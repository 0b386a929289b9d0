"""Carry state across from the JAX package as numpy.

The problem "weights" are the factory kwargs, which keep their names in
both packages (``make_problem("quadcopter", sigma_v=0.15, ...)``). A grid
travels as its static description, and a solved dense value as the ``v``
array of an npz: ``experiments/artifacts/quad_dense_v*.npz`` and the CLI's
``vf.npz``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from c3sc_tpu_torch.grids import Grid


def grid_from_numpy(lb: Sequence[float], ub: Sequence[float], shape: Sequence[int],
                    periodic: Sequence[bool] | None = None,
                    nodes_override: Sequence[Sequence[float]] | None = None) -> Grid:
    """The port's Grid from a JAX ``Grid``'s fields (lb, ub, shape,
    periodic, nodes_override)."""
    return Grid.create(lb, ub, shape, periodic, nodes=nodes_override)


def value_from_npz(path: str, device=None) -> torch.Tensor:
    """The dense value table ``v`` [*grid.shape] of an npz, as float32."""
    with np.load(path) as z:
        return torch.as_tensor(np.asarray(z["v"], np.float32), device=device)
