"""Carry state across from the JAX package as numpy.

The problem "weights" are the factory kwargs, which keep their names in
both packages (``make_problem("quadcopter", sigma_v=0.15, ...)``). A grid
travels as its static description, and a solved dense value as the ``v``
array of an npz: ``experiments/artifacts/quad_dense_v*.npz`` and the CLI's
``vf.npz``. A TT value travels as its padded cores and ranks (the npz keys
``core_k`` and ``ranks`` of either package's ``tt_save``), and the whole
state of a fused solve as the fields of its ``FusedCarry``. The cross index
sets of a two-site fit travel as their ``left`` / ``right`` arrays, and a
local dense patch as the npz keys ``v``, ``lo`` and ``hi`` that
``experiments/quad_dense_oracle.py`` writes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.ops.tt import TT, tt_load


def grid_from_numpy(lb: Sequence[float], ub: Sequence[float], shape: Sequence[int],
                    periodic: Sequence[bool] | None = None,
                    nodes_override: Sequence[Sequence[float]] | None = None) -> Grid:
    """The port's Grid from a JAX ``Grid``'s fields (lb, ub, shape,
    periodic, nodes_override)."""
    return Grid.create(lb, ub, shape, periodic, nodes=nodes_override)


def value_from_npz(path: str, device=None) -> torch.Tensor:
    """The dense value table ``v`` [*grid.shape] of an npz, as float32 on
    ``device`` (None: the default CUDA device)."""
    with np.load(path) as z:
        return torch.as_tensor(np.asarray(z["v"], np.float32), device=resolve_device(device))


def tt_from_numpy(cores, ranks, device=None) -> TT:
    """The port's TT from padded cores ``d x [R, n_k, R]`` and ``ranks [d+1]``
    given as numpy arrays (a JAX ``TT``'s fields), as float32 / int32 on
    ``device`` (None: the default CUDA device)."""
    device = resolve_device(device)
    return TT(tuple(torch.as_tensor(np.array(c, np.float32), device=device) for c in cores),
              torch.as_tensor(np.array(ranks, np.int32), device=device))


def tt_from_npz(path: str, device=None) -> TT:
    """A TT saved by the JAX package's ``tt_save`` (or the port's), unchanged,
    on ``device`` (None: the default CUDA device)."""
    return tt_load(path, device)


def fused_carry_from_numpy(mapping, device=None):
    """The port's ``FusedCarry`` from a JAX ``FusedCarry``'s fields given as
    numpy arrays: ``mapping`` maps every field name to its array (``cores``
    and ``cores_best`` to sequences of arrays), as ``carry._asdict()`` gives
    them. Floats become float32, index sets and pivot rows int64, ranks and
    counters int32, ``frozen`` bool — on ``device`` (None: the default CUDA
    device)."""
    from c3sc_tpu_torch.solvers.fused import FusedCarry

    device = resolve_device(device)
    kinds = dict(cores=np.float32, cores_best=np.float32, residual=np.float32,
                 long_res=np.float32, v_sample=np.float32, sample_ref=np.float32,
                 probe_cost=np.float32, best_cost=np.float32, freeze_mark=np.float32,
                 best_long=np.float32, best_absdisp=np.float32,
                 left=np.int64, right=np.int64, rows_l=np.int64, rows_r=np.int64,
                 frozen=np.bool_)
    missing = set(FusedCarry._fields) - set(mapping)
    if missing:
        raise ValueError(f"fused_carry_from_numpy: missing fields {sorted(missing)}")

    def move(name, a):
        return torch.as_tensor(np.array(a, kinds.get(name, np.int32)), device=device)

    return FusedCarry(**{name: (tuple(move(name, c) for c in mapping[name])
                                if name in ("cores", "cores_best") else move(name, mapping[name]))
                         for name in FusedCarry._fields})


def cross_state_from_numpy(left, right):
    """The port's ``CrossState`` from a JAX ``CrossState``'s ``left`` and
    ``right`` lists of integer arrays (copied, as int64 numpy)."""
    from c3sc_tpu_torch.ops.cross import CrossState

    return CrossState(left=[np.array(a, np.int64) for a in left],
                      right=[np.array(a, np.int64) for a in right])


def patch_from_npz(path: str, grid: Grid, device=None):
    """A ``LocalPatch`` from an npz with the keys ``v`` (the patch values
    [*sub_shape]), ``lo`` and ``hi`` (the sub-box's first and last node
    indices in ``grid``), on ``device`` (None: the default CUDA device). Its
    subgrid is rebuilt from ``grid``; the solve's residual and sweep count are
    not stored and read as NaN and 0."""
    from c3sc_tpu_torch.solvers.local_patch import LocalPatch, patch_subgrid

    with np.load(path) as z:
        v, lo, hi = np.asarray(z["v"], np.float32), z["lo"], z["hi"]
    lo, hi = tuple(int(i) for i in lo), tuple(int(i) for i in hi)
    subgrid = patch_subgrid(grid, lo, hi)
    if tuple(v.shape) != subgrid.shape:
        raise ValueError(f"patch values {v.shape} do not fit the sub-box {subgrid.shape}")
    return LocalPatch(subgrid=subgrid, v=torch.as_tensor(v, device=resolve_device(device)),
                      lo=lo, hi=hi, residual=float("nan"), sweeps=0)
