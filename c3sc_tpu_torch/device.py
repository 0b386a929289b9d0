"""Where the port computes when the caller does not say.

Every entry point that builds tensors (``dense_vi``, ``make_dense_step``,
``dense_policy``, ``make_dense_operands``, ``Grid.node_states`` /
``node_indices``, ``convert.value_from_npz``, ``sim.trajectory_load``)
takes ``device=None`` and resolves it here: the CUDA device. A caller that
wants the CPU says ``device="cpu"``, as the CPU tests do. Nothing looks for
a card and carries on without one: on a machine that has none, torch raises
its own error at the first allocation. Functions that take tensors follow
their inputs' device instead.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The device of every ``device=None``: the current CUDA device."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, the default one for None."""
    return default_device() if device is None else torch.device(device)
