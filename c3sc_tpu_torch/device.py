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

import numpy as np
import torch


def default_device() -> torch.device:
    """The device of every ``device=None``: the current CUDA device."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, the default one for None."""
    return default_device() if device is None else torch.device(device)


def synchronize(device: torch.device) -> None:
    """Wait until a CUDA device has run all it was given (a no-op on the
    CPU): the edge of a device-synced time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_CONSTANTS: dict = {}


def const_tensor(values, dtype, device) -> torch.Tensor:
    """A small static array (grid bounds, spacings, node sets, a model's
    constant matrix) as a tensor on ``device``, uploaded ONCE and kept.

    ``torch.as_tensor(python_values, device="cuda")`` copies from pageable
    host memory, and for that copy torch makes the host wait until the
    device has drained its queue: inside a solver's iteration each such
    call is a host sync. Callers must not write into the result.
    """
    arr = np.asarray(values)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(arr, dtype=dtype, device=device)
    return t
