"""Debug-mode helpers — port of ``c3sc_tpu/utils/debug.py`` (SURVEY.md §5:
the race-detection/sanitizer row).

The JAX package turns on ``jax_debug_nans``, which traps the first NaN a
forward computation makes. Torch has no trap on forward NaNs: what it offers
is autograd's anomaly mode with ``check_nan=True``, which raises where a
backward pass produces a NaN and names the forward operation that caused
it. These helpers turn that on and off; the solvers' own NaN guards (the
fused solver's scrubbed samples and emergency release) stay the forward
checks.
"""

from __future__ import annotations

import contextlib

import torch


def enable_nan_checks() -> None:
    torch.autograd.set_detect_anomaly(True, check_nan=True)


def disable_nan_checks() -> None:
    torch.autograd.set_detect_anomaly(False)


@contextlib.contextmanager
def debug_context():
    """Anomaly mode with NaN checks inside the block; the mode that held
    before is restored on exit. (The JAX package's context also disables
    jit; the port runs eagerly anyway.)"""
    before = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    enable_nan_checks()
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(before[0], check_nan=before[1])
