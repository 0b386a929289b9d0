"""Aux subsystems: checkpoint/resume, metrics, debug (SURVEY.md §5) — the
port's counterpart of ``c3sc_tpu/utils``. The JAX package's persistent
compilation cache (``compile_cache.py``) has none: the port builds its
kernels once per source hash (``_ext.py``)."""

from c3sc_tpu_torch.utils.checkpoint import (
    fused_context,
    load_fused_carry,
    load_solver_state,
    save_fused_carry,
    save_solver_state,
)
from c3sc_tpu_torch.utils.metrics import MetricsLogger

__all__ = [
    "save_solver_state", "load_solver_state",
    "save_fused_carry", "load_fused_carry", "fused_context",
    "MetricsLogger",
]
