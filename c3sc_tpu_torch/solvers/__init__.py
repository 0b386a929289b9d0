"""Solvers ported so far: the dense-grid oracle and the fused TT value
iteration."""

from c3sc_tpu_torch.solvers.dense import DenseSolution, dense_policy, dense_vi
from c3sc_tpu_torch.solvers.fused import (FusedCarry, FusedSolver, FusedVISolution,
                                          fused_tt_vi, make_fused_vi, pad_fused_carry)

__all__ = ["DenseSolution", "dense_vi", "dense_policy", "FusedCarry", "FusedSolver",
           "FusedVISolution", "fused_tt_vi", "make_fused_vi", "pad_fused_carry"]
