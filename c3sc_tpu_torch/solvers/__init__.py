"""Solvers ported so far: the dense-grid oracle, the fused TT value
iteration, and the TT Bellman backup with continuous control refinement."""

from c3sc_tpu_torch.solvers.dense import DenseSolution, dense_policy, dense_vi
from c3sc_tpu_torch.solvers.fused import (FusedCarry, FusedSolver, FusedVISolution,
                                          fused_tt_vi, make_fused_vi, pad_fused_carry)
from c3sc_tpu_torch.solvers.ttvi import (bellman_backup, bellman_residual_sample,
                                         refine_controls, rhs_continuous)

__all__ = ["DenseSolution", "dense_vi", "dense_policy", "FusedCarry", "FusedSolver",
           "FusedVISolution", "fused_tt_vi", "make_fused_vi", "pad_fused_carry",
           "bellman_backup", "bellman_residual_sample", "refine_controls", "rhs_continuous"]
