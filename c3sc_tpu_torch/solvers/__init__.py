"""Solvers: the dense-grid oracle, the fused TT value iteration with its
residual-corrected refinement and grid-multilevel ladder, the host-path TT
value and policy iteration (tt_vi, tt_pi, two-site DMRG cross), PI-ALS, and
the flagship accuracy stack (two-site polish, coarse-grid correction,
gating, the local dense patch)."""

from c3sc_tpu_torch.solvers.dense import DenseSolution, dense_policy, dense_vi
from c3sc_tpu_torch.solvers.dmrg import dmrg_cross
from c3sc_tpu_torch.solvers.fused import (FusedCarry, FusedSolver, FusedVISolution,
                                          fused_tt_vi, fused_tt_vi_refined, make_fused_vi,
                                          pad_fused_carry)
from c3sc_tpu_torch.solvers.gating import GateRecord, gated_apply, make_greedy_probe, probe_trim
from c3sc_tpu_torch.solvers.local_patch import (LocalPatch, TwoLevelResult, default_patch_bounds,
                                                make_patch_node_value_fn, make_patched_value_fn,
                                                solve_local_patch, two_level_solve)
from c3sc_tpu_torch.solvers.multilevel import MultilevelSolution, multilevel_tt_vi
from c3sc_tpu_torch.solvers.pials import PIALSResult, pi_als
from c3sc_tpu_torch.solvers.polish import PolishResult, level_correct, mode_correct, tt_polish
from c3sc_tpu_torch.solvers.ttpi import TTPISolution, tt_pi
from c3sc_tpu_torch.solvers.ttvi import (TTVISolution, bellman_backup, bellman_residual_sample,
                                         make_bellman_kernel, refine_controls, rhs_continuous,
                                         tt_vi)
from c3sc_tpu_torch.solvers.twogrid import TwoGridInfo, coarse_correct, coarse_grid

__all__ = ["DenseSolution", "dense_vi", "dense_policy", "FusedCarry", "FusedSolver",
           "FusedVISolution", "fused_tt_vi", "fused_tt_vi_refined", "make_fused_vi", "pad_fused_carry",
           "bellman_backup", "bellman_residual_sample", "make_bellman_kernel", "refine_controls",
           "rhs_continuous", "PolishResult", "tt_polish", "level_correct", "mode_correct",
           "TwoGridInfo", "coarse_grid", "coarse_correct", "GateRecord", "gated_apply",
           "make_greedy_probe", "probe_trim", "LocalPatch", "TwoLevelResult",
           "default_patch_bounds", "solve_local_patch", "make_patch_node_value_fn",
           "two_level_solve", "make_patched_value_fn", "TTVISolution", "tt_vi",
           "TTPISolution", "tt_pi", "PIALSResult", "pi_als", "MultilevelSolution",
           "multilevel_tt_vi", "dmrg_cross"]
