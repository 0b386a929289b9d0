"""Closed-loop simulation: implicit policy, batched rollouts, and the
receding-horizon loops on the fused solver (MPC, tracking)."""

from c3sc_tpu_torch.sim.integrators import (Trajectory, rollout, trajectory_load,
                                            trajectory_save)
from c3sc_tpu_torch.sim.mpc_fused import FusedMPCResult, fused_mpc_run
from c3sc_tpu_torch.sim.policy import make_implicit_policy, q_values
from c3sc_tpu_torch.sim.tracking import (TrackingRunResult, TrackingSolver,
                                         make_tracking_solver, tracking_mpc_run)

__all__ = ["Trajectory", "rollout", "trajectory_save", "trajectory_load",
           "make_implicit_policy", "q_values", "FusedMPCResult", "fused_mpc_run",
           "TrackingSolver", "TrackingRunResult", "make_tracking_solver", "tracking_mpc_run"]
