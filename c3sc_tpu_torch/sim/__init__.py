"""Closed-loop simulation: implicit policy, batched rollouts, the
receding-horizon loops on the host-path solver (MPC) and on the fused solver
(MPC, tracking), iLQR / shooting receding-horizon MPC over a value function,
and the terminal LQR of its dual mode."""

from c3sc_tpu_torch.sim.ilqr import make_ilqr_plan
from c3sc_tpu_torch.sim.integrators import (Trajectory, rollout, trajectory_load,
                                            trajectory_save)
from c3sc_tpu_torch.sim.mpc import MPCResult, mpc_run
from c3sc_tpu_torch.sim.mpc_fused import FusedMPCResult, fused_mpc_run
from c3sc_tpu_torch.sim.mpc_shoot import make_plan_fn, receding_horizon_rollout
from c3sc_tpu_torch.sim.policy import make_implicit_policy, q_values
from c3sc_tpu_torch.sim.terminal import TerminalLQR, make_terminal_lqr
from c3sc_tpu_torch.sim.tracking import (TrackingRunResult, TrackingSolver,
                                         make_tracking_solver, tracking_mpc_run)

__all__ = ["Trajectory", "rollout", "trajectory_save", "trajectory_load",
           "make_implicit_policy", "q_values", "MPCResult", "mpc_run", "FusedMPCResult",
           "fused_mpc_run",
           "TrackingSolver", "TrackingRunResult", "make_tracking_solver", "tracking_mpc_run",
           "make_ilqr_plan", "make_plan_fn", "receding_horizon_rollout",
           "TerminalLQR", "make_terminal_lqr"]
