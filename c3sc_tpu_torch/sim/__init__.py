"""Closed-loop simulation: implicit policy and batched rollouts."""

from c3sc_tpu_torch.sim.integrators import (Trajectory, rollout, trajectory_load,
                                            trajectory_save)
from c3sc_tpu_torch.sim.policy import make_implicit_policy, q_values

__all__ = ["Trajectory", "rollout", "trajectory_save", "trajectory_load",
           "make_implicit_policy", "q_values"]
