"""Problem registry — the systems ported from ``c3sc_tpu/models`` so far,
and the problem families whose cost moves with a parameter theta
(``make_lq_family``, ``make_quadcopter_family``).

Dubins, the glider and the 7D quadcopter follow in later slices.
"""

from c3sc_tpu_torch.models.base import Boundary, ControlProblem, Obstacle
from c3sc_tpu_torch.models.lq import lqr_solution, make_lq_family, make_lq_problem
from c3sc_tpu_torch.models.pendulum import make_pendulum_problem
from c3sc_tpu_torch.models.quadcopter import make_quadcopter_family, make_quadcopter_problem

REGISTRY = {
    "lq": make_lq_problem,
    "pendulum": make_pendulum_problem,
    "quadcopter": make_quadcopter_problem,
}


def make_problem(name: str, **kwargs):
    """Build a named reference problem."""
    return REGISTRY[name](**kwargs)


__all__ = [
    "Boundary",
    "ControlProblem",
    "Obstacle",
    "REGISTRY",
    "make_problem",
    "make_lq_problem",
    "make_lq_family",
    "lqr_solution",
    "make_pendulum_problem",
    "make_quadcopter_problem",
    "make_quadcopter_family",
]
