"""Problem registry — the six systems of ``c3sc_tpu/models`` (the CLI's
``lq``, ``pendulum``, ``dubins``, ``glider``, ``quadcopter`` and
``quadcopter7``), and the problem families whose cost moves with a parameter
theta (``make_lq_family``, ``make_quadcopter_family``).
"""

from c3sc_tpu_torch.models.base import Boundary, ControlProblem, Obstacle
from c3sc_tpu_torch.models.lq import lqr_solution, make_lq_family, make_lq_problem
from c3sc_tpu_torch.models.pendulum import make_pendulum_problem
from c3sc_tpu_torch.models.dubins import make_dubins_problem
from c3sc_tpu_torch.models.glider import make_glider_problem
from c3sc_tpu_torch.models.quadcopter import (make_quadcopter7_problem, make_quadcopter_family,
                                              make_quadcopter_problem)

REGISTRY = {
    "lq": make_lq_problem,
    "pendulum": make_pendulum_problem,
    "dubins": make_dubins_problem,
    "glider": make_glider_problem,
    "quadcopter": make_quadcopter_problem,
    "quadcopter7": make_quadcopter7_problem,
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
    "make_dubins_problem",
    "make_glider_problem",
    "make_quadcopter_problem",
    "make_quadcopter_family",
    "make_quadcopter7_problem",
]
