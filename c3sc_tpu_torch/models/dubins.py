"""Dubins car: 3D reach-avoid with obstacle cost — port of
``c3sc_tpu/models/dubins.py``.

    dx = V cos(theta) dt + sigma_xy dw1
    dy = V sin(theta) dt + sigma_xy dw2
    dtheta = u dt + sigma_th dw3

Min-time reach of a goal disc (modelled as an absorbing rectangle with cost 0)
while avoiding absorbing obstacle rectangles (high cost); leaving the domain
is absorbing with moderate cost. Stage cost 1 (time) + small u^2. The
heading is periodic. Same factory kwargs as the JAX package; every callable
broadcasts over leading axes.
"""

from __future__ import annotations

import numpy as np
import torch

from c3sc_tpu_torch.device import const_tensor
from c3sc_tpu_torch.models.base import Boundary, ControlProblem, Obstacle, batch_shape


def make_dubins_problem(
    speed: float = 1.0,
    sigma_xy: float = 0.05,
    sigma_th: float = 0.2,
    beta: float = 0.2,
    box: float = 4.0,
    u_max: float = 2.0,
    w_u: float = 0.1,
    exit_cost: float = 50.0,
    obstacle_cost: float = 100.0,
    goal_half: float = 0.5,
    with_obstacles: bool = True,
) -> ControlProblem:
    L = np.diag([sigma_xy, sigma_xy, sigma_th])
    s2 = np.array([sigma_xy**2, sigma_xy**2, sigma_th**2])

    def drift(x, u):
        th = x[..., 2]
        cols = torch.broadcast_tensors(speed * torch.cos(th), speed * torch.sin(th), u[..., 0])
        return torch.stack(cols, dim=-1)

    def diff(x, u):
        return const_tensor(L, x.dtype, x.device).expand(*batch_shape(x, u), 3, 3)

    def stage_cost(x, u):
        return torch.broadcast_to(1.0 + w_u * u[..., 0] ** 2, batch_shape(x, u))

    def boundary_cost(x):
        return torch.full(x.shape[:-1], exit_cost, dtype=x.dtype, device=x.device)

    def drift_f0(x):
        th = x[..., 2]
        return torch.stack([speed * torch.cos(th), speed * torch.sin(th),
                            torch.zeros_like(th)], dim=-1)

    def drift_G(x):
        return const_tensor([[0.0], [0.0], [1.0]], x.dtype, x.device).expand(
            *x.shape[:-1], 3, 1)

    goal = Obstacle(  # absorbing goal region, zero cost
        lb=(-goal_half, -goal_half, -np.pi), ub=(goal_half, goal_half, np.pi), cost=0.0
    )
    obstacles = [goal]
    if with_obstacles:
        obstacles += [
            Obstacle(lb=(1.2, -2.8, -np.pi), ub=(2.2, -0.6, np.pi), cost=obstacle_cost),
            Obstacle(lb=(-2.4, 1.0, -np.pi), ub=(-1.0, 2.2, np.pi), cost=obstacle_cost),
        ]

    return ControlProblem(
        dx=3, du=1, dw=3,
        lb=(-box, -box, -np.pi), ub=(box, box, np.pi),
        boundary=(Boundary.ABSORB, Boundary.ABSORB, Boundary.PERIODIC),
        ulb=(-u_max,), uub=(u_max,),
        drift=drift, diff=diff,
        stage_cost=stage_cost, boundary_cost=boundary_cost,
        drift_f0=drift_f0, drift_G=drift_G,
        sigma2_x=lambda x: const_tensor(s2, x.dtype, x.device).expand(x.shape),
        cost_q=lambda x: torch.ones_like(x[..., 0]),
        cost_r=lambda u: w_u * u[..., 0] ** 2,
        beta=beta, obstacles=tuple(obstacles), name="dubins",
        value_bounds=(
            0.0,
            max(exit_cost, obstacle_cost,
                (1.0 + w_u * u_max**2) / max(beta, 1e-6)),
        ),
    )
