"""Pendulum swing-up — port of ``c3sc_tpu/models/pendulum.py``.

    d theta = omega dt
    d omega = ((g/l) sin(theta) - b*omega + u/(m l^2)) dt + sigma dw

theta = 0 is UPRIGHT; theta is periodic on [-pi, pi). Stage cost
    g(x,u) = w_th * 2*(1 - cos theta) + w_om * omega^2 + w_u * u^2.
"""

from __future__ import annotations

import numpy as np
import torch

from c3sc_tpu_torch.device import const_tensor
from c3sc_tpu_torch.models.base import Boundary, ControlProblem, batch_shape


def make_pendulum_problem(
    g: float = 9.81,
    length: float = 1.0,
    mass: float = 1.0,
    damping: float = 0.1,
    sigma: float = 0.5,
    beta: float = 0.1,
    omega_max: float = 8.0,
    u_max: float = 4.0,
    w_th: float = 1.0,
    w_om: float = 0.1,
    w_u: float = 0.05,
) -> ControlProblem:
    ml2 = mass * length**2

    def drift(x, u):
        th, om = x[..., 0], x[..., 1]
        dom = (g / length) * torch.sin(th) - damping * om + u[..., 0] / ml2
        return torch.stack(torch.broadcast_tensors(om, dom), dim=-1)

    def diff(x, u):
        L = torch.zeros((*batch_shape(x, u), 2, 1), dtype=x.dtype, device=x.device)
        L[..., 1, 0] = sigma
        return L

    def stage_cost(x, u):
        th, om = x[..., 0], x[..., 1]
        return w_th * 2.0 * (1.0 - torch.cos(th)) + w_om * om**2 + w_u * u[..., 0] ** 2

    def boundary_cost(x):
        # reflecting omega boundary: psi only used if the regime changed to absorb
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def drift_f0(x):
        return torch.stack([x[..., 1], (g / length) * torch.sin(x[..., 0]) - damping * x[..., 1]],
                           dim=-1)

    def drift_G(x):
        G = const_tensor([[0.0], [1.0 / ml2]], x.dtype, x.device)
        return G.expand(*x.shape[:-1], 2, 1)

    def sigma2_x(x):
        return const_tensor([0.0, sigma**2], x.dtype, x.device).expand(x.shape)

    def cost_q(x):
        return w_th * 2.0 * (1.0 - torch.cos(x[..., 0])) + w_om * x[..., 1] ** 2

    def cost_r(u):
        return w_u * u[..., 0] ** 2

    g_sup = w_th * 4.0 + w_om * omega_max**2 + w_u * u_max**2
    return ControlProblem(
        dx=2, du=1, dw=1,
        lb=(-np.pi, -omega_max), ub=(np.pi, omega_max),
        boundary=(Boundary.PERIODIC, Boundary.REFLECT),
        ulb=(-u_max,), uub=(u_max,),
        drift=drift, diff=diff,
        stage_cost=stage_cost, boundary_cost=boundary_cost,
        drift_f0=drift_f0, drift_G=drift_G, sigma2_x=sigma2_x,
        cost_q=cost_q, cost_r=cost_r,
        beta=beta, name="pendulum",
        value_bounds=(0.0, g_sup / max(beta, 1e-6)),
    )
