"""Perching glider: 4D nonlinear flat-plate dynamics, terminal-cost DP —
port of ``c3sc_tpu/models/glider.py``.

Flat-plate glider in the longitudinal plane, state (x, z, v, gamma):
position, airspeed, flight-path angle; control = angle of attack alpha.

    x'     = v cos(gamma)
    z'     = v sin(gamma)
    v'     = -g sin(gamma) - D(v, alpha)/m           + noise
    gamma' =  L(v, alpha)/(m v) - g cos(gamma)/v     + noise

with flat-plate aero  C_L = 2 sin(a) cos(a),  C_D = 2 sin^2(a) + cd0,
L = q S C_L, D = q S C_D, q = rho v^2 / 2.

Perching: reach the plane x = 0.5 (absorbing) with small z, v, gamma
deviations, charged by the boundary cost psi. The drift is nonlinear in the
angle of attack, so the problem declares no ``drift_f0``/``drift_G``: its
dense sweep runs kernel K1's general entries on the card.
"""

from __future__ import annotations

import torch

from c3sc_tpu_torch.device import const_tensor
from c3sc_tpu_torch.models.base import Boundary, ControlProblem, batch_shape


def _maximum(a, lo: float):
    """max(a, lo) with ``jnp.maximum``'s derivative: 1/2 where a == lo
    (torch.maximum splits a tie evenly; torch.clamp would give 1)."""
    return torch.maximum(a, const_tensor(lo, a.dtype, a.device))


def make_glider_problem(
    mass: float = 0.08,
    s_area: float = 0.1,
    rho: float = 1.2,
    gconst: float = 9.81,
    cd0: float = 0.02,
    sigma_v: float = 0.2,
    sigma_g: float = 0.1,
    beta: float = 0.05,
    alpha_max: float = 0.9,
    miss_cost: float = 50.0,
    target_z: float = 0.0,
    target_v: float = 1.0,
) -> ControlProblem:
    qs = 0.5 * rho * s_area
    L = [[0.0, 0.0], [0.0, 0.0], [sigma_v, 0.0], [0.0, sigma_g]]
    s2 = [0.0, 0.0, sigma_v**2, sigma_g**2]

    def drift(x, u):
        v, gam = x[..., 2], x[..., 3]
        a = u[..., 0]
        vsafe = _maximum(v, 0.3)
        cl = 2.0 * torch.sin(a) * torch.cos(a)
        cd = 2.0 * torch.sin(a) ** 2 + cd0
        lift = qs * vsafe**2 * cl
        drag = qs * vsafe**2 * cd
        dv = -gconst * torch.sin(gam) - drag / mass
        dgam = lift / (mass * vsafe) - gconst * torch.cos(gam) / vsafe
        cols = torch.broadcast_tensors(v * torch.cos(gam), v * torch.sin(gam), dv, dgam)
        return torch.stack(cols, dim=-1)

    def diff(x, u):
        return const_tensor(L, x.dtype, x.device).expand(*batch_shape(x, u), 4, 2)

    def stage_cost(x, u):
        return torch.broadcast_to(0.1 + 0.1 * u[..., 0] ** 2, batch_shape(x, u))

    def boundary_cost(x):
        # perch quality at exit: miss distance in (z, v, gamma); the glider
        # flies in +x and only the x = ub face is the perch, every other
        # exit pays the full miss_cost. The threshold is a float32 tensor, so
        # the comparison is JAX's float32 one under any batching
        z, v, gam = x[..., 1], x[..., 2], x[..., 3]
        miss = 4.0 * (z - target_z) ** 2 + 1.0 * (v - target_v) ** 2 + 0.5 * gam**2
        at_perch = x[..., 0] >= const_tensor(0.4, x.dtype, x.device)
        return torch.where(at_perch, miss, const_tensor(miss_cost, x.dtype, x.device))

    return ControlProblem(
        dx=4, du=1, dw=2,
        lb=(-3.5, -1.5, 0.3, -1.2), ub=(0.5, 1.5, 6.0, 1.2),
        boundary=(Boundary.ABSORB, Boundary.ABSORB, Boundary.REFLECT, Boundary.REFLECT),
        ulb=(-alpha_max,), uub=(alpha_max,),
        drift=drift, diff=diff,
        stage_cost=stage_cost, boundary_cost=boundary_cost,
        # drift is NONLINEAR in u (angle of attack): no affine declarations;
        # diffusion and cost structure still declared
        sigma2_x=lambda x: const_tensor(s2, x.dtype, x.device).expand(x.shape),
        cost_q=lambda x: torch.full_like(x[..., 0], 0.1),
        cost_r=lambda u: 0.1 * u[..., 0] ** 2,
        beta=beta, name="glider",
        value_bounds=(
            0.0,
            max(miss_cost * 1.5,
                (0.1 + 0.1 * alpha_max**2) / max(beta, 1e-6)),
        ),
    )
