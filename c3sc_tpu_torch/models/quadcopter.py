"""Quadcopter: 6D planar-quadrotor stochastic hover — port of
``c3sc_tpu/models/quadcopter.py::make_quadcopter_problem``,
``make_quadcopter_family`` and the 7D ``make_quadcopter7_problem``.

State (x, z, th, vx, vz, om), controls (u1, u2) = rotor thrusts in [0, u_max]:

    x'  = vx                     vx' = -(u1 + u2) sin(th) / m      + noise
    z'  = vz                     vz' =  (u1 + u2) cos(th) / m - g  + noise
    th' = om                     om' =  arm (u1 - u2) / inertia    + noise

Quadratic stage cost to hover at the origin. Same factory kwargs as the
JAX package; every callable broadcasts over leading axes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from c3sc_tpu_torch.device import const_tensor
from c3sc_tpu_torch.models.base import Boundary, ControlProblem, batch_shape


def make_quadcopter_problem(
    mass: float = 0.5,
    inertia: float = 0.01,
    arm: float = 0.17,
    gconst: float = 9.81,
    sigma_v: float = 0.25,
    sigma_om: float = 0.25,
    beta: float = 0.2,
    u_max: float = 6.0,
    pos_max: float = 2.0,
    th_max: float = 1.0,
    vel_max: float = 3.0,
    om_max: float = 4.0,
    w_pos: float = 2.0,
    w_th: float = 1.0,
    w_vel: float = 0.2,
    w_om: float = 0.1,
    w_u: float = 0.02,
    exit_cost: float = 100.0,
) -> ControlProblem:
    hover = 0.5 * mass * gconst  # per-rotor hover thrust (cost reference)

    def drift(x, u):
        th, vx, vz, om = x[..., 2], x[..., 3], x[..., 4], x[..., 5]
        thrust = u[..., 0] + u[..., 1]
        cols = torch.broadcast_tensors(
            vx, vz, om,
            -thrust * torch.sin(th) / mass,
            thrust * torch.cos(th) / mass - gconst,
            arm * (u[..., 0] - u[..., 1]) / inertia,
        )
        return torch.stack(cols, dim=-1)

    L = np.zeros((6, 3))
    L[3, 0], L[4, 1], L[5, 2] = sigma_v, sigma_v, sigma_om

    def diff(x, u):
        # one constant uploaded once and expanded: writing Python scalars
        # into a device tensor would cost a host copy per element and call
        return const_tensor(L, x.dtype, x.device).expand(*batch_shape(x, u), 6, 3)

    def stage_cost(x, u):
        pos = x[..., 0] ** 2 + x[..., 1] ** 2
        du = (u[..., 0] - hover) ** 2 + (u[..., 1] - hover) ** 2
        return (
            w_pos * pos
            + w_th * x[..., 2] ** 2
            + w_vel * (x[..., 3] ** 2 + x[..., 4] ** 2)
            + w_om * x[..., 5] ** 2
            + w_u * du
        )

    def boundary_cost(x):
        return torch.full(x.shape[:-1], exit_cost, dtype=x.dtype, device=x.device)

    # control-affine structure: f(x, u) = f0(x) + G(x) u
    def drift_f0(x):
        z = torch.zeros_like(x[..., 0])
        return torch.stack([x[..., 3], x[..., 4], x[..., 5], z, z - gconst, z], dim=-1)

    def drift_G(x):
        s, c = torch.sin(x[..., 2]) / mass, torch.cos(x[..., 2]) / mass
        k = torch.full_like(s, arm / inertia)
        z = torch.zeros_like(s)
        rows = [(z, z), (z, z), (z, z), (-s, -s), (c, c), (k, -k)]
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    def sigma2_x(x):
        s2 = const_tensor([0.0, 0.0, 0.0, sigma_v**2, sigma_v**2, sigma_om**2],
                          x.dtype, x.device)
        return s2.expand(x.shape)

    def cost_q(x):
        return (w_pos * (x[..., 0] ** 2 + x[..., 1] ** 2) + w_th * x[..., 2] ** 2
                + w_vel * (x[..., 3] ** 2 + x[..., 4] ** 2) + w_om * x[..., 5] ** 2)

    def cost_r(u):
        return w_u * ((u[..., 0] - hover) ** 2 + (u[..., 1] - hover) ** 2)

    return ControlProblem(
        dx=6, du=2, dw=3,
        lb=(-pos_max, -pos_max, -th_max, -vel_max, -vel_max, -om_max),
        ub=(pos_max, pos_max, th_max, vel_max, vel_max, om_max),
        boundary=(
            Boundary.ABSORB, Boundary.ABSORB, Boundary.REFLECT,
            Boundary.REFLECT, Boundary.REFLECT, Boundary.REFLECT,
        ),
        ulb=(0.0, 0.0), uub=(u_max, u_max),
        drift=drift, diff=diff,
        stage_cost=stage_cost, boundary_cost=boundary_cost,
        drift_f0=drift_f0, drift_G=drift_G, sigma2_x=sigma2_x,
        cost_q=cost_q, cost_r=cost_r,
        beta=beta, name="quadcopter",
        value_bounds=(0.0, max(exit_cost, _g_sup(
            w_pos, w_th, w_vel, w_om, w_u, pos_max, th_max, vel_max, om_max,
            u_max, hover) / max(beta, 1e-6))),
    )


def _g_sup(w_pos, w_th, w_vel, w_om, w_u, pos_max, th_max, vel_max, om_max,
           u_max, hover):
    return (
        w_pos * 2 * pos_max**2 + w_th * th_max**2 + w_vel * 2 * vel_max**2
        + w_om * om_max**2 + w_u * 2 * max(hover, u_max - hover) ** 2
    )


def make_quadcopter_family(**kwargs):
    """Moving-hover-target quadcopter FAMILY: ``family(theta) ->
    ControlProblem`` where theta [2] = (x*, z*) is the hover target that the
    position cost tracks. Every other term, and ``value_bounds``, is the base
    problem's (``make_quadcopter_problem(**kwargs)``); the bound was derived
    for a target at the origin and is kept as the JAX package keeps it.

    theta is read as a tensor at every call of the cost closures, never
    turned into a float or a cached constant (see ``models/lq.make_lq_family``).
    """
    base = make_quadcopter_problem(**kwargs)
    w_pos = kwargs.get("w_pos", 2.0)
    b_cost_q, b_stage = base.cost_q, base.stage_cost

    def family(theta):
        theta = torch.as_tensor(theta, dtype=torch.float32)

        def moved(q, x):
            # the origin-centred position term replaced by the target-centred
            # one, in the JAX package's order of operations
            th = theta.to(device=x.device, dtype=x.dtype)
            return (q - w_pos * (x[..., 0] ** 2 + x[..., 1] ** 2)
                    + w_pos * ((x[..., 0] - th[0]) ** 2 + (x[..., 1] - th[1]) ** 2))

        def cost_q(x):
            return moved(b_cost_q(x), x)

        def stage_cost(x, u):
            return moved(b_stage(x, u), x)

        return dataclasses.replace(base, cost_q=cost_q, stage_cost=stage_cost,
                                   name="quadcopter_tracking")

    return family


def make_quadcopter7_problem(
    wind_tau: float = 2.0,
    wind_sigma: float = 0.6,
    wind_max: float = 1.5,
    **kwargs,
) -> ControlProblem:
    """7D quadcopter: the 6D planar quadrotor + an Ornstein-Uhlenbeck wind
    state w acting on horizontal acceleration:

        vx' += w          (wind drag acceleration)
        w'   = -w / tau + sigma_w dW

    State (x, z, th, vx, vz, om, w), controls unchanged (2 rotor thrusts).
    Control-affine structure and separable costs are kept, so all five
    declarations hold and kernel K1 runs it at (d, du) = (7, 2).

    Where the JAX package writes ``f6.at[3].add(x[6])`` and
    ``L.at[6, 3].set(wind_sigma)``, the port concatenates slices and expands
    one uploaded constant: no in-place write, so ``torch.func`` (iLQR) and
    autograd see plain functions, and no Python scalar meets a 0-d tensor.
    """
    base = make_quadcopter_problem(**kwargs)
    b_drift, b_f0, b_G = base.drift, base.drift_f0, base.drift_G
    b_s2, b_cost_q = base.sigma2_x, base.cost_q
    # the constant diffusion and variances: the 6D model's, and the wind's
    x6, u2 = torch.zeros(6), torch.zeros(2)
    L7 = np.zeros((7, 4), np.float32)
    L7[:6, :3] = base.diff(x6, u2).numpy()
    L7[6, 3] = wind_sigma
    s2_7 = np.append(b_s2(x6).numpy(), np.float32(wind_sigma**2))

    def with_wind(f6, x):
        """f6 [..., 6] with the wind added to vx' and w' appended: [..., 7]."""
        w = x[..., 6]
        vx, dw = torch.broadcast_tensors(f6[..., 3] + w, -w / wind_tau)
        return torch.cat([f6[..., :3], vx[..., None], f6[..., 4:], dw[..., None]], dim=-1)

    def drift(x, u):
        return with_wind(b_drift(x[..., :6], u), x)

    def diff(x, u):
        return const_tensor(L7, x.dtype, x.device).expand(*batch_shape(x, u), 7, 4)

    def drift_f0(x):
        return with_wind(b_f0(x[..., :6]), x)

    def drift_G(x):
        G6 = b_G(x[..., :6])                                  # [..., 6, 2]
        return torch.cat([G6, G6.new_zeros((*G6.shape[:-2], 1, 2))], dim=-2)

    def sigma2_x(x):
        return const_tensor(s2_7, x.dtype, x.device).expand(x.shape)

    def cost_q(x):
        return b_cost_q(x[..., :6])                           # wind itself is free

    return ControlProblem(
        dx=7, du=2, dw=4,
        lb=base.lb + (-wind_max,), ub=base.ub + (wind_max,),
        boundary=base.boundary + (Boundary.REFLECT,),
        ulb=base.ulb, uub=base.uub,
        drift=drift, diff=diff,
        stage_cost=lambda x, u: base.stage_cost(x[..., :6], u),
        boundary_cost=lambda x: base.boundary_cost(x[..., :6]),
        drift_f0=drift_f0, drift_G=drift_G, sigma2_x=sigma2_x,
        cost_q=cost_q, cost_r=base.cost_r,
        beta=base.beta, name="quadcopter7",
        value_bounds=base.value_bounds,
    )
