"""2D stochastic double-integrator LQ problem + analytic Riccati oracle —
port of ``c3sc_tpu/models/lq.py`` (``make_lq_problem``, ``make_lq_family``,
``lqr_solution``).

    dx1 = x2 dt
    dx2 = u dt + sigma dw
    g(x, u) = x' Q x + u' R u,  discounted at rate beta.

Discounted-LQR oracle: V(x) = x' P x + tr(S P)/beta with P solving the
discounted CARE (A - beta/2 I)'P + P(A - beta/2 I) - P B R^-1 B' P + Q = 0,
and u*(x) = -R^-1 B' P x.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from c3sc_tpu_torch.device import const_tensor
from c3sc_tpu_torch.models.base import Boundary, ControlProblem, batch_shape

A = np.array([[0.0, 1.0], [0.0, 0.0]])
B = np.array([[0.0], [1.0]])


def _quad_form(x, M: np.ndarray):
    """x' M x over the last axis, as ``x @ (M @ x)``."""
    Mt = const_tensor(M, x.dtype, x.device)
    return torch.sum(x * (x @ Mt.T), dim=-1)


def make_lq_problem(
    q: float = 1.0,
    r: float = 1.0,
    sigma: float = 1.0,
    beta: float = 1.0,
    xmax: float = 2.0,
    umax: float = 6.0,
) -> ControlProblem:
    Q = np.eye(2) * q
    R = np.eye(1) * r
    # absorbing box edge: charge the analytic interior value so the boundary
    # perturbs the interior solution as little as possible
    P, c, _ = lqr_solution(q=q, r=r, sigma=sigma, beta=beta)

    def drift(x, u):
        return torch.stack(torch.broadcast_tensors(x[..., 1], u[..., 0]), dim=-1)

    def diff(x, u):
        L = torch.zeros((*batch_shape(x, u), 2, 1), dtype=x.dtype, device=x.device)
        L[..., 1, 0] = sigma
        return L

    def stage_cost(x, u):
        return _quad_form(x, Q) + _quad_form(u, R)

    def boundary_cost(x):
        return _quad_form(x, P) + c

    def drift_f0(x):
        return torch.stack([x[..., 1], torch.zeros_like(x[..., 1])], dim=-1)

    def drift_G(x):
        G = const_tensor([[0.0], [1.0]], x.dtype, x.device)
        return G.expand(*x.shape[:-1], 2, 1)

    def sigma2_x(x):
        return const_tensor([0.0, sigma**2], x.dtype, x.device).expand(x.shape)

    return ControlProblem(
        dx=2, du=1, dw=1,
        lb=(-xmax, -xmax), ub=(xmax, xmax),
        boundary=(Boundary.ABSORB, Boundary.ABSORB),
        ulb=(-umax,), uub=(umax,),
        drift=drift, diff=diff,
        stage_cost=stage_cost, boundary_cost=boundary_cost,
        drift_f0=drift_f0, drift_G=drift_G, sigma2_x=sigma2_x,
        cost_q=lambda x: _quad_form(x, Q),
        cost_r=lambda u: _quad_form(u, R),
        beta=beta, name="lq",
    )


def make_lq_family(
    q: float = 1.0,
    r: float = 1.0,
    sigma: float = 1.0,
    beta: float = 1.0,
    xmax: float = 2.0,
    umax: float = 6.0,
):
    """Setpoint-tracking LQ problem FAMILY: ``family(theta) ->
    ControlProblem`` with stage cost (x - theta)' Q (x - theta) + u' R u.

    theta [2] is read as a tensor at every call of the cost closures, never
    turned into a float or a cached constant: a tensor theta on the solve's
    device (a buffer that ``sim/tracking.py`` updates in place) changes the
    cost without rebuilding anything. Other theta (numpy, lists) become a
    float32 CPU tensor, copied to the states' device at each call.
    """
    Q = np.eye(2) * q
    R = np.eye(1) * r
    P, c, _ = lqr_solution(q=q, r=r, sigma=sigma, beta=beta)
    base = make_lq_problem(q=q, r=r, sigma=sigma, beta=beta, xmax=xmax, umax=umax)

    def family(theta):
        theta = torch.as_tensor(theta, dtype=torch.float32)

        def error(x):
            # theta itself where it lives on x's device: a buffer written in
            # place is read at every call
            return x - theta.to(device=x.device, dtype=x.dtype)

        def cost_q(x):
            return _quad_form(error(x), Q)

        def stage_cost(x, u):
            return cost_q(x) + _quad_form(u, R)

        def boundary_cost(x):
            return _quad_form(error(x), P) + c

        return dataclasses.replace(base, stage_cost=stage_cost, boundary_cost=boundary_cost,
                                   cost_q=cost_q, name="lq_tracking")

    return family


def lqr_solution(q: float = 1.0, r: float = 1.0, sigma: float = 1.0, beta: float = 1.0):
    """Analytic discounted stochastic LQR: returns (P [2,2], const, K [1,2])
    with V(x) = x'Px + const and u*(x) = -K x."""
    import scipy.linalg

    Q = np.eye(2) * q
    R = np.eye(1) * r
    Ad = A - 0.5 * beta * np.eye(2)
    P = scipy.linalg.solve_continuous_are(Ad, B, Q, R)
    K = np.linalg.solve(R, B.T @ P)
    S = np.array([[0.0], [sigma]]) @ np.array([[0.0, sigma]])
    const = float(np.trace(S @ P) / beta) if beta > 0 else 0.0
    return P, const, K
