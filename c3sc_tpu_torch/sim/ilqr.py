"""Batched iLQR trajectory optimiser over the problem's dynamics — port of
``c3sc_tpu/sim/ilqr.py``.

Linearise the dynamics along the nominal trajectory, quadraticise the
discounted cost, run a Riccati backward pass for feedforward k and feedback
gains K, and roll the forward pass closed-loop: the gains absorb the
open-loop instability, so the local model stays valid at any horizon. The
terminal cost-to-go is the value function: its gradient feeds Qx at the
horizon, and the curvature there is g_xx / beta (the stationary cost of
parking at x_H), since a piecewise-multilinear value has no usable Hessian.

Everything is batched over scenarios. The derivatives of the dynamics and
the stage cost come from ``torch.func`` (``jacfwd`` and ``grad`` under
``vmap``), evaluated at every step of the nominal trajectory in one call;
the value gradient at the horizon comes from ``torch.autograd``. The time
loops are Python loops over ``horizon``. The line search evaluates its step
sizes together, as one batch, and keeps per sample the first step of least
cost, as the JAX package's sequential strict-improvement scan does. A plan
has fixed shapes and reads nothing on the host, so it can be captured in a
CUDA graph (``sim/mpc_shoot.py`` does).

Box control bounds are clamped in the forward pass; with the per-sample
line-search acceptance the iteration is monotone in the true objective.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from c3sc_tpu_torch.device import const_tensor
from c3sc_tpu_torch.models.base import Boundary, ControlProblem


def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi), with its derivative at the bounds."""
    return torch.minimum(torch.maximum(x, lo), hi)


def problem_periodic(problem: ControlProblem):
    """Per-dim bool: True where the boundary wraps."""
    return [b == Boundary.PERIODIC for b in problem.boundary]


def make_step_fn(problem: ControlProblem, dt: float):
    """``fstep(x [..., d], u [..., du]) -> x_next``: one explicit Euler step of
    the drift, clamped to the box on non-periodic dims (the planners' smooth
    surrogate of the plant's boundary semantics; periodic dims stay free, so
    an angle can swing through)."""
    periodic = problem_periodic(problem)

    def fstep(x, u):
        xn = x + problem.drift(x, u) * dt
        lb = const_tensor(problem.lb, x.dtype, x.device)
        ub = const_tensor(problem.ub, x.dtype, x.device)
        per = const_tensor(periodic, torch.bool, x.device)
        return torch.where(per, xn, _clip(xn, lb, ub))

    return fstep


def make_ilqr_plan(
    problem: ControlProblem,
    value_fn: Callable,
    dt: float,
    horizon: int,
    n_iters: int = 10,
    mu0: float = 1.0,
    alphas=(1.0, 0.3, 0.1, 0.03, 0.01, 0.003),
):
    """Build ``plan(x0 [B, d], u_init [B, H, du]) -> u [B, H, du]`` and
    ``objective(us [B, H, du], x0 [B, d]) -> J [B]``.

    Minimises  sum_t e^(-beta t dt) g(x_t, u_t) dt + e^(-beta H dt) V(x_H)
    subject to x_{t+1} = clip(x_t + dt f(x_t, u_t)) (non-periodic dims) and
    u in [ulb, uub]. A per-sample line search keeps the iteration monotone,
    and a per-sample Levenberg term mu shrinks on acceptance and grows when
    every step is rejected. ``value_fn``: points [B, d] -> values [B].
    """
    d, du = problem.dx, problem.du
    f32 = torch.float32
    neg_bdt = float(np.float32(-problem.beta) * np.float32(dt))   # -beta dt in float32
    beta = float(np.float32(problem.beta))
    fstep = make_step_fn(problem, dt)
    g_fn = problem.stage_cost

    # per-sample derivatives, batched over a flat sample axis by vmap. The
    # callables see a batch of one: on 0-d per-sample tensors vmap promotes
    # a Python scalar factor to float64
    def fstep1(x, u):
        return fstep(x[None], u[None])[0]

    def g1(x, u):
        return g_fn(x[None], u[None])[0]

    jac_f = vmap(jacfwd(fstep1, argnums=(0, 1)))
    grad_g = vmap(grad(g1, argnums=(0, 1)))
    hess_g = vmap(jacfwd(grad(g1, argnums=(0, 1)), argnums=(0, 1)))
    consts = {}

    def weights(device):
        """(w_t [H], w_H, ulb, uub, alphas [A]) on ``device``, built once."""
        if device not in consts:
            ar = torch.arange(horizon, dtype=f32, device=device)
            consts[device] = (torch.exp(torch.tensor(neg_bdt, dtype=f32, device=device) * ar),
                              torch.exp(torch.tensor(neg_bdt * np.float32(horizon), dtype=f32,
                                                     device=device)),
                              const_tensor(problem.ulb, f32, device),
                              const_tensor(problem.uub, f32, device),
                              torch.tensor(alphas, dtype=f32, device=device))
        return consts[device]

    def rollout_open(x0, us_t):
        """Nominal forward: us_t [H, B, du] -> (xs [H+1, B, d], J [B])."""
        w_t, w_H = weights(x0.device)[:2]
        x, J, xs = x0, torch.zeros(x0.shape[0], dtype=f32, device=x0.device), [x0]
        for t in range(horizon):
            J = J + w_t[t] * g_fn(x, us_t[t]) * dt
            x = fstep(x, us_t[t])
            xs.append(x)
        return torch.stack(xs), J + w_H * value_fn(x)

    def value_grad(x):
        with torch.enable_grad():
            leaf = x.detach().requires_grad_(True)
            (gv,) = torch.autograd.grad(value_fn(leaf).sum(), leaf)
        return gv

    def backward(xs, us_t, mu):
        """Riccati sweep -> (k [H, B, du], K [H, B, du, d])."""
        w_t, w_H = weights(xs.device)[:2]
        H, B = us_t.shape[:2]
        xf, uf = xs[:-1].reshape(H * B, d), us_t.reshape(H * B, du)
        A, Bm = (a.reshape(H, B, *a.shape[1:]) for a in jac_f(xf, uf))
        gx, gu = grad_g(xf, uf)
        (gxx, _), (gux, guu) = hess_g(xf, uf)
        wdt = (w_t * dt)[:, None]
        lx = wdt[..., None] * gx.reshape(H, B, d)
        lu = wdt[..., None] * gu.reshape(H, B, du)
        lxx = wdt[..., None, None] * gxx.reshape(H, B, d, d)
        luu = wdt[..., None, None] * guu.reshape(H, B, du, du)
        lux = wdt[..., None, None] * gux.reshape(H, B, du, d)
        Vx = w_H * value_grad(xs[-1])                                  # [B, d]
        # terminal curvature: the stationary cost-to-go of parking at x is
        # ~ g(x, u)/beta, whose Hessian is a smooth, correctly scaled estimate
        (gxx_H, _), _ = hess_g(xs[-1], us_t[-1])
        Vxx = (w_H / beta) * gxx_H                                     # [B, d, d]
        eye = torch.eye(du, dtype=f32, device=xs.device)
        ks, Ks = [None] * H, [None] * H
        for t in range(H - 1, -1, -1):
            At, Bt = A[t], Bm[t]
            Qx = lx[t] + torch.einsum("bij,bi->bj", At, Vx)
            Qu = lu[t] + torch.einsum("bij,bi->bj", Bt, Vx)
            Qxx = lxx[t] + torch.einsum("bia,bij,bjc->bac", At, Vxx, At)
            Quu = luu[t] + torch.einsum("bia,bij,bjc->bac", Bt, Vxx, Bt)
            Qux = lux[t] + torch.einsum("bia,bij,bjc->bac", Bt, Vxx, At)
            sol, _ = torch.linalg.solve_ex(Quu + mu[:, None, None] * eye,
                                           torch.cat([Qu[..., None], Qux], dim=-1))
            k, K = -sol[..., 0], -sol[..., 1:]
            Vx = (Qx + torch.einsum("bui,buv,bv->bi", K, Quu, k)
                  + torch.einsum("bui,bu->bi", K, Qu)
                  + torch.einsum("bui,bu->bi", Qux, k))
            Vxx = (Qxx + torch.einsum("bui,buv,bvj->bij", K, Quu, K)
                   + torch.einsum("bui,buj->bij", K, Qux)
                   + torch.einsum("bui,buj->bji", K, Qux))
            Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
            ks[t], Ks[t] = k, K
        return torch.stack(ks), torch.stack(Ks)

    def forward(x0, xs, us_t, ks, Ks):
        """Closed-loop forward with feedback at every step size at once ->
        (us_new [A, H, B, du], J [A, B])."""
        w_t, w_H, ulb, uub, al = weights(x0.device)
        nA = al.shape[0]
        x = x0.expand(nA, *x0.shape)
        J = torch.zeros(nA, x0.shape[0], dtype=f32, device=x0.device)
        us_new = []
        for t in range(horizon):
            un = (us_t[t] + al[:, None, None] * ks[t]
                  + torch.einsum("bij,abj->abi", Ks[t], x - xs[t]))
            un = _clip(un, ulb, uub)
            J = J + w_t[t] * g_fn(x, un) * dt
            x = fstep(x, un)
            us_new.append(un)
        J = J + w_H * value_fn(x.reshape(-1, d)).reshape(nA, -1)
        return torch.stack(us_new, dim=1), J

    def plan(x0, u_init):
        us_t = u_init.transpose(0, 1)                                  # [H, B, du]
        _, J = rollout_open(x0, us_t)
        mu = torch.full((x0.shape[0],), float(mu0), dtype=f32, device=x0.device)
        for _ in range(n_iters):
            xs, _ = rollout_open(x0, us_t)
            ks, Ks = backward(xs, us_t, mu)
            us_a, J_a = forward(x0, xs, us_t, ks, Ks)
            # per-sample line search, monotone against the current J: the
            # first step size of strictly least cost, as the sequential scan
            best_us, best_J = us_t, J
            for a in range(J_a.shape[0]):
                better = J_a[a] < best_J
                best_us = torch.where(better[None, :, None], us_a[a], best_us)
                best_J = torch.where(better, J_a[a], best_J)
            # adaptive Levenberg: per-sample mu shrinks on acceptance, grows
            # when every step was rejected (the local model is invalid)
            accepted = best_J < J
            mu = torch.clamp(torch.where(accepted, mu / 3.0, mu * 5.0), 1e-3, 1e6)
            us_t, J = best_us, best_J
        return us_t.transpose(0, 1).contiguous()

    return plan, lambda us, x0: rollout_open(x0, us.transpose(0, 1))[1]
