"""Batched inner minimization over controls — port of
``c3sc_tpu/ops/argmin.py``.

Every node optimizes at once, for a fixed number of iterations, with a
parallel line search: each iteration evaluates all trial steps and keeps the
best, the current point included, so the objective never increases.

- ``brute_force_minimize``: the candidate set and an argmin;
- ``pgd_minimize``: projected gradient from the start point u0;
- ``lbfgs_minimize``: box L-BFGS (two-loop recursion batched over nodes),
  with projected-gradient trials as a guard against bad curvature.

Gradients come from ``torch.autograd.grad`` of ``f(u).sum()`` on a fresh leaf
``u`` under ``torch.enable_grad()``, so the optimizers work inside the
``torch.no_grad()`` of a solver loop, and nothing reads the device on the
host: they can run inside a CUDA graph capture. Ties of an argmin go to
the lowest index, as in ``jnp.argmin``. ``f`` maps u ``[B, du]`` to ``[B]``;
trial points are evaluated one ``f`` call per trial step.
"""

from __future__ import annotations

from typing import Callable

import torch

from c3sc_tpu_torch.device import const_tensor

DEFAULT_STEPS = (1.0, 0.3, 0.1, 0.03, 0.01)


def first_argmin(a, dim: int = 0):
    """Index of the first minimum along ``dim``, the same on every device
    (``torch.argmin`` promises no order among ties on CUDA). NaN counts as
    the smallest value, as in ``jnp.argmin``."""
    a = torch.nan_to_num(a, nan=float("-inf"))
    shape = [1] * a.ndim
    shape[dim] = a.shape[dim]
    ar = torch.arange(a.shape[dim], device=a.device).reshape(shape)
    return torch.where(a == a.amin(dim, keepdim=True), ar, a.shape[dim]).amin(dim)


def _grad(f: Callable, u):
    """d f(u).sum() / du, as a tensor without a graph."""
    with torch.enable_grad():
        leaf = u.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(f(leaf).sum(), leaf)
    return g


def _unit(g):
    return g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-12)


def _bounds(lb, ub, u0):
    return (const_tensor(lb, u0.dtype, u0.device).broadcast_to(u0.shape[-1:]),
            const_tensor(ub, u0.dtype, u0.device).broadcast_to(u0.shape[-1:]))


def _best(f: Callable, u, fu, props):
    """Keep the best of the current point and the trial points props
    [S, B, du]: (u [B, du], f [B])."""
    all_u = torch.cat([u[None], props], dim=0)                   # [S+1, B, du]
    all_f = torch.stack([fu] + [f(p) for p in props], dim=0)     # [S+1, B]
    best = first_argmin(all_f, 0)                                # [B]
    fn = torch.gather(all_f, 0, best[None])[0]
    un = torch.gather(all_u, 0, best[None, :, None].expand(1, *u.shape))[0]
    return un, fn


def pgd_minimize(f: Callable, u0, lb, ub, n_iters: int = 10, step_sizes=DEFAULT_STEPS):
    """Batched box-constrained minimization by projected gradient.

    u0 [B, du] starts. Per iteration: the batched gradient, the proposals
    clip(u - s * g/|g| * span) for every trial step s (span: the box's
    width per control), all evaluated, the best kept. Returns
    (u_opt [B, du], f_opt [B]).
    """
    lb, ub = _bounds(lb, ub, u0)
    span = ub - lb
    steps = const_tensor(step_sizes, u0.dtype, u0.device)
    with torch.no_grad():
        u = torch.clamp(u0.detach(), lb, ub)
        fu = f(u)
        for _ in range(n_iters):
            gn = _unit(_grad(f, u))
            props = torch.clamp(u[None] - steps[:, None, None] * gn[None] * span, lb, ub)
            u, fu = _best(f, u, fu, props)
    return u, fu


def lbfgs_minimize(f: Callable, u0, lb, ub, n_iters: int = 15, history: int = 5,
                   step_sizes=(1.0, 0.5, 0.1, 0.03, 0.01)):
    """Batched box-constrained L-BFGS: the two-loop recursion over the last
    ``history`` steps (rows with no curvature have rho = 0 and contribute
    nothing), unit steps scaled to the box's span, projected trials along
    the L-BFGS direction and along the negative gradient, the best kept.
    Returns (u_opt [B, du], f_opt [B])."""
    lb, ub = _bounds(lb, ub, u0)
    span = ub - lb
    steps = const_tensor(step_sizes, u0.dtype, u0.device)
    m = history
    B, du = u0.shape

    def direction(g, S, Y, rho):
        q = g
        alphas = []
        for i in range(m - 1, -1, -1):
            a = rho[i] * torch.sum(S[i] * q, dim=-1)              # [B]
            q = q - a[:, None] * Y[i]
            alphas.append(a)
        alphas = alphas[::-1]
        yy = torch.sum(Y[m - 1] * Y[m - 1], dim=-1)
        sy = torch.sum(S[m - 1] * Y[m - 1], dim=-1)
        gamma = torch.where(yy > 1e-12, sy / (yy + 1e-12), torch.ones_like(yy))
        r = gamma[:, None] * q
        for i in range(m):
            b = rho[i] * torch.sum(Y[i] * r, dim=-1)
            r = r + S[i] * (alphas[i] - b)[:, None]
        return -r

    with torch.no_grad():
        u = torch.clamp(u0.detach(), lb, ub)
        fu = f(u)
        g = _grad(f, u)
        S = torch.zeros((m, B, du), dtype=u.dtype, device=u.device)
        Y = torch.zeros_like(S)
        rho = torch.zeros((m, B), dtype=u.dtype, device=u.device)
        for _ in range(n_iters):
            dn = _unit(direction(g, S, Y, rho))
            props = torch.clamp(u[None] + steps[:, None, None] * dn[None] * span, lb, ub)
            props_g = torch.clamp(u[None] - steps[:, None, None] * _unit(g)[None] * span, lb, ub)
            un, fu = _best(f, u, fu, torch.cat([props, props_g], dim=0))
            gnew = _grad(f, un)
            s_vec, y_vec = un - u, gnew - g
            sy = torch.sum(s_vec * y_vec, dim=-1)
            rho_new = torch.where(sy > 1e-10, 1.0 / (sy + 1e-12), torch.zeros_like(sy))
            S = torch.cat([S[1:], s_vec[None]], dim=0)
            Y = torch.cat([Y[1:], y_vec[None]], dim=0)
            rho = torch.cat([rho[1:], rho_new[None]], dim=0)
            u, g = un, gnew
    return u, fu


def brute_force_minimize(f: Callable, candidates):
    """f: [C, du] -> [C, B] objective per candidate; returns
    (u_best [B, du], f_best [B])."""
    vals = f(candidates)                                          # [C, B]
    best = first_argmin(vals, 0)
    return candidates[best], torch.gather(vals, 0, best[None])[0]
