"""Plain PyTorch closed loop for the benchmark's reference: the implicit
policy's one-step lookahead, the Euler-Maruyama step with the quadcopter's
faces, and the discounted cost of a recorded trajectory. Imports nothing of
the program under test.

The policy at a state x against a value function V: the stencil's rhs of
every candidate with neighbour values V(x +- h_j e_j) (off-grid points; V
clamps them into the box), and the candidate of least rhs.
"""

from __future__ import annotations

import torch

from benchmark.reference.bellman import UniformGrid, rhs
from benchmark.reference.quadcopter import ABSORB, Quadcopter


def lookahead(model: Quadcopter, grid: UniformGrid, value_fn, x, uc, u=None):
    """rhs of every candidate uc [C, du] at states x [B, d]: [B, C], in x's
    dtype; with applied controls u [B, du] also the rhs of each: [B]."""
    B, d = x.shape
    step = torch.diag(torch.tensor(grid.h, dtype=x.dtype, device=x.device))   # [d, d]
    nb = torch.stack([x[:, None, :] + step, x[:, None, :] - step], dim=1)    # [B, 2, d, d]
    vn = value_fn(nb.reshape(-1, d)).reshape(B, 2, d)
    vp, vm = vn[:, 0], vn[:, 1]
    q = rhs(model, grid, x[None], vp[None], vm[None], uc[:, None].to(x.dtype)).T
    return q if u is None else (q, rhs(model, grid, x, vp, vm, u))


def em_step(model: Quadcopter, x, u, noise, dt: float):
    """One Euler-Maruyama step of the quadcopter from x [B, d] under u [B, du]
    with standard normal noise [B, 3], then its faces: (x_next clamped into
    the box, absorbed [B] where an absorbing coordinate left the box)."""
    xn = x + model.drift(x, u) * dt + model.noise_step(noise) * dt ** 0.5
    lb = torch.tensor(model.lb, dtype=x.dtype, device=x.device)
    ub = torch.tensor(model.ub, dtype=x.dtype, device=x.device)
    absorbed = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for k, kind in enumerate(model.boundary):
        if kind == ABSORB:
            absorbed |= (xn[:, k] < lb[k]) | (xn[:, k] > ub[k])
    return torch.minimum(torch.maximum(xn, lb), ub), absorbed


def near_face(model: Quadcopter, x, u, noise, dt: float, margin: float):
    """Where an absorbing coordinate of the unclamped step lands within
    ``margin`` of its face, float32 and float64 may decide the exit apart."""
    xn = x + model.drift(x, u) * dt + model.noise_step(noise) * dt ** 0.5
    out = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for k, kind in enumerate(model.boundary):
        if kind == ABSORB:
            out |= (torch.abs(xn[:, k] - model.lb[k]) < margin) \
                | (torch.abs(xn[:, k] - model.ub[k]) < margin)
    return out


def discounted_cost(model: Quadcopter, xs, us, alive, dt: float):
    """The realised discounted cost of recorded trajectories xs [T+1, B, d],
    us [T, B, du], alive [T+1, B]: the running cost while alive, and the
    exit cost, discounted from the step after, once on absorption: [B]."""
    T = us.shape[0]
    t = torch.arange(T, dtype=xs.dtype, device=xs.device)[:, None] * dt       # [T, 1]
    run = torch.exp(-model.beta * t) * model.stage_cost(xs[:-1], us) * dt
    newly = alive[:-1] & ~alive[1:]
    exit_ = torch.exp(-model.beta * (t + dt)) * model.exit_cost
    return torch.sum(torch.where(alive[:-1], run, 0.0) + torch.where(newly, exit_, 0.0), dim=0)


def simulate(model: Quadcopter, grid: UniformGrid, value_fn, x0, uc, noise, dt: float):
    """Closed loops of the implicit policy on ``value_fn`` from x0 [B, d] under
    noise [T, B, 3], in x0's dtype: (xs [T+1, B, d], us [T, B, du], alive
    [T+1, B], cost [B]). Absorbed trajectories hold their state."""
    uc = uc.to(x0.device, x0.dtype)
    x, xs, us = x0, [x0], []
    alive = [torch.ones(x0.shape[0], dtype=torch.bool, device=x0.device)]
    for t in range(noise.shape[0]):
        u = uc[torch.argmin(lookahead(model, grid, value_fn, x, uc), dim=1)]
        xn, absorbed = em_step(model, x, u, noise[t].to(x0.dtype), dt)
        x = torch.where(alive[-1][:, None], xn, x)
        alive.append(alive[-1] & ~absorbed)
        xs.append(x)
        us.append(u)
    xs, us, alive = torch.stack(xs), torch.stack(us), torch.stack(alive)
    return xs, us, alive, discounted_cost(model, xs, us, alive, dt)
