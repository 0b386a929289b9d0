"""Batched SDE/ODE integrators and Monte-Carlo rollouts — port of
``c3sc_tpu/sim/integrators.py``.

A whole batch of scenarios advances in lockstep; absorbing boundaries
freeze a trajectory and charge the discounted exit cost once. Where the JAX
package draws Euler–Maruyama noise inside its scan from a key, ``rollout``
here takes the noise ``[T, B, dw]`` explicitly or draws it step by step
from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import Boundary, ControlProblem

METHODS = ("euler_maruyama", "euler", "rk4", "rkf45")


class Trajectory(NamedTuple):
    """Batched rollout record."""

    xs: torch.Tensor         # [T+1, B, d] states
    us: torch.Tensor         # [T, B, du] controls applied
    cost: torch.Tensor       # [B] realized discounted cost
    alive: torch.Tensor      # [T+1, B] bool — False once absorbed
    exit_time: torch.Tensor  # [B] absorption time (= T*dt if never)


def trajectory_save(path: str, traj: Trajectory) -> None:
    """Persist a batched rollout record as one npz (the JAX package's keys)."""
    np.savez_compressed(path, **{k: t.detach().cpu().numpy()
                                 for k, t in traj._asdict().items()})


def trajectory_load(path: str, device=None) -> Trajectory:
    """Read a record back onto ``device`` (None: the default CUDA device)."""
    device = resolve_device(device)
    with np.load(path) as z:
        return Trajectory(**{k: torch.as_tensor(z[k], device=device)
                             for k in Trajectory._fields})


def _apply_boundaries(problem: ControlProblem, grid: Grid, x):
    """Post-step boundary projection: (x_projected, absorbed_mask).

    Periodic dims wrap, reflect dims clamp; absorbing dims leaving the box
    (or entering an obstacle) absorb.
    """
    lb = torch.as_tensor(problem.lb, dtype=x.dtype, device=x.device)
    ub = torch.as_tensor(problem.ub, dtype=x.dtype, device=x.device)
    x = grid.wrap_state(x)
    absorbed = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    cols = []
    for k in range(problem.dx):
        xk = x[..., k]
        if problem.boundary[k] == Boundary.ABSORB:
            absorbed = absorbed | (xk < lb[k]) | (xk > ub[k])
        if problem.boundary[k] != Boundary.PERIODIC:
            xk = torch.clamp(xk, lb[k], ub[k])
        cols.append(xk)
    x = torch.stack(cols, dim=-1)
    return x, absorbed | problem.in_obstacle(x)


def _exit_value(problem: ControlProblem, x):
    psi = torch.broadcast_to(problem.boundary_cost(x), x.shape[:-1])
    if problem.obstacles:
        psi = torch.where(problem.in_obstacle(x), problem.obstacle_cost(x), psi)
    return psi


def _advance(problem: ControlProblem, method: str, x, u, dtf, sqdt, noise):
    """One integrator step from x under the held control u."""
    f = lambda xx: problem.drift(xx, u)
    if method == "rk4":
        k1 = f(x)
        k2 = f(x + 0.5 * dtf * k1)
        k3 = f(x + 0.5 * dtf * k2)
        k4 = f(x + dtf * k3)
        return x + (dtf / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    if method == "rkf45":
        # Runge-Kutta-Fehlberg 4(5), fixed step, 5th-order solution
        k1 = f(x)
        k2 = f(x + dtf * (k1 / 4.0))
        k3 = f(x + dtf * (3 * k1 + 9 * k2) / 32.0)
        k4 = f(x + dtf * (1932 * k1 - 7200 * k2 + 7296 * k3) / 2197.0)
        k5 = f(x + dtf * (439 * k1 / 216 - 8 * k2 + 3680 * k3 / 513
                          - 845 * k4 / 4104))
        k6 = f(x + dtf * (-8 * k1 / 27 + 2 * k2 - 3544 * k3 / 2565
                          + 1859 * k4 / 4104 - 11 * k5 / 40))
        return x + dtf * (16 * k1 / 135 + 6656 * k3 / 12825
                          + 28561 * k4 / 56430 - 9 * k5 / 50 + 2 * k6 / 55)
    if method == "euler":
        return x + f(x) * dtf
    L = problem.diff(x, u)
    return x + f(x) * dtf + torch.einsum("bij,bj->bi", L, noise) * sqdt


def rollout(
    problem: ControlProblem,
    grid: Grid,
    policy: Callable,
    x0,
    dt: float,
    n_steps: int,
    noise=None,
    generator: torch.Generator | None = None,
    policy_every: int = 1,
    method: str = "euler_maruyama",
) -> Trajectory:
    """Closed-loop rollouts.

    x0: [B, d] initial states;  policy: x [B, d] -> u [B, du].
    noise: [n_steps, B, dw] standard normal increments for Euler–Maruyama;
      without it, each step draws them from ``generator`` on x0's device.
    policy_every: recompute the implicit argmin every k steps, holding the
      control in between.
    method: 'euler_maruyama' (SDE, default), 'euler', 'rk4' or 'rkf45'.
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    B = x0.shape[0]
    stochastic = method == "euler_maruyama"
    if stochastic and noise is not None and tuple(noise.shape) != (n_steps, B, problem.dw):
        raise ValueError(f"noise must be [{n_steps}, {B}, {problem.dw}], got {tuple(noise.shape)}")
    if stochastic and noise is None and generator is None:
        raise ValueError("euler_maruyama needs noise= or generator=")
    dev, dtype = x0.device, x0.dtype
    dtf = torch.tensor(dt, dtype=dtype, device=dev)
    sqdt = torch.sqrt(dtf)
    x = x0
    u = torch.zeros((B, problem.du), dtype=dtype, device=dev)
    cost = torch.zeros(B, dtype=dtype, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    t = torch.zeros((), dtype=dtype, device=dev)
    texit = torch.full((B,), n_steps * dt, dtype=dtype, device=dev)
    xs, us, alives = [x0], [], [alive]
    for i in range(n_steps):
        if i % policy_every == 0:
            u = policy(x)
        nz = None
        if stochastic:
            nz = noise[i] if noise is not None else torch.randn(
                (B, problem.dw), generator=generator, dtype=dtype, device=dev)
        xn, absorbed_now = _apply_boundaries(
            problem, grid, _advance(problem, method, x, u, dtf, sqdt, nz))
        newly = absorbed_now & alive
        disc = torch.exp(-problem.beta * t)
        # running cost while alive; exit cost charged once on absorption
        zero = torch.zeros_like(cost)
        cost = cost + torch.where(alive, disc * problem.stage_cost(x, u) * dtf, zero)
        cost = cost + torch.where(
            newly, torch.exp(-problem.beta * (t + dtf)) * _exit_value(problem, xn), zero)
        alive_next = alive & ~absorbed_now
        x = torch.where(alive[:, None], xn, x)  # freeze absorbed trajectories
        texit = torch.where(newly, t + dtf, texit)
        t = t + dtf
        alive = alive_next
        xs.append(x)
        us.append(u)
        alives.append(alive)
    return Trajectory(xs=torch.stack(xs), us=torch.stack(us), cost=cost,
                      alive=torch.stack(alives), exit_time=texit)
