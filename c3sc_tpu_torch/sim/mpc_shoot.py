"""Receding-horizon MPC over the learned value function — the counterpart of
``c3sc_tpu/sim/mpc_shoot.py``.

Each replan optimises a whole control trajectory (certainty-equivalent
receding horizon):

    min_{u_0..u_{H-1}}  sum_t e^{-beta t dt} g(x_t, u_t) dt + e^{-beta H dt} V(x_H),
    x_{t+1} = x_t + dt f(x_t, u_t),   u_t in [ulb, uub],

with either planner: ``"ilqr"`` (``sim/ilqr.py``, the flagship's) or the
projected-Adam gradient shooting of ``make_plan_fn``, whose gradients come
from ``torch.autograd`` through the whole horizon. The stage-cost integral
re-anchors the attractor that a value error tilts. With ``controls`` given,
every replan warm-starts from the per-sample better of the shifted previous
plan and a fresh deterministic greedy rollout from the current state.

The plant is the true stochastic system with the true boundary semantics and
cost accounting of ``sim/integrators.rollout``; its Euler–Maruyama noise is
an explicit tensor ``[n_steps, B, dw]`` or is drawn step by step from a
``torch.Generator``, where the JAX package splits a key. On a CUDA device a
replan is captured once as a CUDA graph and replayed at every replan (it has
fixed shapes and reads nothing on the host).

Dual-mode MPC (``terminal_lqr=``, off by default as in the JAX package): a
``sim.terminal.TerminalLQR`` hands each sample, from the step it first enters
the goal basin on, to the exact discounted LQR at the goal. The latch is a
``[B]`` bool carried through the step loop; it lies outside the replan's
graph and costs a few elementwise operations a step, with no host read.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from c3sc_tpu_torch.device import const_tensor, synchronize
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.sim.ilqr import _clip, make_ilqr_plan, make_step_fn, problem_periodic
from c3sc_tpu_torch.sim.integrators import Trajectory, _apply_boundaries, _exit_value
from c3sc_tpu_torch.sim.terminal import terminal_control

PLANNERS = ("ilqr", "shooting")
__all__ = ["PLANNERS", "problem_periodic", "make_plan_fn", "receding_horizon_rollout"]


def make_plan_fn(problem: ControlProblem, value_fn: Callable, dt: float, horizon: int,
                 opt_iters: int = 30, lr: float = 0.15):
    """Build ``plan(x [B, d], u_seq [B, H, du]) -> u_seq``, projected-Adam
    trajectory optimisation of the shooting objective warm-started from the
    previous plan, and ``objective_per_sample(u_seq, x0) -> [B]``."""
    f32 = torch.float32
    fstep = make_step_fn(problem, dt)

    def objective_per_sample(u_seq, x0):
        """Discounted horizon cost + terminal value, per batch sample [B]."""
        x = x0
        t = torch.zeros((), dtype=f32, device=x0.device)
        costs = []
        for i in range(u_seq.shape[1]):
            u_t = u_seq[:, i]
            costs.append(torch.exp(-problem.beta * t) * problem.stage_cost(x, u_t) * dt)
            # the differentiable box projection is the planner's surrogate;
            # the plant applies the true semantics
            x = fstep(x, u_t)
            t = t + dt
        return torch.stack(costs).sum(0) + torch.exp(-problem.beta * t) * value_fn(x)

    def grad_fn(u, x0):
        # samples are independent: the gradient of the sum is per sample
        with torch.enable_grad():
            leaf = u.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(objective_per_sample(leaf, x0).sum(), leaf)
        return g

    def plan(x0, u_seq):
        """Projected Adam with per-sample monotone acceptance: the best-J
        sequence is kept per sample, so the planner can polish its warm
        start but never trade it away."""
        ulb = const_tensor(problem.ulb, f32, x0.device)
        uub = const_tensor(problem.uub, f32, x0.device)
        J_best = objective_per_sample(u_seq, x0)
        u, u_best = u_seq, u_seq
        m, v = torch.zeros_like(u_seq), torch.zeros_like(u_seq)
        for i in range(opt_iters):
            g = grad_fn(u, x0)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1.0 - 0.9 ** (i + 1.0))
            vh = v / (1.0 - 0.999 ** (i + 1.0))
            u = _clip(u - lr * mh / (torch.sqrt(vh) + 1e-8), ulb, uub)
            J = objective_per_sample(u, x0)
            better = J < J_best
            u_best = torch.where(better[:, None, None], u, u_best)
            J_best = torch.where(better, J, J_best)
        return u_best

    return plan, objective_per_sample


def _greedy_useq(problem: ControlProblem, grid: Grid, pol, x0, dt: float, horizon: int):
    """Deterministic greedy rollout -> [B, H, du] control sequence."""
    x, us = x0, []
    for _ in range(horizon):
        u = pol(x)
        x, _ = _apply_boundaries(problem, grid, x + problem.drift(x, u) * dt)
        us.append(u)
    return torch.stack(us, dim=1)


class _GraphedCall:
    """``fn(*tensors)`` captured once as a CUDA graph on static input
    buffers: a call copies its inputs in, replays, and returns a clone of the
    output. The capture follows one warm-up call on a side stream."""

    captures = 0

    def __init__(self, fn):
        self.fn, self.graph = fn, None

    def __call__(self, *args):
        if self.graph is None:
            self.inputs = tuple(a.clone() for a in args)
            dev = args[0].device
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.fn(*self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.output = self.fn(*self.inputs)
            _GraphedCall.captures += 1
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        return self.output.clone()


def _rh_rollout(problem, grid, value_fn, x0, u_init, dt, n_steps, horizon, replan_every,
                opt_iters, lr, greedy_seed=None, planner="ilqr", noise=None, generator=None,
                replan_times=None, terminal_lqr=None):
    B = x0.shape[0]
    dev, dtype = x0.device, x0.dtype
    if planner == "ilqr":
        plan, obj_ps = make_ilqr_plan(problem, value_fn, dt, horizon, n_iters=opt_iters)
    else:
        plan, obj_ps = make_plan_fn(problem, value_fn, dt, horizon, opt_iters, lr)

    def replan(x, u_seq):
        if greedy_seed is not None:
            # the shifted previous plan goes stale under plant noise; a fresh
            # deterministic greedy rollout from the CURRENT state is the
            # feedback-stabilised alternative: seed with the per-sample better
            u_g = greedy_seed(x)
            better = obj_ps(u_g, x) < obj_ps(u_seq, x)
            u_seq = torch.where(better[:, None, None], u_g, u_seq)
        return plan(x, u_seq)

    if dev.type == "cuda":
        replan = _GraphedCall(replan)
    dtf = torch.tensor(dt, dtype=dtype, device=dev)
    sqdt = torch.sqrt(dtf)
    x, u_seq = x0, u_init
    cost = torch.zeros(B, dtype=dtype, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    t = torch.zeros((), dtype=dtype, device=dev)
    texit = torch.full((B,), n_steps * dt, dtype=dtype, device=dev)
    if terminal_lqr is not None:
        tmode = torch.zeros(B, dtype=torch.bool, device=dev)   # the dual-mode latch
        ulb = const_tensor(problem.ulb, dtype, dev)
        uub = const_tensor(problem.uub, dtype, dev)
    xs, us, alives = [x0], [], [alive]
    for i in range(n_steps):
        if i % replan_every == 0:
            if replan_times is None:
                u_seq = replan(x, u_seq)
            else:
                synchronize(dev)
                t0 = time.perf_counter()
                u_seq = replan(x, u_seq)
                synchronize(dev)
                replan_times.append(time.perf_counter() - t0)
        u = u_seq[:, 0]
        if terminal_lqr is not None:
            # dual-mode MPC: once a sample first enters the terminal basin it
            # stays with the goal's LQR (a momentary membership test lets a
            # tilted value field fight the LQR at the basin's shell)
            u_lqr, in_basin = terminal_control(terminal_lqr, x, ulb, uub)
            tmode = tmode | in_basin
            u = torch.where(tmode[:, None], u_lqr, u)
        # plant: true stochastic dynamics, true boundary semantics, the cost
        # accounting of integrators.rollout
        nz = noise[i] if noise is not None else torch.randn(
            (B, problem.dw), generator=generator, dtype=dtype, device=dev)
        xn = (x + problem.drift(x, u) * dtf
              + torch.einsum("bij,bj->bi", problem.diff(x, u), nz) * sqdt)
        xn, absorbed_now = _apply_boundaries(problem, grid, xn)
        newly = absorbed_now & alive
        zero = torch.zeros_like(cost)
        cost = cost + torch.where(alive, torch.exp(-problem.beta * t)
                                  * problem.stage_cost(x, u) * dtf, zero)
        cost = cost + torch.where(
            newly, torch.exp(-problem.beta * (t + dtf)) * _exit_value(problem, xn), zero)
        alive_next = alive & ~absorbed_now
        x = torch.where(alive[:, None], xn, x)
        texit = torch.where(newly, t + dtf, texit)
        t = t + dtf
        alive = alive_next
        # receding horizon: consume the applied action, hold the last
        u_seq = torch.cat([u_seq[:, 1:], u_seq[:, -1:]], dim=1)
        xs.append(x)
        us.append(u)
        alives.append(alive)
    return Trajectory(xs=torch.stack(xs), us=torch.stack(us), cost=cost,
                      alive=torch.stack(alives), exit_time=texit)


def receding_horizon_rollout(
    problem: ControlProblem,
    grid: Grid,
    value_fn: Callable,
    x0,
    dt: float,
    n_steps: int,
    horizon: int = 128,
    replan_every: int = 4,
    opt_iters: int = 10,
    lr: float = 0.05,
    u_init=None,
    controls=None,
    planner: str = "ilqr",
    noise=None,
    generator: torch.Generator | None = None,
    replan_times: list | None = None,
    terminal_lqr=None,
) -> Trajectory:
    """Closed-loop receding-horizon MPC rollout (module docstring), on the
    device of x0 [B, d].

    value_fn: batched points [B, d] -> values [B] (TT ``tt_lerp_eval``, dense
    ``multilinear_interp`` or the composite TT + patch field), the cost-to-go
    beyond the horizon. ``planner``: ``"ilqr"`` (``opt_iters`` iLQR
    iterations) or ``"shooting"`` (``opt_iters`` projected-Adam steps at
    ``lr``). ``controls``: the candidate set of the greedy re-seeding (and of
    ``u_init``'s greedy start); without it the first plan holds the middle
    of the control box. noise: [n_steps, B, dw] standard normal plant
    increments; without it, each step draws them from ``generator``.
    On a CUDA device the first replan is captured as a CUDA graph, which
    every later replan replays. ``replan_times``: a list to which the device-synced wall time of every
    replan is appended, in seconds (the first includes the graph's capture).
    ``terminal_lqr``: a ``sim.terminal.TerminalLQR`` on x0's device turns on
    dual-mode MPC (the module docstring); None, the default, is pure MPC.
    Plant noise, boundaries and cost accounting match
    ``integrators.rollout``, so common-random-number comparisons against the
    greedy implicit policy are like for like.
    """
    from c3sc_tpu_torch.sim.policy import make_implicit_policy

    if planner not in PLANNERS:
        raise ValueError(f"planner must be one of {PLANNERS}, got {planner!r}")
    B = x0.shape[0]
    if noise is not None and tuple(noise.shape) != (n_steps, B, problem.dw):
        raise ValueError(f"noise must be [{n_steps}, {B}, {problem.dw}], got {tuple(noise.shape)}")
    if noise is None and generator is None:
        raise ValueError("receding_horizon_rollout needs noise= or generator=")
    if terminal_lqr is not None and terminal_lqr.K.device != x0.device:
        raise ValueError(f"terminal_lqr is on {terminal_lqr.K.device}, x0 on {x0.device}")
    greedy_seed = None
    if controls is not None:
        uc = torch.as_tensor(controls, dtype=torch.float32, device=x0.device)
        pol = make_implicit_policy(problem, grid, value_fn, uc)
        greedy_seed = lambda x: _greedy_useq(problem, grid, pol, x, float(dt), int(horizon))  # noqa: E731
    with torch.no_grad():
        if u_init is None or isinstance(u_init, str):
            if greedy_seed is not None:
                u_init = greedy_seed(x0)
            else:
                umid = 0.5 * (const_tensor(problem.ulb, torch.float32, x0.device)
                              + const_tensor(problem.uub, torch.float32, x0.device))
                u_init = umid.expand(B, horizon, problem.du).contiguous()
        return _rh_rollout(problem, grid, value_fn, x0, u_init, float(dt), int(n_steps),
                           int(horizon), int(replan_every), int(opt_iters), float(lr),
                           greedy_seed=greedy_seed, planner=planner, noise=noise,
                           generator=generator, replan_times=replan_times,
                           terminal_lqr=terminal_lqr)
