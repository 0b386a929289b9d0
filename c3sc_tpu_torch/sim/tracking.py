"""Time-varying-cost receding-horizon re-solve (tracking MPC) — port of
``c3sc_tpu/sim/tracking.py``.

The cost carries a parameter vector theta (for example a moving hover
target), and every cost update is a warm fused re-solve from the previous
cycle's whole solver state. Where the JAX package traces theta into one
jitted update, the port keeps ONE theta buffer on the device: the fused
solver is built once over ``problem_family(theta_buf)``, whose cost
closures read the buffer at every call, and an update is
``theta_buf.copy_(theta)`` followed by ``step_fn``. On a CUDA device that is
one graph, captured at the first solve and replayed for every theta after
it; nothing is rebuilt or recaptured when the cost moves.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device, synchronize
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.ops.tt import TT, tt_lerp_eval
from c3sc_tpu_torch.sim.integrators import rollout
from c3sc_tpu_torch.sim.policy import make_implicit_policy
from c3sc_tpu_torch.solvers.fused import make_fused_vi


@dataclasses.dataclass
class TrackingSolver:
    """Warm re-solving value function for a theta-parameterized cost."""

    init: Callable          # (theta, seed, n_iters) -> carry
    update: Callable        # (carry, theta, n_iters) -> carry
    value_fn: Callable      # (carry, p [B, d]) -> [B]
    policy: Callable        # (carry, theta, x [B, d]) -> u [B, du]
    grid: Grid
    controls: torch.Tensor  # [C, du] on the solver's device
    theta: torch.Tensor     # the buffer the solver's cost reads


def make_tracking_solver(problem_family: Callable, grid: Grid, controls, rmax: int = 16,
                         theta_example=None, solver_kwargs: dict | None = None,
                         device=None) -> TrackingSolver:
    """Build the warm re-solving tracking stack on ``device`` (None: the
    default CUDA device, where the solver replays a CUDA graph).

    ``problem_family(theta) -> ControlProblem`` with cost closures that read
    theta as a tensor at every call (``models.make_lq_family``,
    ``models.make_quadcopter_family``). ``theta_example`` gives the buffer's
    shape (default: 2 entries). ``solver_kwargs`` go to ``make_fused_vi``
    (tol 0 and no iteration cap unless given).
    """
    device = resolve_device(device)
    solver_kwargs = dict(solver_kwargs or {})
    solver_kwargs.setdefault("tol", 0.0)
    solver_kwargs.setdefault("max_iters", 10 ** 9)
    solver_kwargs.setdefault("cuda_graph", device.type == "cuda")
    shape = (2,) if theta_example is None else tuple(np.shape(theta_example))
    theta_buf = torch.zeros(shape, dtype=torch.float32, device=device)
    uc = torch.as_tensor(np.asarray(controls), dtype=torch.float32, device=device)
    solver = make_fused_vi(problem_family(theta_buf), grid, controls, rmax=rmax,
                           device=device, **solver_kwargs)

    def _set(theta):
        theta_buf.copy_(torch.as_tensor(theta, dtype=torch.float32))

    def update(carry, theta, n_iters: int):
        """The cost at theta, then exactly n_iters warm iterations."""
        _set(theta)
        return solver.step_fn(carry, n_iters)

    def init(theta, seed: int = 0, n_iters: int = 500):
        """A fresh solver state (pivot sets drawn from ``seed``), solved for
        n_iters iterations at theta."""
        return update(solver.init_fn(seed), theta, n_iters)

    def value_fn(carry, p):
        return tt_lerp_eval(TT(carry.cores, carry.ranks), grid, p)

    def policy(carry, theta, x):
        prob = problem_family(torch.as_tensor(theta, dtype=torch.float32, device=device))
        return make_implicit_policy(prob, grid, lambda p: value_fn(carry, p), uc)(x)

    return TrackingSolver(init=init, update=update, value_fn=value_fn, policy=policy,
                          grid=grid, controls=uc, theta=theta_buf)


@dataclasses.dataclass
class TrackingRunResult:
    xs: torch.Tensor            # [1 + K * steps_per_segment, B, d]
    cost: torch.Tensor          # [B] float64 realized discounted tracking cost
    replan_latency_s: list      # per cost update, device-synced
    thetas: np.ndarray          # [K, ...] the schedule


def tracking_mpc_run(
    solver: TrackingSolver,
    problem_family: Callable,
    theta_schedule,
    x0,
    dt: float = 0.01,
    steps_per_segment: int = 100,
    replan_iters: int = 40,
    first_solve_iters: int = 600,
    stale: bool = False,
    verbose: bool = False,
    seed: int = 0,
    generator: torch.Generator | None = None,
    noise=None,
) -> TrackingRunResult:
    """Closed loop against a piecewise-constant theta schedule [K, ...].

    ``stale=True`` is the ablation: the value is never re-solved after the
    first segment, while the policy still takes the greedy argmin of the
    CURRENT cost against the stale value — the baseline a tracking re-solve
    must beat. Euler–Maruyama noise: ``noise [K, steps_per_segment, B, dw]``,
    else drawn from ``generator``, else from a generator on the solver's
    device seeded with ``seed`` (which also seeds the first solve's pivots).
    """
    device = solver.theta.device
    thetas = np.asarray(theta_schedule, dtype=np.float32)
    beta = float(problem_family(thetas[0]).beta)
    if noise is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    carry = solver.init(thetas[0], seed, first_solve_iters)
    synchronize(device)

    grid = solver.grid
    x = torch.as_tensor(x0, dtype=torch.float32, device=device)
    xs_all = [x[None]]
    cost = torch.zeros(x.shape[0], dtype=torch.float64, device=device)
    lat = []
    t_sim = 0.0
    for seg in range(thetas.shape[0]):
        if seg > 0 and not stale:
            synchronize(device)
            t0 = time.perf_counter()
            carry = solver.update(carry, thetas[seg], replan_iters)
            synchronize(device)
            lat.append(time.perf_counter() - t0)
        prob = problem_family(torch.as_tensor(thetas[seg], device=device))
        v = TT(carry.cores, carry.ranks)
        policy = make_implicit_policy(prob, grid, lambda p, v=v: tt_lerp_eval(v, grid, p),
                                      solver.controls)
        with torch.no_grad():
            traj = rollout(prob, grid, policy, x, dt, steps_per_segment,
                           noise=None if noise is None else noise[seg], generator=generator)
        x = traj.xs[-1]
        xs_all.append(traj.xs[1:])
        cost = cost + math.exp(-beta * t_sim) * traj.cost.double()
        t_sim += steps_per_segment * dt
        if verbose:
            msg = f" lat={lat[-1] * 1e3:.1f}ms" if seg > 0 and not stale else ""
            print(f"[tracking] seg={seg} theta={thetas[seg]}{msg}", flush=True)
    return TrackingRunResult(xs=torch.cat(xs_all, 0), cost=cost, replan_latency_s=lat,
                             thetas=thetas)
