"""Receding-horizon stochastic MPC on the host-path solver — port of
``c3sc_tpu/sim/mpc.py``.

Each replan cycle
  1. refines the TT value against the (possibly time-varying) problem with
     ``tt_vi``, warm-started from the previous cycle's cores and cross index
     sets: typically 1-2 cheap warm iterations;
  2. advances the whole batch of plants ``steps_per_replan`` Euler–Maruyama
     steps under the implicit TT policy;
  3. records the replan latency (the real-time budget metric), measured to
     the end of the device's work.
Where the JAX package splits a key for every solve and rollout, the port
takes ``noise=`` (explicit increments), ``generator=`` or ``seed`` for the
rollouts, as ``sim/mpc_fused.py`` does, and ``seed`` for the solves.
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
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops.tt import tt_lerp_eval
from c3sc_tpu_torch.sim.integrators import rollout
from c3sc_tpu_torch.sim.policy import make_implicit_policy
from c3sc_tpu_torch.solvers.ttvi import tt_vi


@dataclasses.dataclass
class MPCResult:
    xs: torch.Tensor          # [T+1, B, d]
    us: torch.Tensor          # [T, B, du]
    cost: torch.Tensor        # [B] float64 realized discounted cost
    replan_latency: list      # seconds per replan cycle (device-synced)
    residuals: list           # solver residual per cycle
    ranks: list               # value TT max rank per cycle


def mpc_run(
    problem: ControlProblem | Callable[[float], ControlProblem],
    grid: Grid,
    x0,
    dt: float,
    steps_per_replan: int,
    n_replans: int,
    controls=None,
    n_controls: int = 9,
    rmax: int = 16,
    refine_iters: int = 2,
    first_solve_iters: int = 300,
    solver_kwargs: dict | None = None,
    verbose: bool = False,
    seed: int = 0,
    generator: torch.Generator | None = None,
    noise=None,
    device=None,
) -> MPCResult:
    """Closed-loop MPC: solve -> act -> re-solve, warm-started throughout, on
    ``device`` (None: the default CUDA device; x0 [B, d] moves there).

    ``problem`` may be a fixed ControlProblem or a callable t -> problem for
    time-varying costs or dynamics. ``solver_kwargs`` go to every ``tt_vi``
    call (default ``cross_sweeps=1, chunk=2048``; the warm replans drop its
    ``tol`` and run ``refine_iters`` iterations at tol 0). Euler–Maruyama
    noise: ``noise [n_replans, steps_per_replan, B, dw]``, else drawn from
    ``generator``, else from a generator on the device seeded with ``seed``.
    ``seed`` also seeds the solves (the cold one with ``seed``, replan c with
    ``seed + c``).
    """
    device = resolve_device(device)
    time_varying = callable(problem)
    prob0 = problem(0.0) if time_varying else problem
    if controls is None:
        controls = prob0.control_candidates(n_controls)
    kw = dict(cross_sweeps=1, chunk=2048)
    kw.update(solver_kwargs or {})
    if noise is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)

    sol = tt_vi(prob0, grid, controls=controls, rmax=rmax, seed=seed,
                max_iters=first_solve_iters, device=device, **kw)
    state, v = sol.state, sol.v
    uc = torch.as_tensor(np.asarray(controls), dtype=torch.float32, device=device)

    x = torch.as_tensor(x0, dtype=torch.float32, device=device)
    xs_all, us_all = [x[None]], []
    cost = torch.zeros(x.shape[0], dtype=torch.float64, device=device)
    lat, residuals, ranks = [], [], []
    t_sim = 0.0
    prob_t = prob0
    refine_kw = {k: val for k, val in kw.items() if k != "tol"}
    for cycle in range(n_replans):
        if time_varying and cycle > 0:
            prob_t = problem(t_sim)
        synchronize(device)
        t0 = time.perf_counter()
        if cycle > 0:
            sol = tt_vi(prob_t, grid, controls=controls, rmax=rmax, seed=seed + cycle,
                        max_iters=refine_iters, tol=0.0, v0=v, state=state, device=device,
                        **refine_kw)
            state, v = sol.state, sol.v
        synchronize(device)
        lat.append(time.perf_counter() - t0)
        residuals.append(sol.residual)
        ranks.append(int(v.ranks.max()))
        policy = make_implicit_policy(prob_t, grid, lambda p, v=v: tt_lerp_eval(v, grid, p), uc)
        with torch.no_grad():
            traj = rollout(prob_t, grid, policy, x, dt, steps_per_replan,
                           noise=None if noise is None else noise[cycle], generator=generator)
        x = traj.xs[-1]
        xs_all.append(traj.xs[1:])
        us_all.append(traj.us)
        cost = cost + math.exp(-prob_t.beta * t_sim) * traj.cost.double()
        t_sim += steps_per_replan * dt
        if verbose:
            print(f"[mpc] cycle={cycle} latency={lat[-1] * 1e3:.1f}ms res={sol.residual:.2e} "
                  f"rank={ranks[-1]}", flush=True)
    return MPCResult(xs=torch.cat(xs_all, 0), us=torch.cat(us_all, 0), cost=cost,
                     replan_latency=lat, residuals=residuals, ranks=ranks)
