"""Receding-horizon MPC on the fused solver: warm replans — port of
``c3sc_tpu/sim/mpc_fused.py``.

Each replan continues the fused value iteration from the previous cycle's
whole solver state (TT cores and cross pivot sets) by ``step_fn(carry,
refine_iters)``: exactly that many iterations, then one synchronisation; the
replan latency is measured over those two. On a CUDA device the solver is
built with ``cuda_graph=True``, so a replan is one copy in, ``refine_iters``
graph replays and one copy out; on the CPU it runs the eager loop.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device, synchronize
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops.tt import TT, tt_lerp_eval
from c3sc_tpu_torch.sim.integrators import rollout
from c3sc_tpu_torch.sim.policy import make_implicit_policy
from c3sc_tpu_torch.solvers.fused import make_fused_vi


@dataclasses.dataclass
class FusedMPCResult:
    xs: torch.Tensor           # [1 + n_replans * steps_per_replan, B, d]
    us: torch.Tensor           # [n_replans * steps_per_replan, B, du]
    cost: torch.Tensor         # [B] float64 realized discounted cost
    replan_latency: list       # seconds per replan (device-synced); 0.0 for the cold solve
    residuals: list            # the carry's sample residual at each cycle
    solve_s: float             # the cold solve's wall time (device-synced)


def fused_mpc_run(
    problem: ControlProblem,
    grid: Grid,
    x0,
    dt: float,
    steps_per_replan: int,
    n_replans: int,
    controls=None,
    n_controls: int = 9,
    rmax: int = 16,
    refine_iters: int = 3,
    first_solve_iters: int = 800,
    refine_steps: int = 0,
    tol: float = 1e-4,
    verbose: bool = False,
    seed: int = 0,
    generator: torch.Generator | None = None,
    noise=None,
    device=None,
) -> FusedMPCResult:
    """Closed loop of ``n_replans`` cycles of ``steps_per_replan`` steps.

    The cold solve is ``first_solve_iters`` iterations from ``init_fn(seed)``;
    every later cycle first replans by ``refine_iters`` iterations. The
    segment rollouts use the implicit policy on the current TT value
    (``refine_steps`` continuous steps per control). Euler–Maruyama noise:
    ``noise [n_replans, steps_per_replan, B, dw]``, else drawn from
    ``generator``, else from a generator on the device seeded with ``seed``.
    ``tol`` is unused, as in the JAX package (the solver runs with tol 0).
    x0 [B, d] moves to ``device`` (None: the default CUDA device).
    """
    device = resolve_device(device)
    if controls is None:
        controls = problem.control_candidates(n_controls)
    _, init_fn, step_fn, _ = make_fused_vi(problem, grid, controls, rmax=rmax, tol=0.0,
                                           max_iters=10**9, device=device,
                                           cuda_graph=device.type == "cuda")
    if noise is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    carry = init_fn(seed)
    synchronize(device)
    t0 = time.perf_counter()
    carry = step_fn(carry, first_solve_iters)
    synchronize(device)
    solve_s = time.perf_counter() - t0
    uc = torch.as_tensor(np.asarray(controls), dtype=torch.float32, device=device)

    x = torch.as_tensor(x0, dtype=torch.float32, device=device)
    xs_all, us_all = [x[None]], []
    cost = torch.zeros(x.shape[0], dtype=torch.float64, device=device)
    lat, residuals = [], []
    t_sim = 0.0
    for cycle in range(n_replans):
        if cycle > 0:
            synchronize(device)
            t0 = time.perf_counter()
            carry = step_fn(carry, refine_iters)
            synchronize(device)
            lat.append(time.perf_counter() - t0)
        else:
            lat.append(0.0)  # the cold solve is accounted separately
        residuals.append(float(carry.residual))
        v = TT(carry.cores, carry.ranks)
        policy = make_implicit_policy(problem, grid, lambda p, v=v: tt_lerp_eval(v, grid, p),
                                      uc, refine_steps=refine_steps)
        with torch.no_grad():
            traj = rollout(problem, grid, policy, x, dt, steps_per_replan,
                           noise=None if noise is None else noise[cycle], generator=generator)
        x = traj.xs[-1]
        xs_all.append(traj.xs[1:])
        us_all.append(traj.us)
        cost = cost + math.exp(-problem.beta * t_sim) * traj.cost.double()
        t_sim += steps_per_replan * dt
        if verbose:
            print(f"[fused_mpc] cycle={cycle} latency={lat[-1] * 1e3:.1f}ms "
                  f"res={residuals[-1]:.2e}", flush=True)
    return FusedMPCResult(xs=torch.cat(xs_all, 0), us=torch.cat(us_all, 0), cost=cost,
                          replan_latency=lat, residuals=residuals, solve_s=solve_s)
