#!/usr/bin/env python3
"""Where kernel K1 of c3sc_tpu_torch and its solver loop spend their time on
one NVIDIA GPU. Run from the repo root:

    python3 experiments/torch_k1_profile.py

Prints, after the card's name and power limit:
  1  the host's time to enqueue one improve and one evaluate launch (pendulum
     31^2, where the device is never the limit);
  2  for the quadcopter at 9^6 and 11^6: a warm chunk of 25 outer sweeps of
     dense_vi under torch.profiler, eager and graphed (an outer sweep a CUDA
     graph, dense_vi's default on the card) — wall, device-busy time by
     kernel, idle share — and the same chunk's wall without the profiler;
  3  on the quadcopter 9^6, the glider 41^4 (K1's general entries) and
     Dubins 41^3: a warm chunk of 25 outer sweeps eager and graphed, wall a
     chunk and an outer sweep, the results bit-equal; then whole dense_vi
     solves (chip_smoke.py's settings) eager, graphed, graphed, eager, eager,
     graphed: walls,
     and the graphs' capture time;
  4  the 9^6 quadcopter's local patch (7^6 at margin 1, faces from
     dense_vi's 9^6 value, tol 1e-5): whole solve_local_patch walls in the
     same order, bit-equal.
Everything raises on failure. Imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402  (the timing and comparison helpers)
from c3sc_tpu_torch.models import make_problem  # noqa: E402
from c3sc_tpu_torch.ops import dense_backup as db  # noqa: E402
from c3sc_tpu_torch.solvers import dense_vi  # noqa: E402
from c3sc_tpu_torch.solvers.dense import GraphedSweeps, make_dense_step  # noqa: E402

log = cs.log


def host_enqueue_us(n_launches=2000):
    prob = make_problem("pendulum")
    grid = prob.default_grid(31)
    ops = db.make_dense_operands(prob, grid, prob.control_candidates(5))
    v = torch.zeros(grid.shape, device=ops.x.device)
    _, best = db.dense_backup(ops, v)
    for name, fn in (("improve", lambda: db.dense_backup(ops, v)),
                     ("evaluate", lambda: db.dense_evaluate(ops, v, best))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_launches):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        log(f"[1] host time to enqueue one {name} launch (pendulum 31^2, {n_launches} "
            f"launches): {1e6 * host / n_launches:.1f} us")


def chunk_profile(n, graphed, chunk=25):
    from torch.profiler import ProfilerActivity, profile

    prob = make_problem("quadcopter", **cs.QUAD)
    grid = prob.default_grid(n)
    step, v = make_dense_step(prob, grid, prob.control_candidates(5), eval_sweeps=10,
                              cuda_graph=graphed)
    for _ in range(2):  # warm
        v, res = step(v, chunk)
        float(res)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, res = step(v, chunk)
        float(res)
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, res = step(v, chunk)
        float(res)
        profiled = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        raise RuntimeError("torch.profiler recorded no device time")
    wall = float(np.median(walls))
    kind = "graphed" if graphed else "eager"
    log(f"[2] quadcopter {n}^6 warm chunk of {chunk} outer sweeps, {kind}: wall {wall:.3f} ms "
        f"(median of 3: {', '.join(f'{w:.3f}' for w in walls)}), profiled wall {profiled:.3f} ms, "
        f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f} of the unprofiled wall, "
        f"{1 - busy / profiled:.3f} of the profiled one")
    for ms, count, key in sorted(rows, reverse=True)[:4]:
        log(f"[2]   {ms:.3f} ms in {count} launches ({ms / count:.4f} ms each): {key[:90]}")


def _chunk_walls(step, v, chunk, reps=3):
    for _ in range(2):  # warm (the graphed step captures at its first call)
        v, res = step(v, chunk)
        float(res)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, res = step(v, chunk)
        float(res)
        walls.append(1e3 * (time.perf_counter() - t0))
    return v, walls


DENSE_CASES = (  # label, problem, width, candidates a dim, tol, chunk (chip_smoke.py's)
    ("quadcopter 9^6", lambda: make_problem("quadcopter", **cs.QUAD), 9, 5, 1e-5, 25),
    ("glider 41^4", lambda: make_problem("glider"), 41, 9, 1e-5, 50),
    ("dubins 41^3", lambda: make_problem("dubins"), 41, 9, 1e-4, 50))


def _timed_solves(solve):
    """solve(graphed) in the order E, G, G, E, E, G: the walls by
    kind, the graphed runs' capture seconds, and the solutions (bit-equal)."""
    walls, caps, sols = {False: [], True: []}, [], []
    for graphed in (False, True, True, False, False, True):
        cap0 = GraphedSweeps.capture_seconds
        sol, wall = cs._synced_s(lambda: solve(graphed))
        walls[graphed].append(1e3 * wall)
        if graphed:
            caps.append(1e3 * (GraphedSweeps.capture_seconds - cap0))
        sols.append(sol)
    for sol in sols[1:]:
        if not (torch.equal(sol.v, sols[0].v) and sol.sweeps == sols[0].sweeps):
            raise AssertionError("the graphed solve differs from the eager one")
    return walls, caps, sols[0]


def _walls_line(walls, caps):
    e, g = float(np.median(walls[False])), float(np.median(walls[True]))
    return (f"eager {', '.join(f'{w:.3f}' for w in walls[False])} ms, graphed "
            f"{', '.join(f'{w:.3f}' for w in walls[True])} ms (captures "
            f"{', '.join(f'{c:.3f}' for c in caps)} ms of it), eager / graphed {e / g:.2f}x")


def graphed_dense(chunk=25):
    for label, make, n, per_dim, tol, solve_chunk in DENSE_CASES:
        prob = make()
        grid = prob.default_grid(n)
        uc = prob.control_candidates(per_dim)
        out = {}
        for graphed in (False, True):
            step, v = make_dense_step(prob, grid, uc, eval_sweeps=10, cuda_graph=graphed)
            out[graphed] = _chunk_walls(step, v, chunk)
        (ve, we), (vg, wg) = out[False], out[True]
        if not torch.equal(ve, vg):
            raise AssertionError(f"{label}: the graphed chunks differ from the eager ones")
        e, g = float(np.median(we)), float(np.median(wg))
        log(f"[3] {label}, {len(uc)} candidates, warm chunk of {chunk} outer sweeps (1 improve "
            f"+ 10 evaluates each): eager {e:.3f} ms ({e / chunk:.4f} a sweep), graphed "
            f"{g:.3f} ms ({g / chunk:.4f} a sweep, {g / chunk / 11:.4f} a K1 launch), "
            f"{e / g:.2f}x; bit-equal; walls eager {', '.join(f'{w:.3f}' for w in we)}, graphed "
            f"{', '.join(f'{w:.3f}' for w in wg)}")
        walls, caps, sol = _timed_solves(
            lambda graphed: dense_vi(prob, grid, controls=uc, tol=tol, max_outer=3000,
                                     chunk=solve_chunk, cuda_graph=None if graphed else False))
        log(f"[3] {label}: whole dense_vi (tol {tol}, chunks of {solve_chunk}), {sol.sweeps} "
            f"outer sweeps: " + _walls_line(walls, caps) + "; bit-equal")


def graphed_patch():
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.solvers.local_patch import solve_local_patch

    prob = make_problem("quadcopter", **cs.QUAD)
    grid = prob.default_grid(9)
    uc = prob.control_candidates(5)
    v9 = dense_vi(prob, grid, controls=uc, tol=1e-5, max_outer=3000, chunk=25).v
    walls, caps, sol = _timed_solves(
        lambda graphed: solve_local_patch(prob, grid, lambda p: multilinear_interp(grid, v9, p),
                                          uc, margin=1, tol=1e-5,
                                          cuda_graph=None if graphed else False))
    log(f"[4] 9^6 patch {tuple(sol.v.shape)}, {sol.sweeps} sweeps: " + _walls_line(walls, caps)
        + "; bit-equal")


def main():
    cs.phase_a_environment()
    host_enqueue_us()
    for n in (9, 11):
        for graphed in (False, True):
            chunk_profile(n, graphed)
    graphed_dense()
    graphed_patch()
    return 0


if __name__ == "__main__":
    sys.exit(main())
