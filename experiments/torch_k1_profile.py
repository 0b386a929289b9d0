#!/usr/bin/env python3
"""Where kernel K1 of c3sc_tpu_torch and its solver loop spend their time on
one NVIDIA GPU. Run from the repo root:

    python3 experiments/torch_k1_profile.py

Prints, after the card's name and power limit:
  1  the host's time to enqueue one improve and one evaluate launch (pendulum
     31^2, where the device is never the limit);
  2  for the quadcopter at 9^6 and 11^6: a warm chunk of 25 outer sweeps of
     dense_vi under torch.profiler — wall, device-busy time by kernel, idle
     share — and the same chunk's wall without the profiler.
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
from c3sc_tpu_torch.solvers.dense import make_dense_step  # noqa: E402

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


def chunk_profile(n, chunk=25):
    from torch.profiler import ProfilerActivity, profile

    prob = make_problem("quadcopter", **cs.QUAD)
    grid = prob.default_grid(n)
    step, v = make_dense_step(prob, grid, prob.control_candidates(5), eval_sweeps=10)
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
    log(f"[2] quadcopter {n}^6 warm chunk of {chunk} outer sweeps: wall {wall:.3f} ms "
        f"(median of 3: {', '.join(f'{w:.3f}' for w in walls)}), profiled wall {profiled:.3f} ms, "
        f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f} of the unprofiled wall, "
        f"{1 - busy / profiled:.3f} of the profiled one")
    for ms, count, key in sorted(rows, reverse=True)[:4]:
        log(f"[2]   {ms:.3f} ms in {count} launches ({ms / count:.4f} ms each): {key[:90]}")


def main():
    cs.phase_a_environment()
    host_enqueue_us()
    for n in (9, 11):
        chunk_profile(n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
