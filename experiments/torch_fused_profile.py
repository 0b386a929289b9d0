#!/usr/bin/env python3
"""Where a fused TT value iteration's time goes on one NVIDIA GPU
(c3sc_tpu_torch only; imports nothing of JAX).

    python3 experiments/torch_fused_profile.py [--rmax 16 32 64] [--n 31]

For the bench configuration (default quadcopter, n^6, 25 candidates, tol 0)
at each rank cap:
  [1] ms/iteration of the eager loop over 100 warm iterations;
  [2] torch.profiler over 10 warm iterations: device-busy time, idle share,
      device time and launches of the two blocks of a core-step
      (``fiber_backup`` = block K2, ``core_fit`` = block K3), the largest
      kernels, and the host syncs and scalar host reads inside the window
      (none are allowed);
  [3] which ``torch.linalg`` calls of the core fit make the host wait for the
      device (each called alone after a long-running kernel);
  [4] the same loop as a CUDA graph of one masked iteration
      (``cuda_graph=True``): ms/iteration, or the call that refused capture.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (the fused drive and the profiler reading)

log = cs.log


def eager_ms(solver, carry, reps=100):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = solver.step_fn(carry, reps)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps, carry


def host_waits():
    """Does the host wait for the device inside a linalg call? Enqueue about
    50 ms of matmuls, call the function, and read the host clock before any
    synchronize: a call that returns early did not wait."""
    dev = cs.DEVICE
    big = torch.randn(8192, 8192, device=dev)
    a = torch.randn(496, 16, device=dev)
    sq = torch.randn(16, 16, device=dev) + 4 * torch.eye(16, device=dev)
    calls = {
        "linalg.qr [496,16]": lambda: torch.linalg.qr(a),
        "linalg.svdvals [16,16]": lambda: torch.linalg.svdvals(sq),
        "linalg.lu [128,16]": lambda: torch.linalg.lu(a[:128]),
        "linalg.solve_ex [16,16]x[16,496]": lambda: torch.linalg.solve_ex(
            sq, a.T, check_errors=False),
        "linalg.solve [16,16]x[16,496]": lambda: torch.linalg.solve(sq, a.T),
        "linalg.slogdet [16,16]": lambda: torch.linalg.slogdet(sq),
        "sort stable [496]": lambda: torch.sort(a[:, 0], descending=True, stable=True),
    }
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            big @ big
        queued = 1e3 * (time.perf_counter() - t0)
        fn()
        returned = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        done = 1e3 * (time.perf_counter() - t0)
        waits = returned > 0.5 * done
        log(f"[3] {name}: matmuls queued at {queued:.2f} ms, call returned at {returned:.2f} ms, "
            f"device done at {done:.2f} ms -> the host {'WAITS' if waits else 'does not wait'}")


def graph_ms(n, rmax, reps=100):
    prob, grid, solver = cs._quad_fused(n, rmax, cs.DEVICE, problem_kw={}, tol=0.0,
                                        max_iters=10**9, cuda_graph=True)
    _, _, eager = cs._quad_fused(n, rmax, cs.DEVICE, problem_kw={}, tol=0.0, max_iters=10**9)
    carry = eager.step_fn(eager.init_fn(0), 30)
    try:
        carry = solver.run_fn(carry, 5)       # captures at the first call
    except Exception as e:   # the report of this script: which call refused capture
        log(f"[4] {n}^6 rmax {rmax}: CUDA graph capture FAILED: {type(e).__name__}: "
            f"{str(e).splitlines()[0][:300]}")
        # a failed capture can leave the CUDA context unusable: report and stop here
        sys.stdout.flush()
        os._exit(4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = solver.run_fn(carry, reps)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / reps
    # the replayed graph against the eager loop from the same carry
    a = eager.run_fn(carry, 3)
    b = solver.run_fn(carry, 3)
    err = (a.v_sample - b.v_sample).abs().max().item()
    log(f"[4] {n}^6 rmax {rmax}: CUDA graph of one masked iteration: {ms:.3f} ms/iteration "
        f"over {reps}; 3 iterations graph vs eager max|dv_sample| {err:.3e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rmax", type=int, nargs="+", default=[16, 32, 64])
    ap.add_argument("--n", type=int, default=31)
    args = ap.parse_args()
    cs.phase_a_environment()
    host_waits()
    for rmax in args.rmax:
        _, _, solver = cs._quad_fused(args.n, rmax, cs.DEVICE, problem_kw={}, tol=0.0,
                                      max_iters=10**9)
        carry = solver.step_fn(solver.init_fn(0), 30)
        ms, carry = eager_ms(solver, carry)
        log(f"[1] quadcopter {args.n}^6 rmax {rmax}: eager loop {ms:.3f} ms/iteration over 100, "
            f"ranks {carry.ranks.tolist()}")
        cs.profile_iterations(solver, carry, label=f"quadcopter {args.n}^6 rmax {rmax}")
        graph_ms(args.n, rmax)
    return 0


if __name__ == "__main__":
    sys.exit(main())
