#!/usr/bin/env python3
"""Drive the c3sc_tpu_torch dense Bellman path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is
non-zero, with no result line):
  A  environment: the card, its power limit, the CUDA version; no card -> fail
  B  build kernel K1 (csrc/dense_backup.cu) with nvcc for sm_90a
  C  K1 against its plain PyTorch version on the card (pendulum 31^2, LQ
     21^2, 6D quadcopter 9^6 and 11^6); an improve sweep against the evaluate
     sweep under its argmin (bit-equal) and against its 64-bit-index form
     (bit-equal); per-sweep times of kernel and plain version, as a loop of
     launches between one CUDA-event pair and as the median of single
     launches; improve times at 1, 4, 9 and 25 candidates at 11^6; each
     sweep's bound (bytes at 3.35 TB/s, float32 operations at 67 TFLOP/s)
  D  dense_vi on the quadcopter at 9^6 and 11^6 with the oracle's settings,
     held against the stored solves experiments/artifacts/quad_dense_v{9,11}.npz,
     with the solve's peak device memory
  E  256 x 400-step Euler–Maruyama rollouts under the implicit policy on the
     9^6 value, against the same rollouts on the stored value
Then one JSON line of the kernels, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ART = os.path.join(REPO, "experiments", "artifacts")
QUAD = dict(sigma_v=0.15, sigma_om=0.15)   # the dense oracle's quadcopter
VALUE_BAR = 2e-4     # |kernel - plain| <= VALUE_BAR * max(1, |plain|)
TIE_BAR = 1e-5       # argmins may differ where the two best rhs are this close
SOLVE_BAR = 5e-3     # max |v - stored v| after dense_vi (value range ~98)
KERNEL_SOURCE = "c3sc_tpu_torch/csrc/dense_backup.cu"
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate (NVIDIA's data sheet)
F32_FLOP_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores
DEVICE = torch.device("cuda")


def log(msg):
    print(msg, flush=True)


def phase_a_environment():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on an NVIDIA GPU only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    log(smi[0])  # the card's name and power limit, as nvidia-smi gives them
    log(f"[A] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi[0]


def phase_b_build():
    from c3sc_tpu_torch import _ext
    from c3sc_tpu_torch.ops import dense_backup as db

    t0 = time.time()
    db._lib()
    log(f"[B] built and loaded K1 in {time.time() - t0:.1f} s ({_ext.build_dir()})")
    # registers and spills of the 6D / 2-control instantiations, from ptxas -v
    text = (_ext.build_dir() / "build.log").read_text()
    for kind in ("dense_backup_kernel", "dense_evaluate_kernel"):
        # ...ILi6ELi2EjE...: d = 6, du = 2, 32-bit (unsigned int) indices
        m = re.search(kind + r"ILi6ELi2EjE.*?Used (\d+) registers", text, re.S)
        spill = re.search(kind + r"ILi6ELi2EjE.*?(\d+) bytes spill stores", text, re.S)
        if m is None or spill is None:
            raise RuntimeError(f"build.log has no ptxas line for {kind}<6,2,uint32>")
        log(f"[B] {kind}<6,2,uint32>: registers {m.group(1)}, spill stores {spill.group(1)} B")


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of fn() over reps runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def loop_ms(fn, launches=50, warmup=3):
    """Milliseconds a call of fn() over a loop of calls between one CUDA-event
    pair: the device's time a launch, without the host time of the wrapper
    as long as the host enqueues faster than the device runs."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def sweep_bounds(ops):
    """The least time the card could take for one improve and one evaluate
    sweep on these operands: the larger of bytes / memory rate (each input
    read once, each output written once) and float32 operations / peak rate,
    counted for the factored form of csrc/dense_backup.cu on this data."""
    N, d = ops.x.shape
    du, C = ops.problem.du, ops.uc.shape[0]
    node_in = 4 * (d + d * du + d + 1) + 1 + 4 + 4     # f0, G, s2, q, t_mask, t_val, v
    cand = 4 * C * (du + 1)                            # uc, r
    per_node = d * (7 + du) + 1                        # f0h, Gh, a, Q0, A0
    per_cand = d * (2 * du + 3) + 8                    # fh, Q, S, then dt, exp and the sum
    n_term = int(ops.t_mask.sum())                     # evaluate only copies t_val there
    work = {
        "dense_backup": (N * (node_in + 8) + cand, N * (per_node + C * per_cand)),
        "dense_evaluate": ((N - n_term) * (node_in + 8) + n_term * 9 + cand,
                           (N - n_term) * (per_node + per_cand)),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOP_PER_S
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "flops": flops}
    return out


def compare_sweep(ops, v, clip, pin_input, label):
    """Kernel against plain version for one improve and one evaluate sweep."""
    from c3sc_tpu_torch.ops import dense_backup as db

    kv, kb = db.dense_backup(ops, v, clip, pin_input)
    pv, pb = db.dense_backup_reference(ops, v, clip, pin_input)
    torch.cuda.synchronize()
    err = (kv - pv).abs()
    bad = int((err > VALUE_BAR * pv.abs().clamp(min=1.0)).sum())
    rhs = db.candidate_rhs(ops, v, clip, pin_input)
    top2 = torch.topk(rhs, 2, dim=0, largest=False).values
    near_tie = (top2[1] - top2[0]) <= TIE_BAR * top2[0].abs().clamp(min=1.0)
    del rhs, top2
    best_bad = int(((kb != pb) & ~near_tie).sum())
    ke = db.dense_evaluate(ops, v, pb)
    pe = db.dense_evaluate_reference(ops, v, pb)
    eerr = (ke - pe).abs()
    ebad = int((eerr > VALUE_BAR * pe.abs().clamp(min=1.0)).sum())
    log(f"[C] {label}: improve max|diff| {err.max().item():.3e} (over bar: {bad}), "
        f"argmin differs off near-ties: {best_bad} (near-ties {int(near_tie.sum())}); "
        f"evaluate max|diff| {eerr.max().item():.3e} (over bar: {ebad})")
    if bad or best_bad or ebad or not torch.isfinite(kv).all() or not torch.isfinite(ke).all():
        raise AssertionError(f"K1 disagrees with its plain version: {label}")
    # the 64-bit-index form of both kernels decodes the same nodes
    wv, wb = db.dense_backup(ops, v, clip, pin_input, _wide_index=True)
    we = db.dense_evaluate(ops, v, pb, _wide_index=True)
    if not (torch.equal(wv, kv) and torch.equal(wb, kb) and torch.equal(we, ke)):
        raise AssertionError(f"K1 with 64-bit indices differs from 32-bit: {label}")
    if clip is None and not pin_input:
        # dense_vi's pair: evaluating under improve's own argmin repeats its value
        if not torch.equal(db.dense_evaluate(ops, v, kb), kv):
            raise AssertionError(f"improve and evaluate under its argmin are not bit-equal: {label}")
    return err.max().item(), eerr.max().item()


def phase_c_kernel_vs_plain(sizes=(9, 11)):
    from c3sc_tpu_torch.convert import value_from_npz
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops import dense_backup as db

    dev = DEVICE
    errs = {"dense_backup": 0.0, "dense_evaluate": 0.0}
    times, bounds = {}, {}

    def note(e):
        errs["dense_backup"] = max(errs["dense_backup"], e[0])
        errs["dense_evaluate"] = max(errs["dense_evaluate"], e[1])

    for name, n in (("pendulum", 31), ("lq", 21)):
        prob = make_problem(name)
        grid = prob.default_grid(n)
        ops = db.make_dense_operands(prob, grid, prob.control_candidates(5), dev)
        v = torch.as_tensor(np.random.default_rng(0).uniform(0, 5, grid.shape),
                            dtype=torch.float32, device=dev)
        note(compare_sweep(ops, v, prob.value_bounds, True,
                           f"{name} {n}^2, 5 candidates, Pallas semantics"))
    prob = make_problem("quadcopter", **QUAD)
    for n in sizes:
        grid = prob.default_grid(n)
        torch.cuda.synchronize()
        t0 = time.time()
        ops = db.make_dense_operands(prob, grid, prob.control_candidates(5), dev)
        torch.cuda.synchronize()
        log(f"[C] quadcopter {n}^6 operands (x-only tensors) built in {time.time() - t0:.3f} s")
        inputs = {"random v": torch.as_tensor(
            np.random.default_rng(0).uniform(0, 5, grid.shape), dtype=torch.float32, device=dev)}
        stored = os.path.join(ART, f"quad_dense_v{n}.npz")
        if os.path.exists(stored):
            inputs["stored v"] = value_from_npz(stored, dev).contiguous()
        for vname, v in inputs.items():
            for sem, (clip, pin) in (("Pallas", (prob.value_bounds, True)),
                                     ("dense_vi", (None, False))):
                note(compare_sweep(ops, v, clip, pin,
                                   f"quadcopter {n}^6, 25 candidates, {vname}, {sem} semantics"))
        v = inputs["random v"]
        _, best = db.dense_backup(ops, v)
        calls = dict(
            backup_kernel=lambda: db.dense_backup(ops, v),
            backup_plain=lambda: db.dense_backup_reference(ops, v),
            evaluate_kernel=lambda: db.dense_evaluate(ops, v, best),
            evaluate_plain=lambda: db.dense_evaluate_reference(ops, v, best),
        )
        single = {k: cuda_ms(fn) for k, fn in calls.items()}
        log(f"[C] quadcopter {n}^6 per-sweep ms (median of 20 single launches, CUDA events): "
            + ", ".join(f"{k} {x:.4f}" for k, x in single.items()))
        times[n] = {k: loop_ms(fn, 100 if k.endswith("kernel") else 50)
                    for k, fn in calls.items()}
        log(f"[C] quadcopter {n}^6 per-sweep ms (loop of 100 kernel or 50 plain launches "
            "between one event pair): " + ", ".join(f"{k} {x:.4f}" for k, x in times[n].items()))
        bounds[n] = sweep_bounds(ops)
        log(f"[C] quadcopter {n}^6 bounds: " + json.dumps(bounds[n]))
        if n == max(sizes):
            by_c = {}
            for nc in (1, 2, 3, 5):   # 1, 4, 9 and 25 candidates: the base and the slope
                ops_c = db.make_dense_operands(prob, grid, prob.control_candidates(nc), dev)
                by_c[nc * nc] = loop_ms(lambda: db.dense_backup(ops_c, v), 100)
                del ops_c
            log(f"[C] quadcopter {n}^6 improve ms by candidate count (loop of 100): "
                + ", ".join(f"C={c} {x:.4f}" for c, x in by_c.items()))
        del ops, inputs, v, best, calls
        torch.cuda.empty_cache()
    return errs, times, bounds


def phase_d_solve(sizes=(9, 11)):
    from c3sc_tpu_torch.convert import value_from_npz
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops import dense_backup as db
    from c3sc_tpu_torch.solvers import dense_vi

    dev = DEVICE
    prob = make_problem("quadcopter", **QUAD)
    values = {}
    for n in sizes:
        grid = prob.default_grid(n)
        before = (db.dense_backup.launches, db.dense_evaluate.launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        sol = dense_vi(prob, grid, controls=prob.control_candidates(5), tol=1e-5,
                       max_outer=3000, chunk=25, eval_sweeps=10, device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        improves = db.dense_backup.launches - before[0]
        evals = db.dense_evaluate.launches - before[1]
        if improves != sol.sweeps or evals != 10 * sol.sweeps:
            raise AssertionError(f"{n}^6: {improves} improve and {evals} evaluate launches "
                                 f"for {sol.sweeps} outer sweeps")
        if not (sol.residual < 1e-5 or sol.floored):
            raise AssertionError(f"{n}^6: neither converged nor floored "
                                 f"(residual {sol.residual:.3e})")
        if tuple(sol.v.shape) != grid.shape or not torch.isfinite(sol.v).all():
            raise AssertionError(f"{n}^6: value is not finite of shape {grid.shape}")
        diff = (sol.v - value_from_npz(os.path.join(ART, f"quad_dense_v{n}.npz"), dev)).abs()
        dmax, dq95 = diff.max().item(), torch.quantile(diff.reshape(-1), 0.95).item()
        log(f"[D] dense_vi quadcopter {n}^6: {sol.sweeps} outer sweeps, residual "
            f"{sol.residual:.3e}, floored {sol.floored}, wall {wall:.2f} s, launches "
            f"{improves} improve + {evals} evaluate, peak device memory {peak_mib:.1f} MiB; "
            f"vs stored v max {dmax:.3e} q95 {dq95:.3e}")
        if dmax > SOLVE_BAR:
            raise AssertionError(f"{n}^6: max |v - stored v| {dmax:.3e} > {SOLVE_BAR}")
        values[n] = sol.v
    return values


def phase_e_rollouts(v9, n_rollouts=256, n_steps=400, dt=0.01):
    from c3sc_tpu_torch.convert import value_from_npz
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.sim import make_implicit_policy, rollout

    dev = DEVICE
    prob = make_problem("quadcopter", **QUAD)
    grid = prob.default_grid(tuple(v9.shape))
    controls = torch.as_tensor(prob.control_candidates(5), dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)  # x0 as the CLI draws it (seed 0)
    lb, ub = np.asarray(prob.lb), np.asarray(prob.ub)
    mid, span = (lb + ub) / 2, (ub - lb) / 2
    x0 = torch.as_tensor(mid + 0.5 * span * rng.uniform(-1, 1, (n_rollouts, prob.dx)),
                         dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = torch.randn((n_steps, n_rollouts, prob.dw), generator=gen, device=dev)
    stored = value_from_npz(os.path.join(ART, f"quad_dense_v{v9.shape[0]}.npz"), dev)
    out = {}
    for label, v in (("port v", v9), ("stored v", stored)):
        policy = make_implicit_policy(prob, grid, lambda p, v=v: multilinear_interp(grid, v, p),
                                      controls)
        torch.cuda.synchronize()
        t0 = time.time()
        traj = rollout(prob, grid, policy, x0, dt, n_steps, noise=noise)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if tuple(traj.xs.shape) != (n_steps + 1, n_rollouts, prob.dx) or \
                not torch.isfinite(traj.xs).all() or not torch.isfinite(traj.cost).all():
            raise AssertionError(f"rollouts on {label}: bad trajectory")
        mean_cost = traj.cost.mean().item()
        survival = traj.alive[-1].float().mean().item()
        out[label] = (mean_cost, survival)
        log(f"[E] rollouts on {label}: {n_rollouts} x {n_steps} steps dt {dt}: mean cost "
            f"{mean_cost:.4f}, survival {100 * survival:.2f}%, wall {wall:.2f} s")
    (c_p, s_p), (c_s, s_s) = out["port v"], out["stored v"]
    if abs(c_p - c_s) > 0.01 * abs(c_s) or abs(s_p - s_s) > 0.02:
        raise AssertionError(f"rollouts disagree: cost {c_p:.4f} vs {c_s:.4f}, "
                             f"survival {s_p:.4f} vs {s_s:.4f}")


def main():
    phase_a_environment()
    phase_b_build()
    from c3sc_tpu_torch.ops import dense_backup as db

    errs, times, bounds = phase_c_kernel_vs_plain()
    # the main path's run: counts start at 0 here and are read right after
    db.dense_backup.launches = 0
    db.dense_evaluate.launches = 0
    values = phase_d_solve()
    phase_e_rollouts(values[9])
    launches = {"dense_backup": db.dense_backup.launches,
                "dense_evaluate": db.dense_evaluate.launches}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    # times and bounds of the 11^6 quadcopter sweep with 25 candidates; no single
    # PyTorch call computes either sweep, so there is no library time
    t11, b11 = times[11], bounds[11]
    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": t11[key + "_kernel"], "plain_ms": t11[key + "_plain"],
         "bound_ms": b11[name]["bound_ms"], "bound_by": b11[name]["bound_by"],
         "library_ms": None}
        for name, key, replaces in (
            ("dense_backup", "backup", "c3sc_tpu/ops/pallas_dense.py:107"),
            ("dense_evaluate", "evaluate", "c3sc_tpu/solvers/dense.py:122"))
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
