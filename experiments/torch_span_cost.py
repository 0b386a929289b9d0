#!/usr/bin/env python3
"""What the port's spans (``c3sc_tpu_torch.utils.metrics``) cost with
tracing off, and what they read with the profiler off, on one NVIDIA GPU.
Run from the repo root:

    python3 experiments/torch_span_cost.py [--rounds 8] [--parts 1234]

Prints, after the card's name and power limit:
  1  the fused 31^6 rank-16 iteration's two CUDA graphs: the host seconds
     of each capture at the first graphed call, and ms a replay over 100
     back-to-back replays (CUDA events around them), in turns, 2 x
     ``--rounds`` each, of the graph replayed with tracing off against the
     graph with the spans' timing-event nodes; medians and quartiles;
  2  under ``tracing()`` with no profiler: calls of 9 + 1 graphed iterations
     (the quad6_tt31.vi cell's), each to its synchronize: host ms a call,
     device ms a call from CUDA events around it, their ratio, and the
     harvested replays' split (``fiber_backup``, ``core_fit``,
     ``fused.rest``) against their first-to-last event time; the same calls'
     host ms with tracing off;
  3  the closed loop of the quad6_dense11.rollout cell (262,144 scenarios,
     50 steps a batch, the implicit policy on the 11^6 dense value) and cold
     11^6 ``dense_vi`` solves, each with the spans in place (tracing off)
     against the same code with ``span`` returning at once, in turns: ms a
     batch and a solve;
  4  host us a span under ``torch.profiler`` (CPU and CUDA activities) and
     under ``tracing()``: a one-element add alone, inside a host-only span
     (``device=False``), inside a device-timed span, and inside a bare
     ``record_function``; 2,000 a loop, 5 loops each, in turns; medians.
``--parts 4`` runs part 4 alone (parts 1 and 2 run together). Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from c3sc_tpu_torch.models.quadcopter import make_quadcopter_problem  # noqa: E402
from c3sc_tpu_torch.solvers import fused  # noqa: E402
from c3sc_tpu_torch.utils import metrics  # noqa: E402

CONFIGS = os.path.join(REPO, "benchmark", "configs")


def log(*a):
    print(*a, flush=True)


def quartiles(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"median": q[1], "q1": q[0], "q3": q[2], "n": len(xs)}


def config(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def replay_ms(graph, n=100):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


class timed_graph(torch.cuda.graph):
    """``torch.cuda.graph`` that appends each capture's host seconds (the
    capture and the graph's instantiation) to ``timed_graph.seconds``."""

    seconds = []

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        torch.cuda.synchronize()
        timed_graph.seconds.append(time.perf_counter() - self.t0)
        return out


def graphed_iterations():
    return {id(o): o for o in gc.get_objects() if isinstance(o, fused._GraphedIteration)}


def fused_costs(dev, rounds):
    c = config("quad6_tt31")
    prob = make_quadcopter_problem(**c["problem"])
    grid = prob.default_grid(c["grid_n"])
    uc = prob.control_candidates(c["candidates_per_axis"])
    solver = fused.make_fused_vi(prob, grid, uc, rmax=c["rmax"], kick=c["kick"],
                                 eps_rank=c["eps_rank"], tol=c["tol"], max_iters=10 ** 9,
                                 device=dev, cuda_graph=True)
    carry = solver.init_fn(7)
    real = torch.cuda.graph
    torch.cuda.graph = timed_graph
    try:
        t0 = time.perf_counter()
        carry = solver.step_fn(carry, 1)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
    finally:
        torch.cuda.graph = real
    plain_s, traced_s = timed_graph.seconds
    log(f"[1] first graphed call {first:.3f} s: capture of the graph {plain_s:.3f} s, of the "
        f"graph with the spans' events {traced_s:.3f} s")
    carry = solver.step_fn(carry, 29)
    torch.cuda.synchronize()
    g, = graphed_iterations().values()
    graphs = {"graph": g.graph, "traced": g.traced}
    times = {k: [] for k in graphs}
    for graph in graphs.values():
        replay_ms(graph, 10)
    order = list(graphs)
    for r in range(2 * rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(replay_ms(graphs[k]))
    q = {k: quartiles(v) for k, v in times.items()}
    d = q["traced"]["median"] - q["graph"]["median"]
    log(f"[1] fused graph ms a replay, tracing off (graph) and on (traced, "
        f"{len(g.spans.events)} event nodes): {json.dumps(q)}; traced less graph {d:+.5f} ms "
        f"({100 * d / q['graph']['median']:+.3f} %)")
    log(f"[1] raw: {json.dumps(times)}")

    def calls(n, traced):
        nonlocal carry
        host, device = [], []
        ctx = metrics.tracing() if traced else contextlib.nullcontext()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with ctx:
            for _ in range(n):
                t0 = time.perf_counter()
                start.record()
                carry = solver.step_fn(carry, 9)
                carry = solver.step_fn(carry, 1)
                end.record()
                torch.cuda.synchronize()
                host.append(time.perf_counter() - t0)
                device.append(start.elapsed_time(end) / 1e3)
        return host, device

    calls(3, False)
    metrics.reset()
    n = 30
    host_on, dev_on = calls(n, True)
    host_off, _ = calls(n, False)
    rows = {(r["name"], r["parent"]): r for r in metrics.snapshot()["spans"]}
    it = rows[("fused.iteration", "fused.step")]
    dev_call, host_call = 1e3 * sum(dev_on) / n, 1e3 * sum(host_on) / n
    log(f"[2] tracing() without the profiler, {n} calls of 9 + 1 graphed iterations: host "
        f"{host_call:.3f} ms a call (tracing off: {1e3 * sum(host_off) / n:.3f}), device "
        f"{dev_call:.3f} ms a call (events around it): busy {100 * dev_call / host_call:.2f} %, "
        f"idle {100 - 100 * dev_call / host_call:.2f} %")
    reps = it["entries"]
    split = {t: 1e3 * rows[(t, "fused.iteration")]["device_s"] / reps
             for t in ("fiber_backup", "core_fit", "fused.rest")}
    log(f"[2] harvested replays {reps}: first-to-last {1e3 * it['device_s'] / reps:.4f} ms, "
        f"tiles {json.dumps(split)} sum {sum(split.values()):.4f} ms; shares "
        f"{ {t: round(100 * v / sum(split.values()), 2) for t, v in split.items()} } %")
    metrics.reset()
    del solver, carry, g, graphs
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def spans_return_at_once():
    from c3sc_tpu_torch.sim import integrators, policy
    from c3sc_tpu_torch.solvers import dense

    off = contextlib.nullcontext()
    mods = (integrators, policy, dense)
    real = [m.span for m in mods]
    for m in mods:
        m.span = lambda name, device=True: off
    try:
        yield
    finally:
        for m, s in zip(mods, real):
            m.span = s


def dense_costs(dev, rounds):
    import numpy as np

    from c3sc_tpu_torch import _ext
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.sim.integrators import rollout
    from c3sc_tpu_torch.sim.policy import make_implicit_policy
    from c3sc_tpu_torch.solvers.dense import dense_vi

    _ext.load()
    c = config("quad6_dense11")
    prob = make_quadcopter_problem(**c["problem"])
    grid = prob.default_grid(c["grid_n"])
    controls = prob.control_candidates(c["candidates_per_axis"])

    def solve():
        return dense_vi(prob, grid, controls=controls, tol=c["tol"], max_outer=c["max_outer"],
                        chunk=c["chunk"], eval_sweeps=c["eval_sweeps"], device=dev)

    v = solve().v
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(5)
    lb, ub = (torch.tensor(b, device=dev) for b in (prob.lb, prob.ub))
    B, steps = 262144, 50
    x0 = (lb + ub) / 2 + 0.25 * (ub - lb) * (2 * torch.rand((B, prob.dx), generator=gen,
                                                            device=dev) - 1)
    noise = torch.randn((steps, B, prob.dw), generator=gen, device=dev)
    uc = torch.as_tensor(np.asarray(controls), dtype=torch.float32, device=dev)
    pol = make_implicit_policy(prob, grid, lambda p: multilinear_interp(grid, v, p), uc)

    def batch():
        with torch.no_grad():
            rollout(prob, grid, pol, x0, 0.01, steps, noise=noise)
        torch.cuda.synchronize()

    def solves(k=10):
        for _ in range(k):
            solve()
        torch.cuda.synchronize()

    for name, fn in (("rollout batch of 50 steps", batch), ("10 cold dense_vi solves", solves)):
        fn()
        times = {"spans": [], "at_once": []}
        for _ in range(rounds):
            for side in ("spans", "at_once", "at_once", "spans"):
                ctx = spans_return_at_once() if side == "at_once" else contextlib.nullcontext()
                with ctx:
                    t0 = time.perf_counter()
                    fn()
                    times[side].append(1e3 * (time.perf_counter() - t0))
        q = {k: quartiles(x) for k, x in times.items()}
        diff = q["spans"]["median"] - q["at_once"]["median"]
        log(f"[3] {name} ms: {json.dumps(q)}; spans - at once {diff:.3f} ms "
            f"({100 * diff / q['at_once']['median']:.3f} %)")


def span_costs(dev):
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.zeros(1, device=dev)
    n = 2000
    kinds = ("none", "host", "timed", "record_function")

    def loop(kind):
        t0 = time.perf_counter()
        for _ in range(n):
            if kind == "none":
                x.add_(1)
            elif kind == "record_function":
                with record_function("s"):
                    x.add_(1)
            else:
                with metrics.span("s", device=kind == "timed"):
                    x.add_(1)
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / n

    for mode in ("profiler", "tracing"):
        us = {k: [] for k in kinds}
        for r in range(5):
            for k in (kinds if r % 2 == 0 else kinds[::-1]):
                if mode == "profiler":
                    ctx = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                else:
                    ctx = metrics.tracing()
                with ctx:
                    us[k].append(loop(k))
                metrics.reset()
        med = {k: round(statistics.median(v), 2) for k, v in us.items()}
        log(f"[4] under {mode}: host us an add {json.dumps(med)}; raw {json.dumps(us)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--parts", default="1234")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    log(f"card: {card.strip()}; torch {torch.__version__}")
    if "1" in args.parts or "2" in args.parts:
        fused_costs(dev, args.rounds)
    if "3" in args.parts:
        dense_costs(dev, args.rounds)
    if "4" in args.parts:
        span_costs(dev)


if __name__ == "__main__":
    main()
