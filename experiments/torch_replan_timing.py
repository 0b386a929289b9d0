"""How steady the replan time of ``chip_smoke.py``'s H.3 rows is, and what
moves it: the receding-horizon iLQR closed loop on the committed 9^6 dense
quadcopter value (horizon 128, replan every 4, 8 iterations, 64 samples, as
H.3 runs it), in short rows of pure and dual-mode MPC (``terminal_lqr=``)
in the order pure, dual, dual, pure; first in a fresh process, then after
one ``torch.profiler`` session over a CUDA graph's replay (CPU and CUDA
activities, as ``chip_smoke.py``'s phase C traces its graphs). For each row
it prints the median and spread of the host wall of a replan (as
``replan_times`` gives it) and of the device time of the graph's replay
between two CUDA events, and the wall of an eager greedy closed loop; then
each row's captured graph replayed again, to tell a capture's own speed
from the card's state at the time.

    python3 experiments/torch_replan_timing.py [--steps 32] [--rounds 1] \\
        [--empty-cache] [--no-profiler]

Needs one CUDA card; writes nothing.
"""
import argparse
import gc
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from c3sc_tpu_torch.convert import value_from_npz  # noqa: E402
from c3sc_tpu_torch.models import make_problem  # noqa: E402
from c3sc_tpu_torch.ops.interp import multilinear_interp  # noqa: E402
from c3sc_tpu_torch.sim import make_implicit_policy, make_terminal_lqr, rollout  # noqa: E402
from c3sc_tpu_torch.sim import mpc_shoot  # noqa: E402

DEVICE = torch.device("cuda")
EVENT_MS = []
EMPTY_CACHE = False
GRAPHS = []


def timed_call(self, *args):
    """mpc_shoot._GraphedCall.__call__ with the replay between two events."""
    if self.graph is None:
        GRAPHS.append(self)
        return ORIGINAL(self, *args)
    for dst, src in zip(self.inputs, args):
        dst.copy_(src)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    self.graph.replay()
    b.record()
    b.synchronize()
    EVENT_MS.append(a.elapsed_time(b))
    return self.output.clone()


ORIGINAL = mpc_shoot._GraphedCall.__call__
mpc_shoot._GraphedCall.__call__ = timed_call


def stats(xs):
    xs = np.asarray(xs)
    return f"median {np.median(xs):.2f} min {xs.min():.2f} max {xs.max():.2f}"


def rows(stage, prob, grid, vfn, uc, x0, noise, tl, steps, rounds):
    with torch.no_grad():
        pol = make_implicit_policy(prob, grid, vfn, uc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(prob, grid, pol, x0, 0.01, 400, noise=noise)
        torch.cuda.synchronize()
        print(f"[{stage}] greedy closed loop 256 x 400 eager: wall {time.perf_counter() - t0:.2f} s",
              flush=True)
    pooled = {"pure": [], "dual": []}
    for _ in range(rounds):
        for mode in ("pure", "dual", "dual", "pure"):
            if EMPTY_CACHE:
                gc.collect()
                torch.cuda.empty_cache()
            times = []
            EVENT_MS.clear()
            mpc_shoot.receding_horizon_rollout(
                prob, grid, vfn, x0[:64], dt=0.01, n_steps=steps, horizon=128, replan_every=4,
                opt_iters=8, controls=uc, noise=noise[:steps, :64], replan_times=times,
                terminal_lqr=tl if mode == "dual" else None)
            torch.cuda.synchronize()
            wall = [1e3 * t for t in times[1:]]
            pooled[mode] += wall
            print(f"[{stage}] {mode} row, {steps} steps: capture {times[0]:.2f} s; replan wall ms "
                  f"{stats(wall)}; replay device ms {stats(EVENT_MS)}", flush=True)
    d, p = np.median(pooled["dual"]), np.median(pooled["pure"])
    print(f"[{stage}] pooled medians dual {d:.2f} pure {p:.2f} ms ({100 * (d / p - 1):+.1f} %)",
          flush=True)


def replay_again(stage, reps=5):
    """Each row's captured replan replayed again, in row order, twice: the
    device ms of a capture's replay now beside what its row measured."""
    for rnd in range(2):
        for i, g in enumerate(GRAPHS):
            ms = []
            for _ in range(reps):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                g.graph.replay()
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            print(f"[{stage}] round {rnd}: row {i}'s graph replayed again: device ms {stats(ms)}",
                  flush=True)


def profile_a_graph():
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1 << 20, device=DEVICE)
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        y = (x * 2 + 1).sin()
    torch.cuda.current_stream().wait_stream(s)
    with torch.cuda.graph(g):
        y = (x * 2 + 1).sin()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    print(f"[profiler] one graph replay traced: {n} device events", flush=True)
    return y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--empty-cache", action="store_true",
                    help="gc.collect() and torch.cuda.empty_cache() before every row")
    ap.add_argument("--no-profiler", action="store_true",
                    help="skip the profiler session and the rows after it")
    args = ap.parse_args()
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    prob = make_problem("quadcopter", sigma_v=0.15, sigma_om=0.15)
    grid = prob.default_grid(9)
    uc = torch.as_tensor(prob.control_candidates(5), dtype=torch.float32, device=DEVICE)
    vd = value_from_npz(os.path.join(REPO, "experiments", "artifacts", "quad_dense_v9.npz"),
                        DEVICE)
    vfn = lambda p: multilinear_interp(grid, vd, p)  # noqa: E731
    rng = np.random.default_rng(4242)
    x0 = torch.as_tensor(0.4 * rng.uniform(-1, 1, (256, 6))
                         * np.asarray([2.0, 2.0, 1.0, 3.0, 3.0, 4.0]),
                         dtype=torch.float32, device=DEVICE)
    noise = torch.randn((400, 256, prob.dw), generator=torch.Generator(device=DEVICE)
                        .manual_seed(1000), device=DEVICE)
    tl = make_terminal_lqr(prob, dt=0.01, radius=0.4, device=DEVICE)
    global EMPTY_CACHE
    EMPTY_CACHE = args.empty_cache
    rows("fresh", prob, grid, vfn, uc, x0, noise, tl, args.steps, args.rounds)
    replay_again("fresh")
    if args.no_profiler:
        return 0
    GRAPHS.clear()
    profile_a_graph()
    rows("after the profiler", prob, grid, vfn, uc, x0, noise, tl, args.steps, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
