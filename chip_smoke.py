#!/usr/bin/env python3
"""Drive the c3sc_tpu_torch dense Bellman path, the fused TT value
iteration, the receding-horizon control path, the flagship accuracy stack,
the remaining models, the remaining solvers, the users' entry points
(the CLI, the C3Control builder) and the parallel paths (device meshes,
the sharded backup and rollout, batched solves) and K1 on problems beyond
its structured entries (five controls, nine states) once on one NVIDIA GPU.

    python3 chip_smoke.py              every phase
    python3 chip_smoke.py --phases F   phases A, B, D at 9^6 and F (while developing)
    python3 chip_smoke.py --phases G   phases A, B, D at 9^6 and G (while developing)
    python3 chip_smoke.py --phases H   phases A, B, D at 9^6 and H at the recipe's full
                                       depth (both fused bases, 6 cycles, 256 iLQR rollouts)
    python3 chip_smoke.py --phases H --seed N
                                       the same for the recipe's seed N (H.1, the committed
                                       seed-0 fields, runs for seed 0 only)
    python3 chip_smoke.py --phases I   phases A, B and I at the 7D recipe's full depth
                                       (both fused bases, 3 cycles, 128 closed loops)
    python3 chip_smoke.py --phases J   phases A, B, D at 9^6 and J at its full depth
    python3 chip_smoke.py --phases K   phases A, B and K at full depth (the documented
                                       quadcopter CLI run uncut)
    python3 chip_smoke.py --phases L   phases A, B, D at 9^6, F.2 and L
    python3 chip_smoke.py --phases M   phases A, B and M

Phases (each prints its lines; any failure raises and the exit code is
non-zero, with no result line):
  A  environment: the card, its power limit, the CUDA version; no card -> fail
  B  build kernel K1 (csrc/dense_backup.cu) with nvcc for sm_90a; print the
     registers, stack frame and spill stores of some compiled instantiations
     and of every run-time-d one from ptxas -v, and fail if a run-time-d
     kernel of a register capacity (d <= 12, d <= 16) has a stack frame or
     spills
  C  K1 against its plain PyTorch version on the card (pendulum 31^2, LQ
     21^2, 6D quadcopter 9^6 and 11^6); an improve sweep against the evaluate
     sweep under its argmin (bit-equal) and against its 64-bit-index form
     (bit-equal); per-sweep times of kernel and plain version, as a loop of
     launches between one CUDA-event pair and as the median of single
     launches; improve times at 1, 4, 9 and 25 candidates at 11^6; each
     sweep's bound (bytes at 3.35 TB/s, float32 operations at 67 TFLOP/s)
     then, outside the counted runs, every graphed dense solve of D, H.1 and
     I.3 against the eager loop (dense_vi(cuda_graph=False)): bit-equal, with
     both walls and the capture time; one replay of each of the two graphs
     under torch.profiler (9^6, the glider 41^4, the patch's sweep): the K1
     kernels the card ran equal the launches the graphs counted; device
     memory steady over replays (9^6)
  D  dense_vi on the quadcopter at 9^6 and 11^6 with the oracle's settings
     (on the card an outer sweep is one CUDA graph, replayed); held against
     the stored solves experiments/artifacts/quad_dense_v{9,11}.npz, with the
     solve's peak device memory
  E  256 x 400-step Euler–Maruyama rollouts under the implicit policy on the
     9^6 value, against the same rollouts on the stored value
  F  the fused TT value iteration (plain PyTorch, no hand kernel):
     F.1 the card against the CPU (quadcopter 9^6, rmax 16): every block of a
         half sweep on identical inputs, values within 1e-4 x max|v|; and a
         solve that converges (pendulum 31^2) against the dense solve, < 3 %
     F.2 the 9^6 solve (rmax 16, 25 candidates, tol 2e-4, patience 25, at most
         900 iterations) against phase D's dense solve: interior q95 of
         |v_tt - v_dense| / range <= 0.25; then the probe harvest at a small depth
     F.3 the bench configuration at full width: 31^6, rmax 16 and 32, tol 0:
         ms/iteration over 25 (eager loop) and 200 (CUDA graph of one
         iteration) iterations, active backups/s, warm 3-iteration replan
     F.4 torch.profiler over 10 warm iterations at 31^6 rmax 16: device-busy
         time, idle share, and the device time and launches of the two blocks
         of a core-step (fiber_backup, core_fit); no host sync nor scalar host read in the window
     F.5 phase E's rollouts on the TT value of F.2 through tt_lerp_eval
  G  the control path: continuous refinement, fused MPC, tracking re-solves
     G.1 refinement (refine_steps=2): (a) dense_policy on D's 9^6 value, its
         argmin through K1; every node's refined RHS at most its candidate's;
         (b) phase E's rollouts under the refined implicit policy; (d) F.2's
         9^6 solve refined under the CUDA graph, interior q95 <= 0.25; (c) one
         refined fiber backup per core, card against CPU within 1e-4 x max|v|; the
         profile of an eager refined 9^6 iteration: no host sync and no
         scalar read on the host (aten::item)
     G.2 fused MPC at bench.py's configuration (31^6, rmax 16, 25 candidates,
         6 replans of 3 iterations, 256 rollouts x 25 steps each; the cold
         solve cut from 800 to 400 iterations): graphed step_fn against
         eager, then every warm replan's latency; median under the 25 x
         0.01 s real-time budget
     G.3 tracking at bench.py's configuration (moving hover target, 9^6,
         rmax 16): median 10-iteration cost-update latency; the re-solve at a
         moved target against dense_vi there (K1), q95 <= 0.25 and below the
         stale value's; tracking against stale closed loops; one build and one
         graph capture across every cost update
  H  the flagship accuracy stack on the 9^6 quadcopter (25 candidates), the
     recipe of experiments/quad_dense_oracle.py:
     H.1 the committed seed-0 fields (northstar_seed0_{v,patch}.npz): the
         deployed composite at all 531,441 nodes against quad_dense_v9.npz,
         interior q95 within 1e-4 of the JAX package's 0.028826; the patch
         re-solved from the TT's faces by solve_local_patch through K1
     H.2 the recipe from a rank-16 fused TT: in the whole script F.2's solve
         (the graphed variant: no probe, 900 iterations); under --phases H the
         recipe's own base (eager, the probe harvest of 32 x 500 steps, up to
         1,500 iterations), with the graphed variant solved and scored beside
         it. Re-padded to rank 64, cycles of [two-site polish, 10 steps +
         coarse-grid correction] (6 under --phases H, 2 in the whole script),
         gated level and mode corrections with a 24 x 250 greedy probe,
         two_level_solve (2 cycles, margin 1); interior q95 per stage, below
         the fused base's at the end (and <= 0.05 at full depth)
     H.3 deployment on the composite and on the dense value under common random
         numbers: greedy closed loops 256 x 400 steps at dt 0.01 (x0 as
         quad_dense_oracle.py draws it), then receding-horizon iLQR (horizon 128,
         a replan every 4 steps, 8 iterations, no terminal LQR; 64 rollouts in
         the whole script, 256 under --phases H), each replan a CUDA graph;
         then the dual-mode row: the same iLQR on the dense value with the
         terminal LQR latch (make_terminal_lqr(radius=0.4), as
         experiments/northstar_deploy_dualmode.py builds it), the same x0
         and noise: mean cost, survival, signed_rel against the pure-MPC
         dense row, median replan within 5 % of the pure row's (the latch
         lies outside the replan's graph)
     then K1 held against its plain version on the patch's 7^6 sub-box (one
     sweep, and the whole patch solve)
  I  the remaining models, each held to the JAX package's own bars:
     I.1 K1 against its plain version at the users' widths (outside the
         counted run): the structured entry at (3, 1) on Dubins 41^3 and at
         (7, 2) on quadcopter7 9^7 (25 candidates); the general entries on the
         glider 41^4 (9 candidates; its drift is undeclared) and on the
         pendulum at 1001^2 stripped of every declaration (per-candidate
         variances and cost); max difference, ms a sweep, each entry's share of
         its bound; the improve's policy (with_policy=True: for general
         operands the winner's operands from its epilogue) bit-equal to
         gather_policy of its argmin, the evaluate under it bit-equal to the
         improve
     I.2 tests/test_dubins.py on the card ((25, 25, 16), beta 0.5, 7
         candidates): fused rmax 20 against dense_vi, q95 < 0.05 and mean <
         0.02; closed loops of its rmax-28 solve under shared noise, cost
         within 1 %, candidate agreement >= 94 %; dense_vi at the CLI's 41^3
     I.3 tests/test_glider_parity.py on the card ((15, 11, 11, 11), 9
         candidates, the dense oracle through the general entries): fused rmax
         16 q95 < 0.05, closed-loop control deviation < 1 % of the range, cost
         within 2 %; dense_vi at the CLI's 41^4 (general entries)
     I.4 experiments/quad7_northstar.py at 9^7 with 25 candidates: the full
         9^7 dense oracle through K1 first; fused base, cycles of [10 polish
         steps at rank 64 + coarse correction on 7^7], the gated level
         correction, the 7^7 patch at margin 1, the sampled Bellman residual
         (8,192 nodes), greedy closed loops (x0 from default_rng(4242), 400
         steps at dt 0.01) on the composite and on the oracle, the sub-box
         oracle (tol 1e-6, 4,000 sweeps, scored 2 layers in); bars of
         NORTHSTAR7.json (survival >= 0.9, residual <= 0.02, inner q95 <=
         0.05); interior q95 of each fused base, the polished TT and the
         composite against the full oracle (reported). --phases I: the
         recipe's base (eager, probe harvest, <= 1,500 iterations) beside the
         graphed variant (<= 1,500), 3 cycles, 128 loops. Cuts in the whole
         script: the graphed base only (<= 600 iterations), 1 cycle, 32 loops
  J  the remaining solvers (plain PyTorch on the card; their dense oracles run
     K1), each held to the JAX package's bars:
     J.1 fused_tt_vi_refined: tests/test_fused.py's refined bar (pendulum 21^2,
         rank 8, 2 rounds, graphed); the 9^6 quadcopter (rmax 16, tol 2e-4,
         patience 25, graphed) with interior q95 of the base and of every
         accepted total against quad_dense_v9.npz, the refine history and each
         solve's wall; bar: an accepted round and q95 <= 0.25; an eager
         iteration with a base reads nothing on the host. Whole script: 1 round
         and <= 300 iterations a solve (--phases J: 2 rounds, <= 900)
     J.2 oversample 1.0 at rmax 32 (fit cap 16) on the 9^6 quadcopter, graphed:
         q95, ms/iteration; three forced iterations graphed bit-equal to
         eager; an eager iteration reads nothing on the host (<= 300
         iterations in the whole script, 900 under --phases J)
     J.3 multilevel_tt_vi: pendulum [21, 31] against dense_vi (q95 < 0.05);
         the quadcopter at [5, 7, 9]^6 against the 9^6 oracle (reported; 300
         iterations a level in the whole script, also the pendulum's coarse
         level; the default caps under --phases J)
     J.4 pi_als: tests/test_pials.py's bars (a)-(c) on the pendulum 31^2; the
         users' configuration (experiments/rehearse6d_r5.py) on the 9^6
         quadcopter from J.1's rank-16 base at padding 64: q95 before and
         after, wall, peak device memory (schedule ((1, 32),) in the whole
         script, ((2, 48),) under --phases J)
     J.5 the host path against dense_vi: tt_vi (cross and dmrg) on the pendulum
         (sup < 2 %; 41^2 and 1,500 iterations under --phases J, 31^2 and 300
         in the whole script), tt_pi on Dubins (21, 21, 12) (q95 < 2 %, mean <
         0.5 %, <= 15 outer iterations), mpc_run on LQ against the dense
         value's closed loop under the same noise; tt_vi on the 9^6
         quadcopter for 20 iterations: ms and host syncs an iteration
  K  K1 on non-uniform grids and the users' entry points:
     K.1 (kernels outside the counted run) each K1 entry on tanh grids
         (tests/test_nonuniform.py's nodes, sharp 1.5) against its plain
         version by C's bars, both semantics: the quadcopter 11^6 and
         quadcopter7 9^7 (25 candidates, structured entries), the glider
         (15, 11, 11, 11) (9 candidates, general entries); ms a sweep beside
         the uniform grid of the same shape, timed in the same run, and the
         bound with the spacing tables counted. On the main path: dense_vi on
         the LQ 21^2 tanh grid and solve_local_patch on the pendulum's
         non-uniform patch, card against CPU within 1e-4 x max|v|
     K.2 the CLI (c3sc_tpu_torch.cli.main in this process): the documented
         quadcopter run (--n 31 --rmax 20, 81 candidates, 256 x 500-step
         rollouts; 2,000 iterations under --phases K, cut to 400 in the whole
         script) with ms an iteration, its checkpoints and rollout_wall_s;
         dubins --n 41 --solver dense (K1), its vf.npz bit-equal to dense_vi
         called directly; tests/test_cli.py's flows at LQ 21^2 rank 8 (the
         fused run, --load solver_state.npz, --load vf.npz, --save-format c3tt
         --policy-basis poly, --load vf.c3tt) and --solver tt and pi, each
         with the JAX CLI's summary keys and strict-JSON metrics.jsonl; the
         pendulum with --policy-basis poly (a periodic dim), whose ft_eval
         and ft_grad_eval make no host sync; then
         python -m c3sc_tpu_torch.cli lq --n 21 --solver dense as a subprocess
     K.3 the C3Control builder: tests/test_control_api.py's Riccati bar (31^2,
         rmax 10, rel < 0.08) and its closed loops (poly + refine realizes at
         most lerp's cost under the same noise)
  L  c3sc_tpu_torch.parallel on a world of one rank under NCCL (make_mesh()):
     L.1 the (1, 1) sharded backup: quadcopter 9^6, 16 candidates, 4,096
         nodes on F.2's TT, bit-equal to make_bellman_kernel; both times
     L.2 make_fused_vi(mesh=) at F.3's configuration (31^6, rmax 16, 25
         candidates), graphed, 50 iterations with and without the mesh from
         one warm carry, in turns: ms/iteration of each; ranks equal, values
         within 1e-5 x max|v|; 0 host syncs in 3 graphed iterations and in
         an eager mesh iteration, and the collectives the latter issues
     L.3 make_batch_stepper at bench_scaling.py's configuration (pendulum
         31^2, 9 candidates, rmax 12, tol 0): 8 instances in turn through
         one captured iteration against one instance's graph, instance-iterations/s and peak
         memory; instances 0 and 1 bit-equal to their graphed single solves
     L.4 the sharded 256 x 400 rollout on F.2's value, bit-equal to rollout
         under common noise; then from per-block seeds
  M  K1 on the problems its structured entries cannot take:
     M.1 (kernels outside the counted run) the double integrator of
         C3Control(dx=2, du=5) (acceleration the sum of five inputs; 3
         candidates a control, 243) on 201^2 (40,401 nodes, fc 79 MB), and
         the same problem with all five declarations, which du = 5 also
         sends to the general entries: both against the plain version by
         C's bars, both semantics; ms a sweep against the bound
     M.2 (kernels outside the counted run) C3Control(dx=9, du=1): x_j' =
         -x_j + u [j = 0], noise 0.3, cost |x|^2 + 0.1 u^2, reflecting faces
         on [-1, 1]^9, 3 candidates, on 5^9 (1,953,125 nodes) and on a tanh
         grid of that shape: the general entries' run-time-d form
         (wide_dense_backup_general, wide_dense_evaluate_general) against
         the plain version by C's bars, both semantics; ms a sweep (CUDA
         graph of 100 launches), the plain version's, and the byte bound.
         Then the same family on twelve states at 4^12 (16,777,216 nodes,
         3 candidates, about 7 GB of operands) on both grid forms: ms a
         sweep against the bound (no plain version at this size; the
         policy, the evaluate under it and finite values are checked)
         On the main path: dense_vi on the card against the CPU within
         1e-4 x max|v|, the du = 5 problem at 21^2 (both forms) and the
         nine-state one at 3^9
K1's launch counts (all six entries) are set to 0 before each of D+E, F,
G, H, I, J, K, L and M and read after it (each of D+E to K must launch the
structured entries, H the improve entry, I the four compiled entries, M the
general and the wide ones; L reaches none); the kernels line sums them.
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
PARITY_BAR = 1e-4    # card against CPU on values, relative to max|v| (phase F.1)
FUSED_Q95_BAR = 0.25  # interior q95 of |v_tt - v_dense| / (max - min of v_dense), 9^6 rmax 16
SEED0_Q95 = 0.028826  # the JAX package's interior q95 of the committed seed-0 composite
FLAGSHIP_Q95_BAR = 0.05   # the deployed composite at the recipe's full depth (JAX seeds 0.012-0.032)
MPC_BUDGET_S = 25 * 0.01   # real time: a warm replan within the 25 x 0.01 s it plans for
KERNEL_SOURCE = "c3sc_tpu_torch/csrc/dense_backup.cu"
KERNELS = ("dense_backup", "dense_evaluate", "dense_backup_general", "dense_evaluate_general")
WIDE = ("wide_dense_backup_general", "wide_dense_evaluate_general")   # the run-time-d form
WIDE_CAPS = (12, 16, 32)   # its capacities; the first two keep their state in registers
WIDE_REGISTER_CAPS = (12, 16)   # ... and must keep no local memory (no stack frame, no spills)
ALL_KERNELS = KERNELS + WIDE
NORTHSTAR7 = os.path.join(REPO, "NORTHSTAR7.json")  # the JAX package's 7D record (a TPU run)
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
    # registers and spills of the 6D / 2-control instantiations, of the
    # glider's general ones (d = 4) and of every run-time-d one, from ptxas -v
    text = (_ext.build_dir() / "build.log").read_text()
    wide = [(kind, f"{cap}{',nu' if nu else ''}{',int64' if idx == 'x' else ''}",
             f"ILi{cap}ELi{nu}E{idx}E")
            for kind in ("wide_dense_backup_general_kernel", "wide_dense_evaluate_general_kernel")
            for cap in WIDE_CAPS for nu in (0, 1) for idx in ("j", "x")]
    for kind, args, mangled in [("dense_backup_kernel", "6,2", "ILi6ELi2ELi0EjE"),
                                ("dense_evaluate_kernel", "6,2", "ILi6ELi2ELi0EjE"),
                                ("dense_backup_general_kernel", "4", "ILi4ELi0EjE"),
                                ("dense_evaluate_general_kernel", "4", "ILi4ELi0EjE"),
                                ("dense_backup_kernel", "6,2,nu", "ILi6ELi2ELi1EjE"),
                                ("dense_evaluate_kernel", "6,2,nu", "ILi6ELi2ELi1EjE"),
                                ("dense_backup_kernel", "7,2,nu", "ILi7ELi2ELi1EjE"),
                                ("dense_backup_general_kernel", "4,nu", "ILi4ELi1EjE"),
                                ("dense_evaluate_general_kernel", "4,nu", "ILi4ELi1EjE")] + wide:
        # ...ILi6ELi2ELi0EjE...: d = 6, du = 2, the uniform stencil (Li1: the
        # non-uniform one), 32-bit (unsigned int; x: long long) indices; the
        # run-time-d kernels' first argument is their capacity
        m = re.search(r"\b_Z\w*?" + kind + mangled + r".*?Used (\d+) registers", text, re.S)
        spill = re.search(r"\b_Z\w*?" + kind + mangled
                          + r".*?(\d+) bytes stack frame, (\d+) bytes spill stores", text, re.S)
        if m is None or spill is None:
            raise RuntimeError(f"build.log has no ptxas line for {kind}<{args}>")
        regs, frame, spilled = m.group(1), int(spill.group(1)), int(spill.group(2))
        log(f"[B] {kind}<{args}>: registers {regs}, stack frame {frame} B, spill stores "
            f"{spilled} B")
        if kind.startswith("wide_") and any(mangled.startswith(f"ILi{cap}E")
                                            for cap in WIDE_REGISTER_CAPS) and (frame or spilled):
            raise AssertionError(f"{kind}<{args}> keeps its per-dim state out of registers: "
                                 f"a {frame} B stack frame, {spilled} B of spill stores")


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


def graph_ms(fn, launches=100, reps=5):
    """Milliseconds a call of fn() takes on the device alone: ``launches``
    calls captured as one CUDA graph, whose replay is timed between CUDA
    events (median of ``reps`` replays). No host time enters, unlike
    loop_ms, which a wrapper's host time limits once the kernel is shorter
    than it. Data that fits the 50 MB L2 cache stays there from one launch
    to the next, as it does between dense_vi's back-to-back sweeps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return float(np.median(times))


def _kernel_and_plain_ms(calls, plain_launches):
    """Per-call ms of each of ``calls``: the kernels (keys not ending in
    "plain") by graph_ms, the plain versions by loop_ms; and the kernels'
    eager loop_ms beside, for comparison with earlier runs, which timed
    the eager loop."""
    times = {k: loop_ms(fn, plain_launches) if k.endswith("plain") else graph_ms(fn)
             for k, fn in calls.items()}
    eager = {k: loop_ms(fn, 100) for k, fn in calls.items() if not k.endswith("plain")}
    return times, eager


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
    return _bounds({
        "dense_backup": (N * (node_in + 8) + cand, N * (per_node + C * per_cand)),
        "dense_evaluate": ((N - n_term) * (node_in + 8) + n_term * 9 + cand,
                           (N - n_term) * (per_node + per_cand)),
    })


def general_sweep_bounds(ops):
    """sweep_bounds for the general entries: each node reads its per-candidate
    operands (fc, and s2c and gc where those are per candidate) once for
    every candidate in improve and for its policy's candidate in evaluate.
    The improve that dense_vi runs (with_policy=True) also writes its
    policy's operands (the winner's fc, s2c, gc: ``cand_in`` bytes a node)."""
    N, d = ops.x.shape
    C = ops.uc.shape[0]
    node_in = 4 + 1 + 4 + (4 * d if ops.s2_k is not None else 0) + (4 if ops.q is not None else 0)
    cand_in = 4 * d + (4 * d if ops.s2c_k is not None else 0) + (4 if ops.gc is not None else 0)
    cand = 4 * C if ops.r is not None else 0           # r
    diffusion = 6 * d + 1                              # a, Q0, A0
    per_node = diffusion if ops.s2_k is not None else 0
    per_cand = 5 * d + 8 + (diffusion if ops.s2c_k is not None else 0)
    n_term = int(ops.t_mask.sum())
    return _bounds({
        "dense_backup_general": (N * (node_in + C * cand_in + 8 + cand_in) + cand,
                                 N * (per_node + C * per_cand)),
        "dense_evaluate_general": ((N - n_term) * (node_in + cand_in + 8) + n_term * 9 + cand,
                                   (N - n_term) * (per_node + per_cand)),
    })


def _bounds(work):
    """{name: (bytes, float32 operations)} -> the least times on the card."""
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOP_PER_S
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "flops": flops}
    return out


def _policy_equal(a, b):
    """Two DensePolicy objects hold the same indices and operands, bit for bit."""
    return all((x is None and y is None) or (x is not None and y is not None and torch.equal(x, y))
               for x, y in ((a.best, b.best), (a.fpol_k, b.fpol_k), (a.s2pol_k, b.s2pol_k),
                            (a.gpol, b.gpol)))


def compare_sweep(ops, v, clip, pin_input, label, tag="C"):
    """Kernel against plain version for one improve and one evaluate sweep
    (the structured entries, or the general ones for general operands). The
    improve keeps its policy (with_policy=True, dense_vi's call): for general
    operands its epilogue's operands must equal gather_policy of its argmin
    (the plain torch.gather) bit for bit."""
    from c3sc_tpu_torch.ops import dense_backup as db

    kv, kpol = db.dense_backup(ops, v, clip, pin_input, with_policy=True)
    kb = kpol.best
    pv, pb = db.dense_backup_reference(ops, v, clip, pin_input)
    torch.cuda.synchronize()
    err = (kv - pv).abs()
    bad = int((err > VALUE_BAR * pv.abs().clamp(min=1.0)).sum())
    rhs = db.candidate_rhs(ops, v, clip, pin_input)
    top2 = torch.topk(rhs, 2, dim=0, largest=False).values
    near_tie = (top2[1] - top2[0]) <= TIE_BAR * top2[0].abs().clamp(min=1.0)
    del rhs, top2
    best_bad = int(((kb != pb) & ~near_tie).sum())
    if not _policy_equal(kpol, db.gather_policy(ops, kb)):
        raise AssertionError(f"the improve's policy differs from gather_policy of its argmin: "
                             f"{label}")
    ke = db.dense_evaluate(ops, v, db.gather_policy(ops, pb))
    pe = db.dense_evaluate_reference(ops, v, pb)
    eerr = (ke - pe).abs()
    ebad = int((eerr > VALUE_BAR * pe.abs().clamp(min=1.0)).sum())
    log(f"[{tag}] {label}: improve max|diff| {err.max().item():.3e} (over bar: {bad}), "
        f"argmin differs off near-ties: {best_bad} (near-ties {int(near_tie.sum())}); "
        f"evaluate max|diff| {eerr.max().item():.3e} (over bar: {ebad})")
    if bad or best_bad or ebad or not torch.isfinite(kv).all() or not torch.isfinite(ke).all():
        raise AssertionError(f"K1 disagrees with its plain version: {label}")
    # the 64-bit-index form of both kernels decodes the same nodes
    wv, wpol = db.dense_backup(ops, v, clip, pin_input, with_policy=True, _wide_index=True)
    we = db.dense_evaluate(ops, v, pb, _wide_index=True)   # bare indices: gathered first
    if not (torch.equal(wv, kv) and _policy_equal(wpol, kpol) and torch.equal(we, ke)):
        raise AssertionError(f"K1 with 64-bit indices differs from 32-bit: {label}")
    if clip is None and not pin_input:
        # dense_vi's pair: evaluating under improve's own policy repeats its value
        if not torch.equal(db.dense_evaluate(ops, v, kpol), kv):
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
        times[n], eager = _kernel_and_plain_ms(calls, 50)
        log(f"[C] quadcopter {n}^6 per-sweep ms (kernels: a CUDA graph of 100 launches; plain: "
            "a loop of 50 between one event pair): "
            + ", ".join(f"{k} {x:.4f}" for k, x in times[n].items())
            + "; kernels as an eager loop of 100: "
            + ", ".join(f"{k} {x:.4f}" for k, x in eager.items()))
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


def graphed_vs_eager(solve, label, tag):
    """``solve(cuda_graph)`` -> a solution (``v``, ``sweeps``, ``residual``),
    run eager, graphed, eager, graphed, outside the counted runs (the first
    pair also takes the first-use costs): every run must agree bit for bit
    and count the same K1 launches, replays included. Logs the walls and the
    graphs' capture time."""
    from c3sc_tpu_torch.ops import dense_backup as db
    from c3sc_tpu_torch.solvers.dense import GraphedSweeps

    order, runs = (False, True, False, True), []
    for graphed in order:
        before, captures = db.launch_counts(), GraphedSweeps.captures
        capture_s = GraphedSweeps.capture_seconds
        sol, wall = _synced_s(lambda: solve(graphed))
        made = {k: n - before[k] for k, n in db.launch_counts().items()}
        runs.append((sol, wall, made, GraphedSweeps.captures - captures,
                     GraphedSweeps.capture_seconds - capture_s))
    e = runs[0][0]
    for graphed, (g, _, made, caps, _) in zip(order, runs):
        if not (torch.equal(e.v, g.v) and e.sweeps == g.sweeps and e.residual == g.residual):
            raise AssertionError(f"{label}: the graphed solve differs from the eager one "
                                 f"(max |dv| {(e.v - g.v).abs().max().item():.3e}, sweeps "
                                 f"{e.sweeps} and {g.sweeps})")
        if made != runs[0][2] or caps != (2 if graphed else 0):
            raise AssertionError(f"{label}: launches eager {runs[0][2]}, then {made} "
                                 f"({caps} captures)")
    walls = [r[1] for r in runs]
    log(f"[{tag}] {label}: eager and graphed bit-equal over {e.sweeps} sweeps; walls eager "
        f"{walls[0]:.4f}, {walls[2]:.4f} s, graphed {walls[1]:.4f}, {walls[3]:.4f} s (2 graphs of "
        f"one sweep captured in {runs[1][4]:.4f}, {runs[3][4]:.4f} s of it), eager / graphed "
        f"{walls[2] / walls[3]:.2f}x in the second pair; launches each {runs[0][2]}")


def replay_traced(step, v, label, tag):
    """torch.profiler over ``step(v, 2)`` of a graphed step (both of its
    graphs replayed once): the K1 kernels the card ran, by entry, must equal
    the launches the step counted, which it takes from its captures."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from c3sc_tpu_torch.ops import dense_backup as db

    v, res = step(v, 1)   # captures
    float(res)
    before = db.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        v, res = step(v, 2)
        torch.cuda.synchronize()
    counted_ = {k: n - before[k] for k, n in db.launch_counts().items()}
    ran = dict.fromkeys(ALL_KERNELS, 0)
    device_events = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        device_events += 1
        m = re.search(r"\b((?:wide_)?dense_(?:backup|evaluate)(?:_general)?)_kernel\b", e.name)
        if m:
            ran[m.group(1)] += 1
    if device_events == 0:
        raise RuntimeError(f"{label}: torch.profiler recorded no device events")
    log(f"[{tag}] {label}: one replay of each graph under torch.profiler ran K1 kernels {ran} "
        f"({device_events} device events); the counts added {counted_}")
    if ran != counted_ or sum(ran.values()) == 0:
        raise AssertionError(f"{label}: the graphs ran {ran} K1 kernels, the counts say "
                             f"{counted_}")


def _graph_memory_steady(step, v, chunk, replays=4):
    """Device memory allocated after each of ``replays`` graphed chunks: the
    first captures, the later ones must allocate nothing more than their
    outputs (which the next chunk frees)."""
    seen = []
    for _ in range(replays):
        v, res = step(v, chunk)
        float(res)
        seen.append(torch.cuda.memory_allocated())
    if len(set(seen[1:])) != 1:
        raise AssertionError(f"device memory grows over graph replays: {seen}")
    return seen


def phase_graph_checks(parts=("D", "H", "I")):
    """The graphed solves against the eager loop, outside the counted runs
    (which run the graphs alone): D's dense_vi at 9^6 and 11^6, H.1's patch,
    I.3's glider at (15, 11, 11, 11) and 41^4 bit-equal with both walls; one
    replay traced by torch.profiler (9^6, the glider 41^4, the patch); device
    memory steady over replays (9^6)."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.solvers import dense_vi
    from c3sc_tpu_torch.solvers.dense import make_dense_step, sweep_runner

    if "D" in parts:
        prob = make_problem("quadcopter", **QUAD)
        uc = prob.control_candidates(5)
        for n in (9, 11):
            grid = prob.default_grid(n)
            graphed_vs_eager(
                lambda graphed: dense_vi(prob, grid, controls=uc, tol=1e-5, max_outer=3000,
                                         chunk=25, eval_sweeps=10, device=DEVICE,
                                         cuda_graph=graphed),
                f"dense_vi quadcopter {n}^6", "D")
        step, v0 = make_dense_step(prob, prob.default_grid(9), uc, DEVICE)
        seen = _graph_memory_steady(step, v0, 25)
        log(f"[D] 9^6 graphed chunks of 25: device memory after each of 4 chunks "
            f"{[round(b / 2**20, 1) for b in seen]} MiB (steady after the capture)")
        replay_traced(step, v0, "dense_vi quadcopter 9^6", "D")
    if "H" in parts:
        from c3sc_tpu_torch.convert import tt_from_npz
        from c3sc_tpu_torch.ops import dense_backup as db
        from c3sc_tpu_torch.ops.tt import tt_lerp_eval
        from c3sc_tpu_torch.solvers.local_patch import (default_patch_bounds,
                                                        make_patch_operands, solve_local_patch)

        prob, grid, uc, _ = _flagship_setup()
        v_tt = tt_from_npz(os.path.join(ART, "northstar_seed0_v.npz"), DEVICE)
        tt_fn = lambda p: tt_lerp_eval(v_tt, grid, p)  # noqa: E731
        graphed_vs_eager(lambda graphed: solve_local_patch(prob, grid, tt_fn, uc, margin=1,
                                                           tol=1e-5, device=DEVICE,
                                                           cuda_graph=graphed),
                         "the seed-0 patch re-solved from the TT's faces", "H.1")
        with torch.no_grad():
            ops, v0 = make_patch_operands(prob, grid, tt_fn, uc, *default_patch_bounds(grid, 1),
                                          DEVICE)
            replay_traced(sweep_runner(lambda v: db.dense_backup(ops, v)[0], ops, True),
                          v0.reshape(ops.grid.shape).contiguous(), "the patch's sweep", "H.1")
    if "I" in parts:
        prob = make_problem("glider")
        uc = prob.control_candidates(9)
        for shape, chunk in (((15, 11, 11, 11), 100), (41, 50)):
            grid = prob.default_grid(shape)
            graphed_vs_eager(
                lambda graphed: dense_vi(prob, grid, controls=uc, tol=1e-5, max_outer=2000,
                                         chunk=chunk, device=DEVICE, cuda_graph=graphed),
                f"dense_vi glider {grid.shape}", "I.3")
        step, v0 = make_dense_step(prob, prob.default_grid(41), uc, DEVICE)
        replay_traced(step, v0, "dense_vi glider 41^4", "I.3")


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
        before = db.launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sol, wall = _synced_s(lambda: dense_vi(prob, grid, controls=prob.control_candidates(5),
                                               tol=1e-5, max_outer=3000, chunk=25,
                                               eval_sweeps=10, device=dev))
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        improves = db.dense_backup.launches - before["dense_backup"]
        evals = db.dense_evaluate.launches - before["dense_evaluate"]
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
        log(f"[D] dense_vi quadcopter {n}^6 (graphed): {sol.sweeps} outer sweeps, residual "
            f"{sol.residual:.3e}, floored {sol.floored}, wall {wall:.2f} s, launches "
            f"{improves} improve + {evals} evaluate, peak device memory {peak_mib:.1f} MiB; "
            f"vs stored v max {dmax:.3e} q95 {dq95:.3e}")
        if dmax > SOLVE_BAR:
            raise AssertionError(f"{n}^6: max |v - stored v| {dmax:.3e} > {SOLVE_BAR}")
        values[n] = sol.v
    return values


def _rollout_inputs(prob, n_rollouts, n_steps):
    """x0 as the CLI draws it (seed 0) and one noise tensor from seed 0."""
    rng = np.random.default_rng(0)
    lb, ub = np.asarray(prob.lb), np.asarray(prob.ub)
    mid, span = (lb + ub) / 2, (ub - lb) / 2
    x0 = torch.as_tensor(mid + 0.5 * span * rng.uniform(-1, 1, (n_rollouts, prob.dx)),
                         dtype=torch.float32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    return x0, torch.randn((n_steps, n_rollouts, prob.dw), generator=gen, device=DEVICE)


def phase_e_rollouts(v9, n_rollouts=256, n_steps=400, dt=0.01):
    from c3sc_tpu_torch.convert import value_from_npz
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.sim import make_implicit_policy, rollout

    dev = DEVICE
    prob = make_problem("quadcopter", **QUAD)
    grid = prob.default_grid(tuple(v9.shape))
    controls = torch.as_tensor(prob.control_candidates(5), dtype=torch.float32, device=dev)
    x0, noise = _rollout_inputs(prob, n_rollouts, n_steps)
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
    return c_p


def _quad_fused(n, rmax, device, **kw):
    """The quadcopter's fused solver at n^6 with 25 candidates."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.solvers import make_fused_vi

    prob = make_problem("quadcopter", **kw.pop("problem_kw", QUAD))
    grid = prob.default_grid(n)
    return prob, grid, make_fused_vi(prob, grid, prob.control_candidates(5), rmax=rmax,
                                     device=device, **kw)


def phase_f1_device_parity(n=9, rmax=16, warm=30):
    """The card against the CPU, on values.

    A whole adaptive iteration cannot be compared: where a fiber matrix has
    fewer active rows than columns (core 0: 9 rows), the kick columns are
    rounding noise normalised to unit length, so LAPACK and cuSOLVER pick
    different, equally valid pivots there (printed, no bar). Held instead:
    (a) every block of a left-to-right half sweep on IDENTICAL inputs, the
        CPU's results carried forward: fiber backup (K2) within 1e-4 x max|v|,
        ranks equal, the projector on the needed columns within 1e-3, and the
        interpolation core from the same basis and rows within 1e-4;
    (b) ``phase_f1c_converging_solve``: a whole solve that converges
        (pendulum 31^2) against the dense solve, both on the card;
    and F.2 holds the 9^6 solve against the dense solve by its statistic.
    Neither does a frozen iteration compare: with the freeze the basis keeps
    ``r_prev`` columns, and those beyond ``r_need`` are the free trailing
    columns of a rank-deficient QR.
    """
    from c3sc_tpu_torch.solvers import fused as tf

    prob, grid, cpu = _quad_fused(n, rmax, "cpu")
    _, _, gpu = _quad_fused(n, rmax, DEVICE)
    one = {dev: s.step_fn(s.init_fn(0), 1) for dev, s in (("cpu", cpu), ("cuda", gpu))}
    log(f"[F.1] quadcopter {n}^6 rmax {rmax}, one ADAPTIVE iteration cuda vs cpu (no bar): "
        f"max|dv_sample| {(one['cuda'].v_sample.cpu() - one['cpu'].v_sample).abs().max():.3e}, "
        f"ranks {one['cuda'].ranks.tolist()} vs {one['cpu'].ranks.tolist()}")

    # (a) blockwise, from the CPU carry after `warm` iterations
    carry = cpu.step_fn(cpu.init_fn(0), warm)
    uc = torch.as_tensor(prob.control_candidates(5), dtype=torch.float32)
    backup = {dev: tf.make_fiber_backup(prob, grid, uc.to(dev), rmax) for dev in ("cpu", DEVICE)}
    worst = dict(backup=0.0, projector=0.0, core=0.0)
    vmax = carry.v_sample.abs().max().item()
    ar = torch.arange(rmax)
    for k in range(prob.dx - 1):
        out = {}
        for dev in ("cpu", DEVICE):
            mv = lambda t, dev=dev: t.to(dev)
            vals = backup[dev](tuple(mv(c) for c in carry.cores), mv(carry.ranks), k,
                               mv(carry.left[k]), mv(carry.right[k + 1]))
            row_mask = (ar < carry.rl[k])[:, None].expand(rmax, n).reshape(-1).float()
            C = vals.reshape(rmax * n, rmax) * mv(row_mask)[:, None] \
                * mv((ar < carry.rr[k + 1]).float())[None, :]
            # frozen: no kick columns, so the noise plays no part
            qe, r_need, r_new = tf._orth_basis_and_rank(
                C, torch.zeros_like(C), 1e-4, 2, mv(torch.tensor(rmax)), mv(row_mask),
                mv(carry.rlf[k + 1]), mv(torch.tensor(True)))
            G = tf._interp_from_rows(qe, mv(carry.rows_l[k]), r_new)
            out[dev] = (vals.cpu(), qe.cpu(), int(r_need), int(r_new), G.cpu())
        (va, qa, na, ra, Ga), (vb, qb, nb, rb, Gb) = out["cpu"], out[DEVICE]
        if (na, ra) != (nb, rb):
            raise AssertionError(f"core {k}: ranks differ, cpu {(na, ra)} cuda {(nb, rb)}")
        worst["backup"] = max(worst["backup"], (va - vb).abs().max().item() / vmax)
        worst["projector"] = max(worst["projector"], (qa[:, :na] @ qa[:, :na].T
                                                      - qb[:, :na] @ qb[:, :na].T).abs().max().item())
        Gc = tf._interp_from_rows(qa.to(DEVICE), carry.rows_l[k].to(DEVICE),
                                  torch.tensor(ra, device=DEVICE)).cpu()
        worst["core"] = max(worst["core"], (Gc - Ga).abs().max().item()
                            / max(Ga.abs().max().item(), 1.0))
    log(f"[F.1] blocks of a half sweep on identical inputs (after {warm} iterations, max|v| "
        f"{vmax:.3e}): fiber backup max|diff|/max|v| {worst['backup']:.3e} (bar {PARITY_BAR}), "
        f"ranks equal, projector on the needed columns {worst['projector']:.3e} (bar 1e-3), "
        f"interpolation core {worst['core']:.3e} (bar {PARITY_BAR})")
    if worst["backup"] > PARITY_BAR or worst["projector"] > 1e-3 or worst["core"] > PARITY_BAR:
        raise AssertionError(f"a block of the fused sweep differs on the card: {worst}")



def phase_f1c_converging_solve(n=31, rmax=16):
    """A case where the fused solve converges, whole on the card: pendulum
    31^2 (beta 0.5, sigma 0.5, 9 candidates) against the dense solve there,
    by the bar of the CPU tests: relative sup error under 3 %."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops.tt import tt_gather_eval
    from c3sc_tpu_torch.solvers import dense_vi, fused_tt_vi

    prob = make_problem("pendulum", beta=0.5, sigma=0.5)
    grid = prob.default_grid(n)
    controls = prob.control_candidates(9)
    dense = dense_vi(prob, grid, controls=controls, tol=1e-5, max_outer=400, chunk=100,
                     device=DEVICE)
    sol = fused_tt_vi(prob, grid, controls=controls, rmax=rmax, seed=0, tol=2e-4,
                      max_iters=3000, device=DEVICE)
    v_tt = tt_gather_eval(sol.v, grid.node_indices(DEVICE))
    err = ((v_tt - dense.v.reshape(-1)).abs().max() / dense.v.abs().max()).item()
    log(f"[F.1] fused_tt_vi pendulum {n}^2 rmax {rmax} on the card: {sol.iterations} iterations, "
        f"residual {sol.residual:.3e}, wall {sol.wall_time:.2f} s; vs dense_vi on the card: "
        f"relative sup error {err:.4f} (bar 0.03)")
    if not err < 0.03:
        raise AssertionError(f"fused pendulum solve on the card: sup error {err:.4f} >= 0.03")


def interior_q95(prob, grid, v_tt, v_dense):
    """(interior q95, max) of |v_tt - v_dense| / (max - min of v_dense) at the
    nodes, interior: off the absorbing faces. v_tt: a TT on the grid."""
    from c3sc_tpu_torch.models.base import Boundary
    from c3sc_tpu_torch.ops.tt import tt_gather_eval

    v = tt_gather_eval(v_tt, grid.node_indices(DEVICE)).reshape(grid.shape)
    if not torch.isfinite(v).all():
        raise AssertionError("a TT value is not finite")
    rel = (v.double() - v_dense.double()).abs() / (v_dense.max() - v_dense.min()).double()
    sl = tuple(slice(1, -1) if b == Boundary.ABSORB else slice(None) for b in prob.boundary)
    return torch.quantile(rel[sl].reshape(-1).float(), 0.95).item(), rel.max().item()


def phase_f2_solve(v_dense, n=9, rmax=16):
    """The 9^6 fused solve against the dense solve, then the probe path.
    Returns the solution and its interior q95."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.solvers import fused_tt_vi

    prob = make_problem("quadcopter", **QUAD)
    grid = prob.default_grid(n)
    controls = prob.control_candidates(5)
    sol = fused_tt_vi(prob, grid, controls=controls, rmax=rmax, seed=0, tol=2e-4,
                      max_iters=900, patience=25, probe_rollouts=0, device=DEVICE,
                      cuda_graph=True)
    vrange = (v_dense.max() - v_dense.min()).item()
    q95, rmax_rel = interior_q95(prob, grid, sol.v, v_dense)
    log(f"[F.2] fused_tt_vi quadcopter {n}^6 rmax {rmax} (CUDA graph of an iteration): "
        f"{sol.iterations} iterations, "
        f"residual {sol.residual:.3e}, ranks {sol.v.ranks.tolist()}, wall {sol.wall_time:.2f} s "
        f"({1e3 * sol.wall_time / max(sol.iterations, 1):.2f} ms/iteration); vs dense_vi "
        f"(range {vrange:.2f}): max rel {rmax_rel:.4f}, interior q95 {q95:.4f} "
        f"(bar {FUSED_Q95_BAR})")
    if not q95 <= FUSED_Q95_BAR:
        raise AssertionError(f"fused {n}^6 solve: interior q95 {q95:.4f} > {FUSED_Q95_BAR}")
    probe = fused_tt_vi(prob, grid, controls=controls, rmax=rmax, seed=0, tol=2e-4,
                        max_iters=100, patience=25, probe_rollouts=8, probe_steps=50,
                        device=DEVICE)
    log(f"[F.2] probe harvest (8 rollouts x 50 steps, 100 iterations): probe_cost "
        f"{probe.probe_cost:.4f}, wall {probe.wall_time:.2f} s")
    if not np.isfinite(probe.probe_cost):
        raise AssertionError("the probe path left no finite probe_cost")
    return sol, q95


def phase_f3_bench(n=31, reps=200, eager_reps=25, warmup=30):
    """The bench configuration: default quadcopter, 31^6, 25 candidates, tol 0.
    The eager loop is timed over ``eager_reps`` iterations (its rate is the
    host's launch rate, 0.1-0.25 s an iteration), the graph over ``reps``."""
    carries = {}
    for rmax in (16, 32):
        prob, grid, solver = _quad_fused(n, rmax, DEVICE, problem_kw={}, tol=0.0,
                                         max_iters=10**9)
        carry = solver.step_fn(solver.init_fn(0), warmup)   # adapt the ranks, warm the caches
        torch.cuda.synchronize()
        ranks_pre = carry.ranks.clone()
        t0 = time.perf_counter()
        carry = solver.step_fn(carry, eager_reps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steady = bool(torch.equal(carry.ranks, ranks_pre))
        # active backups per iteration: every core-step evaluates its active
        # fiber block rl[k] * n_k * rr[k+1], once in each half sweep (exact
        # only when the ranks held still over the timed region)
        rl, rr = carry.rl.tolist(), carry.rr.tolist()
        per_iter = 2 * sum(rl[k] * grid.shape[k] * rr[k + 1] for k in range(prob.dx))
        lat = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            carry = solver.step_fn(carry, 3)
            torch.cuda.synchronize()
            lat.append(1e3 * (time.perf_counter() - t1))
        log(f"[F.3] quadcopter {n}^6 rmax {rmax}, eager loop: {1e3 * wall / eager_reps:.3f} "
            f"ms/iteration over {eager_reps} iterations, {per_iter} active backups/iteration, "
            f"{per_iter * eager_reps / wall:.4e} backups/s, ranks {carry.ranks.tolist()} held still "
            f"{steady}, warm 3-iteration replan median {float(np.median(lat)):.3f} ms")
        if not torch.isfinite(carry.v_sample).all():
            raise AssertionError(f"{n}^6 rmax {rmax}: the sample values are not finite")
        # the same loop as a CUDA graph of one masked iteration (cuda_graph=True)
        _, _, graphed = _quad_fused(n, rmax, DEVICE, problem_kw={}, tol=0.0, max_iters=10**9,
                                    cuda_graph=True)
        same = (graphed.run_fn(carry, 3).v_sample - solver.run_fn(carry, 3).v_sample).abs().max()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = graphed.run_fn(carry, reps)
        torch.cuda.synchronize()
        gwall = time.perf_counter() - t0
        lat = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = graphed.run_fn(out, 3)
            torch.cuda.synchronize()
            lat.append(1e3 * (time.perf_counter() - t1))
        log(f"[F.3] quadcopter {n}^6 rmax {rmax}, CUDA graph: {1e3 * gwall / reps:.3f} ms/iteration "
            f"over {reps} iterations, {per_iter * reps / gwall:.4e} backups/s, warm 3-iteration "
            f"replan median {float(np.median(lat)):.3f} ms; 3 iterations graph vs eager "
            f"max|dv_sample| {same.item():.3e}")
        if not (torch.isfinite(out.v_sample).all() and same.item() <= PARITY_BAR * 100.0):
            raise AssertionError(f"{n}^6 rmax {rmax}: the graphed loop differs from the eager one")
        carries[rmax] = (solver, carry)
    return carries


# the runtime calls in which the host waits for the device: reading a CUDA
# tensor on the host (``.item()``) and a pageable upload both end in one
SYNC_NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
BLOCKS = ("fiber_backup", "core_fit")


def profile_iterations(solver, carry, iters=10, label="", tag="F.4"):
    """torch.profiler over ``iters`` warm iterations: wall, device-busy time and
    idle share of the window; device time and launches under the two
    ``record_function`` ranges of a core-step; the host syncs inside the
    window and the scalar reads on the host (``aten::item``, counted apart:
    a Python float written into a CUDA tensor reads a CPU tensor, which
    waits for nothing but costs host time). There must be neither.""" 
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    carry = solver.step_fn(carry, 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function("fused_window"):
            carry = solver.step_fn(carry, iters)
        enqueued = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    spans = {name: [] for name in BLOCKS + ("fused_window",)}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in spans:
            spans[e.name].append((e.time_range.start, e.time_range.end))
    (w0, w1), = spans["fused_window"]

    def block_of(t):
        for name in BLOCKS:
            if any(a <= t <= b for a, b in spans[name]):
                return name
        return "other"

    def op_above(e):
        """The outermost aten op that encloses event e (below the ranges)."""
        top = e.name
        while e.cpu_parent is not None and e.cpu_parent.name not in spans:
            e = e.cpu_parent
            top = e.name if e.name.startswith("aten::") else top
        return top

    dev_ms = {name: 0.0 for name in BLOCKS + ("other",)}
    launches = {name: 0 for name in BLOCKS + ("other",)}
    syncs, host_reads = {}, {}
    for e in events:
        if e.device_type != DeviceType.CPU or not (w0 <= e.time_range.start <= w1):
            continue
        if e.name in SYNC_NAMES:
            key = f"{e.name} in {op_above(e)}"
            syncs[key] = syncs.get(key, 0) + 1
        elif e.name == "aten::_local_scalar_dense":
            key = op_above(e)
            host_reads[key] = host_reads.get(key, 0) + 1
        for k in e.kernels:
            b = block_of(e.time_range.start)
            dev_ms[b] += k.duration / 1e3
            launches[b] += 1
    busy = sum(dev_ms.values())
    if busy == 0:
        raise RuntimeError("torch.profiler recorded no device time")
    top = sorted(((getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
                  for e in prof.key_averages()), reverse=True)[:6]
    log(f"[{tag}] {label}: {iters} warm iterations under torch.profiler: wall {wall:.2f} ms "
        f"({wall / iters:.3f} ms/iteration; host done enqueuing at {enqueued:.2f} ms), device "
        f"busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}")
    for name in BLOCKS + ("other",):
        log(f"[{tag}]   {name}: device {dev_ms[name] / iters:.3f} ms/iteration in "
            f"{launches[name] / iters:.0f} launches/iteration")
    for ms, count, key in top:
        log(f"[{tag}]   {ms / iters:.4f} ms/iteration in {count / iters:.0f} launches/iteration: "
            f"{key[:80]}")
    log(f"[{tag}]   host syncs inside the window, by the aten op they sit in: "
        f"{syncs if syncs else 'none'}; scalar reads (_local_scalar_dense), by op: "
        f"{host_reads or 'none'}")
    if syncs:
        raise AssertionError(f"an iteration reads the device on the host: {syncs}")
    if host_reads:
        raise AssertionError(f"an iteration reads scalars on the host: {host_reads}")
    return dict(wall_ms=wall / iters, busy_ms=busy / iters, idle=1 - busy / wall,
                dev_ms={k: v / iters for k, v in dev_ms.items()},
                launches={k: v / iters for k, v in launches.items()}), carry


def phase_f5_rollouts(sol, n_rollouts=256, n_steps=400, dt=0.01):
    """Phase E's rollouts, steered by the TT value through tt_lerp_eval."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops.tt import tt_lerp_eval
    from c3sc_tpu_torch.sim import make_implicit_policy, rollout

    prob = make_problem("quadcopter", **QUAD)
    grid = prob.default_grid(sol.v.shape)
    controls = torch.as_tensor(sol.controls, dtype=torch.float32, device=DEVICE)
    x0, noise = _rollout_inputs(prob, n_rollouts, n_steps)
    policy = make_implicit_policy(prob, grid, lambda p: tt_lerp_eval(sol.v, grid, p), controls)
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.no_grad():
        traj = rollout(prob, grid, policy, x0, dt, n_steps, noise=noise)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if not torch.isfinite(traj.cost).all() or not torch.isfinite(traj.xs).all():
        raise AssertionError("rollouts on the TT value: costs or states are not finite")
    log(f"[F.5] rollouts on the fused TT value (tt_lerp_eval): {n_rollouts} x {n_steps} steps "
        f"dt {dt}: mean cost {traj.cost.mean().item():.4f}, survival "
        f"{100 * traj.alive[-1].float().mean().item():.2f}%, wall {wall:.2f} s")


def phase_f_fused(v9):
    """Phase F; returns F.2's solution and its interior q95."""
    phase_f1_device_parity()
    phase_f1c_converging_solve()
    sol, q95 = phase_f2_solve(v9)
    carries = phase_f3_bench()
    profile_iterations(*carries[16], label="quadcopter 31^6 rmax 16")
    phase_f5_rollouts(sol)
    return sol, q95


def _synced_s(fn):
    """(result, seconds) of fn() between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_g1_refinement(v9, e_cost=None, f2_q95=None, n_rollouts=256, n_steps=400, dt=0.01):
    """G.1: continuous control refinement on the card: (a) the refined dense
    policy through K1, (b) rollouts under the refined implicit policy, (d)
    the refined fused 9^6 solve under the CUDA graph, (c) one refined fiber
    backup block, card against CPU, on (d)'s carry."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops.dense_backup import make_dense_operands, neighbor_values
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.sim import make_implicit_policy, rollout
    from c3sc_tpu_torch.solvers import dense_policy, fused_tt_vi, rhs_continuous
    from c3sc_tpu_torch.solvers import fused as tf

    prob = make_problem("quadcopter", **QUAD)
    grid = prob.default_grid(tuple(v9.shape))
    n = grid.shape[0]
    uc_np = prob.control_candidates(5)
    uc = torch.as_tensor(uc_np, dtype=torch.float32, device=DEVICE)

    # (a) the refined dense policy: every node's RHS at most its candidate's
    brute = dense_policy(prob, grid, v9, uc_np, device=DEVICE).reshape(-1, prob.du)
    walls = []
    for _ in range(2):      # the first call in the process, then a warm one
        refined, wall = _synced_s(lambda: dense_policy(prob, grid, v9, uc_np, device=DEVICE,
                                                       refine_steps=2))
        walls.append(wall)
    refined = refined.reshape(-1, prob.du)
    ops = make_dense_operands(prob, grid, uc_np, DEVICE)
    vp, vm = neighbor_values(v9, grid)
    f = rhs_continuous(prob, grid, ops.x, torch.stack([vp, vm], dim=1))
    with torch.no_grad():
        f_ref, f_brute = f(refined), f(brute)
    above = int((f_ref > f_brute).sum())
    moved = (refined != brute).any(-1).float().mean().item()
    log(f"[G.1a] dense_policy(refine_steps=2) quadcopter {n}^6 ({v9.numel()} nodes, argmin by "
        f"K1): wall {walls[0]:.3f} s first call, {walls[1]:.3f} s warm, controls moved at "
        f"{100 * moved:.2f}% of the nodes, mean RHS "
        f"{f_brute.mean().item():.4f} -> {f_ref.mean().item():.4f}, nodes whose refined RHS "
        f"exceeds the candidate's: {above}")
    if above or not torch.isfinite(refined).all():
        raise AssertionError(f"refined dense policy: {above} nodes above their candidate's RHS")

    # (b) phase E's rollouts under the refined implicit policy
    x0, noise = _rollout_inputs(prob, n_rollouts, n_steps)
    costs = {}
    for steps in (0, 2):
        if steps == 0 and e_cost is not None:
            costs[0] = e_cost
            continue
        policy = make_implicit_policy(prob, grid, lambda p: multilinear_interp(grid, v9, p), uc,
                                      refine_steps=steps)
        with torch.no_grad():
            traj, wall = _synced_s(lambda: rollout(prob, grid, policy, x0, dt, n_steps,
                                                   noise=noise))
        if not (torch.isfinite(traj.cost).all() and torch.isfinite(traj.xs).all()):
            raise AssertionError(f"rollouts under refine_steps={steps}: not finite")
        costs[steps] = traj.cost.mean().item()
    log(f"[G.1b] rollouts {n_rollouts} x {n_steps} steps dt {dt} on the dense {n}^6 value, "
        f"implicit policy refine_steps=2: mean cost {costs[2]:.4f} against {costs[0]:.4f} "
        f"unrefined (phase E), survival {100 * traj.alive[-1].float().mean().item():.2f}%, "
        f"wall {wall:.2f} s")

    # (d) the refined fused solve, F.2's configuration under the graph
    sol = fused_tt_vi(prob, grid, controls=uc_np, rmax=16, seed=0, tol=2e-4, max_iters=900,
                      patience=25, device=DEVICE, cuda_graph=True, refine_steps=2)
    q95, rel_max = interior_q95(prob, grid, sol.v, v9)
    f2 = f"{f2_q95:.4f}" if f2_q95 is not None else "not run (phase F skipped)"
    log(f"[G.1d] fused_tt_vi quadcopter {n}^6 rmax 16 refine_steps=2 (CUDA graph): "
        f"{sol.iterations} iterations, residual {sol.residual:.3e}, wall {sol.wall_time:.2f} s "
        f"({1e3 * sol.wall_time / max(sol.iterations, 1):.2f} ms/iteration); vs dense_vi: "
        f"interior q95 {q95:.4f} (bar {FUSED_Q95_BAR}; F.2 refine 0: {f2}), max rel {rel_max:.4f}")
    if not q95 <= FUSED_Q95_BAR:
        raise AssertionError(f"refined fused {n}^6 solve: interior q95 {q95:.4f}")

    # (c) one refined fiber-backup block per core, card against CPU, on (d)'s carry
    c = sol.carry
    worst, vmax = 0.0, 0.0
    for k in range(prob.dx):
        out = {}
        for dev in ("cpu", DEVICE):
            backup = tf.make_fiber_backup(prob, grid, uc.to(dev), 16, refine_steps=2)
            out[dev] = backup(tuple(t.to(dev) for t in c.cores), c.ranks.to(dev), k,
                              c.left[k].to(dev), c.right[k + 1].to(dev)).cpu()
        vmax = max(vmax, out["cpu"].abs().max().item())
        worst = max(worst, (out["cpu"] - out[DEVICE]).abs().max().item())
    log(f"[G.1c] refined fiber backup (refine_steps=2), all {prob.dx} cores on the solved "
        f"carry, cuda vs cpu: max|diff| / max|v| {worst / vmax:.3e} (bar {PARITY_BAR})")
    if worst > PARITY_BAR * vmax:
        raise AssertionError("the refined fiber backup differs on the card")
    # where a refined iteration's device time goes (eager, so the profiler
    # sees the two blocks), and that the refinement reads nothing on the host
    _, _, eager = _quad_fused(n, 16, DEVICE, tol=0.0, max_iters=10**9, refine_steps=2)
    profile_iterations(eager, c, iters=5, label=f"refined fused iteration, quadcopter {n}^6 "
                       "rmax 16", tag="G.1d")


def phase_g2_mpc(n=31, rmax=16, n_rollouts=256, n_replans=6, steps=25, dt=0.01,
                 first_solve_iters=400):
    """G.2: fused MPC at the bench's configuration (bench.py:38-106), with
    the cold solve cut from the bench's 800 iterations to 400 to keep the
    script within its time (F.3 finds the ranks saturated at 16 after 30)."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.sim import fused_mpc_run

    # the graphed step_fn against the eager one, 3 iterations from one carry
    prob, grid, eager = _quad_fused(n, rmax, DEVICE, problem_kw={}, tol=0.0, max_iters=10**9)
    _, _, graphed = _quad_fused(n, rmax, DEVICE, problem_kw={}, tol=0.0, max_iters=10**9,
                                cuda_graph=True)
    carry = eager.step_fn(eager.init_fn(0), 20)
    same = (graphed.step_fn(carry, 3).v_sample - eager.step_fn(carry, 3).v_sample).abs().max()
    log(f"[G.2] quadcopter {n}^6 rmax {rmax}: 3 iterations of step_fn, CUDA graph vs eager, "
        f"from one carry: max|dv_sample| {same.item():.3e} (bar {PARITY_BAR * 100})")
    if not same.item() <= PARITY_BAR * 100.0:
        raise AssertionError("the graphed step_fn differs from the eager one")
    del eager, graphed, carry
    torch.cuda.empty_cache()

    prob = make_problem("quadcopter")
    x0, _ = _rollout_inputs(prob, n_rollouts, 1)
    res = fused_mpc_run(prob, prob.default_grid(n), x0, dt=dt, steps_per_replan=steps,
                        n_replans=n_replans, controls=prob.control_candidates(5), rmax=rmax,
                        refine_iters=3, first_solve_iters=first_solve_iters, seed=0,
                        device=DEVICE)
    warm = res.replan_latency[1:]
    med = float(np.median(warm))
    log(f"[G.2] fused_mpc_run quadcopter {n}^6 rmax {rmax}, 25 candidates: cold solve "
        f"{first_solve_iters} iterations in {res.solve_s:.2f} s (capture included); warm "
        f"3-iteration replans (ms) {[round(1e3 * t, 2) for t in warm]}, median "
        f"{1e3 * med:.2f} ms (budget {1e3 * MPC_BUDGET_S:.0f} ms); {n_rollouts} rollouts x "
        f"{n_replans} x {steps} steps: mean cost {res.cost.mean().item():.4f}, residuals "
        f"{[f'{r:.2e}' for r in res.residuals]}")
    if not (med < MPC_BUDGET_S and torch.isfinite(res.cost).all()
            and tuple(res.xs.shape) == (1 + n_replans * steps, n_rollouts, prob.dx)):
        raise AssertionError(f"fused MPC: median replan {med:.3f} s or costs not finite")


def phase_g3_tracking(n=9, rmax=16, n_rollouts=256):
    """G.3: tracking re-solves at bench.py:207-228's configuration, then the
    re-solve at a moved target against a dense solve there, then the closed
    loop against the stale-value ablation."""
    from c3sc_tpu_torch.models import make_quadcopter_family
    from c3sc_tpu_torch.ops.tt import TT
    from c3sc_tpu_torch.sim import tracking
    from c3sc_tpu_torch.solvers import bellman_residual_sample, dense_vi
    from c3sc_tpu_torch.solvers import fused as tf

    family = make_quadcopter_family(**QUAD)
    prob0 = family(np.zeros(2))
    grid = prob0.default_grid(n)
    controls = prob0.control_candidates(5)
    builds, real = [], tracking.make_fused_vi

    def counting(*args, **kwargs):
        builds.append(1)
        return real(*args, **kwargs)

    captures = tf._GraphedIteration.captures
    tracking.make_fused_vi = counting
    try:
        solver = tracking.make_tracking_solver(family, grid, controls, rmax=rmax,
                                               solver_kwargs={"sample_size": 256}, device=DEVICE)
    finally:
        tracking.make_fused_vi = real
    carry, t_init = _synced_s(lambda: solver.init(np.zeros(2), 0, 300))
    carry = solver.update(carry, np.array([0.3, 0.1]), 10)
    lat = []
    for i in range(5):
        carry, t = _synced_s(lambda: solver.update(carry, np.array([0.1 * i - 0.2, 0.05 * i]), 10))
        lat.append(t)
    stale = carry
    theta = np.array([0.8, 0.0])
    carry, t_move = _synced_s(lambda: solver.update(carry, theta, 600))
    log(f"[G.3] tracking quadcopter {n}^6 rmax {rmax}, 25 candidates: init 300 iterations "
        f"{t_init:.2f} s (capture included); 10-iteration cost updates (ms) "
        f"{[round(1e3 * t, 2) for t in lat]}, median {1e3 * float(np.median(lat)):.2f} ms; "
        f"update to theta* = {theta.tolist()} for 600 iterations {t_move:.2f} s")

    prob = family(torch.as_tensor(theta, dtype=torch.float32, device=DEVICE))
    dense = dense_vi(prob, grid, controls=controls, tol=1e-5, max_outer=3000, chunk=25,
                     eval_sweeps=10, device=DEVICE)
    q_new, _ = interior_q95(prob, grid, TT(carry.cores, carry.ranks), dense.v)
    q_old, _ = interior_q95(prob, grid, TT(stale.cores, stale.ranks), dense.v)
    res, _ = bellman_residual_sample(prob, grid, controls, TT(carry.cores, carry.ranks))
    hi = prob.value_bounds[1]
    log(f"[G.3] vs dense_vi at theta* ({dense.sweeps} sweeps on K1, residual "
        f"{dense.residual:.2e}): interior q95 re-solved {q_new:.4f}, stale {q_old:.4f} (bar "
        f"{FUSED_Q95_BAR}, and below stale); bellman_residual_sample of the re-solved value "
        f"{res.item():.4e}; dense v at theta* max {dense.v.max().item():.3f} against the kept "
        f"upper value bound {hi:.3f}: {int((dense.v > hi).sum())} nodes above it")
    if not (q_new <= FUSED_Q95_BAR and q_new < q_old):
        raise AssertionError(f"tracking re-solve at theta*: q95 {q_new:.4f} (stale {q_old:.4f})")

    x0, _ = _rollout_inputs(prob0, n_rollouts, 1)
    schedule = np.array([[0.0, 0.0], theta])
    runs = {}
    for stale_run in (False, True):
        run, wall = _synced_s(lambda: tracking.tracking_mpc_run(
            solver, family, schedule, x0, dt=0.01, steps_per_segment=200, replan_iters=300,
            first_solve_iters=600, stale=stale_run, seed=0))
        if not torch.isfinite(run.cost).all():
            raise AssertionError("tracking closed loop: costs not finite")
        runs[stale_run] = (run.cost.mean().item(), wall, run.replan_latency_s)
    log(f"[G.3] tracking_mpc_run schedule {schedule.tolist()}, {n_rollouts} rollouts x 2 x "
        f"200 steps, first solve 600 and replan 300 iterations: mean cost tracking "
        f"{runs[False][0]:.4f} (replan "
        f"{1e3 * runs[False][2][0]:.1f} ms, wall {runs[False][1]:.2f} s), stale "
        f"{runs[True][0]:.4f} (wall {runs[True][1]:.2f} s)")
    made = tf._GraphedIteration.captures - captures
    log(f"[G.3] across every cost update: make_fused_vi built {len(builds)} time(s), CUDA "
        f"graph captured {made} time(s)")
    if len(builds) != 1 or made != 1:
        raise AssertionError(f"tracking rebuilt ({len(builds)}) or recaptured ({made})")


def phase_g_control(v9, e_cost=None, f2_q95=None):
    phase_g1_refinement(v9, e_cost, f2_q95)
    phase_g2_mpc()
    phase_g3_tracking()


# ---- phase H: the flagship accuracy stack -------------------------------------------

def _flagship_setup():
    from c3sc_tpu_torch.convert import value_from_npz
    from c3sc_tpu_torch.models import make_problem

    prob = make_problem("quadcopter", **QUAD)
    grid = prob.default_grid(9)
    uc = prob.control_candidates(5)
    return prob, grid, uc, value_from_npz(os.path.join(ART, "quad_dense_v9.npz"), DEVICE)


def field_q95(prob, values, v_dense):
    """(interior q95, full q95) of |values - v_dense| / (max - min of v_dense)
    at the nodes; interior: off the absorbing faces."""
    from c3sc_tpu_torch.models.base import Boundary

    if not torch.isfinite(values).all():
        raise AssertionError("a value field is not finite")
    rel = (values.double() - v_dense.double()).abs() / (v_dense.max() - v_dense.min()).double()
    sl = tuple(slice(1, -1) if b == Boundary.ABSORB else slice(None) for b in prob.boundary)
    q = lambda a: torch.quantile(a.reshape(-1).float(), 0.95).item()  # noqa: E731
    return q(rel[sl]), q(rel)


def composite_at_nodes(grid, vfn, chunk=131072):
    """A value function at every node of grid, [*grid.shape]."""
    x = grid.node_states(DEVICE)
    with torch.no_grad():
        return torch.cat([vfn(x[i:i + chunk]) for i in range(0, x.shape[0], chunk)]).reshape(
            grid.shape)


def phase_h1_committed():
    """H.1: the committed seed-0 fields; returns the patch's operands and the
    stored patch for the kernel's comparison."""
    from c3sc_tpu_torch.convert import patch_from_npz, tt_from_npz
    from c3sc_tpu_torch.ops import dense_backup as db
    from c3sc_tpu_torch.ops.tt import tt_lerp_eval
    from c3sc_tpu_torch.solvers.local_patch import (make_patch_operands, make_patched_value_fn,
                                                    solve_local_patch)

    prob, grid, uc, vd = _flagship_setup()
    v_tt = tt_from_npz(os.path.join(ART, "northstar_seed0_v.npz"), DEVICE)
    patch = patch_from_npz(os.path.join(ART, "northstar_seed0_patch.npz"), grid, DEVICE)
    tt_fn = lambda p: tt_lerp_eval(v_tt, grid, p)  # noqa: E731
    comp, wall = _synced_s(lambda: composite_at_nodes(
        grid, make_patched_value_fn(grid, tt_fn, patch)))
    q_in, q_full = field_q95(prob, comp, vd)
    q_tt, _ = field_q95(prob, composite_at_nodes(grid, tt_fn), vd)
    log(f"[H.1] committed seed-0 fields (TT ranks {v_tt.ranks.tolist()}, patch "
        f"{tuple(patch.v.shape)} at nodes {patch.lo}..{patch.hi}): deployed composite at "
        f"{comp.numel()} nodes in {wall:.3f} s, vs quad_dense_v9.npz interior q95 {q_in:.6f} "
        f"(JAX {SEED0_Q95}, bar 1e-4), full q95 {q_full:.6f}; the TT alone interior q95 "
        f"{q_tt:.6f}")
    if abs(q_in - SEED0_Q95) > 1e-4:
        raise AssertionError(f"committed composite: interior q95 {q_in:.6f} vs {SEED0_Q95}")
    before = db.dense_backup.launches
    sol, wall = _synced_s(lambda: solve_local_patch(prob, grid, tt_fn, uc, margin=1, tol=1e-5,
                                                    device=DEVICE))
    launched = db.dense_backup.launches - before
    ops, v0 = make_patch_operands(prob, grid, tt_fn, uc, patch.lo, patch.hi, DEVICE)
    face = ops.t_mask.reshape(sol.v.shape)
    diff = (sol.v - patch.v).abs()
    log(f"[H.1] patch re-solved from the TT's faces (solve_local_patch, K1): {sol.sweeps} sweeps, "
        f"{wall:.4f} s (a sweep a graph replay), residual {sol.residual:.3e}, {launched} K1 "
        f"improve launches; "
        f"|patch - stored patch| max {diff[face].max().item():.4e} on the faces (the stored "
        f"patch's faces are not the stored TT's), {diff[~face].max().item():.4e} inside")
    if launched != sol.sweeps or launched == 0 or not torch.isfinite(sol.v).all():
        raise AssertionError("the patch re-solve did not run through K1")
    return ops, v0, patch.v.contiguous()


def fused_bases(prob, grid, uc, recipe=True, graphed_iters=900, seed=0):
    """The flagship's rank-16 fused bases (tol 2e-4, patience 25, the
    recipe's ``seed``), by label: the recipe's
    (experiments/quad_dense_oracle.py:160-161 and quad7_northstar.py:76-79:
    eager, up to 1,500 iterations, the probe harvest of 32 rollouts x 500
    steps; when ``recipe``), then the graphed variant (a CUDA graph of one
    iteration, no probe, ``graphed_iters``)."""
    from c3sc_tpu_torch.solvers import fused_tt_vi

    kw = dict(controls=uc, rmax=16, seed=seed, tol=2e-4, patience=25, device=DEVICE)
    bases = {}
    if recipe:
        bases["recipe: eager, probe harvest, <= 1500 iterations"] = fused_tt_vi(
            prob, grid, max_iters=1500, probe_rollouts=32, probe_steps=500, probe_dt=0.01, **kw)
    bases[f"graphed variant: no probe, <= {graphed_iters} iterations"] = fused_tt_vi(
        prob, grid, max_iters=graphed_iters, probe_rollouts=0, cuda_graph=True, **kw)
    return bases


def phase_h2_recipe(fused, cycles, rmax=64, steps=10, seed=0, label="graphed variant"):
    """H.2: quad_dense_oracle.py's recipe from a fused base (``label`` names
    which). ``seed`` is the recipe's: the polish generators are seeded
    1000 seed + cycle as its keys are; the gating probe (seed 4242) and the
    two-level solve (seed 0) do not vary with it, as in the recipe. Returns
    the deployed composite's value function and its interior q95."""
    from c3sc_tpu_torch.ops.tt import _repad, tt_lerp_eval
    from c3sc_tpu_torch.solvers.gating import gated_apply, make_greedy_probe
    from c3sc_tpu_torch.solvers.local_patch import make_patched_value_fn, two_level_solve
    from c3sc_tpu_torch.solvers.polish import level_correct, mode_correct, tt_polish
    from c3sc_tpu_torch.solvers.ttvi import make_bellman_kernel
    from c3sc_tpu_torch.solvers.twogrid import coarse_correct

    prob, grid, uc, vd = _flagship_setup()

    def tt_q95(v):
        with torch.no_grad():
            return interior_q95(prob, grid, v, vd)[0]

    q_fused = tt_q95(fused.v)
    log(f"[H.2] fused base, {label} (rmax {fused.v.rmax}, {fused.iterations} iterations, "
        f"{fused.wall_time:.2f} s, "
        f"ranks {fused.v.ranks.tolist()}): interior q95 {q_fused:.4f}")
    kernel = make_bellman_kernel(prob, grid, uc, chunk=32768)
    v, state = _repad(fused.v, rmax), None
    t_cycles = time.perf_counter()
    for cyc in range(cycles):
        t0 = time.perf_counter()
        psol = tt_polish(prob, grid, uc, v, rmax=rmax, schedule=((steps, rmax),), check_every=4,
                         kernel=kernel, state=state,
                         generator=torch.Generator().manual_seed(1000 * seed + cyc))
        v, state = psol.v, psol.state
        t1 = time.perf_counter()
        v, cinfo = coarse_correct(prob, grid, uc, v, kernel=kernel, rmax_corr=32)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        bres = [round(h["bres"], 5) for h in psol.history if "bres" in h]
        log(f"[H.2] cycle {cyc}: polish {steps} steps {t1 - t0:.2f} s (best step "
            f"{psol.best_step}, sampled bres {bres}, ranks {psol.history[-1]['ranks']}, "
            f"{psol.n_evals} backups); coarse correction {t2 - t1:.2f} s, |e|_max "
            f"{cinfo.correction_scale:.4f}, bres {cinfo.bres_before:.4f} -> "
            f"{cinfo.bres_after:.4f}, accepted {cinfo.accepted}; interior q95 {tt_q95(v):.4f}")
    wall_cycles = time.perf_counter() - t_cycles
    q_polished = tt_q95(v)

    t0 = time.perf_counter()
    probe = make_greedy_probe(prob, grid, uc, n_rollouts=24, n_steps=250, dt=0.01,
                              device=DEVICE)
    gates = []
    for name, corr in (("level", level_correct), ("modes", mode_correct)):
        v, rec = gated_apply(prob, grid, uc, v,
                             lambda vt, corr=corr: corr(prob, grid, uc, vt, kernel=kernel)[0],
                             name=name, kernel=kernel, probe_fn=probe)
        gates.append(rec)
        log(f"[H.2] gate {name}: bres {rec.bres_before:.4f} -> {rec.bres_after:.4f}, probe "
            f"{rec.probe_before:.4f} -> {rec.probe_after:.4f}: "
            f"{'accepted' if rec.accepted else 'rejected'}")
    wall_gates = time.perf_counter() - t0
    q_gated = tt_q95(v)
    t0 = time.perf_counter()
    tl = two_level_solve(prob, grid, uc, v, rmax=rmax, cycles=2,
                         cycle_schedule=((steps, rmax),), margin=1,
                         generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    wall_tl = time.perf_counter() - t0
    v, patch = tl.v, tl.patch
    vfn = make_patched_value_fn(grid, lambda p: tt_lerp_eval(v, grid, p), patch)
    q_comp, q_comp_full = field_q95(prob, composite_at_nodes(grid, vfn), vd)
    for rec in tl.history:
        log(f"[H.2] two-level cycle {rec['cycle']}: patch residual {rec['patch_res']:.3e} after "
            f"{rec['patch_sweeps']} sweeps, polish best step {rec['polish_best']}, sampled bres "
            f"{[round(b, 5) for b in rec['bres']]}")
    log(f"[H.2] interior q95 fused {q_fused:.4f} -> polished ({cycles} cycles) "
        f"{q_polished:.4f} -> gated {q_gated:.4f} -> polished TT {tt_q95(v):.4f} -> deployed "
        f"composite {q_comp:.4f} (full q95 {q_comp_full:.4f}); walls: cycles {wall_cycles:.2f} "
        f"s, gates {wall_gates:.2f} s, two-level {wall_tl:.2f} s; final ranks "
        f"{v.ranks.tolist()}")
    if not q_comp < q_fused:
        raise AssertionError(f"the recipe did not improve on its base: {q_comp:.4f} vs "
                             f"{q_fused:.4f}")
    if cycles >= 6 and not q_comp <= FLAGSHIP_Q95_BAR:
        raise AssertionError(f"deployed composite at full depth: q95 {q_comp:.4f} > "
                             f"{FLAGSHIP_Q95_BAR}")
    return vfn, q_comp


def phase_h3_deploy(vfn_prod, n_greedy=256, n_mpc=256, n_steps=400, dt=0.01):
    """H.3: greedy and receding-horizon iLQR closed loops on the deployed
    composite and on the dense value, under common random numbers (the same
    x0 and noise for every recipe seed, as quad_dense_oracle.py draws them:
    its deployment keys do not depend on the seed); then the dual-mode row
    on the dense value. Returns the greedy cost_rel, the iLQR signed_rel and
    survivals, and the dual-mode row's."""
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.sim import make_implicit_policy, make_terminal_lqr, rollout
    from c3sc_tpu_torch.sim.mpc_shoot import receding_horizon_rollout

    prob, grid, uc_np, vd = _flagship_setup()
    uc = torch.as_tensor(uc_np, dtype=torch.float32, device=DEVICE)
    vfn_dense = lambda p: multilinear_interp(grid, vd, p)  # noqa: E731
    rng = np.random.default_rng(4242)                     # quad_dense_oracle.py:247-251
    x0 = torch.as_tensor(0.4 * rng.uniform(-1, 1, (n_greedy, 6))
                         * np.asarray([2.0, 2.0, 1.0, 3.0, 3.0, 4.0]),
                         dtype=torch.float32, device=DEVICE)
    noise = torch.randn((n_steps, n_greedy, prob.dw),
                        generator=torch.Generator(device=DEVICE).manual_seed(1000),
                        device=DEVICE)
    fields = (("composite", vfn_prod), ("dense", vfn_dense))
    greedy = {}
    for label, vfn in fields:
        pol = make_implicit_policy(prob, grid, vfn, uc)
        with torch.no_grad():
            traj, wall = _synced_s(lambda: rollout(prob, grid, pol, x0, dt, n_steps, noise=noise))
        if not torch.isfinite(traj.cost).all():
            raise AssertionError(f"greedy closed loop on the {label} value: costs not finite")
        greedy[label] = (traj.cost.mean().item(), traj.alive[-1].float().mean().item(), wall)
    (c_p, s_p, w_p), (c_o, s_o, _) = greedy["composite"], greedy["dense"]
    log(f"[H.3] greedy closed loop {n_greedy} x {n_steps} steps dt {dt}: mean cost composite "
        f"{c_p:.4f} dense {c_o:.4f} (rel {(c_p - c_o) / abs(c_o):+.4f}), survival composite "
        f"{100 * s_p:.2f}% dense {100 * s_o:.2f}%, wall {w_p:.2f} s")
    mpc = {}
    for label, vfn in fields:
        times = []
        traj, wall = _synced_s(lambda: receding_horizon_rollout(
            prob, grid, vfn, x0[:n_mpc], dt=dt, n_steps=n_steps, horizon=128, replan_every=4,
            opt_iters=8, controls=uc, noise=noise[:, :n_mpc], replan_times=times))
        if not (torch.isfinite(traj.cost).all() and torch.isfinite(traj.xs).all()):
            raise AssertionError(f"iLQR closed loop on the {label} value: not finite")
        mpc[label] = (traj.cost.mean().item(), traj.alive[-1].float().mean().item(), wall,
                      times)
    (c_p, s_p, w_p, t_p), (c_o, s_o, w_o, t_o) = mpc["composite"], mpc["dense"]
    log(f"[H.3] receding-horizon iLQR (horizon 128, replan every 4, 8 iterations, pure MPC) "
        f"{n_mpc} x {n_steps} steps: mean cost composite {c_p:.4f} dense {c_o:.4f}, signed_rel "
        f"{(c_p - c_o) / abs(c_o):+.4f}, survival composite {100 * s_p:.2f}% dense "
        f"{100 * s_o:.2f}%; {len(t_p)} replans, median replan {1e3 * np.median(t_p[1:]):.2f} ms "
        f"(composite) {1e3 * np.median(t_o[1:]):.2f} ms (dense), first (the graph's capture "
        f"on CUDA) {t_p[0]:.2f} s; wall {w_p:.2f} s and {w_o:.2f} s")
    # the dual-mode row: the same closed loop on the dense value, each sample
    # handed to the goal's LQR from its first step inside the basin
    tl = make_terminal_lqr(prob, dt=dt, radius=0.4, device=DEVICE)   # northstar_deploy_dualmode.py:74
    t_d = []
    traj, w_d = _synced_s(lambda: receding_horizon_rollout(
        prob, grid, vfn_dense, x0[:n_mpc], dt=dt, n_steps=n_steps, horizon=128, replan_every=4,
        opt_iters=8, controls=uc, noise=noise[:, :n_mpc], replan_times=t_d, terminal_lqr=tl))
    if not (torch.isfinite(traj.cost).all() and torch.isfinite(traj.xs).all()):
        raise AssertionError("dual-mode iLQR closed loop on the dense value: not finite")
    c_d, s_d = traj.cost.mean().item(), traj.alive[-1].float().mean().item()
    med_d, med_o = np.median(t_d[1:]), np.median(t_o[1:])
    log(f"[H.3] dual-mode iLQR (the same, terminal LQR latch at radius 0.4) on the dense value "
        f"{n_mpc} x {n_steps} steps: mean cost {c_d:.4f}, signed_rel against the pure-MPC dense "
        f"row {(c_d - c_o) / abs(c_o):+.4f}, survival {100 * s_d:.2f}%; median replan "
        f"{1e3 * med_d:.2f} ms against the pure row's {1e3 * med_o:.2f} ms "
        f"({100 * (med_d / med_o - 1):+.1f} %), first {t_d[0]:.2f} s; wall {w_d:.2f} s")
    if not abs(med_d / med_o - 1) <= 0.05:
        raise AssertionError(f"dual-mode median replan {1e3 * med_d:.2f} ms is not within 5 % of "
                             f"the pure row's {1e3 * med_o:.2f} ms")
    (gc_p, _, _), (gc_o, _, _) = greedy["composite"], greedy["dense"]
    return dict(cost_rel=abs(gc_p - gc_o) / abs(gc_o), signed_rel=(c_p - c_o) / abs(c_o),
                survival=s_p, survival_dense=s_o, dual_signed_rel=(c_d - c_o) / abs(c_o),
                dual_survival=s_d)


def compare_patch_kernel(ops, v0, stored, tol=1e-5, max_sweeps=2000, chunk=50):
    """K1 against its plain version on the patch's sub-box (outside the
    counted runs): one sweep on the stored patch (compare_sweep), then the
    whole patch solve with the plain sweep on the card against the same
    solve through the kernel. Returns the largest improve difference."""
    from c3sc_tpu_torch.ops import dense_backup as db

    n = ops.grid.shape[0]
    err, _ = compare_sweep(ops, stored, None, False,
                           f"quadcopter 9^6 patch sub-box {n}^6, 25 candidates, stored patch")
    solved = {}
    for name, sweep in (("kernel", db.dense_backup), ("plain", db.dense_backup_reference)):
        v, done, res = v0.reshape(ops.grid.shape).contiguous(), 0, float("inf")
        while done < max_sweeps:
            for i in range(chunk):
                vnew, _ = sweep(ops, v)
                if i == chunk - 1:
                    res = torch.max(torch.abs(vnew - v)).item()
                v = vnew
            done += chunk
            if res < tol:
                break
        solved[name] = (v, done)
    diff = (solved["kernel"][0] - solved["plain"][0]).abs().max().item()
    times = {"kernel": graph_ms(lambda: db.dense_backup(ops, stored)),
             "plain": loop_ms(lambda: db.dense_backup_reference(ops, stored), 20)}
    log(f"[H] patch solve on the card, kernel vs plain sweep: {solved['kernel'][1]} and "
        f"{solved['plain'][1]} sweeps, max|diff| {diff:.3e} (bar {VALUE_BAR} x max|v|); per "
        f"sweep at {n}^6 (kernel: a CUDA graph of 100 launches; plain: a loop of 20): kernel "
        f"{times['kernel']:.4f} ms, plain {times['plain']:.4f} ms")
    if solved["kernel"][1] != solved["plain"][1] or \
            diff > VALUE_BAR * solved["plain"][0].abs().max().item():
        raise AssertionError("the patch solve through K1 differs from its plain version")
    return err


def phase_h_flagship(v9, fused=None, cycles=2, n_mpc=64, seed=0):
    """Phase H; returns what compare_patch_kernel needs (None for a seed
    other than 0: H.1's committed fields are seed 0's). Without ``fused``
    (``--phases H``) it solves both fused bases, reports both, and runs the
    recipe from the recipe's base; with it (the whole script: F.2's solve,
    the graphed variant) it runs the recipe from that. At the recipe's full
    depth it holds the deployed composite to NORTHSTAR_seed{seed}.json's
    tolerance (value_q95_max, survival_min; its cost_rel is reported, not
    held: the JAX package misses it on seed 1) and prints the record's
    numbers beside the port's."""
    h1 = phase_h1_committed() if seed == 0 else None
    label = "graphed variant (F.2's solve: no probe, <= 900 iterations)"
    record = json.load(open(os.path.join(REPO, f"NORTHSTAR_seed{seed}.json")))
    jq = record["value_parity_rel_to_range"]
    if fused is None:
        prob, grid, uc, vd = _flagship_setup()
        bases = fused_bases(prob, grid, uc, seed=seed)
        for name, sol in bases.items():
            with torch.no_grad():
                q = interior_q95(prob, grid, sol.v, vd)[0]
            log(f"[H.2] fused base (seed {seed}), {name}: {sol.iterations} iterations in "
                f"{sol.wall_time:.2f} s, probe_cost {sol.probe_cost:.4f}, interior q95 {q:.4f} "
                f"(JAX seed {seed}: {jq['fused']['interior']['q95']:.4f})")
        label, fused = next(iter(bases.items()))
    vfn, q_comp = phase_h2_recipe(fused, cycles, seed=seed, label=label)
    dep = phase_h3_deploy(vfn, n_mpc=n_mpc)
    tol = record["tolerance"]
    jm = record["deployment_mpc"]
    log(f"[H] seed {seed} end gate: composite interior q95 {q_comp:.4f} (JAX "
        f"{jq['deployed_composite']['interior']['q95']:.4f}; bar {tol['value_q95_max']}), iLQR "
        f"signed_rel {dep['signed_rel']:+.4f} (JAX {jm['signed_rel']:+.4f}), survival "
        f"{dep['survival']:.4f} (JAX {jm['survival']:.4f}; bar {tol['survival_min']}), greedy "
        f"cost_rel {dep['cost_rel']:.4f} (JAX {record['cost_rel_deviation']:.4f}; "
        f"{tol['cost_rel']} reported, not held)")
    if cycles >= 6 and not (q_comp <= tol["value_q95_max"]
                            and dep["survival"] >= tol["survival_min"]):
        raise AssertionError(f"seed {seed} end gate: q95 {q_comp:.4f}, survival "
                             f"{dep['survival']:.4f}")
    return h1


# ---- phase I: the remaining models ----------------------------------------------------

def _bare(prob):
    """The problem with every structure declaration stripped: its sweeps take
    the general entries with per-candidate variances and costs."""
    import dataclasses

    return dataclasses.replace(prob, drift_f0=None, drift_G=None, sigma2_x=None, cost_q=None,
                               cost_r=None, name=prob.name + " without declarations")


def phase_i1_kernels():
    """I.1: K1's entries at the widths the three models' users run, against the
    plain version (outside the counted run): the structured entry at (3, 1)
    (Dubins 41^3, 9 candidates) and (7, 2) (quadcopter7 9^7, 25 candidates),
    the general entries on the glider (41^4, 9 candidates) and on the
    pendulum without declarations (1001^2, 9 candidates: per-candidate
    variances and cost). Returns (max differences, the glider's times,
    the glider's bounds)."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops import dense_backup as db

    errs = dict.fromkeys(KERNELS, 0.0)
    glider = {}
    cases = (("dubins", make_problem("dubins"), 41, 9),
             ("quadcopter7", make_problem("quadcopter7", **QUAD), 9, 5),
             ("glider", make_problem("glider"), 41, 9),
             ("pendulum", _bare(make_problem("pendulum")), 1001, 9))
    for name, prob, n, per_dim in cases:
        grid = prob.default_grid(n)
        uc = prob.control_candidates(per_dim)
        ops, t_ops = _synced_s(lambda: db.make_dense_operands(prob, grid, uc, DEVICE))
        kind = "general" if ops.general else "structured"
        label = f"{prob.name} {n}^{prob.dx}, {len(uc)} candidates, {kind} entries"
        log(f"[I.1] {label}: operands ({ops.x.shape[0]} nodes) built in {t_ops:.3f} s")
        v = torch.as_tensor(np.random.default_rng(0).uniform(0, 5, grid.shape),
                            dtype=torch.float32, device=DEVICE)
        names = KERNELS[2:] if ops.general else KERNELS[:2]
        for sem, (clip, pin) in (("Pallas", (prob.value_bounds, True)),
                                 ("dense_vi", (None, False))):
            e = compare_sweep(ops, v, clip, pin, f"{label}, {sem} semantics", tag="I.1")
            errs[names[0]], errs[names[1]] = max(errs[names[0]], e[0]), max(errs[names[1]], e[1])
        # dense_vi's calls: the improve keeps its policy, the evaluate reads it
        _, pol = db.dense_backup(ops, v, with_policy=True)
        calls = dict(backup_kernel=lambda: db.dense_backup(ops, v, with_policy=True),
                     backup_plain=lambda: db.dense_backup_reference(ops, v, with_policy=True),
                     evaluate_kernel=lambda: db.dense_evaluate(ops, v, pol),
                     evaluate_plain=lambda: db.dense_evaluate_reference(ops, v, pol))
        if ops.general:   # the improve without the policy's epilogue, for the record
            calls["backup_kernel_without_policy"] = lambda: db.dense_backup(ops, v)
        times, eager = _kernel_and_plain_ms(calls, 10)
        bounds = (general_sweep_bounds if ops.general else sweep_bounds)(ops)
        log(f"[I.1] {label}: per-sweep ms (kernels: a CUDA graph of 100 launches; plain: a loop "
            "of 10 between one event pair): " + ", ".join(f"{k} {x:.4f}" for k, x in times.items())
            + "; kernels as an eager loop of 100: "
            + ", ".join(f"{k} {x:.4f}" for k, x in eager.items()) + "; bounds "
            + json.dumps(bounds))
        for entry, key in zip(names, ("backup_kernel", "evaluate_kernel")):
            b = bounds[entry]["bound_ms"]
            log(f"[I.1] {label}: {entry} {times[key]:.4f} ms against its bound {b:.4f} ms "
                f"({bounds[entry]['bound_by']}): {100 * b / times[key]:.1f} % of the bound")
        if name == "glider":
            glider = dict(times=times, bounds=bounds)
        del ops, v, pol, calls
        torch.cuda.empty_cache()
    return errs, glider["times"], glider["bounds"]


def closed_loop_parity(prob, grid, vfn_ref, vfn, controls, x0, dt, n_steps, noise_seed):
    """Greedy closed loops on two value functions under one noise tensor (the
    JAX tests' shared key): (control deviation / control range over steps
    where both live, per-step candidate agreement, mean cost on the
    reference, mean cost on vfn)."""
    from c3sc_tpu_torch.sim import make_implicit_policy, rollout

    uc = torch.as_tensor(controls, dtype=torch.float32, device=DEVICE)
    noise = torch.randn((n_steps, x0.shape[0], prob.dw), device=DEVICE,
                        generator=torch.Generator(device=DEVICE).manual_seed(noise_seed))
    trs = []
    for fn in (vfn_ref, vfn):
        with torch.no_grad():
            trs.append(rollout(prob, grid, make_implicit_policy(prob, grid, fn, uc), x0, dt,
                               n_steps, noise=noise))
    ref, tr = trs
    alive = (ref.alive[:-1] & tr.alive[:-1])[..., None]
    du = (tr.us - ref.us).abs()
    dev = ((du * alive).sum() / alive.sum().clamp(min=1)).item() / (prob.uub[0] - prob.ulb[0])
    agree = ((du < 1e-6) | ~alive).float().mean().item()
    return dev, agree, ref.cost.mean().item(), tr.cost.mean().item()


def node_errors(grid, v_tt, v_dense):
    """|v_tt - v_dense| / max|v_dense| at every node (the JAX tests' measure)."""
    from c3sc_tpu_torch.ops.tt import tt_gather_eval

    v = tt_gather_eval(v_tt, grid.node_indices(DEVICE))
    if not torch.isfinite(v).all():
        raise AssertionError("a TT value is not finite")
    return (v - v_dense.reshape(-1)).abs() / v_dense.abs().max()


def _dense_at_width(prob, n, per_dim, tol, max_outer, label):
    """dense_vi at a user's width (graphed, the default on the card): wall,
    sweeps, residual, peak device memory."""
    from c3sc_tpu_torch.solvers import dense_vi

    grid = prob.default_grid(n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sol, wall = _synced_s(lambda: dense_vi(prob, grid, n_controls=per_dim, tol=tol,
                                           max_outer=max_outer, chunk=50, device=DEVICE))
    peak = torch.cuda.max_memory_allocated() / 2**20
    if not torch.isfinite(sol.v).all():
        raise AssertionError(f"{label}: the dense value is not finite")
    log(f"[{label}] dense_vi {prob.name} {grid.shape} ({sol.v.numel()} nodes), "
        f"{per_dim ** prob.du} candidates, tol {tol}, graphed: {sol.sweeps} outer sweeps in "
        f"{wall:.2f} s, residual {sol.residual:.3e}, stopped at the f32 plateau {sol.floored}, "
        f"peak device memory {peak:.1f} MiB")
    return sol


def phase_i2_dubins():
    """I.2: tests/test_dubins.py's configuration on the card (beta 0.5, grid
    (25, 25, 16), 7 candidates), then dense_vi at the CLI's width."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.ops.tt import tt_lerp_eval
    from c3sc_tpu_torch.solvers import dense_vi, fused_tt_vi

    prob = make_problem("dubins", beta=0.5)
    grid = prob.default_grid((25, 25, 16))
    uc = prob.control_candidates(7)
    dense, wall = _synced_s(lambda: dense_vi(prob, grid, controls=uc, tol=1e-4, max_outer=200,
                                             chunk=50, device=DEVICE))
    sol = fused_tt_vi(prob, grid, controls=uc, rmax=20, seed=0, tol=3e-4, max_iters=1500,
                      patience=100, device=DEVICE, cuda_graph=True)
    err = node_errors(grid, sol.v, dense.v)
    q95, mean = torch.quantile(err, 0.95).item(), err.mean().item()
    log(f"[I.2] dubins (25, 25, 16), 7 candidates: dense_vi {dense.sweeps} sweeps in {wall:.2f} s "
        f"(residual {dense.residual:.2e}); fused rmax 20: {sol.iterations} iterations in "
        f"{sol.wall_time:.2f} s (CUDA graph), ranks {sol.v.ranks.tolist()}; |v_tt - v_dense| / "
        f"max|v_dense| q95 {q95:.4f} (bar 0.05), mean {mean:.4f} (bar 0.02)")
    if not (q95 < 0.05 and mean < 0.02):
        raise AssertionError(f"dubins fused vs dense: q95 {q95:.4f}, mean {mean:.4f}")
    # the closed loops of test_dubins_control_sequence_parity, on its own solve
    sol = fused_tt_vi(prob, grid, controls=uc, rmax=28, eps_rank=1e-5, seed=0, tol=2e-4,
                      max_iters=2500, patience=100, device=DEVICE, cuda_graph=True)
    rng = np.random.default_rng(11)
    ang, r = rng.uniform(0, 2 * np.pi, 32), rng.uniform(2.2, 3.2, 32)
    x0 = torch.as_tensor(np.stack([r * np.cos(ang), r * np.sin(ang),
                                   np.arctan2(-np.sin(ang), -np.cos(ang))
                                   + rng.uniform(-0.4, 0.4, 32)], -1), dtype=torch.float32,
                         device=DEVICE)
    dev, agree, c_d, c_t = closed_loop_parity(
        prob, grid, lambda p: multilinear_interp(grid, dense.v, p),
        lambda p: tt_lerp_eval(sol.v, grid, p), uc, x0, 0.02, 300, 21)
    rel = abs(c_t - c_d) / max(abs(c_d), 1e-9)
    log(f"[I.2] closed loops 32 x 300 steps dt 0.02 (fused rmax 28, {sol.iterations} "
        f"iterations): control deviation {dev:.4f} of the range (bar 0.05), candidate agreement "
        f"{agree:.4f} (bar 0.94), mean cost dense {c_d:.4f} TT {c_t:.4f}, rel {rel:.4f} "
        f"(bar 0.01)")
    if not (dev < 0.05 and agree > 0.94 and rel < 0.01):
        raise AssertionError(f"dubins closed loops: dev {dev:.4f} agree {agree:.4f} rel {rel:.4f}")
    _dense_at_width(make_problem("dubins"), 41, 9, 1e-4, 2000, "I.2")


def phase_i3_glider():
    """I.3: tests/test_glider_parity.py's configuration on the card ((15, 11,
    11, 11), 9 candidates; the dense oracle through the general entries),
    then dense_vi at the CLI's width, 41^4 with 9 candidates."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.ops.tt import tt_lerp_eval
    from c3sc_tpu_torch.solvers import dense_vi, fused_tt_vi

    prob = make_problem("glider")
    grid = prob.default_grid((15, 11, 11, 11))
    uc = prob.control_candidates(9)
    dense, wall = _synced_s(lambda: dense_vi(prob, grid, controls=uc, tol=1e-5,
                                             max_outer=2000, chunk=100, device=DEVICE))
    sol = fused_tt_vi(prob, grid, controls=uc, rmax=16, seed=0, tol=2e-4, max_iters=1200,
                      eps_rank=1e-5, patience=40, device=DEVICE, cuda_graph=True)
    q95 = torch.quantile(node_errors(grid, sol.v, dense.v), 0.95).item()
    rng = np.random.default_rng(5)
    x0 = torch.as_tensor(np.stack([rng.uniform(-3.2, -2.0, 32), rng.uniform(-0.5, 0.5, 32),
                                   rng.uniform(2.0, 5.0, 32), rng.uniform(-0.5, 0.3, 32)], -1),
                         dtype=torch.float32, device=DEVICE)
    dev, _, c_d, c_t = closed_loop_parity(
        prob, grid, lambda p: multilinear_interp(grid, dense.v, p),
        lambda p: tt_lerp_eval(sol.v, grid, p), uc, x0, 0.01, 300, 7)
    rel = abs(c_t - c_d) / max(abs(c_d), 1e-9)
    log(f"[I.3] glider (15, 11, 11, 11), 9 candidates: dense_vi (general entries) "
        f"{dense.sweeps} sweeps in {wall:.2f} s, residual {dense.residual:.2e} (bar 1e-4); fused "
        f"rmax 16: {sol.iterations} iterations in {sol.wall_time:.2f} s (CUDA graph), ranks "
        f"{sol.v.ranks.tolist()}; q95 {q95:.4f} (bar 0.05); closed loops 32 x 300 steps dt "
        f"0.01: control deviation {dev:.4f} of the range (bar 0.01), mean cost dense {c_d:.4f} "
        f"TT {c_t:.4f}, rel {rel:.4f} (bar 0.02)")
    if not (dense.residual < 1e-4 and q95 < 0.05 and dev < 0.01 and rel < 0.02):
        raise AssertionError(f"glider: residual {dense.residual:.2e} q95 {q95:.4f} dev {dev:.4f} "
                             f"rel {rel:.4f}")
    _dense_at_width(prob, 41, 9, 1e-5, 2000, "I.3")


def phase_i4_quad7(full):
    """I.4: the 7D flagship of experiments/quad7_northstar.py at 9^7 with 25
    candidates, with the full 9^7 dense oracle (its --try-full-oracle).
    ``full`` (--phases I): the recipe's base (eager, probe harvest, 1,500
    iterations) beside the graphed variant, 3 cycles, 128 closed loops. The
    whole script cuts it to the graphed base (600 iterations), 1 cycle and
    32 closed loops."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.ops.tt import _repad, tt_lerp_eval
    from c3sc_tpu_torch.sim import make_implicit_policy, rollout
    from c3sc_tpu_torch.solvers import bellman_residual_sample, dense_vi
    from c3sc_tpu_torch.solvers.gating import gated_apply
    from c3sc_tpu_torch.solvers.local_patch import make_patched_value_fn, solve_local_patch
    from c3sc_tpu_torch.solvers.polish import level_correct, tt_polish
    from c3sc_tpu_torch.solvers.ttvi import make_bellman_kernel
    from c3sc_tpu_torch.solvers.twogrid import coarse_correct

    cycles, n_roll = (3, 128) if full else (1, 32)
    prob = make_problem("quadcopter7", **QUAD)
    grid = prob.default_grid(9)
    uc = prob.control_candidates(5)
    with open(NORTHSTAR7) as f:
        ref = json.load(f)

    # the full dense oracle, first, so that every stage is scored against it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    oracle, wall = _synced_s(lambda: dense_vi(prob, grid, controls=uc, tol=1e-5, max_outer=3000,
                                              chunk=25, eval_sweeps=10, device=DEVICE))
    vd = oracle.v
    log(f"[I.4] full 9^7 dense oracle (dense_vi, K1 at (7, 2), {vd.numel()} nodes x 25 "
        f"candidates): {oracle.sweeps} outer sweeps in {wall:.2f} s, residual "
        f"{oracle.residual:.3e}, stopped at the f32 plateau {oracle.floored}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; the JAX package never solved it "
        f"(NORTHSTAR7.json oracle_full: {ref['oracle_full']})")
    if not (torch.isfinite(vd).all() and (oracle.residual < 1e-5 or oracle.floored)):
        raise AssertionError(f"9^7 oracle: residual {oracle.residual:.3e}")

    def tt_q95(v):
        with torch.no_grad():
            return interior_q95(prob, grid, v, vd)[0]

    bases = fused_bases(prob, grid, uc, recipe=full, graphed_iters=1500 if full else 600)
    q_bases = {}
    for name, sol in bases.items():
        q_bases[name] = tt_q95(sol.v)
        log(f"[I.4] fused base, {name}: {sol.iterations} iterations in {sol.wall_time:.2f} s, "
            f"ranks {sol.v.ranks.tolist()}, probe_cost {sol.probe_cost:.4f}; interior q95 "
            f"against the oracle {q_bases[name]:.4f}")
    label, fsol = next(iter(bases.items()))

    kernel = make_bellman_kernel(prob, grid, uc, chunk=32768)
    v, state = _repad(fsol.v, 64), None
    t_cycles = time.perf_counter()
    for cyc in range(cycles):
        t0 = time.perf_counter()
        psol = tt_polish(prob, grid, uc, v, rmax=64, schedule=((10, 64),), check_every=4,
                         kernel=kernel, state=state,
                         generator=torch.Generator().manual_seed(100 + cyc))
        v, state = psol.v, psol.state
        t1 = time.perf_counter()
        v, cinfo = coarse_correct(prob, grid, uc, v, kernel=kernel, rmax_corr=32)
        torch.cuda.synchronize()
        log(f"[I.4] cycle {cyc}: polish 10 steps {t1 - t0:.2f} s, coarse correction on 7^7 "
            f"{time.perf_counter() - t1:.2f} s (bres {cinfo.bres_before:.4f} -> "
            f"{cinfo.bres_after:.4f}, accepted {cinfo.accepted}); interior q95 {tt_q95(v):.4f}")
    wall_cycles = time.perf_counter() - t_cycles
    v, gate = gated_apply(prob, grid, uc, v,
                          lambda vt: level_correct(prob, grid, uc, vt, kernel=kernel)[0],
                          name="level", kernel=kernel)
    q_polished = tt_q95(v)
    vfn_tt = lambda p: tt_lerp_eval(v, grid, p)  # noqa: E731
    patch, wall_patch = _synced_s(lambda: solve_local_patch(prob, grid, vfn_tt, uc, margin=1,
                                                            tol=1e-5, device=DEVICE))
    vfn_prod = make_patched_value_fn(grid, vfn_tt, patch)
    q_comp = field_q95(prob, composite_at_nodes(grid, vfn_prod), vd)[0]
    bres, _ = bellman_residual_sample(prob, grid, uc, v, n_samples=8192)
    bres = bres.item()

    # greedy closed loops, x0 as quad7_northstar.py draws it, one noise tensor
    rng = np.random.default_rng(4242)
    x0 = torch.as_tensor(0.4 * rng.uniform(-1, 1, (n_roll, 7))
                         * np.asarray([2.0, 2.0, 1.0, 3.0, 3.0, 4.0, 1.5]),
                         dtype=torch.float32, device=DEVICE)
    noise = torch.randn((400, n_roll, prob.dw), device=DEVICE,
                        generator=torch.Generator(device=DEVICE).manual_seed(1000))
    loops = {}
    for name, fn in (("composite", vfn_prod), ("dense oracle",
                                                lambda p: multilinear_interp(grid, vd, p))):
        pol = make_implicit_policy(prob, grid, fn, torch.as_tensor(uc, dtype=torch.float32,
                                                                   device=DEVICE))
        with torch.no_grad():
            tr, w = _synced_s(lambda: rollout(prob, grid, pol, x0, 0.01, 400, noise=noise))
        if not torch.isfinite(tr.cost).all():
            raise AssertionError(f"7D closed loops on the {name}: costs not finite")
        loops[name] = (tr.cost.mean().item(), tr.alive[-1].float().mean().item(), w)

    # the independent sub-box oracle: the same operator on the centred 7^7
    # sub-box, TT faces, tol 1e-6, scored 2 node layers in
    po, wall_po = _synced_s(lambda: solve_local_patch(prob, grid, vfn_tt, uc, margin=1, tol=1e-6,
                                                      max_sweeps=4000, device=DEVICE))
    inner = tuple(slice(2, n - 2) for n in po.subgrid.shape)
    v_sub = composite_at_nodes(po.subgrid, vfn_tt)
    rel_in = ((v_sub[inner] - po.v[inner]).abs() / (po.v.max() - po.v.min())).reshape(-1)
    q_in = torch.quantile(rel_in, 0.95).item()
    (c_p, s_p, w_p), (c_o, s_o, _) = loops["composite"], loops["dense oracle"]
    jp = ref["production"]
    log(f"[I.4] recipe from the {label} base: {cycles} cycles in {wall_cycles:.2f} s, level gate "
        f"{'accepted' if gate.accepted else 'rejected'} (bres {gate.bres_before:.4f} -> "
        f"{gate.bres_after:.4f}), patch {po.subgrid.shape} margin 1: {patch.sweeps} sweeps in "
        f"{wall_patch:.2f} s, residual {patch.residual:.2e}")
    log(f"[I.4] interior q95 against the full 9^7 oracle: fused base "
        + ", ".join(f"({k}) {q:.4f}" for k, q in q_bases.items())
        + f" -> polished TT {q_polished:.4f} -> deployed composite {q_comp:.4f} (no JAX number)")
    log(f"[I.4] bars of NORTHSTAR7.json: sub-box oracle ({po.sweeps} sweeps in {wall_po:.2f} s, "
        f"residual {po.residual:.1e}) inner q95 {q_in:.4f} (bar "
        f"{ref['tolerance']['oracle_inner_q95_max']}; JAX {ref['oracle']['inner_value_q95']:.4f}), "
        f"sampled Bellman residual {bres:.4f} (bar {ref['tolerance']['bellman_residual_max']}; "
        f"JAX {jp['bellman_residual_sampled']:.4f}), greedy {n_roll} x 400 steps dt 0.01 "
        f"survival {s_p:.4f} (bar {ref['tolerance']['survival_min']}; JAX {jp['survival']}), mean "
        f"cost composite {c_p:.4f} (JAX {jp['mean_cost']:.4f}) dense oracle {c_o:.4f} (survival "
        f"{s_o:.4f}, rel {(c_p - c_o) / abs(c_o):+.4f}), wall {w_p:.2f} s. JAX's times are a "
        "TPU's and are not compared")
    if not (s_p >= ref["tolerance"]["survival_min"]
            and bres <= ref["tolerance"]["bellman_residual_max"]
            and q_in <= ref["tolerance"]["oracle_inner_q95_max"]):
        raise AssertionError(f"7D flagship: survival {s_p:.4f}, bres {bres:.4f}, inner q95 "
                             f"{q_in:.4f}")


def phase_i_models(full=False):
    """Phase I after I.1: the path that the launch counts read."""
    marks = [time.perf_counter()]
    for fn in (phase_i2_dubins, phase_i3_glider, lambda: phase_i4_quad7(full)):
        fn()
        marks.append(time.perf_counter())
    log("[timing] phase I: " + ", ".join(f"I.{i + 2} {b - a:.1f} s"
                                         for i, (a, b) in enumerate(zip(marks, marks[1:]))))


# ---- phase J: the remaining solvers -----------------------------------------------------

def _node_values(grid, v_tt):
    """A TT's values at every node, [N] (chunked gathers)."""
    from c3sc_tpu_torch.ops.tt import tt_gather_eval

    idx = grid.node_indices(DEVICE)
    with torch.no_grad():
        return torch.cat([tt_gather_eval(v_tt, idx[i:i + 131072])
                          for i in range(0, idx.shape[0], 131072)])


def _rel_err(values, v_dense, by="range"):
    """|values - v_dense| / (range of v_dense, or its max |.|) at the nodes, as
    float64 numpy."""
    vd = v_dense.reshape(-1).double()
    scale = (vd.max() - vd.min()) if by == "range" else vd.abs().max()
    if not torch.isfinite(values).all():
        raise AssertionError("a value field is not finite")
    return ((values.double() - vd).abs() / scale).cpu().numpy()


def _profiled_syncs(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CPU and e.name in SYNC_NAMES)


def count_syncs(fn):
    """fn() under torch.profiler; returns (its result, the host syncs in it):
    the syncs recorded less those of an empty call profiled the same way
    (the closing synchronize, and the one the profiler makes when it stops)."""
    _, base = _profiled_syncs(lambda: None)
    out, n = _profiled_syncs(fn)
    return out, n - base


def _pendulum(n, **kw):
    from c3sc_tpu_torch.models import make_pendulum_problem

    prob = make_pendulum_problem(**kw)
    return prob, prob.default_grid(n)


def phase_j1_refined(full):
    """J.1 fused_tt_vi_refined: (a) tests/test_fused.py's refined bar on the
    card (pendulum 21^2, rank 8, 5 candidates, 2 rounds, graphed): refined
    q95 < 0.04 and < plain / 3, the sampled residual strictly falling over
    accepted rounds; (b) the 9^6 quadcopter (25 candidates, rmax 16, tol
    2e-4, patience 25, graphed; --phases J: 2 rounds and <= 900 iterations a
    solve, the whole script: 1 round and <= 300): interior q95 against
    quad_dense_v9.npz of the base and of every accepted total, the refine
    history and each solve's wall; bar: an accepted round (the total's
    sampled residual below the base's) and q95 <= F.2's 0.25; (c) an eager
    iteration with a base reads nothing on the host (F.4's check). Returns
    the rank-16 base (J.4 starts from it)."""
    from c3sc_tpu_torch.ops.tt import tt_full
    from c3sc_tpu_torch.solvers import dense_vi, fused_tt_vi, make_fused_vi
    from c3sc_tpu_torch.solvers import fused as fz

    prob, grid = _pendulum(21)
    uc = prob.control_candidates(5)
    vd = dense_vi(prob, grid, controls=uc, tol=1e-6, max_outer=3000, device=DEVICE).v
    kw = dict(controls=uc, rmax=8, tol=1e-4, max_iters=800, patience=20, device=DEVICE,
              cuda_graph=True)
    plain = fused_tt_vi(prob, grid, seed=0, **kw)
    ref = fz.fused_tt_vi_refined(prob, grid, rounds=2, seed=0, **kw)
    q_plain = float(np.quantile(_rel_err(tt_full(plain.v).reshape(-1), vd), 0.95))
    q_ref = float(np.quantile(_rel_err(tt_full(ref.v).reshape(-1), vd), 0.95))
    accepted = [h for h in ref.refine_history[1:] if h["accepted"]]
    bres = [ref.refine_history[0]["bellman_res"]] + [h["bellman_res"] for h in accepted]
    log(f"[J.1] pendulum 21^2 rank 8, 5 candidates, graphed: plain q95 {q_plain:.4f} "
        f"({plain.iterations} iterations, {plain.wall_time:.2f} s); refined 2 rounds q95 "
        f"{q_ref:.4f} ({ref.iterations} iterations, {ref.wall_time:.2f} s), accepted "
        f"{[h['accepted'] for h in ref.refine_history[1:]]}, sampled bres {bres} (bars: q95 < "
        f"0.04 and < plain/3 = {q_plain / 3:.4f}; bres strictly falling)")
    if not (accepted and all(b < a for a, b in zip(bres, bres[1:]))
            and q_ref < 0.04 and q_ref < q_plain / 3):
        raise AssertionError(f"refined pendulum bar: q95 {q_ref:.4f} vs plain {q_plain:.4f}, "
                             f"bres {bres}")

    prob, grid, uc, vd = _flagship_setup()
    rounds, iters = (2, 900) if full else (1, 300)
    solves = []
    inner = fz.fused_tt_vi

    def recording(*args, **kwargs):
        sol = inner(*args, **kwargs)
        solves.append((kwargs.get("base"), sol))
        return sol

    fz.fused_tt_vi = recording       # records each sub-solve for the per-round q95
    try:
        ref = fz.fused_tt_vi_refined(prob, grid, controls=uc, rounds=rounds, rmax=16, seed=0,
                                     tol=2e-4, patience=25, max_iters=iters, device=DEVICE,
                                     cuda_graph=True)
    finally:
        fz.fused_tt_vi = inner
    for (base, sol), h in zip(solves, ref.refine_history):
        vals = _node_values(grid, sol.v)
        if base is not None:
            vals = vals + _node_values(grid, base)
        q = field_q95(prob, vals.reshape(grid.shape), vd)[0]
        what = "base" if base is None else f"correction on a base padded to {base.rmax}"
        log(f"[J.1] quadcopter 9^6 round {h['round']} ({what}): {sol.iterations} iterations, {h['wall_s']:.2f} s "
            f"({1e3 * h['wall_s'] / max(sol.iterations, 1):.2f} ms/iteration), residual "
            f"{h['residual']:.3e}, sampled bres {h['bellman_res']:.5f} (abs "
            f"{h['bellman_res_abs']:.4f}), accepted {h.get('accepted', '-')}, interior q95 of "
            f"the total {q:.4f}")
    q_final = field_q95(prob, _node_values(grid, ref.v).reshape(grid.shape), vd)[0]
    accepted = [h for h in ref.refine_history[1:] if h["accepted"]]
    log(f"[J.1] quadcopter 9^6 refined ({rounds} round(s), <= {iters} iterations a solve, cut "
        f"{'none' if full else 'from 2 rounds and 900'}): total after tt_round ranks "
        f"{ref.v.ranks.tolist()} (padding {ref.v.rmax}), interior q95 {q_final:.4f} (bar "
        f"{FUSED_Q95_BAR}), {len(accepted)} accepted of {len(ref.refine_history) - 1} attempts, "
        f"{ref.iterations} iterations in {ref.wall_time:.2f} s")
    if not (accepted and accepted[-1]["bellman_res_abs"] < ref.refine_history[0]["bellman_res_abs"]
            and q_final <= FUSED_Q95_BAR):
        raise AssertionError(f"refined 9^6: no accepted round or q95 {q_final:.4f}")
    base_v = solves[0][1].v
    solver = make_fused_vi(prob, grid, uc, rmax=16, base=base_v, device=DEVICE)
    profile_iterations(solver, solver.init_fn(0), iters=1, tag="J.1",
                       label="quadcopter 9^6 rmax 16, eager, with a rank-16 base")
    return base_v


def _flat(carry):
    return [t for f in carry for t in (f if isinstance(f, tuple) else (f,))]


def phase_j2_oversample(full):
    """J.2 oversample=1.0 at rmax 32 (fit cap 16) on the 9^6 quadcopter, 25
    candidates, tol 2e-4, patience 25, graphed (<= 900 iterations; 300 in the
    whole script): interior q95 against the oracle and ms/iteration; three
    forced iterations graphed bit-equal to eager; an eager iteration reads
    nothing on the host (F.4's check)."""
    from c3sc_tpu_torch.solvers import fused_tt_vi

    prob, grid, uc, vd = _flagship_setup()
    iters = 900 if full else 300
    sol = fused_tt_vi(prob, grid, controls=uc, rmax=32, oversample=1.0, seed=0, tol=2e-4,
                      patience=25, max_iters=iters, device=DEVICE, cuda_graph=True)
    q95, _ = interior_q95(prob, grid, sol.v, vd)
    c = sol.carry
    log(f"[J.2] quadcopter 9^6 rmax 32 oversample 1.0 (fit cap 16), graphed, <= {iters} "
        f"iterations{'' if full else ' (cut from 900)'}: {sol.iterations} iterations in {sol.wall_time:.2f} s "
        f"({1e3 * sol.wall_time / max(sol.iterations, 1):.2f} ms/iteration), residual "
        f"{sol.residual:.3e}; bond sample rows {c.rl.tolist()} over fit ranks {c.rlf.tolist()}; "
        f"interior q95 {q95:.4f} (reported; F.2's square scheme 0.128)")
    if not (c.rl >= c.rlf).all() or int(c.rlf.max()) > 16:
        raise AssertionError("oversampled bonds: sample rows below the fit ranks or fit > 16")
    kw = dict(oversample=1.0, tol=2e-4, patience=25, max_iters=10**9)
    _, _, graphed = _quad_fused(9, 32, DEVICE, cuda_graph=True, **kw)
    _, _, eager = _quad_fused(9, 32, DEVICE, **kw)
    a, b = graphed.step_fn(c, 3), eager.step_fn(c, 3)
    equal = all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b)))
    log(f"[J.2] three forced iterations, CUDA graph against the eager loop: bit-equal {equal}")
    if not equal:
        raise AssertionError("the oversampled iteration differs between graph and eager")
    profile_iterations(eager, c, iters=1, tag="J.2",
                       label="quadcopter 9^6 rmax 32 oversample 1.0, eager")


def phase_j3_multilevel(full):
    """J.3 multilevel_tt_vi: tests/test_multilevel.py on the card (pendulum
    [21, 31], beta 0.5, sigma 0.5, rmax 16, tol 2e-4, graphed; the whole
    script caps the coarse level at 300 iterations, as the CPU test does),
    q95 of |v - dense| / max|dense| < 0.05; then the quadcopter at
    [5, 7, 9]^6, rmax 16, 25 candidates (--phases J: the default caps of
    4,000 coarse and 2,000 fine iterations; the whole script: 300 a level),
    interior q95 against the 9^6 oracle and the iterations of each level
    (reported)."""
    from c3sc_tpu_torch.solvers import dense_vi
    from c3sc_tpu_torch.solvers.multilevel import multilevel_tt_vi

    prob, _ = _pendulum(31, beta=0.5, sigma=0.5)
    uc = prob.control_candidates(9)
    ml = multilevel_tt_vi(prob, [21, 31], rmax=16, seed=0, tol=2e-4, controls=uc, device=DEVICE,
                          cuda_graph=True, **({} if full else dict(max_iters_coarse=300)))
    dense = dense_vi(prob, ml.grid, controls=uc, tol=1e-5, max_outer=400, chunk=100,
                     device=DEVICE)
    q = float(np.quantile(_rel_err(_node_values(ml.grid, ml.final.v), dense.v, by="max"), 0.95))
    log(f"[J.3] pendulum [21, 31] rmax 16{'' if full else ' (coarse level cut to 300 iterations)'}: "
        f"levels (n, iterations, residual, wall s) {ml.levels}; "
        f"q95 |v - dense| / max|dense| {q:.4f} (bar 0.05)")
    if not q < 0.05:
        raise AssertionError(f"multilevel pendulum: q95 {q:.4f}")
    qprob, grid, uc, vd = _flagship_setup()
    caps = {} if full else dict(max_iters_coarse=300, max_iters_fine=300)
    ml = multilevel_tt_vi(qprob, [5, 7, 9], rmax=16, seed=0, tol=2e-4, patience=25, controls=uc,
                          device=DEVICE, cuda_graph=True, **caps)
    q95, _ = interior_q95(qprob, grid, ml.final.v, vd)
    depth = "the default caps" if full else "300 iterations a level"
    log(f"[J.3] quadcopter [5, 7, 9]^6 rmax 16 ({depth}): levels {ml.levels}; interior q95 "
        f"against the 9^6 oracle {q95:.4f} (reported)")
    if not np.isfinite(q95):
        raise AssertionError("multilevel quadcopter: no finite value")


def phase_j4_pials(base_v, full):
    """J.4 pi_als: tests/test_pials.py's bars on the card (pendulum 31^2: (a)
    the rows reproduce the Bellman defect within 1e-3 x max|v|, (b) q95 <
    0.002 from the rank-20 start, (c) the best sampled-residual iterate is
    returned), then its users' configuration (experiments/rehearse6d_r5.py:
    90-103) on the 9^6 quadcopter from J.1's rank-16 base repadded to 64:
    schedule ((2, 48),) (the whole script: ((1, 32),)), oversample 3,
    lam_rel 3e-2, one sweep, make_bellman_kernel(chunk=32768); q95 before
    and after, wall, peak device memory; bar (c)."""
    from c3sc_tpu_torch.ops.tt import _repad, tt_from_dense, tt_full, tt_gather_eval
    from c3sc_tpu_torch.solvers import dense_vi
    from c3sc_tpu_torch.solvers.pials import frozen_policy_rows, pi_als
    from c3sc_tpu_torch.solvers.ttvi import make_bellman_kernel

    prob, grid = _pendulum(31)
    uc = prob.control_candidates(9)
    vd = dense_vi(prob, grid, controls=uc, tol=1e-6, max_outer=4000, device=DEVICE).v
    vmax = vd.abs().max().item()
    v_tt = _repad(tt_from_dense(vd, rmax=20, tol=1e-4), 24)
    rng = np.random.default_rng(3)
    idx = torch.as_tensor(np.stack([rng.integers(0, n, 512) for n in grid.shape], -1),
                          device=DEVICE)
    pts, w, rhs = frozen_policy_rows(prob, grid, torch.as_tensor(uc, device=DEVICE), v_tt, idx)
    lhs = torch.sum(w * tt_gather_eval(v_tt, pts.reshape(-1, 2)).reshape(pts.shape[:2]), 1) - rhs
    defect = tt_gather_eval(v_tt, idx) - make_bellman_kernel(prob, grid, uc, chunk=1024)(v_tt, idx)
    row_err = (lhs - defect).abs().max().item()
    v0 = _repad(tt_from_dense(vd, rmax=20, tol=1e-6), 24)
    res = pi_als(prob, grid, uc, v0, rmax=24, schedule=((3, 20),), oversample=4.0, chunk=8192,
                 lam_rel=1e-1, device=DEVICE)
    q95 = float(np.quantile(_rel_err(tt_full(res.v).reshape(-1), vd), 0.95))
    bres = [r["bres_abs"] for r in res.history]
    ok_c = res.best_outer == -1 or min(bres) == bres[res.best_outer]
    log(f"[J.4] pendulum 31^2: (a) rows against the defect {row_err:.3e} (bar "
        f"{1e-3 * max(vmax, 1.0):.3e}); (b) pi_als from rank 20, 3 outers at cap 20: q95 "
        f"{q95:.6f} (bar 0.002), {res.wall_time:.2f} s; (c) best outer {res.best_outer}, bres "
        f"{[round(b, 6) for b in bres]}")
    if not (row_err < 1e-3 * max(vmax, 1.0) and q95 < 0.002 and ok_c):
        raise AssertionError(f"pi_als pendulum bars: rows {row_err:.3e}, q95 {q95:.6f}, "
                             f"best {res.best_outer}")

    qprob, qgrid, quc, qvd = _flagship_setup()
    schedule = ((2, 48),) if full else ((1, 32),)
    v0 = _repad(base_v, 64)
    q_before, _ = interior_q95(qprob, qgrid, v0, qvd)
    kernel = make_bellman_kernel(qprob, qgrid, quc, chunk=32768)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, wall = _synced_s(lambda: pi_als(qprob, qgrid, quc, v0, rmax=64, schedule=schedule,
                                         oversample=3.0, lam_rel=3e-2, sweeps=1, kernel=kernel,
                                         device=DEVICE))
    peak = torch.cuda.max_memory_allocated() / 2**30
    q_after, _ = interior_q95(qprob, qgrid, res.v, qvd)
    bres = [r["bres_abs"] for r in res.history]
    ok_c = res.best_outer == -1 or min(bres) == bres[res.best_outer]
    log(f"[J.4] quadcopter 9^6 from the rank-16 base at padding 64, schedule {schedule}"
        f"{'' if full else ' (cut from ((2, 48),))'}, oversample 3, lam_rel 3e-2: interior q95 "
        f"{q_before:.4f} -> {q_after:.4f}, wall {wall:.2f} s, peak device memory {peak:.2f} GiB, "
        f"history {[(h['outer'], h['S'], round(h['bres'], 5)) for h in res.history]}, best outer "
        f"{res.best_outer}")
    if not (ok_c and np.isfinite(q_after)):
        raise AssertionError("pi_als 9^6: the returned iterate is not the best one")


def phase_j5_host(full):
    """J.5 the host path, each held against dense_vi on the card (K1):
    tt_vi with both cross methods on the pendulum at rank 16
    (tests/test_ttvi.py's problem and settings: beta 0.5, sigma 0.5, 9
    candidates, tol 2e-4, one cross sweep; sup error < 2 %) at the CLI
    example's 41^2 and 1,500 iterations under --phases J, at the test's own
    31^2 and 300 iterations in the whole script (at 41^2 the single-site
    cross settles into a cycle whose sup error moves between 0.015 and
    0.025 from one hundred iterations to the next; at 31^2 it stays within
    0.006-0.010 from iteration 200 on); tt_pi on
    Dubins as tests/test_ttpi.py runs it ((21, 21, 12), 7 candidates, rmax
    20; q95 < 2 %, mean < 0.5 %, <= 15 outer iterations); mpc_run on LQ
    (tests/test_mpc.py's settings, 16 plants) against the dense value's
    greedy closed loop under the same noise (final mean |x_0| within 0.05;
    JAX's own bar, final < half the start, is printed: its threshold is the
    closed loop's stationary spread, so fresh noise passes it about half the
    time); then tt_vi on the 9^6 quadcopter for 20 iterations: ms and host
    syncs an iteration."""
    from c3sc_tpu_torch.models import make_dubins_problem, make_lq_problem
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.sim import make_implicit_policy, mpc_run, rollout
    from c3sc_tpu_torch.solvers import dense_vi, tt_pi, tt_vi

    n, iters = (41, 1500) if full else (31, 300)
    prob, grid = _pendulum(n, beta=0.5, sigma=0.5)
    uc = prob.control_candidates(9)
    dense = dense_vi(prob, grid, controls=uc, tol=1e-5, max_outer=400, chunk=100, device=DEVICE)
    for method in ("cross", "dmrg"):
        sol, wall = _synced_s(lambda: tt_vi(prob, grid, controls=uc, rmax=16, seed=0, tol=2e-4,
                                            max_iters=iters, cross_sweeps=1, chunk=2048,
                                            cross_method=method, device=DEVICE))
        err = _rel_err(_node_values(grid, sol.v), dense.v, by="max")
        log(f"[J.5] tt_vi ({method}) pendulum {n}^2 rmax 16"
            f"{'' if full else ' (cut from 41^2 and 1,500 iterations)'}: {sol.iterations} "
            f"iterations, residual "
            f"{sol.residual:.3e}, ranks {sol.ranks[-1]}, {wall:.2f} s "
            f"({1e3 * wall / sol.iterations:.2f} ms/iteration), {sol.n_evals} backups; sup error "
            f"{err.max():.4f} of max|dense| (bar 0.02)")
        if not (err.max() < 0.02 and max(sol.ranks[-1]) <= 16):
            raise AssertionError(f"tt_vi {method} pendulum {n}^2: sup error {err.max():.4f}")

    prob = make_dubins_problem(beta=0.5)
    grid = prob.default_grid((21, 21, 12))
    uc = prob.control_candidates(7)
    dense = dense_vi(prob, grid, controls=uc, tol=1e-4, max_outer=200, chunk=50, device=DEVICE)
    sol, wall = _synced_s(lambda: tt_pi(prob, grid, controls=uc, rmax=20, seed=0, tol=3e-4,
                                        outer_iters=30, eval_iters=15, chunk=2048,
                                        device=DEVICE))
    err = _rel_err(_node_values(grid, sol.v), dense.v, by="max")
    q95 = float(np.quantile(err, 0.95))
    log(f"[J.5] tt_pi Dubins (21, 21, 12) rmax 20: {sol.outer_iters} outer iterations (bar <= "
        f"15), residual {sol.residual:.3e}, {wall:.2f} s, {sol.n_evals} backups; q95 {q95:.5f} "
        f"(bar 0.02), mean {err.mean():.5f} (bar 0.005)")
    if not (q95 < 0.02 and err.mean() < 0.005 and sol.outer_iters <= 15):
        raise AssertionError(f"tt_pi Dubins: q95 {q95:.5f}, mean {err.mean():.5f}, "
                             f"{sol.outer_iters} outers")

    prob = make_lq_problem(sigma=0.5, beta=1.0)
    grid = prob.default_grid(21)
    B, steps, n_replans, dt = 16, 25, 6, 0.02
    x0 = torch.tensor([1.5, 0.0], device=DEVICE).repeat(B, 1)
    noise = torch.randn((n_replans, steps, B, prob.dw),
                        generator=torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    res, wall = _synced_s(lambda: mpc_run(
        prob, grid, x0, dt=dt, steps_per_replan=steps, n_replans=n_replans, n_controls=9,
        rmax=8, refine_iters=2, first_solve_iters=200,
        solver_kwargs=dict(tol=1e-3, cross_sweeps=1, chunk=1024), noise=noise, device=DEVICE))
    uc = torch.as_tensor(prob.control_candidates(9), dtype=torch.float32, device=DEVICE)
    vd = dense_vi(prob, grid, controls=uc.cpu().numpy(), tol=1e-5, max_outer=400, chunk=100,
                  device=DEVICE).v
    pol = make_implicit_policy(prob, grid, lambda p: multilinear_interp(grid, vd, p), uc)
    with torch.no_grad():
        ref = rollout(prob, grid, pol, x0, dt, n_replans * steps,
                      noise=noise.reshape(n_replans * steps, B, prob.dw))
    final = res.xs[-1, :, 0].abs().mean().item()
    final_dense = ref.xs[-1, :, 0].abs().mean().item()
    log(f"[J.5] mpc_run LQ 21^2 rank 8, {B} plants x {n_replans} replans of {steps} steps: "
        f"{wall:.2f} s, warm replan latencies {[round(1e3 * t, 2) for t in res.replan_latency[1:]]} "
        f"ms, ranks {res.ranks}; final mean|x_0| {final:.4f} against the dense value's closed "
        f"loop {final_dense:.4f} under the same noise (bar 0.05); JAX's bar final < 0.75: "
        f"{final < 0.75} (its threshold is the stationary spread)")
    if not (tuple(res.xs.shape) == (1 + n_replans * steps, B, 2) and len(res.replan_latency)
            == n_replans and torch.isfinite(res.cost).all() and abs(final - final_dense) <= 0.05):
        raise AssertionError(f"mpc_run LQ: final {final:.4f} vs dense {final_dense:.4f}")

    qprob, qgrid, quc, qvd = _flagship_setup()
    sol, wall = _synced_s(lambda: tt_vi(qprob, qgrid, controls=quc, rmax=16, seed=0, tol=0.0,
                                        max_iters=20, device=DEVICE))
    warm, syncs = count_syncs(lambda: tt_vi(qprob, qgrid, controls=quc, rmax=16, seed=1,
                                            tol=0.0, max_iters=1, v0=sol.v, state=sol.state,
                                            device=DEVICE))
    q95, _ = interior_q95(qprob, qgrid, warm.v, qvd)
    log(f"[J.5] tt_vi quadcopter 9^6 rmax 16, 25 candidates, 20 iterations (the first with 5 "
        f"cross sweeps, then 2): {wall:.2f} s ({1e3 * wall / 20:.1f} ms/iteration), "
        f"{sol.n_evals} backups, ranks {sol.ranks[-1]}; a warm iteration under "
        f"torch.profiler: {syncs} host syncs (the loop runs on the host by design); interior "
        f"q95 after 21 iterations {q95:.4f} (reported)")


def phase_j_solvers(full=False):
    """Phase J: the remaining solvers, each held on the card (module
    docstring). ``full``: --phases J's depth; else the whole script's cuts."""
    marks = [time.perf_counter()]
    base_v = phase_j1_refined(full)
    marks.append(time.perf_counter())
    for fn in (lambda: phase_j2_oversample(full), lambda: phase_j3_multilevel(full),
               lambda: phase_j4_pials(base_v, full), lambda: phase_j5_host(full)):
        fn()
        marks.append(time.perf_counter())
    log("[timing] phase J: " + ", ".join(f"J.{i + 1} {b - a:.1f} s"
                                         for i, (a, b) in enumerate(zip(marks, marks[1:]))))


# ---- phase K: K1 on non-uniform grids, the CLI and the builder -------------------

K_SCRATCH = os.path.join(REPO, ".chip_scratch", "k")   # listed in .gitignore
K1_UNIFORM_MS = {"dense_backup": 0.1362, "dense_evaluate": 0.0583}   # PERF.md, 11^6, 25 cand.
# the summary keys of the JAX CLI (c3sc_tpu/cli.py) by solver, before the rollouts' keys
CLI_KEYS = {"dense": {"solver", "residual", "sweeps"},
            "fused": {"solver", "residual", "iterations", "ranks", "wall"},
            "tt": {"solver", "residual", "iterations", "evals", "ranks", "wall"},
            "pi": {"solver", "residual", "outer_iters", "evals", "wall"}}


def tanh_grid(prob, shape, sharp=1.5):
    """The problem's default grid with tests/test_nonuniform.py's nodes,
    denser near the centre, on every bounded dim (periodic dims keep their
    uniform nodes)."""
    from c3sc_tpu_torch.grids import Grid

    g = prob.default_grid(shape)
    nodes = []
    for k, (lo, hi, n) in enumerate(zip(g.lb, g.ub, g.shape)):
        t = np.tanh(sharp * np.linspace(-1, 1, n)) / np.tanh(sharp)
        nodes.append(g.nodes(k) if g.periodic[k] else lo + (t + 1) * 0.5 * (hi - lo))
    return Grid.create(g.lb, g.ub, g.shape, g.periodic, nodes=nodes)


def phase_k1_kernels():
    """K.1 (outside the counted run): each K1 entry on non-uniform (tanh)
    grids against its plain version, by compare_sweep's bars (2e-4, argmins
    off near-ties, the improve's policy bit-equal to gather_policy, the
    evaluate under it bit-equal to the improve, 64-bit indices bit-equal to
    32-bit), under both semantics: the structured entries on the quadcopter
    at 11^6 and on quadcopter7 at 9^7 (d = 7, du = 2), 25 candidates; the
    general ones on the glider at (15, 11, 11, 11), 9 candidates. Then ms a
    sweep (CUDA graph of 100 launches) on the non-uniform grid and on the
    uniform grid of the same shape, in this run, and the bound with the
    spacing tables counted (each used float read once). Returns (max
    differences, {entry: the non-uniform record for the kernels line})."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops import dense_backup as db

    errs = dict.fromkeys(KERNELS, 0.0)
    record = {}
    cases = (("quadcopter", make_problem("quadcopter", **QUAD), (11,) * 6, 5),
             ("glider", make_problem("glider"), (15, 11, 11, 11), 9),
             ("quadcopter7", make_problem("quadcopter7", **QUAD), (9,) * 7, 5))
    for name, prob, shape, per_dim in cases:
        uc = prob.control_candidates(per_dim)
        grid = tanh_grid(prob, shape)
        ops = db.make_dense_operands(prob, grid, uc, DEVICE)
        kind = "general" if ops.general else "structured"
        label = f"{prob.name} {'x'.join(map(str, shape))} tanh, {len(uc)} candidates, {kind}"
        v = torch.as_tensor(np.random.default_rng(0).uniform(0, 5, shape), dtype=torch.float32,
                            device=DEVICE)
        names = KERNELS[2:] if ops.general else KERNELS[:2]
        for sem, (clip, pin) in (("Pallas", (prob.value_bounds, True)),
                                 ("dense_vi", (None, False))):
            e = compare_sweep(ops, v, clip, pin, f"{label}, {sem} semantics", tag="K.1")
            errs[names[0]], errs[names[1]] = max(errs[names[0]], e[0]), max(errs[names[1]], e[1])
        uni = db.make_dense_operands(prob, prob.default_grid(shape), uc, DEVICE)
        ms = {}
        for form, o in (("nonuniform", ops), ("uniform", uni)):
            _, pol = db.dense_backup(o, v, with_policy=True)
            ms[form] = {names[0]: graph_ms(lambda: db.dense_backup(o, v, with_policy=True)),
                        names[1]: graph_ms(lambda: db.dense_evaluate(o, v, pol))}
        bounds = (general_sweep_bounds if ops.general else sweep_bounds)(ops)
        table = 4 * 5 * sum(shape)                        # the spacing tables' used floats
        bounds = _bounds({k: (b["bytes"] + table, b["flops"]) for k, b in bounds.items()})
        for entry in names:
            b, t, u = bounds[entry]["bound_ms"], ms["nonuniform"][entry], ms["uniform"][entry]
            log(f"[K.1] {label}: {entry} {t:.4f} ms a sweep (uniform grid of the same shape "
                f"{u:.4f} ms, x{t / u:.3f}); bound {b:.4f} ms ({bounds[entry]['bound_by']}, "
                f"tables counted): {100 * b / t:.1f} % of the bound")
            if name in ("quadcopter", "glider"):
                record[entry] = {"nonuniform_ms": t, "nonuniform_bound_ms": b,
                                 "nonuniform_uniform_ms": u, "nonuniform_at": label}
            if name == "quadcopter":
                log(f"[K.1] uniform 11^6 {entry} {u:.4f} ms against PERF.md's "
                    f"{K1_UNIFORM_MS[entry]} ms (H100 80GB HBM3, 700 W): "
                    f"{100 * (u / K1_UNIFORM_MS[entry] - 1):+.1f} %")
        del ops, uni, v
        torch.cuda.empty_cache()
    return errs, record


def phase_k1_solves():
    """K.1 on the main path (counted): dense_vi on tests/test_nonuniform.py's
    LQ 21^2 tanh grid (9 candidates) and solve_local_patch on the pendulum
    31^2 patch [8, 22]^2 (a slice of periodic theta nodes, non-uniform by
    rounding; the faces from a seeded value) on the card against the CPU:
    within 1e-4 x max|v|, the patch after the same number of sweeps."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.solvers import dense_vi
    from c3sc_tpu_torch.solvers.local_patch import solve_local_patch

    prob = make_problem("lq")
    grid = tanh_grid(prob, (21, 21))
    uc = prob.control_candidates(9)
    sols = {dev: dense_vi(prob, grid, controls=uc, tol=1e-6, max_outer=4000, device=dev)
            for dev in (DEVICE, "cpu")}
    ref = sols["cpu"].v
    err = float((sols[DEVICE].v.cpu() - ref).abs().max() / ref.abs().max())
    log(f"[K.1] dense_vi on the LQ 21^2 tanh grid: card against CPU {err:.3e} x max|v| "
        f"({sols[DEVICE].sweeps} and {sols['cpu'].sweeps} sweeps)")
    if not err <= PARITY_BAR:
        raise AssertionError(f"non-uniform dense_vi on the card differs from the CPU: {err:.3e}")
    prob = make_problem("pendulum")
    grid = prob.default_grid(31)
    vdeg = np.random.default_rng(3).uniform(0, 5, grid.shape).astype(np.float32) + 10.0
    patches = {}
    for dev in (DEVICE, "cpu"):
        vt = torch.as_tensor(vdeg, device=dev)
        patches[dev] = solve_local_patch(prob, grid, lambda p: multilinear_interp(grid, vt, p),
                                         prob.control_candidates(9), lo=(8, 8), hi=(22, 22),
                                         tol=1e-5, max_sweeps=400, device=dev)
    gpu, cpu = patches[DEVICE], patches["cpu"]
    err = float((gpu.v.cpu() - cpu.v).abs().max() / cpu.v.abs().max())
    log(f"[K.1] pendulum patch [8, 22]^2 (uniform: {gpu.subgrid.uniform}): card against CPU "
        f"{err:.3e} x max|v|, sweeps {gpu.sweeps} and {cpu.sweeps}")
    if gpu.subgrid.uniform or gpu.sweeps != cpu.sweeps or not err <= PARITY_BAR:
        raise AssertionError("the non-uniform patch on the card differs from the CPU")


def _cli(argv, label):
    """c3sc_tpu_torch.cli.main in this process, with a time and the files it wrote."""
    from c3sc_tpu_torch import cli

    t0 = time.perf_counter()
    summary = cli.main(argv)
    wall = time.perf_counter() - t0
    outdir = argv[argv.index("--outdir") + 1]
    log(f"[K.2] {label}: {wall:.1f} s, files {sorted(os.listdir(outdir))}, summary "
        + json.dumps(summary))
    for line in open(os.path.join(outdir, "metrics.jsonl")):
        json.loads(line)
        if "Infinity" in line or "NaN" in line:
            raise AssertionError(f"metrics.jsonl is not strict JSON: {label}")
    solver = summary["solver"]
    want = CLI_KEYS[solver] | {"solve_wall_s"}
    if "--rollouts" in argv:
        want |= {"rollouts", "mean_cost", "rollout_wall_s"}
        if not np.isfinite(summary["mean_cost"]):
            raise AssertionError(f"non-finite rollout cost: {label}")
    if "--save-format" in argv:
        want |= {"c3tt_file", "c3tt_native"}
    if set(summary) != want:
        raise AssertionError(f"{label}: summary keys {sorted(summary)}, the JAX CLI's "
                             f"{sorted(want)}")
    if not np.isfinite(summary["residual"]):
        raise AssertionError(f"non-finite residual: {label}")
    return summary, wall


def phase_k2_cli(full):
    """K.2: the CLI as users run it (module docstring). ``full``: the
    documented quadcopter run uncut (2,000 iterations); else 400."""
    import shutil

    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.native import have_native, tt_load_binary, tt_to_active
    from c3sc_tpu_torch.ops.ft import ft_eval, ft_from_tt, ft_grad_eval
    from c3sc_tpu_torch.solvers import dense_vi
    from c3sc_tpu_torch.utils import checkpoint as ck
    from c3sc_tpu_torch.utils import load_solver_state

    shutil.rmtree(K_SCRATCH, ignore_errors=True)
    d = lambda name: os.path.join(K_SCRATCH, name)  # noqa: E731
    saves = []
    real_save = ck.save_fused_carry

    def counting_save(*a, **kw):
        saves.append(int(a[1].it))
        return real_save(*a, **kw)

    ck.save_fused_carry = counting_save
    try:
        iters = 2000 if full else 400
        s, wall = _cli(["quadcopter", "--n", "31", "--rmax", "20", "--max-iters", str(iters),
                        "--rollouts", "256", "--steps", "500", "--outdir", d("quad")],
                       f"quadcopter 31^6, rmax 20, 81 candidates, <= {iters} iterations")
        log(f"[K.2] quadcopter: {1e3 * s['wall'] / max(s['iterations'], 1):.2f} ms an "
            f"iteration (the solver's wall), checkpoints written at iterations {saves}, "
            f"rollout_wall_s {s['rollout_wall_s']} (256 x 500 steps)")
        if not saves:
            raise AssertionError("the quadcopter run wrote no checkpoint")
        s, _ = _cli(["dubins", "--n", "41", "--solver", "dense", "--rollouts", "256", "--steps",
                     "500", "--outdir", d("dubins")], "dubins 41^3, dense (K1)")
        prob = make_problem("dubins")
        direct = dense_vi(prob, prob.default_grid(41), controls=prob.control_candidates(9),
                          tol=1e-4, device=DEVICE)
        if not np.array_equal(np.load(d("dubins") + "/vf.npz")["v"], direct.v.cpu().numpy()):
            raise AssertionError("the CLI's dense vf.npz differs from dense_vi called directly")
        lq = ["lq", "--n", "21", "--rmax", "8"]
        s1, _ = _cli(lq + ["--max-iters", "120", "--save-every", "50", "--rollouts", "8",
                           "--steps", "50", "--outdir", d("lq")], "lq fused run")
        s2, _ = _cli(lq + ["--max-iters", "200", "--outdir", d("lq_resume"),
                           "--load", d("lq") + "/solver_state.npz"], "lq --load solver_state.npz")
        if s2["iterations"] < s1["iterations"]:
            raise AssertionError("the resumed run did fewer iterations than the first")
        _cli(lq + ["--max-iters", "150", "--outdir", d("lq_warm"), "--load", d("lq") + "/vf.npz"],
             "lq --load vf.npz")
        s4, _ = _cli(lq + ["--max-iters", "150", "--rollouts", "8", "--steps", "50", "--outdir",
                           d("lq_c3tt"), "--save-format", "c3tt", "--policy-basis", "poly"],
                     "lq --save-format c3tt --policy-basis poly")
        active = tt_to_active(load_solver_state(d("lq_c3tt") + "/vf.npz", "cpu")["v"])
        if not all(np.array_equal(a, b) for a, b in zip(tt_load_binary(s4["c3tt_file"]), active)):
            raise AssertionError("vf.c3tt does not reload to the active cores")
        if s4["c3tt_native"] is not have_native():
            raise AssertionError("the native library is loaded but its C3TT writer failed")
        log(f"[K.2] vf.c3tt written by the {'native library' if s4['c3tt_native'] else 'numpy'} "
            "route (the route tt_save_binary returned), reloads to the active cores exactly")
        _cli(lq + ["--max-iters", "100", "--outdir", d("lq_from_c3tt"), "--load",
                   s4["c3tt_file"]], "lq --load vf.c3tt")
        _cli(["pendulum", "--n", "21", "--rmax", "8", "--max-iters", "150", "--rollouts", "8",
              "--steps", "50", "--policy-basis", "poly", "--outdir", d("pend_poly")],
             "pendulum --policy-basis poly (a periodic dim)")
        pgrid = make_problem("pendulum").default_grid(21)
        ft = ft_from_tt(load_solver_state(d("pend_poly") + "/vf.npz", DEVICE)["v"], pgrid)
        lo = torch.tensor(pgrid.lb, device=DEVICE)
        span = torch.tensor(pgrid.ub, device=DEVICE) - lo
        pts = lo + 1.5 * span * torch.rand((256, 2), device=DEVICE)   # past the period too
        ft_eval(ft, pts)
        ft_grad_eval(ft, pts)
        _, syncs = count_syncs(lambda: (ft_eval(ft, pts), ft_grad_eval(ft, pts)))
        log(f"[K.2] ft_eval + ft_grad_eval on 256 pendulum points (the poly policy's value "
            f"and gradient, periodic theta): {syncs} host syncs")
        if syncs:
            raise AssertionError("the poly policy's value function syncs with the host")
        _cli(lq + ["--solver", "tt", "--max-iters", "30", "--outdir", d("lq_tt")], "lq --solver tt")
        _cli(lq + ["--solver", "pi", "--max-iters", "3", "--outdir", d("lq_pi")], "lq --solver pi")
    finally:
        ck.save_fused_carry = real_save
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "c3sc_tpu_torch.cli", "lq", "--n", "21",
                          "--solver", "dense", "--outdir", d("lq_module")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"python -m c3sc_tpu_torch.cli failed:\n{out.stderr[-3000:]}")
    log(f"[K.2] python -m c3sc_tpu_torch.cli lq --n 21 --solver dense: "
        f"{time.perf_counter() - t0:.1f} s, {out.stdout.strip().splitlines()[-1]}")


def _builder_lq():
    """tests/test_control_api.py's LQ builder with batched callables."""
    from c3sc_tpu_torch.control import C3Control
    from c3sc_tpu_torch.device import const_tensor
    from c3sc_tpu_torch.models import lqr_solution

    P, c, _ = lqr_solution(sigma=1.0, beta=1.0)

    def diff(x, u):   # constants uploaded once: a captured iteration copies nothing
        L = const_tensor([[0.0], [1.0]], x.dtype, x.device)
        return L.expand(*torch.broadcast_shapes(x.shape[:-1], u.shape[:-1]), 2, 1)

    def psi(x):
        return torch.einsum("...i,ij,...j->...", x, const_tensor(P, x.dtype, x.device), x) + c

    ctrl = (C3Control(dx=2, du=1, dw=1, lb=[-2, -2], ub=[2, 2], beta=1.0, ulb=[-6], uub=[6],
                      name="lq_builder")
            .add_drift(lambda x, u: torch.stack(torch.broadcast_tensors(x[..., 1], u[..., 0]), -1))
            .add_diff(diff)
            .add_stagecost(lambda x, u: (x * x).sum(-1) + (u * u).sum(-1))
            .add_boundcost(psi)
            .set_external_boundary(0, "absorb")
            .set_external_boundary(1, "absorb"))
    return ctrl, P, c


def phase_k3_builder():
    """K.3: the C3Control builder on the card. tests/test_control_api.py's
    Riccati bar (31^2, rmax 10, 15 candidates, tol 2e-4, <= 1,500
    iterations, graphed: interior rel < 0.08), then its closed-loop bar on
    a 21^2 rmax-8 solve: 128 rollouts of 400 steps at dt 0.01 from
    default_rng(7)'s x0, the same noise (torch.Generator, seed 11) for every
    policy: poly + 8 refine steps realizes a cost at most lerp's."""
    from c3sc_tpu_torch.ops.tt import tt_gather_eval
    from c3sc_tpu_torch.sim import rollout

    ctrl, P, c = _builder_lq()
    sol, wall = _synced_s(lambda: ctrl.vi_solve(ngrid=31, rmax=10, n_controls=15, tol=2e-4,
                                                max_iters=1500, seed=0, device=DEVICE,
                                                cuda_graph=True))
    grid = sol.grid
    idx = grid.node_indices(DEVICE)
    x = grid.index_to_state(idx).cpu().numpy()
    v = tt_gather_eval(sol.v, idx).cpu().numpy()
    v_true = np.einsum("ni,ij,nj->n", x, P, x) + c
    interior = np.all(np.abs(x) < 1.0, axis=-1)
    rel = np.abs(v - v_true)[interior].max() / np.abs(v_true[interior]).max()
    log(f"[K.3] builder vi_solve 31^2 rmax 10: {sol.iterations} iterations in {wall:.1f} s, "
        f"interior rel error against Riccati {rel:.4f} (bar 0.08)")
    if not rel < 0.08:
        raise AssertionError(f"builder VI against Riccati: {rel:.3f}")
    sol = ctrl.vi_solve(ngrid=21, rmax=8, n_controls=9, tol=2e-4, max_iters=800, seed=0,
                        device=DEVICE, cuda_graph=True)
    prob = ctrl.problem()
    x0 = torch.as_tensor(np.random.default_rng(7).uniform(-1.2, 1.2, (128, 2)),
                         dtype=torch.float32, device=DEVICE)
    noise = torch.randn((400, 128, 1), generator=torch.Generator(device=DEVICE).manual_seed(11),
                        device=DEVICE)

    def realized(**kw):
        pol = ctrl.implicit_policy(sol, n_controls=9, **kw)
        with torch.no_grad():
            return float(rollout(prob, sol.grid, pol, x0, 0.01, 400, noise=noise).cost.mean())

    c_lerp, c_pref = realized(), realized(basis="poly", refine_steps=8)
    log(f"[K.3] closed loops (128 x 400, shared noise): lerp {c_lerp:.4f}, poly + 8 refine "
        f"steps {c_pref:.4f}")
    if not c_pref <= c_lerp:
        raise AssertionError(f"poly + refine realized {c_pref:.4f} > lerp {c_lerp:.4f}")


def phase_k_entry_points(full=False):
    """Phase K on the main path (counted): K.1's solves, K.2, K.3. Returns
    the K1 launches of K.1's solves, all of them on non-uniform grids (the
    counts are 0 when the phase starts)."""
    from c3sc_tpu_torch.ops import dense_backup as db

    marks = [time.perf_counter()]
    phase_k1_solves()
    nonuniform = db.launch_counts()
    log(f"[K.1] K1 launches on non-uniform grids (dense_vi and the patch): {nonuniform}")
    marks.append(time.perf_counter())
    for fn in (lambda: phase_k2_cli(full), phase_k3_builder):
        fn()
        marks.append(time.perf_counter())
    log("[timing] phase K: " + ", ".join(f"{n} {b - a:.1f} s" for n, a, b in
                                         zip(("K.1 solves", "K.2", "K.3"), marks, marks[1:])))
    return nonuniform


# ---- phase L: parallel/ on a world of one ----------------------------------------------

def _profiled_collectives(fn):
    """fn() under torch.profiler; returns (its result, the host syncs in it
    less an empty call's, and the collectives it issued by name: the
    dispatcher's ``c10d::`` ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, base = _profiled_syncs(lambda: None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    ops = {}
    for e in cpu:
        if e.name.startswith("c10d::"):
            ops[e.name] = ops.get(e.name, 0) + 1
    return out, sum(e.name in SYNC_NAMES for e in cpu) - base, ops


def phase_l1_sharded_backup(mesh, v_tt, n_nodes=4096):
    """The (1, 1) sharded backup of 4,096 nodes of the 9^6 quadcopter with 16
    candidates, on F.2's TT, against make_bellman_kernel: bit for bit."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.parallel import make_sharded_bellman
    from c3sc_tpu_torch.solvers.ttvi import make_bellman_kernel

    prob = make_problem("quadcopter", **QUAD)
    grid = prob.default_grid(tuple(v_tt.shape))
    controls = prob.control_candidates((8, 2))
    rng = np.random.default_rng(2)
    idx = torch.as_tensor(np.stack([rng.integers(0, m, n_nodes) for m in grid.shape], -1),
                          device=DEVICE)
    uc = torch.as_tensor(controls, dtype=torch.float32, device=DEVICE)
    sharded = make_sharded_bellman(prob, grid, mesh)
    plain = make_bellman_kernel(prob, grid, controls, chunk=n_nodes)
    got, want = sharded(v_tt, idx, uc), plain(v_tt, idx)
    diff = (got - want).abs().max().item()
    ms = {"sharded": cuda_ms(lambda: sharded(v_tt, idx, uc)),
          "plain": cuda_ms(lambda: plain(v_tt, idx))}
    log(f"[L.1] sharded backup, mesh {tuple(mesh.shape)}: quadcopter {grid.shape[0]}^6, "
        f"{len(controls)} candidates, {n_nodes} nodes: max|sharded - make_bellman_kernel| "
        f"{diff:.3e} (bit-equal {torch.equal(got, want)}); {ms['sharded']:.4f} ms against "
        f"{ms['plain']:.4f} ms")
    if not torch.equal(got, want):
        raise AssertionError(f"the sharded backup differs from make_bellman_kernel by {diff:.3e}")


def phase_l2_mesh_iteration(mesh, n=31, rmax=16, iters=50, warm=30, traced=3):
    """make_fused_vi(mesh=) at F.3's configuration, graphed, against the
    plain graphed solver from the same warm carry; times in turns (plain,
    mesh, mesh, plain); host syncs of ``traced`` graphed mesh iterations
    (a trace holds every kernel of every replay: 8,400 an iteration) and of
    an eager mesh iteration, and the collectives the eager one issues."""
    kw = dict(problem_kw={}, tol=0.0, max_iters=10**9)
    prob, grid, plain = _quad_fused(n, rmax, DEVICE, cuda_graph=True, **kw)
    _, _, meshed = _quad_fused(n, rmax, DEVICE, cuda_graph=True, mesh=mesh, **kw)
    carry = plain.step_fn(plain.init_fn(0), warm)
    outs, walls = {}, {"plain": [], "mesh": []}
    for label in ("plain", "mesh", "mesh", "plain"):
        solver = plain if label == "plain" else meshed
        solver.step_fn(carry, 1)                 # the first mesh call captures its graph
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[label] = solver.step_fn(carry, iters)
        torch.cuda.synchronize()
        walls[label].append(1e3 * (time.perf_counter() - t0) / iters)
    a, b = outs["mesh"], outs["plain"]
    scale = b.v_sample.abs().max().item()
    diff = (a.v_sample - b.v_sample).abs().max().item()
    same = all(torch.equal(x, y) for x, y in zip(a.cores, b.cores))
    _, syncs, _ = _profiled_collectives(lambda: meshed.step_fn(carry, traced))
    _, _, eager = _quad_fused(n, rmax, DEVICE, mesh=mesh, **kw)
    eager.step_fn(carry, 1)
    _, eager_syncs, ops = _profiled_collectives(lambda: eager.step_fn(carry, 1))
    log(f"[L.2] fused {n}^6 rmax {rmax}, 25 candidates, CUDA graph: plain "
        f"{', '.join(f'{w:.3f}' for w in walls['plain'])} ms/iteration, mesh "
        f"{tuple(mesh.shape)} {', '.join(f'{w:.3f}' for w in walls['mesh'])} ms/iteration "
        f"(over {iters} iterations each, in turns); ranks {a.ranks.tolist()} equal "
        f"{torch.equal(a.ranks, b.ranks)}, max|dv_sample| {diff:.3e} of max|v| {scale:.4g}, "
        f"cores bit-equal {same}; host syncs: graphed {traced} iterations {syncs}, an eager "
        f"mesh iteration {eager_syncs}; collectives an eager iteration {ops}")
    if not torch.equal(a.ranks, b.ranks) or diff > 1e-5 * scale:
        raise AssertionError(f"the mesh iteration differs from the plain one: {diff:.3e}")
    if syncs or eager_syncs:
        raise AssertionError(f"a mesh iteration reads the device on the host: {syncs}, "
                             f"{eager_syncs}")


def phase_l3_batch(mesh, n_inst=8, n=31, rmax=12, iters=100, warm=5):
    """make_batch_stepper at bench_scaling.py's configuration (pendulum 31^2,
    9 candidates, rmax 12, tol 0): 8 instances, each in turn through the
    batch solver's one captured iteration, against one instance's own
    graph; instances 0 and 1 bit-equal to their single solves."""
    from c3sc_tpu_torch.models import make_pendulum_problem
    from c3sc_tpu_torch.parallel.multi_solve import make_batch_stepper, unstack_carry
    from c3sc_tpu_torch.solvers import make_fused_vi

    prob = make_pendulum_problem()
    grid = prob.default_grid(n)
    controls = prob.control_candidates(9)
    init, step = make_batch_stepper(prob, grid, controls, rmax=rmax, mesh=mesh)
    _, s_init, s_step, _ = make_fused_vi(prob, grid, controls, rmax=rmax, tol=0.0,
                                         max_iters=10**9, device=DEVICE, cuda_graph=True)

    def timed(run, start):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = run(start, warm)                   # the capture, then warm replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(out, iters)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base

    singles = [timed(s_step, s_init(s)) for s in (0, 1)]
    batch, wall, peak = timed(step, init(list(range(n_inst))))
    rate_1, rate_n = iters / singles[0][1], n_inst * iters / wall
    equal = [all(torch.equal(x, y) for fa, fb in zip(c, single) for x, y in
                 (zip(fa, fb) if isinstance(fa, tuple) else ((fa, fb),)))
             for c, (single, _, _) in zip(unstack_carry(batch, 0, 2), singles)]
    log(f"[L.3] make_batch_stepper, pendulum {n}^2 rmax {rmax}, {n_inst} instances in turn "
        f"(mesh {tuple(mesh.shape)}): {rate_n:.1f} instance-iterations/s "
        f"({1e3 * wall / iters:.3f} ms an iteration of all {n_inst}) against one instance's graph "
        f"{rate_1:.1f} iterations/s ({1e3 * singles[0][1] / iters:.3f} ms): "
        f"{rate_n / rate_1:.3f}x; peak device memory above the start {peak / 2**20:.1f} MiB "
        f"against {singles[0][2] / 2**20:.1f} MiB; instances 0 and 1 bit-equal to their "
        f"graphed single solves {equal}")
    if not all(equal):
        raise AssertionError(f"batched instances differ from their single solves: {equal}")


def phase_l4_rollout(mesh, sol, n_rollouts=256, n_steps=400, dt=0.01):
    """Phase F.5's rollouts on F.2's value, sharded over 'fibers', against
    rollout under common noise: bit for bit; then from per-block seeds."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops.tt import tt_lerp_eval
    from c3sc_tpu_torch.parallel import make_sharded_rollout
    from c3sc_tpu_torch.sim import make_implicit_policy, rollout

    prob = make_problem("quadcopter", **QUAD)
    grid = prob.default_grid(sol.v.shape)
    controls = torch.as_tensor(sol.controls, dtype=torch.float32, device=DEVICE)
    x0, noise = _rollout_inputs(prob, n_rollouts, n_steps)
    policy = make_implicit_policy(prob, grid, lambda p: tt_lerp_eval(sol.v, grid, p), controls)
    roll = make_sharded_rollout(prob, grid, mesh, policy, dt, n_steps)
    out, walls = {}, {}
    with torch.no_grad():
        for label, fn in (("sharded", lambda: roll(x0, noise=noise)),
                          ("rollout", lambda: rollout(prob, grid, policy, x0, dt, n_steps,
                                                      noise=noise)),
                          ("seeds", lambda: roll(x0, seeds=list(range(n_rollouts))))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[label] = fn()
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
    a, b, s = out["sharded"], out["rollout"], out["seeds"]
    equal = all(torch.equal(getattr(a, f), getattr(b, f)) for f in b._fields)
    log(f"[L.4] sharded rollouts on F.2's value, mesh {tuple(mesh.shape)}: {n_rollouts} x "
        f"{n_steps} steps: bit-equal to rollout {equal}, wall {walls['sharded']:.2f} s against "
        f"{walls['rollout']:.2f} s; from seeds: mean cost {s.cost.mean().item():.4f}, survival "
        f"{100 * s.alive[-1].float().mean().item():.2f}%, wall {walls['seeds']:.2f} s")
    if not equal:
        raise AssertionError("the sharded rollout differs from rollout under common noise")
    if tuple(s.xs.shape) != (n_steps + 1, n_rollouts, prob.dx) or \
            not torch.isfinite(s.xs).all() or not torch.isfinite(s.cost).all():
        raise AssertionError("the seeded sharded rollout: bad trajectory")


def phase_l_parallel(sol):
    """Phase L on a world of one under NCCL: L.1-L.4 (sol: F.2's solution)."""
    import torch.distributed as dist

    from c3sc_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh()
    log(f"[L] world of one: backend {dist.get_backend()}, world size {dist.get_world_size()}, "
        f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on {mesh.device_type}")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"the card's mesh runs {dist.get_backend()}, not NCCL")
    marks = [time.perf_counter()]
    phase_l1_sharded_backup(mesh, sol.v)
    marks.append(time.perf_counter())
    phase_l2_mesh_iteration(mesh)
    marks.append(time.perf_counter())
    phase_l3_batch(make_mesh(axes=("fibers",)))
    marks.append(time.perf_counter())
    phase_l4_rollout(mesh, sol)
    marks.append(time.perf_counter())
    dist.destroy_process_group()
    log("[timing] phase L: " + ", ".join(f"L.{i + 1} {b - a:.1f} s" for i, (a, b) in
                                         enumerate(zip([t0] + marks[1:-1], marks[1:]))))


# ---- phase M: K1 beyond its structured entries -----------------------------------------

WIDE_SIGMA = 0.3   # the diffusion of both of M's problems, on every state


def _wide_diff(x, u):
    """WIDE_SIGMA I [..., d, d] over the broadcast batch of x and u."""
    batch = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
    return torch.diag_embed(x.new_full((*batch, x.shape[-1]), WIDE_SIGMA))


def double_integrator_du5(declared=False):
    """C3Control(dx=2, du=5): x0' = x1, x1' = u0 + ... + u4 (ROADMAP's
    fixture for five controls), noise 0.3, cost |x|^2 + 0.1 |u|^2,
    reflecting faces on [-2, 2]^2, u in [-0.4, 0.4]^5; ``declared`` adds
    all five structure declarations."""
    import dataclasses

    from c3sc_tpu_torch.control import C3Control

    prob = (C3Control(dx=2, du=5, dw=2, lb=[-2.0, -2.0], ub=[2.0, 2.0], beta=0.5,
                      ulb=[-0.4] * 5, uub=[0.4] * 5, name="double_integrator_du5")
            .add_drift(lambda x, u: torch.stack(torch.broadcast_tensors(x[..., 1], u.sum(-1)),
                                                -1))
            .add_diff(_wide_diff)
            .add_stagecost(lambda x, u: (x * x).sum(-1) + 0.1 * (u * u).sum(-1))
            .set_external_boundary(0, "reflect").set_external_boundary(1, "reflect")
            .set_value_bounds(0.0, 50.0)).problem()
    if not declared:
        return prob
    return dataclasses.replace(
        prob, name=prob.name + " declared",
        drift_f0=lambda x: torch.stack([x[..., 1], torch.zeros_like(x[..., 0])], -1),
        drift_G=lambda x: torch.stack([torch.zeros_like(x[..., :1]).expand(*x.shape[:-1], 5),
                                       torch.ones_like(x[..., :1]).expand(*x.shape[:-1], 5)],
                                      -2),
        sigma2_x=lambda x: torch.full_like(x, WIDE_SIGMA ** 2),
        cost_q=lambda x: (x * x).sum(-1),
        cost_r=lambda u: 0.1 * (u * u).sum(-1))


def nine_states(d=9):
    """C3Control(dx=d, du=1): x_j' = -x_j + u [j = 0], noise 0.3 on every
    state, cost |x|^2 + 0.1 u^2, reflecting faces on [-1, 1]^d, u in [-1, 1]
    (d = 9 unless given: the family's nine-state member)."""
    from c3sc_tpu_torch.control import C3Control

    ctrl = (C3Control(dx=d, du=1, dw=d, lb=[-1.0] * d, ub=[1.0] * d, beta=0.5,
                      name={9: "nine_states", 12: "twelve_states"}.get(d, f"states{d}"))
            .add_drift(lambda x, u: torch.nn.functional.pad(u[..., :1], (0, d - 1)) - x)
            .add_diff(_wide_diff)
            .add_stagecost(lambda x, u: (x * x).sum(-1) + 0.1 * (u * u).sum(-1))
            .set_value_bounds(0.0, 50.0))
    for j in range(d):
        ctrl.set_external_boundary(j, "reflect")
    return ctrl.problem()


def _wide_bounds(ops, names, table=0):
    """general_sweep_bounds under the entry names ``names`` (improve,
    evaluate), with ``table`` bytes of spacing tables counted."""
    bounds = general_sweep_bounds(ops)
    return _bounds({new: (bounds[old]["bytes"] + table, bounds[old]["flops"])
                    for new, old in zip(names, KERNELS[2:])})


def phase_m1_five_controls(n=201):
    """M.1 (outside the counted run): the du = 5 double integrator, without
    and with its declarations, against the plain version by compare_sweep's
    bars under both semantics; ms a sweep against the bound. Returns the max
    differences of the general entries."""
    from c3sc_tpu_torch.ops import dense_backup as db

    errs = dict.fromkeys(KERNELS[2:], 0.0)
    for declared in (False, True):
        prob = double_integrator_du5(declared)
        grid = prob.default_grid(n)
        ops = db.make_dense_operands(prob, grid, prob.control_candidates(3), DEVICE)
        label = f"{prob.name} {n}^2, {ops.uc.shape[0]} candidates"
        if not ops.general or prob.structured != declared:
            raise AssertionError(f"{label}: du = 5 must take the general entries")
        v = torch.as_tensor(np.random.default_rng(0).uniform(0, 5, grid.shape),
                            dtype=torch.float32, device=DEVICE)
        for sem, (clip, pin) in (("Pallas", (prob.value_bounds, True)),
                                 ("dense_vi", (None, False))):
            e = compare_sweep(ops, v, clip, pin, f"{label}, {sem} semantics", tag="M.1")
            errs[KERNELS[2]], errs[KERNELS[3]] = (max(errs[KERNELS[2]], e[0]),
                                                  max(errs[KERNELS[3]], e[1]))
        _, pol = db.dense_backup(ops, v, with_policy=True)
        ms = {KERNELS[2]: graph_ms(lambda: db.dense_backup(ops, v, with_policy=True)),
              KERNELS[3]: graph_ms(lambda: db.dense_evaluate(ops, v, pol))}
        bounds = general_sweep_bounds(ops)
        for entry, t in ms.items():
            b = bounds[entry]["bound_ms"]
            log(f"[M.1] {label}: {entry} {t:.4f} ms a sweep (CUDA graph of 100); bound "
                f"{b:.4f} ms ({bounds[entry]['bound_by']}): {100 * b / t:.1f} % of the bound")
        del ops, v, pol
        torch.cuda.empty_cache()
    return errs


def phase_m2_nine_states(n=5):
    """M.2 (outside the counted run): the wide entries on the nine-state
    problem at n^9 (3 candidates), on the uniform grid and on a tanh grid of
    the same shape, against the plain version by compare_sweep's bars under
    both semantics; ms a sweep (CUDA graph of 100 launches), the plain
    version's (a loop of 10), the bound. Returns (max differences, {entry:
    the record of the kernels line})."""
    from c3sc_tpu_torch.ops import dense_backup as db

    prob = nine_states()
    errs, record, ms = dict.fromkeys(WIDE, 0.0), {}, {}
    for form, grid in (("uniform", prob.default_grid(n)), ("tanh", tanh_grid(prob, (n,) * 9))):
        ops = db.make_dense_operands(prob, grid, prob.control_candidates(3), DEVICE)
        label = f"{prob.name} {n}^9 {form}, {ops.uc.shape[0]} candidates"
        if not ops.general:
            raise AssertionError(f"{label}: nine states must take the general entries")
        v = torch.as_tensor(np.random.default_rng(0).uniform(0, 5, grid.shape),
                            dtype=torch.float32, device=DEVICE)
        before = db.launch_counts()
        for sem, (clip, pin) in (("Pallas", (prob.value_bounds, True)),
                                 ("dense_vi", (None, False))):
            e = compare_sweep(ops, v, clip, pin, f"{label}, {sem} semantics", tag="M.2")
            errs[WIDE[0]], errs[WIDE[1]] = max(errs[WIDE[0]], e[0]), max(errs[WIDE[1]], e[1])
        made = {k: c - before[k] for k, c in db.launch_counts().items()}
        if made[WIDE[0]] == 0 or made[WIDE[1]] == 0 or made[KERNELS[2]] or made[KERNELS[3]]:
            raise AssertionError(f"{label}: the sweeps launched {made}, not the wide entries")
        _, pol = db.dense_backup(ops, v, with_policy=True)
        calls = dict(backup_kernel=lambda: db.dense_backup(ops, v, with_policy=True),
                     backup_plain=lambda: db.dense_backup_reference(ops, v, with_policy=True),
                     evaluate_kernel=lambda: db.dense_evaluate(ops, v, pol),
                     evaluate_plain=lambda: db.dense_evaluate_reference(ops, v, pol))
        ms[form], eager = _kernel_and_plain_ms(calls, 10)
        table = 0 if grid.uniform else 4 * 5 * sum(grid.shape)
        bounds = _wide_bounds(ops, WIDE, table)
        log(f"[M.2] {label}: per-sweep ms (kernels: a CUDA graph of 100 launches; plain: a loop "
            "of 10 between one event pair): " + ", ".join(f"{k} {x:.4f}" for k, x in ms[form].items())
            + "; kernels as an eager loop of 100: "
            + ", ".join(f"{k} {x:.4f}" for k, x in eager.items()) + "; bounds "
            + json.dumps(bounds))
        for entry, key in zip(WIDE, ("backup", "evaluate")):
            b, t = bounds[entry]["bound_ms"], ms[form][key + "_kernel"]
            log(f"[M.2] {label}: {entry} {t:.4f} ms against its bound {b:.4f} ms "
                f"({bounds[entry]['bound_by']}): {100 * b / t:.1f} % of the bound")
            if form == "uniform":
                record[entry] = {"ms": t, "plain_ms": ms[form][key + "_plain"], "bound_ms": b,
                                 "bound_by": bounds[entry]["bound_by"]}
            else:
                record[entry].update(nonuniform_ms=t, nonuniform_bound_ms=b,
                                     nonuniform_uniform_ms=ms["uniform"][key + "_kernel"],
                                     nonuniform_at=label)
        del ops, v, pol, calls
        torch.cuda.empty_cache()
    phase_m2_twelve_states(record)
    return errs, record


def phase_m2_twelve_states(record, n=4):
    """M.2 at a second width: the same family on twelve states at n^12
    (16,777,216 nodes at n = 4, 3 candidates: fc and s2c 2.4 GB each), on
    the uniform grid and on a tanh grid of that shape. No plain version at
    this size (its [C, N, d, d] diffusion alone would take 29 GB): the
    improve's policy must equal gather_policy of its argmin, the evaluate
    under it must repeat the improve's value bit for bit, the values must be
    finite. ms a sweep (a CUDA graph of 100 launches) against the byte
    bound, into ``record`` under the twelve_* keys."""
    from c3sc_tpu_torch.ops import dense_backup as db

    prob = nine_states(12)
    for form, grid in (("uniform", prob.default_grid(n)),
                       ("tanh", tanh_grid(prob, (n,) * 12))):
        ops = db.make_dense_operands(prob, grid, prob.control_candidates(3), DEVICE)
        label = f"{prob.name} {n}^12 {form}, {ops.uc.shape[0]} candidates"
        v = torch.as_tensor(np.random.default_rng(0).uniform(0, 5, grid.shape),
                            dtype=torch.float32, device=DEVICE)
        before = db.launch_counts()
        kv, pol = db.dense_backup(ops, v, with_policy=True)
        ke = db.dense_evaluate(ops, v, pol)
        made = {k: c - before[k] for k, c in db.launch_counts().items()}
        if made[WIDE[0]] != 1 or made[WIDE[1]] != 1:
            raise AssertionError(f"{label}: the sweeps launched {made}, not the wide entries")
        if not (torch.isfinite(kv).all() and _policy_equal(pol, db.gather_policy(ops, pol.best))
                and torch.equal(ke, kv)):
            raise AssertionError(f"{label}: the wide kernels' improve, policy and evaluate "
                                 f"disagree")
        del kv, ke
        ms = {WIDE[0]: graph_ms(lambda: db.dense_backup(ops, v, with_policy=True)),
              WIDE[1]: graph_ms(lambda: db.dense_evaluate(ops, v, pol))}
        bounds = _wide_bounds(ops, WIDE, 0 if grid.uniform else 4 * 5 * sum(grid.shape))
        for entry, t in ms.items():
            b = bounds[entry]["bound_ms"]
            log(f"[M.2] {label}: {entry} {t:.4f} ms a sweep (CUDA graph of 100) against its "
                f"bound {b:.4f} ms ({bounds[entry]['bound_by']}): {100 * b / t:.1f} % of the "
                f"bound")
            pre = "twelve_" if form == "uniform" else "twelve_nonuniform_"
            record[entry].update({pre + "ms": t, pre + "bound_ms": b})
            record[entry]["twelve_at"] = f"{prob.name} {n}^12, {ops.uc.shape[0]} candidates"
        del ops, v, pol
        torch.cuda.empty_cache()


def phase_m_solves():
    """M on the main path (counted): dense_vi on the card against the CPU,
    within 1e-4 x max|v|: the du = 5 double integrator at 21^2 (243
    candidates) without and with its declarations (the general entries) and
    the nine-state problem at 3^9 (the wide entries)."""
    from c3sc_tpu_torch.solvers import dense_vi

    for prob, n in ((double_integrator_du5(), 21), (double_integrator_du5(True), 21),
                    (nine_states(), 3)):
        grid = prob.default_grid(n)
        uc = prob.control_candidates(3)
        sols = {dev: dense_vi(prob, grid, controls=uc, tol=1e-6, max_outer=2000, device=dev)
                for dev in (DEVICE, "cpu")}
        ref = sols["cpu"].v
        err = float((sols[DEVICE].v.cpu() - ref).abs().max() / ref.abs().max())
        log(f"[M] dense_vi {prob.name} {n}^{prob.dx} ({len(uc)} candidates): card against CPU "
            f"{err:.3e} x max|v| ({sols[DEVICE].sweeps} and {sols['cpu'].sweeps} sweeps, "
            f"residual {sols[DEVICE].residual:.2e})")
        if not (err <= PARITY_BAR and torch.isfinite(sols[DEVICE].v).all()):
            raise AssertionError(f"dense_vi of {prob.name} on the card differs from the CPU: "
                                 f"{err:.3e}")


def phase_m_kernels():
    """M.1 and M.2 (outside the counted run): (max differences, M.2's record)."""
    errs = phase_m1_five_controls()
    wide_errs, record = phase_m2_nine_states()
    return {**errs, **wide_errs}, record


def _entries():
    """K1's six entries by name: the wrappers that count their launches."""
    from c3sc_tpu_torch.ops import dense_backup as db

    return {name: getattr(db, name) for name in ALL_KERNELS}


def counted(label, fn, required=("dense_backup", "dense_evaluate"), totals=None):
    """Run one path of the main run with K1's launch counts (all six
    entries) set to 0 just before it and read just after; every kernel in
    ``required`` must have been launched. Adds the counts to ``totals``;
    returns fn()'s result."""
    for entry in _entries().values():
        entry.launches = 0
    out = fn()
    from c3sc_tpu_torch.ops import dense_backup as db

    made = db.launch_counts()
    log(f"[{label}] K1 launches in phase {label}: {made}")
    for name in required:
        if made[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by phase {label}")
    if totals is not None:
        for name, n in made.items():
            totals[name] += n
    return out


def main_fused_only():
    """Phases A, B and F, with phase D cut to its 9^6 solve (F.2 needs it)."""
    phase_a_environment()
    phase_b_build()
    phase_f_fused(phase_d_solve(sizes=(9,))[9])
    return 0


def main_control_only():
    """Phases A, B and G, with phase D cut to its 9^6 solve (G needs it)."""
    phase_a_environment()
    phase_b_build()
    v9 = phase_d_solve(sizes=(9,))[9]
    counted("G", lambda: phase_g_control(v9))
    return 0


def main_flagship_only(seed=0):
    """Phases A, B and H at the recipe's full depth for the recipe's
    ``seed``, with phase D cut to its 9^6 solve; H solves both fused bases
    itself and runs the recipe from the recipe's. H.1 (the committed seed-0
    fields) and the patch kernel's check on its sub-box run for seed 0 only."""
    phase_a_environment()
    phase_b_build()
    v9 = phase_d_solve(sizes=(9,))[9]
    if seed == 0:
        phase_graph_checks(parts=("H",))
    t0 = time.perf_counter()
    h1 = counted("H", lambda: phase_h_flagship(v9, cycles=6, n_mpc=256, seed=seed),
                 required=("dense_backup",))
    log(f"[timing] phase H {time.perf_counter() - t0:.1f} s")
    if h1 is not None:
        compare_patch_kernel(*h1)
    return 0


def main_models_only():
    """Phases A, B and I, with I.4 at the 7D recipe's full depth."""
    phase_a_environment()
    phase_b_build()
    t0 = time.perf_counter()
    phase_i1_kernels()
    phase_graph_checks(parts=("I",))
    counted("I", lambda: phase_i_models(full=True), required=KERNELS)
    log(f"[timing] phase I {time.perf_counter() - t0:.1f} s")
    return 0


def main_solvers_only():
    """Phases A, B and J at --phases J's depth, with phase D cut to its 9^6
    solve."""
    phase_a_environment()
    phase_b_build()
    phase_d_solve(sizes=(9,))
    t0 = time.perf_counter()
    counted("J", lambda: phase_j_solvers(full=True))
    log(f"[timing] phase J {time.perf_counter() - t0:.1f} s")
    return 0


def main_parallel_only():
    """Phases A, B, D at 9^6, F.2 (L's TT) and L."""
    phase_a_environment()
    phase_b_build()
    sol, _ = phase_f2_solve(phase_d_solve(sizes=(9,))[9])
    t0 = time.perf_counter()
    counted("L", lambda: phase_l_parallel(sol), required=())
    log(f"[timing] phase L {time.perf_counter() - t0:.1f} s")
    return 0


def main_entry_points_only():
    """Phases A, B and K at full depth (the documented quadcopter CLI run
    uncut)."""
    phase_a_environment()
    phase_b_build()
    t0 = time.perf_counter()
    phase_k1_kernels()
    counted("K", lambda: phase_k_entry_points(full=True))
    log(f"[timing] phase K {time.perf_counter() - t0:.1f} s")
    return 0


def main_wide_only():
    """Phases A, B and M."""
    phase_a_environment()
    phase_b_build()
    t0 = time.perf_counter()
    phase_m_kernels()
    counted("M", phase_m_solves, required=KERNELS[2:] + WIDE)
    log(f"[timing] phase M {time.perf_counter() - t0:.1f} s")
    return 0


USAGE = "usage: chip_smoke.py [--phases F | G | I | J | K | L | M | H [--seed N]]"


def main():
    modes = {"F": main_fused_only, "G": main_control_only, "H": main_flagship_only,
             "I": main_models_only, "J": main_solvers_only, "K": main_entry_points_only,
             "L": main_parallel_only, "M": main_wide_only}
    args = sys.argv[1:]
    if args:
        if len(args) not in (2, 4) or args[0] != "--phases" or args[1] not in modes:
            raise SystemExit(USAGE)
        if len(args) == 4:
            if args[1] != "H" or args[2] != "--seed" or not args[3].isdigit():
                raise SystemExit(USAGE)
            return main_flagship_only(seed=int(args[3]))
        return modes[args[1]]()
    marks = [("start", time.perf_counter())]
    phase_a_environment()
    phase_b_build()
    marks.append(("A+B", time.perf_counter()))
    errs, times, bounds = phase_c_kernel_vs_plain()
    phase_graph_checks()
    marks.append(("C", time.perf_counter()))
    # the main path's run, one path at a time: each counted() sets the counts
    # to 0 just before its path and reads them just after
    totals = dict.fromkeys(ALL_KERNELS, 0)

    def dense_path():
        values = phase_d_solve()
        return values, phase_e_rollouts(values[9])

    values, e_cost = counted("D+E", dense_path, totals=totals)
    marks.append(("D+E", time.perf_counter()))
    fused, f2_q95 = counted("F", lambda: phase_f_fused(values[9]), totals=totals)
    marks.append(("F", time.perf_counter()))
    counted("G", lambda: phase_g_control(values[9], e_cost, f2_q95), totals=totals)
    marks.append(("G", time.perf_counter()))
    h1 = counted("H", lambda: phase_h_flagship(values[9], fused=fused), totals=totals,
                 required=("dense_backup",))
    marks.append(("H", time.perf_counter()))
    errs["dense_backup"] = max(errs["dense_backup"], compare_patch_kernel(*h1))
    i_errs, gen_times, gen_bounds = phase_i1_kernels()
    counted("I", phase_i_models, totals=totals, required=KERNELS)
    marks.append(("I", time.perf_counter()))
    counted("J", phase_j_solvers, totals=totals)
    marks.append(("J", time.perf_counter()))
    k_errs, nonuniform = phase_k1_kernels()
    nu_launches = counted("K", phase_k_entry_points, totals=totals)
    marks.append(("K", time.perf_counter()))
    # phase L (parallel/) reaches no K1 entry: its counts are read and logged, none required
    counted("L", lambda: phase_l_parallel(fused), totals=totals, required=())
    marks.append(("L", time.perf_counter()))
    m_errs, wide = phase_m_kernels()
    counted("M", phase_m_solves, totals=totals, required=KERNELS[2:] + WIDE)
    marks.append(("M", time.perf_counter()))
    errs = {name: max(errs.get(name, 0.0), i_errs.get(name, 0.0), k_errs.get(name, 0.0),
                      m_errs.get(name, 0.0)) for name in ALL_KERNELS}
    launches = totals
    log(f"[M] K1 launches from phase D through M: {launches}")
    log("[timing] seconds by phase: " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}" for i, (name, t) in enumerate(marks[1:]))
        + f", total {time.perf_counter() - marks[0][1]:.1f}")
    # times and bounds of the structured entries at the 11^6 quadcopter with 25
    # candidates, of the general ones at the 41^4 glider with 9; no single
    # PyTorch call computes any of these sweeps, so there is no library time.
    # The nonuniform_* keys: K.1's times on tanh grids (the quadcopter 11^6, the
    # glider (15, 11, 11, 11)) beside the uniform grid of the same shape, and
    # the launches of K.1's non-uniform solves on the main path. The wide
    # entries' times and bounds are M.2's, at the nine-state problem's 5^9 with
    # 3 candidates, and its tanh grid's beside them
    at = {"dense_backup": (times[11], bounds[11]), "dense_evaluate": (times[11], bounds[11]),
          "dense_backup_general": (gen_times, gen_bounds),
          "dense_evaluate_general": (gen_times, gen_bounds)}
    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": at[name][0][key + "_kernel"], "plain_ms": at[name][0][key + "_plain"],
         "bound_ms": at[name][1][name]["bound_ms"], "bound_by": at[name][1][name]["bound_by"],
         "library_ms": None, **nonuniform[name], "nonuniform_launches": nu_launches[name]}
        for name, key, replaces in (
            ("dense_backup", "backup", "c3sc_tpu/ops/pallas_dense.py:107"),
            ("dense_evaluate", "evaluate", "c3sc_tpu/solvers/dense.py:122"),
            ("dense_backup_general", "backup", "c3sc_tpu/ops/pallas_dense.py:107"),
            ("dense_evaluate_general", "evaluate", "c3sc_tpu/solvers/dense.py:122"))
    ] + [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name], **wide[name],
         "library_ms": None, "nonuniform_launches": nu_launches[name]}
        for name, replaces in ((WIDE[0], "c3sc_tpu/ops/pallas_dense.py:107"),
                               (WIDE[1], "c3sc_tpu/solvers/dense.py:122"))
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
