"""Dense-grid value iteration — the correctness oracle (no TT). Port of
``c3sc_tpu/solvers/dense.py``.

A full-grid Markov-chain-approximation Bellman solve by *modified policy
iteration*: each outer sweep does one argmin over the control candidates
(improve) and ``eval_sweeps`` fixed-policy backups (evaluate). Both sweeps
are kernel K1 (``ops/dense_backup.py``): on a CUDA device they launch the
hand-written kernel, on the CPU they run its plain PyTorch version. The
solve runs on the CUDA device unless the caller passes ``device="cpu"``.

The JAX package's ``_precompute`` stores the stencil of every candidate as
[C, N, d] tensors; here ``make_dense_operands`` keeps only the x-only
declarations and the sweep recomputes the stencil. A problem without all
five declarations (the glider) keeps its per-candidate drift [C, d, N]
instead, and on CUDA its sweeps run K1's general entries
(``dense_backup_general``, ``dense_evaluate_general``), to which
``dense_backup`` and ``dense_evaluate`` route its operands. As in JAX's
``one_outer``, the evaluate sweeps run under the policy that the improve
returns (``DensePolicy``: for general operands the winning candidate's
operands, written by the improve kernel's epilogue, which is what JAX's
``gather_policy`` gathers).

The JAX package runs a chunk of outer sweeps as one jitted ``fori_loop``;
here, on a CUDA device, an outer sweep is captured once as a CUDA graph
(``GraphedSweeps``) and replayed, so that the host launches one graph an
outer sweep instead of ``eval_sweeps + 1`` kernels.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops.dense_backup import (add_launches, dense_backup, dense_evaluate,
                                             launch_counts, make_dense_operands,
                                             neighbor_values, preload)
from c3sc_tpu_torch.solvers.ttvi import refine_controls
from c3sc_tpu_torch.utils.metrics import span


@dataclasses.dataclass
class DenseSolution:
    v: torch.Tensor           # [*grid.shape] value at nodes
    residual: float           # final sup-norm sweep residual
    sweeps: int               # outer sweeps executed
    residual_history: list    # residual after each outer chunk
    controls: np.ndarray      # [C, du] candidate set used
    floored: bool = False     # stopped at the f32 residual floor, not tol


def eager_sweeps(body, v, n: int):
    """``n`` sweeps of ``body(v) -> v_new`` in a Python loop: (v_n, the last
    sweep's max |v_n - v_(n-1)| as a 0-d tensor, so no host sync)."""
    if n < 1:
        return v, torch.tensor(float("inf"), device=v.device)
    for i in range(n):
        vnew = body(v)
        if i == n - 1:
            res = torch.max(torch.abs(vnew - v))
        v = vnew
    return v, res


_CAPTURE = {}   # torch.device -> (pool, side stream, anchor graph) of every capture there


def _capture_pool_and_stream(dev):
    """The memory pool into which every ``GraphedSweeps`` on ``dev``
    captures, and the side stream it captures on. A capture takes fresh
    device memory (cudaMalloc, milliseconds) for what its graph allocates
    unless its pool holds free blocks of its stream: with one pool and one
    stream, a solve's second graph reuses what its first freed, and a later
    solve what an earlier solve's graphs freed. Their scratch may overlap
    because the graphs replay on one stream and what a ``GraphedSweeps``
    keeps in the pool between calls (the residual) is rewritten by its next
    call before it is read. A pool lives while a graph captured into it
    does (PyTorch's allocators refuse to capture into a pool whose graphs
    are all gone), so a one-kernel anchor graph is kept for each device."""
    if dev not in _CAPTURE:
        pool, side, anchor = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev), \
            torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            anchor.capture_begin(pool=pool)
            try:
                torch.zeros(1, device=dev)
            finally:
                anchor.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        _CAPTURE[dev] = (pool, side, anchor)
    return _CAPTURE[dev][:2]


class GraphedSweeps:
    """``eager_sweeps`` as CUDA graphs of one sweep: ``body(v) -> v_new`` on
    a dense v is captured at the first call on a static copy of v, once
    alone and once with the residual, and a call of ``n`` sweeps replays the
    first graph n - 1 times and the second once. One copy in, n replays, one
    copy out; the host launches one graph a sweep instead of every kernel of
    it, and any n (``dense_vi``'s shorter last chunk) replays the same two
    graphs. Bit-equal to ``eager_sweeps``.

    Before the capture ``preload(ops)`` loads K1's kernels (with lazy module
    loading a kernel is otherwise loaded at its first launch, which should
    not happen inside a capture) and the residual's own kernels run once on
    scratch, off the capture. A capture that fails raises; nothing runs the
    sweeps eagerly instead. K1's launch counts are Python increments, which a
    replay does not make: the increments made while capturing (which
    launched nothing) are taken back, and every replay adds them once. The
    tensors the body allocates come from ``_capture_pool_and_stream``'s
    pool, once, at the capture; the static v does not.
    ``GraphedSweeps.captures`` counts the graphs captured in this process and
    ``capture_seconds`` sums their host time (preload and capture).
    """

    captures = 0
    capture_seconds = 0.0

    def __init__(self, body, ops):
        if ops.x.device.type != "cuda":
            raise ValueError(f"cuda_graph=True needs a CUDA device, not {ops.x.device}")
        self.body, self.ops = body, ops
        self.graphs = None

    def _capture(self, v):
        t0 = time.perf_counter()
        dev = v.device
        preload(self.ops)
        self.v = v.clone()
        pool, side = _capture_pool_and_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graphs, self.per_replay = [], []
        with torch.cuda.stream(side):
            torch.max(torch.abs(self.v - self.v))
            for with_residual in (False, True):
                graph = torch.cuda.CUDAGraph()
                before = launch_counts()
                # capture_begin, not torch.cuda.graph(): that one first
                # synchronizes and empties the allocator's cache
                graph.capture_begin(pool=pool)
                try:
                    out = self.body(self.v)
                    if with_residual:
                        self.res = torch.max(torch.abs(out - self.v))
                    self.v.copy_(out)
                    del out   # free for the next capture to reuse
                finally:
                    graph.capture_end()
                    after = launch_counts()
                    made = {k: after[k] - before[k] for k in after}
                    add_launches(made, -1)
                graphs.append(graph)
                self.per_replay.append(made)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graphs = graphs
        GraphedSweeps.captures += len(graphs)
        GraphedSweeps.capture_seconds += time.perf_counter() - t0

    def __call__(self, v, n: int):
        if n < 1:
            return v, torch.tensor(float("inf"), device=v.device)
        if self.graphs is None:
            with span("dense.capture", device=False):
                self._capture(v)
        self.v.copy_(v)
        sweep, last = self.graphs
        for _ in range(n - 1):
            sweep.replay()
        last.replay()
        add_launches(self.per_replay[0], n - 1)
        add_launches(self.per_replay[1])
        return self.v.clone(), self.res.clone()


def sweep_runner(body, ops, cuda_graph: bool | None):
    """``run(v, n) -> (v_n, residual)`` for ``body`` on ``ops``' device:
    ``GraphedSweeps`` where ``cuda_graph`` is True, or None on a CUDA device;
    ``eager_sweeps`` where it is False, or None on the CPU. True on the CPU
    raises ValueError."""
    if cuda_graph is None:
        cuda_graph = ops.x.device.type == "cuda"
    if cuda_graph:
        return GraphedSweeps(body, ops)
    return lambda v, n: eager_sweeps(body, v, n)


def make_dense_step(problem: ControlProblem, grid: Grid, controls, device=None,
                    eval_sweeps: int = 10, cuda_graph: bool | None = None):
    """Build the outer-sweep function on ``device`` (None: the default CUDA
    device).

    Returns (step, init_v) where step(v, n_outer) runs n_outer modified-PI
    sweeps and returns (v_new, residual_of_last_sweep) — the residual as a
    0-d tensor, so a chunk of sweeps runs without a host sync.

    ``cuda_graph`` (``sweep_runner``): None runs an outer sweep as a CUDA
    graph, captured at the first call and replayed, on a CUDA device and the
    eager loop on the CPU; True or False forces one or the other (True on
    the CPU raises ValueError). The two are bit-equal.
    """
    with span("dense.operands", device=False):
        ops = make_dense_operands(problem, grid, controls, device)

    def one_outer(v):
        # improve (argmin over candidates), then evaluate under that policy;
        # JAX's improve neither clips nor pins its input
        vnew, policy = dense_backup(ops, v, with_policy=True)
        for _ in range(eval_sweeps):
            vnew = dense_evaluate(ops, vnew, policy)
        return vnew

    step = sweep_runner(one_outer, ops, cuda_graph)
    init_v = torch.where(ops.t_mask, ops.t_val,
                         torch.zeros_like(ops.t_val)).reshape(grid.shape)
    return step, init_v


def dense_vi(
    problem: ControlProblem,
    grid: Grid,
    controls=None,
    n_controls: int = 11,
    tol: float = 1e-5,
    max_outer: int = 2000,
    chunk: int = 50,
    eval_sweeps: int = 10,
    device=None,
    v0=None,
    verbose: bool = False,
    cuda_graph: bool | None = None,
) -> DenseSolution:
    """Solve the MCA Bellman equation on the full grid, on ``device`` (None:
    the default CUDA device; without one torch raises).

    Outer sweeps run in chunks; convergence when the sup-norm change of one
    outer sweep < tol, or the plateau stop at the f32 residual floor.
    ``cuda_graph`` is ``make_dense_step``'s: on a CUDA device every outer
    sweep replays one CUDA graph unless it is False.

    Spans (``utils.metrics``, host time only): ``dense_vi`` around the
    solve, and inside it ``dense.operands`` (``make_dense_operands``),
    ``dense.sweeps`` (a chunk; the first holds the graphs' capture,
    ``dense.capture``) and ``dense.read`` (each read of the device on the
    host).
    """
    with span("dense_vi", device=False):
        if controls is None:
            controls = problem.control_candidates(n_controls)
        step, init_v = make_dense_step(problem, grid, controls, device, eval_sweeps, cuda_graph)
        v = init_v if v0 is None else torch.as_tensor(
            v0, dtype=torch.float32, device=init_v.device).reshape(grid.shape).contiguous()
        history = []
        done = 0
        best_res, stall = float("inf"), 0
        floored = False
        res = float("inf")
        while done < max_outer:
            n = min(chunk, max_outer - done)
            with span("dense.sweeps", device=False):
                v, res = step(v, n)
            with span("dense.read", device=False):
                res = float(res)
            done += n
            history.append(res)
            if verbose:
                print(f"[dense_vi:{problem.name}] outer={done} residual={res:.3e}")
            if res < tol:
                break
            # plateau stop: in f32 the sup-norm residual bottoms out at the
            # value scale's quantization floor and never reaches a tighter
            # tol — stop once it stops improving, but only near that floor
            # (or near tol), so a weakly discounted problem that improves
            # slowly keeps going.
            with span("dense.read", device=False):
                scale = float(torch.max(torch.abs(v)))
            floor_gate = max(100.0 * np.finfo(np.float32).eps * scale, 100.0 * tol)
            if res < best_res * 0.99:
                best_res, stall = res, 0
            elif res < floor_gate:
                stall += 1
                if stall >= 3:
                    floored = True
                    if verbose:
                        print(f"[dense_vi:{problem.name}] residual floor "
                              f"{res:.3e} (no improvement for {stall} chunks)")
                    break
    return DenseSolution(v=v, residual=res, sweeps=done, residual_history=history,
                         controls=np.asarray(controls), floored=floored)


def dense_policy(problem: ControlProblem, grid: Grid, v, controls, device=None,
                 refine_steps: int = 0, refine_method: str = "pgd"):
    """Greedy policy u*(node) = argmin_u Bellman RHS against a dense v.

    Returns u [*grid.shape, du] on ``device`` (None: the default CUDA
    device). The argmin is K1's improve sweep. ``refine_steps > 0`` polishes
    the winner at every node with that many batched projected-gradient
    (``refine_method='pgd'``) or L-BFGS (``'lbfgs'``) steps of the
    continuous right-hand side under the control box.
    """
    ops = make_dense_operands(problem, grid, controls, device)
    v = torch.as_tensor(v, dtype=torch.float32, device=ops.x.device).contiguous()
    f0, best = dense_backup(ops, v)
    u = ops.uc[best.long()]
    if refine_steps > 0:
        # a dense v is already pinned at terminal nodes, so its neighbour
        # values need no pinning; f0 (pinned there) only bounds the
        # returned objective, which is not returned
        vp, vm = neighbor_values(v.reshape(grid.shape), grid)
        u, _ = refine_controls(problem, grid, ops.x, torch.stack([vp, vm], dim=1), u,
                               f0.reshape(-1), refine_steps, refine_method)
    return u.reshape(*grid.shape, problem.du)
