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
declarations and the sweep recomputes the stencil.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops.dense_backup import (  # noqa: F401  (neighbor_values re-exported)
    dense_backup, dense_evaluate, make_dense_operands, neighbor_values)


@dataclasses.dataclass
class DenseSolution:
    v: torch.Tensor           # [*grid.shape] value at nodes
    residual: float           # final sup-norm sweep residual
    sweeps: int               # outer sweeps executed
    residual_history: list    # residual after each outer chunk
    controls: np.ndarray      # [C, du] candidate set used
    floored: bool = False     # stopped at the f32 residual floor, not tol


def make_dense_step(problem: ControlProblem, grid: Grid, controls, device=None,
                    eval_sweeps: int = 10):
    """Build the outer-sweep function on ``device`` (None: the default CUDA
    device).

    Returns (step, init_v) where step(v, n_outer) runs n_outer modified-PI
    sweeps and returns (v_new, residual_of_last_sweep) — the residual as a
    0-d tensor, so a chunk of sweeps runs without a host sync.
    """
    ops = make_dense_operands(problem, grid, controls, device)

    def one_outer(v):
        # improve (argmin over candidates), then evaluate under that policy;
        # JAX's improve neither clips nor pins its input
        vnew, best = dense_backup(ops, v)
        for _ in range(eval_sweeps):
            vnew = dense_evaluate(ops, vnew, best)
        return vnew

    def step(v, n_outer: int):
        res = torch.tensor(float("inf"), device=v.device)
        for i in range(n_outer):
            vnew = one_outer(v)
            if i == n_outer - 1:
                res = torch.max(torch.abs(vnew - v))
            v = vnew
        return v, res

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
) -> DenseSolution:
    """Solve the MCA Bellman equation on the full grid, on ``device`` (None:
    the default CUDA device; without one torch raises).

    Outer sweeps run in chunks; convergence when the sup-norm change of one
    outer sweep < tol, or the plateau stop at the f32 residual floor.
    """
    if controls is None:
        controls = problem.control_candidates(n_controls)
    step, init_v = make_dense_step(problem, grid, controls, device, eval_sweeps)
    v = init_v if v0 is None else torch.as_tensor(
        v0, dtype=torch.float32, device=init_v.device).reshape(grid.shape).contiguous()
    history = []
    done = 0
    best_res, stall = float("inf"), 0
    floored = False
    res = float("inf")
    while done < max_outer:
        n = min(chunk, max_outer - done)
        v, res = step(v, n)
        res = float(res)
        done += n
        history.append(res)
        if verbose:
            print(f"[dense_vi:{problem.name}] outer={done} residual={res:.3e}")
        if res < tol:
            break
        # plateau stop: in f32 the sup-norm residual bottoms out at the value
        # scale's quantization floor and never reaches a tighter tol — stop
        # once it stops improving, but only near that floor (or near tol), so
        # a weakly discounted problem that improves slowly keeps going.
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
                 refine_steps: int = 0):
    """Greedy policy u*(node) = argmin_u Bellman RHS against a dense v.

    Returns u [*grid.shape, du] on ``device`` (None: the default CUDA
    device). ``refine_steps > 0`` (continuous polishing
    of the brute-force winner) needs ``solvers/ttvi.refine_controls``, which
    is not ported yet.
    """
    if refine_steps > 0:
        raise NotImplementedError("dense_policy refine_steps > 0 needs "
                                  "solvers/ttvi.refine_controls (not ported yet)")
    ops = make_dense_operands(problem, grid, controls, device)
    v = torch.as_tensor(v, dtype=torch.float32, device=ops.x.device).contiguous()
    _, best = dense_backup(ops, v)
    return ops.uc[best.long()].reshape(*grid.shape, problem.du)
