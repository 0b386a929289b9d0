"""Local dense completion: an exact sub-grid solve around the operating
point — port of ``c3sc_tpu/solvers/local_patch.py``.

The TT value stays the global solution; on a sub-box of grid nodes around the
operating point (the hover basin) a dense value iteration of the SAME
discrete Bellman operator (same nodes, spacing and stencil) runs with the TT
values pinned on the sub-box faces. Interior values converge to the exact
discrete solution given that boundary data; boundary error enters only
through discounted first passage to the faces.

The sweeps are kernel K1's improve sweep (``ops/dense_backup.dense_backup``,
``csrc/dense_backup.cu`` on a CUDA device, its plain version on the CPU)
with the patch's own terminal mask: the sub-box faces pinned to the TT data,
and interior obstacle or goal nodes pinned as the parent operator pins them.
A sub-box that is not uniform (a slice of a periodic dimension's nodes is
not, through float rounding alone) runs K1's non-uniform stencil. On a CUDA
device a sweep is one CUDA graph, captured once and replayed
(``solvers.dense.GraphedSweeps``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops.dense_backup import dense_backup, make_dense_operands
from c3sc_tpu_torch.ops.interp import multilinear_interp
from c3sc_tpu_torch.ops.tt import tt_gather_eval, tt_lerp_eval
from c3sc_tpu_torch.solvers.dense import sweep_runner


@dataclasses.dataclass
class LocalPatch:
    subgrid: Grid
    v: torch.Tensor         # [*subgrid.shape] patch values (faces = TT data)
    lo: tuple               # per-dim first node index in the parent grid
    hi: tuple               # per-dim last node index (inclusive)
    residual: float
    sweeps: int


def default_patch_bounds(grid: Grid, margin: int = 2):
    """Central sub-box: drop ``margin`` nodes from each side per dim."""
    lo = tuple(margin for _ in grid.shape)
    hi = tuple(n - 1 - margin for n in grid.shape)
    assert all(h - l >= 2 for l, h in zip(lo, hi)), "patch too small"  # noqa: E741
    return lo, hi


def patch_subgrid(grid: Grid, lo: Sequence[int], hi: Sequence[int]) -> Grid:
    """The sub-box [lo, hi] (node indices, inclusive) of ``grid`` as a grid of
    its own, on the same nodes (non-periodic in every dim)."""
    sub_shape = tuple(h - l + 1 for l, h in zip(lo, hi))  # noqa: E741
    sub_nodes = [grid.nodes(k)[lo[k]:hi[k] + 1] for k in range(grid.ndim)]
    return Grid.create(tuple(float(nk[0]) for nk in sub_nodes),
                       tuple(float(nk[-1]) for nk in sub_nodes), sub_shape,
                       periodic=(False,) * grid.ndim, nodes=sub_nodes)


def make_patch_operands(problem: ControlProblem, grid: Grid, value_fn: Callable, controls,
                        lo: Sequence[int], hi: Sequence[int], device=None):
    """The sweep operands of the sub-box [lo, hi] of ``grid`` and its face
    data: (``DenseOperands`` on the subgrid, v0 [N] = ``value_fn`` at the
    subgrid's nodes), on ``device`` (None: the default CUDA device).

    The terminal mask and values are the patch's own: the faces of the
    SUB-BOX carry the TT data (they are not the problem's absorbing faces
    that ``mca.node_terminal`` would make of them), and interior obstacle or
    goal nodes keep the parent operator's pinning. Both tensors are
    contiguous, as kernel K1 needs them.
    """
    device = resolve_device(device)
    assert all(l >= 1 and h <= n - 2 for l, h, n in zip(lo, hi, grid.shape))  # noqa: E741
    subgrid = patch_subgrid(grid, lo, hi)
    if grid.uniform:
        assert np.allclose(subgrid.h, grid.h), (subgrid.h, grid.h)
    ops = make_dense_operands(problem, subgrid, controls, device)
    idx = subgrid.node_indices(device)
    face = torch.zeros(idx.shape[0], dtype=torch.bool, device=device)
    for k, n in enumerate(subgrid.shape):
        face |= (idx[:, k] == 0) | (idx[:, k] == n - 1)
    in_obs = problem.in_obstacle(ops.x)
    v0 = value_fn(ops.x).to(torch.float32)                 # TT data everywhere
    ops = dataclasses.replace(
        ops, t_mask=(face | in_obs).contiguous(),
        t_val=torch.where(in_obs, problem.obstacle_cost(ops.x).to(torch.float32),
                          v0).contiguous())
    return ops, v0


def solve_local_patch(
    problem: ControlProblem,
    grid: Grid,
    value_fn: Callable,
    controls,
    lo: Sequence[int] | None = None,
    hi: Sequence[int] | None = None,
    margin: int = 2,
    tol: float = 1e-5,
    max_sweeps: int = 2000,
    chunk: int = 50,
    device=None,
    cuda_graph: bool | None = None,
) -> LocalPatch:
    """Dense VI on the sub-box [lo, hi] (node indices, inclusive) of the
    parent grid, faces pinned to ``value_fn`` (the TT solve; points [B, d]
    -> [B] on ``device``), on ``device`` (None: the default CUDA device).

    The sub-box must not touch the parent grid's boundary and must not wrap
    a periodic dim. Sweeps run ``chunk`` at a time; after each chunk the
    host reads the last sweep's max |dv| once, and the solve stops when it
    is below ``tol`` or after ``max_sweeps``. ``cuda_graph`` is
    ``dense.make_dense_step``'s: on a CUDA device every sweep replays one
    CUDA graph unless it is False (True on the CPU raises ValueError).
    """
    if lo is None or hi is None:
        lo, hi = default_patch_bounds(grid, margin)
    lo, hi = tuple(lo), tuple(hi)
    ops, v0 = make_patch_operands(problem, grid, value_fn, controls, lo, hi, device)
    subgrid = ops.grid
    # clip=None, pin_input=False
    run = sweep_runner(lambda v: dense_backup(ops, v)[0], ops, cuda_graph)
    v = v0.reshape(subgrid.shape).contiguous()
    res = float("inf")
    done = 0
    with torch.no_grad():
        while done < max_sweeps:
            v, delta = run(v, chunk)
            res = float(delta)
            done += chunk
            if res < tol:
                break
    return LocalPatch(subgrid=subgrid, v=v, lo=lo, hi=hi, residual=res, sweeps=done)


def make_patch_node_value_fn(patch: LocalPatch):
    """``node_value_fn(v_tt, idx [B, d] int) -> [B]``: the TT gather with the
    patch's dense values substituted inside its sub-box (the two-level
    composite field at grid nodes)."""
    dev = patch.v.device
    lo = torch.as_tensor(patch.lo, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(patch.hi, dtype=torch.int64, device=dev)
    sub_shape = patch.subgrid.shape
    top = torch.as_tensor(sub_shape, dtype=torch.int64, device=dev) - 1
    strides = np.cumprod((sub_shape[1:] + (1,))[::-1])[::-1].copy()
    strides = torch.as_tensor(strides, dtype=torch.int64, device=dev)
    v_flat = patch.v.reshape(-1)

    def node_value_fn(v_tt, idx):
        v = tt_gather_eval(v_tt, idx)
        inside = torch.all((idx >= lo) & (idx <= hi), dim=-1)
        local = torch.minimum(torch.clamp(idx - lo, min=0), top)
        return torch.where(inside, v_flat[torch.sum(local * strides, dim=-1)], v)

    return node_value_fn


@dataclasses.dataclass
class TwoLevelResult:
    v: object                   # final TT (polish result)
    patch: LocalPatch
    history: list               # per-cycle polish/patch stats


def two_level_solve(
    problem: ControlProblem,
    grid: Grid,
    controls,
    v0,
    rmax: int = 64,
    cycles: int = 2,
    cycle_schedule=((10, 64),),
    margin: int = 1,
    patch_tol: float = 1e-5,
    generator: torch.Generator | None = None,
    verbose: bool = False,
    cuda_graph: bool | None = None,
    **polish_kwargs,
):
    """Two-level TT + local-patch iteration, on the device of ``v0``:

        patch  <- dense VI on the sub-box, Dirichlet faces from the TT
        TT     <- two-site polish of T(composite), composite = TT (+) patch

    The polish target is the Bellman backup of the composite field, so the
    TT's values at the patch ring are refreshed from accurate patch-interior
    neighbours, which improves the next patch's face data. The final
    composite is the production value field. ``generator`` draws the polish's
    cross index sets where the JAX package folds its key (None: a CPU
    generator seeded 0). ``cuda_graph`` is the patch solves'.
    """
    from c3sc_tpu_torch.solvers.polish import tt_polish
    from c3sc_tpu_torch.solvers.ttvi import make_bellman_kernel

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dev = v0.cores[0].device
    v_tt = v0
    state = None
    history = []

    def patch_of(v_tt):
        return solve_local_patch(problem, grid, lambda p: tt_lerp_eval(v_tt, grid, p), controls,
                                 margin=margin, tol=patch_tol, device=dev,
                                 cuda_graph=cuda_graph)

    patch = patch_of(v_tt)
    for cycle in range(cycles):
        kernel = make_bellman_kernel(problem, grid, controls,
                                     chunk=polish_kwargs.get("chunk", 32768),
                                     node_value_fn=make_patch_node_value_fn(patch))
        psol = tt_polish(problem, grid, controls, v_tt, rmax=rmax, schedule=cycle_schedule,
                         kernel=kernel, state=state, generator=generator, **polish_kwargs)
        v_tt, state = psol.v, psol.state
        patch = patch_of(v_tt)
        rec = {"cycle": cycle, "patch_res": patch.residual, "patch_sweeps": patch.sweeps,
               "polish_best": psol.best_step,
               "bres": [h.get("bres") for h in psol.history if "bres" in h]}
        history.append(rec)
        if verbose:
            print(f"[two_level] cycle={cycle} bres={rec['bres']}", flush=True)
    return TwoLevelResult(v=v_tt, patch=patch, history=history)


def make_patched_value_fn(grid: Grid, value_fn: Callable, patch: LocalPatch):
    """Continuous value: the dense patch inside its sub-box, ``value_fn``
    outside. The patch faces carry the TT data, so the piecewise-multilinear
    field is continuous across the seam."""
    dev = patch.v.device
    sub_lb = torch.as_tensor(patch.subgrid.lb, dtype=torch.float32, device=dev)
    sub_ub = torch.as_tensor(patch.subgrid.ub, dtype=torch.float32, device=dev)

    def vfn(p):
        inside = torch.all((p >= sub_lb) & (p <= sub_ub), dim=-1)
        v_loc = multilinear_interp(patch.subgrid, patch.v,
                                   torch.minimum(torch.maximum(p, sub_lb), sub_ub))
        return torch.where(inside, v_loc, value_fn(p))

    return vfn
