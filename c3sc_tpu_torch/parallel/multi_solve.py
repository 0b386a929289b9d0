"""Batched independent solves, the batch split over a mesh axis ("solves/s")
— port of ``c3sc_tpu/parallel/multi_solve.py``.

JAX runs a batch of independent fused VI solves (different pivot seeds) as
ONE vmapped program with the batch axis sharded over devices. The port runs
each rank's instances one after the other through the single-instance
solver (one solver, so under ``cuda_graph`` one captured iteration serves
them all). Each instance ends where it would alone, as under JAX's vmapped
``while_loop``, whose stopped instances keep their state until the last one
stops. A batched carry through the fused blocks (one launch for all
instances) is a performance change that is not made here.

Seeds are ints: a JAX key ``k`` reaches the port as ``key_data(k)[-1]``, as
``init_fn`` takes it. Results are stacked ``FusedCarry``s whose leading axis
is the instance, as JAX's are.
"""

from __future__ import annotations

from typing import Sequence

import torch

from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.parallel.mesh import block, check_device, gather_rows, mesh_device
from c3sc_tpu_torch.solvers.fused import FusedCarry, make_fused_vi


def stack_carries(carries: Sequence[FusedCarry]) -> FusedCarry:
    """One carry whose every field has the instances on a new leading axis."""
    out = []
    for fields in zip(*carries):
        if isinstance(fields[0], tuple):
            out.append(tuple(torch.stack(cs) for cs in zip(*fields)))
        else:
            out.append(torch.stack(fields))
    return FusedCarry(*out)


def unstack_carry(stacked: FusedCarry, lo: int = 0, hi: int | None = None) -> list:
    """Instances ``lo..hi-1`` of a stacked carry as a list of carries."""
    hi = stacked.it.shape[0] if hi is None else hi
    return [FusedCarry(*(tuple(c[i] for c in f) if isinstance(f, tuple) else f[i]
                         for f in stacked))
            for i in range(lo, hi)]


def _gather_instances(stacked: FusedCarry, mesh, axis: str) -> FusedCarry:
    """Every rank's instances along ``axis``, in rank order: the whole batch."""
    if mesh is None:
        return stacked
    return FusedCarry(*(tuple(gather_rows(c, mesh, axis) for c in f) if isinstance(f, tuple)
                        else gather_rows(f, mesh, axis) for f in stacked))


def _batch_solver(problem, grid, controls, rmax, mesh, device, fused_kwargs):
    """The fused solver of every instance: on the mesh's device where a mesh
    is given, graphed on CUDA unless the caller says or a probe forbids it."""
    if mesh is None:
        device = resolve_device(device)
    else:
        device = mesh_device(mesh) if device is None else torch.device(device)
        check_device(mesh, device)
    kw = dict(fused_kwargs)
    kw.setdefault("cuda_graph", device.type == "cuda" and kw.get("probe_rollouts", 0) == 0)
    return make_fused_vi(problem, grid, controls, rmax=rmax, device=device, **kw)


def solve_batch(problem: ControlProblem, grid: Grid, controls, seeds, rmax: int = 16,
                mesh=None, axis: str = "fibers", device=None, **fused_kwargs) -> FusedCarry:
    """Run ``len(seeds)`` independent fused VI solves; returns the stacked
    final carry (leading axis = instance) on every rank.

    With a mesh, rank r takes instances ``[r N/F, (r+1) N/F)`` of the
    ``F`` ranks along ``axis`` (N must divide by F) and the stacks are
    gathered at the end; ranks that differ only along other axes repeat the
    same instances. Each instance reads its stopping state on the host
    once per chunk of ``window`` iterations. ``device=None``: the
    mesh's device, or the default CUDA device without a mesh."""
    solver = _batch_solver(problem, grid, controls, rmax, mesh, device, fused_kwargs)
    seeds = [int(s) for s in seeds]
    lo, hi = (0, len(seeds)) if mesh is None else block(mesh, axis, len(seeds), "instances")
    out = [solver.solve_fn(solver.init_fn(s)) for s in seeds[lo:hi]]
    return _gather_instances(stack_carries(out), mesh, axis)


def make_batch_stepper(problem: ControlProblem, grid: Grid, controls, rmax: int = 16,
                       mesh=None, axis: str = "fibers", device=None, **fused_kwargs):
    """Fixed-iteration batched fused-VI stepper for throughput measurements.

    Unlike ``solve_batch`` (lockstep until the LAST instance stops), this
    runs an exact number of iterations per instance, so wall time measures
    pure throughput: the basis of the solves/s metric. Returns
    ``(init, step)``:

      init(seeds [N]) -> stacked FusedCarry of all N instances
      step(stacked, n_iters) -> stacked: every instance n_iters iterations on,
                                the rank's block along ``axis`` computed
                                here, the rest gathered from the other ranks
    """
    solver = _batch_solver(problem, grid, controls, rmax, mesh, device,
                           dict(fused_kwargs, tol=0.0, max_iters=10**9))

    def init(seeds) -> FusedCarry:
        return stack_carries([solver.init_fn(int(s)) for s in seeds])

    def step(stacked: FusedCarry, n_iters: int) -> FusedCarry:
        n = stacked.it.shape[0]
        lo, hi = (0, n) if mesh is None else block(mesh, axis, n, "instances")
        out = [solver.step_fn(c, n_iters) for c in unstack_carry(stacked, lo, hi)]
        return _gather_instances(stack_carries(out), mesh, axis)

    return init, step
