"""Whole-grid dense Bellman sweep v -> T v — kernel K1 of the port.

Counterpart of ``c3sc_tpu/ops/pallas_dense.py`` (the Pallas TPU kernel
``make_pallas_dense_backup``) and of the ``improve``/``evaluate`` sweeps of
``c3sc_tpu/solvers/dense.py::make_dense_step``. On a CUDA tensor the
wrappers launch the hand-written kernel in ``csrc/dense_backup.cu``; on a
CPU tensor they run the plain PyTorch version, which computes the same math
through ``mca.transition_all_controls`` and ``mca.stage_cost_all``. There is
no fallback from one to the other: on CUDA the kernel runs or the wrapper
raises.

The kernel works from the problem's structure declarations (``drift_f0``,
``drift_G``, ``sigma2_x``, ``cost_q``, ``cost_r``) evaluated once per problem
and grid, and recomputes each candidate's stencil in registers. Problems
without them (the glider) and non-uniform grids raise
``NotImplementedError`` on CUDA; the general ``[C, N, d]`` form is a later
kernel task.

Semantics switches of ``dense_backup``: ``clip=(lo, hi)`` clips the input
values and the result, ``pin_input=True`` pins terminal nodes of the input
before they are read as neighbours. The Pallas kernel is
``clip=value_bounds, pin_input=True``; ``dense_vi``'s improve is
``clip=None, pin_input=False``. The result is always pinned on terminal
nodes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from c3sc_tpu_torch import _ext
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops import mca

MAX_D = 8   # kMaxD in csrc/dense_backup.cu
MAX_DU = 4  # kMaxDU


@dataclasses.dataclass(frozen=True)
class DenseOperands:
    """Everything a sweep needs besides v, on one device.

    ``f0 [N, d]``, ``G [N, d, du]``, ``s2 [N, d]``, ``q [N]`` and ``r [C]``
    are the structure declarations evaluated at the nodes and candidates;
    they are None for a problem that lacks them.
    """

    problem: ControlProblem
    grid: Grid
    x: torch.Tensor          # [N, d] node states, row-major node order
    uc: torch.Tensor         # [C, du] control candidates
    t_mask: torch.Tensor     # [N] bool, terminal (absorbing) nodes
    t_val: torch.Tensor      # [N] pinned terminal values
    f0: Optional[torch.Tensor] = None
    G: Optional[torch.Tensor] = None
    s2: Optional[torch.Tensor] = None
    q: Optional[torch.Tensor] = None
    r: Optional[torch.Tensor] = None


def make_dense_operands(problem: ControlProblem, grid: Grid, controls,
                        device=None) -> DenseOperands:
    """Evaluate the v-independent sweep inputs once (float32, on ``device``)."""
    x = grid.node_states(device)
    uc = torch.as_tensor(controls, dtype=torch.float32, device=x.device)
    t_mask, t_val = mca.node_terminal(problem, grid, grid.node_indices(x.device), x)
    declared = {}
    if problem.structured:
        declared = dict(
            f0=problem.drift_f0(x), G=problem.drift_G(x), s2=problem.sigma2_x(x),
            q=problem.cost_q(x), r=problem.cost_r(uc))
        declared = {k: t.to(torch.float32).contiguous() for k, t in declared.items()}
    return DenseOperands(problem, grid, x, uc.contiguous(), t_mask.contiguous(),
                         t_val.to(torch.float32).contiguous(), **declared)


# ---- plain PyTorch version ------------------------------------------------------


def neighbor_values(v, grid: Grid):
    """Per-dim +-1-node neighbour values of a dense v [*grid.shape].

    Periodic dims wrap; bounded dims clamp (reflecting faces stick, absorbing
    faces are pinned separately). Returns (vp [N, d], vm [N, d]).
    """
    vps, vms = [], []
    for j in range(grid.ndim):
        n = v.shape[j]
        if grid.periodic[j]:
            vp = torch.roll(v, -1, dims=j)
            vm = torch.roll(v, 1, dims=j)
        else:
            vp = torch.cat([v.narrow(j, 1, n - 1), v.narrow(j, n - 1, 1)], dim=j)
            vm = torch.cat([v.narrow(j, 0, 1), v.narrow(j, 0, n - 1)], dim=j)
        vps.append(vp.reshape(-1))
        vms.append(vm.reshape(-1))
    return torch.stack(vps, dim=-1), torch.stack(vms, dim=-1)


def _input_values(ops: DenseOperands, v, clip, pin_input):
    vin = v.reshape(-1)
    if clip is not None:
        vin = torch.clamp(vin, clip[0], clip[1])
    if pin_input:
        vin = torch.where(ops.t_mask, ops.t_val, vin)
    return vin.reshape(ops.grid.shape)


def candidate_rhs(ops: DenseOperands, v, clip=None, pin_input: bool = False):
    """Bellman right-hand side of every candidate at every node: [C, N]."""
    problem, grid = ops.problem, ops.grid
    vp, vm = neighbor_values(_input_values(ops, v, clip, pin_input), grid)
    pp, pm, dt = mca.transition_all_controls(problem, grid, ops.x, ops.uc)
    g = mca.stage_cost_all(problem, ops.x, ops.uc)
    expect = torch.sum(pp * vp, dim=-1) + torch.sum(pm * vm, dim=-1)
    return g * dt + torch.exp(-problem.beta * dt) * expect


def dense_backup_reference(ops: DenseOperands, v, clip=None, pin_input: bool = False):
    """Plain PyTorch sweep: (vnew [*shape], best [N] int32)."""
    rhs = candidate_rhs(ops, v, clip, pin_input)
    best = torch.argmin(rhs, dim=0)  # first index on ties
    vnew = torch.gather(rhs, 0, best[None])[0]
    if clip is not None:
        vnew = torch.clamp(vnew, clip[0], clip[1])
    vnew = torch.where(ops.t_mask, ops.t_val, vnew)
    return vnew.reshape(ops.grid.shape), best.to(torch.int32)


def dense_evaluate_reference(ops: DenseOperands, v, best):
    """Plain PyTorch fixed-policy sweep under candidate indices best [N]."""
    problem, grid = ops.problem, ops.grid
    u = ops.uc[best.long()]                                    # [N, du]
    pp, pm, dt = mca.transition(problem, grid, ops.x, u)
    g = problem.stage_cost(ops.x, u)
    vp, vm = neighbor_values(v.reshape(grid.shape), grid)
    expect = torch.sum(pp * vp + pm * vm, dim=-1)
    vnew = g * dt + torch.exp(-problem.beta * dt) * expect
    return torch.where(ops.t_mask, ops.t_val, vnew).reshape(grid.shape)


# ---- CUDA kernel wrappers ----------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _ext.load()
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    desc = [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int)]
    lib.c3sc_dense_backup.argtypes = ([ptr] * 11 + [i32] * 3 + desc
                                      + [f32, i32, f32, f32, i32, ptr])
    lib.c3sc_dense_backup.restype = i32
    lib.c3sc_dense_evaluate.argtypes = [ptr] * 11 + [i32] * 3 + desc + [f32, ptr]
    lib.c3sc_dense_evaluate.restype = i32
    return lib


def _kernel_inputs(ops: DenseOperands, v):
    """Check that the kernel can run on (ops, v); return its pointer list
    (f0, G, s2, q, r, uc, t_mask, t_val) and its scalar/grid arguments."""
    problem, grid = ops.problem, ops.grid
    if ops.f0 is None:
        raise NotImplementedError(
            f"dense sweep kernel: problem {problem.name!r} lacks the structure "
            "declarations drift_f0/drift_G/sigma2_x/cost_q/cost_r; the general "
            "[C, N, d] form of the kernel is not written yet")
    if not grid.uniform:
        raise NotImplementedError("dense sweep kernel: uniform grids only")
    d, du = grid.ndim, problem.du
    if d > MAX_D or du > MAX_DU:
        raise NotImplementedError(f"dense sweep kernel: d <= {MAX_D}, du <= {MAX_DU}")
    N = int(np.prod(grid.shape))
    if v.dtype != torch.float32 or v.numel() != N or not v.is_contiguous():
        raise ValueError(f"v must be a contiguous float32 tensor of {N} values")
    tensors = (ops.f0, ops.G, ops.s2, ops.q, ops.r, ops.uc, ops.t_mask, ops.t_val)
    if any(t.device != v.device for t in tensors):
        raise ValueError(f"operands and v must share one device, v is on {v.device}")
    shape = (ctypes.c_longlong * d)(*grid.shape)
    h = (ctypes.c_float * d)(*np.asarray(grid.h, np.float32).tolist())
    periodic = (ctypes.c_int * d)(*map(int, grid.periodic))
    scalars = (d, du, ops.uc.shape[0], shape, h, periodic, float(problem.beta))
    return [t.data_ptr() for t in tensors], scalars


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _require_cuda(v, name):
    if v.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, got {v.device}")


def dense_backup(ops: DenseOperands, v, clip=None, pin_input: bool = False):
    """One improve sweep: (vnew [*grid.shape] f32, best [N] int32 argmin).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``dense_backup.launches`` counts those launches).
    """
    if v.device.type == "cpu":
        return dense_backup_reference(ops, v, clip, pin_input)
    _require_cuda(v, "dense_backup")
    ptrs, scalars = _kernel_inputs(ops, v)
    vnew = torch.empty(v.numel(), dtype=torch.float32, device=v.device)
    best = torch.empty(v.numel(), dtype=torch.int32, device=v.device)
    lo, hi = (float(clip[0]), float(clip[1])) if clip is not None else (0.0, 0.0)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = _lib().c3sc_dense_backup(
            v.data_ptr(), *ptrs, vnew.data_ptr(), best.data_ptr(), *scalars,
            int(clip is not None), lo, hi, int(pin_input), stream)
    _check(err, "dense_backup")
    dense_backup.launches += 1
    return vnew.view(ops.grid.shape), best


dense_backup.launches = 0


def dense_evaluate(ops: DenseOperands, v, best):
    """One fixed-policy sweep under candidate indices best [N] (int32):
    vnew [*grid.shape], pinned on terminal nodes.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``dense_evaluate.launches`` counts those launches).
    """
    if v.device.type == "cpu":
        return dense_evaluate_reference(ops, v, best)
    _require_cuda(v, "dense_evaluate")
    ptrs, scalars = _kernel_inputs(ops, v)
    if best.dtype != torch.int32 or best.numel() != v.numel() or best.device != v.device \
            or not best.is_contiguous():
        raise ValueError("best must be a contiguous int32 tensor of one index per node")
    vnew = torch.empty(v.numel(), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = _lib().c3sc_dense_evaluate(
            v.data_ptr(), best.data_ptr(), *ptrs, vnew.data_ptr(), *scalars, stream)
    _check(err, "dense_evaluate")
    dense_evaluate.launches += 1
    return vnew.view(ops.grid.shape)


dense_evaluate.launches = 0
