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
and grid, and recomputes each candidate's stencil in registers, in the
division-free factored form that ``candidate_rhs_factored`` states in plain
PyTorch. It reads the per-node operands as structure-of-arrays
(``f0_k [d, N]``, ``G_k [d, du, N]``, ``s2_k [d, N]``), so that a warp's
load of one component is one line; the ``[N, d]`` forms are views of the
same memory. Problems without the declarations (the glider) and non-uniform
grids raise ``NotImplementedError`` on CUDA; the general ``[C, N, d]`` form
is a later kernel task.

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
from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops import mca

MAX_D = 8   # kMaxD in csrc/dense_backup.cu
MAX_DU = 4  # kMaxDU
_EPS = 1e-10  # the stencil's guard against Q = 0, as in ops/mca.py


@dataclasses.dataclass(frozen=True)
class DenseOperands:
    """Everything a sweep needs besides v, on one device.

    ``f0_k [d, N]``, ``G_k [d, du, N]``, ``s2_k [d, N]`` (the kernel's
    layout, contiguous), ``q [N]`` and ``r [C]`` are the structure
    declarations evaluated at the nodes and candidates; they are None for a
    problem that lacks them. ``f0 [N, d]``, ``G [N, d, du]`` and
    ``s2 [N, d]`` are transposed views of the kernel's copies.
    """

    problem: ControlProblem
    grid: Grid
    x: torch.Tensor          # [N, d] node states, row-major node order
    uc: torch.Tensor         # [C, du] control candidates
    t_mask: torch.Tensor     # [N] bool, terminal (absorbing) nodes
    t_val: torch.Tensor      # [N] pinned terminal values
    f0_k: Optional[torch.Tensor] = None
    G_k: Optional[torch.Tensor] = None
    s2_k: Optional[torch.Tensor] = None
    q: Optional[torch.Tensor] = None
    r: Optional[torch.Tensor] = None

    @property
    def f0(self):
        return None if self.f0_k is None else self.f0_k.T

    @property
    def G(self):
        return None if self.G_k is None else self.G_k.permute(2, 0, 1)

    @property
    def s2(self):
        return None if self.s2_k is None else self.s2_k.T

    @functools.cached_property
    def kernel_args(self):
        """What every launch on these operands passes besides v and its
        outputs, built once: the device pointers (f0_k, G_k, s2_k, q, r, uc,
        t_mask, t_val) and the scalar and grid arguments as ctypes values.
        Raises for what the kernel does not take."""
        problem, grid = self.problem, self.grid
        if self.f0_k is None:
            raise NotImplementedError(
                f"dense sweep kernel: problem {problem.name!r} lacks the structure "
                "declarations drift_f0/drift_G/sigma2_x/cost_q/cost_r; the general "
                "[C, N, d] form of the kernel is not written yet")
        if not grid.uniform:
            raise NotImplementedError("dense sweep kernel: uniform grids only")
        d, du = grid.ndim, problem.du
        if d > MAX_D or du > MAX_DU:
            raise NotImplementedError(f"dense sweep kernel: d <= {MAX_D}, du <= {MAX_DU}")
        tensors = (self.f0_k, self.G_k, self.s2_k, self.q, self.r, self.uc, self.t_mask,
                   self.t_val)
        if any(t.device != self.x.device or not t.is_contiguous() for t in tensors):
            raise ValueError("operands must be contiguous and share one device")
        shape = (ctypes.c_longlong * d)(*grid.shape)
        h = (ctypes.c_float * d)(*np.asarray(grid.h, np.float32).tolist())
        periodic = (ctypes.c_int * d)(*map(int, grid.periodic))
        scalars = (d, du, self.uc.shape[0], shape, h, periodic, float(problem.beta))
        return tuple(t.data_ptr() for t in tensors), scalars


def make_dense_operands(problem: ControlProblem, grid: Grid, controls,
                        device=None) -> DenseOperands:
    """Evaluate the v-independent sweep inputs once (float32, on ``device``;
    None: the default CUDA device)."""
    f32 = torch.float32
    x = grid.node_states(resolve_device(device))
    uc = torch.as_tensor(controls, dtype=f32, device=x.device).contiguous()
    t_mask, t_val = mca.node_terminal(problem, grid, grid.node_indices(x.device), x)
    declared = {}
    if problem.structured:
        # node-major declarations -> the kernel's structure-of-arrays copies
        declared = dict(
            f0_k=problem.drift_f0(x).to(f32).T.contiguous(),
            G_k=problem.drift_G(x).to(f32).permute(1, 2, 0).contiguous(),
            s2_k=problem.sigma2_x(x).to(f32).T.contiguous(),
            q=problem.cost_q(x).to(f32).contiguous(),
            r=problem.cost_r(uc).to(f32).contiguous())
    return DenseOperands(problem, grid, x, uc, t_mask.contiguous(),
                         t_val.to(f32).contiguous(), **declared)


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


def candidate_rhs_factored(ops: DenseOperands, v, clip=None, pin_input: bool = False):
    """The same [C, N] right-hand side in the kernel's factored form, from the
    kernel's operands: no division per candidate but ``1 / Q``.

    With ``a_j = s2_j / (2 h_j^2)``: per node ``f0h = f0 / h``, ``Gh = G / h``,
    ``Q0 = sum_j 2 a_j + 1e-10``, ``A0 = sum_j a_j (v+_j + v-_j)``; per
    candidate ``fh = f0h + Gh u``, ``Q = Q0 + sum_j |fh_j|``,
    ``S = sum_j |fh_j| (fh_j > 0 ? v+_j : v-_j)``,
    ``dt = 1 / Q``, ``rhs = dt ((r + q) + exp(-beta dt) (A0 + S))``. It equals
    ``candidate_rhs`` to float rounding; the tests hold the kernel's algebra
    against the JAX package through it.
    """
    grid = ops.grid
    vp, vm = neighbor_values(_input_values(ops, v, clip, pin_input), grid)   # [N, d]
    h = torch.as_tensor(grid.h, dtype=torch.float32, device=vp.device)
    ih, a = 1.0 / h, ops.s2 * (0.5 / (h * h))
    f0h, Gh = ops.f0 * ih, ops.G * ih[:, None]
    Q0 = torch.sum(2.0 * a, dim=-1) + _EPS
    A0 = torch.sum(a * (vp + vm), dim=-1)
    fh = f0h[None] + torch.einsum("ndm,cm->cnd", Gh, ops.uc)                 # [C, N, d]
    af = torch.abs(fh)
    dt = 1.0 / (Q0[None] + torch.sum(af, dim=-1))
    S = torch.sum(af * torch.where(fh > 0, vp[None], vm[None]), dim=-1)
    return dt * ((ops.r[:, None] + ops.q[None]) + torch.exp(-ops.problem.beta * dt) * (A0 + S))


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
                                      + [f32, i32, f32, f32, i32, i32, ptr])
    lib.c3sc_dense_backup.restype = i32
    lib.c3sc_dense_evaluate.argtypes = [ptr] * 11 + [i32] * 3 + desc + [f32, i32, ptr]
    lib.c3sc_dense_evaluate.restype = i32
    return lib


def _kernel_inputs(ops: DenseOperands, v):
    """Check that the kernel can run on (ops, v); return ``ops.kernel_args``."""
    ptrs, scalars = ops.kernel_args
    N = ops.t_val.numel()
    if v.dtype != torch.float32 or v.numel() != N or not v.is_contiguous():
        raise ValueError(f"v must be a contiguous float32 tensor of {N} values")
    if v.device != ops.t_val.device:
        raise ValueError(f"operands and v must share one device, v is on {v.device}")
    return ptrs, scalars


def _require_cuda(v, name):
    if v.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, got {v.device}")


def _launch(entry: str, v, *args):
    """Call the library's ``entry`` on v's device and current stream; raise
    if the launch is refused."""
    fn = getattr(_lib(), entry)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    if v.device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(v.device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed with CUDA error {err}")


def dense_backup(ops: DenseOperands, v, clip=None, pin_input: bool = False, *,
                 _wide_index: bool = False):
    """One improve sweep: (vnew [*grid.shape] f32, best [N] int32 argmin).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``dense_backup.launches`` counts those launches). The kernel decodes
    with 64-bit indices for grids of 2^31 nodes and more; ``_wide_index`` is
    the tests' switch that makes it do so on a small grid.
    """
    if v.device.type == "cpu":
        return dense_backup_reference(ops, v, clip, pin_input)
    _require_cuda(v, "dense_backup")
    ptrs, scalars = _kernel_inputs(ops, v)
    vnew = torch.empty(v.numel(), dtype=torch.float32, device=v.device)
    best = torch.empty(v.numel(), dtype=torch.int32, device=v.device)
    lo, hi = (float(clip[0]), float(clip[1])) if clip is not None else (0.0, 0.0)
    _launch("c3sc_dense_backup", v, v.data_ptr(), *ptrs, vnew.data_ptr(), best.data_ptr(),
            *scalars, int(clip is not None), lo, hi, int(pin_input), int(_wide_index))
    dense_backup.launches += 1
    return vnew.view(ops.grid.shape), best


dense_backup.launches = 0


def dense_evaluate(ops: DenseOperands, v, best, *, _wide_index: bool = False):
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
    _launch("c3sc_dense_evaluate", v, v.data_ptr(), best.data_ptr(), *ptrs, vnew.data_ptr(),
            *scalars, int(_wide_index))
    dense_evaluate.launches += 1
    return vnew.view(ops.grid.shape)


dense_evaluate.launches = 0
