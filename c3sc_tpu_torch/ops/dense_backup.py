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
same memory.

A problem without all five declarations (the glider, whose drift is
nonlinear in its control), and a declared one beyond the structured kernels'
``d <= MAX_D``, ``du <= MAX_DU``, takes the general entries
``dense_backup_general`` and ``dense_evaluate_general``, the counterpart of
the Pallas kernel's any-callable contract and of the XLA sweeps of
``c3sc_tpu/solvers/dense.py``: ``make_dense_operands`` evaluates the problem's own callables once per
problem and grid, in candidate chunks, into the per-candidate drift
``fc_k [C, d, N]`` (and ``s2c_k [C, d, N]`` where ``sigma2_x`` is missing,
``gc [C, N]`` where ``cost_q`` or ``cost_r`` is); ``dense_backup`` and
``dense_evaluate`` route such operands there. Above ``MAX_D`` dims the general
entries launch the kernels' run-time-d form, whose wrappers
``wide_dense_backup_general`` and ``wide_dense_evaluate_general`` count its
launches; above ``MAX_D_WIDE`` dims no kernel takes the grid and the
wrappers raise. A grid of 33 dims of two nodes has 2^33 nodes, whose values
alone take 32 GiB, so no such grid fits one card.

Non-uniform grids. Every entry takes them: on such a grid the operands carry
``nu_k [sum_k n_k, 8]``, each dim's table of the reciprocal spacings the
unequal-spacing stencil of ``mca._stencil_nonuniform`` uses at each of its
coordinates (``spacing_tables``), and the kernels scale each candidate's
drift by ``1/h+`` or ``1/h-`` once its sign is known.

The policy. ``dense_vi`` runs ``eval_sweeps`` fixed-policy sweeps after
every improve. ``dense_backup(..., with_policy=True)`` returns the improve's
argmin as a ``DensePolicy``: for general operands the kernel's epilogue
also writes the winning candidate's operands, ``fpol_k [d, N]`` (and
``s2pol_k [d, N]``, ``gpol [N]`` where those are per candidate), so that the
evaluate sweeps read coalesced lines instead of ``fc_k[best[n], :, n]``
scattered across the candidate planes. It is the counterpart of
``gather_policy`` in ``c3sc_tpu/solvers/dense.py``; ``gather_policy`` here
builds the same object from ``best`` alone with a plain ``torch.gather``, for
callers that hold only the indices (it is the plain version of the
epilogue), and the evaluate wrappers take either.

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
from typing import Optional, Union

import numpy as np
import torch

from c3sc_tpu_torch import _ext
from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops import mca

MAX_D = 8         # kMaxD in csrc/dense_backup.cu: the structured entries, and the
                  # general entries' compiled-d form
MAX_DU = 4        # kMaxDU: the structured entries' controls
MAX_D_WIDE = 32   # kMaxDWide: the general entries' run-time-d form, MAX_D < d <= 32
_EPS = 1e-10  # the stencil's guard against Q = 0, as in ops/mca.py


@dataclasses.dataclass(frozen=True)
class DenseOperands:
    """Everything a sweep needs besides v, on one device.

    ``f0_k [d, N]``, ``G_k [d, du, N]``, ``s2_k [d, N]`` (the kernel's
    layout, contiguous), ``q [N]`` and ``r [C]`` are the structure
    declarations evaluated at the nodes and candidates; they are None for a
    problem that lacks them. ``f0 [N, d]``, ``G [N, d, du]`` and
    ``s2 [N, d]`` are transposed views of the kernel's copies.

    Operands of a problem without all five declarations are ``general``:
    ``fc_k [C, d, N]`` holds the drift of every candidate at every node,
    ``s2c_k [C, d, N]`` the variances where ``sigma2_x`` is missing (else
    ``s2_k``), and ``gc [C, N]`` the stage cost where ``cost_q`` or
    ``cost_r`` is (else ``q`` and ``r``).

    On a non-uniform grid ``nu_k`` holds ``spacing_tables(grid)``.
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
    fc_k: Optional[torch.Tensor] = None
    s2c_k: Optional[torch.Tensor] = None
    gc: Optional[torch.Tensor] = None
    nu_k: Optional[torch.Tensor] = None   # spacing_tables(grid) on a non-uniform grid

    @property
    def general(self) -> bool:
        """True for the per-candidate operands of the general entries."""
        return self.fc_k is not None

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
        outputs, built once: the device pointers and the scalar and grid
        arguments as ctypes values. Structured: (f0_k, G_k, s2_k, q, r, uc,
        t_mask, t_val) and (d, du, C, ...); general: (fc_k, s2_k, s2c_k, q,
        r, gc, t_mask, t_val), the absent ones null, and (d, C, ...). The
        grid arguments end with the spacing tables' pointer (null on a
        uniform grid). Raises for what the kernels do not take."""
        problem, grid = self.problem, self.grid
        if (self.nu_k is None) != grid.uniform:
            raise ValueError("operands of a non-uniform grid carry its spacing tables, "
                             "and only those do: build them with make_dense_operands")
        d, du = grid.ndim, problem.du
        if self.general and d > MAX_D_WIDE:
            raise ValueError(f"dense sweep kernel: the general entries take grids of at most "
                             f"{MAX_D_WIDE} dims (MAX_D_WIDE), got {d}")
        if not self.general and (d > MAX_D or du > MAX_DU):
            raise ValueError(f"dense sweep kernel: structured operands take d <= {MAX_D} and "
                             f"du <= {MAX_DU}, got d = {d}, du = {du}: make_dense_operands "
                             f"gives such a problem the general operands")
        if self.general:
            tensors = (self.fc_k, self.s2_k, self.s2c_k, self.q, self.r, self.gc, self.t_mask,
                       self.t_val)
        else:
            tensors = (self.f0_k, self.G_k, self.s2_k, self.q, self.r, self.uc, self.t_mask,
                       self.t_val)
        if any(t is not None and (t.device != self.x.device or not t.is_contiguous())
               for t in (*tensors, self.nu_k)):
            raise ValueError("operands must be contiguous and share one device")
        shape = (ctypes.c_longlong * d)(*grid.shape)
        h = (ctypes.c_float * d)(*np.asarray(grid.h, np.float32).tolist())
        periodic = (ctypes.c_int * d)(*map(int, grid.periodic))
        sizes = (d, self.uc.shape[0]) if self.general else (d, du, self.uc.shape[0])
        scalars = (*sizes, shape, h, periodic, _ptr(self.nu_k), float(problem.beta))
        return tuple(0 if t is None else t.data_ptr() for t in tensors), scalars


def make_dense_operands(problem: ControlProblem, grid: Grid, controls,
                        device=None) -> DenseOperands:
    """Evaluate the v-independent sweep inputs once (float32, on ``device``;
    None: the default CUDA device): the structured operands for a problem
    with all five declarations within ``d <= MAX_D`` and ``du <= MAX_DU``,
    else the general operands (``C d N`` floats of drift, no more than the
    JAX package's ``[C, N, d]`` stencil of ``_precompute``)."""
    f32 = torch.float32
    x = grid.node_states(resolve_device(device))
    uc = torch.as_tensor(controls, dtype=f32, device=x.device).contiguous()
    t_mask, t_val = mca.node_terminal(problem, grid, grid.node_indices(x.device), x)
    if problem.structured and grid.ndim <= MAX_D and problem.du <= MAX_DU:
        # node-major declarations -> the kernel's structure-of-arrays copies
        declared = dict(
            f0_k=problem.drift_f0(x).to(f32).T.contiguous(),
            G_k=problem.drift_G(x).to(f32).permute(1, 2, 0).contiguous(),
            s2_k=problem.sigma2_x(x).to(f32).T.contiguous(),
            q=problem.cost_q(x).to(f32).contiguous(),
            r=problem.cost_r(uc).to(f32).contiguous())
    else:
        declared = _general_operands(problem, x, uc)
    return DenseOperands(problem, grid, x, uc, t_mask.contiguous(),
                         t_val.to(f32).contiguous(), nu_k=spacing_tables(grid, x.device),
                         **declared)


SPACING_STRIDE = 8  # kSpacingStride in csrc/dense_backup.cu


def spacing_tables(grid: Grid, device) -> Optional[torch.Tensor]:
    """The kernels' spacing tables of a non-uniform grid, None on a uniform
    one: ``[sum_k n_k, 8]`` float32, row ``n_0 + ... + n_{k-1} + i`` holding
    ``1/h+, 1/h-, 1/(h+ h-), 1/(h+ (h+ + h-)), 1/(h- (h+ + h-))`` (then
    zeros) for coordinate ``i`` of dim ``k``, with ``h+-`` from
    ``Grid.node_h``, worked out in float64 and rounded once."""
    if grid.uniform:
        return None
    rows = []
    for k in range(grid.ndim):
        hp, hm = grid.node_h(k)
        t = np.zeros((len(hp), SPACING_STRIDE))
        t[:, :5] = np.stack([1.0 / hp, 1.0 / hm, 1.0 / (hp * hm), 1.0 / (hp * (hp + hm)),
                             1.0 / (hm * (hp + hm))], axis=-1)
        rows.append(t)
    return torch.as_tensor(np.concatenate(rows).astype(np.float32), device=device)


def node_spacings(ops: DenseOperands) -> torch.Tensor:
    """Each node's five reciprocal spacings from ``ops.nu_k``, as the
    kernels read them: [5, N, d]."""
    grid = ops.grid
    idx = grid.node_indices(ops.x.device)                          # [N, d]
    off = np.concatenate([[0], np.cumsum(grid.shape)[:-1]])
    rows = idx + torch.as_tensor(off, device=idx.device)
    return ops.nu_k[rows][..., :5].permute(2, 0, 1)


def _general_operands(problem: ControlProblem, x, uc, chunk_elems: int = 1 << 22):
    """The per-candidate operands of the general entries, evaluated through
    the problem's own callables in chunks of candidates (at most about
    ``chunk_elems`` (candidate, node) pairs at a time): the drift of every
    candidate, and the variances and the cost from their declarations where
    those exist, per candidate where they do not."""
    f32 = torch.float32
    (N, d), C = x.shape, uc.shape[0]
    out = {"fc_k": torch.empty((C, d, N), dtype=f32, device=x.device)}
    if problem.sigma2_x is not None:
        out["s2_k"] = problem.sigma2_x(x).to(f32).T.contiguous()
    else:
        out["s2c_k"] = torch.empty((C, d, N), dtype=f32, device=x.device)
    if problem.cost_q is not None and problem.cost_r is not None:
        out["q"] = problem.cost_q(x).to(f32).contiguous()
        out["r"] = problem.cost_r(uc).to(f32).contiguous()
    else:
        out["gc"] = torch.empty((C, N), dtype=f32, device=x.device)
    step = max(1, chunk_elems // N)
    for c0 in range(0, C, step):
        u = uc[c0:c0 + step]
        out["fc_k"][c0:c0 + step] = problem.drift(x[None], u[:, None]).transpose(1, 2)
        if "s2c_k" in out:
            out["s2c_k"][c0:c0 + step] = problem.sigma2_diag(x[None], u[:, None]).transpose(1, 2)
        if "gc" in out:
            out["gc"][c0:c0 + step] = problem.stage_cost(x[None], u[:, None])
    return out


@dataclasses.dataclass(frozen=True)
class DensePolicy:
    """A fixed policy of the evaluate sweeps: the candidate index of every
    node and, for general operands, that candidate's per-candidate operands
    in the kernels' structure-of-arrays layout (contiguous): ``fpol_k [d,
    N]`` its drift, ``s2pol_k [d, N]`` its variances where the operands have
    ``s2c_k``, ``gpol [N]`` its stage cost where they have ``gc``. Structured
    operands need ``best`` alone: their evaluate reads ``f0_k``, ``G_k`` and
    ``uc[best]``."""

    best: torch.Tensor                       # [N] int32
    fpol_k: Optional[torch.Tensor] = None    # [d, N]
    s2pol_k: Optional[torch.Tensor] = None   # [d, N]
    gpol: Optional[torch.Tensor] = None      # [N]


def gather_policy(ops: DenseOperands, best) -> DensePolicy:
    """The policy of candidate indices ``best [N]`` (int32), gathered from the
    operands with plain ``torch.gather`` on their device: the plain version
    of the improve kernel's epilogue (``dense_backup(..., with_policy=True)``),
    bit for bit, for callers that hold only the indices."""
    best = best.reshape(-1)
    if not ops.general:
        return DensePolicy(best)
    # a bad index gathers candidate 0 or C - 1 here; the evaluate kernel's
    # guard then turns its node into NaN, from best
    idx = best.long().clamp(0, ops.uc.shape[0] - 1)[None]   # [1, N]

    def take(a):                                             # [C, d, N] -> [d, N]
        return torch.gather(a, 0, idx[:, None].expand(1, a.shape[1], -1))[0]

    return DensePolicy(best, take(ops.fc_k),
                       None if ops.s2c_k is None else take(ops.s2c_k),
                       None if ops.gc is None else torch.gather(ops.gc, 0, idx)[0])


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
    """The same [C, N] right-hand side in the kernels' factored form, from the
    kernels' operands: no division per candidate but ``1 / Q``.

    With ``a_j = s2_j / (2 h_j^2)``: per node ``f0h = f0 / h``, ``Gh = G / h``,
    ``Q0 = sum_j 2 a_j + 1e-10``, ``A0 = sum_j a_j (v+_j + v-_j)``; per
    candidate ``fh = f0h + Gh u``, ``Q = Q0 + sum_j |fh_j|``,
    ``S = sum_j |fh_j| (fh_j > 0 ? v+_j : v-_j)``,
    ``dt = 1 / Q``, ``rhs = dt ((r + q) + exp(-beta dt) (A0 + S))``. The
    general entries take ``fh = fc / h`` from the per-candidate drift, and
    ``a``, ``Q0``, ``A0`` from ``s2c`` and the cost from ``gc`` where those
    are per candidate. On a non-uniform grid, from the spacing tables:
    ``Q0 = sum_j s2_j / (h+ h-) + 1e-10``, ``A0 = sum_j s2_j (v+_j / (h+ (h+ +
    h-)) + v-_j / (h- (h+ + h-)))`` and ``fh = f / h+`` where ``f > 0``,
    ``f / h-`` elsewhere, with f unscaled. It equals ``candidate_rhs`` to
    float rounding; the tests hold the kernels' algebra against the JAX
    package through it.
    """
    grid = ops.grid
    vp, vm = neighbor_values(_input_values(ops, v, clip, pin_input), grid)   # [N, d]
    s2 = ops.s2 if ops.s2_k is not None else ops.s2c_k.transpose(1, 2)       # [(C,) N, d]
    if ops.nu_k is None:
        h = torch.as_tensor(grid.h, dtype=torch.float32, device=vp.device)
        ih = 1.0 / h
        a = s2 * (0.5 / (h * h))
        Q0 = torch.sum(2.0 * a, dim=-1) + _EPS
        A0 = torch.sum(a * (vp + vm), dim=-1)
        if ops.general:
            fh = ops.fc_k.transpose(1, 2) * ih                                # [C, N, d]
        else:
            fh = (ops.f0 * ih)[None] + torch.einsum("ndm,cm->cnd", ops.G * ih[:, None], ops.uc)
    else:
        ihp, ihm, cpm, cp, cm = node_spacings(ops)                            # [N, d] each
        Q0 = torch.sum(s2 * cpm, dim=-1) + _EPS
        A0 = torch.sum(s2 * (cp * vp + cm * vm), dim=-1)
        if ops.general:
            f = ops.fc_k.transpose(1, 2)
        else:
            f = ops.f0[None] + torch.einsum("ndm,cm->cnd", ops.G, ops.uc)
        fh = f * torch.where(f > 0, ihp, ihm)
    g = ops.gc if ops.gc is not None else ops.r[:, None] + ops.q[None]
    af = torch.abs(fh)
    dt = 1.0 / (Q0 + torch.sum(af, dim=-1))
    S = torch.sum(af * torch.where(fh > 0, vp[None], vm[None]), dim=-1)
    return dt * (g + torch.exp(-ops.problem.beta * dt) * (A0 + S))


def dense_backup_reference(ops: DenseOperands, v, clip=None, pin_input: bool = False,
                           with_policy: bool = False):
    """Plain PyTorch sweep: (vnew [*shape], best [N] int32), or with
    ``with_policy`` (vnew, ``gather_policy(ops, best)``)."""
    rhs = candidate_rhs(ops, v, clip, pin_input)
    best = torch.argmin(rhs, dim=0)  # first index on ties
    vnew = torch.gather(rhs, 0, best[None])[0]
    if clip is not None:
        vnew = torch.clamp(vnew, clip[0], clip[1])
    vnew = torch.where(ops.t_mask, ops.t_val, vnew).reshape(ops.grid.shape)
    best = best.to(torch.int32)
    return vnew, (gather_policy(ops, best) if with_policy else best)


def dense_evaluate_reference(ops: DenseOperands, v, policy):
    """Plain PyTorch fixed-policy sweep under a ``DensePolicy`` or candidate
    indices best [N]. It recomputes the stencil of ``uc[best]`` through the
    problem's own callables, so it reads none of the policy's gathered
    operands: a policy whose operands disagree with its indices shows."""
    problem, grid = ops.problem, ops.grid
    best = policy.best if isinstance(policy, DensePolicy) else policy
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
    desc = desc + [ptr]   # the spacing tables (null on a uniform grid)
    lib.c3sc_dense_backup.argtypes = ([ptr] * 11 + [i32] * 3 + desc
                                      + [f32, i32, f32, f32, i32, i32, ptr])
    lib.c3sc_dense_backup.restype = i32
    lib.c3sc_dense_evaluate.argtypes = [ptr] * 11 + [i32] * 3 + desc + [f32, i32, ptr]
    lib.c3sc_dense_evaluate.restype = i32
    lib.c3sc_dense_backup_general.argtypes = ([ptr] * 14 + [i32] * 2 + desc
                                              + [f32, i32, f32, f32, i32, i32, i32, ptr])
    lib.c3sc_dense_backup_general.restype = i32
    lib.c3sc_dense_evaluate_general.argtypes = ([ptr] * 14 + [i32] * 2 + desc
                                                + [f32, i32, i32, ptr])
    lib.c3sc_dense_evaluate_general.restype = i32
    lib.c3sc_dense_preload.argtypes = [i32] * 3 + desc
    lib.c3sc_dense_preload.restype = i32
    return lib


ENTRIES = ("dense_backup", "dense_evaluate", "dense_backup_general", "dense_evaluate_general",
           "wide_dense_backup_general", "wide_dense_evaluate_general")


def launch_counts() -> dict:
    """K1's launch counts by entry (``ENTRIES``)."""
    return {name: globals()[name].launches for name in ENTRIES}


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` to K1's launch counts: what a CUDA graph's
    replay launches, which passes no wrapper (``times=-1`` takes back the
    increments the wrappers made while the graph was captured, which ran
    nothing)."""
    for name, n in counts.items():
        globals()[name].launches += times * n


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


def preload(ops: DenseOperands) -> None:
    """Load the improve and evaluate kernels that launches on these CUDA
    operands run, launching nothing. With lazy module loading a kernel is
    otherwise loaded at its first launch, which a CUDA graph's capture must
    not have to do: the graphed solvers call this before they capture."""
    _, scalars = ops.kernel_args
    d, C, shape, h, periodic, nu = (scalars[0], scalars[1], *scalars[2:6]) if ops.general \
        else (scalars[0], scalars[2], *scalars[3:7])
    du = 0 if ops.general else scalars[1]
    with torch.cuda.device(ops.x.device):
        err = _lib().c3sc_dense_preload(d, du, C, shape, h, periodic, nu)
    if err != 0:
        raise RuntimeError(f"loading the dense sweep kernels failed with CUDA error {err}")


def dense_backup(ops: DenseOperands, v, clip=None, pin_input: bool = False, *,
                 with_policy: bool = False, _wide_index: bool = False):
    """One improve sweep: (vnew [*grid.shape] f32, best [N] int32 argmin), or
    with ``with_policy`` (vnew, ``DensePolicy``), the evaluate sweeps' input.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``dense_backup.launches`` counts those launches), or, for general
    operands, ``dense_backup_general``. The kernel decodes with 64-bit
    indices for grids of 2^31 nodes and more; ``_wide_index`` is the tests'
    switch that makes it do so on a small grid.
    """
    if v.device.type == "cpu":
        return dense_backup_reference(ops, v, clip, pin_input, with_policy)
    if ops.general:
        return dense_backup_general(ops, v, clip, pin_input, with_policy=with_policy,
                                    _wide_index=_wide_index)
    _require_cuda(v, "dense_backup")
    ptrs, scalars = _kernel_inputs(ops, v)
    vnew = torch.empty(v.numel(), dtype=torch.float32, device=v.device)
    best = torch.empty(v.numel(), dtype=torch.int32, device=v.device)
    lo, hi = (float(clip[0]), float(clip[1])) if clip is not None else (0.0, 0.0)
    _launch("c3sc_dense_backup", v, v.data_ptr(), *ptrs, vnew.data_ptr(), best.data_ptr(),
            *scalars, int(clip is not None), lo, hi, int(pin_input), int(_wide_index))
    dense_backup.launches += 1
    return vnew.view(ops.grid.shape), (DensePolicy(best) if with_policy else best)


dense_backup.launches = 0


def dense_evaluate(ops: DenseOperands, v, policy: Union[DensePolicy, torch.Tensor], *,
                   _wide_index: bool = False):
    """One fixed-policy sweep under ``policy``, a ``DensePolicy`` (from
    ``dense_backup(..., with_policy=True)`` or ``gather_policy``) or the
    candidate indices best [N] (int32) alone: vnew [*grid.shape], pinned on
    terminal nodes.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``dense_evaluate.launches`` counts those launches), or, for general
    operands, ``dense_evaluate_general``.
    """
    if v.device.type == "cpu":
        return dense_evaluate_reference(ops, v, policy)
    if ops.general:
        return dense_evaluate_general(ops, v, policy, _wide_index=_wide_index)
    _require_cuda(v, "dense_evaluate")
    ptrs, scalars = _kernel_inputs(ops, v)
    best = policy.best if isinstance(policy, DensePolicy) else policy
    _check_policy(v, best)
    vnew = torch.empty(v.numel(), dtype=torch.float32, device=v.device)
    _launch("c3sc_dense_evaluate", v, v.data_ptr(), best.data_ptr(), *ptrs, vnew.data_ptr(),
            *scalars, int(_wide_index))
    dense_evaluate.launches += 1
    return vnew.view(ops.grid.shape)


dense_evaluate.launches = 0


def _check_policy(v, best):
    if best.dtype != torch.int32 or best.numel() != v.numel() or best.device != v.device \
            or not best.is_contiguous():
        raise ValueError("best must be a contiguous int32 tensor of one index per node")


def _check_general_policy(ops: DenseOperands, v, pol: DensePolicy):
    """The policy's operands are those of these operands: contiguous float32
    on v's device, fpol_k [d, N], s2pol_k [d, N] exactly where s2c_k exists,
    gpol [N] exactly where gc does."""
    _check_policy(v, pol.best)
    N, d = ops.x.shape
    want = ((pol.fpol_k, (d, N)), (pol.s2pol_k, (d, N) if ops.s2c_k is not None else None),
            (pol.gpol, (N,) if ops.gc is not None else None))
    for t, shape in want:
        if (t is None) != (shape is None) or t is not None and (
                tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != v.device
                or not t.is_contiguous()):
            raise ValueError("the policy's operands do not match the general operands: "
                             "take them from dense_backup(..., with_policy=True) or "
                             "gather_policy")


def _require_general(ops: DenseOperands, name):
    if not ops.general:
        raise ValueError(f"{name}: operands of a structured problem take the structured entry")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def dense_backup_general(ops: DenseOperands, v, clip=None, pin_input: bool = False, *,
                         with_policy: bool = False, _wide_index: bool = False,
                         _runtime_d: bool = False):
    """One improve sweep on general operands (a problem without all five
    declarations, or beyond the structured kernels' limits): (vnew
    [*grid.shape] f32, best [N] int32), with ``dense_backup``'s ``clip`` and
    ``pin_input`` switches; with ``with_policy`` (vnew, ``DensePolicy``),
    whose operands the kernel's epilogue writes after re-reading the winner's
    lines of ``fc`` (``s2c``, ``gc``), which its warp read in the candidate
    loop and which come from L1 or L2.

    CPU tensors take the plain version (``dense_backup_reference``, through
    ``mca.transition_all_controls``'s per-candidate branch, and
    ``gather_policy``); CUDA tensors launch the kernel
    (``dense_backup_general.launches`` counts those launches), or, on a grid
    of more than ``MAX_D`` dims, ``wide_dense_backup_general``. 64-bit
    offsets are taken when C d N >= 2^31; ``_wide_index`` forces them.
    ``_runtime_d`` is the tests' switch that sends a grid of at most
    ``MAX_D`` dims to ``wide_dense_backup_general`` too (ignored on the CPU).
    """
    if v.device.type == "cpu":
        return dense_backup_reference(ops, v, clip, pin_input, with_policy)
    _require_cuda(v, "dense_backup_general")
    _require_general(ops, "dense_backup_general")
    if ops.grid.ndim > MAX_D or _runtime_d:
        return wide_dense_backup_general(ops, v, clip, pin_input, with_policy=with_policy,
                                         _wide_index=_wide_index, _runtime_d=_runtime_d)
    out = _launch_backup_general(ops, v, clip, pin_input, with_policy, _wide_index)
    dense_backup_general.launches += 1
    return out


dense_backup_general.launches = 0


def wide_dense_backup_general(ops: DenseOperands, v, clip=None, pin_input: bool = False, *,
                              with_policy: bool = False, _wide_index: bool = False,
                              _runtime_d: bool = False):
    """``dense_backup_general`` on a grid of ``MAX_D < d <= MAX_D_WIDE`` dims
    (with ``_runtime_d``, of any ``d <= MAX_D_WIDE``): the kernel's
    run-time-d form (``wide_dense_backup_general.launches`` counts its
    launches). CPU tensors take the plain version. More than ``MAX_D_WIDE``
    dims raise ValueError."""
    if v.device.type == "cpu":
        return dense_backup_reference(ops, v, clip, pin_input, with_policy)
    _require_cuda(v, "wide_dense_backup_general")
    _require_general(ops, "wide_dense_backup_general")
    _require_wide(ops, "wide_dense_backup_general", _runtime_d)
    out = _launch_backup_general(ops, v, clip, pin_input, with_policy, _wide_index, True)
    wide_dense_backup_general.launches += 1
    return out


wide_dense_backup_general.launches = 0


def _launch_backup_general(ops: DenseOperands, v, clip, pin_input, with_policy, wide_index,
                           runtime_d=False):
    """Launch the general improve kernel (the library picks the form by d;
    ``runtime_d`` takes the run-time-d form at any d)."""
    ptrs, scalars = _kernel_inputs(ops, v)
    N, d = ops.x.shape
    vnew = torch.empty(N, dtype=torch.float32, device=v.device)
    best = torch.empty(N, dtype=torch.int32, device=v.device)
    pol = DensePolicy(best)
    if with_policy:
        empty = functools.partial(torch.empty, dtype=torch.float32, device=v.device)
        pol = DensePolicy(best, empty((d, N)), None if ops.s2c_k is None else empty((d, N)),
                          None if ops.gc is None else empty(N))
    lo, hi = (float(clip[0]), float(clip[1])) if clip is not None else (0.0, 0.0)
    _launch("c3sc_dense_backup_general", v, v.data_ptr(), *ptrs, vnew.data_ptr(),
            best.data_ptr(), _ptr(pol.fpol_k), _ptr(pol.s2pol_k), _ptr(pol.gpol), *scalars,
            int(clip is not None), lo, hi, int(pin_input), int(wide_index), int(runtime_d))
    return vnew.view(ops.grid.shape), (pol if with_policy else best)


def dense_evaluate_general(ops: DenseOperands, v, policy: Union[DensePolicy, torch.Tensor], *,
                           _wide_index: bool = False, _runtime_d: bool = False):
    """One fixed-policy sweep on general operands under ``policy`` (a
    ``DensePolicy``, or candidate indices best [N] int32, which are gathered
    first with ``gather_policy``): vnew [*grid.shape], pinned on terminal
    nodes. The kernel reads the policy's operands, never ``fc_k``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``dense_evaluate_general.launches`` counts those launches), or, on a
    grid of more than ``MAX_D`` dims (or with ``_runtime_d``, as in
    ``dense_backup_general``), ``wide_dense_evaluate_general``.
    """
    if v.device.type == "cpu":
        return dense_evaluate_reference(ops, v, policy)
    _require_cuda(v, "dense_evaluate_general")
    _require_general(ops, "dense_evaluate_general")
    if ops.grid.ndim > MAX_D or _runtime_d:
        return wide_dense_evaluate_general(ops, v, policy, _wide_index=_wide_index,
                                           _runtime_d=_runtime_d)
    out = _launch_evaluate_general(ops, v, policy, _wide_index)
    dense_evaluate_general.launches += 1
    return out


dense_evaluate_general.launches = 0


def wide_dense_evaluate_general(ops: DenseOperands, v,
                                policy: Union[DensePolicy, torch.Tensor], *,
                                _wide_index: bool = False, _runtime_d: bool = False):
    """``dense_evaluate_general`` on a grid of ``MAX_D < d <= MAX_D_WIDE``
    dims (with ``_runtime_d``, of any ``d <= MAX_D_WIDE``): the kernel's
    run-time-d form (``wide_dense_evaluate_general.launches`` counts its
    launches). CPU tensors take the plain version."""
    if v.device.type == "cpu":
        return dense_evaluate_reference(ops, v, policy)
    _require_cuda(v, "wide_dense_evaluate_general")
    _require_general(ops, "wide_dense_evaluate_general")
    _require_wide(ops, "wide_dense_evaluate_general", _runtime_d)
    out = _launch_evaluate_general(ops, v, policy, _wide_index, True)
    wide_dense_evaluate_general.launches += 1
    return out


wide_dense_evaluate_general.launches = 0


def _launch_evaluate_general(ops: DenseOperands, v, policy, wide_index, runtime_d=False):
    """Launch the general evaluate kernel (the library picks the form by d;
    ``runtime_d`` takes the run-time-d form at any d)."""
    ptrs, scalars = _kernel_inputs(ops, v)
    if not isinstance(policy, DensePolicy):
        _check_policy(v, policy)
        policy = gather_policy(ops, policy)
    _check_general_policy(ops, v, policy)
    vnew = torch.empty(v.numel(), dtype=torch.float32, device=v.device)
    _launch("c3sc_dense_evaluate_general", v, v.data_ptr(), policy.best.data_ptr(),
            _ptr(policy.fpol_k), _ptr(policy.s2pol_k), _ptr(policy.gpol), *ptrs,
            vnew.data_ptr(), *scalars, int(wide_index), int(runtime_d))
    return vnew.view(ops.grid.shape)


def _require_wide(ops: DenseOperands, name, runtime_d=False):
    if ops.grid.ndim <= MAX_D and not runtime_d:
        raise ValueError(f"{name}: grids of more than {MAX_D} dims; the general entry takes "
                         f"d <= {MAX_D}")
