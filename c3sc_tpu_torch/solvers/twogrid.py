"""Global two-grid (coarse-grid) correction for the smooth error modes —
port of ``c3sc_tpu/solvers/twogrid.py``.

Value iteration, and every defect-driven fit such as the polish, is a
smoother: it contracts rough error quickly but smooth error only at
e^{-beta dt} per step, and a smooth error of a few % of the range leaves a
defect of only (1 - e^{-beta dt}) times that. The cure is a coarse-grid
correction:

1. the defect d(x) = (T v)(x) - v(x) at every coarse node, by the fine-grid
   Bellman kernel (device);
2. the error equation under the frozen policy pi = argmin of the current
   backup, on the coarse grid: (I - gamma_c P_c^pi) e_c = (dt_c / dt_f) d_c,
   a 2d+1-point sparse system solved exactly on the host (scipy sparse LU,
   float64; a Krylov solve above 40,000 coarse nodes);
3. e_c prolonged to the fine grid (TT-SVD of the coarse correction, then
   ``tt_refine_grid``) and added to v;
4. a one-sided gate on the sampled Bellman defect, with backtracking steps.

Terminal coarse nodes carry the pinned equation e_c = d. The layer-keeping
coarse grid (``boundary_layer=True``) is non-uniform, so its stencil is the
unequal-spacing one of ``mca._stencil_nonuniform``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops import mca
from c3sc_tpu_torch.ops.argmin import first_argmin
from c3sc_tpu_torch.ops.tt import (TT, _repad, _tt_add_raw, tt_from_dense, tt_gather_eval,
                                   tt_refine_grid, tt_round, tt_scale)
from c3sc_tpu_torch.solvers.ttvi import _pinned_neighbor_values, make_bellman_kernel


def coarse_grid(grid: Grid, boundary_layer: bool = False) -> tuple[Grid, list]:
    """Coarse grid and the per-dim fine indices of its nodes.

    Bounded dims with odd n coarsen to every other node ((n+1)/2 nodes, the
    spacing exactly doubles); periodic and even-n dims are not coarsened.
    ``boundary_layer=True`` keeps the distance-1 nodes next to each face of a
    bounded dim (indices [0, 1, 2, 4, ..., n-3, n-2, n-1]), which makes the
    coarse grid non-uniform: the one-cell boundary layer, where the TT error
    of an absorbing face concentrates, stays representable.

    Returns (coarse Grid, fine_index[k] arrays).
    """
    fine_ix = []
    any_nonuniform = False
    for k in range(grid.ndim):
        n = grid.shape[k]
        if (not grid.periodic[k]) and n % 2 == 1 and grid.uniform:
            if boundary_layer and n >= 9:
                ix = np.concatenate([[0, 1], np.arange(2, n - 2, 2), [n - 2, n - 1]])
                any_nonuniform = True
            elif n >= 5:
                ix = np.arange(0, n, 2)
            else:
                ix = np.arange(n)
        else:
            ix = np.arange(n)
        fine_ix.append(ix)
    if any_nonuniform:
        nodes = [np.asarray(grid.nodes(k))[fine_ix[k]] for k in range(grid.ndim)]
        # periodic dims were not subsampled, so they stay uniform
        gc = Grid.create(grid.lb, grid.ub, [len(ix) for ix in fine_ix], grid.periodic,
                         nodes=[nk.tolist() for nk in nodes])
    else:
        gc = Grid.create(grid.lb, grid.ub, [len(ix) for ix in fine_ix], grid.periodic)
    return gc, fine_ix


def _coarse_neighbor_linear(gc: Grid, idx: np.ndarray, dim: int, step: int):
    """Linear index of the +-step neighbour under the coarse grid's rules."""
    n = gc.shape[dim]
    j = idx[:, dim] + step
    j = np.mod(j, n) if gc.periodic[dim] else np.clip(j, 0, n - 1)
    out = idx.copy()
    out[:, dim] = j
    strides = np.cumprod([1] + list(gc.shape[::-1][:-1]))[::-1]
    return out @ strides


def _blend(vt: TT, et: TT, alpha) -> TT:
    """v + alpha * e, rounded back to v's padding: the sum formed exactly at
    padding 2R, rounded to rank R (tolerance 1e-7), then rounded again at
    1e-8 — the path the JAX package's jitted ``_blend`` takes (inside its
    jit ``tt_add`` cannot read the ranks and always goes through 2R)."""
    R = vt.rmax
    wide = _tt_add_raw(vt, tt_scale(et, alpha), 2 * R)
    return tt_round(_repad(tt_round(wide, 1e-7, R), R), 1e-8, R)


@dataclasses.dataclass
class TwoGridInfo:
    defect_rms_before: float
    defect_rms_after: float
    bres_before: float
    bres_after: float
    correction_scale: float
    accepted: bool


def _frozen_policy(problem, grid, uc, v, idx, node_value_fn):
    """Argmin candidate (first on ties) and its dt at nodes idx."""
    x, vn = _pinned_neighbor_values(problem, grid, v, idx, torch.float32, node_value_fn)
    pp, pm, dtt = mca.transition_all_controls(problem, grid, x, uc)
    g = mca.stage_cost_all(problem, x, uc)
    expect = torch.sum(pp * vn[None, :, 0] + pm * vn[None, :, 1], dim=-1)
    rhs = g * dtt + torch.exp(-problem.beta * dtt) * expect
    c = first_argmin(rhs, 0)
    return c, torch.gather(dtt, 0, c[None])[0]


def coarse_correct(
    problem: ControlProblem,
    grid: Grid,
    controls,
    v: TT,
    kernel=None,
    rmax_corr: int = 24,
    corr_tol: float = 1e-6,
    n_check: int = 4096,
    seed: int = 29,
    chunk: int = 32768,
    gate: bool = True,
    gate_slack: float = 1.05,
    boundary_layer: bool = True,
    clip_mult: float | None = None,
    alphas: Sequence[float] = (1.0, 0.5, 0.25),
    verbose: bool = False,
    node_value_fn=None,
):
    """One global coarse-grid correction of ``v`` (module docstring), on the
    device of v.

    Returns (v_new, TwoGridInfo). With ``gate=True`` the correction is kept
    only if the sampled sup-defect does not regress by more than
    ``gate_slack``; step sizes ``alphas`` are tried in order and the first
    that passes wins. ``clip_mult``: robust clipping of the defect rate on the
    terminal-adjacent ring at clip_mult x (1.48 median |d|); default 0 with
    ``boundary_layer`` (the ring is then represented), else 6.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    d = problem.dx
    dev = v.cores[0].device
    controls = np.asarray(controls)
    uc = torch.as_tensor(controls, dtype=torch.float32, device=dev)
    if kernel is None:
        kernel = make_bellman_kernel(problem, grid, controls, chunk=chunk,
                                     node_value_fn=node_value_fn)
    if clip_mult is None:
        clip_mult = 0.0 if boundary_layer else 6.0
    gc, fine_ix = coarse_grid(grid, boundary_layer=boundary_layer)
    shape_c = gc.shape
    N_c = int(np.prod(shape_c))

    # all coarse nodes, their fine indices and states
    mesh = np.meshgrid(*[np.arange(n) for n in shape_c], indexing="ij")
    idx_c = np.stack([m.ravel() for m in mesh], -1)            # [N_c, d]
    idx_f = np.stack([fine_ix[k][idx_c[:, k]] for k in range(d)], -1)
    tidx_f = torch.as_tensor(idx_f, dtype=torch.int64, device=dev)
    tx = grid.index_to_state(tidx_f)                            # [N_c, d] f32

    def node_values(vt, idx):
        return tt_gather_eval(vt, idx) if node_value_fn is None else node_value_fn(vt, idx)

    # fine defect at the coarse nodes (the Bellman kernel, device)
    with torch.no_grad():
        tv = kernel(v, tidx_f).double().cpu().numpy()
        vv = node_values(v, tidx_f).double().cpu().numpy()
        d_f = tv - vv                                           # [N_c]

        # frozen policy at the coarse nodes: argmin of the current backup
        pieces = [_frozen_policy(problem, grid, uc, v, tidx_f[c0:c0 + chunk], node_value_fn)
                  for c0 in range(0, N_c, chunk)]
        cix = torch.cat([p[0] for p in pieces])
        dt_f = torch.cat([p[1] for p in pieces]).double().cpu().numpy()

        # coarse stencil at the frozen policy
        pp_c, pm_c, dt_c = mca.transition(problem, gc, tx, uc[cix])
        pp_c = pp_c.double().cpu().numpy()
        pm_c = pm_c.double().cpu().numpy()
        dt_c = dt_c.double().cpu().numpy()
        tm, _ = mca.node_terminal(problem, gc, torch.as_tensor(idx_c, device=dev), tx)
        tm = tm.cpu().numpy()
    gam_c = np.exp(-problem.beta * dt_c)

    # sparse system (I - gamma_c P_c) e = (dt_c/dt_f) d ; terminal: e = d
    rows, cols, vals = [np.arange(N_c)], [np.arange(N_c)], [np.ones(N_c)]
    for k in range(d):
        for sgn, p in ((+1, pp_c[:, k]), (-1, pm_c[:, k])):
            rows.append(np.arange(N_c))
            cols.append(_coarse_neighbor_linear(gc, idx_c, k, sgn))
            vals.append(np.where(tm, 0.0, -gam_c * p))
    A = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                      shape=(N_c, N_c))
    rate = (dt_c / np.maximum(dt_f, 1e-30)) * d_f
    # robust clip of the defect rate on the terminal-adjacent ring only: the
    # exit cost's jump there is rough content for the smoother, not smooth
    # defect for this solve
    ring = np.zeros(N_c, bool)
    for k in range(d):
        for sgn in (+1, -1):
            ring |= tm[_coarse_neighbor_linear(gc, idx_c, k, sgn)]
    ring &= ~tm
    sig = 1.48 * np.median(np.abs(rate[~tm & ~ring])) if (~tm & ~ring).any() else 0.0
    if clip_mult > 0 and sig > 0:
        rate = np.where(ring, np.clip(rate, -clip_mult * sig, clip_mult * sig), rate)
    rhs = np.where(tm, d_f, rate)
    if N_c <= 40_000:
        e_c = spla.spsolve(A.tocsc(), rhs)
    else:
        # a direct LU's fill-in explodes with the d-dimensional stencil's
        # bandwidth; (I - gamma_c P_c) is well conditioned (~1/(beta dt_c)),
        # so a Krylov solve needs about a hundred matvecs
        Acsr = A.tocsr()
        e_c, ok = spla.bicgstab(Acsr, rhs, rtol=1e-10, atol=0.0, maxiter=2000)
        if ok != 0:
            e_c, ok = spla.gmres(Acsr, rhs, rtol=1e-10, atol=0.0, restart=50, maxiter=40,
                                 x0=e_c)
            if ok != 0:
                # an unconverged correction is untrustworthy: let the gate
                # see a zero correction rather than noise
                e_c = np.zeros_like(rhs)
    e_dense = e_c.reshape(shape_c)

    # prolong: TT-SVD of the coarse correction, linear-element refinement
    R = v.rmax
    e_tt_c = tt_from_dense(e_dense.astype(np.float32), rmax=min(rmax_corr, R), tol=corr_tol,
                           device=dev)
    e_tt = tt_refine_grid(_repad(e_tt_c, R), gc, grid)

    # gate on the sampled sup-defect (one-sided), backtracking step sizes
    rng = np.random.default_rng(seed)
    check = torch.as_tensor(np.stack([rng.integers(0, n, n_check) for n in grid.shape], -1),
                            device=dev)

    def _bres(vt):
        with torch.no_grad():
            return float((kernel(vt, check) - node_values(vt, check)).abs().max())

    b0 = _bres(v)
    accepted, b1, v_out, alpha_used = False, b0, v, 0.0
    for alpha in (alphas if gate else alphas[:1]):
        v_try = _blend(v, e_tt, torch.tensor(float(alpha), dtype=torch.float32, device=dev))
        b_try = _bres(v_try)
        if (not gate) or b_try <= gate_slack * b0:
            accepted, b1, v_out, alpha_used = True, b_try, v_try, alpha
            break
    info = TwoGridInfo(
        defect_rms_before=float(np.sqrt((d_f ** 2).mean())),
        defect_rms_after=float("nan"),
        bres_before=b0, bres_after=b1,
        correction_scale=float(np.abs(e_c).max()) * (alpha_used or 1.0),
        accepted=bool(accepted))
    if verbose:
        print(f"[twogrid] |e|_max={float(np.abs(e_c).max()):.4f} alpha={alpha_used} "
              f"bres {b0:.4f} -> {b1:.4f} accepted={accepted}", flush=True)
    return v_out, info
