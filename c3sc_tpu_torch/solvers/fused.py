"""Fused tensor-train value iteration — port of ``c3sc_tpu/solvers/fused.py``:
the square interpolation scheme, the rectangular-maxvol scheme
(``oversample > 0``), residual solves against a frozen base (``base=``) and
the iterative refinement built on them (``fused_tt_vi_refined``).

One VI iteration is a left-to-right plus a right-to-left cross sweep over
the Bellman backup: per core, evaluate the backup on the structured fiber
block (``_eval_fibers``: block K2), then fit the core (``_orth_basis_and_rank``
+ ``_hysteresis_rows`` + ``_interp_from_rows``: block K3). Cross index sets
live on the device as padded static-shape tensors ``left/right [d+1, R, d]``,
every per-core operation is masked to the active rank block, and ranks,
counters and the stopping state are 0-d or ``[d+1]`` tensors on the device.

The loop on a GPU. JAX runs the solve as one ``lax.while_loop``. Eager
PyTorch cannot, and a host read of the residual every iteration would stall
the card. So an iteration is **masked**: it computes ``active = cond(carry)``
on the device and returns ``torch.where(active, new, old)`` for every field,
the iteration count included. ``run_fn(carry, n)`` then enqueues ``n``
iterations blind and leaves the carry a ``while_loop`` would leave;
``fused_tt_vi`` reads the carry on the host once per chunk. Nothing inside an
iteration reads a tensor on the host: no ``.item()``, no Python ``if`` on a
tensor, no boolean-mask indexing, and the ``torch.linalg`` calls are the
forms that do not check ``info`` on the host (``solve_ex``, ``lu_factor_ex``
with ``check_errors=False``; ``qr`` and ``slogdet`` check nothing). The one
call without such a form, ``svdvals``, is replaced on CUDA by a count that
needs none (``_needed_rank_sync_free``).

``step_fn(carry, n)`` runs exactly n iterations whatever the stopping state,
as the warm replans of MPC and tracking need. Under ``cuda_graph=True`` it
replays the same captured iteration as ``run_fn``, with a flag on the device
that forces it active.

Seeds: ``fused_tt_vi_refined(seed=)`` is an int or a sequence of the
sub-solves' seeds (``c3sc_tpu_torch.seeds``). A JAX key ``k`` reaches
``init_fn`` as the integer ``key_data(k)[-1]``.

Checkpoints (``fused_tt_vi(checkpoint_path=, resume_from=)``) are the JAX
package's files (``utils/checkpoint.py``).

``mesh=`` shards the fiber block of every core-step over a
``torch.distributed`` device mesh (``c3sc_tpu_torch.parallel``; see
``make_fiber_backup``); cores and index sets stay replicated.

Not ported (raises ``NotImplementedError``): ``_cholqr2``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from c3sc_tpu_torch.device import const_tensor, resolve_device
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops import mca
from c3sc_tpu_torch.ops.argmin import first_argmin
from c3sc_tpu_torch.ops.tt import (TT, _concrete_ranks, _repad, tt_add, tt_gather_eval,
                                   tt_lerp_eval, tt_round)
from c3sc_tpu_torch.seeds import seed_stream
from c3sc_tpu_torch.solvers.ttvi import (bellman_residual_sample, check_refine_method,
                                         refine_controls)
from c3sc_tpu_torch.utils.metrics import GraphSpans, recording, span


class FusedSolver(NamedTuple):
    """Bundle returned by ``make_fused_vi``.

    solve_fn(carry) -> carry         run to convergence (chunks of ``window``
                                     masked iterations, one host read a chunk)
    init_fn(seed, v0=None) -> carry  fresh solver state
    step_fn(carry, n) -> carry       exactly n iterations, whatever the stopping
                                     state (benches, warm replans)
    run_fn(carry, n) -> carry        up to n iterations, enqueued blind; stops
                                     on the SAME conditions as solve_fn
    """

    solve_fn: object
    init_fn: object
    step_fn: object
    run_fn: object


class FusedCarry(NamedTuple):
    cores: tuple              # d x [R, n_k, R] current value TT (padded-zero)
    ranks: torch.Tensor       # [d+1] int32
    left: torch.Tensor        # [d+1, R, d] int64
    right: torch.Tensor       # [d+1, R, d] int64
    rl: torch.Tensor          # [d+1] int32 active left-set sizes
    rr: torch.Tensor          # [d+1] int32 active right-set sizes
    # FIT ranks per bond — equal to rl/rr in the square scheme; under
    # oversampling rl/rr carry the sample-row counts s >= the fit ranks
    rlf: torch.Tensor         # [d+1] int32 active left FIT ranks
    rrf: torch.Tensor         # [d+1] int32 active right FIT ranks
    rows_l: torch.Tensor      # [d, R] int64 — pivot rows per core (L2R)
    rows_r: torch.Tensor      # [d, R] int64 — pivot rows per core (R2L)
    it: torch.Tensor          # int32
    residual: torch.Tensor    # float — per-iteration sample change
    long_res: torch.Tensor    # float — sample change over the last window
    wstall: torch.Tensor      # int32 — windows without long_res improvement
    v_sample: torch.Tensor    # [S]
    sample_ref: torch.Tensor  # [S] — snapshot at the last window boundary
    # closed-loop probe harvesting (optional)
    probe_cost: torch.Tensor  # float — last probe's mean discounted cost
    best_cost: torch.Tensor   # float — best probe cost seen
    cores_best: tuple         # cores snapshot at best_cost
    ranks_best: torch.Tensor  # [d+1]
    frozen: torch.Tensor      # bool — sticky adaptation-freeze latch
    freeze_mark: torch.Tensor   # float — long_res when the latch engaged
    best_long: torch.Tensor   # float — best windowed residual seen (monotone)
    best_absdisp: torch.Tensor  # float — best ABSOLUTE windowed displacement
    warm_until: torch.Tensor  # int32 — free-repivot warmup end (reset on growth)


def _not_ported(what: str, waits_for: str):
    raise NotImplementedError(f"{what} is not ported yet: it waits for {waits_for}")


def _solve_device(device, mesh) -> torch.device:
    """``device`` resolved; None with a mesh is the mesh's device."""
    if device is None and mesh is not None:
        from c3sc_tpu_torch.parallel.mesh import mesh_device

        return mesh_device(mesh)
    return resolve_device(device)


def _cholqr2(C):
    """CholeskyQR2 basis (unused by the square scheme's main path)."""
    _not_ported("_cholqr2", "a solver option that selects it (the main path uses Householder QR)")


def _interp_from_rows_ls(qe, rows, r_new, s_rows):
    """Rectangular-maxvol core G = qe pinv(qe[rows]) [m, R] with
    ``s_rows >= r_new`` active sample rows (Mikhalev-Oseledets rect-maxvol).

    The square interpolation core is an oblique projector whose norm the
    d-fold core chain amplifies; a least-squares fit onto the same column
    basis from ~2x rows approaches an orthogonal projection on the sampled
    rows. ``s_rows == r_new`` recovers the square scheme (pinv of a square
    nonsingular matrix). The bond then carries s_rows columns (rank r_new
    content, zero beyond s_rows); rows beyond s_rows are zeroed before the
    normal equations. The solve does not check ``info`` on the host.
    """
    R = qe.shape[1]
    col = torch.arange(R, device=qe.device)
    rowmask = (col < s_rows).to(qe.dtype)
    colmask = (col < r_new).to(qe.dtype)
    sub = qe[rows] * rowmask[:, None] * colmask[None, :]   # [R(s-pad), R(col-pad)]
    # normal equations with a scaled ridge; inactive columns get the identity
    # so the solve stays nonsingular and their G columns are exactly zero
    Gm = sub.T @ sub
    ridge = 1e-6 * torch.clamp(torch.trace(Gm) / torch.clamp(r_new, min=1), min=1e-30)
    Gm = Gm + ridge * torch.eye(R, dtype=qe.dtype, device=qe.device)
    Gm = Gm + torch.diag((col >= r_new).to(qe.dtype))
    X, _ = torch.linalg.solve_ex(Gm, sub.T, check_errors=False)   # pinv(sub) [R(col), R(s)]
    G = (qe * colmask[None, :]) @ X
    return G * rowmask[None, :]


def _extend_rows(qe, rows, r_new, s_rows):
    """Extend r_new maxvol rows to ``s_rows`` in all by top leverage (row norm
    of the orthonormal basis), excluding rows already selected.

    The maxvol swaps can emit duplicate row ids, so the selected set is
    marked with a scatter-max (a scatter-set with duplicates is order-
    undefined and could clear a selected row). Ties in leverage go to the
    lowest index, as ``jax.lax.top_k`` breaks them: a stable descending sort.
    """
    m, R = qe.shape
    col = torch.arange(R, device=qe.device)
    lev = torch.sum(qe * qe, dim=1)
    taken = torch.zeros(m, dtype=torch.int32, device=qe.device).scatter_reduce(
        0, rows, (col < r_new).to(torch.int32), "amax", include_self=True) > 0
    lev = torch.where(taken, torch.full_like(lev, -float("inf")), lev)
    extra = torch.sort(lev, descending=True, stable=True).indices[:R]   # [R] extensions
    # positions [r_new, s_rows) take extension rows; beyond s_rows keep 0
    ext = extra[torch.clamp(col - r_new, 0, R - 1)]
    return torch.where(col < r_new, rows,
                       torch.where(col < s_rows, ext, torch.zeros_like(rows)))


def _first_argmax(a):
    """Index of the first maximum of a 1-D tensor, the same on every device
    (``torch.argmax`` promises no order among ties on CUDA). NaN counts as
    the largest value, as in ``jnp.argmax``."""
    a = torch.nan_to_num(a, nan=float("inf"))
    ar = torch.arange(a.shape[0], device=a.device)
    return torch.where(a == a.max(), ar, a.shape[0]).min()


def _needed_rank(rfac, eps_rank):
    """Number of singular values of the triangular factor above ``eps_rank``
    times the largest, at least 1, as the JAX package counts them: from
    ``svdvals``. On CUDA ``torch.linalg.svdvals`` checks ``info`` on the host
    (it has no ``_ex`` form), so there this call makes the host wait."""
    s = torch.linalg.svdvals(rfac)
    smax = torch.clamp(s[0], min=1e-30)
    return torch.clamp(torch.sum(s > eps_rank * smax).to(torch.int32), min=1)


def _needed_rank_sync_free(rfac, eps_rank):
    """The count of ``_needed_rank`` without a singular value decomposition,
    from calls that never read the device on the host (and so can be
    captured in a CUDA graph).

    In float64, with M = rfac^T rfac: the largest eigenvalue comes from 2^8
    steps of the power iteration, done as eight squarings of the normalised
    M and one Rayleigh quotient. The number of eigenvalues of M above
    tau^2 = (eps_rank s_max)^2 is the number of positive eigenvalues of
    S = M - tau^2 I, which by Jacobi's rule is R minus the number of sign
    changes in the sequence 1, det S[:1,:1], det S[:2,:2], ..., det S: one
    batched ``slogdet`` of the R leading blocks, each padded with an identity.
    tau^2 / lambda_max = 1e-8 is far above float64's resolution; the count
    can differ from the SVD's only where a singular value sits within the
    power iteration's error (under 1e-3 relative) of the threshold.
    """
    R = rfac.shape[0]
    dev = rfac.device
    M = rfac.double()
    M = M.T @ M
    tiny = 1e-300
    B = M / torch.clamp(torch.linalg.matrix_norm(M), min=tiny)
    for _ in range(8):
        B = B @ B
        B = B / torch.clamp(torch.linalg.matrix_norm(B), min=tiny)
    # B ~ u u^T: its column at the largest diagonal entry is the top eigenvector
    top = _first_argmax(torch.diagonal(B))
    v = B.index_select(1, top.reshape(1))[:, 0]
    lam = (v @ (M @ v)) / torch.clamp(v @ v, min=tiny)
    tau2 = (eps_rank ** 2) * torch.clamp(lam, min=1e-60)
    eye = torch.eye(R, dtype=M.dtype, device=dev)
    S = M - tau2 * eye
    lead = (torch.arange(R, device=dev)[None, :] <= torch.arange(R, device=dev)[:, None])
    block = (lead[:, :, None] & lead[:, None, :]).to(M.dtype)       # [R, R, R]: k-th leading block
    minors = S[None] * block + eye[None] * (1.0 - lead.to(M.dtype))[:, :, None]
    with _prefer_cusolver(minors):
        sign = torch.linalg.slogdet(minors).sign
    prev = torch.cat([torch.ones(1, dtype=sign.dtype, device=dev), sign[:-1]])
    negative = torch.sum(sign != prev)
    return torch.clamp((R - negative).to(torch.int32), min=1)


def _orth_basis_and_rank(C, noise, eps_rank, kick, rmax_active, row_mask, r_prev, frozen,
                         sync_free: bool = False):
    """One QR of the fiber matrix serves both rank estimation and the
    (kick-enriched) orthonormal basis, with MONOTONE rank selection.

    - the needed rank is counted from the singular values of the small
      [R, R] triangular factor (``sync_free`` picks the count that never
      reads the device on the host);
    - rank rule (see ``_hysteresis_rank``): grow by the kick width when the
      estimate saturates the current active size, never shrink;
    - the basis keeps REAL directions for all but the last ``kick`` active
      columns; random exploration noise is bounded at ``kick`` columns no
      matter how large the active rank grows, and it is Gram-Schmidt-
      orthogonalised against q instead of a second tall QR.
    Returns (qe [m, R], r_need, r_new).
    """
    m, R = C.shape
    col = torch.arange(R, device=C.device)
    q, rfac = torch.linalg.qr(C)                 # [m, R], [R, R]
    r_need = (_needed_rank_sync_free if sync_free else _needed_rank)(rfac, eps_rank)
    r_adapt = torch.minimum(torch.clamp(r_need + kick, min=1), rmax_active.to(torch.int32))
    r_new = torch.where(frozen, r_prev, _hysteresis_rank(r_need, r_adapt, r_prev))
    # noise only beyond the NEEDED directions, and at most `kick` columns:
    # at saturation (r_need == r_new, e.g. capped at rmax) this leaves ZERO
    # noise columns; frozen sweeps get pure real directions
    r_keep = torch.minimum(torch.clamp(torch.maximum(r_need, r_new - kick), min=1), r_new)
    r_keep = torch.where(frozen, r_new, r_keep)
    keepmask = (col < r_keep).to(C.dtype)
    kickmask = ((col >= r_keep) & (col < r_new)).to(C.dtype)
    z = noise * row_mask[:, None]
    z = z - q @ (q.T @ z)                        # orthogonalise vs q
    z = z / torch.clamp(torch.linalg.norm(z, dim=0, keepdim=True), min=1e-12)
    qe = q * keepmask[None, :] + z * kickmask[None, :]
    qe = qe * row_mask[:, None]
    return qe, r_need, r_new


def _interp_from_rows(qe, rows, r_new):
    """Interpolation core G = qe inv(qe[rows]) [m, R]; G[rows] = I on the
    active block, padded cols exactly zero.

    A small scaled ridge keeps the solve finite when the pivot submatrix is
    (near-)singular — a transiently bad pivot then yields a poor but FINITE
    core instead of NaN-poisoning the whole loop state. Overflow/NaN
    protection lives at the fitting boundary (the scrub in ``_eval_fibers``),
    not in a clip of G. The solve does not check ``info`` on the host.
    """
    R = qe.shape[1]
    col = torch.arange(R, device=qe.device)
    sub = qe[rows]                               # [R, R]
    sub = sub + torch.diag((col >= r_new).to(qe.dtype))
    ridge = 1e-6 * torch.clamp(torch.max(torch.abs(sub)), min=1.0)
    sub = sub + ridge * torch.eye(R, dtype=qe.dtype, device=qe.device)
    sol, _ = torch.linalg.solve_ex(sub.T, qe.T, check_errors=False)
    return sol.T


class _prefer_cusolver:
    """Route the ``torch.linalg`` calls inside the block to cuSOLVER when
    ``t`` is a CUDA tensor. torch's default choice sends a non-square LU and a
    batched LU of 32 x 32 and larger to MAGMA, which synchronises the device
    and cannot be captured in a CUDA graph; cuSOLVER does neither. Only those
    two calls are routed: for the square solves of the core fit the default
    (batched cuBLAS) is the faster one."""

    def __init__(self, t):
        self.on = t.is_cuda

    def __enter__(self):
        if self.on:
            self.before = torch.backends.cuda.preferred_linalg_library()
            torch.backends.cuda.preferred_linalg_library("cusolver")

    def __exit__(self, *exc):
        if self.on:
            torch.backends.cuda.preferred_linalg_library(self.before)


def _tall_lu(A):
    """Partial-pivoted LU of a tall [K, R] matrix without a host sync:
    (LU, pivots) of ``lu_factor_ex``."""
    with _prefer_cusolver(A):
        return torch.linalg.lu_factor_ex(A, check_errors=False)[:2]


def _pivot_rows(qe, r_new, n_swaps: int | None = None):
    """Maxvol pivot rows: partial-pivoted LU seed + greedy swap refinement.

    The LU seed runs on the top-8R rows by norm; the greedy swaps scan ALL m
    rows, so a pivot outside the subset can always enter. Each refinement
    builds G = qe inv(qe[rows]); if max |G_ij| > 1.05, row j of the pivot
    set is replaced by the offending row i (the classic maxvol iteration).

    Ties are broken by lowest index, as ``jax.lax.top_k`` and ``jnp.argmax``
    break them: masked rows of ``qe`` have norm exactly 0, so ties are
    common. The row subset comes from a stable descending sort and the swap
    candidate from ``_first_argmax``.
    """
    m, R = qe.shape
    if n_swaps is None:
        n_swaps = 6      # more swaps make the pivot sets churn under hysteresis
    K = min(m, 8 * R)
    norms = torch.sum(qe * qe, dim=1)
    cand = torch.sort(norms, descending=True, stable=True).indices[:K]   # [K] row ids
    # A = P L U, so the row permutation with A[perm] = L U is argmax over
    # P's rows (lu_factor's LAPACK pivots are sequential swaps, not this)
    LU, pivots = _tall_lu(qe[cand])              # LU on the [K, R] subset
    P, _, _ = torch.lu_unpack(LU, pivots, unpack_data=False)
    perm = P.argmax(dim=0)
    rows = cand[perm[:R]]
    ar = torch.arange(R, device=qe.device)
    for _ in range(n_swaps):
        G = _interp_from_rows(qe, rows, r_new).reshape(-1)
        flat = _first_argmax(torch.abs(G))
        i, j = flat // R, flat % R
        # (G[flat] with a 0-d index would read it on the host)
        do_swap = (torch.abs(G.index_select(0, flat.reshape(1))[0]) > 1.05) & (j < r_new)
        rows = torch.where(do_swap & (ar == j), i, rows)
    return rows


def _logvol(qe, rows, r_new):
    """log |det| of the active pivot submatrix (inactive block -> identity)."""
    R = qe.shape[1]
    col = torch.arange(R, device=qe.device)
    sub = qe[rows] + torch.diag((col >= r_new).to(qe.dtype))
    return torch.linalg.slogdet(sub).logabsdet


def _hysteresis_rank(r_need, r_adapt, r_prev):
    """MONOTONE rank selection (never shrink, grow on saturation).

    Shrinking is never worth it under padded static shapes — the compute
    cost is identical at any active rank <= R, while a rank drop resets the
    pivot set and kick columns, which can tip an almost-converged solve into
    a permanent limit cycle. ``r_need`` is counted from the singular values
    of the ACTIVE fiber block, so it can never exceed the current active
    rank — growth comes through the kick columns: when the estimate
    SATURATES the active size (r_need >= r_prev), enlarge by the kick; once
    it stabilises below the active size the rank freezes for good."""
    saturated = r_need >= r_prev
    return torch.where(saturated, torch.maximum(r_adapt, r_prev), r_prev)


def _hysteresis_rows(qe, rows_prev, r_new, r_prev, in_warmup, frozen, log_gain: float = 0.4):
    """Pivot selection with hysteresis + convergence freeze.

    Fresh LU/maxvol pivots every sweep inject approximation noise that VI
    amplifies by 1/(1-gamma); hard-frozen pivots go unstable when the value
    drifts. Hysteresis keeps the PREVIOUS pivot set unless the fresh one
    improves submatrix volume by exp(log_gain) (or the rank changed, or
    we're still in the adaptation warmup). ``frozen``: once the sample
    residual is small, pivot adaptation stops ENTIRELY and the sweep is a
    deterministic interpolated Bellman operator that contracts cleanly.
    """
    rows_new = _pivot_rows(qe, r_new)
    switch = (~frozen) & (
        in_warmup
        | (r_new != r_prev)
        | (_logvol(qe, rows_new, r_new) > _logvol(qe, rows_prev, r_new) + log_gain)
    )
    return torch.where(switch, rows_new, rows_prev)


def _shift_coord(j, m: int, sign: int, grid: Grid):
    """Neighbor coordinate under boundary rules (matches Grid.neighbor_index)."""
    n = grid.shape[m]
    if grid.periodic[m]:
        return torch.remainder(j + sign, n)
    return torch.clamp(j + sign, 0, n - 1)


def make_structured_fiber_eval(grid: Grid, k: int, rmax: int, dtype=torch.float32):
    """Structured TT evaluation on a cross-fiber block + ALL +-1 neighbors.

    The evaluation set I_k x grid_k x J_{k+1} is a structured block, so
    prefix/suffix partial products are shared across the whole block. Per
    left row we cache forward interface vectors and backward suffix
    matrices; a dim-m neighbor then costs two small matvecs instead of a
    fresh d-core chain, and each of the 2d+1 value tensors assembles with
    one [R,R] x [R,n,R] x [R,R] contraction — O(d n R^3) total against
    O(d^2 n R^4) for independent gather-evals, with no [B, R, R] gather.

    Where the JAX version vmaps a per-row function over the index rows,
    every step here is batched over that axis (gathers ``cores[j][:, idx[:,
    j], :]`` give one [A, R, R] stack of per-row matrices, then ``matmul``).
    The row counts A and B are free: a base TT padded to ``rmax`` is
    evaluated on the index sets of a correction padded otherwise.

    Returns fn(cores, left_k [A,d], right_k1 [B,d]) ->
      (vp [d, A, n, B], vm [d, A, n, B], v0 [A, n, B]): the + and - neighbor
      values per dim and the centre values.
    """
    d = grid.ndim
    R = rmax
    n = grid.shape[k]
    plus_np = np.arange(n) + 1
    minus_np = np.arange(n) - 1
    if grid.periodic[k]:
        plus_np %= n
        minus_np %= n
    else:
        plus_np = np.clip(plus_np, 0, n - 1)
        minus_np = np.clip(minus_np, 0, n - 1)
    pm_np = np.concatenate([plus_np, minus_np])

    def row_mats(core, j):
        """core [R, n_j, R], j [...] node ids -> per-row matrices [..., R, R]."""
        return core[:, j.reshape(-1), :].permute(1, 0, 2).reshape(*j.shape, R, R)

    def fn(cores, left_k, right_k1):
        dev = cores[0].device
        A, Bn = left_k.shape[0], right_k1.shape[0]
        # e_0 for every row
        e0 = (torch.arange(R, device=dev) == 0).to(dtype)
        eye = torch.eye(R, dtype=dtype, device=dev)
        pm_map = const_tensor(pm_np, torch.int64, dev)

        # ---- left rows a: prefix vectors p, suffix matrices S ----
        M = [row_mats(cores[j], left_k[:, j]) for j in range(k)]     # [A, R, R]
        p = e0.expand(A, R)
        ps = []
        for j in range(k):
            ps.append(p)
            p = torch.matmul(p[:, None, :], M[j])[:, 0]
        S = eye.expand(A, R, R)
        Ss = [None] * k
        for j in range(k - 1, -1, -1):
            Ss[j] = S
            S = torch.matmul(M[j], S)
        P2 = []                                          # per m: [2, A, R] (+, -)
        for m in range(k):
            jn = torch.stack([_shift_coord(left_k[:, m], m, sg, grid) for sg in (1, -1)])
            Mn = row_mats(cores[m], jn)                  # [2, A, R, R]
            P2.append(torch.matmul(torch.matmul(ps[m][None, :, None, :], Mn), Ss[m][None])[:, :, 0])
        p0 = p                                           # [A, R]

        # ---- right rows b: suffix vectors s, prefix matrices T ----
        N = {j: row_mats(cores[j], right_k1[:, j]) for j in range(k + 1, d)}
        s = e0.expand(Bn, R)
        sa = [None] * d  # sa[j]: suffix vector for cores j+1..d-1
        for j in range(d - 1, k, -1):
            sa[j] = s
            s = torch.matmul(N[j], s[:, :, None])[:, :, 0]
        T = eye.expand(Bn, R, R)
        Ts = [None] * d  # Ts[j]: prefix matrix cores k+1..j-1
        for j in range(k + 1, d):
            Ts[j] = T
            T = torch.matmul(T, N[j])
        S2 = []                                          # per m: [2, B, R]
        for m in range(k + 1, d):
            jn = torch.stack([_shift_coord(right_k1[:, m], m, sg, grid) for sg in (1, -1)])
            Mn = row_mats(cores[m], jn)                  # [2, B, R, R]
            S2.append(torch.matmul(Ts[m][None], torch.matmul(Mn, sa[m][None, :, :, None]))[..., 0])
        s0 = s                                           # [B, R]

        G = cores[k]
        # ONE batched contraction per neighbor group (left dims / dim k /
        # right dims), both signs at once
        Gs0 = torch.einsum("rns,bs->rnb", G, s0)         # shared right product
        parts = []                                       # each [2, dims, A, n, B]
        if k > 0:
            Pst = torch.stack(P2, dim=2)                 # [2, A, k, R]
            parts.append(torch.einsum("zamr,rnb->zmanb", Pst, Gs0))
        own = torch.einsum("ar,rnb->anb", p0, Gs0[:, pm_map])        # [A, 2n, B]
        parts.append(own.reshape(A, 2, n, Bn).permute(1, 0, 2, 3)[:, None])
        if k < d - 1:
            p0G = torch.einsum("ar,rns->ans", p0, G)     # shared left product
            Sst = torch.stack(S2, dim=2)                 # [2, B, d-k-1, R]
            parts.append(torch.einsum("ans,zbms->zmanb", p0G, Sst))
        both = torch.cat(parts, dim=1)                   # [2, d, A, n, B]
        # centre values at the block nodes themselves, one extra contraction
        # on the shared right product
        v0 = torch.einsum("ar,rnb->anb", p0, Gs0)
        return both[0], both[1], v0  # [d, A, n, B] x2, [A, n, B]

    return fn


def _scrub(val, vb):
    """Replace NaN/inf by finite values: NaN and +inf by the UPPER value bound
    when bounds exist (a spuriously LOW value is optimistic and ATTRACTS the
    Bellman min toward the scrubbed node; the pessimistic bound is self-
    correcting for a min), else 0 and +-1e12 (not bigger: the fitting QR
    squares column entries)."""
    return torch.nan_to_num(val,
                            nan=float(vb[1]) if vb is not None else 0.0,
                            posinf=float(vb[1]) if vb is not None else 1e12,
                            neginf=float(vb[0]) if vb is not None else -1e12)


def make_fiber_backup(problem: ControlProblem, grid: Grid, uc, rmax: int,
                      dtype=torch.float32, debug_identity: bool = False,
                      refine_steps: int = 0, refine_method: str = "pgd",
                      base: TT | None = None, mesh=None):
    """Block K2 of a core-step: the Bellman backup on the structured fiber
    block of core k. ``uc [C, du]`` is the candidate set as a tensor on the
    solve's device. ``refine_steps > 0`` polishes every node's brute-force
    winner with that many continuous steps (``solvers/ttvi.refine_controls``)
    after the min, before the clip and the pin.

    ``base``: a FIXED value TT. The backup is then that of the TOTAL value
    base + w (the base's neighbour values added, value bounds and terminal
    pinning applied to the total) minus the base at the block nodes: the
    fiber values of the residual fixed point w = T(base + w) - base. The
    base's structured evaluator is built at the base's own padding and
    shares the correction's index sets; its cores are moved to the solve's
    device once, here, and live as long as the returned function.

    ``mesh``: a ``DeviceMesh`` (``parallel.make_mesh``) on the kind of
    ``uc``'s device. Each rank then backs up the rows of the block
    ``[R * n_k * R]`` that its ``'fibers'`` coordinate owns (the block padded
    to a multiple of the axis size by repeating its last row) against the
    candidates its ``'ctrl'`` coordinate owns (padded by repeating the last
    one, which cannot change a min); a MIN over ``'ctrl'`` and a gather over
    ``'fibers'`` give every rank the whole block. With ``refine_steps > 0``
    the candidates' RHS is gathered over ``'ctrl'`` instead, so that
    ``first_argmin`` sees all C in order. These are the constraints the JAX
    package puts on the block (nodes over ``'fibers'``, the per-candidate RHS
    over ``'ctrl'``), and the collectives GSPMD inserts for them.

    Returns fn(cores, ranks, k, left_k [R, d], right_k1 [R, d]) -> [R, n_k, R]:
    the backed-up value at every node of I_k x grid_k x J_{k+1}, with terminal
    nodes pinned, values clipped to the problem's bounds and non-finite
    values scrubbed."""
    d = problem.dx
    R = rmax
    shape = grid.shape
    device = uc.device
    vb = problem.value_bounds
    if base is not None:
        R_base = base.rmax
        base_cores = tuple(c.to(device=device, dtype=dtype) for c in base.cores)
        struct_eval_base = [make_structured_fiber_eval(grid, k, R_base, dtype) for k in range(d)]

    def _build_idx(k, left_k, right_k1):
        """Evaluation multi-indices [R, n_k, R, d] for core k: left set's
        columns below k, the node of dim k, the right set's columns above."""
        n = shape[k]
        A = left_k[:, None, None, :k].expand(R, n, R, k)
        I = torch.arange(n, device=device)[None, :, None, None].expand(R, n, R, 1)
        B = right_k1[None, None, :, k + 1:].expand(R, n, R, d - k - 1)
        return torch.cat([A, I, B], dim=-1)

    struct_eval = [make_structured_fiber_eval(grid, k, R, dtype) for k in range(d)]
    eye_d = torch.eye(d, dtype=torch.bool, device=device)
    n_uc = uc.shape[0]
    uc_own = uc
    if mesh is not None:
        from c3sc_tpu_torch.parallel.mesh import (axis_index, axis_size, check_device,
                                                  gather_rows, min_over)

        check_device(mesh, device)

        def own_rows(n, axis):
            """This rank's block of n rows along ``axis``, padded by repeating
            the last row: a slice, or an index tensor where it pads."""
            m = -(-n // axis_size(mesh, axis))
            lo = axis_index(mesh, axis) * m
            if lo + m <= n:
                return slice(lo, lo + m)
            return torch.clamp(torch.arange(lo, lo + m, device=device), max=n - 1)

        uc_own = uc[own_rows(n_uc, "ctrl")]
        block_rows = [own_rows(R * n * R, "fibers") for n in shape]

    def _eval_fibers(cores, ranks, k, left_k, right_k1):
        """Bellman backup on the structured fiber block via the amortized
        neighbor evaluator (no per-point TT gathers)."""
        with span("fiber_backup"):
            n = shape[k]
            flat_idx = _build_idx(k, left_k, right_k1).reshape(-1, d)
            if debug_identity:
                val = tt_gather_eval(TT(cores, ranks), flat_idx)
                return val.to(dtype).reshape(R, n, R)
            # padded-zero cores make the products exact without the ranks
            vp, vm, _ = struct_eval[k](cores, left_k, right_k1)  # [d, R, n, R]
            if base is not None:
                # back up the TOTAL value: neighbours of base + correction
                vpb, vmb, base_v0 = struct_eval_base[k](base_cores, left_k, right_k1)
                vp, vm = vp + vpb, vm + vmb
            B = R * n * R
            vn = torch.stack([vp, vm], dim=0).reshape(2, d, B).permute(2, 0, 1)
            if mesh is not None:
                # this rank's rows of the block from here to the gather
                flat_idx, vn = flat_idx[block_rows[k]], vn[block_rows[k]]
                if base is not None:
                    base_v0 = base_v0.reshape(-1)[block_rows[k]]
                B = flat_idx.shape[0]
            x = grid.index_to_state(flat_idx).to(dtype)          # [B, d]
            if vb is not None:
                vn = torch.clamp(vn, vb[0], vb[1])
            # pin neighbor values at terminal neighbor nodes — ALL 2d
            # neighbor sets classified in one batched node_terminal call
            shifted = torch.stack(
                [torch.stack([_shift_coord(flat_idx[:, m], m, sg, grid) for m in range(d)],
                             dim=-1) for sg in (1, -1)], dim=0)          # [2, B, d]
            nb_all = torch.where(eye_d[None, :, None, :], shifted[:, None, :, :],
                                 flat_idx[None, None, :, :])             # [2, d, B, d]
            nb_flat2 = nb_all.reshape(-1, d)
            nxs = grid.index_to_state(nb_flat2).to(dtype)
            tmn, tvn = mca.node_terminal(problem, grid, nb_flat2, nxs)
            tmn = tmn.reshape(2, d, B).permute(2, 0, 1)                  # [B, 2, d]
            tvn = tvn.reshape(2, d, B).permute(2, 0, 1).to(dtype)
            vn = torch.where(tmn, tvn, vn)
            # all-candidates stencil + cost: one drift contraction for all C
            pp, pm, dtt = mca.transition_all_controls(problem, grid, x, uc_own)
            g = mca.stage_cost_all(problem, x, uc_own)                   # [C, B]
            expect = torch.sum(pp * vn[None, :, 0] + pm * vn[None, :, 1], dim=-1)
            rhs = g * dtt + torch.exp(-problem.beta * dtt) * expect
            if mesh is not None and refine_steps > 0:
                rhs = gather_rows(rhs, mesh, "ctrl")[:n_uc]
            val = torch.min(rhs, dim=0).values
            if mesh is not None and refine_steps == 0:
                val = min_over(val, mesh, "ctrl")
            if refine_steps > 0:
                u0 = uc[first_argmin(rhs, 0)]                            # [B, du]
                _, val = refine_controls(problem, grid, x, vn, u0, val, refine_steps,
                                         refine_method)
            if vb is not None:
                val = torch.clamp(val, vb[0], vb[1])
            tm, tv = mca.node_terminal(problem, grid, flat_idx, x)
            val = torch.where(tm, tv.to(dtype), val)
            # finite-state guarantee: a transiently singular pivot set emits
            # a huge-|G| core whose d-fold chain products overflow f32 to
            # inf, and inf - inf turns NaN in the next contraction; clamping
            # cannot catch it (clamp(NaN) = NaN). Scrubbing HERE — at the
            # fitting boundary — keeps the loop state finite: a scrubbed
            # fiber value is one bad sample the next sweep re-fits.
            val = _scrub(val, vb)
            if base is not None:
                # fit only the correction: the (pinned, bounded) total backup
                # minus the frozen base at the block nodes (centre values of
                # the structured evaluator, not a gather)
                val = val - base_v0.reshape(-1)
            if mesh is not None:
                val = gather_rows(val, mesh, "fibers")[:R * n * R]
            return val.to(dtype).reshape(R, n, R)

    return _eval_fibers


def make_fused_vi(
    problem: ControlProblem,
    grid: Grid,
    controls,
    rmax: int = 16,
    kick: int = 2,
    eps_rank: float = 1e-4,
    tol: float = 1e-4,
    max_iters: int = 2000,
    sample_size: int = 256,
    window: int = 50,
    patience: int = 6,
    freeze_res: float = 1e-2,
    freeze_after: int = 2,
    probe_rollouts: int = 0,
    probe_steps: int = 200,
    probe_dt: float = 0.01,
    probe_x0=None,
    dtype=torch.float32,
    mesh=None,
    refine_steps: int = 0,
    refine_method: str = "pgd",
    target_mode: str = "self",
    n_inner: int = 1,
    debug_identity: bool = False,
    base: TT | None = None,
    oversample: float = 0.0,
    device=None,
    cuda_graph: bool = False,
    sync_free: bool | None = None,
):
    """Build the fused solver on ``device`` (None: the default CUDA device).
    Returns a ``FusedSolver`` bundle.

    ``sync_free``: count the needed rank of a fiber matrix without
    ``torch.linalg.svdvals``, which on CUDA reads ``info`` on the host
    (``_needed_rank_sync_free``). None (default) means True on a CUDA device,
    where an iteration then reads nothing on the host, and False on the CPU,
    where the count is the JAX package's own.

    ``target_mode``: ``'self'`` (default) couples fitting and evaluation —
    each half sweep evaluates the backup of the evolving iterate; cheapest,
    converges on 2-4D problems. ``'frozen'`` evaluates every fiber of an
    iteration against the FIXED sweep-entry iterate, running ``n_inner``
    index-refinement sweeps per iteration.

    ``freeze_after``: windows without long-residual improvement before the
    sticky adaptation-freeze latch engages (see ``body``).

    ``debug_identity``: fit the target itself instead of its Bellman backup
    (isolates the cross fitting machinery from the operator).

    ``cuda_graph``: capture one masked iteration as a CUDA graph and replay
    it (CUDA devices only, ``probe_rollouts == 0``). The capture happens at
    the first ``run_fn``/``step_fn`` call; if a call inside the iteration
    refuses capture, that raises — nothing switches back to the eager loop.
    ``run_fn`` and ``step_fn`` share the one capture (and its memory pool).

    ``refine_steps > 0``: the fiber backup polishes every node's candidate
    winner with that many continuous steps, ``refine_method`` 'pgd' or
    'lbfgs' (see ``make_fiber_backup``).

    ``oversample``: rectangular-maxvol oversampling factor. 0 (default) is
    the square interpolation scheme; ``os > 0`` carries
    ``s = ceil((1+os) r)`` sample rows per bond and builds cores by least
    squares onto the fitted basis (``_interp_from_rows_ls``). Fit ranks are
    capped at R/(1+os) so the extended rows fit the padding.

    ``base``: a FIXED value TT; the solver then solves the residual fixed
    point w = T(base + w) - base and carries only w (``make_fiber_backup``).
    The probe, where there is one, scores the total base + w.

    Stopping (any of):
      - per-iteration sample residual < tol;
      - change over a whole ``window`` of iterations < tol;
      - ``patience`` consecutive windows without 2% improvement of the
        absolute windowed displacement — the plateau at the TT truncation
        floor.

    ``probe_rollouts > 0`` enables closed-loop probe harvesting: at every
    window boundary a fixed-seed batch of Euler–Maruyama rollouts under the
    implicit policy of the CURRENT iterate runs; the iterate with the best
    realized discounted cost is snapshotted and returned. Whether an
    iteration is a window boundary is decided on the host from the iteration
    count read once when ``run_fn``/``step_fn`` is entered (while the masked
    loop is active the device count advances by one per iteration, and once
    it is inactive every result is discarded), so no iteration reads it.

    ``mesh``: a ``torch.distributed`` ``DeviceMesh`` (``parallel.make_mesh``)
    of the kind of ``device`` (None: the mesh's device). The Bellman fiber
    block, the solve's dominant compute, is then split over its ranks: nodes
    over ``'fibers'``, the per-candidate RHS over ``'ctrl'`` where the mesh
    has that axis (``make_fiber_backup``). Every rank fits the whole gathered block with
    the same library, so cores, index sets and ranks stay replicated and the
    ranks in lockstep; every rank runs the same solve and calls it the same
    number of times. The collectives are captured in the iteration's graph
    under ``cuda_graph=True``.
    """
    if target_mode not in ("self", "frozen"):
        raise ValueError(f"target_mode must be 'self' or 'frozen', got {target_mode!r}")
    check_refine_method(refine_method)
    device = _solve_device(device, mesh)
    if sync_free is None:
        sync_free = device.type == "cuda"
    if cuda_graph and (device.type != "cuda" or probe_rollouts > 0 or not sync_free):
        raise ValueError("cuda_graph=True needs a CUDA device, probe_rollouts == 0 and "
                         "sync_free=True")
    d = problem.dx
    R = rmax
    shape = grid.shape
    # static feasible bond dimensions: the TT rank at bond k can never
    # exceed min(prod(shape[:k]), prod(shape[k:])). Each half sweep only
    # bounds the rank through ITS side's recursion, so without this clamp
    # the R2L pass can assign an edge bond a rank above the OTHER side's
    # feasible dimension (one exactly-redundant column of f32 noise).
    bond_cap = [min(math.prod(shape[:k]), math.prod(shape[k:]), R) for k in range(d + 1)]
    fit_cap = int(R / (1.0 + oversample)) if oversample > 0 else R
    uc = torch.as_tensor(np.asarray(controls), dtype=dtype, device=device)
    # host streams, drawn exactly as the JAX package draws them (numpy seed
    # 777: the sample nodes, then both kick-noise lists), then moved over
    rng = np.random.default_rng(777)
    sample_idx = torch.as_tensor(
        np.stack([rng.integers(0, n, size=sample_size) for n in shape], -1),
        dtype=torch.int64, device=device)
    # DETERMINISTIC kick-enrichment directions, fixed across iterations: a
    # fresh random kick every sweep makes the pivot sets churn forever; with
    # fixed directions the VI body is a deterministic map.
    noise_l2r = [torch.as_tensor(rng.standard_normal((R * n, R)), dtype=dtype, device=device)
                 for n in shape]
    noise_r2l = [torch.as_tensor(rng.standard_normal((n * R, R)), dtype=dtype, device=device)
                 for n in shape]
    arR = torch.arange(R, device=device)
    vb = problem.value_bounds
    INF = float("inf")

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    def f32(x):
        return torch.tensor(x, dtype=dtype, device=device)

    if probe_rollouts > 0:
        from c3sc_tpu_torch.sim.integrators import rollout as _rollout
        from c3sc_tpu_torch.sim.policy import make_implicit_policy

        if probe_x0 is None:
            prng = np.random.default_rng(4242)
            lbn, ubn = np.asarray(problem.lb), np.asarray(problem.ub)
            mid, half = (lbn + ubn) / 2, (ubn - lbn) / 2
            probe_x0 = mid + 0.5 * half * prng.uniform(-1, 1, (probe_rollouts, d))
        probe_x0 = torch.as_tensor(np.asarray(probe_x0), dtype=dtype, device=device)
        # one fixed noise batch for every probe (the JAX package reuses one key)
        probe_noise = torch.randn((probe_steps, probe_x0.shape[0], problem.dw),
                                  generator=torch.Generator().manual_seed(31337),
                                  dtype=dtype).to(device)

        base_tt = None if base is None else TT(
            tuple(c.to(device=device, dtype=dtype) for c in base.cores),
            base.ranks.to(device=device, dtype=torch.int32))

        def _probe_cost(v_tt: TT):
            if base_tt is None:
                vfn = lambda p: tt_lerp_eval(v_tt, grid, p)  # noqa: E731
            else:
                vfn = lambda p: tt_lerp_eval(v_tt, grid, p) + tt_lerp_eval(base_tt, grid, p)  # noqa: E731
            pol = make_implicit_policy(problem, grid, vfn, uc)
            traj = _rollout(problem, grid, pol, probe_x0, probe_dt, probe_steps,
                            noise=probe_noise, policy_every=2)
            return traj.cost.mean().to(dtype)

    _eval_fibers = make_fiber_backup(problem, grid, uc, R, dtype, debug_identity,
                                     refine_steps, refine_method, base, mesh)

    def fit_core(qe, rows_prev, r_new, r_prev_fit, cap, s_prev, in_warmup, frozen):
        """Pivot rows + core for the selected scheme; returns (rows, G,
        bond_new, fit_new): the bond's sample-row count and its fit rank."""
        if oversample <= 0:
            rows = _hysteresis_rows(qe, rows_prev, r_new, r_prev_fit, in_warmup, frozen)
            return rows, _interp_from_rows(qe, rows, r_new), r_new, r_new
        s_new = torch.ceil((1.0 + oversample) * r_new).to(torch.int32)
        s_new = torch.minimum(torch.maximum(s_new, r_new), torch.clamp(cap, max=R).to(torch.int32))
        # a frozen sweep holds the bond size exactly (a changed sample mask
        # re-excites the oscillation the freeze exists to kill)
        s_new = torch.where(frozen, s_prev, s_new)
        # the leverage EXTENSION lives inside the hysteresis/freeze decision:
        # recomputed from each sweep's fresh basis, it made the frozen
        # rectangular operator nondeterministic
        rows_new = _extend_rows(qe, _pivot_rows(qe, r_new), r_new, s_new)
        switch = (~frozen) & (
            in_warmup
            | (r_new != r_prev_fit)
            | (_logvol(qe, rows_new, r_new) > _logvol(qe, rows_prev, r_new) + 0.4))
        rows = torch.where(switch, rows_new, rows_prev)
        return rows, _interp_from_rows_ls(qe, rows, r_new, s_new), s_new, r_new

    def one_sweep(st, tgt_cores, tgt_ranks, frozen, in_warmup, self_targeted: bool):
        """One full cross sweep (L2R + R2L) fitting the Bellman backup of a
        TARGET value function.

        ``self_targeted=True`` is the coupled scheme: the L2R half evaluates
        the backup of the sweep-entry iterate and the R2L half evaluates the
        backup of the just-fitted mid-sweep TT (Gauss-Seidel flavored,
        cheapest per sweep). ``False`` evaluates BOTH halves against the
        fixed (tgt_cores, tgt_ranks)."""
        (cores_prev, ranks_prev, left, right, rl, rr, rlf, rrf, rows_l, rows_r) = st
        with span("fused.rest"):
            # the carry's tensors are never written in place: clone, then
            # assign at the static k
            left, right, rl, rr, rlf, rrf, rows_l, rows_r = (
                t.clone() for t in (left, right, rl, rr, rlf, rrf, rows_l, rows_r))
            new_cores = list(cores_prev)
            one = torch.ones((), dtype=torch.int32, device=device)
            new_ranks = [one] * (d + 1)

        # ---------------- left-to-right half sweep ----------------
        for k in range(d - 1):
            n = shape[k]
            vals = _eval_fibers(tgt_cores, tgt_ranks, k, left[k], right[k + 1])
            with span("core_fit"):
                # rows (a, i): the left mask repeats over the n nodes
                row_mask = (arR < rl[k])[:, None].expand(R, n).reshape(-1).to(dtype)
                col_mask = (arR < rr[k + 1]).to(dtype)
                C = vals.reshape(R * n, R) * row_mask[:, None] * col_mask[None, :]
                cap_k = torch.clamp(rl[k] * n, max=bond_cap[k + 1])
                # with oversampling the fit rank leaves room for its extended
                # sample rows within the static padding
                qe, r_need, r_new = _orth_basis_and_rank(
                    C, noise_l2r[k], eps_rank, kick, torch.clamp(cap_k, max=fit_cap), row_mask,
                    rlf[k + 1], frozen, sync_free)
                rows, G, bond_new, fit_new = fit_core(qe, rows_l[k], r_new, rlf[k + 1], cap_k,
                                                      rl[k + 1], in_warmup, frozen)
                rows_l[k] = rows
                rlf[k + 1] = fit_new
                new_cores[k] = G.reshape(R, n, R)
                a, i = rows // n, rows % n
                newleft = torch.zeros((R, d), dtype=left.dtype, device=device)
                newleft[:, :k] = left[k][a][:, :k]
                newleft[:, k] = i
                left[k + 1] = newleft
                rl[k + 1] = bond_new
                new_ranks[k + 1] = bond_new
        # last core: direct evaluation
        n = shape[d - 1]
        vals = _eval_fibers(tgt_cores, tgt_ranks, d - 1, left[d - 1], right[d])
        with span("fused.rest"):
            row_mask = (arR < rl[d - 1])[:, None].expand(R, n).reshape(-1).to(dtype)
            C = vals.reshape(R * n, R) * row_mask[:, None]
            C = C * (arR < 1).to(dtype)[None, :]
            new_cores[d - 1] = C.reshape(R, n, R)
            ranks_mid = torch.stack([one] + [rl[k + 1] for k in range(d - 1)] + [one])
        # mid-sweep TT (left-interpolatory)
        cores_mid = tuple(new_cores)
        if self_targeted:
            r2l_cores, r2l_ranks = cores_mid, ranks_mid
        else:
            r2l_cores, r2l_ranks = tgt_cores, tgt_ranks

        # ---------------- right-to-left half sweep ----------------
        for k in range(d - 1, 0, -1):
            n = shape[k]
            vals = _eval_fibers(r2l_cores, r2l_ranks, k, left[k], right[k + 1])
            with span("core_fit"):
                # rows = (i, b), cols = a: the right mask tiles over the n nodes
                M = vals.permute(1, 2, 0).reshape(n * R, R)
                row_mask = (arR < rr[k + 1])[None, :].expand(n, R).reshape(-1).to(dtype)
                col_mask = (arR < rl[k]).to(dtype)
                M = M * row_mask[:, None] * col_mask[None, :]
                cap_k = torch.clamp(rr[k + 1] * n, max=bond_cap[k])
                qe, r_need, r_new = _orth_basis_and_rank(
                    M, noise_r2l[k], eps_rank, kick, torch.clamp(cap_k, max=fit_cap), row_mask,
                    rrf[k], frozen, sync_free)
                rows, G, bond_new, fit_new = fit_core(qe, rows_r[k], r_new, rrf[k], cap_k, rr[k],
                                                      in_warmup, frozen)
                rows_r[k] = rows
                rrf[k] = fit_new
                # core k: [c, i, b] = G[(i, b), c]
                new_cores[k] = G.reshape(n, R, R).permute(2, 0, 1).contiguous()
                i, b = rows // R, rows % R
                newright = torch.zeros((R, d), dtype=right.dtype, device=device)
                newright[:, k + 1:] = right[k + 1][b][:, k + 1:]
                newright[:, k] = i
                right[k] = newright
                rr[k] = bond_new
                new_ranks[k] = bond_new
        # first core: direct evaluation against new right sets
        n = shape[0]
        vals = _eval_fibers(r2l_cores, r2l_ranks, 0, left[0], right[1])
        with span("fused.rest"):
            col_mask = (arR < rr[1]).to(dtype)
            C0 = vals[:1] * col_mask[None, None, :]  # row 0 only
            new_cores[0] = torch.cat(
                [C0, torch.zeros((R - 1, n, R), dtype=dtype, device=device)], dim=0)
            new_ranks[0] = one
            new_ranks[d] = one
            ranks_new = torch.stack(new_ranks)
        return (tuple(new_cores), ranks_new, left, right, rl, rr, rlf, rrf, rows_l, rows_r)

    def body(carry: FusedCarry, probe_now: bool = False) -> FusedCarry:
        """One VI iteration. Adaptation freeze — two triggers:

        (1) residual gate: stop pivot/rank adaptation while the previous
            iteration's sample residual is below freeze_res (transient,
            self-correcting — resumes if the residual climbs back).
        (2) sticky plateau latch (carry.frozen): when the windowed
            displacement fails to improve for ``freeze_after`` consecutive
            windows, adaptation has stopped progressing — at a SATURATED
            rank cap the pivot reselection noise alone floors the residual.
            Latching the freeze turns the sweep into a deterministic
            interpolated Bellman operator that contracts to ITS fixed point.
            The latch releases only on divergence (long_res > 2x its value
            at engagement).
        The emergency release runs EVERY iteration: a latched freeze whose
        operator turns out unstable grows the residual geometrically and
        must unlatch before values overflow (NaN comparisons are all False,
        so a NaN-poisoned state could never exit via the boundary test).

        ``probe_now``: the host's word that this iteration ends a window
        (see ``make_fused_vi``); the probe's result is still gated by the
        device's own ``at_boundary``.
        """
        with span("fused.rest"):
            emergency = carry.frozen & (
                ~torch.isfinite(carry.residual) | (carry.residual > 10.0 * freeze_res))
            frozen_latch = carry.frozen & ~emergency
            frozen = frozen_latch | (carry.residual < freeze_res)
            in_warmup = carry.it < carry.warm_until
            st = (carry.cores, carry.ranks, carry.left, carry.right, carry.rl, carry.rr,
                  carry.rlf, carry.rrf, carry.rows_l, carry.rows_r)
        if target_mode == "frozen":
            # all fiber evaluations across the n_inner sweeps target the
            # backup of the SWEEP-ENTRY iterate; inner sweeps only refine
            # index sets/ranks for that fixed target
            for _ in range(n_inner):
                st = one_sweep(st, carry.cores, carry.ranks, frozen, in_warmup,
                               self_targeted=False)
        else:
            st = one_sweep(st, carry.cores, carry.ranks, frozen, in_warmup, self_targeted=True)
        (new_cores, ranks_new, left, right, rl, rr, rlf, rrf, rows_l, rows_r) = st
        with span("fused.rest"):
            v_new = TT(tuple(new_cores), ranks_new)
            # the fitted fiber values are already scrubbed; the sample vector
            # needs the same guarantee (an overflowing chain product would turn
            # the residual NaN, and NaN compares False in every stopping test)
            new_sample = _scrub(tt_gather_eval(v_new, sample_idx), vb)
            scale = torch.clamp(torch.max(torch.abs(new_sample)), min=1e-12)
            residual = torch.max(torch.abs(new_sample - carry.v_sample)) / scale
            # windowed long-baseline residual (robust to per-iteration pivot noise)
            at_boundary = torch.remainder(carry.it + 1, window) == 0
            abs_disp = torch.max(torch.abs(new_sample - carry.sample_ref))
            long_new = abs_disp / scale
            # improvement = beating the BEST window so far (monotone baseline),
            # tracked on the ABSOLUTE windowed displacement: a transiently
            # blown-up iterate scores a deceptively small RELATIVE displacement.
            # best_long (relative) is still tracked for the freeze logic.
            improved = abs_disp < carry.best_absdisp * 0.98
            best_long = torch.where(at_boundary, torch.minimum(carry.best_long, long_new),
                                    carry.best_long)
            best_absdisp = torch.where(at_boundary, torch.minimum(carry.best_absdisp, abs_disp),
                                       carry.best_absdisp)
            wstall = torch.where(at_boundary,
                                 torch.where(improved, torch.zeros_like(carry.wstall),
                                             carry.wstall + 1),
                                 carry.wstall)
            # sticky freeze latch: engage after `freeze_after` stalled windows;
            # release on divergence under the freeze. Both transitions reset
            # wstall so the new regime gets fresh stopping patience. Entry at
            # UNSATURATED ranks is unconditional on the residual level; at a
            # SATURATED cap only a stall at LOW residual (< freeze_res) latches
            # (large-truncation saturation is handled by rank-cap growth).
            unsaturated = torch.max(ranks_new) < R
            enter = (at_boundary & (~frozen_latch) & (wstall >= freeze_after)
                     & (unsaturated | (long_new < freeze_res)))
            leave = (at_boundary & frozen_latch & (long_new > 2.0 * carry.freeze_mark)
                     & (long_new > freeze_res))
            frozen_next = (frozen_latch | enter) & ~leave
            freeze_mark = torch.where(enter, torch.clamp(long_new, min=1e-12), carry.freeze_mark)
            wstall = torch.where(enter | leave, torch.zeros_like(wstall), wstall)
            long_res = torch.where(at_boundary, long_new, carry.long_res)
            sample_ref = torch.where(at_boundary, new_sample, carry.sample_ref)
            if probe_rollouts > 0:
                inf = torch.full_like(carry.best_cost, INF)
                pc = torch.where(at_boundary, _probe_cost(v_new), inf) if probe_now else inf
                is_best = pc < carry.best_cost
                best_cost = torch.where(is_best, pc, carry.best_cost)
                probe_cost_out = torch.where(at_boundary, pc, carry.probe_cost)
            else:
                # no probe: harvest the iterate with the smallest ABSOLUTE
                # windowed displacement (the contraction-mapping error proxy
                # ||v_k - v*|| <= ||T v_k - v_k|| / (1 - gamma)). In the churn
                # regime the final iterate can sit on an oscillation far from
                # the fixed point; the harvest brings every lineage close.
                is_best = at_boundary & (abs_disp < carry.best_absdisp)
                best_cost = carry.best_cost
                probe_cost_out = carry.probe_cost
            cores_best = tuple(torch.where(is_best, nc, cb)
                               for nc, cb in zip(new_cores, carry.cores_best))
            ranks_best = torch.where(is_best, ranks_new, carry.ranks_best)
            return FusedCarry(
                cores=tuple(new_cores), ranks=ranks_new, left=left, right=right,
                rl=rl, rr=rr, rlf=rlf, rrf=rrf, rows_l=rows_l, rows_r=rows_r,
                it=carry.it + 1, residual=residual,
                long_res=long_res, wstall=wstall, v_sample=new_sample,
                sample_ref=sample_ref, probe_cost=probe_cost_out,
                best_cost=best_cost, cores_best=cores_best, ranks_best=ranks_best,
                frozen=frozen_next, freeze_mark=freeze_mark,
                best_long=best_long, best_absdisp=best_absdisp,
                warm_until=carry.warm_until,
            )

    def init_fn(seed: int | None = 0, v0: TT | None = None) -> FusedCarry:
        """Fresh solver state. ``seed`` seeds the host draw of the initial
        cross pivot sets (None: 999); the integer ``s`` draws what the JAX
        package draws from ``jax.random.key(s)``."""
        if v0 is None:
            cores = tuple(torch.zeros((R, n, R), dtype=dtype, device=device) for n in shape)
            ranks = torch.ones(d + 1, dtype=torch.int32, device=device)
        else:
            if v0.rmax != R or v0.shape != tuple(shape):
                raise ValueError(f"v0 is padded to {v0.rmax} on {v0.shape}; the solver needs "
                                 f"{R} on {tuple(shape)}")
            cores = tuple(c.to(device=device, dtype=dtype) for c in v0.cores)
            ranks = v0.ranks.to(device=device, dtype=torch.int32)
        host_rng = np.random.default_rng(999 if seed is None else int(seed))

        def distinct_rows(dims):
            """[R, len(dims)] multi-indices with DISTINCT tuples. Duplicate
            pivot rows make the initial cross submatrix exactly singular and
            can latch a churning lineage the rank-adaptive sweep never
            escapes."""
            dims = list(dims)
            space = math.prod(shape[j] for j in dims)
            rows = np.stack([host_rng.integers(0, shape[j], size=R) for j in dims], axis=-1)
            if space < R:
                return rows  # tiny space: duplicates unavoidable
            for _ in range(64):
                flat = np.ravel_multi_index(rows.T, [shape[j] for j in dims])
                _, first = np.unique(flat, return_index=True)
                dup = np.setdiff1d(np.arange(R), first)
                if dup.size == 0:
                    break
                rows[dup] = np.stack([host_rng.integers(0, shape[j], size=dup.size)
                                      for j in dims], axis=-1)
            return rows

        left = np.zeros((d + 1, R, d), np.int64)
        right = np.zeros((d + 1, R, d), np.int64)
        for k in range(1, d):
            left[k, :, :k] = distinct_rows(range(k))
            right[k, :, k:] = distinct_rows(range(k, d))
        r0 = np.ones(d + 1, np.int32) * min(3, R)
        r0[0] = r0[d] = 1
        v_sample = tt_gather_eval(TT(cores, ranks), sample_idx)
        return FusedCarry(
            cores=cores, ranks=ranks,
            left=torch.as_tensor(left, device=device), right=torch.as_tensor(right, device=device),
            rl=i32(r0), rr=i32(r0), rlf=i32(r0), rrf=i32(r0),
            rows_l=torch.zeros((d, R), dtype=torch.int64, device=device),
            rows_r=torch.zeros((d, R), dtype=torch.int64, device=device),
            it=i32(0), residual=f32(INF), long_res=f32(INF),
            wstall=i32(0), v_sample=v_sample, sample_ref=v_sample,
            probe_cost=f32(INF), best_cost=f32(INF),
            cores_best=cores, ranks_best=ranks,
            frozen=torch.zeros((), dtype=torch.bool, device=device),
            freeze_mark=f32(INF), best_long=f32(INF), best_absdisp=f32(INF),
            warm_until=i32(60),
        )

    # under the freeze the iteration is a FIXED interpolation operator: it
    # either contracts to tol within a few windows or it has hit its
    # lineage's refit-noise floor and further iterations are pure waste.
    # Stopping early there hands the remaining budget to a fresh-lineage
    # restart in fused_tt_vi. The UNFROZEN stall patience stays the caller's.
    frozen_patience = min(patience, 6)

    def cond(c: FusedCarry):
        """The loop condition as a 0-d bool tensor on the device."""
        return (
            (c.it < max_iters)
            & (c.residual > tol)
            & (c.long_res > tol)
            & (c.wstall < torch.where(c.frozen, frozen_patience, patience))
        )

    def masked_iteration(carry: FusedCarry, limit, force, probe_now: bool = False) -> FusedCarry:
        """One iteration of ``while cond(c) & (c.it < limit)``: every field
        of the new carry where the loop is still active, the old one where
        it is not. ``force`` (a 0-d bool tensor) makes it active whatever
        the condition: ``step_fn``'s iteration in the shared CUDA graph."""
        with span("fused.rest"):
            active = force | (cond(carry) & (carry.it < limit))
        new = body(carry, probe_now)
        with span("fused.rest"):
            return _tree_map2(lambda a, b: torch.where(active, a, b), new, carry)

    graphed = []    # the captured iteration, built at first use

    def _graphed_iteration():
        if not graphed:
            graphed.append(_GraphedIteration(masked_iteration, device))
        return graphed[0]

    def _host_it(carry):
        # with a probe, the host must know which iterations end a window
        return int(carry.it) if probe_rollouts > 0 else 0

    @torch.no_grad()
    def run_fn(carry: FusedCarry, n_iters: int = 1) -> FusedCarry:
        """Up to n_iters iterations with solve_fn's stopping conditions,
        enqueued without a host read in between — the chunked loop behind
        per-window metrics."""
        limit = carry.it + n_iters
        if cuda_graph:
            return _graphed_iteration()(carry, limit, n_iters, force=False)
        with span("fused.step", device=False):
            it0 = _host_it(carry)
            off = torch.zeros((), dtype=torch.bool, device=device)
            for j in range(n_iters):
                with span("fused.iteration"):
                    carry = masked_iteration(carry, limit, off, (it0 + j + 1) % window == 0)
            return carry

    @torch.no_grad()
    def step_fn(carry: FusedCarry, n_iters: int = 1) -> FusedCarry:
        """Exactly n_iters iterations, whatever the stopping state."""
        if cuda_graph:
            return _graphed_iteration()(carry, carry.it, n_iters, force=True)
        with span("fused.step", device=False):
            it0 = _host_it(carry)
            for j in range(n_iters):
                with span("fused.iteration"):
                    carry = body(carry, (it0 + j + 1) % window == 0)
            return carry

    @torch.no_grad()
    def solve_fn(carry: FusedCarry) -> FusedCarry:
        """Run to convergence: chunks of ``window`` masked iterations, the
        loop condition read on the host once per chunk."""
        while bool(cond(carry)):
            carry = run_fn(carry, window)
        return carry

    return FusedSolver(solve_fn, init_fn, step_fn, run_fn)


def _tree_map2(fn, a: FusedCarry, b: FusedCarry) -> FusedCarry:
    """fn over the paired tensors of two carries (core tuples included)."""
    out = []
    for x, y in zip(a, b):
        out.append(tuple(fn(p, q) for p, q in zip(x, y)) if isinstance(x, tuple) else fn(x, y))
    return FusedCarry(*out)


class _GraphedIteration:
    """One masked iteration captured as a CUDA graph on static buffers, with
    the copy of its result back into its input inside the capture; a chunk
    is then one copy in, ``n`` replays and one copy out. The static
    ``force`` flag on the device makes the replayed iteration active
    whatever the loop condition (``step_fn``).

    The iteration is captured twice, into one memory pool: ``graph``, which
    runs while spans do not record, and ``traced``, the same iteration with
    its spans as timing events (``utils.metrics.GraphSpans``): the root
    ``fused.iteration`` under ``fused.step``, tiled by ``fiber_backup``
    (K2), ``core_fit`` (K3) and ``fused.rest``, one event node at each of
    their 4d + 2 boundaries. Those nodes cost about 4 us each, so only a
    call made while spans record replays ``traced``; it harvests the
    previous such call's last replay if it has completed, and never waits.

    ``_GraphedIteration.captures`` counts the captures made in this process
    (a solver captures once, at its first graphed call; the pair counts
    once)."""

    captures = 0

    def __init__(self, iteration, device):
        self.iteration, self.device = iteration, device
        self.graph = None

    def _capture(self, carry, limit):
        self.static = _tree_map2(lambda a, _: a.clone(), carry, carry)
        self.limit = limit.clone()
        self.force = torch.zeros((), dtype=torch.bool, device=self.device)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):       # warm up off the capture, on scratch copies
            self.iteration(self.static, self.limit, self.force)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._iterate()
        # every tensor the captures allocate dies inside them, so the two
        # graphs share one pool: they are only ever replayed one at a time
        self.traced = torch.cuda.CUDAGraph()
        self.spans = GraphSpans()
        with torch.cuda.graph(self.traced, pool=self.graph.pool()), self.spans.capturing():
            self._iterate()
        _GraphedIteration.captures += 1

    def _iterate(self):
        with span("fused.iteration"):
            new = self.iteration(self.static, self.limit, self.force)
            with span("fused.rest"):
                _tree_map2(lambda dst, src: dst.copy_(src), self.static, new)

    def __call__(self, carry, limit, n_iters, force: bool):
        with span("fused.step", device=False):
            if self.graph is None:
                self._capture(carry, limit)
            _tree_map2(lambda dst, src: dst.copy_(src), self.static, carry)
            self.limit.copy_(limit)
            self.force.fill_(force)
            traced = recording()
            if traced:
                self.spans.harvest()
            graph = self.traced if traced else self.graph
            for _ in range(n_iters):
                graph.replay()
            if traced:
                self.spans.replayed()
            return _tree_map2(lambda a, _: a.clone(), self.static, self.static)


@dataclasses.dataclass
class FusedVISolution:
    v: TT
    residual: float
    iterations: int
    wall_time: float
    carry: FusedCarry
    controls: np.ndarray
    probe_cost: float = float("inf")


def pad_fused_carry(carry: FusedCarry, R_new: int) -> FusedCarry:
    """Zero-pad a FusedCarry to a larger rank cap (cores keep the padded-
    zero invariant, so TT products are unchanged; index sets and pivot rows
    pad with zeros — the growth path in ``fused_tt_vi`` re-draws them via
    ``init_fn`` anyway, and masked rows are inert)."""
    R_old = carry.cores[0].shape[0]
    if R_new == R_old:
        return carry
    assert R_new > R_old, (R_old, R_new)
    dR = R_new - R_old
    pad = torch.nn.functional.pad

    def padcore(c):
        return pad(c, (0, dR, 0, 0, 0, dR))

    return carry._replace(
        cores=tuple(padcore(c) for c in carry.cores),
        cores_best=tuple(padcore(c) for c in carry.cores_best),
        left=pad(carry.left, (0, 0, 0, dR)),
        right=pad(carry.right, (0, 0, 0, dR)),
        rows_l=pad(carry.rows_l, (0, dR)),
        rows_r=pad(carry.rows_r, (0, dR)),
    )


def _host_state(c: FusedCarry) -> dict:
    """The stopping state of a carry on the host, in ONE device read."""
    vals = torch.stack([c.it.double(), c.residual.double(), c.long_res.double(),
                        c.wstall.double(), c.frozen.double(), c.best_absdisp.double(),
                        c.best_cost.double(), c.probe_cost.double(),
                        c.ranks.max().double()]).tolist()
    return dict(it=int(vals[0]), residual=vals[1], long_res=vals[2], wstall=int(vals[3]),
                frozen=bool(vals[4]), best_absdisp=vals[5], best_cost=vals[6],
                probe_cost=vals[7], max_rank=int(vals[8]))


def fused_tt_vi(
    problem: ControlProblem,
    grid: Grid,
    controls=None,
    n_controls: int = 9,
    rmax: int = 16,
    rmax_max: int | None = None,
    seed: int = 0,
    tol: float = 1e-4,
    max_iters: int = 2000,
    kick: int = 2,
    eps_rank: float = 1e-4,
    sample_size: int = 256,
    window: int = 50,
    patience: int = 6,
    freeze_after: int = 2,
    probe_rollouts: int = 0,
    probe_steps: int = 200,
    probe_dt: float = 0.01,
    probe_x0=None,
    dtype=torch.float32,
    v0: TT | None = None,
    carry: FusedCarry | None = None,
    mesh=None,
    refine_steps: int = 0,
    refine_method: str = "pgd",
    target_mode: str = "self",
    n_inner: int = 1,
    base: TT | None = None,
    oversample: float = 0.0,
    metrics=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume_from: str | None = None,
    log_every: int = 0,
    device=None,
    cuda_graph: bool = False,
    sync_free: bool | None = None,
) -> FusedVISolution:
    """One-call fused VI solve on ``device`` (None: the default CUDA device;
    without one torch raises).

    The solve runs in chunks of ``log_every`` iterations (default: the
    stopping ``window``) through ``run_fn``: each chunk is enqueued without a
    host read, then the carry's stopping state is read once. With
    ``metrics`` (any object with ``.log(name, **fields)``) every chunk emits
    a ``fused_vi`` record (iteration, residual, long-window residual, active
    ranks, probe cost).

    ``seed``: the integer the JAX package would pass as ``jax.random.key(seed)``;
    it seeds the initial pivot sets and the re-draws of every restart.

    ``rmax_max`` enables RANK-CAP GROWTH: when a solve stalls with its
    active ranks saturating the current cap, the solver rebuilds at
    ``min(rmax_max, rmax + max(2*kick, 4))``, zero-pads the carry, and
    continues. Steps are small and additive: caps far beyond the problem's
    epsilon-rank fit f32 noise columns and churn as badly as starved ones.

    ``base`` and ``oversample`` as in ``make_fused_vi``; with a base the
    returned ``v`` is the correction w alone, and the validation probe
    scores base + w.

    ``checkpoint_path``: the carry is saved there (``save_fused_carry``,
    the JAX package's file) at the first chunk boundary at least
    ``checkpoint_every`` iterations after the last save (never, for 0), and
    once more when the solve ends, before any rollback to an earlier
    stage. ``resume_from``: a checkpoint of either package continues, at
    the rank cap it was saved at, with a fresh stopping state; the port's
    own files also restore the restarts' seed draws. Under ``cuda_graph``
    the saves read the carry at chunk boundaries, where the loop reads its
    stopping state anyway, and a resumed carry is copied into the graph's
    static inputs.

    ``mesh`` as in ``make_fused_vi``: every rank runs this same call, and
    the host reads between chunks see the same replicated state on every
    rank, so the ranks take the same restarts and stop together. With a
    checkpoint every rank writes its own carry: give each rank its own
    ``checkpoint_path``. ``device=None`` with a mesh is the mesh's device.
    """
    if controls is None:
        controls = problem.control_candidates(n_controls)
    device = _solve_device(device, mesh)
    seeds = np.random.default_rng(int(seed))      # restarts draw their seeds here

    def build(R):
        return make_fused_vi(
            problem, grid, controls, rmax=R, kick=kick, eps_rank=eps_rank,
            tol=tol, max_iters=max_iters, sample_size=sample_size,
            window=window, patience=patience, freeze_after=freeze_after,
            probe_rollouts=probe_rollouts,
            probe_steps=probe_steps, probe_dt=probe_dt, probe_x0=probe_x0,
            dtype=dtype, mesh=mesh,
            refine_steps=refine_steps, refine_method=refine_method,
            target_mode=target_mode, n_inner=n_inner, base=base,
            oversample=oversample, device=device, cuda_graph=cuda_graph,
            sync_free=sync_free,
        )

    cur_rmax = rmax
    solver = build(cur_rmax)
    if resume_from is not None:
        from c3sc_tpu_torch.utils.checkpoint import (checkpoint_seed_stream, fused_context,
                                                     load_fused_carry)

        carry = load_fused_carry(resume_from, expect=fused_context(problem, grid, cur_rmax),
                                 device=device)
        stream = checkpoint_seed_stream(resume_from)
        if stream is not None:
            seeds.bit_generator.state = stream["rng"]
        ck_R = carry.cores[0].shape[0]
        if ck_R != cur_rmax:
            cur_rmax = ck_R
            solver = build(cur_rmax)
    if carry is None:
        if v0 is not None:
            R_v0 = v0.cores[0].shape[0]
            if R_v0 != cur_rmax:
                # warm-start values may come from a run at a different cap;
                # normalise the static padding. Down-padding is lossless
                # only if the active ranks fit.
                cr = _concrete_ranks(v0)
                if R_v0 > cur_rmax and cr.max() > cur_rmax:
                    raise ValueError(
                        f"v0 has active ranks up to {int(cr.max())} but "
                        f"rmax={cur_rmax}; raise rmax (or rmax_max)")
                v0 = _repad(v0, cur_rmax)
        carry = solver.init_fn(seed, v0)
    else:
        # fresh stopping state for the warm restart
        carry = carry._replace(
            wstall=torch.zeros_like(carry.wstall),
            long_res=torch.full_like(carry.long_res, float("inf")),
            best_long=torch.full_like(carry.best_long, float("inf")),
            best_absdisp=torch.full_like(carry.best_absdisp, float("inf")),
        )
    chunk = log_every if log_every > 0 else window

    def save(out):
        from c3sc_tpu_torch.utils.checkpoint import fused_context, save_fused_carry

        save_fused_carry(checkpoint_path, out, context=fused_context(problem, grid, cur_rmax),
                         stream={"rng": seeds.bit_generator.state})

    def drive(solver, carry):
        """Chunks of ``chunk`` blind iterations; one host read per chunk."""
        out = carry
        prev_it = last_saved = _host_state(out)["it"]
        while True:
            out = solver.run_fn(out, chunk)
            hs = _host_state(out)
            if hs["it"] == prev_it:
                # stopping condition already met on entry (incl. NaN
                # residual, whose comparisons are all False) — done
                break
            prev_it = hs["it"]
            if metrics is not None:
                rec = dict(iter=hs["it"], residual=hs["residual"], long_res=hs["long_res"],
                           wstall=hs["wstall"], frozen=hs["frozen"],
                           ranks=[int(r) for r in out.ranks.tolist()])
                if probe_rollouts > 0:
                    rec["probe_cost"] = hs["probe_cost"]
                    rec["best_cost"] = hs["best_cost"]
                metrics.log("fused_vi", **rec)
            if checkpoint_path is not None and checkpoint_every > 0 and (
                    hs["it"] - last_saved >= checkpoint_every):
                save(out)
                last_saved = hs["it"]
            stop = (
                hs["it"] >= max_iters
                or hs["residual"] <= tol
                or hs["long_res"] <= tol
                or hs["wstall"] >= (min(patience, 6) if hs["frozen"] else patience)
            )
            if stop:
                break
        return out, hs

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    best_out, best_metric = None, float("inf")
    lineage_retries = 0
    # cross-stage probe harvest: the best-by-realized-cost iterate must
    # survive growth (each stage's init_fn resets best_cost/cores_best)
    gbest_cost, gbest_cores, gbest_ranks = float("inf"), None, None
    while True:
        out, hs = drive(solver, carry)
        if probe_rollouts > 0 and hs["best_cost"] < gbest_cost:
            gbest_cost = hs["best_cost"]
            gbest_cores, gbest_ranks = out.cores_best, out.ranks_best
        # stage quality = best ABSOLUTE windowed displacement it reached
        # (monotone; scale-robust — see the body() improvement comment)
        metric = hs["best_absdisp"]
        improving = metric < 0.8 * best_metric
        if best_out is None or metric < best_metric:
            best_out, best_hs, best_metric = out, hs, min(metric, best_metric)
        saturated = hs["max_rank"] >= cur_rmax
        unconverged = hs["residual"] > tol and hs["long_res"] > tol and hs["it"] < max_iters
        if (rmax_max is not None and cur_rmax < rmax_max
                and saturated and unconverged and improving):
            new_R = min(rmax_max, cur_rmax + max(2 * kick, 4))
            if metrics is not None:
                metrics.log("fused_rank_growth", rmax_from=cur_rmax, rmax_to=new_R,
                            iter=hs["it"], residual=hs["residual"])
            solver = build(new_R)
            # fresh cross state, warm VALUE: carrying the churned pivot/
            # index lineage into the grown cap measurably underperforms a
            # fresh adaptation started from the current value; init_fn
            # re-draws index sets and re-adapts within a few hundred
            # iterations
            padded = pad_fused_carry(out, new_R)
            carry = solver.init_fn(int(seeds.integers(0, 2**31)),
                                   TT(padded.cores, padded.ranks))._replace(
                it=out.it, warm_until=out.it + 60)
            cur_rmax = new_R
            continue
        if unconverged and lineage_retries < 8:
            # same-cap lineage RESTART: which pivot lineage a cross solve
            # settles into is seed-dependent, and a bad one floors above tol
            # even under the freeze. Re-drawing the index sets re-rolls the
            # lineage within the same max_iters budget.
            lineage_retries += 1
            if metrics is not None:
                metrics.log("fused_lineage_restart", iter=hs["it"], retry=lineage_retries,
                            residual=hs["residual"])
            # alternate warm / cold retries: a warm start (harvested best
            # value) converges fastest when the PIVOTS were the problem, but
            # when the harvested value itself carries the floor every warm
            # retry inherits the same basin. Cold retries are independent.
            warm = (TT(out.cores_best, out.ranks_best) if lineage_retries % 2 == 1 else None)
            carry = solver.init_fn(int(seeds.integers(0, 2**31)), warm)._replace(
                it=out.it, warm_until=out.it + 60)
            continue
        break
    # the resumable state on disk is the LATEST progress, not the returned
    # (possibly earlier best) stage: save before any rollback
    if checkpoint_path is not None:
        save(out)
    # a grown stage that failed to pay means the cap overshot the problem's
    # epsilon-rank — return the BEST stage's iterate, not the last one
    if best_out is not None and best_hs["best_absdisp"] < hs["best_absdisp"]:
        out, hs = best_out, best_hs
    # re-attach the cross-stage probe harvest (pad to the returned cap)
    if probe_rollouts > 0 and gbest_cores is not None and gbest_cost < hs["best_cost"]:
        R_out = out.cores[0].shape[0]
        R_g = gbest_cores[0].shape[0]
        if R_g > R_out:
            # harvest came from a LARGER-cap stage than the rolled-back best
            # stage: pad the whole carry up so cores/cores_best agree
            out = pad_fused_carry(out, R_g)
        elif R_g < R_out:
            gbest_cores = _repad(TT(gbest_cores, gbest_ranks), R_out).cores
        out = out._replace(
            best_cost=torch.as_tensor(gbest_cost, dtype=out.best_cost.dtype, device=device),
            cores_best=gbest_cores, ranks_best=gbest_ranks,
        )
    # WINNER'S-CURSE GUARD: the in-loop probe SELECTS the best iterate over
    # dozens of window boundaries on one fixed-seed batch, so the winning
    # score overfits that batch. A final VALIDATION probe on a fresh seed and
    # a 4x batch chooses between just two candidates (harvested vs final
    # iterate), and the reported probe_cost becomes an unbiased estimate of
    # the returned policy. The validation horizon is 2x probe_steps: the
    # in-loop horizon underestimates exit costs that materialise just past it.
    best_cost = float("inf")
    if probe_rollouts > 0:
        from c3sc_tpu_torch.sim.integrators import rollout as _roll
        from c3sc_tpu_torch.sim.policy import make_implicit_policy as _mip

        # the seed MUST differ from the in-loop probe's (4242)
        vrng = np.random.default_rng(987654321)
        lbn, ubn = np.asarray(problem.lb), np.asarray(problem.ub)
        if probe_x0 is None:
            mid, half = (lbn + ubn) / 2, (ubn - lbn) / 2
            vx0 = mid + 0.5 * half * vrng.uniform(-1, 1, (4 * probe_rollouts, problem.dx))
        else:
            px = np.asarray(probe_x0)
            vx0 = px[vrng.integers(0, px.shape[0], 4 * probe_rollouts)]
            vx0 = vx0 + 0.05 * (ubn - lbn) * vrng.uniform(-1, 1, vx0.shape)
        # keep validation starts inside the box: a jittered point past an
        # ABSORB face dies at step 0 and charges a spurious exit cost
        vx0 = torch.as_tensor(np.clip(vx0, lbn, ubn), dtype=dtype, device=device)
        vnoise = torch.randn((2 * probe_steps, vx0.shape[0], problem.dw),
                             generator=torch.Generator().manual_seed(271828),
                             dtype=dtype).to(device)
        uc = torch.as_tensor(np.asarray(controls), dtype=dtype, device=device)

        @torch.no_grad()
        def _vcost(cores, ranks):
            vtt = TT(cores, ranks)
            if base is None:
                vfn = lambda p: tt_lerp_eval(vtt, grid, p)  # noqa: E731
            else:
                vfn = lambda p: tt_lerp_eval(vtt, grid, p) + tt_lerp_eval(base, grid, p)  # noqa: E731
            pol = _mip(problem, grid, vfn, uc)
            tr = _roll(problem, grid, pol, vx0, probe_dt, 2 * probe_steps, noise=vnoise,
                       policy_every=2)
            return float(tr.cost.mean())

        c_harvest = _vcost(out.cores_best, out.ranks_best)
        c_final = _vcost(out.cores, out.ranks)
        if metrics is not None:
            metrics.log("fused_validation_probe", harvested=c_harvest, final=c_final)
        if c_final < c_harvest:
            out = out._replace(cores_best=out.cores, ranks_best=out.ranks)
        best_cost = min(c_final, c_harvest)
        out = out._replace(best_cost=torch.as_tensor(best_cost, dtype=dtype, device=device))
    elif hs["residual"] <= tol or hs["long_res"] <= tol:
        # converged: return the final iterate — it carries up to window-1
        # iterations of progress past the last harvest boundary. The
        # harvested snapshot is only returned for a run that STOPPED
        # unconverged (patience/max_iters — the churn regime).
        out = out._replace(cores_best=out.cores, ranks_best=out.ranks)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    # cores_best: probe-harvested best iterate when probing, best-
    # displacement harvest (or final, above) otherwise
    return FusedVISolution(
        v=TT(out.cores_best, out.ranks_best), residual=hs["residual"], iterations=hs["it"],
        wall_time=wall, carry=out, controls=np.asarray(controls), probe_cost=best_cost,
    )


def fused_tt_vi_refined(
    problem: ControlProblem,
    grid: Grid,
    controls=None,
    n_controls: int = 9,
    rounds: int = 2,
    rmax: int = 16,
    total_round_tol: float = 1e-6,
    seed: int | Sequence[int] = 0,
    **kw,
) -> FusedVISolution:
    """Residual-corrected fused VI: iterative refinement over the cross
    projector's error floor.

    A projected solve's fixed point carries the cross fit error amplified by
    about 1/(1 - gamma_eff). The fit error is relative to the fitted
    function's own scale, so solving the residual equation

        w_i = T(vbar_i + w_i) - vbar_i,   vbar_{i+1} = vbar_i + w_i

    with the same solver (``base=vbar_i``) contracts the total error by the
    same factor every round. A round is accepted only if the sampled Bellman
    residual of the total, UNNORMALISED (``bres * scale``: a correction that
    inflates max|v| would deflate its relative residual), falls; a rejected
    round costs one retry, at most ``2 * rounds`` attempts. The total is
    summed exactly (block-diagonal ``tt_add`` at a padding that fits both,
    ``on_overflow='raise'``) and compressed by one final ``tt_round`` to
    ``total_round_tol``.

    ``rounds``: correction rounds to accept after the base solve. ``seed``:
    an int draws the seed of every sub-solve (the base, then each attempt)
    from ``np.random.default_rng(seed)``; a sequence gives them in that
    order and needs ``1 + 2 * rounds`` entries. ``kw`` goes to every
    ``fused_tt_vi`` call (tol, max_iters, patience, device, cuda_graph,
    probe_rollouts, ...). The result's ``refine_history`` holds one record a
    solve: round, residual, bellman_res, bellman_res_abs, accepted (not for
    round 0), probe_cost, wall_s.
    """
    if controls is None:
        controls = problem.control_candidates(n_controls)
    next_seed = seed_stream(seed, 1 + 2 * rounds)
    sol = fused_tt_vi(problem, grid, controls=controls, rmax=rmax, seed=next_seed(), **kw)
    total = sol.v
    iters, walls = sol.iterations, sol.wall_time
    bres, bscale = bellman_residual_sample(problem, grid, controls, total)
    bres_abs = float(bres) * float(bscale)
    history = [dict(round=0, residual=sol.residual, bellman_res=float(bres),
                    bellman_res_abs=bres_abs, probe_cost=sol.probe_cost, wall_s=sol.wall_time)]
    acc_residual, acc_probe = sol.residual, sol.probe_cost
    accepted_rounds, attempts = 0, 0
    while accepted_rounds < rounds and attempts < 2 * rounds:
        attempts += 1
        sol_w = fused_tt_vi(problem, grid, controls=controls, rmax=rmax, seed=next_seed(),
                            base=total, **kw)
        Rt = total.rmax + sol_w.v.rmax
        cand = tt_add(_repad(total, Rt), _repad(sol_w.v, Rt), on_overflow="raise")
        iters += sol_w.iterations
        walls += sol_w.wall_time
        # accept on the measured sampled Bellman residual, the oracle-free
        # bound ||v - v*|| <= ||Tv - v|| / (1 - gamma): a correction solve
        # that churned above its fixed point's scale must never poison the
        # result
        bres_c, cscale = bellman_residual_sample(problem, grid, controls, cand)
        bres_c_abs = float(bres_c) * float(cscale)
        accepted = bres_c_abs < bres_abs
        history.append(dict(round=accepted_rounds + 1, residual=sol_w.residual,
                            bellman_res=float(bres_c), bellman_res_abs=bres_c_abs,
                            accepted=accepted, probe_cost=sol_w.probe_cost,
                            wall_s=sol_w.wall_time))
        if accepted:
            accepted_rounds += 1
            total, bres_abs = cand, bres_c_abs
            # the solution's metrics describe the ACCEPTED state
            acc_residual, acc_probe = sol_w.residual, sol_w.probe_cost
    # one compression pass: the exact sum usually carries redundant rank
    total = tt_round(total, total_round_tol)
    out = FusedVISolution(v=total, residual=acc_residual, iterations=iters, wall_time=walls,
                          carry=sol.carry, controls=sol.controls, probe_cost=acc_probe)
    out.refine_history = history
    return out
