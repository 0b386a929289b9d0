"""TT policy iteration with direct linear policy-evaluation solves (ALS-LS) —
port of ``c3sc_tpu/solvers/pials.py``.

Projected value iteration (``solvers/polish.py``) fits the backed-up target
every step, so its fit error re-enters the fixed-point loop and accumulates
to about e_fit / (1 - gamma_eff). Policy iteration instead solves the
frozen-policy linear Bellman system

    v(x) - e^{-beta dt(x)} sum_j p_j(x) v(nb_j(x)) = g(x, u*(x)) dt(x)

in the TT manifold by alternating least squares: with every core but one
frozen and orthogonalised, v is linear in that core, and the sampled
equations are an ordinary least-squares problem. Its normal equations are
assembled chunk by chunk and solved on the device (float32 Cholesky, a
proximal pull toward the warm start, and corrected-seminormal iterative
refinement against the exact rows). The tiny core algebra (blocks, QR
orthogonalisation, rank inflation) stays on the host in numpy float64, as
in the reference: it is microseconds at these ranks.

Samples come from ``np.random.default_rng(seed)``, so both packages draw the
same rows. On CUDA nothing of the device work reads the host except the
per-refinement residual norm and the acceptance check, as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops import mca
from c3sc_tpu_torch.ops.argmin import first_argmin
from c3sc_tpu_torch.ops.tt import TT, tt_gather_eval
from c3sc_tpu_torch.solvers.ttvi import _neighbor_indices, make_bellman_kernel

# ---------------------------------------------------------- frozen policy


def frozen_policy_rows(problem: ControlProblem, grid: Grid, uc, v_tt: TT, idx,
                       dtype=torch.float32):
    """Linear Bellman rows at nodes ``idx`` [S, d] under the argmin policy of
    the current value ``v_tt`` (the policy-improvement step); ``uc`` [C, du]
    on idx's device.

    Returns (pts [S, T, d], w [S, T], rhs [S]) with T = 2 d + 1 such that the
    frozen-policy equation at each sample reads sum_t w[s, t] v(pts[s, t]) =
    rhs[s]. pts[:, 0] is the node itself (w = 1); pts[:, 1:] are its 2d
    stencil neighbours with w = -gamma p (zero at terminal neighbours, whose
    pinned value moves to the right-hand side). Terminal nodes get the row
    v(s) = psi(s). Ties of the argmin go to the first candidate.
    """
    d = problem.dx
    S = idx.shape[0]
    x = grid.index_to_state(idx).to(dtype)
    nb_flat = _neighbor_indices(grid, idx).reshape(S, 2 * d, d)
    nx = grid.index_to_state(nb_flat).to(dtype)
    t_nb, tv_nb = mca.node_terminal(problem, grid, nb_flat, nx)           # [S, 2d]

    # policy improvement: argmin over the candidates under the current v
    vn = tt_gather_eval(v_tt, nb_flat.reshape(-1, d)).to(dtype)
    if problem.value_bounds is not None:
        vn = torch.clamp(vn, problem.value_bounds[0], problem.value_bounds[1])
    vn = torch.where(t_nb.reshape(-1), tv_nb.reshape(-1).to(dtype), vn)
    vn2 = vn.reshape(S, 2, d)
    pp, pm, dt = mca.transition_all_controls(problem, grid, x, uc)      # [C, S, d]
    g = mca.stage_cost_all(problem, x, uc)                              # [C, S]
    expect = torch.sum(pp * vn2[None, :, 0] + pm * vn2[None, :, 1], dim=-1)
    rhs_all = g * dt + torch.exp(-problem.beta * dt) * expect           # [C, S]
    c = first_argmin(rhs_all, 0)                                        # [S]

    def take(a):
        if a.ndim == 3:
            return a.gather(0, c[None, :, None].expand(1, S, a.shape[2]))[0]
        return a.gather(0, c[None, :])[0]

    ppw, pmw, dtw, gw = take(pp), take(pm), take(dt), take(g)
    gamma = torch.exp(-problem.beta * dtw)                              # [S]
    p_nb = torch.cat([ppw, pmw], dim=-1)                                # [S, 2d]
    w_nb = -gamma[:, None] * p_nb
    # terminal neighbours: the pinned value moves to the right-hand side
    zero = torch.zeros((), dtype=dtype, device=x.device)
    rhs = gw * dtw + gamma * torch.sum(torch.where(t_nb, p_nb * tv_nb.to(dtype), zero), dim=-1)
    w_nb = torch.where(t_nb, zero, w_nb)
    # terminal evaluation nodes: the row v(s) = psi(s)
    tm, tv = mca.node_terminal(problem, grid, idx, x)
    w_nb = torch.where(tm[:, None], zero, w_nb)
    rhs = torch.where(tm, tv.to(dtype), rhs)
    pts = torch.cat([idx[:, None, :], nb_flat], dim=1)                  # [S, T, d]
    w = torch.cat([torch.ones((S, 1), dtype=dtype, device=x.device), w_nb.to(dtype)], dim=1)
    return pts, w, rhs.to(dtype)


# ------------------------------------------------------- host core algebra


def tt_to_blocks(v: TT):
    """Padded TT -> list of unpadded float64 numpy cores [r_l, n, r_r]."""
    ranks = [int(r) for r in v.ranks.tolist()]
    return [c.detach().cpu().numpy().astype(np.float64)[: ranks[k], :, : ranks[k + 1]]
            for k, c in enumerate(v.cores)]


def blocks_to_tt(blocks, rmax: int, dtype=torch.float32, device=None) -> TT:
    """Unpadded numpy cores -> padded TT on ``device`` (None: the default
    CUDA device), through float32 as the reference does."""
    device = resolve_device(device)
    ranks = [1] + [b.shape[2] for b in blocks[:-1]] + [1]
    cores = []
    for b in blocks:
        full = np.zeros((rmax, b.shape[1], rmax), np.float32)
        full[: b.shape[0], :, : b.shape[2]] = b
        cores.append(torch.as_tensor(full, dtype=dtype, device=device))
    return TT(tuple(cores), torch.as_tensor(ranks, dtype=torch.int32, device=device))


def _orthogonalize(blocks, center: int):
    """Left-orthogonalise cores < center, right-orthogonalise > center (host
    float64 QR on tiny [r n, r] matrices)."""
    d = len(blocks)
    for k in range(center):
        r_l, n, r_r = blocks[k].shape
        q, rr = np.linalg.qr(blocks[k].reshape(r_l * n, r_r))
        blocks[k] = q.reshape(r_l, n, q.shape[1])
        blocks[k + 1] = np.einsum("ij,jns->ins", rr, blocks[k + 1])
    for k in range(d - 1, center, -1):
        r_l, n, r_r = blocks[k].shape
        q, rr = np.linalg.qr(blocks[k].reshape(r_l, n * r_r).T)
        blocks[k] = q.T.reshape(q.shape[1], n, r_r)
        blocks[k - 1] = np.einsum("ins,js->inj", blocks[k - 1], rr)
    return blocks


def _move_center(blocks, k: int, forward: bool):
    """QR-shift the non-orthogonal centre from core k to k+1 (or k-1)."""
    if forward:
        r_l, n, r_r = blocks[k].shape
        q, rr = np.linalg.qr(blocks[k].reshape(r_l * n, r_r))
        blocks[k] = q.reshape(r_l, n, q.shape[1])
        blocks[k + 1] = np.einsum("ij,jns->ins", rr, blocks[k + 1])
    else:
        r_l, n, r_r = blocks[k].shape
        q, rr = np.linalg.qr(blocks[k].reshape(r_l, n * r_r).T)
        blocks[k] = q.T.reshape(q.shape[1], n, r_r)
        blocks[k - 1] = np.einsum("ins,js->inj", blocks[k - 1], rr)
    return blocks


def inflate_ranks(blocks, target: Sequence[int], eps: float = 1e-3, seed: int = 0):
    """Grow bond ranks toward ``target`` by appending small random directions
    (scale eps x core norm). ALS refits the new capacity at once; the random
    content only conditions the first solve."""
    rng = np.random.default_rng(seed)
    d = len(blocks)
    for k in range(d - 1):
        r_now = blocks[k].shape[2]
        r_new = min(int(target[k + 1]), blocks[k].shape[0] * blocks[k].shape[1] * 4)
        if r_new <= r_now:
            continue
        add = r_new - r_now
        sc = eps * max(np.linalg.norm(blocks[k]), 1e-12) / np.sqrt(add)
        ext = rng.standard_normal((blocks[k].shape[0], blocks[k].shape[1], add)) * sc
        blocks[k] = np.concatenate([blocks[k], ext], axis=2)
        zer = np.zeros((add, blocks[k + 1].shape[1], blocks[k + 1].shape[2]))
        blocks[k + 1] = np.concatenate([blocks[k + 1], zer], axis=0)
    return blocks


# ------------------------------------------------------------ device parts


def _frames(cores, pts_flat, k: int):
    """Left/right frame row vectors at points [M, d] for centre core k:

        L[m] = prod_{j<k} core_j[:, pts_j, :]  -> [M, r]
        R[m] = prod_{j>k} core_j[:, pts_j, :]  -> [M, r]

    in the matmul-then-select form (one dense contraction a core). Works on
    zero-padded cores: padded entries stay exactly zero through the products.
    """
    d = len(cores)
    M = pts_flat.shape[0]
    dev, dt = cores[0].device, cores[0].dtype
    L = torch.zeros((M, cores[0].shape[0]), dtype=dt, device=dev)
    L[:, 0] = 1.0
    for j in range(k):
        c = cores[j]
        r_l, n, r_r = c.shape
        prod = (L @ c.reshape(r_l, n * r_r)).reshape(M, n, r_r)
        L = prod.gather(1, pts_flat[:, j][:, None, None].expand(M, 1, r_r))[:, 0]
    R = torch.zeros((M, cores[-1].shape[2]), dtype=dt, device=dev)
    R[:, 0] = 1.0
    for j in range(d - 1, k, -1):
        c = cores[j]
        r_l, n, r_r = c.shape
        # suffix product: core[:, i, :] @ R^T, then select i
        prod = (c.reshape(r_l * n, r_r) @ R.T).reshape(r_l, n, M)
        R = prod.gather(1, pts_flat[:, j][None, None, :].expand(r_l, 1, M))[:, 0].T
    return L, R


@dataclasses.dataclass
class PIALSResult:
    v: TT
    history: list
    best_outer: int
    n_evals: int
    wall_time: float


def _rows_chunk(L, R, islice, w, n: int):
    """Densified least-squares rows of one sample chunk.

    L [S, T, r1], R [S, T, r2], islice [S, T] (node index along the centre
    dim), w [S, T] -> Z [S, P], P = n r1 r2 in vec order (i, a, b):
    Z[s] = sum_t w[s, t] e_{i_t} (x) (l_t r_t^T). The sum over t is a
    batched matmul of a one-hot selection (no scatter: the same sums in the
    same order on every device)."""
    S, T, r1 = L.shape
    r2 = R.shape[2]
    onehot = (islice[:, :, None] == torch.arange(n, device=L.device)).to(L.dtype)   # [S, T, n]
    A = onehot[:, :, :, None] * (L * w[:, :, None])[:, :, None, :]                 # [S, T, n, r1]
    Z = torch.bmm(A.reshape(S, T, n * r1).transpose(1, 2), R)                     # [S, n r1, r2]
    return Z.reshape(S, n * r1 * r2)


def _normal_eq_chunk(L, R, islice, w, rhs, n: int):
    """One chunk's contribution (G, b) to the normal equations."""
    Zf = _rows_chunk(L, R, islice, w, n)
    return Zf.T @ Zf, Zf.T @ rhs


def _row_grad_chunk(L, R, islice, w, rhs, x, n: int):
    """One chunk's contribution to (M^T (rhs - M x), ||rhs - M x||^2), the
    residual taken against the EXACT rows (corrected-seminormal refinement:
    attainable error ~ kappa(M) eps instead of kappa(M)^2 eps; the MCA
    operator has sigma_min ~ beta dt, so the squared conditioning of float32
    normal equations alone is fatal)."""
    Zf = _rows_chunk(L, R, islice, w, n)
    res = rhs - Zf @ x
    return Zf.T @ res, torch.sum(res * res)


def pi_als(
    problem: ControlProblem,
    grid: Grid,
    controls,
    v0: TT,
    rmax: int = 48,
    schedule: Sequence[tuple] = ((2, 24), (3, 32), (10, 48)),
    n_samples: int | None = None,
    oversample: float = 3.0,
    sweeps: int = 1,
    lam_rel: float = 3e-2,
    refine_iters: int = 4,
    chunk: int = 4096,
    n_check: int = 4096,
    patience: int = 4,
    seed: int = 11,
    interior_frac: float = 0.5,
    dtype=torch.float32,
    verbose: bool = False,
    kernel=None,
    device=None,
) -> PIALSResult:
    """Policy iteration with ALS-LS policy evaluation (module docstring), on
    ``device`` (None: the default CUDA device).

    ``schedule``: ((outer_iters, rank_cap), ...) — ranks ramp as PI
    converges (the normal-equation work is O(P^3), P = r n r). ``oversample``:
    least-squares rows per core parameter (terminal rows included).
    ``interior_frac``: the share of rows drawn off the faces; the rest are
    uniform over the grid so absorbing faces are fitted too. ``kernel``: the
    Bellman backup for the acceptance check (default
    ``make_bellman_kernel(..., chunk=32768)``).

    Acceptance: the sampled sup|Tv - v| on a fixed check set (the oracle-free
    contraction bound) decides, and the best iterate is returned — an outer
    iteration never silently degrades the result; the input is the first
    candidate (``best_outer == -1``).
    """
    t0 = time.time()
    device = resolve_device(device)
    d = problem.dx
    shape = tuple(grid.shape)
    controls = np.asarray(controls, np.float32)
    uc = torch.as_tensor(controls, dtype=dtype, device=device)
    if kernel is None:
        kernel = make_bellman_kernel(problem, grid, controls, chunk=32768, dtype=dtype)

    rng = np.random.default_rng(seed)
    check_idx = torch.as_tensor(np.stack([rng.integers(0, n, n_check) for n in shape], -1),
                                dtype=torch.int64, device=device)

    def sample_idx(S):
        S_int = int(round(S * interior_frac))
        cols_u = [rng.integers(0, n, S - S_int) for n in shape]
        cols_i = [rng.integers(1, max(n - 1, 2), S_int) for n in shape]
        return np.stack([np.concatenate([u, i]) for u, i in zip(cols_u, cols_i)], -1)

    def bres_of(v_tt):
        with torch.no_grad():
            cur = tt_gather_eval(v_tt, check_idx).double().cpu().numpy()
            tv = kernel(v_tt, check_idx).double().cpu().numpy()
        return cur, float(np.max(np.abs(tv - cur)))

    blocks = tt_to_blocks(v0)
    history = []
    n_evals = 0
    # baseline acceptance: never return anything worse than the input
    v_in = blocks_to_tt(blocks, rmax, dtype, device)
    best = (bres_of(v_in)[1], v_in, -1)
    outer = 0
    stall = 0
    T = 2 * d + 1
    for stage_iters, cap in schedule:
        # rank targets for this stage: min(cap, full left/right unfoldings)
        tgt = [1] + [min(cap, int(np.prod(shape[: k + 1])), int(np.prod(shape[k + 1:])))
                     for k in range(d - 1)] + [1]
        blocks = inflate_ranks(blocks, tgt, seed=seed + outer)
        for _ in range(stage_iters):
            P_max = max(b.shape[0] * b.shape[1] * b.shape[2] for b in blocks)
            S = n_samples or int(oversample * P_max)
            idx = torch.as_tensor(sample_idx(S), dtype=torch.int64, device=device)
            v_tt = blocks_to_tt(blocks, rmax, dtype, device)
            with torch.no_grad():
                pts, w, rhs = frozen_policy_rows(problem, grid, uc, v_tt, idx, dtype)
            n_evals += S * T
            pts_flat = pts.reshape(-1, d)

            # ALS sweep(s): left to right, then right to left
            order = list(range(d)) + list(range(d - 2, 0, -1))
            for _swp in range(sweeps):
                blocks = _orthogonalize(blocks, order[0])
                pos = order[0]
                for k in order:
                    if k != pos:
                        blocks = _move_center(blocks, pos, forward=(k > pos))
                        pos = k
                    blocks[k] = _solve_core(blocks, k, tgt, shape, rmax, dtype, device,
                                            pts, pts_flat, w, rhs, S, T, chunk, lam_rel,
                                            refine_iters)

            # acceptance check on the fixed common-random-number set
            v_tt = blocks_to_tt(blocks, rmax, dtype, device)
            cur, bres_abs = bres_of(v_tt)
            scale = max(float(np.max(np.abs(cur))), 1e-12)
            rec = {"outer": outer, "cap": cap, "S": S,
                   "ranks": [b.shape[0] for b in blocks] + [1],
                   "bres_abs": bres_abs, "bres": bres_abs / scale}
            history.append(rec)
            if verbose:
                print(f"[pi_als] outer={outer} cap={cap} S={S} bres={rec['bres']:.3e} "
                      f"ranks={rec['ranks']}", flush=True)
            if bres_abs < best[0]:
                best = (bres_abs, v_tt, outer)
                stall = 0
            else:
                stall += 1
                if stall > patience:
                    return PIALSResult(best[1], history, best[2], n_evals, time.time() - t0)
            outer += 1
    return PIALSResult(best[1], history, best[2], n_evals, time.time() - t0)


@torch.no_grad()
def _solve_core(blocks, k, tgt, shape, rmax, dtype, device, pts, pts_flat, w, rhs, S, T,
                chunk, lam_rel, refine_iters):
    """The least-squares update of core k (every other core frozen and
    orthogonalised): chunked normal equations, a Cholesky factor of
    G + lam I, and corrected-seminormal refinement with a proximal pull
    toward the current core. Returns the new core as float64 numpy."""
    # frames over cores PADDED to the static rmax, then sliced to the
    # stage's per-bond target ranks; padded directions have zero rows in G,
    # so the proximal lambda holds them at their start value (zero)
    Lf, Rf = _frames(blocks_to_tt(blocks, rmax, dtype, device).cores, pts_flat, k)
    r1, r2 = blocks[k].shape[0], blocks[k].shape[2]
    n_k = shape[k]
    rp1 = max(int(tgt[k]), r1)          # never drop active
    rp2 = max(int(tgt[k + 1]), r2)      # frame columns
    Lf = Lf[:, :rp1].reshape(S, T, rp1)
    Rf = Rf[:, :rp2].reshape(S, T, rp2)
    isl = pts[:, :, k]
    P = n_k * rp1 * rp2
    spans = [(c0, min(c0 + chunk, S)) for c0 in range(0, S, chunk)]
    G = torch.zeros((P, P), dtype=dtype, device=device)
    for c0, c1 in spans:
        Gc, _ = _normal_eq_chunk(Lf[c0:c1], Rf[c0:c1], isl[c0:c1], w[c0:c1], rhs[c0:c1], n_k)
        G = G + Gc
    lam = lam_rel * (torch.trace(G) / (n_k * r1 * r2))
    Lc, info = torch.linalg.cholesky_ex(G + lam * torch.eye(P, dtype=dtype, device=device))
    # a failed factor gives NaN, as jax.scipy.linalg.cho_factor does
    Lc = torch.where(info == 0, Lc, torch.full_like(Lc, float("nan")))
    del G
    x0_np = np.zeros((n_k, rp1, rp2))
    x0_np[:, :r1, :r2] = blocks[k].transpose(1, 0, 2)
    x0 = torch.as_tensor(x0_np.reshape(P), dtype=dtype, device=device)
    x = x0
    best_x, best_res = x0, np.inf
    for r in range(refine_iters + 1):
        gvec = -lam * (x - x0)
        rsq = torch.zeros((), dtype=torch.float64, device=device)
        for c0, c1 in spans:
            gc, rc = _row_grad_chunk(Lf[c0:c1], Rf[c0:c1], isl[c0:c1], w[c0:c1], rhs[c0:c1], x,
                                     n_k)
            gvec = gvec + gc
            rsq = rsq + rc.double()
        rsq = float(rsq)
        # keep the best row-residual iterate: with kappa(G) >> 1/eps_f32 the
        # float32 preconditioner can over- or undershoot; monitoring makes
        # the refinement monotone in the TRUE objective
        if rsq < best_res:
            best_x, best_res = x, rsq
        elif rsq > 1.2 * best_res:
            break
        if r < refine_iters:
            x = x + torch.cholesky_solve(gvec[:, None], Lc)[:, 0]
    return best_x.double().cpu().numpy().reshape(n_k, rp1, rp2)[:, :r1, :r2].transpose(1, 0, 2)
