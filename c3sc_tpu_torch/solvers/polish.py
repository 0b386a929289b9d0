"""Frozen-target two-site polish: projected value iteration with
quasi-optimal fits — port of ``c3sc_tpu/solvers/polish.py``.

The fused solve's floor comes from per-fit churn that the value iteration
amplifies. The polish attacks the per-fit error:

    v_{k+1} = Fit2s(T(v_k)),    T evaluated pointwise, target frozen,

where ``Fit2s`` is a two-site (DMRG-style) cross fit whose every
decomposition runs on the HOST in float64 numpy: a supercore SVD reveals the
bond rank in one shot, maxvol pivoting runs to convergence (|G| <= 1.02), so
the interpolation factor has a controlled norm. Only the Bellman target
evaluation runs on the device, through ``ttvi.make_bellman_kernel``; each
evaluation of a fiber block is one index upload and one value download.

Also here: the slow-mode defect corrections ``level_correct`` (the value
level) and ``mode_correct`` (the level, one ramp per dimension, optionally
the boundary-layer rings), each a Newton step on a sampled defect.

Where the JAX package splits a JAX key to draw fresh cross index sets, the
port draws them from a ``torch.Generator`` (``ops/cross.init_cross_state``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import Boundary, ControlProblem
from c3sc_tpu_torch.ops.cross import CrossState, init_cross_state
from c3sc_tpu_torch.ops.tt import (TT, _repad, tt_add, tt_constant, tt_gather_eval, tt_rank1,
                                   tt_round)
from c3sc_tpu_torch.solvers.ttvi import make_bellman_kernel

# ------------------------------------------------------------- host linalg


def _maxvol(U: np.ndarray, tol: float = 1.02, max_iter: int = 200):
    """Maxvol row selection in an orthonormal basis U [m, r], run to
    convergence (max |G| <= tol). Returns (rows [r], G [m, r]) with
    G = U (U[rows])^{-1}, G[rows] = I."""
    m, r = U.shape
    if m == r:
        return np.arange(r), np.eye(r, dtype=U.dtype)
    # init: Gaussian elimination with full row pivoting (independent rows)
    A = U.copy()
    rows = np.empty(r, np.int64)
    for j in range(r):
        i = int(np.argmax(np.abs(A[:, j])))
        rows[j] = i
        piv = A[i, j]
        if abs(piv) < 1e-300:
            # degenerate column: fall back to an unused row
            unused = np.setdiff1d(np.arange(m), rows[: j + 1])
            rows[j] = unused[0] if unused.size else i
            continue
        A -= np.outer(A[:, j] / piv, A[i, :])
    G = np.linalg.solve(U[rows].T, U.T).T
    for _ in range(max_iter):
        flat = int(np.argmax(np.abs(G)))
        i, j = flat // r, flat % r
        if abs(G[i, j]) <= tol:
            break
        rows[j] = i
        G = np.linalg.solve(U[rows].T, U.T).T
    return rows, G


def _svd_rank(s: np.ndarray, eps: float, cap: int) -> int:
    smax = s[0] if s.size and s[0] > 0 else 1.0
    return int(max(1, min(int(np.sum(s > eps * smax)), cap)))


# ------------------------------------------------------------ two-site fit


def _select_rows(U: np.ndarray, oversample: float, smax: int):
    """Row selection in the orthonormal basis U [m, r].

    oversample == 0: maxvol rows and the interpolatory factor
    G = U (U[rows])^{-1} (G[rows] = I, |G| <= 1.02).

    oversample > 0: the maxvol rows extended by the highest-leverage unselected
    rows to s = min(ceil((1 + os) r), smax, m), and the least-squares factor
    G = U (U[rows])^+ [m, s] of rank r."""
    m, r = U.shape
    rows, G = _maxvol(U)
    if oversample <= 0:
        return rows, G
    s = min(int(np.ceil((1.0 + oversample) * r)), smax, m)
    if s > r:
        lev = np.einsum("ij,ij->i", U, U)          # leverage scores
        lev[rows] = -np.inf
        extra = np.argpartition(-lev, s - r - 1)[: s - r]
        rows = np.concatenate([rows, extra])
    G = U @ np.linalg.pinv(U[rows])                # [m, s], rank r
    return rows, G


def _fit2site(
    f: Callable,
    shape: Sequence[int],
    state: CrossState,
    rmax_pad: int,
    cap: int,
    eps_rank: float,
    n_sweeps: int,
    dtype=np.float32,
    oversample: float = 0.0,
    device=None,
):
    """Two-site cross fit of the black box ``f(idx [B, d] int64 tensor) -> [B]``.

    Each fiber block is one call of f: its indices go up to ``device`` in
    one upload and its values come back in one download. All decompositions
    run in host float64. Returns (padded TT on ``device``, state, n_evals);
    the state's nested index sets are updated in place (the warm start
    across polish steps).

    ``oversample > 0``: core_k is the orthonormal SVD basis itself and
    core_{k+1} the least-squares solve from s = (1 + os) r sampled rows.
    """
    d = len(shape)
    n_evals = 0

    def eval_block2(I, k, J):
        nonlocal n_evals
        rl, rr = I.shape[0], J.shape[0]
        n0, n1 = shape[k], shape[k + 1]
        ii = np.broadcast_to(I[:, None, None, None, :], (rl, n0, n1, rr, I.shape[1]))
        m0 = np.broadcast_to(np.arange(n0)[None, :, None, None, None], (rl, n0, n1, rr, 1))
        m1 = np.broadcast_to(np.arange(n1)[None, None, :, None, None], (rl, n0, n1, rr, 1))
        jj = np.broadcast_to(J[None, None, None, :, :], (rl, n0, n1, rr, J.shape[1]))
        idx = np.concatenate([ii, m0, m1, jj], axis=-1).reshape(-1, d)
        n_evals += idx.shape[0]
        vals = f(torch.as_tensor(idx, dtype=torch.int64, device=device))
        return vals.cpu().numpy().astype(np.float64).reshape(rl * n0, n1 * rr)

    cores = [None] * d
    for _ in range(n_sweeps):
        # ---- left-to-right: updates cores[k], left[k+1] -------------------
        for k in range(d - 1):
            I, J = state.left[k], state.right[k + 2]
            rl, rr = I.shape[0], J.shape[0]
            n0, n1 = shape[k], shape[k + 1]
            M = eval_block2(I, k, J)                     # [rl*n0, n1*rr] f64
            U, sv, _ = np.linalg.svd(M, full_matrices=False)
            r = _svd_rank(sv, eps_rank, min(cap, rl * n0, n1 * rr, rmax_pad))
            rows, G = _select_rows(U[:, :r], oversample, min(rl * n0, rmax_pad))
            a, i = rows // n0, rows % n0
            state.left[k + 1] = np.concatenate([I[a], i[:, None]], axis=-1)
            s = len(rows)
            cores[k] = G.reshape(rl, n0, s)
            cores[k + 1] = M[rows].reshape(s, n1, rr)    # provisional
        # ---- right-to-left: updates cores[k+1], right[k+1] ----------------
        for k in range(d - 2, -1, -1):
            I, J = state.left[k], state.right[k + 2]
            rl, rr = I.shape[0], J.shape[0]
            n0, n1 = shape[k], shape[k + 1]
            M = eval_block2(I, k, J)
            Mt = M.reshape(rl, n0, n1, rr).transpose(2, 3, 0, 1).reshape(n1 * rr, rl * n0)
            U, sv, _ = np.linalg.svd(Mt, full_matrices=False)
            r = _svd_rank(sv, eps_rank, min(cap, rl * n0, n1 * rr, rmax_pad))
            rows, G = _select_rows(U[:, :r], oversample, min(n1 * rr, rmax_pad))
            i, b = rows // rr, rows % rr
            state.right[k + 1] = np.concatenate([i[:, None], J[b]], axis=-1)
            s = len(rows)
            cores[k + 1] = G.T.reshape(s, n1, rr)
            cores[k] = Mt[rows].T.reshape(rl, n0, s)

    # pad into the static-rank TT (zero-padding invariant)
    R = rmax_pad
    ranks = [1] + [c.shape[2] for c in cores[:-1]] + [1]
    padded = []
    for k, c in enumerate(cores):
        full = np.zeros((R, shape[k], R), dtype)
        full[: c.shape[0], :, : c.shape[2]] = c
        padded.append(torch.as_tensor(full, device=device))
    return (TT(tuple(padded), torch.as_tensor(ranks, dtype=torch.int32, device=device)),
            state, n_evals)


# ------------------------------------------------------- level correction


def _sample_inner_nodes(shape, n_samples: int, seed: int) -> np.ndarray:
    """Random nodes one off every face (numpy seed), as the corrections draw them."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(1, max(n - 1, 2), n_samples) for n in shape], -1)


def _device_of(v: TT) -> torch.device:
    return v.cores[0].device


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def level_correct(
    problem: ControlProblem,
    grid: Grid,
    controls,
    v: TT,
    kernel=None,
    n_samples: int = 8192,
    iters: int = 3,
    seed: int = 13,
    chunk: int = 32768,
    verbose: bool = False,
):
    """Scalar slow-mode (value-LEVEL) defect correction.

    The projected VI's slowest mode is the global value level: it contracts
    at E[e^(-beta dt)] per application. This Newton iteration solves for the
    scalar shift directly:
        s  = mean(T(v + delta) - T(v)) / delta   (the operator's measured slope
             in the constant direction, terminal-pinning leakage included)
        c  = mean(T(v) - v) / (1 - s)
        v <- v + c
    Two kernel evaluations per iteration; oracle-free. Returns (v, history).
    """
    if kernel is None:
        kernel = make_bellman_kernel(problem, grid, controls, chunk=chunk)
    dev = _device_of(v)
    idx = torch.as_tensor(_sample_inner_nodes(grid.shape, n_samples, seed), device=dev)
    shape = tuple(grid.shape)
    R = v.rmax
    history = []
    for it in range(iters):
        tv = _host(kernel(v, idx))
        vv = _host(tt_gather_eval(v, idx))
        d = float(np.mean(tv - vv))
        delta = max(1.0, 0.01 * float(np.max(np.abs(vv))))
        v_shift = tt_round(tt_add(v, tt_constant(shape, delta, R, device=dev),
                                  on_overflow="round"), 1e-9, R)
        tv_s = _host(kernel(v_shift, idx))
        s = float(np.mean(tv_s - tv)) / delta
        c = d / max(1.0 - s, 1e-4)
        v = tt_round(tt_add(v, tt_constant(shape, c, R, device=dev), on_overflow="round"),
                     1e-9, R)
        history.append({"iter": it, "mean_defect": d, "slope": s, "shift": c})
        if verbose:
            print(f"[level] it={it} mean_defect={d:+.4f} slope={s:.5f} shift={c:+.4f}",
                  flush=True)
        if abs(c) < 1e-3:
            break
    return v, history


def _ramp(grid: Grid, k: int) -> np.ndarray:
    """The centred, range-normalised node coordinate of dim k (float32)."""
    nk = np.asarray(grid.nodes(k), np.float32)
    return (nk - nk.mean()) / max(nk.max() - nk.min(), 1e-9)


def _axis_mode(shape, k: int, factor: np.ndarray, R: int, device) -> TT:
    """The rank-1 TT of ``factor`` along dim k and ones elsewhere."""
    return tt_rank1([torch.as_tensor(factor, device=device) if j == k
                     else torch.ones(shape[j], dtype=torch.float32, device=device)
                     for j in range(len(shape))], R)


def mode_correct(
    problem: ControlProblem,
    grid: Grid,
    controls,
    v: TT,
    kernel=None,
    n_samples: int = 8192,
    iters: int = 2,
    seed: int = 13,
    chunk: int = 32768,
    damping: float = 1e-3,
    ring_modes: bool = False,
    verbose: bool = False,
):
    """Slow-mode SUBSPACE defect correction (generalises ``level_correct``).

    Modes: the constant plus one centred linear ramp per dimension, and with
    ``ring_modes=True`` one boundary-layer indicator per bounded-dim face
    (node 1 and node n-2). For each mode phi_m one extra kernel evaluation
    measures the operator's action, (T(v + delta phi_m) - T(v)) / delta; the
    Newton step solves the sampled least squares
        min_c || d + sum_m c_m (img_m - phi_m) ||^2,   d = T(v) - v,
    and sets v <- v + sum_m c_m phi_m. Returns (v, history).
    """
    if kernel is None:
        kernel = make_bellman_kernel(problem, grid, controls, chunk=chunk)
    shape = tuple(grid.shape)
    R = v.rmax
    dev = _device_of(v)
    idx_np = _sample_inner_nodes(shape, n_samples, seed)
    idx = torch.as_tensor(idx_np, device=dev)

    # mode TTs and their node values at the sample
    modes = [tt_constant(shape, 1.0, R, device=dev)]
    mode_vals = [np.ones(n_samples)]
    for k in range(grid.ndim):
        ramp = _ramp(grid, k)
        modes.append(_axis_mode(shape, k, ramp, R, dev))
        mode_vals.append(ramp[idx_np[:, k]])
    if ring_modes:
        for k in range(grid.ndim):
            if problem.boundary[k] == Boundary.PERIODIC:
                continue
            for j_ring in (1, shape[k] - 2):
                spike = np.zeros(shape[k], np.float32)
                spike[j_ring] = 1.0
                modes.append(_axis_mode(shape, k, spike, R, dev))
                mode_vals.append((idx_np[:, k] == j_ring).astype(np.float64))
    Phi = np.stack(mode_vals, axis=1)                      # [N, M]
    M = Phi.shape[1]

    history = []
    for it in range(iters):
        tv = _host(kernel(v, idx))
        vv = _host(tt_gather_eval(v, idx))
        d = tv - vv                                        # [N]
        scale = max(float(np.max(np.abs(vv))), 1.0)
        delta = 0.01 * scale
        cols = []
        for m in range(M):
            v_s = tt_round(tt_add(v, _scale_tt(modes[m], delta), on_overflow="round"), 1e-9, R)
            img = (_host(kernel(v_s, idx)) - tv) / delta
            cols.append(img - Phi[:, m])                   # (gamma P - I) phi
        A = np.stack(cols, axis=1)                         # [N, M]
        c, *_ = np.linalg.lstsq(A.astype(np.float64), -d.astype(np.float64), rcond=None)
        # huge shifts mean the local model is invalid
        c = np.clip(c, -0.2 * scale, 0.2 * scale)
        for m in range(M):
            v = tt_round(tt_add(v, _scale_tt(modes[m], float(c[m])), on_overflow="round"),
                         1e-9, R)
        history.append({"iter": it, "mean_defect": float(d.mean()),
                        "rms_defect": float(np.sqrt((d ** 2).mean())),
                        "coeffs": [float(x) for x in c]})
        if verbose:
            print(f"[modes] it={it} mean_d={d.mean():+.4f} rms_d={np.sqrt((d**2).mean()):.4f} "
                  f"c={np.round(c, 3)}", flush=True)
        if float(np.abs(c).max()) < damping * scale:
            break
    return v, history


def _scale_tt(tt: TT, alpha: float) -> TT:
    return TT((tt.cores[0] * alpha,) + tuple(tt.cores[1:]), tt.ranks)


# ------------------------------------------------------------- the polish loop


@dataclasses.dataclass
class PolishResult:
    v: TT
    history: list              # per-step dicts (step, cap, disp, bres, ...)
    best_step: int
    n_evals: int
    wall_time: float
    state: CrossState | None = None   # final index sets (warm restart)


def tt_polish(
    problem: ControlProblem,
    grid: Grid,
    controls,
    v0: TT,
    rmax: int = 64,
    schedule: Sequence[tuple] = ((10, 24), (10, 40), (20, 64)),
    eps_rank: float = 1e-5,
    oversample: float = 0.0,
    first_step_sweeps: int = 2,
    generator: torch.Generator | None = None,
    chunk: int = 32768,
    n_check: int = 4096,
    check_every: int = 1,
    seed: int = 7,
    verbose: bool = False,
    kernel=None,
    state: CrossState | None = None,
    average_tail: int = 0,
    reroll_every: int = 0,
) -> PolishResult:
    """Polish a fused-VI solution by frozen-target two-site projected VI, on
    the device of ``v0``.

    ``schedule``: ((steps, rank_cap), ...) or ((steps, cap, sweeps), ...).
    ``kernel``: override the Bellman evaluator (``make_bellman_kernel``'s
    signature); ``two_level_solve`` passes the composite TT+patch kernel.
    ``state``: warm-start cross index sets; without one, and at every
    re-roll, fresh sets are drawn from ``generator`` (None: a CPU generator
    seeded 0), where the JAX package splits its key.

    The returned iterate is the one with the smallest absolute sampled
    Bellman residual sup|Tv - v| (at ``n_check`` nodes, numpy seed ``seed``).
    ``average_tail > 0`` also averages the last iterates and returns the
    average if its residual is smaller; ``reroll_every = k`` re-draws the
    cross state every k steps, so successive epochs carry independent fit
    biases for that average to cancel.
    """
    t0 = time.time()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    shape = tuple(grid.shape)
    dev = _device_of(v0)
    if kernel is None:
        kernel = make_bellman_kernel(problem, grid, controls, chunk=chunk)
    v_cur = _repad(v0, rmax)

    rng = np.random.default_rng(seed)
    check_idx = torch.as_tensor(np.stack([rng.integers(0, n, n_check) for n in shape], -1),
                                device=dev)

    def geval(tt):
        return _host(tt_gather_eval(tt, check_idx))

    if state is None:
        state = init_cross_state(generator, shape, int(min(schedule[0][1], 8)))

    history = []
    best = (np.inf, v_cur, -1)
    prev_check = geval(v_cur)
    n_evals = 0
    step = 0
    total_steps = sum(s[0] for s in schedule)
    avg_sum, avg_n = None, 0
    Ravg = min(2 * rmax, 160)
    for stage in schedule:
        n_steps, cap = stage[0], stage[1]
        stage_sweeps = stage[2] if len(stage) > 2 else 1
        for _ in range(n_steps):
            fresh = step == 0 or (reroll_every > 0 and step % reroll_every == 0)
            if fresh and step > 0:
                state = init_cross_state(generator, shape, int(min(cap, 8)))
            sweeps = first_step_sweeps if fresh else stage_sweeps
            v_new, state, ne = _fit2site(lambda idx: kernel(v_cur, idx), shape, state, rmax,
                                         cap, eps_rank, sweeps, oversample=oversample,
                                         device=dev)
            n_evals += ne
            rec = {"step": step, "cap": cap, "ranks": v_new.ranks.tolist()}
            if (step + 1) % check_every == 0 or step == 0:
                cur = geval(v_new)
                tv = _host(kernel(v_new, check_idx))
                scale = max(float(np.max(np.abs(cur))), 1e-12)
                rec["disp"] = float(np.max(np.abs(cur - prev_check))) / scale
                rec["bres_abs"] = float(np.max(np.abs(tv - cur)))
                rec["bres"] = rec["bres_abs"] / scale
                prev_check = cur
                if rec["bres_abs"] < best[0]:
                    best = (rec["bres_abs"], v_new, step)
            history.append(rec)
            if verbose and "bres" in rec:
                print(f"[polish] step={step} cap={cap} disp={rec['disp']:.3e} "
                      f"bres={rec['bres']:.3e} ranks={rec['ranks']}", flush=True)
            v_cur = v_new
            if average_tail > 0 and step >= total_steps - average_tail:
                inc = _repad(v_new, Ravg)
                avg_sum = inc if avg_sum is None else tt_round(
                    tt_add(avg_sum, inc, on_overflow="round"), 1e-7, Ravg)
                avg_n += 1
            step += 1
    if avg_sum is not None and avg_n > 1:
        mean = TT((avg_sum.cores[0] / avg_n,) + tuple(avg_sum.cores[1:]), avg_sum.ranks)
        v_avg = _repad(tt_round(mean, 1e-7, rmax), rmax)
        cur = geval(v_avg)
        bres_avg = float(np.max(np.abs(_host(kernel(v_avg, check_idx)) - cur)))
        history.append({"step": "avg", "n_averaged": avg_n, "bres_abs": bres_avg,
                        "bres": bres_avg / max(float(np.max(np.abs(cur))), 1e-12),
                        "ranks": v_avg.ranks.tolist()})
        if verbose:
            print(f"[polish] tail-average n={avg_n} bres={history[-1]['bres']:.3e} "
                  f"vs best {best[0]:.3e}", flush=True)
        if bres_avg < best[0]:
            best = (bres_avg, v_avg, -2)
    return PolishResult(v=best[1], history=history, best_step=best[2], n_evals=n_evals,
                        wall_time=time.time() - t0, state=state)
