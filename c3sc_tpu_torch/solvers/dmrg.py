"""Two-site DMRG cross approximation — port of ``c3sc_tpu/solvers/dmrg.py``
(C3's ``dmrg*.c`` over the discrete linear-element TT).

Two-site sweeps reveal the rank between cores k and k+1 by an SVD of the
merged supercore, so ranks adapt in one step instead of by the kick-and-
round creep of single-site cross. The supercore block (r_l n_k n_{k+1} r_r
points) is one call of the black box on the device; the SVD, the LU pivots
and the maxvol swaps run on the device; the index sets and the rank choice
stay on the host with exact shapes, as in ``ops/cross.py``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.ops.cross import (CrossResult, CrossState, _lu_rows, _maxvol_swaps,
                                      _pad_tt, default_sample_idx, fiber_block,
                                      init_cross_state)
from c3sc_tpu_torch.ops.tt import tt_gather_eval
from c3sc_tpu_torch.seeds import seed_stream


def _choose_rank_svd(s, eps: float, rmax: int) -> int:
    s = np.asarray(s)
    smax = s[0] if s.size and s[0] > 0 else 1.0
    return int(max(1, min(int(np.sum(s > eps * smax)), rmax)))


def _svd_select(M, r_new: int):
    """Top-r_new left singular basis of M, maxvol pivot rows in it (LU seed
    and four swaps), and the CUR interpolation factor G = U_r (U_r[rows])^-1
    (G[rows] = I). G depends on the basis's span only, so the singular
    vectors' free signs do not reach it. Returns (rows, G, s)."""
    U, s, _ = torch.linalg.svd(M, full_matrices=False)
    Ur = U[:, :r_new]
    rows, G = _maxvol_swaps(Ur, _lu_rows(Ur)[:r_new], r_new, 4)
    return rows, G, s


def dmrg_cross(
    f: Callable,
    shape: Sequence[int],
    rmax: int,
    seed: int | Sequence[int] = 0,
    state: CrossState | None = None,
    r0: int = 2,
    tol: float = 1e-5,
    eps_rank: float = 1e-7,
    max_sweeps: int = 5,
    sample_idx=None,
    dtype=torch.float32,
    verbose: bool = False,
    device=None,
) -> CrossResult:
    """Approximate ``f(idx [B, d] int64 tensor) -> [B]`` as a padded TT on
    ``device`` (None: the default CUDA device) by two-site DMRG sweeps. Same
    contract as ``ops.cross.tt_cross``; ranks come from supercore SVDs (no
    kick). ``seed``: an int draws the first index sets' seed from
    ``np.random.default_rng(seed)``; a one-item sequence gives it (JAX's key
    k0 as ``randint(k0, (), 0, 2**31 - 1)``)."""
    d = len(shape)
    if d < 2:
        raise ValueError("dmrg_cross needs at least 2 dimensions")
    device = resolve_device(device)
    if state is None:
        state = init_cross_state(seed_stream(seed, 1)(), shape, r0)
    if sample_idx is None:
        sample_idx = default_sample_idx(shape, 54321)
    sample_t = torch.as_tensor(np.asarray(sample_idx), dtype=torch.int64, device=device)

    n_evals = 0

    def eval_block2(I, k, J):
        """f on I x grid_k x grid_{k+1} x J -> [r_l n_k, n_{k+1} r_r]."""
        nonlocal n_evals
        n0, n1 = shape[k], shape[k + 1]
        M = fiber_block(f, shape, dtype, device,
                        [I[:, None, None, None, :], np.arange(n0)[None, :, None, None, None],
                         np.arange(n1)[None, None, :, None, None], J[None, None, None, :, :]])
        n_evals += M.numel()
        return M.reshape(I.shape[0] * n0, n1 * J.shape[0])

    def svals(M):
        return torch.linalg.svdvals(M).double().cpu().numpy()

    cores = [None] * d
    errors = []
    prev_sample = None
    converged = False
    for sweep in range(max_sweeps):
        # ---- left-to-right two-site sweep: updates cores k, left[k+1] ------
        for k in range(d - 1):
            I, J = state.left[k], state.right[k + 2]
            rl, rr = I.shape[0], J.shape[0]
            n0, n1 = shape[k], shape[k + 1]
            M = eval_block2(I, k, J)                              # [rl n0, n1 rr]
            r_new = min(_choose_rank_svd(svals(M), eps_rank, rmax), rl * n0, n1 * rr)
            rows, G, _ = _svd_select(M, r_new)
            rows_np = rows.cpu().numpy()
            a, i = rows_np // n0, rows_np % n0
            state.left[k + 1] = np.concatenate([I[a], i[:, None]], axis=-1)
            cores[k] = G.reshape(rl, n0, r_new)
            # provisional next core from the pivot rows (exact interpolation):
            # M ~ G M[rows]; M[rows] reshapes to core k+1 against right[k+2]
            cores[k + 1] = M[rows].reshape(r_new, n1, rr)

        # convergence check on the sample set
        cur = tt_gather_eval(_pad_tt(cores, rmax, dtype, device), sample_t)
        if prev_sample is not None:
            denom = float(torch.max(torch.abs(cur))) + 1e-12
            err = float(torch.max(torch.abs(cur - prev_sample))) / denom
            errors.append(err)
            if verbose:
                print(f"[dmrg] sweep={sweep} err={err:.3e} "
                      f"ranks={[c.shape[2] for c in cores[:-1]]}")
            if err < tol:
                converged = True
                break
        prev_sample = cur

        # ---- right-to-left two-site sweep: updates right[k+1] --------------
        for k in range(d - 2, -1, -1):
            I, J = state.left[k], state.right[k + 2]
            rl, rr = I.shape[0], J.shape[0]
            n0, n1 = shape[k], shape[k + 1]
            M = eval_block2(I, k, J)
            Mt = M.reshape(rl, n0, n1, rr).permute(2, 3, 0, 1).reshape(n1 * rr, rl * n0)
            r_new = min(_choose_rank_svd(svals(Mt), eps_rank, rmax), rl * n0, n1 * rr)
            rows, G, _ = _svd_select(Mt, r_new)
            rows_np = rows.cpu().numpy()
            i, b = rows_np // rr, rows_np % rr
            state.right[k + 1] = np.concatenate([i[:, None], J[b]], axis=-1)
            cores[k + 1] = G.T.reshape(r_new, n1, rr)
            cores[k] = Mt[rows].T.reshape(rl, n0, r_new)

    tt = _pad_tt(cores, rmax, dtype, device)
    return CrossResult(tt=tt, state=state, n_evals=n_evals, sweeps=sweep + 1,
                       converged=converged, errors=errors)
