"""Rank-adaptive TT-cross approximation with maxvol pivoting — port of
``c3sc_tpu/ops/cross.py``.

``tt_cross`` builds a TT of a black box f(multi-index) by alternating left
and right sweeps that evaluate f only on fibers through the current cross
index sets. Each core's whole fiber block is one call of f on the device;
the index sets live on the host as numpy integer arrays with exact shapes,
and the rank of each bond is chosen on the host from the fiber matrix's
singular values (``svdvals``, a host read by design: this loop runs on the
host, as in the reference). Pivot rows come from a partial-pivoted LU of
the kick-enriched orthonormal basis plus three maxvol swaps; ties of the
swap's argmax go to the lowest index on every device.

The two-site polish (``solvers/polish.py``) and ``solvers/ttvi.tt_vi`` carry
a ``CrossState`` from one fit to the next, as the reference carries its
``CrossIndex`` across Bellman iterations. Where the JAX package draws the
first sets from a JAX key, ``init_cross_state`` here draws them from a
``torch.Generator`` (or takes the numpy seed itself, which is what a JAX key
turns into).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.ops.argmin import first_argmin
from c3sc_tpu_torch.ops.tt import TT, tt_gather_eval
from c3sc_tpu_torch.seeds import seed_stream


@dataclasses.dataclass
class CrossState:
    """Nested cross index sets (host-side, exact shapes).

    left[k]:  [r_k, k]   multi-indices into dims 0..k-1   (left boundary k)
    right[k]: [r_k, d-k] multi-indices into dims k..d-1   (right boundary k)
    left[0] and right[d] are [1, 0] (empty prefix/suffix).
    """

    left: list
    right: list

    @property
    def ranks_left(self):
        return [a.shape[0] for a in self.left]

    @property
    def ranks_right(self):
        return [a.shape[0] for a in self.right]


@dataclasses.dataclass
class CrossResult:
    tt: TT
    state: CrossState
    n_evals: int
    sweeps: int
    converged: bool
    errors: list


def cross_seed(generator: torch.Generator | None) -> int:
    """The numpy seed in [0, 2^31 - 1) that ``init_cross_state`` draws from
    ``generator`` (None: a CPU generator seeded 0)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return int(torch.randint(0, 2**31 - 1, (), generator=generator, device=generator.device))


def init_cross_state(seed: int | torch.Generator | None, shape: Sequence[int],
                     r0: int) -> CrossState:
    """Random nested right index sets at rank r0 (the left sets are built on
    the first sweep), from the numpy seed ``seed`` or one drawn from a
    ``torch.Generator`` (``cross_seed``). The JAX package's state for a key
    is this function's for ``int(jax.random.randint(key, (), 0, 2**31 - 1))``."""
    if not isinstance(seed, (int, np.integer)):
        seed = cross_seed(seed)
    d = len(shape)
    rng = np.random.default_rng(int(seed))
    left = ([np.zeros((1, 0), np.int64)]
            + [np.stack([rng.integers(0, shape[j], size=r0) for j in range(k)], axis=-1)
               for k in range(1, d)]
            + [np.zeros((1, 0), np.int64)])
    right = ([np.zeros((1, d), np.int64)]  # right[0] unused
             + [np.stack([rng.integers(0, shape[j], size=r0) for j in range(k, d)], axis=-1)
                for k in range(1, d)]
             + [np.zeros((1, 0), np.int64)])
    return CrossState(left=left, right=right)


# ------------------------------------------------------------- device pieces


def _lu_rows(A):
    """Row permutation of a partial-pivoted LU of a tall [m, r] matrix:
    A[perm] = L U (what ``jax.lax.linalg.lu`` returns as its permutation)."""
    P, _, _ = torch.linalg.lu(A)
    return P.argmax(dim=0)


def _maxvol_swaps(qe, rows, r_new: int, n_swaps: int):
    """``n_swaps`` greedy maxvol swaps: G = qe inv(qe[rows]); where max |G|
    exceeds 1.05, the offending row replaces its column's pivot. The first
    maximum wins ties, NaN counting as the largest (``jnp.argmax``). Returns
    (rows, G) with G from the final rows."""

    def core(rows):
        sol, _ = torch.linalg.solve_ex(qe[rows].T, qe.T, check_errors=False)
        return sol.T

    ar = torch.arange(r_new, device=qe.device)
    for _ in range(n_swaps):
        G = core(rows).reshape(-1)
        flat = first_argmin(-torch.abs(G), 0)
        i, j = flat // r_new, flat % r_new
        swap = torch.abs(G.index_select(0, flat.reshape(1))[0]) > 1.05
        rows = torch.where(swap & (ar == j), i, rows)
    return rows, core(rows)


def _select_and_core(C, noise, r_new: int):
    """From a fiber matrix C [m, r_r]: orthogonalise, kick-enrich to r_new
    columns, pick r_new pivot rows, build the interpolation core.

    Returns (rows [r_new] pivot row ids, G [m, r_new] with G[rows] = I)."""
    q = torch.linalg.qr(C).Q                     # [m, min(m, r_r)]
    k = q.shape[1]
    if r_new <= k:
        qe = q[:, :r_new]
    else:
        # kick: random directions orthogonalised against q
        extra = noise[:, : r_new - k]
        extra = extra - q @ (q.T @ extra)
        qe = torch.linalg.qr(torch.cat([q, extra], dim=1)).Q[:, :r_new]
    rows = _lu_rows(qe)[:r_new]                  # maxvol proxy
    return _maxvol_swaps(qe, rows, r_new, 3)


def _rank_estimate(C) -> np.ndarray:
    """Singular values of the fiber matrix, on the host (adaptive rank)."""
    return torch.linalg.svdvals(C).double().cpu().numpy()


def _choose_rank(s, eps: float, kick: int, rmax: int, m: int) -> int:
    s = np.asarray(s)
    smax = s[0] if s.size and s[0] > 0 else 1.0
    r_need = max(1, int(np.sum(s > eps * smax)))
    return int(min(r_need + kick, rmax, m))


# -------------------------------------------------------------- the cross loop


def _pad_tt(cores: list, rmax: int, dtype, device) -> TT:
    """Pack exact-shape cores [r_l, n, r_r] into the padded-R TT container
    on ``device``."""
    out = []
    ranks = [1]
    for c in cores:
        rl, n, rr = c.shape
        buf = torch.zeros((rmax, n, rmax), dtype=dtype, device=device)
        buf[:rl, :, :rr] = c.to(dtype)
        out.append(buf)
        ranks.append(rr)
    ranks[-1] = 1
    return TT(tuple(out), torch.as_tensor(ranks, dtype=torch.int32, device=device))


def default_sample_idx(shape: Sequence[int], seed: int) -> np.ndarray:
    """256 random nodes from ``np.random.default_rng(seed)`` (the convergence
    check's set)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, shape[j], size=256) for j in range(len(shape))], axis=-1)


def fiber_block(f: Callable, shape, dtype, device, idx_lists) -> torch.Tensor:
    """f at the multi-indices that concatenating ``idx_lists`` (broadcast
    numpy index blocks, last axis the dims) gives, as a tensor of their
    leading shape."""
    blocks = np.broadcast_shapes(*(a.shape[:-1] for a in idx_lists))
    idx = np.concatenate([np.broadcast_to(a, blocks + (a.shape[-1],)) for a in idx_lists],
                         axis=-1).reshape(-1, len(shape))
    vals = f(torch.as_tensor(idx, dtype=torch.int64, device=device))
    return torch.as_tensor(vals, dtype=dtype, device=device).reshape(blocks)


def tt_cross(
    f: Callable,
    shape: Sequence[int],
    rmax: int,
    seed: int | Sequence[int] = 0,
    state: CrossState | None = None,
    r0: int = 3,
    kick: int = 2,
    tol: float = 1e-4,
    eps_rank: float = 1e-6,
    max_sweeps: int = 6,
    sample_idx=None,
    dtype=torch.float32,
    verbose: bool = False,
    device=None,
) -> CrossResult:
    """Cross-approximate ``f(idx [B, d] int64 tensor) -> [B]`` as a padded TT
    on ``device`` (None: the default CUDA device).

    Convergence: the relative sup-change of the TT surrogate on a random
    sample set between sweeps < tol. Pass ``state`` to warm-start (VI reuses
    it; the state is updated in place and returned). ``seed``: an int draws
    the seeds of the first index sets and of the kick noise from
    ``np.random.default_rng(seed)``; a pair gives them (JAX's keys k0, k1
    as ``randint(k, (), 0, 2**31 - 1)``).
    """
    device = resolve_device(device)
    d = len(shape)
    next_seed = seed_stream(seed, 2)
    state_seed, noise_seed = next_seed(), next_seed()
    if state is None:
        state = init_cross_state(state_seed, shape, r0)
    if sample_idx is None:
        sample_idx = default_sample_idx(shape, 12345)
    sample_t = torch.as_tensor(np.asarray(sample_idx), dtype=torch.int64, device=device)
    rng = np.random.default_rng(noise_seed)

    n_evals = 0
    prev_sample = None
    errors = []
    converged = False

    def eval_block(I, j_dim, J):
        """f on I x grid_j x J -> C [len(I) n_j, len(J)]."""
        nonlocal n_evals
        rl, rr, n = I.shape[0], J.shape[0], shape[j_dim]
        C = fiber_block(f, shape, dtype, device,
                        [I[:, None, None, :], np.arange(n)[None, :, None, None],
                         J[None, None, :, :]])
        n_evals += C.numel()
        return C.reshape(rl * n, rr)

    def noise(m):
        return torch.as_tensor(rng.standard_normal((m, max(kick, 1))), dtype=dtype,
                               device=device)

    cores = [None] * d
    for sweep in range(max_sweeps):
        # ---------------- left-to-right: rebuild left sets + cores ----------
        for k in range(d - 1):
            I, J = state.left[k], state.right[k + 1]
            n = shape[k]
            C = eval_block(I, k, J)                               # [rl n, rr]
            r_new = _choose_rank(_rank_estimate(C), eps_rank, kick, rmax, I.shape[0] * n)
            rows, G = _select_and_core(C, noise(I.shape[0] * n), r_new)
            rows = rows.cpu().numpy()
            a, i = rows // n, rows % n                            # row = a n + i
            state.left[k + 1] = np.concatenate([I[a], i[:, None]], axis=-1)
            cores[k] = G.reshape(I.shape[0], n, r_new)
        # final core: plain evaluation (interpolation exact at pivots)
        I = state.left[d - 1]
        C = eval_block(I, d - 1, state.right[d])
        cores[d - 1] = C.reshape(I.shape[0], shape[d - 1], 1)

        # convergence check on the sample set
        cur = tt_gather_eval(_pad_tt(cores, rmax, dtype, device), sample_t)
        if prev_sample is not None:
            denom = float(torch.max(torch.abs(cur))) + 1e-12
            err = float(torch.max(torch.abs(cur - prev_sample))) / denom
            errors.append(err)
            if verbose:
                print(f"[cross] sweep={sweep} err={err:.3e} ranks={[c.shape[2] for c in cores]}")
            if err < tol:
                converged = True
                break
        prev_sample = cur

        # ---------------- right-to-left: rebuild right sets -----------------
        for k in range(d - 1, 0, -1):
            I, J = state.left[k], state.right[k + 1]
            rl, n, rr = I.shape[0], shape[k], J.shape[0]
            Ct = eval_block(I, k, J).reshape(rl, n * rr).T        # [n rr, rl]
            r_new = _choose_rank(_rank_estimate(Ct), eps_rank, kick, rmax, n * rr)
            rows, G = _select_and_core(Ct, noise(n * rr), r_new)
            rows = rows.cpu().numpy()
            i, b = rows // rr, rows % rr
            state.right[k] = np.concatenate([i[:, None], J[b]], axis=-1)
            cores[k] = G.T.reshape(r_new, n, rr)
        # first core after R2L: exact evaluation
        J = state.right[1]
        C = eval_block(state.left[0], 0, J)
        cores[0] = C.reshape(1, shape[0], J.shape[0])

    tt = _pad_tt(cores, rmax, dtype, device)
    return CrossResult(tt=tt, state=state, n_evals=n_evals, sweeps=sweep + 1,
                       converged=converged, errors=errors)
