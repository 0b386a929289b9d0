"""Plain PyTorch fused tensor-train value iteration, followed from the
program's own state: the benchmark's reference for the fused solves.
Imports nothing of the program under test.

One iteration is a left-to-right and a right-to-left cross sweep over the
Bellman backup (``bellman.rhs`` minimised over the candidates, neighbour
values clamped to the value bounds and pinned on absorbing faces, the
result clamped and pinned). At core k the left-to-right sweep backs up the
value on the fiber block I_k x grid_k x J_(k+1) and fits the core that
interpolates the block through the pivot rows: with the block's active
columns C, the core is C C[rows]^-1 (whatever basis of C's columns the
program orthonormalises, the interpolating core is the same). The last core
holds its block's values. The right-to-left sweep does the same on the
train the first half left, from the last core down to core 1, and core 0
holds its block's values.

The pivot rows, the index sets I_k and J_k and the ranks are discrete
choices the program makes from its own rounding; the reference takes them
from the program's state after the iterations it follows, and checks that
each index set is the one its pivot rows name. It follows iterations in
which those choices held still and every fit used all active columns of a
block of full rank (``follow`` says which iterations it cannot follow).
"""

from __future__ import annotations

import torch

from benchmark.reference import bellman, interp
from benchmark.reference.quadcopter import Quadcopter

F64 = torch.float64


def backup(model: Quadcopter, grid: bellman.UniformGrid, uc, cores, idx, tf32: bool = False):
    """The fused backup of the train ``cores`` at multi-indices idx [B, d]: [B],
    in the cores' dtype."""
    d, dtype = grid.ndim, cores[0].dtype
    nb = bellman.neighbour_indices(grid, idx)                        # [B, 2, d, d]
    vn = interp.tt_at_nodes(cores, nb.reshape(-1, d), dtype, tf32).reshape(nb.shape[:3])
    lo, hi = model.value_bounds
    vn = torch.clamp(vn, lo, hi)
    vn = torch.where(bellman.terminal(model, grid, nb), model.exit_cost, vn)
    x = grid.state(idx, dtype)
    rhs = bellman.rhs(model, grid, x[None], vn[None, :, 0], vn[None, :, 1],
                      uc.to(dtype)[:, None])
    tv = torch.clamp(torch.min(rhs, dim=0).values, lo, hi)
    return torch.where(bellman.terminal(model, grid, idx), model.exit_cost, tv)


def block(grid, k, left_k, right_k1, R):
    """Multi-indices [R, n_k, R, d] of the fiber block of core k."""
    n, d = grid.shape[k], grid.ndim
    a = left_k[:, None, None, :k].expand(R, n, R, k)
    i = torch.arange(n, device=left_k.device)[None, :, None, None].expand(R, n, R, 1)
    b = right_k1[None, None, :, k + 1:].expand(R, n, R, d - k - 1)
    return torch.cat([a, i, b], dim=-1)


def interpolating(C, rows, r, rank_tol=None):
    """The core interpolating C [m, R] (its first r columns active) through
    rows[:r]: C[:, :r] C[rows, :r]^-1, zero-padded to R columns, formed as
    Q Q[rows]^-1 from an orthonormal basis Q of those columns.

    With ``rank_tol``: raises ``Unfollowable`` unless every singular value
    of C[:, :r] clears ``rank_tol`` times the largest by a tenth. Below it
    the program counts fewer needed directions than columns and puts its
    kick directions (random, orthogonalised against a basis that rounding
    completes) in the place of the last ones, which no reference repeats."""
    if rank_tol is not None:
        s = torch.linalg.svdvals(C[:, :r])
        if s[-1] <= 1.1 * rank_tol * s[0]:
            raise Unfollowable(f"a fiber block of rank below {r} at tolerance {rank_tol}")
    q = torch.linalg.qr(C[:, :r]).Q
    out = torch.zeros_like(C)
    out[:, :r] = torch.linalg.solve(q[rows[:r]].T, q.T).T
    return out


class Unfollowable(ValueError):
    """The program's state records choices the reference cannot follow."""


def follow(model: Quadcopter, grid: bellman.UniformGrid, uc, prev, state, iterations: int,
           dtype=F64, tf32: bool = False, rank_tol=None):
    """Cores [R, n_k, R] of ``iterations`` fused iterations from the program's
    state ``prev`` under the choices recorded in ``state`` (dicts of cores,
    left, right, rows_l, rows_r, rl, rr, as tensors), in ``dtype`` (float64
    for the reference; float32 with TF32 products for the control).

    Raises ``Unfollowable`` where the state's index sets are not the ones its
    pivot rows name, where the choices moved over more than one iteration,
    where a fit did not use all of its block's active columns, or (with
    ``rank_tol``, the program's rank tolerance) where a block's rank may
    have fallen below them (``interpolating``)."""
    d, R = grid.ndim, prev["cores"][0].shape[0]
    dev = prev["cores"][0].device
    uc = uc.to(dev, dtype)
    left, right = state["left"].to(dev), state["right"].to(dev)
    rows_l, rows_r = state["rows_l"].to(dev), state["rows_r"].to(dev)
    rl, rr = state["rl"].tolist(), state["rr"].tolist()
    rr_in = prev["rr"].tolist()
    right_in = prev["right"].to(dev)
    if iterations > 1 and any(not torch.equal(prev[k].to(dev), state[k].to(dev))
                              for k in ("left", "right", "rows_l", "rows_r", "rl", "rr")):
        raise Unfollowable("the index sets moved over the iterations followed")
    _check_sets(grid, left, right, rows_l, rows_r, rl, rr, R)
    cores = [c.to(dtype) for c in prev["cores"]]
    for it in range(iterations):
        if it > 0:
            right_in, rr_in = right, rr
        mid = list(cores)
        for k in range(d - 1):                                       # left to right
            n = grid.shape[k]
            if rl[k + 1] != rr_in[k + 1]:
                raise Unfollowable(f"core {k}: fit rank {rl[k + 1]} of {rr_in[k + 1]} columns")
            vals = backup(model, grid, uc, cores,
                          block(grid, k, left[k], right_in[k + 1], R).reshape(-1, d), tf32)
            C = _masked(vals.reshape(R * n, R), rl[k], n, rr_in[k + 1], rows_first=True)
            mid[k] = interpolating(C, rows_l[k], rl[k + 1], rank_tol).reshape(R, n, R)
        n = grid.shape[d - 1]
        vals = backup(model, grid, uc, cores, block(grid, d - 1, left[d - 1], right_in[d], R)
                      .reshape(-1, d), tf32).reshape(R, n, R)
        last = torch.zeros_like(vals)
        last[:rl[d - 1], :, 0] = vals[:rl[d - 1], :, 0]
        mid[d - 1] = last
        new = list(mid)
        for k in range(d - 1, 0, -1):                                # right to left
            n = grid.shape[k]
            if rr[k] != rl[k]:
                raise Unfollowable(f"core {k}: fit rank {rr[k]} of {rl[k]} columns")
            vals = backup(model, grid, uc, mid,
                          block(grid, k, left[k], right[k + 1], R).reshape(-1, d), tf32)
            M = vals.reshape(R, n, R).permute(1, 2, 0).reshape(n * R, R)
            M = _masked(M, rr[k + 1], n, rl[k], rows_first=False)
            new[k] = interpolating(M, rows_r[k], rr[k], rank_tol).reshape(n, R, R) \
                .permute(2, 0, 1)
        n = grid.shape[0]
        vals = backup(model, grid, uc, mid, block(grid, 0, left[0], right[1], R)
                      .reshape(-1, d), tf32).reshape(R, n, R)
        first = torch.zeros_like(vals)
        first[0, :, :rr[1]] = vals[0, :, :rr[1]]
        new[0] = first
        cores = new
    return cores


def _masked(M, r_rows, n, r_cols, rows_first: bool):
    """Zero the inactive rows and columns of a block's unfolding [m, R]: rows
    (a, i) with a >= r_rows (``rows_first``) or (i, b) with b >= r_rows, and
    columns >= r_cols."""
    R = M.shape[1]
    ar = torch.arange(R, device=M.device)
    live = (ar < r_rows)
    rowmask = live[:, None].expand(R, n) if rows_first else live[None, :].expand(n, R)
    return M * rowmask.reshape(-1, 1).to(M.dtype) * (ar < r_cols).to(M.dtype)[None, :]


def _check_sets(grid, left, right, rows_l, rows_r, rl, rr, R):
    """Each index set is the one the pivot rows of its core name: left
    [k + 1][c] = (left[k][a][:k], i) for row (a, i) = rows_l[k][c], and
    right[k][c] = (i, right[k + 1][b][k + 1:]) for row (i, b) = rows_r[k][c]."""
    d = grid.ndim
    for k in range(d - 1):
        n, r = grid.shape[k], rl[k + 1]
        a, i = rows_l[k][:r] // n, rows_l[k][:r] % n
        want = torch.cat([left[k][a][:, :k], i[:, None]], dim=1)
        if not torch.equal(left[k + 1][:r, :k + 1], want):
            raise Unfollowable(f"left index set {k + 1} is not the one its pivot rows name")
    for k in range(d - 1, 0, -1):
        r = rr[k]
        i, b = rows_r[k][:r] // R, rows_r[k][:r] % R
        want = torch.cat([i[:, None], right[k + 1][b][:, k + 1:]], dim=1)
        if not torch.equal(right[k][:r, k:], want):
            raise Unfollowable(f"right index set {k} is not the one its pivot rows name")
