"""Tensor-train (function-train) algebra with padded static ranks — port of
``c3sc_tpu/ops/tt.py``.

With the linear-element class on a fixed grid the continuous function train
is exactly a discrete TT on the grid nodes plus multilinear interpolation
between them. Every core is padded to one static R: ``cores[k]: [R, n_k, R]``
with the **invariant that padded entries are exactly zero** outside the
active ``ranks[k] x n_k x ranks[k+1]`` block (``ranks[0] == ranks[d] == 1``).
Zero padding makes evaluation, contraction and addition correct with no
masking at all; rounding restores the invariant by masking truncated
directions instead of changing shapes. On the GPU the same padding keeps
every launch of a rank-adaptive solve at one shape, so nothing in it depends
on a rank read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device


class TT(NamedTuple):
    """Padded tensor train. cores[k]: [R, n_k, R]; ranks: [d+1] int32, on
    the cores' device."""

    cores: tuple
    ranks: torch.Tensor

    @property
    def ndim(self) -> int:
        return len(self.cores)

    @property
    def rmax(self) -> int:
        return self.cores[0].shape[0]

    @property
    def shape(self) -> tuple:
        return tuple(c.shape[1] for c in self.cores)


def _ones_ranks(d: int, device) -> torch.Tensor:
    return torch.ones(d + 1, dtype=torch.int32, device=device)


def _rank_mask(R: int, r_left, r_right, dtype, device=None):
    """[R, 1, R] mask selecting the active block (ranks: ints or 0-d tensors)."""
    if device is None:
        device = r_left.device if isinstance(r_left, torch.Tensor) else None
    ar = torch.arange(R, device=device)
    rows = (ar < r_left).to(dtype)[:, None, None]
    cols = (ar < r_right).to(dtype)[None, None, :]
    return rows * cols


def mask_cores(tt: TT) -> TT:
    """Re-zero the padded region (restores the invariant after raw edits)."""
    new = []
    for k, c in enumerate(tt.cores):
        m = _rank_mask(tt.rmax, tt.ranks[k], tt.ranks[k + 1], c.dtype, c.device)
        new.append(c * m)
    return TT(tuple(new), tt.ranks)


# ---------------------------------------------------------------- constructors


def tt_zeros(shape: Sequence[int], rmax: int, dtype=torch.float32, device=None) -> TT:
    device = resolve_device(device)
    cores = tuple(torch.zeros((rmax, n, rmax), dtype=dtype, device=device) for n in shape)
    return TT(cores, _ones_ranks(len(shape), device))


def tt_constant(shape: Sequence[int], value, rmax: int, dtype=torch.float32,
                device=None) -> TT:
    """TT of the constant tensor `value` (rank-1)."""
    device = resolve_device(device)
    cores = []
    for k, n in enumerate(shape):
        c = torch.zeros((rmax, n, rmax), dtype=dtype, device=device)
        c[0, :, 0] = value if k == 0 else 1.0
        cores.append(c)
    return TT(tuple(cores), _ones_ranks(len(shape), device))


def tt_rank1(factors: Sequence[torch.Tensor], rmax: int) -> TT:
    """TT of the rank-1 tensor prod_k factors[k], factors[k]: [n_k] (on the
    factors' device)."""
    cores = []
    for f in factors:
        c = torch.zeros((rmax, f.shape[0], rmax), dtype=f.dtype, device=f.device)
        c[0, :, 0] = f
        cores.append(c)
    return TT(tuple(cores), _ones_ranks(len(factors), factors[0].device))


def tt_random(generator: torch.Generator, shape: Sequence[int], ranks: Sequence[int],
              rmax: int, dtype=torch.float32, device=None) -> TT:
    """Random TT with the given (unpadded) ranks, padded to rmax. Drawn from
    ``generator`` on the generator's own device, then moved to ``device``."""
    device = resolve_device(device)
    d = len(shape)
    rk = [1] + [min(int(r), rmax) for r in ranks] + [1] if len(ranks) == d - 1 else list(ranks)
    assert len(rk) == d + 1 and rk[0] == rk[-1] == 1
    cores = []
    for k, n in enumerate(shape):
        c = torch.zeros((rmax, n, rmax), dtype=dtype, device=device)
        blk = torch.randn((rk[k], n, rk[k + 1]), generator=generator, dtype=dtype,
                          device=generator.device) / np.sqrt(rmax)
        c[: rk[k], :, : rk[k + 1]] = blk.to(device)
        cores.append(c)
    return TT(tuple(cores), torch.as_tensor(rk, dtype=torch.int32, device=device))


def tt_from_dense(a, rmax: int, tol: float = 1e-6, device=None) -> TT:
    """TT-SVD of a small dense tensor (test/oracle use; the SVDs run in
    numpy on the host). ``device=None`` follows ``a`` when it is a tensor,
    else it is the default CUDA device."""
    if isinstance(a, torch.Tensor):
        device = a.device if device is None else torch.device(device)
        a = a.detach().cpu().numpy()
    else:
        device = resolve_device(device)
        a = np.asarray(a)
    shape, d, dtype = a.shape, a.ndim, a.dtype
    cores = []
    ranks = [1]
    m = a.reshape(1 * shape[0], -1)
    r_prev = 1
    for k in range(d - 1):
        m = m.reshape(r_prev * shape[k], -1)
        u, s, vt = np.linalg.svd(m, full_matrices=False)
        smax = s[0] if s.size and s[0] > 0 else 1.0
        keep = max(1, int(np.sum(s > tol * smax)))
        keep = min(keep, rmax)
        u, s, vt = u[:, :keep], s[:keep], vt[:keep]
        core = np.zeros((rmax, shape[k], rmax), dtype)
        core[:r_prev, :, :keep] = u.reshape(r_prev, shape[k], keep)
        cores.append(torch.as_tensor(core, device=device))
        ranks.append(keep)
        m = s[:, None] * vt
        r_prev = keep
    core = np.zeros((rmax, shape[-1], rmax), dtype)
    core[:r_prev, :, 0] = m.reshape(r_prev, shape[-1])
    cores.append(torch.as_tensor(core, device=device))
    ranks.append(1)
    return TT(tuple(cores), torch.as_tensor(ranks, dtype=torch.int32, device=device))


# ------------------------------------------------------------------ evaluation


def _select_node(prod, j):
    """prod [B, n, R], j [B] -> prod[b, j[b], :] as [B, R]."""
    B, _, R = prod.shape
    return prod.gather(1, j.long()[:, None, None].expand(B, 1, R))[:, 0]


def tt_gather_eval(tt: TT, idx) -> torch.Tensor:
    """Evaluate at grid nodes. idx: [B, d] int -> [B].

    Matmul-then-select per core: ``v @ core-unfolding [R, n*R]`` (one dense
    matmul) followed by a select on the point's node index. The per-point
    core gather would materialise [R, B, R] slices — gigabytes at the 6D
    paddings; the unfolded matmul touches each core once and keeps the
    transient at [B, n, R].
    """
    idx = idx.long()
    B = idx.shape[0]
    v = tt.cores[0][0, idx[:, 0], :]  # [B, R]
    for k in range(1, tt.ndim):
        R_l, n, R_r = tt.cores[k].shape
        prod = (v @ tt.cores[k].reshape(R_l, n * R_r)).reshape(B, n, R_r)
        v = _select_node(prod, idx[:, k])
    return v[:, 0]


def tt_lerp_eval(tt: TT, grid, x) -> torch.Tensor:
    """Continuous (linear-element) evaluation at off-grid points x [B, d] ->
    [B]. Same matmul-then-select form as ``tt_gather_eval``: two selected
    node rows per dim, lerped."""
    cell, w = grid.state_to_cell(grid.wrap_state(x))
    B = x.shape[0]
    v = None
    for k in range(tt.ndim):
        nk = grid.shape[k]
        j0 = cell[:, k]
        j1 = torch.remainder(j0 + 1, nk) if grid.periodic[k] else torch.clamp(j0 + 1, 0, nk - 1)
        wk = w[:, k].to(tt.cores[k].dtype)
        R_l, _, R_r = tt.cores[k].shape
        if v is None:
            s0 = tt.cores[k][0, j0, :]  # [B, R]
            s1 = tt.cores[k][0, j1, :]
        else:
            prod = (v @ tt.cores[k].reshape(R_l, nk * R_r)).reshape(B, nk, R_r)
            s0 = _select_node(prod, j0)
            s1 = _select_node(prod, j1)
        v = s0 * (1 - wk)[:, None] + s1 * wk[:, None]
    return v[:, 0]


def tt_full(tt: TT) -> torch.Tensor:
    """Densify (small tensors / tests only)."""
    out = tt.cores[0][:1]  # [1, n0, R]
    for k in range(1, tt.ndim):
        out = torch.einsum("...r,rns->...ns", out, tt.cores[k])
    return out[0, ..., 0]


# ------------------------------------------------------------------ arithmetic


def tt_scale(tt: TT, alpha) -> TT:
    cores = (tt.cores[0] * alpha,) + tuple(tt.cores[1:])
    return TT(cores, tt.ranks)


def _concrete_ranks(tt: TT) -> np.ndarray:
    """Ranks as a numpy array: one host read (never called inside a solve's
    iteration)."""
    return tt.ranks.detach().cpu().numpy().astype(np.int64)


def _repad(tt: TT, R_new: int) -> TT:
    """Re-pad a TT to a different static padding (active block must fit)."""
    cores = []
    for c in tt.cores:
        R_old, n, _ = c.shape
        if R_new >= R_old:
            out = torch.zeros((R_new, n, R_new), dtype=c.dtype, device=c.device)
            out[:R_old, :, :R_old] = c
        else:
            out = c[:R_new, :, :R_new].contiguous()
        cores.append(out)
    return TT(tuple(cores), tt.ranks)


def _shift_cols(core, shift):
    """Shift the last axis of [R, n, R] by `shift` (a 0-d tensor), zero-fill."""
    R = core.shape[-1]
    src = torch.arange(R, device=core.device) - shift
    gathered = core[:, :, torch.clamp(src, 0, R - 1)]
    return torch.where((src >= 0)[None, None, :], gathered, torch.zeros_like(gathered))


def _shift_rows(core, shift):
    R = core.shape[0]
    src = torch.arange(R, device=core.device) - shift
    gathered = core[torch.clamp(src, 0, R - 1), :, :]
    return torch.where((src >= 0)[:, None, None], gathered, torch.zeros_like(gathered))


def _tt_add_raw(a: TT, b: TT, R: int) -> TT:
    """Block-diagonal sum at static padding R (exact iff ranks fit)."""
    d = a.ndim
    dev = a.cores[0].device
    one = torch.ones((), dtype=torch.int32, device=dev)
    cores = []
    ranks = [one]
    for k in range(d):
        ca, cb = a.cores[k], b.cores[k]
        n = ca.shape[1]
        ra_l, ra_r = a.ranks[k], a.ranks[k + 1]
        rb_r = b.ranks[k + 1]
        out = torch.zeros((R, n, R), dtype=ca.dtype, device=dev)
        out[: ca.shape[0], :, : ca.shape[2]] = ca
        pb = torch.zeros((R, n, R), dtype=cb.dtype, device=dev)
        pb[: cb.shape[0], :, : cb.shape[2]] = cb
        if k == 0:
            # row vector concat: [1, n, ra_r + rb_r]
            out = out + _shift_cols(pb, ra_r)
            ranks.append(ra_r + rb_r)
        elif k == d - 1:
            out = out + _shift_rows(pb, ra_l)
            ranks.append(one)
        else:
            out = out + _shift_rows(_shift_cols(pb, ra_r), ra_l)
            ranks.append(ra_r + rb_r)
        cores.append(out)
    ranks = torch.stack([r.to(torch.int32) for r in ranks])
    return TT(tuple(cores), torch.clamp(ranks, max=R))


def tt_add(a: TT, b: TT, on_overflow: str = "round", round_tol: float = 1e-7) -> TT:
    """TT sum (block-diagonal core concatenation), overflow-safe.

    The combined active ranks ra+rb may exceed the static padding R:

    - the sum fits: exact path at R;
    - overflow + ``on_overflow='raise'``: ValueError;
    - overflow + ``on_overflow='round'`` (default): the sum is formed
      EXACTLY at padding 2R, TT-rounded to relative ``round_tol`` with rank
      cap R, and re-padded to R — a best approximation instead of silent
      corruption.

    Reads both rank vectors on the host (the JAX module's path for concrete
    ranks); not for use inside a solve's iteration.
    """
    if on_overflow not in ("round", "raise"):
        raise ValueError(f"on_overflow must be 'round' or 'raise', got {on_overflow!r}")
    R = a.rmax
    combined = _concrete_ranks(a) + _concrete_ranks(b)
    combined[0] = combined[-1] = 1
    if int(combined.max()) <= R:
        return _tt_add_raw(a, b, R)
    if on_overflow == "raise":
        raise ValueError(
            f"tt_add rank overflow: combined ranks {combined.tolist()} "
            f"exceed padding R={R}; pass on_overflow='round' or enlarge R"
        )
    wide = _tt_add_raw(a, b, 2 * R)
    return _repad(tt_round(wide, round_tol, R), R)


def tt_dot(a: TT, b: TT) -> torch.Tensor:
    """<A, B>, the inner product over all entries (a 0-d tensor)."""
    # first cores contribute only row 0 (r0 == 1): [n, R] x [n, R] -> [R, R]
    t = torch.einsum("nb,nd->bd", a.cores[0][0], b.cores[0][0])
    for k in range(1, a.ndim):
        t = torch.einsum("ac,anb,cnd->bd", t, a.cores[k], b.cores[k])
    return t[0, 0]


def tt_norm(tt: TT) -> torch.Tensor:
    return torch.sqrt(torch.clamp(tt_dot(tt, tt), min=0.0))


def _tt_mult_raw(a: TT, b: TT, R_out: int) -> TT:
    """Hadamard product packed into padding R_out (exact iff ra*rb fits)."""
    R = a.rmax
    dev = a.cores[0].device
    RR = torch.arange(R * R, device=dev)
    cores = []
    ranks = [torch.ones((), dtype=torch.int32, device=dev)]
    for k in range(a.ndim):
        ca, cb = a.cores[k], b.cores[k]
        n = ca.shape[1]
        # Kronecker per slice: out[(i1 i2), n, (j1 j2)] = ca[i1,n,j1] * cb[i2,n,j2]
        kron = torch.einsum("anb,cnd->acnbd", ca, cb).reshape(R * R, n, R * R)
        # compact the active block: active rows are (i1 < ra, i2 < rb) at
        # position i1*R+i2; gather them into the leading ra*rb rows
        rb_l = b.ranks[k]
        ra_r, rb_r = a.ranks[k + 1], b.ranks[k + 1]
        row_src = torch.clamp((RR // rb_l) * R + RR % rb_l, 0, R * R - 1)
        col_src = torch.clamp((RR // rb_r) * R + RR % rb_r, 0, R * R - 1)
        packed = kron[row_src][:, :, col_src]
        if R_out <= R * R:
            out = packed[:R_out, :, :R_out]
        else:
            out = torch.zeros((R_out, n, R_out), dtype=ca.dtype, device=dev)
            out[: R * R, :, : R * R] = packed
        cores.append(out)
        ranks.append(torch.clamp(ra_r * rb_r, max=R_out).to(torch.int32))
    return mask_cores(TT(tuple(cores), torch.stack(ranks)))


def tt_mult(a: TT, b: TT, on_overflow: str = "round", round_tol: float = 1e-7) -> TT:
    """Elementwise (Hadamard) product; representation ranks multiply.

    Reference: ``function_train_mult`` (C3 ``src/lib_clinalg/ft.c``). The
    product ranks ra*rb can exceed the static padding R:

    - ra*rb <= R everywhere: exact path at R;
    - overflow + ``on_overflow='raise'``: ValueError;
    - overflow + ``on_overflow='round'`` (default): the product is formed
      EXACTLY at padding max_k(ra_k*rb_k), TT-rounded to relative
      ``round_tol`` with rank cap R and re-padded to R.

    Reads both rank vectors on the host (the JAX module's path for concrete
    ranks); not for use inside a solve's iteration.
    """
    if on_overflow not in ("round", "raise"):
        raise ValueError(f"on_overflow must be 'round' or 'raise', got {on_overflow!r}")
    R = a.rmax
    combined = _concrete_ranks(a) * _concrete_ranks(b)
    if int(combined.max()) <= R:
        return _tt_mult_raw(a, b, R)
    if on_overflow == "raise":
        raise ValueError(
            f"tt_mult rank overflow: product ranks {combined.tolist()} "
            f"exceed padding R={R}; pass on_overflow='round' or enlarge R"
        )
    wide = _tt_mult_raw(a, b, int(combined.max()))
    return _repad(tt_round(wide, round_tol, R), R)


def tt_integrate(tt: TT, grid=None, weights: Sequence | None = None) -> torch.Tensor:
    """Integral of the (multilinear-interpolated) TT over the grid box.

    Reference: ``function_train_integrate`` (C3 ``src/lib_clinalg/ft.c`` +
    ``lib_quadrature``). With the linelm class the exact integral is the
    trapezoid rule over the nodes; periodic dims use uniform weights (the
    rectangle rule over the circle). Explicit per-dim ``weights`` override;
    with neither, every weight is 1 (the sum of the entries).
    """
    v = None
    for k, core in enumerate(tt.cores):
        n = core.shape[1]
        if weights is not None:
            w = np.asarray(weights[k], np.float64)
        elif grid is not None:
            if grid.periodic[k]:
                w = np.full(n, float(grid.h[k]))
            elif grid.uniform:
                w = np.full(n, float(grid.h[k]))
                w[0] *= 0.5
                w[n - 1] *= 0.5
            elif n == 1:
                w = np.ones(1)    # a single-node dim: np.diff is empty
            else:
                # trapezoid weights on arbitrary nodes: w_i = (gap_l + gap_r) / 2
                gaps = np.diff(grid.nodes(k))
                w = np.concatenate([gaps[:1] * 0.5, 0.5 * (gaps[1:] + gaps[:-1]),
                                    gaps[-1:] * 0.5])
        else:
            w = np.ones(n)
        # the weights in float32 first, as the JAX module holds them
        wt = torch.as_tensor(w.astype(np.float32), dtype=core.dtype, device=core.device)
        m = torch.einsum("rns,n->rs", core, wt)
        v = m[0] if v is None else v @ m
    return v[0]


def tt_refine_grid(tt: TT, grid_coarse, grid_fine) -> TT:
    """Prolong a TT from a coarse grid to a finer one, exactly for the
    linear-element class: each core's node slices are lerped in 1-D onto the
    fine nodes (ranks unchanged). Coarse dims may be non-uniform (the
    layer-keeping coarse grids of ``solvers/twogrid.py``)."""
    assert tt.ndim == grid_coarse.ndim == grid_fine.ndim
    cores = []
    for k in range(tt.ndim):
        xf = np.asarray(grid_fine.nodes(k))
        nc = grid_coarse.shape[k]
        if grid_coarse.uniform or grid_coarse.periodic[k]:
            hc = float(grid_coarse.h[k])
            t = (xf - grid_coarse.lb[k]) / hc
            cell = np.floor(t).astype(np.int64)
            hi = nc - 1 if grid_coarse.periodic[k] else nc - 2
            cell = np.clip(cell, 0, max(hi, 0))
            w = np.clip(t - cell, 0.0, 1.0)
            j1 = np.mod(cell + 1, nc) if grid_coarse.periodic[k] else np.clip(cell + 1, 0, nc - 1)
        else:
            xc = np.asarray(grid_coarse.nodes(k))
            cell = np.clip(np.searchsorted(xc, xf, side="right") - 1, 0, nc - 2)
            w = np.clip((xf - xc[cell]) / (xc[cell + 1] - xc[cell]), 0.0, 1.0)
            j1 = cell + 1
        c = tt.cores[k]
        cell = torch.as_tensor(cell, dtype=torch.int64, device=c.device)
        j1 = torch.as_tensor(j1, dtype=torch.int64, device=c.device)
        w = torch.as_tensor(w, dtype=c.dtype, device=c.device)
        cores.append(c[:, cell, :] * (1 - w)[None, :, None] + c[:, j1, :] * w[None, :, None])
    return TT(tuple(cores), tt.ranks)


# -------------------------------------------------------------------- rounding


def tt_round(tt: TT, tol: float, rmax_new: int | None = None) -> TT:
    """SVD re-compression to relative accuracy `tol` (Frobenius), keeping
    static padded shapes (Oseledets TT-rounding).

    Left-to-right QR orthogonalisation, then right-to-left SVD truncation;
    truncated directions are *masked to zero* and the ranks tensor updated —
    no shape change. (``torch.linalg.svd`` checks ``info`` on the host; this
    is not for use inside a solve's iteration.)
    """
    d = tt.ndim
    R = tt.rmax
    dev = tt.cores[0].device
    cap = R if rmax_new is None else min(rmax_new, R)
    cores = list(tt.cores)
    # --- left-to-right QR sweep ---
    for k in range(d - 1):
        c = cores[k]  # [R, n, R]
        n = c.shape[1]
        q, r = torch.linalg.qr(c.reshape(R * n, R))  # q [R*n, R], r [R, R]
        cores[k] = q.reshape(R, n, R)
        cores[k + 1] = torch.einsum("ij,jns->ins", r, cores[k + 1])
    # after the sweep the tensor = orthogonal cores with all mass in the last
    nrm = torch.linalg.norm(cores[-1])
    thresh = tol * nrm / np.sqrt(max(d - 1, 1))
    one = torch.ones((), dtype=torch.int32, device=dev)
    new_ranks = [one] * (d + 1)
    ar = torch.arange(R, device=dev)
    # --- right-to-left SVD truncation sweep ---
    for k in range(d - 1, 0, -1):
        c = cores[k]  # [R, n, R]
        n = c.shape[1]
        u, s, vt = torch.linalg.svd(c.reshape(R, n * R), full_matrices=False)
        keep = (s > thresh) & (ar < cap)
        keep = keep | (ar == 0)  # rank >= 1
        mask = keep.to(c.dtype)
        cores[k] = (mask[:, None] * vt).reshape(R, n, R)
        carry = u * (mask * s)[None, :]  # [R, R] columns masked
        cores[k - 1] = torch.einsum("ins,sj->inj", cores[k - 1], carry)
        new_ranks[k] = keep.sum().to(torch.int32)
    return mask_cores(TT(tuple(cores), torch.stack(new_ranks)))


# ------------------------------------------------------------------------- i/o


def tt_save(tt: TT, path: str) -> None:
    """Serialize as one npz with the JAX package's keys (``core_k``, ``ranks``)."""
    arrays = {f"core_{k}": c.detach().cpu().numpy() for k, c in enumerate(tt.cores)}
    arrays["ranks"] = tt.ranks.detach().cpu().numpy().astype(np.int32)
    np.savez(path, **arrays)


def tt_load(path: str, device=None) -> TT:
    """Read a TT saved by either package onto ``device`` (None: the default
    CUDA device)."""
    device = resolve_device(device)
    with np.load(path) as data:
        d = len([k for k in data.files if k.startswith("core_")])
        cores = tuple(torch.as_tensor(data[f"core_{k}"], device=device) for k in range(d))
        ranks = torch.as_tensor(np.asarray(data["ranks"], np.int32), device=device)
    return TT(cores, ranks)
