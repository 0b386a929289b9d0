"""Plain PyTorch evaluation of value functions for the benchmark's
reference: multilinear interpolation of a dense value table, and a tensor
train evaluated at grid nodes and between them (linear elements). Imports
nothing of the program under test.
"""

from __future__ import annotations

import itertools

import torch

from benchmark.reference.bellman import UniformGrid
from benchmark.reference.precision import bmm


def cells(grid: UniformGrid, x):
    """x [B, d] -> (lower node [B, d] int64 in [0, n - 2], weight [B, d] in [0, 1])."""
    lb = torch.tensor(grid.lb, dtype=x.dtype, device=x.device)
    h = torch.tensor(grid.h, dtype=x.dtype, device=x.device)
    t = (x - lb) / h
    top = torch.tensor(grid.shape, device=x.device) - 2
    cell = torch.minimum(torch.clamp(torch.floor(t).long(), min=0), top)
    return cell, torch.clamp(t - cell.to(x.dtype), 0.0, 1.0)


def multilinear(grid: UniformGrid, v, x):
    """Dense flat value v [N] at points x [B, d], in x's dtype: the sum over
    the 2^d corners of the cell of the corner's weight times its value."""
    cell, w = cells(grid, x)
    v = v.to(x.dtype)
    out = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for corner in itertools.product((0, 1), repeat=grid.ndim):
        c = torch.tensor(corner, device=x.device)
        weight = torch.prod(torch.where(c.bool(), w, 1.0 - w), dim=-1)
        out += weight * v[grid.ravel(cell + c)]
    return out


def tt_at_nodes(cores, idx, dtype, tf32: bool = False):
    """Tensor train (cores [R, n_k, R], padded with zeros) at multi-indices
    idx [B, d]: [B], in ``dtype`` (with TF32 products where asked)."""
    v = cores[0][0, idx[:, 0], :].to(dtype)                      # [B, R]
    for k in range(1, len(cores)):
        ck = cores[k].to(dtype)[:, idx[:, k], :].permute(1, 0, 2)  # [B, R, R]
        v = bmm(v[:, None, :], ck, tf32)[:, 0]
    return v[:, 0]


def tt_between_nodes(grid: UniformGrid, cores, x, block=1 << 15, tf32: bool = False):
    """Tensor train at points x [B, d] with linear elements in every dim (the
    multilinear interpolant of the train's node values), in x's dtype (with
    TF32 products where asked)."""
    out = []
    for s in range(0, x.shape[0], block):
        xb = x[s:s + block]
        cell, w = cells(grid, xb)
        v = None
        for k, core in enumerate(cores):
            core = core.to(xb.dtype)
            wk = w[:, k, None, None]
            m = (1 - wk) * core[:, cell[:, k], :].permute(1, 0, 2) \
                + wk * core[:, cell[:, k] + 1, :].permute(1, 0, 2)     # [B, R, R]
            v = m[:, 0] if v is None else bmm(v[:, None, :], m, tf32)[:, 0]
        out.append(v[:, 0])
    return torch.cat(out)
