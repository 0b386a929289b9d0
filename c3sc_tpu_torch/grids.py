"""Tensor-product state grids — uniform or per-dim arbitrary node sets.

Port of ``c3sc_tpu/grids.py``. The static description (bounds, shape,
periodic flags, node sets, spacings) stays numpy; the vectorised queries
(``index_to_state``, ``state_to_cell``, ``local_h``, ``wrap_state``,
``neighbor_index``) take torch tensors of any leading shape and return
tensors on the same device.

Non-uniform dims must be bounded (periodic + non-uniform is not supported).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from c3sc_tpu_torch.device import const_tensor, resolve_device


def float_mod(x, y):
    """Floating remainder with the sign of ``y`` — ``fmod`` plus the same
    correction ``jnp.mod`` applies, so wrapped states agree bit for bit
    with the JAX package."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


@dataclasses.dataclass(frozen=True)
class Grid:
    """A tensor-product grid over a box [lb, ub].

    For periodic dimensions the nodes cover [lb, ub) — node n would alias
    node 0 — matching the reference's convention for angle dimensions.

    Attributes:
      lb, ub: per-dim bounds, shape (d,) (python tuples — static).
      shape:  per-dim node counts (n_1, ..., n_d) (static).
      periodic: per-dim bool, True where the dimension wraps.
      nodes_override: optional per-dim tuples of node positions (sorted,
        first == lb, last == ub). None => uniform.
    """

    lb: tuple[float, ...]
    ub: tuple[float, ...]
    shape: tuple[int, ...]
    periodic: tuple[bool, ...]
    nodes_override: tuple[tuple[float, ...], ...] | None = None

    @staticmethod
    def create(
        lb: Sequence[float],
        ub: Sequence[float],
        shape: Sequence[int],
        periodic: Sequence[bool] | None = None,
        nodes: Sequence[Sequence[float]] | None = None,
    ) -> "Grid":
        d = len(shape)
        if periodic is None:
            periodic = (False,) * d
        if not len(lb) == len(ub) == len(periodic) == d:
            raise ValueError("lb, ub, periodic and shape must have one entry per dim")
        override = None
        if nodes is not None:
            override = tuple(tuple(map(float, nk)) for nk in nodes)
            for k, nk in enumerate(override):
                if len(nk) != shape[k]:
                    raise ValueError(f"dim {k}: {len(nk)} nodes for shape {shape[k]}")
                if not all(a < b for a, b in zip(nk, nk[1:])):
                    raise ValueError(f"dim {k}: nodes must be strictly increasing")
                if periodic[k]:
                    # a periodic dim accepts only its canonical uniform node
                    # set, so mixed grids can carry one override tuple
                    if not np.allclose(nk, _canonical_nodes(lb[k], ub[k], shape[k], True),
                                       atol=1e-9):
                        raise ValueError("periodic dims must carry the uniform node set")
                elif abs(nk[0] - lb[k]) >= 1e-9 or abs(nk[-1] - ub[k]) >= 1e-9:
                    raise ValueError(f"dim {k}: nodes must span [lb, ub]")
            # drop the override only when every dim is EXACTLY its canonical
            # uniform node set: a tolerance would silently swap the stencil
            # of a deliberately near-uniform grid
            if all(np.array_equal(np.asarray(nk),
                                  _canonical_nodes(lb[k], ub[k], shape[k], periodic[k]))
                   for k, nk in enumerate(override)):
                override = None
        return Grid(tuple(map(float, lb)), tuple(map(float, ub)),
                    tuple(map(int, shape)), tuple(map(bool, periodic)), override)

    @staticmethod
    def create_nonuniform(nodes: Sequence[Sequence[float]],
                          periodic: Sequence[bool] | None = None) -> "Grid":
        """Grid from explicit per-dim node arrays (bounds derived)."""
        lb = [float(nk[0]) for nk in nodes]
        ub = [float(nk[-1]) for nk in nodes]
        shape = [len(nk) for nk in nodes]
        return Grid.create(lb, ub, shape, periodic, nodes=nodes)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def uniform(self) -> bool:
        return self.nodes_override is None

    @property
    def h(self) -> np.ndarray:
        """Per-dim reference spacing (static numpy): the exact spacing on
        uniform dims, the mean spacing on non-uniform ones (stencil and
        policy code use ``local_h``/``node_h`` there)."""
        out = np.empty(self.ndim)
        for k in range(self.ndim):
            n = self.shape[k]
            span = self.ub[k] - self.lb[k]
            out[k] = span / n if self.periodic[k] else span / max(n - 1, 1)
        return out

    def nodes(self, k: int) -> np.ndarray:
        """The 1-D node array for dimension k (static numpy)."""
        if self.nodes_override is not None:
            return np.asarray(self.nodes_override[k])
        n = self.shape[k]
        if self.periodic[k]:
            # (arange * span) / n, not arange * (span / n) as in create():
            # the two round differently, and each mirrors the JAX package
            return self.lb[k] + np.arange(n) * (self.ub[k] - self.lb[k]) / n
        return np.linspace(self.lb[k], self.ub[k], n)

    def node_h(self, k: int):
        """Static per-node spacing pair (h_plus [n], h_minus [n]) for dim k.

        h_plus[i] = nodes[i+1] - nodes[i] (last: previous gap);
        h_minus[i] = nodes[i] - nodes[i-1] (first: next gap). Periodic dims
        are uniform so both equal h[k] everywhere.
        """
        nk = self.nodes(k)
        if self.periodic[k] or len(nk) < 2:
            h = self.h[k]
            return np.full(len(nk), h), np.full(len(nk), h)
        gaps = np.diff(nk)
        return (np.concatenate([gaps, gaps[-1:]]),
                np.concatenate([gaps[:1], gaps]))

    def meshgrid(self) -> list[np.ndarray]:
        """Full dense meshgrid (numpy)."""
        return list(np.meshgrid(*[self.nodes(k) for k in range(self.ndim)], indexing="ij"))

    def node_states(self, device=None):
        """All node states [N, d] float32 in row-major (C) node order, built
        on ``device`` (None: the default CUDA device) from the per-dim node
        arrays (the values of ``meshgrid()``)."""
        device = resolve_device(device)
        axes = [torch.as_tensor(self.nodes(k), dtype=torch.float32, device=device)
                for k in range(self.ndim)]
        return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, self.ndim)

    def node_indices(self, device=None):
        """All node multi-indices [N, d] int64 in row-major node order, on
        ``device`` (None: the default CUDA device)."""
        device = resolve_device(device)
        axes = [torch.arange(n, device=device) for n in self.shape]
        return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, self.ndim)

    # ---- vectorised index <-> state ------------------------------------------

    def index_to_state(self, idx):
        """idx [..., d] int -> x [..., d] float32."""
        f32 = torch.float32
        if self.nodes_override is None:
            lb = const_tensor(self.lb, f32, idx.device)
            h = const_tensor(self.h, f32, idx.device)
            return lb + idx.to(f32) * h
        cols = [const_tensor(self.nodes(k), f32, idx.device)[idx[..., k]]
                for k in range(self.ndim)]
        return torch.stack(cols, dim=-1)

    def state_to_cell(self, x):
        """x [..., d] -> (cell [..., d] int64, w [..., d] in [0,1]) for lerp.

        cell k in [0, n_k-2] for bounded dims (clamped), [0, n_k-1] for
        periodic dims where the upper cell wraps to node 0.
        """
        dev = x.device
        if self.nodes_override is None:
            lb = const_tensor(self.lb, x.dtype, dev)
            h = const_tensor(self.h, x.dtype, dev)
            t = (x - lb) / h
            hi = const_tensor([n - 1 if p else n - 2
                               for n, p in zip(self.shape, self.periodic)], torch.int64, dev)
            cell = torch.minimum(torch.clamp(torch.floor(t).to(torch.int64), min=0), hi)
            w = t - cell.to(t.dtype)
            return cell, torch.clamp(w, 0.0, 1.0)
        cells, ws = [], []
        for k in range(self.ndim):
            nk = const_tensor(self.nodes(k), x.dtype, dev)
            xk = x[..., k].contiguous()
            c = torch.searchsorted(nk, xk, right=True) - 1
            c = torch.clamp(c, 0, self.shape[k] - 2)
            gap = nk[c + 1] - nk[c]
            cells.append(c)
            ws.append(torch.clamp((xk - nk[c]) / gap, 0.0, 1.0))
        return torch.stack(cells, -1), torch.stack(ws, -1)

    def local_h(self, x):
        """Per-point spacing to the up/down neighbour NODES:
        x [..., d] -> (h_plus [..., d], h_minus [..., d]).

        Defined at the nearest node to x per dim (exact at nodes). Uniform
        dims return the static h.
        """
        if self.nodes_override is None:
            h = const_tensor(self.h, x.dtype, x.device).expand(x.shape)
            return h, h
        hps, hms = [], []
        for k in range(self.ndim):
            nk = const_tensor(self.nodes(k), x.dtype, x.device)
            mid = 0.5 * (nk[1:] + nk[:-1])
            j = torch.clamp(torch.searchsorted(mid, x[..., k].contiguous()),
                            0, self.shape[k] - 1)
            hp_k, hm_k = self.node_h(k)
            hps.append(const_tensor(hp_k, x.dtype, x.device)[j])
            hms.append(const_tensor(hm_k, x.dtype, x.device)[j])
        return torch.stack(hps, -1), torch.stack(hms, -1)

    def wrap_state(self, x):
        """Wrap periodic coordinates of x into [lb, ub)."""
        lb = const_tensor(self.lb, x.dtype, x.device)
        ub = const_tensor(self.ub, x.dtype, x.device)
        wrapped = lb + float_mod(x - lb, ub - lb)
        per = const_tensor(self.periodic, torch.bool, x.device)
        return torch.where(per, wrapped, x)

    def neighbor_index(self, idx, dim: int, step: int):
        """Index of the +-1 neighbour of `idx` along `dim` under boundary
        rules: periodic dims wrap, bounded dims clamp. idx: [..., d] int."""
        n = self.shape[dim]
        j = idx[..., dim] + step
        j = torch.remainder(j, n) if self.periodic[dim] else torch.clamp(j, 0, n - 1)
        out = idx.clone()
        out[..., dim] = j
        return out


def _canonical_nodes(lb: float, ub: float, n: int, periodic: bool) -> np.ndarray:
    if periodic:
        return lb + np.arange(n) * ((ub - lb) / n)
    return np.linspace(lb, ub, n)
