"""Plain PyTorch Bellman operator of the Kushner-Dupuis Markov chain
approximation on a uniform tensor-product grid: the benchmark's reference
for the dense and the tensor-train solves. It imports nothing of the
program under test.

On a grid of spacing h, at a node x under control u with drift f and
diffusion variances s2 (one per dim):

    a_j = s2_j / (2 h_j^2),   Q = sum_j (2 a_j + |f_j| / h_j) + 1e-10
    p+_j = (a_j + max(f_j, 0) / h_j) / Q,   p-_j = (a_j + max(-f_j, 0) / h_j) / Q
    dt = 1 / Q,   rhs(u) = g(x, u) dt + exp(-beta dt) sum_j (p+_j v+_j + p-_j v-_j)

and (T v)(x) = min_u rhs(u). Neighbours past a face are the face node
itself; nodes on an absorbing face hold the exit cost. Everything is
computed in the dtype the caller passes (float64 for the reference, a lower
precision for the control), in blocks of nodes so that it fits.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference.quadcopter import ABSORB, Quadcopter

EPS = 1e-10


@dataclasses.dataclass(frozen=True)
class UniformGrid:
    lb: tuple
    ub: tuple
    shape: tuple

    @staticmethod
    def of(model: Quadcopter, n) -> "UniformGrid":
        shape = (int(n),) * model.dx if isinstance(n, int) else tuple(int(m) for m in n)
        return UniformGrid(tuple(model.lb), tuple(model.ub), shape)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return math.prod(self.shape)

    @property
    def h(self):
        return tuple((u - l) / (n - 1) for l, u, n in zip(self.lb, self.ub, self.shape))

    @property
    def strides(self):
        out, s = [], 1
        for n in reversed(self.shape):
            out.append(s)
            s *= n
        return tuple(reversed(out))

    def unravel(self, flat):
        """Flat node numbers [B] (row-major) -> multi-indices [B, d]."""
        return torch.stack([(flat // s) % n for s, n in zip(self.strides, self.shape)], dim=-1)

    def ravel(self, idx):
        return sum(idx[..., k] * s for k, s in enumerate(self.strides))

    def state(self, idx, dtype):
        lb = torch.tensor(self.lb, dtype=dtype, device=idx.device)
        h = torch.tensor(self.h, dtype=dtype, device=idx.device)
        return lb + idx.to(dtype) * h


def terminal(model: Quadcopter, grid: UniformGrid, idx):
    """Nodes on an absorbing face: [B] bool."""
    mask = torch.zeros(idx.shape[:-1], dtype=torch.bool, device=idx.device)
    for k, kind in enumerate(model.boundary):
        if kind == ABSORB:
            mask |= (idx[..., k] == 0) | (idx[..., k] == grid.shape[k] - 1)
    return mask


def neighbour_indices(grid: UniformGrid, idx):
    """The 2d neighbours of each node, clamped at the faces: [B, 2, d, d]
    (sign +1 first, then the dim moved, then the multi-index)."""
    d = grid.ndim
    hi = torch.tensor(grid.shape, device=idx.device) - 1
    out = []
    for sign in (1, -1):
        rows = []
        for j in range(d):
            nb = idx.clone()
            nb[:, j] = torch.clamp(nb[:, j] + sign, min=0)
            nb[:, j] = torch.minimum(nb[:, j], hi[j])
            rows.append(nb)
        out.append(torch.stack(rows, dim=1))
    return torch.stack(out, dim=1)


def rhs(model: Quadcopter, grid: UniformGrid, x, vp, vm, u):
    """rhs of controls u [..., du] at states x [..., d] against neighbour
    values vp, vm [..., d]; leading axes broadcast (x[None] against
    candidates uc[:, None] gives [C, B]). Computed in x's dtype."""
    h = torch.tensor(grid.h, dtype=x.dtype, device=x.device)
    f = model.drift(x, u)
    a = 0.5 * model.sigma2(x) / (h * h)
    Q = torch.sum(2.0 * a + torch.abs(f) / h, dim=-1) + EPS
    num = (a + torch.clamp(f, min=0) / h) * vp + (a + torch.clamp(-f, min=0) / h) * vm
    dt = 1.0 / Q
    return model.stage_cost(x, u) * dt + torch.exp(-model.beta * dt) * (torch.sum(num, -1) / Q)


def dense_sweep(model: Quadcopter, grid: UniformGrid, v, uc, policy=None, block=1 << 18):
    """One sweep of the dense operator on the flat value v [N] (its dtype):
    the improve (min over the candidates uc [C, du]) when ``policy`` is None,
    else the evaluate under candidate indices ``policy [N]``. Neighbours are
    read from v unpinned; the result is pinned on absorbing faces. Returns
    (v_new [N], argmin [N] or the policy)."""
    N = grid.size
    out = torch.empty_like(v)
    best_all = torch.empty(N, dtype=torch.int64, device=v.device) if policy is None else policy
    for s in range(0, N, block):
        flat = torch.arange(s, min(N, s + block), device=v.device)
        idx = grid.unravel(flat)
        x = grid.state(idx, v.dtype)
        nb = grid.ravel(neighbour_indices(grid, idx))              # [B, 2, d]
        vp, vm = v[nb[:, 0]], v[nb[:, 1]]
        if policy is None:
            val, best = torch.min(rhs(model, grid, x[None], vp[None], vm[None], uc[:, None]),
                                  dim=0)
            best_all[s:s + len(flat)] = best
        else:
            val = rhs(model, grid, x, vp, vm, uc[policy[flat]])
        val = torch.where(terminal(model, grid, idx), torch.full_like(val, model.exit_cost), val)
        out[s:s + len(flat)] = val
    return out, best_all


def dense_residual(model: Quadcopter, grid: UniformGrid, v, uc, block=1 << 18):
    """max |T v - v| over every node of the flat value v [N] (in v's dtype)."""
    tv, _ = dense_sweep(model, grid, v, uc, block=block)
    return float(torch.max(torch.abs(tv - v)))


def dense_vi(model: Quadcopter, grid: UniformGrid, uc, n_outer: int, eval_sweeps: int,
             dtype, device):
    """Modified policy iteration from the terminal-masked zero value: each
    outer sweep one improve and ``eval_sweeps`` evaluates under its argmin,
    ``n_outer`` times, in ``dtype``. Returns the flat value [N]."""
    idx = grid.unravel(torch.arange(grid.size, device=device))
    v = torch.where(terminal(model, grid, idx), model.exit_cost, 0.0).to(dtype)
    uc = uc.to(dtype=dtype, device=device)
    for _ in range(n_outer):
        v, best = dense_sweep(model, grid, v, uc)
        for _ in range(eval_sweeps):
            v, _ = dense_sweep(model, grid, v, uc, policy=best)
    return v
