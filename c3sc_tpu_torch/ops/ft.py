"""Function train with orthonormal-polynomial cores (C3's FT proper) — port
of ``c3sc_tpu/ops/ft.py``.

The value path stores a discrete TT on grid nodes (linelm semantics:
``ops/tt.py`` + lerp). C3's ``struct FunctionTrain`` can also carry
polynomial cores (``lib_funcs/polynomials.c`` inside ``lib_clinalg/ft.c``):
each core entry is a univariate orthonormal expansion, giving smooth
off-grid evaluation and exact integrals. This module is that object:

- ``PolyFT``: d coefficient cores ``[R, p_k, R]`` in the orthonormal
  Legendre basis of ``ops/funcs.py``, plus static per-dim domains and
  periodicity flags;
- ``ft_from_tt``: least-squares projection of a nodal TT onto per-dim
  Legendre bases, one einsum per dim. Periodic dims fit over the FULL period
  with the wrap node appended, so the seam interpolates toward v(lb);
- ``ft_eval``: batched continuous evaluation (chains of [R, R] products),
  periodic dims wrapped like ``tt_lerp_eval``;
- ``ft_integrate``: exact, the constant-mode contraction;
- ``ft_grad_eval``: the gradient at a batch of points by
  ``torch.autograd.grad``, under ``torch.enable_grad()`` so that callers
  inside ``torch.no_grad`` (the implicit policy) get it too.

Degree: full-degree (n-1) interpolation on equispaced nodes is numerically
catastrophic beyond n ~ 20 in float32, so the default degree caps at
``max(16, 2 sqrt(n))``: an interpolant on small grids, a least-squares
smoothing fit on large ones.

``ft_save`` writes the JAX package's npz layout (``coeff_k``, ``ranks``, a
JSON ``meta``), so a file either package writes loads in the other.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.grids import Grid, float_mod
from c3sc_tpu_torch.ops.funcs import _legendre_vander
from c3sc_tpu_torch.ops.tt import TT


class PolyFT(NamedTuple):
    """Function train with orthonormal-Legendre coefficient cores."""

    coeff: tuple          # d x [R, p_k, R]
    ranks: torch.Tensor   # [d+1] active ranks (padded-zero invariant kept)
    lb: tuple             # d static domain lower bounds
    ub: tuple             # d static domain upper bounds
    periodic: tuple       # d static bools — wrap x into [lb, ub) on eval

    @property
    def ndim(self) -> int:
        return len(self.coeff)


def _default_order(n: int) -> int:
    return min(n - 1, max(16, int(2 * np.sqrt(n))))


def ft_from_tt(v: TT, grid: Grid, order: int | None = None) -> PolyFT:
    """Project a nodal TT onto per-dim orthonormal Legendre bases.

    order: polynomial degree. Default ``min(n-1, max(16, 2 sqrt(n)))``:
    exact interpolation of the nodal values on small grids, a stable
    least-squares fit on large equispaced grids. Padded-zero columns of the
    TT cores project to exactly zero coefficient columns, so the active-rank
    invariant survives. The projector is the pseudo-inverse of the float32
    design matrix, worked out by numpy on the host as in the JAX package.
    """
    cores_out = []
    lb, ub = [], []
    for k, core in enumerate(v.cores):
        nodes = np.asarray(grid.nodes(k))
        if grid.periodic[k]:
            nodes = np.append(nodes, grid.lb[k] + (grid.ub[k] - grid.lb[k]))
            core = torch.cat([core, core[:, :1, :]], dim=1)
        n = core.shape[1]
        p = min(n, (order + 1) if order is not None else _default_order(n) + 1)
        a, b = float(nodes[0]), float(nodes[-1])
        t = 2.0 * (nodes - a) / (b - a) - 1.0
        P = _legendre_vander(torch.as_tensor(t, dtype=torch.float32), p).numpy()   # [n, p]
        Pp = torch.as_tensor(np.linalg.pinv(P), dtype=core.dtype, device=core.device)
        cores_out.append(torch.einsum("pn,rns->rps", Pp, core))
        lb.append(a)
        ub.append(b)
    return PolyFT(tuple(cores_out), v.ranks, tuple(lb), tuple(ub),
                  tuple(bool(x) for x in grid.periodic))


def ft_eval(ft: PolyFT, pts) -> torch.Tensor:
    """Continuous evaluation at pts [B, d] -> [B]: per dim, the coefficient
    core mixed with the Legendre design row, then the [B, R, R] factors
    chained. Periodic dims wrap into [lb, lb + period) first. The domain
    enters as Python scalars, so no call copies a constant to the device."""
    pts = torch.as_tensor(pts, dtype=ft.coeff[0].dtype, device=ft.coeff[0].device)
    B = pts.shape[0]
    R = ft.coeff[0].shape[0]
    vec = torch.zeros((B, R), dtype=pts.dtype, device=pts.device)
    vec[:, 0].fill_(1.0)   # a scalar fill: assigning 1.0 reads a host tensor with item()
    for k, core in enumerate(ft.coeff):
        x = pts[:, k]
        if ft.periodic[k]:
            x = ft.lb[k] + float_mod(x - ft.lb[k], float(ft.ub[k] - ft.lb[k]))
        t = torch.clamp(2.0 * (x - ft.lb[k]) / (ft.ub[k] - ft.lb[k]) - 1.0, -1.0, 1.0)
        phi = _legendre_vander(t, core.shape[1])             # [B, p]
        M = torch.einsum("bp,rps->brs", phi, core)           # [B, R, R]
        vec = torch.einsum("br,brs->bs", vec, M)
    return vec[:, 0]


def ft_integrate(ft: PolyFT) -> torch.Tensor:
    """Exact integral over the full domain: only the constant Legendre mode
    integrates to a nonzero value (sqrt(2)/2 (b - a) per dim)."""
    R = ft.coeff[0].shape[0]
    vec = torch.zeros(R, dtype=ft.coeff[0].dtype, device=ft.coeff[0].device)
    vec[0] = 1.0
    for k, core in enumerate(ft.coeff):
        w = float(np.sqrt(np.float32(2.0))) * (ft.ub[k] - ft.lb[k]) / 2.0
        vec = vec @ (core[:, 0, :] * w)
    return vec[0]


def ft_grad_eval(ft: PolyFT, pts) -> torch.Tensor:
    """Gradient of the smooth FT at pts [B, d] -> [B, d]: the smooth
    interpolant makes value gradients well defined everywhere (lerp
    gradients are piecewise constant and undefined on cell faces). Each
    point's value depends on its own coordinates alone, so the gradient of
    the batch's sum is every point's gradient."""
    with torch.enable_grad():
        x = torch.as_tensor(pts, dtype=ft.coeff[0].dtype,
                            device=ft.coeff[0].device).detach().requires_grad_(True)
        (g,) = torch.autograd.grad(ft_eval(ft, x).sum(), x)
    return g


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def ft_save(path: str, ft: PolyFT) -> None:
    """Serialize a PolyFT to npz, the ``function_train_save`` equivalent for
    polynomial cores: coefficient cores + ranks + static domain."""
    arrays = {f"coeff_{k}": c.detach().cpu().numpy() for k, c in enumerate(ft.coeff)}
    arrays["ranks"] = ft.ranks.detach().cpu().numpy()
    meta = {"kind": "poly_ft", "d": ft.ndim, "lb": list(ft.lb),
            "ub": list(ft.ub), "periodic": [bool(p) for p in ft.periodic]}
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(_npz(path), **arrays)


def ft_load(path: str, device=None) -> PolyFT:
    """Restore a PolyFT written by either package's ``ft_save``, on
    ``device`` (None: the default CUDA device)."""
    dev = resolve_device(device)
    with np.load(_npz(path)) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        if meta.get("kind") != "poly_ft":
            raise ValueError(f"{path} is not a PolyFT file (kind={meta.get('kind')!r})")
        d = meta["d"]
        return PolyFT(
            coeff=tuple(torch.as_tensor(data[f"coeff_{k}"], device=dev) for k in range(d)),
            ranks=torch.as_tensor(data["ranks"], device=dev),
            lb=tuple(meta["lb"]), ub=tuple(meta["ub"]), periodic=tuple(meta["periodic"]),
        )
