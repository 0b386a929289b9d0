"""Univariate function classes — C3 ``lib_funcs`` parity; port of
``c3sc_tpu/ops/funcs.py``.

Reference: C3 ``src/lib_funcs/`` — ``polynomials.c`` (orthonormal expansions),
``piecewisepoly.c``, ``linelm.c``, ``constelm.c``, ``kernels.c`` and the
``functions.c`` ``generic_function`` tagged-union dispatcher (line n/a, empty
mount; SURVEY.md §2.2).

Every class is a NamedTuple of coefficient tensors plus static domain
metadata; evaluation is batched over x by construction and differentiable
with ``torch.autograd``. Fitting is quadrature projection or least squares
over static node sets. A callback ``f`` takes a batch of points (a tensor of
any shape) and returns the values there, as the port's model callables do:
where the JAX package calls ``jax.vmap(f)`` on the nodes, the port calls
``f`` on them. The fitting functions build their tensors on ``device``
(None: the default CUDA device); the others follow their inputs.

``gf_save`` writes the JAX package's npz layout (``kind``, ``scalars``, one
``f<i>`` array a tensor field), so a file either package writes loads in the
other.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.ops.quadrature import gauss_legendre

_F32 = torch.float32


def _as(x, like: torch.Tensor) -> torch.Tensor:
    """x as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Orthonormal polynomial expansions (polynomials.c)
# ---------------------------------------------------------------------------


class OrthPolyExpansion(NamedTuple):
    """f(x) = sum_k coeff[k] phi_k(t(x)), phi_k orthonormal Legendre on
    [-1, 1], t the affine map from [a, b]."""

    coeff: torch.Tensor   # [n]
    a: float
    b: float


def _legendre_vander(t: torch.Tensor, n: int) -> torch.Tensor:
    """Orthonormal Legendre design matrix [..., n] on t in [-1, 1]."""
    cols = [torch.ones_like(t), t]
    for k in range(1, n - 1):
        cols.append(((2 * k + 1) * t * cols[k] - k * cols[k - 1]) / (k + 1))
    P = torch.stack(cols[:n], dim=-1)
    norm = torch.sqrt((2.0 * torch.arange(n, dtype=t.dtype, device=t.device) + 1.0) / 2.0)
    return P * norm


def poly_fit(f: Callable, n: int, a: float, b: float, nquad: int | None = None,
             device=None) -> OrthPolyExpansion:
    """Project a callback onto the first n orthonormal Legendre polys."""
    x, w = gauss_legendre(nquad or (2 * n), a, b)
    dev = resolve_device(device)
    xt = torch.as_tensor(x, dtype=_F32, device=dev)
    t = 2.0 * (xt - a) / (b - a) - 1.0
    P = _legendre_vander(t, n)                          # [q, n]
    scale = 2.0 / (b - a)                               # dt/dx
    coeff = P.T @ (torch.as_tensor(w, dtype=_F32, device=dev) * f(xt)) * scale
    return OrthPolyExpansion(coeff.to(_F32), float(a), float(b))


def poly_eval(p: OrthPolyExpansion, x):
    x = _as(x, p.coeff)
    t = 2.0 * (x - p.a) / (p.b - p.a) - 1.0
    return _legendre_vander(t, p.coeff.shape[0]) @ p.coeff


def poly_integrate(p: OrthPolyExpansion):
    """int_a^b f dx: only the constant mode survives (phi_0 = 1/sqrt(2)),
    so the integral is c_0 sqrt(2) (b - a) / 2."""
    return p.coeff[0] * math.sqrt(2.0) * (p.b - p.a) / 2.0


def poly_inner(p: OrthPolyExpansion, q: OrthPolyExpansion):
    """int_a^b p q dx via orthonormality (same domain required)."""
    n = min(p.coeff.shape[0], q.coeff.shape[0])
    return torch.dot(p.coeff[:n], q.coeff[:n]) * (p.b - p.a) / 2.0


def poly_deriv(p: OrthPolyExpansion) -> OrthPolyExpansion:
    """d/dx as a new expansion (degree drops by one)."""
    n = p.coeff.shape[0]
    # host-side derivative matrix in the orthonormal basis
    norm = np.sqrt((2.0 * np.arange(n) + 1.0) / 2.0)
    D = np.zeros((max(n - 1, 1), n))
    for k in range(1, n):             # dP_k/dt = sum_{j<k, j+k odd} (2j+1) P_j
        for j in range(k - 1, -1, -2):
            D[j, k] = (2 * j + 1) * norm[k] / norm[j]
    D *= 2.0 / (p.b - p.a)            # chain rule dt/dx
    return OrthPolyExpansion(_as(D, p.coeff) @ p.coeff, p.a, p.b)


# ---------------------------------------------------------------------------
# Linear elements (linelm.c) — values on grid nodes, hat-function basis
# ---------------------------------------------------------------------------


class LinElem(NamedTuple):
    nodes: torch.Tensor   # [m] sorted
    vals: torch.Tensor    # [m]


def linelm_fit(f: Callable, nodes, device=None) -> LinElem:
    nodes = torch.as_tensor(nodes, dtype=_F32, device=resolve_device(device))
    return LinElem(nodes, f(nodes))


def _interp(x, xp, fp):
    """Piecewise-linear interpolation with constant extension past the ends
    (``jnp.interp``, term for term)."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    zero = dx == 0
    f = torch.where(zero, fp[i], fp[i - 1] + (delta / torch.where(zero, torch.ones_like(dx), dx))
                    * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def linelm_eval(le: LinElem, x):
    return _interp(_as(x, le.vals), le.nodes, le.vals)


def linelm_integrate(le: LinElem):
    return torch.trapezoid(le.vals, le.nodes)


def linelm_inner(a: LinElem, b: LinElem):
    """Exact int a b dx for piecewise-linear a, b on SHARED nodes: per
    segment h/6 (2 u0 v0 + u0 v1 + u1 v0 + 2 u1 v1)."""
    h = torch.diff(a.nodes)
    u0, u1 = a.vals[:-1], a.vals[1:]
    v0, v1 = b.vals[:-1], b.vals[1:]
    return torch.sum(h / 6.0 * (2 * u0 * v0 + u0 * v1 + u1 * v0 + 2 * u1 * v1))


def linelm_deriv(le: LinElem) -> "ConstElem":
    """Exact derivative: piecewise constant on the cells."""
    return ConstElem(le.nodes, torch.diff(le.vals) / torch.diff(le.nodes))


# ---------------------------------------------------------------------------
# Constant elements (constelm.c) — piecewise constant on cells
# ---------------------------------------------------------------------------


class ConstElem(NamedTuple):
    edges: torch.Tensor   # [m] cell edges (m-1 cells)
    vals: torch.Tensor    # [m-1]


def _cell(edges, x, n_cells):
    return torch.clamp(torch.searchsorted(edges, x.contiguous(), right=True) - 1, 0, n_cells - 1)


def constelm_eval(ce: ConstElem, x):
    return ce.vals[_cell(ce.edges, _as(x, ce.vals), ce.vals.shape[0])]


def constelm_integrate(ce: ConstElem):
    return torch.sum(ce.vals * torch.diff(ce.edges))


# ---------------------------------------------------------------------------
# Piecewise polynomials (piecewisepoly.c)
# ---------------------------------------------------------------------------


class PiecewisePoly(NamedTuple):
    """Per-cell monomial coeffs in the local coordinate s = x - edges[i],
    low order first: f(x) = sum_j coeff[i, j] s^j on cell i."""

    edges: torch.Tensor   # [m] (m-1 cells)
    coeff: torch.Tensor   # [m-1, p]


def pwpoly_fit(f: Callable, edges, order: int = 3, npts_per_cell: int | None = None,
               device=None) -> PiecewisePoly:
    """Least-squares monomial fit per cell at Gauss points (host-side lstsq
    in float64 on the float32 values of ``f``)."""
    dev = resolve_device(device)
    edges = np.asarray(edges, float)
    p = order + 1
    q = npts_per_cell or (2 * p)
    coeffs = []
    for i in range(len(edges) - 1):
        xs, _ = gauss_legendre(q, edges[i], edges[i + 1])
        V = np.vander(xs - edges[i], p, increasing=True)
        y = f(torch.as_tensor(xs, dtype=_F32, device=dev)).detach().cpu().numpy()
        c, *_ = np.linalg.lstsq(V, y, rcond=None)
        coeffs.append(c)
    return PiecewisePoly(torch.as_tensor(edges, dtype=_F32, device=dev),
                         torch.as_tensor(np.stack(coeffs), dtype=_F32, device=dev))


def pwpoly_eval(pw: PiecewisePoly, x):
    x = _as(x, pw.coeff)
    i = _cell(pw.edges, x, pw.coeff.shape[0])
    s = x - pw.edges[i]
    powers = s[..., None] ** torch.arange(pw.coeff.shape[1], dtype=x.dtype, device=x.device)
    return torch.sum(pw.coeff[i] * powers, dim=-1)


def pwpoly_integrate(pw: PiecewisePoly):
    h = torch.diff(pw.edges)                            # [m-1]
    j = torch.arange(pw.coeff.shape[1], dtype=pw.coeff.dtype, device=pw.coeff.device)
    return torch.sum(torch.sum(pw.coeff * h[:, None] ** (j + 1) / (j + 1), dim=1))


def pwpoly_deriv(pw: PiecewisePoly) -> PiecewisePoly:
    p = pw.coeff.shape[1]
    if p == 1:
        return PiecewisePoly(pw.edges, torch.zeros_like(pw.coeff))
    j = torch.arange(1, p, dtype=pw.coeff.dtype, device=pw.coeff.device)
    return PiecewisePoly(pw.edges, pw.coeff[:, 1:] * j[None, :])


# ---------------------------------------------------------------------------
# Kernel (RBF) expansions (kernels.c)
# ---------------------------------------------------------------------------


class KernelExpansion(NamedTuple):
    """f(x) = sum_i coeff[i] exp(-(x - centers[i])^2 / (2 width^2))."""

    centers: torch.Tensor  # [m]
    coeff: torch.Tensor    # [m]
    width: float


def kernel_eval(ke: KernelExpansion, x):
    x = _as(x, ke.coeff)
    K = torch.exp(-((x[..., None] - ke.centers) ** 2) / (2.0 * ke.width ** 2))
    return K @ ke.coeff


def kernel_fit(f: Callable, centers, width: float, reg: float = 1e-8,
               device=None) -> KernelExpansion:
    """Regularized interpolation at the centers (ridge least squares)."""
    centers = torch.as_tensor(centers, dtype=_F32, device=resolve_device(device))
    K = torch.exp(-((centers[:, None] - centers[None, :]) ** 2) / (2.0 * width ** 2))
    m = centers.shape[0]
    eye = torch.eye(m, dtype=K.dtype, device=K.device)
    coeff = torch.linalg.solve(K + reg * eye, f(centers))
    return KernelExpansion(centers, coeff, float(width))


def kernel_integrate(ke: KernelExpansion, a: float, b: float):
    """Exact int_a^b via the error function."""
    s = ke.width * math.sqrt(2.0)
    parts = torch.special.erf((b - ke.centers) / s) - torch.special.erf((a - ke.centers) / s)
    return torch.sum(ke.coeff * parts) * ke.width * math.sqrt(math.pi / 2.0)


# ---------------------------------------------------------------------------
# Generic dispatcher (functions.c struct GenericFunction)
# ---------------------------------------------------------------------------

_KINDS = ("poly", "linelm", "constelm", "pwpoly", "kernel")
_CLASSES = {"poly": OrthPolyExpansion, "linelm": LinElem, "constelm": ConstElem,
            "pwpoly": PiecewisePoly, "kernel": KernelExpansion}


class GenericFunction(NamedTuple):
    """Tagged wrapper over any univariate class; ``kind`` picks the methods."""

    kind: str
    obj: NamedTuple


def gf_eval(g: GenericFunction, x):
    return {"poly": poly_eval, "linelm": linelm_eval, "constelm": constelm_eval,
            "pwpoly": pwpoly_eval, "kernel": kernel_eval}[g.kind](g.obj, x)


def gf_integrate(g: GenericFunction, a: float | None = None, b: float | None = None):
    if g.kind == "poly":
        return poly_integrate(g.obj)
    if g.kind == "linelm":
        return linelm_integrate(g.obj)
    if g.kind == "constelm":
        return constelm_integrate(g.obj)
    if g.kind == "pwpoly":
        return pwpoly_integrate(g.obj)
    if g.kind == "kernel":
        if a is None or b is None:
            raise ValueError("kernel integrate needs [a, b]")
        return kernel_integrate(g.obj, a, b)
    raise ValueError(f"unknown kind {g.kind!r} (want one of {_KINDS})")


def gf_save(path: str, g: GenericFunction) -> None:
    """The JAX package's layout: ``kind``, ``scalars`` (the float fields in
    order) and ``f<i>`` for the tensor field at position i."""
    arrays = {f"f{i}": a.detach().cpu().numpy() for i, a in enumerate(g.obj)
              if isinstance(a, torch.Tensor)}
    scalars = [a for a in g.obj if not isinstance(a, torch.Tensor)]
    np.savez(path, kind=g.kind, scalars=np.asarray(scalars, float), **arrays)


def gf_load(path: str, device=None) -> GenericFunction:
    """A GenericFunction written by either package's ``gf_save``, on
    ``device`` (None: the default CUDA device)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
        arrays = [torch.as_tensor(z[k], device=dev) for k in sorted(
            (k for k in z.files if k.startswith("f")), key=lambda s: int(s[1:]))]
        scalars = [float(s) for s in z["scalars"]]
    return GenericFunction(kind, _CLASSES[kind](*arrays, *scalars))
