"""Quadrature rules — C3 ``lib_quadrature`` parity; the port's own copy of
``c3sc_tpu/ops/quadrature.py`` (numpy only).

Reference: C3 ``src/lib_quadrature/`` (Gauss rules used by the univariate
function classes for projection/inner products — line n/a, empty mount;
SURVEY.md §2.2). Nodes/weights are computed host-side with numpy (they are
static problem data) and returned as plain float64 arrays; the function
classes of ``ops/funcs.py`` turn them into tensors where they use them.
"""

from __future__ import annotations

import numpy as np


def gauss_legendre(n: int, a: float = -1.0, b: float = 1.0):
    """Gauss–Legendre rule with ``n`` points on [a, b].

    Exact for polynomials up to degree 2n-1. Returns (nodes [n], weights [n]).
    """
    x, w = np.polynomial.legendre.leggauss(n)
    half = 0.5 * (b - a)
    return a + half * (x + 1.0), half * w


def gauss_hermite(n: int):
    """Physicists' Gauss–Hermite: ∫ f(x) e^{-x²} dx ≈ Σ wᵢ f(xᵢ)."""
    return np.polynomial.hermite.hermgauss(n)


def gauss_hermite_prob(n: int):
    """Probabilists' Gauss–Hermite: E[f(Z)], Z ~ N(0,1) ≈ Σ wᵢ f(xᵢ).

    Weights sum to 1; nodes are √2 × the physicists' nodes.
    """
    x, w = np.polynomial.hermite.hermgauss(n)
    return np.sqrt(2.0) * x, w / np.sqrt(np.pi)


def clenshaw_curtis(n: int, a: float = -1.0, b: float = 1.0):
    """Clenshaw–Curtis rule with ``n`` points (Chebyshev extrema) on [a, b].

    Exact for polynomials up to degree n-1; spectrally accurate for smooth
    integrands. n must be ≥ 2.
    """
    if n < 2:
        raise ValueError("clenshaw_curtis requires n >= 2")
    m = n - 1
    theta = np.pi * np.arange(n) / m
    x = np.cos(theta)                       # extrema, descending on [-1, 1]
    w = np.zeros(n)
    v = np.ones(m - 1)
    for k in range(1, m // 2 + 1):
        fac = 1.0 if 2 * k != m else 0.5
        v -= 2.0 * fac * np.cos(2.0 * k * theta[1:m]) / (4.0 * k * k - 1.0)
    w[1:m] = 2.0 * v / m
    w[0] = w[m] = 1.0 / (m * m - 1.0 + (m % 2))
    half = 0.5 * (b - a)
    return a + half * (x[::-1] + 1.0), half * w[::-1]


def trapezoid(nodes: np.ndarray):
    """Trapezoid weights on arbitrary sorted nodes (linelm's exact rule)."""
    nodes = np.asarray(nodes, float)
    d = np.diff(nodes)
    w = np.zeros_like(nodes)
    w[:-1] += 0.5 * d
    w[1:] += 0.5 * d
    return nodes, w
