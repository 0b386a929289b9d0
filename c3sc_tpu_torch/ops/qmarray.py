"""Quasimatrix (matrix-of-functions) algebra — C3 ``qmarray.c`` parity; port
of ``c3sc_tpu/ops/qmarray.py``.

Reference: C3 ``src/lib_clinalg/qmarray.c`` / ``quasimatrix.c`` — QR, LU and
maxvol of matrices whose entries are univariate functions (line n/a, empty
mount; SURVEY.md §2.2).

A QmArray is an r x c matrix of linear-element functions on shared nodes,
stored as one dense tensor ``vals[r, m, c]``, so every continuous operation
is an exact weighted matrix operation: inner products use the exact
piecewise-linear mass matrix, QR is a Cholesky-metric QR (one Gram and one
triangular solve), and ``qm_maxvol1d`` selects (row, x-node) pivots of the
flattened evaluation tensor with the native maxvol (``native.maxvol``).
Callbacks take a batch of points, as the port's model callables do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device


class QmArray(NamedTuple):
    """r x c quasimatrix: entry (i, j) is the linelm function with node
    values ``vals[i, :, j]`` on the shared sorted ``nodes``."""

    nodes: torch.Tensor   # [m]
    vals: torch.Tensor    # [r, m, c]

    @property
    def shape(self) -> tuple:
        return (self.vals.shape[0], self.vals.shape[2])


def qm_from_callbacks(fs, nodes, device=None) -> QmArray:
    """Build from a nested list fs[i][j] of callbacks (points -> values), on
    ``device`` (None: the default CUDA device)."""
    nodes = torch.as_tensor(nodes, dtype=torch.float32, device=resolve_device(device))
    return QmArray(nodes, torch.stack([torch.stack([f(nodes) for f in frow], dim=-1)
                                       for frow in fs], dim=0))


def mass_matrix(nodes) -> torch.Tensor:
    """Exact Gram of the hat-function basis: tridiagonal [m, m] with
    M[i,i] = (h_{i-1} + h_i)/3, M[i,i+-1] = h/6; float32, on the nodes'
    device (the CPU for an array)."""
    dev = nodes.device if isinstance(nodes, torch.Tensor) else torch.device("cpu")
    nodes = np.asarray(nodes.cpu() if isinstance(nodes, torch.Tensor) else nodes, float)
    h = np.diff(nodes)
    m = len(nodes)
    M = np.zeros((m, m))
    M[np.arange(m - 1), np.arange(1, m)] = h / 6.0
    M[np.arange(1, m), np.arange(m - 1)] = h / 6.0
    d = np.zeros(m)
    d[:-1] += h / 3.0
    d[1:] += h / 3.0
    M[np.arange(m), np.arange(m)] = d
    return torch.as_tensor(M, dtype=torch.float32, device=dev)


def qm_eval(A: QmArray, x) -> torch.Tensor:
    """Evaluate every entry at scalar x -> [r, c] (linear interpolation)."""
    x = torch.as_tensor(x, dtype=A.vals.dtype, device=A.vals.device)
    i = torch.clamp(torch.searchsorted(A.nodes, x.reshape(1), right=True) - 1,
                    0, A.nodes.shape[0] - 2)[0]
    x0, x1 = A.nodes[i], A.nodes[i + 1]
    w = torch.clamp((x - x0) / (x1 - x0), 0.0, 1.0)
    return (1.0 - w) * A.vals[:, i, :] + w * A.vals[:, i + 1, :]


def qm_inner(A: QmArray, B: QmArray) -> torch.Tensor:
    """Continuous column Gram: G[j,k] = sum_i int A[i,.,j](x) B[i,.,k](x) dx,
    exact for the piecewise-linear class via the mass matrix."""
    M = mass_matrix(A.nodes).to(A.vals.dtype)
    return torch.einsum("imj,mn,ink->jk", A.vals, M, B.vals)


def qm_qr(A: QmArray):
    """Continuous QR: A = Q R with Q^T Q = I in the L2 metric (``qm_inner``).

    Cholesky-metric QR: G = A^T A (continuous), G = R^T R, Q = A R^-1.
    Returns (Q: QmArray, R [c, c] upper-triangular).
    """
    G = qm_inner(A, A)
    c = G.shape[0]
    # jitter for rank-deficient inputs keeps the solve finite
    R = torch.linalg.cholesky(G + 1e-10 * torch.eye(c, dtype=G.dtype, device=G.device)).T
    qvals = torch.linalg.solve_triangular(R.T, A.vals.reshape(-1, c).T, upper=False)
    return QmArray(A.nodes, qvals.T.reshape(A.vals.shape)), R


def qm_lu(A: QmArray):
    """Continuous LU with (row, x-node) partial pivoting, on the host in
    float64.

    Returns (L: QmArray [r, c] with L(pivots) = unit lower-triangular,
    U [c, c], pivots: list of (row i, node index t)).
    """
    r, m, c = A.vals.shape
    Lv = A.vals.detach().cpu().numpy().astype(float)      # working function values
    U = np.zeros((c, c))
    pivots = []
    for j in range(c):
        flat = int(np.argmax(np.abs(Lv[:, :, j])))
        pi, pt = flat // m, flat % m
        pivots.append((pi, pt))
        U[j, j:] = Lv[pi, pt, j:]                          # remaining columns at pivot
        piv = U[j, j] if abs(U[j, j]) > 1e-14 else 1e-14
        Lv[:, :, j] /= piv
        for k in range(j + 1, c):
            Lv[:, :, k] -= Lv[:, :, j] * U[j, k]
    like = dict(dtype=A.vals.dtype, device=A.vals.device)
    return QmArray(A.nodes, torch.as_tensor(Lv, **like)), torch.as_tensor(U, **like), pivots


def qm_maxvol1d(A: QmArray, max_iters: int = 50):
    """Select c (row, x-node) pivots approximately maximizing |det| of the
    evaluation matrix — ``qmarray_maxvol1d`` parity.

    Returns (pivots [(row, node_idx)], Eval [c, c] with
    Eval[p, j] = A[row_p, ., j](x_p), interp: QmArray with
    interp(x_p)[row_p] = e_p — the CUR interpolation factor).
    """
    from c3sc_tpu_torch.native import maxvol

    r, m, c = A.vals.shape
    F = A.vals.detach().cpu().numpy().reshape(r * m, c)
    rows = maxvol(F, max_iters=max_iters)
    pivots = [(int(t) // m, int(t) % m) for t in rows]
    E = F[rows]                                            # [c, c]
    G = np.linalg.solve(E.T, F.T).T                        # [r*m, c]
    like = dict(dtype=A.vals.dtype, device=A.vals.device)
    return pivots, torch.as_tensor(E, **like), QmArray(A.nodes,
                                                       torch.as_tensor(G.reshape(r, m, c), **like))
