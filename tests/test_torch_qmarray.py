"""The port's quasimatrices (c3sc_tpu_torch.ops.qmarray) against the JAX
package's (c3sc_tpu.ops.qmarray) on the CPU, on tests/test_qmarray.py's
example written once in each framework.

Bars, each stated at its test: the mass matrix equal to float32 rounding;
Q R and L U rebuild the same A within 1e-5 (of max|A| = 1); |diag R| within
1e-5 relative of JAX's; the same LU and maxvol pivots; the JAX tests' bars
on the port (orthonormality 1e-4, unit pivots, the CUR identity 1e-5,
cond(E) < 50).
"""

from torch_port_testing import to_numpy  # first: pins torch's threads

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3sc_tpu.ops import qmarray as jq
from c3sc_tpu_torch.ops import qmarray as tq

NODES = np.linspace(-1.0, 1.0, 101)


def _examples():
    jfs = [[lambda x: jnp.ones_like(x), lambda x: x, lambda x: x**2],
           [lambda x: jnp.sin(3 * x), jnp.cos, lambda x: x**3]]
    tfs = [[torch.ones_like, lambda x: x, lambda x: x**2],
           [lambda x: torch.sin(3 * x), torch.cos, lambda x: x**3]]
    return jq.qm_from_callbacks(jfs, jnp.asarray(NODES)), tq.qm_from_callbacks(tfs, NODES, "cpu")


def test_mass_matrix_and_eval():
    np.testing.assert_array_equal(tq.mass_matrix(NODES).numpy(), np.asarray(jq.mass_matrix(NODES)))
    ones, x = torch.ones(len(NODES)), torch.as_tensor(NODES, dtype=torch.float32)
    M = tq.mass_matrix(NODES)
    assert float(ones @ M @ ones) == pytest.approx(2.0, rel=1e-6)
    assert float(x @ M @ x) == pytest.approx(2.0 / 3.0, rel=1e-4)
    A, T = _examples()
    np.testing.assert_allclose(tq.qm_eval(T, 0.5).numpy(), np.asarray(jq.qm_eval(A, 0.5)),
                               atol=1e-6)
    np.testing.assert_allclose(tq.qm_eval(T, 0.5).numpy(),
                               [[1.0, 0.5, 0.25], [np.sin(1.5), np.cos(0.5), 0.125]], atol=1e-3)


def test_qr_rebuilds_and_matches_jax():
    A, T = _examples()
    Q, R = tq.qm_qr(T)
    JQ, JR = jq.qm_qr(A)
    recon = torch.einsum("imk,kj->imj", Q.vals, R).numpy()
    np.testing.assert_allclose(recon, np.asarray(jnp.einsum("imk,kj->imj", JQ.vals, JR)),
                               atol=1e-5)
    np.testing.assert_allclose(recon, T.vals.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.abs(np.diag(R.numpy())), np.abs(np.diag(np.asarray(JR))),
                               rtol=1e-5)
    np.testing.assert_allclose(tq.qm_inner(Q, Q).numpy(), np.eye(3), atol=1e-4)
    assert abs(float(R[1, 0])) < 1e-6 and abs(float(R[2, 0])) < 1e-6


def test_lu_rebuilds_with_the_same_pivots():
    A, T = _examples()
    L, U, piv = tq.qm_lu(T)
    JL, JU, jpiv = jq.qm_lu(A)
    assert piv == jpiv
    recon = torch.einsum("imk,kj->imj", L.vals, U).numpy()
    np.testing.assert_allclose(recon, T.vals.numpy(), atol=1e-5)
    np.testing.assert_allclose(recon, np.asarray(jnp.einsum("imk,kj->imj", JL.vals, JU)),
                               atol=1e-5)
    for j, (pi, pt) in enumerate(piv):
        assert float(L.vals[pi, pt, j]) == pytest.approx(1.0, abs=1e-6)


def test_maxvol1d_same_pivots_and_cur_identity():
    A, T = _examples()
    piv, E, interp = tq.qm_maxvol1d(T)
    jpiv, JE, _ = jq.qm_maxvol1d(A)
    assert piv == jpiv
    np.testing.assert_allclose(E.numpy(), np.asarray(JE), atol=1e-6)
    for p, (pi, pt) in enumerate(piv):
        np.testing.assert_allclose(to_numpy(interp.vals[pi, pt, :]), np.eye(3)[p], atol=1e-5)
    assert np.linalg.cond(E.numpy()) < 50.0
