"""Kernel K1 of the port on non-uniform grids, against the JAX package on
the CPU. The CUDA kernels run only on the card (tests/test_torch_kernels.py
holds each entry there against its plain version); here their arithmetic
on a non-uniform grid, ``candidate_rhs_factored`` on the kernels' own
operands and spacing tables, is held against JAX's unequal-spacing stencil
(``mca._stencil_nonuniform`` through ``solvers.dense._precompute``), and
``dense_vi`` on tests/test_nonuniform.py's tanh grid against JAX's.

Bars, each stated at its test: the rhs [C, N] within rtol/atol 1e-5 (float32
rounding of one stencil in two term orders), argmins equal off near-ties;
the spacing tables equal to the float32 rounding of Grid.node_h's
reciprocals; dense_vi within 1e-4 x max|v|.
"""

from torch_port_testing import (TIE, port_grid, random_v,  # first: pins torch's threads
                                tanh_node_sets, tanh_nodes)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3sc_tpu import models as jm
from c3sc_tpu.grids import Grid as JGrid
from c3sc_tpu.solvers.dense import _precompute, dense_vi as j_dense_vi, neighbor_values
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.ops import dense_backup as db
from c3sc_tpu_torch.solvers import dense_vi


def _tanh_grid(jp, shape):
    """A JAX Grid with tanh nodes on the problem's bounded dims and the
    uniform periodic nodes elsewhere."""
    periodic = jp.default_grid(shape).periodic
    return JGrid.create(jp.lb, jp.ub, shape, periodic,
                        nodes=tanh_node_sets(jp.lb, jp.ub, shape, periodic))


def _jax_rhs(jp, jg, uc, v):
    x, pp, pm, dt, g, _, _ = _precompute(jp, jg, uc, jnp.float32)
    vp, vm = neighbor_values(jnp.asarray(v), jg)
    return np.asarray(g * dt + jnp.exp(-jp.beta * dt) * (
        jnp.einsum("cnd,nd->cn", pp, vp) + jnp.einsum("cnd,nd->cn", pm, vm)))


@pytest.mark.parametrize("name,shape,n_cand", [("lq", (21, 21), 9),
                                               ("pendulum", (16, 21), 9),
                                               ("glider", (7, 5, 5, 6), 3)])
def test_factored_rhs_on_nonuniform_grid_matches_plain_and_jax(name, shape, n_cand):
    """The structured form (LQ; the pendulum with its periodic theta) and
    the general form (the glider) against the plain version and JAX: rtol
    and atol 1e-5, argmins equal wherever the best two are not a near-tie."""
    jp, tp = jm.make_problem(name), tm.make_problem(name)
    jg = _tanh_grid(jp, shape)
    tg = port_grid(jg)
    assert not tg.uniform
    uc = jp.control_candidates(n_cand)
    ops = db.make_dense_operands(tp, tg, uc, "cpu")
    assert ops.general == (name == "glider") and ops.nu_k is not None
    v = random_v(shape)
    tv = torch.as_tensor(v)
    got = db.candidate_rhs_factored(ops, tv).numpy()
    np.testing.assert_allclose(got, db.candidate_rhs(ops, tv).numpy(), rtol=1e-5, atol=1e-5)
    rhs = _jax_rhs(jp, jg, uc, v)
    np.testing.assert_allclose(got, rhs, rtol=1e-5, atol=1e-5)
    top2 = np.sort(rhs, axis=0)[:2]
    near_tie = (top2[1] - top2[0]) <= TIE * np.maximum(1.0, np.abs(top2[0]))
    assert not np.any((np.argmin(got, axis=0) != np.argmin(rhs, axis=0)) & ~near_tie)


def test_spacing_tables():
    """One row a (dim, coordinate): 1/h+, 1/h-, 1/(h+ h-), 1/(h+ (h+ + h-)),
    1/(h- (h+ + h-)) of Grid.node_h in float64, rounded to float32 once;
    none on a uniform grid."""
    jp, tp = jm.make_problem("pendulum"), tm.make_problem("pendulum")
    tg = port_grid(_tanh_grid(jp, (8, 11)))
    tab = db.spacing_tables(tg, "cpu").numpy()
    assert tab.shape == (19, db.SPACING_STRIDE) and tab.dtype == np.float32
    hp, hm = tg.node_h(1)
    want = np.stack([1 / hp, 1 / hm, 1 / (hp * hm), 1 / (hp * (hp + hm)), 1 / (hm * (hp + hm))],
                    -1).astype(np.float32)
    np.testing.assert_array_equal(tab[8:, :5], want)
    np.testing.assert_array_equal(tab[:, 5:], 0.0)
    h = tg.h[0]   # the periodic dim keeps its uniform spacing
    np.testing.assert_allclose(tab[:8, :2], 1 / h, rtol=1e-7)
    assert db.spacing_tables(tp.default_grid(11), "cpu") is None


def test_dense_vi_on_tanh_grid_matches_jax():
    """tests/test_nonuniform.py's LQ 21^2 tanh grid (9 candidates): the
    port's dense_vi (K1's plain sweeps) against JAX's, within 1e-4 x max|v|."""
    jp, tp = jm.make_problem("lq"), tm.make_problem("lq")
    nodes = [tanh_nodes(lo, hi, 21) for lo, hi in zip(jp.lb, jp.ub)]
    jg = JGrid.create_nonuniform(nodes)
    uc = jp.control_candidates(9)
    want = np.asarray(j_dense_vi(jp, jg, controls=uc, tol=1e-6, max_outer=4000).v)
    got = dense_vi(tp, port_grid(jg), controls=uc, tol=1e-6, max_outer=4000, device="cpu").v
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
