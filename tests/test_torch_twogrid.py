"""The port's coarse-grid correction (c3sc_tpu_torch.solvers.twogrid) and
``ops.tt.tt_refine_grid`` against the JAX package on the CPU, every call on
device "cpu".

Bars, each stated at its test:
  - ``coarse_grid``: identical shapes, node sets and fine indices;
  - ``tt_refine_grid`` and ``_blend``: float32 rounding, 1e-5 x max|v|;
  - ``coarse_correct`` on ``tests/test_twogrid.py``'s pendulum base (the JAX
    fused solve at rmax 12, key 1): the same acceptance and step size; the
    sampled defects before and after within 1e-4 relative, the defect rms and
    the correction's scale within 1e-3 relative (the coarse solve amplifies
    the float32 defect by up to 1 / (1 - gamma)); the result within
    1e-3 x max|v|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_testing import QUAD, port_grid, random_tt_numpy
from c3sc_tpu import models as jm
from c3sc_tpu.ops import tt as jtt
from c3sc_tpu.solvers import twogrid as jtg
from c3sc_tpu.solvers.fused import fused_tt_vi as j_fused
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import tt_from_numpy
from c3sc_tpu_torch.ops import tt as ttt
from c3sc_tpu_torch.solvers import twogrid as ttg

CPU = "cpu"


def to_port(jt):
    return tt_from_numpy([np.asarray(c) for c in jt.cores], np.asarray(jt.ranks), CPU)


def jax_tt(cores, ranks):
    return jtt.TT(tuple(jnp.asarray(c) for c in cores), jnp.asarray(ranks))


@pytest.mark.parametrize("name,n", [("pendulum", 31), ("quadcopter", 9), ("quadcopter", 5)])
@pytest.mark.parametrize("layer", [False, True])
def test_coarse_grid_matches_jax(name, n, layer):
    jp = jm.make_problem(name, **(QUAD if name == "quadcopter" else {}))
    jg = jp.default_grid(n)
    jgc, jix = jtg.coarse_grid(jg, boundary_layer=layer)
    tgc, tix = ttg.coarse_grid(port_grid(jg), boundary_layer=layer)
    assert tgc.shape == jgc.shape and tgc.uniform == jgc.uniform
    for k in range(jg.ndim):
        np.testing.assert_array_equal(tix[k], jix[k])
        np.testing.assert_array_equal(tgc.nodes(k), np.asarray(jgc.nodes(k)))
    if name == "quadcopter" and n == 9:
        assert tgc.uniform != layer       # the layer-keeping grid is non-uniform


@pytest.mark.parametrize("layer", [False, True])
def test_tt_refine_grid_matches_jax(layer):
    """A random TT on the coarse grid of the 9^6 quadcopter, prolonged to the
    fine grid (uniform and layer-keeping coarse grids)."""
    jg = jm.make_problem("quadcopter", **QUAD).default_grid(9)
    jgc, _ = jtg.coarse_grid(jg, boundary_layer=layer)
    cores, ranks = random_tt_numpy(jgc.shape, [4] * 5, 4, seed=2)
    want = jtt.tt_refine_grid(jax_tt(cores, ranks), jgc, jg)
    got = ttt.tt_refine_grid(tt_from_numpy(cores, ranks, CPU), port_grid(jgc), port_grid(jg))
    for a, b in zip(want.cores, got.cores):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(a)).max())
    assert got.ranks.tolist() == np.asarray(want.ranks).tolist()


def test_blend_matches_jax():
    """v + alpha e through the 2R sum and both roundings, as JAX's jitted path."""
    shape = (7, 6, 5)
    cv, rv = random_tt_numpy(shape, [3, 3], 4, seed=0)
    ce, re = random_tt_numpy(shape, [2, 3], 4, seed=1)
    want = jtg._blend(jax_tt(cv, rv), jax_tt(ce, re), jnp.asarray(0.5, jnp.float32))
    got = ttg._blend(tt_from_numpy(cv, rv, CPU), tt_from_numpy(ce, re, CPU), 0.5)
    wf = np.asarray(jtt.tt_full(want))
    np.testing.assert_allclose(ttt.tt_full(got).numpy(), wf, rtol=0,
                               atol=1e-5 * np.abs(wf).max())


@pytest.fixture(scope="module")
def pendulum_base():
    """tests/test_twogrid.py's base: the JAX fused solve of pendulum 31^2 at
    rmax 12 from key 1."""
    jp, tp = jm.make_problem("pendulum"), tm.make_problem("pendulum")
    jg, tg = jp.default_grid(31), tp.default_grid(31)
    uc = jp.control_candidates(9)
    fsol = j_fused(jp, jg, controls=uc, rmax=12, key=jax.random.key(1), tol=2e-4,
                   max_iters=600, patience=50)
    return jp, tp, jg, tg, uc, fsol.v


@pytest.mark.parametrize("layer", [True, False])
def test_coarse_correct_matches_jax(pendulum_base, layer):
    jp, tp, jg, tg, uc, v = pendulum_base
    jv, ji = jtg.coarse_correct(jp, jg, uc, v, boundary_layer=layer, chunk=8192)
    tv, ti = ttg.coarse_correct(tp, tg, uc, to_port(v), boundary_layer=layer, chunk=8192)
    assert ti.accepted == ji.accepted
    np.testing.assert_allclose([ti.bres_before, ti.bres_after], [ji.bres_before, ji.bres_after],
                               rtol=1e-4)
    np.testing.assert_allclose([ti.defect_rms_before, ti.correction_scale],
                               [ji.defect_rms_before, ji.correction_scale], rtol=1e-3)
    want = np.asarray(jtt.tt_full(jv))
    assert np.abs(ttt.tt_full(tv).numpy() - want).max() <= 1e-3 * np.abs(want).max()
