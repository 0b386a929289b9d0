"""Parity of the port's grids and models (c3sc_tpu_torch) with the JAX
package: the same numpy inputs through both, float32 on the CPU.

Tolerance: rtol 1e-6 (a few float32 ulps, for the libraries' own sin/cos and
summation order), with atol 1e-6 for values that are zero up to rounding.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import QUAD, REPO, close, port_grid
from c3sc_tpu import models as jm
from c3sc_tpu.grids import Grid as JGrid
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.grids import Grid

PROBLEMS = [("quadcopter", QUAD), ("pendulum", {}), ("lq", {})]
TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(name, kw):
    return jm.make_problem(name, **kw), tm.make_problem(name, **kw)


def _samples(prob, n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(prob.lb, prob.ub, (n, prob.dx)).astype(np.float32)
    u = rng.uniform(prob.ulb, prob.uub, (n, prob.du)).astype(np.float32)
    return x, u


def _close(got, want):
    close(got, want, **TOL)


@pytest.mark.parametrize("name,kw", PROBLEMS)
def test_callables_match_jax(name, kw):
    jp, tp = _pair(name, kw)
    x, u = _samples(jp)
    jx, ju, tx, tu = jnp.asarray(x), jnp.asarray(u), torch.as_tensor(x), torch.as_tensor(u)
    _close(tp.drift(tx, tu), jax.vmap(jp.drift)(jx, ju))
    _close(tp.diff(tx, tu), jax.vmap(jp.diff)(jx, ju))
    _close(tp.sigma2_diag(tx, tu), jax.vmap(jp.sigma2_diag)(jx, ju))
    _close(tp.stage_cost(tx, tu), jax.vmap(jp.stage_cost)(jx, ju))
    exit_cost = tp.boundary_cost(tx)
    assert exit_cost.shape == (len(x),)  # batch-shaped even for a constant psi
    _close(exit_cost, jax.vmap(jp.boundary_cost)(jx))


@pytest.mark.parametrize("name,kw", PROBLEMS)
def test_structure_declarations_match_jax(name, kw):
    jp, tp = _pair(name, kw)
    x, u = _samples(jp, seed=1)
    jx, ju, tx, tu = jnp.asarray(x), jnp.asarray(u), torch.as_tensor(x), torch.as_tensor(u)
    assert tp.structured
    _close(tp.drift_f0(tx), jax.vmap(jp.drift_f0)(jx))
    _close(tp.drift_G(tx), jax.vmap(jp.drift_G)(jx))
    _close(tp.sigma2_x(tx), jax.vmap(jp.sigma2_x)(jx))
    _close(tp.cost_q(tx), jax.vmap(jp.cost_q)(jx))
    _close(tp.cost_r(tu), jax.vmap(jp.cost_r)(ju))
    # the declarations are the model: drift == f0 + G u, sigma2_x == diag(L L^T),
    # stage cost == q + r
    affine = tp.drift_f0(tx) + torch.einsum("bdm,bm->bd", tp.drift_G(tx), tu)
    np.testing.assert_allclose(affine.numpy(), tp.drift(tx, tu).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp.sigma2_x(tx).numpy(), tp.sigma2_diag(tx, tu).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose((tp.cost_q(tx) + tp.cost_r(tu)).numpy(),
                               tp.stage_cost(tx, tu).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,kw", PROBLEMS)
def test_static_description_matches_jax(name, kw):
    jp, tp = _pair(name, kw)
    for field in ("dx", "du", "dw", "lb", "ub", "ulb", "uub", "beta", "value_bounds", "name"):
        assert getattr(tp, field) == getattr(jp, field), field
    assert [int(b) for b in tp.boundary] == [int(b) for b in jp.boundary]
    np.testing.assert_array_equal(tp.control_candidates(5), jp.control_candidates(5))
    jg, tg = jp.default_grid(7), tp.default_grid(7)
    assert (tg.lb, tg.ub, tg.shape, tg.periodic) == (jg.lb, jg.ub, jg.shape, jg.periodic)
    np.testing.assert_array_equal(tg.h, jg.h)


def test_callables_broadcast_over_candidates():
    """x [1, B, d] against u [C, 1, du] gives [C, B, ...] (the port's
    replacement of a nested vmap)."""
    tp = tm.make_problem("quadcopter")
    x, u = _samples(tp, n=8)
    tx, tu = torch.as_tensor(x)[None], torch.as_tensor(u[:3])[:, None]
    assert tp.drift(tx, tu).shape == (3, 8, 6)
    assert tp.diff(tx, tu).shape == (3, 8, 6, 3)
    assert tp.stage_cost(tx, tu).shape == (3, 8)
    np.testing.assert_array_equal(tp.drift(tx, tu)[1].numpy(),
                                  tp.drift(tx[0], tu[1].expand(8, 2)).numpy())


def test_lqr_solution_matches_jax():
    for got, want in zip(tm.lqr_solution(q=2.0, beta=0.5), jm.lqr_solution(q=2.0, beta=0.5)):
        np.testing.assert_allclose(got, want, rtol=1e-12)


def _grids():
    periodic = JGrid.create((-np.pi, -2.0), (np.pi, 2.0), (16, 9), (True, False))
    nonuni = JGrid.create(
        (-np.pi, -2.0), (np.pi, 2.0), (12, 9), (True, False),
        nodes=[-np.pi + np.arange(12) * (2 * np.pi / 12),
               [-2.0, -1.2, -0.5, -0.1, 0.0, 0.2, 0.7, 1.5, 2.0]])
    return [periodic, nonuni]


@pytest.mark.parametrize("jg", _grids(), ids=["uniform", "nonuniform"])
def test_grid_queries_match_jax(jg):
    tg = port_grid(jg)
    assert tg == Grid(jg.lb, jg.ub, jg.shape, jg.periodic, jg.nodes_override)
    rng = np.random.default_rng(3)
    x = rng.uniform(np.array(jg.lb) - 1.0, np.array(jg.ub) + 1.0, (300, 2)).astype(np.float32)
    idx = np.stack([rng.integers(0, n, 300) for n in jg.shape], -1).astype(np.int32)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    jidx, tidx = jnp.asarray(idx), torch.as_tensor(idx).long()
    _close(tg.index_to_state(tidx), jg.index_to_state(jidx))
    _close(tg.wrap_state(tx), jg.wrap_state(jx))
    xw = jg.wrap_state(jx)
    jc, jw = jg.state_to_cell(xw)
    tc, tw = tg.state_to_cell(torch.as_tensor(np.array(xw)))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _close(tw, jw)
    for got, want in zip(tg.local_h(tx), jg.local_h(jx)):
        _close(got, want)
    for dim in range(2):
        for step in (-1, 1):
            np.testing.assert_array_equal(tg.neighbor_index(tidx, dim, step).numpy(),
                                          np.asarray(jg.neighbor_index(jidx, dim, step)))
    for k in range(2):
        np.testing.assert_array_equal(tg.nodes(k), jg.nodes(k))
        for got, want in zip(tg.node_h(k), jg.node_h(k)):
            np.testing.assert_array_equal(got, want)


def test_import_leaves_jax_out():
    code = ("import sys, c3sc_tpu_torch, c3sc_tpu_torch.convert, c3sc_tpu_torch.solvers, "
            "c3sc_tpu_torch.sim, c3sc_tpu_torch.ops.interp, c3sc_tpu_torch.ops.dense_backup, "
            "c3sc_tpu_torch.ops.cross, c3sc_tpu_torch.solvers.multilevel, "
            "c3sc_tpu_torch.solvers.pials, c3sc_tpu_torch.solvers.dmrg, "
            "c3sc_tpu_torch.solvers.ttpi, c3sc_tpu_torch.sim.mpc; "
            "import torch; assert torch.backends.cuda.matmul.allow_tf32 is False; "
            "assert torch.backends.cudnn.allow_tf32 is False; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'c3sc_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=REPO)
