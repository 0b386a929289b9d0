"""Parity of the port's Kushner–Dupuis stencil (c3sc_tpu_torch.ops.mca) with
c3sc_tpu.ops.mca: the same numpy nodes and candidates through both, on the
quadcopter 5^6, the pendulum, and a non-uniform grid.

Tolerance: rtol 1e-5, atol 1e-6 — float32 rounding of the drift contraction
and of the sums over dims, which the two libraries order differently.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3sc_tpu import models as jm
from c3sc_tpu.grids import Grid as JGrid
from c3sc_tpu.ops import mca as jmca
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import grid_from_numpy
from c3sc_tpu_torch.ops import mca as tmca

TOL = dict(rtol=1e-5, atol=1e-6)
UNSTRUCTURED = dict(drift_f0=None, drift_G=None, sigma2_x=None, cost_q=None, cost_r=None)


def _case(name):
    """(jax problem, port problem, jax grid, port grid, candidates)."""
    if name == "quad5":
        kw = dict(sigma_v=0.15, sigma_om=0.15)
        jp, tp = jm.make_problem("quadcopter", **kw), tm.make_problem("quadcopter", **kw)
        jg = jp.default_grid(5)
        uc = jp.control_candidates(5)
    elif name == "pendulum":
        jp, tp = jm.make_problem("pendulum"), tm.make_problem("pendulum")
        jg = jp.default_grid((21, 17))
        uc = jp.control_candidates(9)
    else:  # LQ on a non-uniform grid, denser near the origin
        jp, tp = jm.make_problem("lq"), tm.make_problem("lq")
        nodes = 2.0 * np.sign(np.linspace(-1, 1, 15)) * np.linspace(-1, 1, 15) ** 2
        jg = JGrid.create(jp.lb, jp.ub, (15, 15), nodes=[nodes, nodes])
        assert not jg.uniform
        uc = jp.control_candidates(7)
    tg = grid_from_numpy(jg.lb, jg.ub, jg.shape, jg.periodic, jg.nodes_override)
    return jp, tp, jg, tg, np.asarray(uc, np.float32)


def _nodes(jg):
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in jg.shape], indexing="ij"), -1)
    idx = idx.reshape(-1, jg.ndim).astype(np.int32)
    x = np.array(jg.index_to_state(jnp.asarray(idx)), np.float32)
    return idx, x


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("structured", [True, False], ids=["declared", "general"])
@pytest.mark.parametrize("name", ["quad5", "pendulum", "nonuniform"])
def test_transition_all_controls_and_stage_cost(name, structured):
    """Both the declared fast path and the general broadcast path (taken by
    problems without structure declarations, as the glider)."""
    jp, tp, jg, tg, uc = _case(name)
    if not structured:
        jp, tp = dataclasses.replace(jp, **UNSTRUCTURED), dataclasses.replace(tp, **UNSTRUCTURED)
    _, x = _nodes(jg)
    jx, tx, juc, tuc = jnp.asarray(x), torch.as_tensor(x), jnp.asarray(uc), torch.as_tensor(uc)
    for got, want in zip(tmca.transition_all_controls(tp, tg, tx, tuc),
                         jmca.transition_all_controls(jp, jg, jx, juc)):
        assert got.shape == want.shape
        _close(got, want)
    _close(tmca.stage_cost_all(tp, tx, tuc), jmca.stage_cost_all(jp, jx, juc))


@pytest.mark.parametrize("name", ["quad5", "pendulum", "nonuniform"])
def test_transition_per_node_controls(name):
    jp, tp, jg, tg, uc = _case(name)
    _, x = _nodes(jg)
    u = uc[np.random.default_rng(0).integers(0, len(uc), len(x))]
    got = tmca.transition(tp, tg, torch.as_tensor(x), torch.as_tensor(u))
    want = jmca.transition_batch(jp, jg, jnp.asarray(x), jnp.asarray(u))
    for g, w in zip(got, want):
        _close(g, w)
    # probabilities are a distribution over the 2d neighbours
    np.testing.assert_allclose((got[0] + got[1]).sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("name", ["quad5", "pendulum", "nonuniform"])
def test_node_terminal(name):
    jp, tp, jg, tg, _ = _case(name)
    idx, x = _nodes(jg)
    tmask, tval = tmca.node_terminal(tp, tg, torch.as_tensor(idx).long(), torch.as_tensor(x))
    jmask, jval = jmca.node_terminal(jp, jg, jnp.asarray(idx), jnp.asarray(x))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    _close(tval, jval)


def test_stencil_gradient_wrt_u():
    """d(dt)/du through torch.autograd agrees with jax.grad."""
    jp, tp, jg, tg, uc = _case("quad5")
    _, x = _nodes(jg)
    x0, u0 = x[1234], uc[7]
    want = jax.grad(lambda u: jmca.transition(jp, jg, jnp.asarray(x0), u)[2])(jnp.asarray(u0))
    u = torch.tensor(u0, requires_grad=True)
    tmca.transition(tp, tg, torch.as_tensor(x0), u)[2].backward()
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-9)
