"""Kernel K1 on the problems its structured entries cannot take, against the
JAX package on the same numpy inputs, on the CPU (the CUDA kernels run on
the card: tests/test_torch_kernels.py):

(a) five controls: the double integrator of ``C3Control(dx=2, du=5, ...)``
    on 21^2 nodes with 3 candidates a control (243), which takes the general
    entries;
(b) the same problem with all five structure declarations: du = 5 is beyond
    the structured kernels (du <= 4), so ``make_dense_operands`` gives it the
    general operands too;
(c) nine states: ``C3Control(dx=9, du=1, ...)`` on 3^9 nodes, which takes
    the general entries' run-time-d form;
(d) a grid of 33 dims, which no kernel takes.

Bars: after a fixed 20 outer sweeps (tol 0) of dense_vi in both packages,
values within 1e-4 x max|v|; the improve's argmin at the result equal to
JAX's except where JAX's two best right-hand sides lie within 1e-5 relative
of each other (TIE); the kernels' factored arithmetic on the general
operands (candidate_rhs_factored) within 1e-5 of JAX's XLA right-hand side.
"""

from torch_port_testing import TIE, WIDE_SIGMA, double_integrator_du5, nine_states

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3sc_tpu.control import C3Control as JC3Control
from c3sc_tpu.solvers import dense_vi as jax_dense_vi
from c3sc_tpu.solvers.dense import _precompute, neighbor_values
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.ops import dense_backup as db
from c3sc_tpu_torch.solvers import dense_vi

SWEEPS = 20


def _jax_double_integrator_du5():
    """torch_port_testing.double_integrator_du5 in the JAX package."""
    return (JC3Control(dx=2, du=5, dw=2, lb=[-2.0, -2.0], ub=[2.0, 2.0], beta=0.5,
                       ulb=[-0.4] * 5, uub=[0.4] * 5, name="double_integrator_du5")
            .add_drift(lambda x, u: jnp.stack([x[1], jnp.sum(u)]))
            .add_diff(lambda x, u: WIDE_SIGMA * jnp.eye(2))
            .add_stagecost(lambda x, u: jnp.sum(x * x) + 0.1 * jnp.sum(u * u))
            .set_external_boundary(0, "reflect").set_external_boundary(1, "reflect")
            .set_value_bounds(0.0, 50.0)).problem()


def _jax_nine_states():
    """torch_port_testing.nine_states in the JAX package."""
    ctrl = (JC3Control(dx=9, du=1, dw=9, lb=[-1.0] * 9, ub=[1.0] * 9, beta=0.5,
                       name="nine_states")
            .add_drift(lambda x, u: jnp.zeros(9).at[0].set(u[0]) - x)
            .add_diff(lambda x, u: WIDE_SIGMA * jnp.eye(9))
            .add_stagecost(lambda x, u: jnp.sum(x * x) + 0.1 * jnp.sum(u * u))
            .set_value_bounds(0.0, 50.0))
    for j in range(9):
        ctrl.set_external_boundary(j, "reflect")
    return ctrl.problem()


CASES = {
    "du5": (_jax_double_integrator_du5, double_integrator_du5, 21),
    "du5-declared": (_jax_double_integrator_du5, lambda: double_integrator_du5(declared=True),
                     21),
    "nine-states": (_jax_nine_states, nine_states, 3),
}


def _jax_rhs(jp, jg, uc, v):
    """The rhs [C, N] that JAX's make_dense_step improve minimises."""
    x, pp, pm, dt, g, _, _ = _precompute(jp, jg, uc, jnp.float32)
    vp, vm = neighbor_values(jnp.asarray(v), jg)
    return np.asarray(g * dt + jnp.exp(-jp.beta * dt) * (
        jnp.einsum("cnd,nd->cn", pp, vp) + jnp.einsum("cnd,nd->cn", pm, vm)))


@pytest.mark.parametrize("case", list(CASES))
def test_dense_vi_matches_jax(case):
    """(a)-(c): the general operands (also for the declared du = 5 twin,
    whose kernel_args build), dense_vi after 20 sweeps, the argmin."""
    make_j, make_t, n = CASES[case]
    jp, tp = make_j(), make_t()
    assert tp.structured == (case == "du5-declared")
    jg, tg = jp.default_grid(n), tp.default_grid(n)
    uc = jp.control_candidates(3)
    assert uc.shape == ((243, 5) if tp.du == 5 else (3, 1))
    ops = db.make_dense_operands(tp, tg, uc, "cpu")
    assert ops.general and ops.fc_k.shape == (len(uc), tg.ndim, int(np.prod(tg.shape)))
    assert (ops.s2_k is not None, ops.gc is None) == ((case == "du5-declared"),) * 2
    ptrs, scalars = ops.kernel_args
    assert scalars[:2] == (tg.ndim, len(uc))
    want = np.asarray(jax_dense_vi(jp, jg, controls=uc, tol=0.0, max_outer=SWEEPS,
                                   chunk=SWEEPS).v)
    got = dense_vi(tp, tg, controls=uc, tol=0.0, max_outer=SWEEPS, chunk=SWEEPS, device="cpu")
    assert got.sweeps == SWEEPS
    assert np.abs(got.v.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    rhs = _jax_rhs(jp, jg, uc, want)
    top2 = np.sort(rhs, axis=0)[:2]
    near_tie = (top2[1] - top2[0]) <= TIE * np.maximum(1.0, np.abs(top2[0]))
    _, best = db.dense_backup(ops, got.v)
    assert not np.any((best.numpy() != np.argmin(rhs, axis=0)) & ~near_tie)
    factored = db.candidate_rhs_factored(ops, torch.as_tensor(want)).numpy()
    np.testing.assert_allclose(factored, rhs, rtol=1e-5, atol=1e-5)


def test_structured_limits_route_to_the_general_operands():
    """A declared problem within the structured kernels' limits keeps the
    structured operands; beyond them (du > 4 here) it gets the general ones;
    structured operands forced onto such a problem refuse a launch."""
    tp = double_integrator_du5(declared=True)
    four = dataclasses.replace(tp, du=4, ulb=tp.ulb[:4], uub=tp.uub[:4],
                               drift_G=lambda x: tp.drift_G(x)[..., :4])
    assert not db.make_dense_operands(four, four.default_grid(5),
                                      four.control_candidates(3), "cpu").general
    ops = db.make_dense_operands(tp, tp.default_grid(5), tp.control_candidates(3), "cpu")
    assert ops.general
    forced = dataclasses.replace(ops, fc_k=None, f0_k=torch.zeros(2, 25),
                                 G_k=torch.zeros(2, 5, 25))
    with pytest.raises(ValueError, match="du <= 4"):
        forced.kernel_args


def test_33_dims_raise():
    """(d): no kernel takes a grid of more than MAX_D_WIDE = 32 dims (2^33
    nodes at two a dim: 32 GiB of values alone); kernel_args names the limit."""
    tp = nine_states()
    ops = db.make_dense_operands(tp, tp.default_grid(3), tp.control_candidates(3), "cpu")
    assert db.MAX_D_WIDE == 32
    grid = Grid.create([-1.0] * 33, [1.0] * 33, (2,) * 33, (False,) * 33)
    with pytest.raises(ValueError, match="at most 32 dims"):
        dataclasses.replace(ops, grid=grid).kernel_args


def test_runtime_d_switch_is_ignored_on_cpu():
    """The tests' ``_runtime_d`` switch of the general wrappers (and of the
    wide ones) is ignored on CPU tensors: the plain version runs, on the
    glider's four dims and on nine states; a grid of 33 dims still has no
    kernel (``kernel_args`` raises)."""
    from c3sc_tpu_torch import models as tm

    for tp, n in ((tm.make_problem("glider"), (5, 4, 4, 4)), (nine_states(), 3)):
        grid = tp.default_grid(n)
        ops = db.make_dense_operands(tp, grid, tp.control_candidates(3), "cpu")
        v = torch.as_tensor(np.random.default_rng(1).uniform(0, 5, grid.shape), dtype=torch.float32)
        want, wpol = db.dense_backup_reference(ops, v, tp.value_bounds, True, with_policy=True)
        for entry in (db.dense_backup_general, db.wide_dense_backup_general):
            got, pol = entry(ops, v, tp.value_bounds, True, with_policy=True, _runtime_d=True)
            assert torch.equal(got, want) and torch.equal(pol.best, wpol.best)
            assert torch.equal(pol.fpol_k, wpol.fpol_k)
        want_e = db.dense_evaluate_reference(ops, v, wpol)
        for entry in (db.dense_evaluate_general, db.wide_dense_evaluate_general):
            assert torch.equal(entry(ops, v, wpol, _runtime_d=True), want_e)
    grid = Grid.create([-1.0] * 33, [1.0] * 33, (2,) * 33, (False,) * 33)
    with pytest.raises(ValueError, match="at most 32 dims"):
        dataclasses.replace(ops, grid=grid).kernel_args
