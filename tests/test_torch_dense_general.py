"""Kernel K1's general entries (c3sc_tpu_torch.ops.dense_backup:
dense_backup_general, dense_evaluate_general) for problems without the
structure declarations, against the JAX package on the same numpy inputs:
their plain version against the Pallas kernel (interpret mode) and against
the XLA sweeps of c3sc_tpu.solvers.dense; the kernels' factored arithmetic
on the general operands (candidate_rhs_factored) against both; dense_vi of
the three new models against JAX's; a fused glider solve against the port's
own dense solve. The CUDA kernels run only on the card
(tests/test_torch_kernels.py).

Tolerances: one sweep 2e-4 against the Pallas kernel (its own test's bar)
and 1e-5 against the XLA sweeps (float32 rounding of a ten-term stencil);
argmins equal wherever the two best candidates are not a near-tie (TIE);
dense_vi within 1e-4 x the value range of JAX's (both converge to 1e-5 in
float32); the fused glider at rank 8 (deliberately under-resolved, as in
JAX's smoke test, which asks only for a finite value and adapted ranks)
within q95 0.15 of max|v_dense|: seeds 0-3 give 0.075-0.100 on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import QUAD, TIE, random_v
from c3sc_tpu import models as jm
from c3sc_tpu.ops.pallas_dense import make_pallas_dense_backup
from c3sc_tpu.solvers import dense_vi as jax_dense_vi
from c3sc_tpu.solvers.dense import _precompute, make_dense_step, neighbor_values
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.ops import dense_backup as db
from c3sc_tpu_torch.solvers import dense_vi


def _bare(prob):
    return dataclasses.replace(prob, drift_f0=None, drift_G=None, sigma2_x=None, cost_q=None,
                               cost_r=None)


def _jax_rhs(jp, jg, uc, v):
    """The rhs [C, N] that make_dense_step's improve minimises."""
    x, pp, pm, dt, g, _, _ = _precompute(jp, jg, uc, jnp.float32)
    vp, vm = neighbor_values(jnp.asarray(v), jg)
    return np.asarray(g * dt + jnp.exp(-jp.beta * dt) * (
        jnp.einsum("cnd,nd->cn", pp, vp) + jnp.einsum("cnd,nd->cn", pm, vm)))


def _near_ties(rhs):
    top2 = np.sort(rhs, axis=0)[:2]
    return (top2[1] - top2[0]) <= TIE * np.maximum(1.0, np.abs(top2[0]))


@pytest.mark.parametrize("name,n", [("pendulum", 21), ("dubins", (9, 9, 8))], ids=["pendulum", "dubins"])
def test_general_plain_matches_pallas_interpret(name, n):
    """Pallas semantics (clip to value_bounds, pin terminals in and out) on
    the problem stripped of every declaration: the wrapper's plain version
    and the kernels' factored form on the general operands (per-candidate
    drift, variances and cost) against the Pallas kernel."""
    jp, tp = jm.make_problem(name), _bare(tm.make_problem(name))
    jg, tg = jp.default_grid(n), tp.default_grid(n)
    uc = jp.control_candidates(5)
    v = random_v(jg.shape)
    want = np.asarray(make_pallas_dense_backup(jp, jg, uc, interpret=True)(jnp.asarray(v)))
    ops = db.make_dense_operands(tp, tg, uc, "cpu")
    assert ops.general and ops.s2c_k is not None and ops.gc is not None
    got, _ = db.dense_backup_general(ops, torch.as_tensor(v), clip=tp.value_bounds,
                                     pin_input=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    rhs = db.candidate_rhs_factored(ops, torch.as_tensor(v), tp.value_bounds, True)
    vnew = torch.clamp(rhs.min(0).values, *tp.value_bounds)
    vnew = torch.where(ops.t_mask, ops.t_val, vnew).reshape(tg.shape)
    np.testing.assert_allclose(vnew.numpy(), want, rtol=2e-4, atol=2e-4)


def _glider(n=(7, 5, 5, 5), per_dim=5):
    jp, tp = jm.make_problem("glider"), tm.make_problem("glider")
    jg, tg = jp.default_grid(n), tp.default_grid(n)
    uc = jp.control_candidates(per_dim)
    return jp, tp, jg, tg, uc, random_v(jg.shape)


def test_glider_sweeps_match_xla():
    """The glider (its drift undeclared, its variances and cost declared) at
    (7, 5, 5, 5) with 5 candidates: improve against JAX's improve sweep, one
    improve + one evaluate against JAX's outer step, the factored rhs
    against JAX's [C, N] rhs, argmins off near-ties."""
    jp, tp, jg, tg, uc, v = _glider()
    ops = db.make_dense_operands(tp, tg, uc, "cpu")
    assert ops.general and ops.s2_k is not None and ops.q is not None and ops.gc is None
    tv = torch.as_tensor(v)
    step0, _ = make_dense_step(jp, jg, uc, eval_sweeps=0)
    step1, _ = make_dense_step(jp, jg, uc, eval_sweeps=1)
    got, best = db.dense_backup_general(ops, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(step0(jnp.asarray(v), 1)[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(db.dense_evaluate_general(ops, got, best).numpy(),
                               np.asarray(step1(jnp.asarray(v), 1)[0]), rtol=1e-5, atol=1e-5)
    rhs = _jax_rhs(jp, jg, uc, v)
    fact = db.candidate_rhs_factored(ops, tv).numpy()
    np.testing.assert_allclose(fact, rhs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(db.candidate_rhs(ops, tv).numpy(), rhs, rtol=1e-5, atol=1e-5)
    for mine in (best.numpy(), np.argmin(fact, axis=0)):
        assert not np.any((mine != np.argmin(rhs, axis=0)) & ~_near_ties(rhs))


def test_general_operands_layout():
    """fc_k [C, d, N] holds the drift of every candidate at every node,
    candidate-major and contiguous, whatever the chunk of candidates it was
    evaluated in; s2c_k and gc exist only where their declarations do not;
    the launch arguments carry null pointers for what is absent."""
    jp, tp, jg, tg, uc, _ = _glider(per_dim=7)
    ops = db.make_dense_operands(tp, tg, uc, "cpu")
    C, (N, d) = len(uc), ops.x.shape
    assert ops.fc_k.shape == (C, d, N) and ops.fc_k.is_contiguous()
    want = tp.drift(ops.x[None], ops.uc[:, None]).transpose(1, 2)
    assert torch.equal(ops.fc_k, want)
    assert (ops.f0_k, ops.G_k, ops.s2c_k, ops.gc) == (None, None, None, None)
    one = db._general_operands(tp, ops.x, ops.uc, chunk_elems=N)      # a candidate a chunk
    assert torch.equal(one["fc_k"], ops.fc_k)
    bare = db.make_dense_operands(_bare(tp), tg, uc, "cpu")
    assert bare.s2c_k.shape == (C, d, N) and bare.gc.shape == (C, N)
    assert torch.equal(bare.s2c_k, tp.sigma2_diag(ops.x[None], ops.uc[:, None]).transpose(1, 2))
    assert torch.equal(bare.gc, tp.stage_cost(ops.x[None], ops.uc[:, None]))
    ptrs, scalars = bare.kernel_args
    assert ptrs[0] == bare.fc_k.data_ptr() and ptrs[1] == 0 and ptrs[3:5] == (0, 0)
    assert scalars[:2] == (d, C)
    ptrs, _ = ops.kernel_args
    assert ptrs[1] == ops.s2_k.data_ptr() and ptrs[2] == 0 and ptrs[5] == 0


def test_general_wrappers_on_the_cpu_are_the_plain_version():
    """On CPU tensors the general entries run the plain version and launch
    nothing; dense_backup and dense_evaluate route general operands the same
    way."""
    _, tp, _, tg, uc, v = _glider()
    ops = db.make_dense_operands(tp, tg, uc, "cpu")
    tv = torch.as_tensor(v)
    before = (db.dense_backup_general.launches, db.dense_evaluate_general.launches)
    got, best = db.dense_backup_general(ops, tv, clip=tp.value_bounds, pin_input=True)
    want, wbest = db.dense_backup_reference(ops, tv, clip=tp.value_bounds, pin_input=True)
    assert torch.equal(got, want) and torch.equal(best, wbest) and best.dtype == torch.int32
    assert torch.equal(db.dense_backup(ops, tv)[0], db.dense_backup_reference(ops, tv)[0])
    assert torch.equal(db.dense_evaluate_general(ops, got, best),
                       db.dense_evaluate(ops, got, best))
    assert (db.dense_backup_general.launches, db.dense_evaluate_general.launches) == before


@pytest.mark.parametrize("name,kw,n,per_dim", [
    ("glider", {}, (7, 5, 5, 5), 5),
    ("dubins", dict(beta=0.5), (9, 9, 8), 5),
    ("quadcopter7", QUAD, 4, 3),
], ids=["glider", "dubins", "quadcopter7"])
def test_dense_vi_matches_jax(name, kw, n, per_dim):
    jp, tp = jm.make_problem(name, **kw), tm.make_problem(name, **kw)
    jg, tg = jp.default_grid(n), tp.default_grid(n)
    uc = jp.control_candidates(per_dim)
    want = jax_dense_vi(jp, jg, controls=uc, tol=1e-5, max_outer=1000, chunk=50)
    got = dense_vi(tp, tg, controls=uc, tol=1e-5, max_outer=1000, chunk=50, device="cpu")
    assert got.v.shape == tg.shape and torch.isfinite(got.v).all()
    ref = np.asarray(want.v)
    assert np.abs(got.v.numpy() - ref).max() <= 1e-4 * (ref.max() - ref.min())


def test_glider_fused_solve_against_own_dense():
    """A fused glider solve (rank 8, the JAX smoke test's settings and seed)
    on (11, 9, 9, 9): the transition of every candidate goes through
    transition_all_controls's per-candidate branch. Its value is finite, its
    ranks adapt beyond 1, and at every node |v_tt - v_dense| / max|v_dense|
    has q95 under 0.15."""
    from c3sc_tpu_torch.ops.tt import tt_gather_eval
    from c3sc_tpu_torch.solvers import fused_tt_vi

    tp = tm.make_problem("glider")
    grid = tp.default_grid((11, 9, 9, 9))
    uc = tp.control_candidates(5)
    sol = fused_tt_vi(tp, grid, controls=uc, rmax=8, seed=2, tol=1e-3, max_iters=200,
                      patience=60, device="cpu")
    dense = dense_vi(tp, grid, controls=uc, tol=1e-5, max_outer=2000, chunk=100, device="cpu")
    v_tt = tt_gather_eval(sol.v, grid.node_indices("cpu"))
    assert torch.isfinite(v_tt).all() and int(sol.v.ranks.max()) > 1
    err = (v_tt - dense.v.reshape(-1)).abs() / dense.v.abs().max()
    assert torch.quantile(err, 0.95).item() < 0.15
