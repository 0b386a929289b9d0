"""Kernel K1 of the port (c3sc_tpu_torch.ops.dense_backup) against the JAX
package: its plain PyTorch version against the Pallas kernel (interpret
mode, as tests/test_pallas_dense.py runs it) and against the XLA sweeps of
c3sc_tpu.solvers.dense.make_dense_step. The CUDA kernel itself runs only on
the card: tests/test_torch_kernels.py holds it against the plain version.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3sc_tpu import models as jm
from c3sc_tpu.ops.pallas_dense import make_pallas_dense_backup
from c3sc_tpu.solvers.dense import _precompute, make_dense_step, neighbor_values
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import value_from_npz
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.ops import dense_backup as db

QUAD = dict(sigma_v=0.15, sigma_om=0.15)
V5 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "experiments", "artifacts", "quad_dense_v5.npz")
TIE = 1e-5  # argmins may differ only where the two best rhs are this close (relative)


def _random_v(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 5, shape).astype(np.float32)


def _quad5(v_kind):
    jp, tp = jm.make_problem("quadcopter", **QUAD), tm.make_problem("quadcopter", **QUAD)
    jg, tg = jp.default_grid(5), tp.default_grid(5)
    uc = jp.control_candidates(5)
    v = _random_v(jg.shape) if v_kind == "random" else value_from_npz(V5).numpy()
    return jp, tp, jg, tg, uc, v


def _jax_rhs(jp, jg, uc, v):
    """The rhs [C, N] that make_dense_step's improve minimises."""
    x, pp, pm, dt, g, _, _ = _precompute(jp, jg, uc, jnp.float32)
    vp, vm = neighbor_values(jnp.asarray(v), jg)
    return np.asarray(g * dt + jnp.exp(-jp.beta * dt) * (
        jnp.einsum("cnd,nd->cn", pp, vp) + jnp.einsum("cnd,nd->cn", pm, vm)))


def _near_ties(rhs):
    top2 = np.sort(rhs, axis=0)[:2]
    return (top2[1] - top2[0]) <= TIE * np.maximum(1.0, np.abs(top2[0]))


@pytest.mark.parametrize("name,n", [("pendulum", 31), ("lq", 21)])
def test_plain_matches_pallas_interpret(name, n):
    """Pallas semantics: clip to value_bounds and pin terminals, in and out."""
    jp, tp = jm.make_problem(name), tm.make_problem(name)
    jg, tg = jp.default_grid(n), tp.default_grid(n)
    uc = jp.control_candidates(5)
    v = _random_v(jg.shape)
    want = np.asarray(make_pallas_dense_backup(jp, jg, uc, interpret=True)(jnp.asarray(v)))
    ops = db.make_dense_operands(tp, tg, uc)
    got, _ = db.dense_backup(ops, torch.as_tensor(v), clip=tp.value_bounds, pin_input=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("v_kind", ["random", "stored"])
def test_plain_matches_xla_improve(v_kind):
    """dense_vi semantics (no clip, no input pin) on the quadcopter 5^6 with 25
    candidates: the value of JAX's improve sweep to 1e-5 relative, and the
    argmin wherever the best two candidates are not a near-tie."""
    jp, tp, jg, tg, uc, v = _quad5(v_kind)
    step, _ = make_dense_step(jp, jg, uc, eval_sweeps=0)
    want, _ = step(jnp.asarray(v), 1)
    ops = db.make_dense_operands(tp, tg, uc)
    got, best = db.dense_backup(ops, torch.as_tensor(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    rhs = _jax_rhs(jp, jg, uc, v)
    differ = best.numpy() != np.argmin(rhs, axis=0)
    assert not np.any(differ & ~_near_ties(rhs))
    np.testing.assert_allclose(db.candidate_rhs(ops, torch.as_tensor(v)).numpy(), rhs,
                               rtol=1e-5, atol=1e-5)


def test_plain_evaluate_matches_xla():
    """One improve + one fixed-policy evaluate sweep against JAX's outer step."""
    jp, tp, jg, tg, uc, v = _quad5("random")
    step, _ = make_dense_step(jp, jg, uc, eval_sweeps=1)
    want, _ = step(jnp.asarray(v), 1)
    ops = db.make_dense_operands(tp, tg, uc)
    vnew, best = db.dense_backup(ops, torch.as_tensor(v))
    got = db.dense_evaluate(ops, vnew, best)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_is_plain_version_and_launches_nothing():
    _, tp, _, tg, uc, v = _quad5("random")
    ops = db.make_dense_operands(tp, tg, uc)
    before = (db.dense_backup.launches, db.dense_evaluate.launches)
    tv = torch.as_tensor(v)
    got, best = db.dense_backup(ops, tv, clip=tp.value_bounds, pin_input=True)
    want, wbest = db.dense_backup_reference(ops, tv, clip=tp.value_bounds, pin_input=True)
    assert torch.equal(got, want) and torch.equal(best, wbest) and best.dtype == torch.int32
    assert torch.equal(db.dense_evaluate(ops, got, best),
                       db.dense_evaluate_reference(ops, got, best))
    assert (db.dense_backup.launches, db.dense_evaluate.launches) == before


def test_kernel_refuses_what_it_cannot_run():
    """No quiet fallback: a problem without the structure declarations or a
    non-uniform grid raises before any launch."""
    tp = tm.make_problem("pendulum")
    uc = tp.control_candidates(5)
    v = torch.zeros(21 * 21)
    bare = dataclasses.replace(tp, drift_f0=None, drift_G=None, sigma2_x=None,
                               cost_q=None, cost_r=None)
    ops = db.make_dense_operands(bare, tp.default_grid(21), uc)
    with pytest.raises(NotImplementedError, match="structure"):
        db._kernel_inputs(ops, v)
    nodes = [np.linspace(-np.pi, np.pi, 21, endpoint=False), np.linspace(-8, 8, 21) ** 3 / 64]
    grid = Grid.create(tp.lb, tp.ub, (21, 21), (True, False), nodes=nodes)
    with pytest.raises(NotImplementedError, match="uniform"):
        db._kernel_inputs(db.make_dense_operands(tp, grid, uc), v)
    # and the plain version still serves both on the CPU
    assert torch.isfinite(db.dense_backup(ops, v.reshape(21, 21))[0]).all()
