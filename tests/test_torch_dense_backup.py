"""Kernel K1 of the port (c3sc_tpu_torch.ops.dense_backup) against the JAX
package: its plain PyTorch version against the Pallas kernel (interpret
mode, as tests/test_pallas_dense.py runs it) and against the XLA sweeps of
c3sc_tpu.solvers.dense.make_dense_step. The CUDA kernel itself runs only on
the card: tests/test_torch_kernels.py holds it against the plain version.
Here its factored arithmetic is held, as the plain PyTorch function
candidate_rhs_factored on the kernel's own operands, against the JAX package.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import QUAD, TIE, V5
from torch_port_testing import random_v as _random_v
from c3sc_tpu import models as jm
from c3sc_tpu.ops.pallas_dense import make_pallas_dense_backup
from c3sc_tpu.solvers.dense import _precompute, make_dense_step, neighbor_values
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import value_from_npz
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.ops import dense_backup as db



def _quad5(v_kind):
    jp, tp = jm.make_problem("quadcopter", **QUAD), tm.make_problem("quadcopter", **QUAD)
    jg, tg = jp.default_grid(5), tp.default_grid(5)
    uc = jp.control_candidates(5)
    v = _random_v(jg.shape) if v_kind == "random" else value_from_npz(V5, "cpu").numpy()
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
    ops = db.make_dense_operands(tp, tg, uc, "cpu")
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
    ops = db.make_dense_operands(tp, tg, uc, "cpu")
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
    ops = db.make_dense_operands(tp, tg, uc, "cpu")
    vnew, best = db.dense_backup(ops, torch.as_tensor(v))
    got = db.dense_evaluate(ops, vnew, best)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_is_plain_version_and_launches_nothing():
    _, tp, _, tg, uc, v = _quad5("random")
    ops = db.make_dense_operands(tp, tg, uc, "cpu")
    before = (db.dense_backup.launches, db.dense_evaluate.launches)
    tv = torch.as_tensor(v)
    got, best = db.dense_backup(ops, tv, clip=tp.value_bounds, pin_input=True)
    want, wbest = db.dense_backup_reference(ops, tv, clip=tp.value_bounds, pin_input=True)
    assert torch.equal(got, want) and torch.equal(best, wbest) and best.dtype == torch.int32
    assert torch.equal(db.dense_evaluate(ops, got, best),
                       db.dense_evaluate_reference(ops, got, best))
    assert (db.dense_backup.launches, db.dense_evaluate.launches) == before


def test_kernel_refuses_what_it_cannot_run():
    """No quiet fallback: operands whose spacing tables do not match their
    grid raise before any launch. A non-uniform grid is no longer refused:
    its operands carry the spacing tables, whose pointer ends the grid
    arguments. A problem without the structure declarations is no longer
    refused either: its operands are the general entries' (per-candidate
    drift, variances and cost), with their own launch arguments."""
    tp = tm.make_problem("pendulum")
    uc = tp.control_candidates(5)
    v = torch.zeros(21 * 21)
    bare = dataclasses.replace(tp, drift_f0=None, drift_G=None, sigma2_x=None,
                               cost_q=None, cost_r=None)
    ops = db.make_dense_operands(bare, tp.default_grid(21), uc, "cpu")
    ptrs, scalars = db._kernel_inputs(ops, v)
    assert ops.general and ptrs[0] == ops.fc_k.data_ptr() and scalars[:2] == (2, len(uc))
    nodes = [np.linspace(-np.pi, np.pi, 21, endpoint=False), np.linspace(-8, 8, 21) ** 3 / 64]
    grid = Grid.create(tp.lb, tp.ub, (21, 21), (True, False), nodes=nodes)
    nu_ops = db.make_dense_operands(tp, grid, uc, "cpu")
    _, nu_scalars = db._kernel_inputs(nu_ops, v)
    assert nu_ops.nu_k.shape == (42, db.SPACING_STRIDE)
    assert nu_scalars[-2] == nu_ops.nu_k.data_ptr() and scalars[-2] == 0
    with pytest.raises(ValueError, match="spacing tables"):
        db._kernel_inputs(dataclasses.replace(nu_ops, nu_k=None), v)
    # and the plain version still serves both on the CPU
    assert torch.isfinite(db.dense_backup(ops, v.reshape(21, 21))[0]).all()


def _factored_case(case):
    """(JAX problem, JAX grid, port operands, candidates, v, clip, pin_input)."""
    if case.startswith("quad"):
        jp, tp, jg, tg, uc, v = _quad5(case.split("-")[1])
        return jp, jg, db.make_dense_operands(tp, tg, uc, "cpu"), uc, v, None, False
    name, n = {"pendulum": ("pendulum", 31), "lq": ("lq", 21)}[case]
    jp, tp = jm.make_problem(name), tm.make_problem(name)
    jg, tg = jp.default_grid(n), tp.default_grid(n)
    uc = jp.control_candidates(5)
    ops = db.make_dense_operands(tp, tg, uc, "cpu")
    return jp, jg, ops, uc, _random_v(jg.shape), tp.value_bounds, True


@pytest.mark.parametrize("case", ["quad-random", "quad-stored", "pendulum", "lq"])
def test_factored_rhs_matches_plain_and_jax(case):
    """The kernel's division-free form of the rhs [C, N], against the plain
    version and against JAX's, to 1e-5; its argmin against JAX's wherever the
    best two candidates are not a near-tie. Pendulum and LQ run under the
    Pallas semantics (clip and pin the input), which JAX's rhs gets here by
    the same clip and pin of v."""
    jp, jg, ops, uc, v, clip, pin = _factored_case(case)
    tv = torch.as_tensor(v)
    got = db.candidate_rhs_factored(ops, tv, clip, pin).numpy()
    assert got.shape == (len(uc), v.size)
    np.testing.assert_allclose(got, db.candidate_rhs(ops, tv, clip, pin).numpy(),
                               rtol=1e-5, atol=1e-5)
    vin = db._input_values(ops, tv, clip, pin).numpy()
    rhs = _jax_rhs(jp, jg, uc, vin)
    np.testing.assert_allclose(got, rhs, rtol=1e-5, atol=1e-5)
    differ = np.argmin(got, axis=0) != np.argmin(rhs, axis=0)
    assert not np.any(differ & ~_near_ties(rhs))


def test_kernel_layout_operands_are_contiguous_transposes():
    """f0_k [d, N], G_k [d, du, N], s2_k [d, N] hold the declarations at the
    nodes, component-major and contiguous; the [N, d] forms are views of them."""
    _, tp, _, tg, uc, _ = _quad5("random")
    ops = db.make_dense_operands(tp, tg, uc, "cpu")
    N, d, du = 5 ** 6, 6, 2
    assert ops.f0_k.shape == (d, N) and ops.G_k.shape == (d, du, N) and ops.s2_k.shape == (d, N)
    for t in (ops.f0_k, ops.G_k, ops.s2_k, ops.q, ops.r, ops.uc, ops.t_mask, ops.t_val):
        assert t.is_contiguous() and t.device.type == "cpu"
    assert torch.equal(ops.f0_k, tp.drift_f0(ops.x).T)
    assert torch.equal(ops.G_k, tp.drift_G(ops.x).permute(1, 2, 0))
    assert torch.equal(ops.s2_k, tp.sigma2_x(ops.x).T)
    assert torch.equal(ops.f0, ops.f0_k.T) and ops.f0.shape == (N, d)
    assert torch.equal(ops.G, ops.G_k.permute(2, 0, 1)) and ops.G.shape == (N, d, du)
    assert torch.equal(ops.s2, ops.s2_k.T) and ops.s2.shape == (N, d)
    assert ops.f0.untyped_storage().data_ptr() == ops.f0_k.untyped_storage().data_ptr()
    # the launch arguments are built once per operands
    assert ops.kernel_args is ops.kernel_args
    assert ops.kernel_args[0][0] == ops.f0_k.data_ptr()
