"""The port's dense value iteration (c3sc_tpu_torch.solvers.dense) against
c3sc_tpu.solvers.dense on the CPU, where both sweeps of kernel K1 run their
plain PyTorch version (every call passes device="cpu": the port's default
device is the card).

Bar: max |v_port - v_ref| <= 1e-4 x (value range), far below the
discretisation error and above the float32 residual floor of either solve.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import ART, QUAD
from torch_port_testing import within_range as _within_range
from c3sc_tpu import models as jm
from c3sc_tpu.solvers.dense import _precompute, neighbor_values
from c3sc_tpu.solvers.dense import dense_policy as jdense_policy
from c3sc_tpu.solvers.dense import dense_vi as jdense_vi
from c3sc_tpu.solvers.dense import make_dense_step as jmake_dense_step
import c3sc_tpu_torch
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import value_from_npz
from c3sc_tpu_torch.solvers import dense_policy, dense_vi
from c3sc_tpu_torch.solvers.dense import make_dense_step


@pytest.mark.parametrize("name,n,n_controls", [("pendulum", 31, 9), ("lq", 21, 11)])
def test_dense_vi_matches_jax(name, n, n_controls):
    kw = dict(n_controls=n_controls, tol=1e-5, max_outer=600, chunk=25)
    jsol = jdense_vi(jm.make_problem(name), jm.make_problem(name).default_grid(n), **kw)
    sol = dense_vi(tm.make_problem(name), tm.make_problem(name).default_grid(n), device="cpu",
                   **kw)
    assert sol.v.shape == (n, n) and sol.v.dtype == torch.float32
    assert sol.residual < 1e-5 or sol.floored
    _within_range(sol.v.numpy(), jsol.v)
    assert len(sol.residual_history) == sol.sweeps // 25
    np.testing.assert_array_equal(sol.controls, jsol.controls)


def test_dense_vi_quadcopter_5_matches_stored_oracle():
    """The 6D quadcopter (sigma 0.15, 25 candidates) against the committed
    JAX solve experiments/artifacts/quad_dense_v5.npz."""
    prob = tm.make_problem("quadcopter", **QUAD)
    sol = dense_vi(prob, prob.default_grid(5), controls=prob.control_candidates(5), tol=1e-5,
                   max_outer=3000, chunk=25, eval_sweeps=10, device="cpu")
    assert sol.residual < 1e-5 or sol.floored
    _within_range(sol.v.numpy(),
                  value_from_npz(os.path.join(ART, "quad_dense_v5.npz"), "cpu").numpy())


def test_dense_step_matches_jax():
    """Init value, a chunk of outer sweeps and its residual, from one v0."""
    jp, tp = jm.make_problem("pendulum"), tm.make_problem("pendulum")
    uc = jp.control_candidates(7)
    jstep, jinit = jmake_dense_step(jp, jp.default_grid(15), uc, eval_sweeps=3)
    step, init = make_dense_step(tp, tp.default_grid(15), uc, device="cpu", eval_sweeps=3)
    np.testing.assert_array_equal(init.numpy(), np.asarray(jinit))
    v0 = np.random.default_rng(0).uniform(0, 5, (15, 15)).astype(np.float32)
    jv, jres = jstep(jnp.asarray(v0), 4)
    v, res = step(torch.as_tensor(v0), 4)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(res), float(jres), rtol=1e-3, atol=1e-5)


def test_dense_policy_matches_jax():
    jp, tp = jm.make_problem("pendulum"), tm.make_problem("pendulum")
    jg, tg = jp.default_grid(21), tp.default_grid(21)
    uc = jp.control_candidates(9)
    v = np.array(jdense_vi(jp, jg, controls=uc, tol=1e-4, max_outer=300).v)
    want = np.asarray(jdense_policy(jp, jg, jnp.asarray(v), uc))
    got = dense_policy(tp, tg, v, uc, device="cpu")
    assert got.shape == want.shape == (21, 21, 1)
    # identical but where the best two candidates tie to float rounding
    _, pp, pm, dt, g, _, _ = _precompute(jp, jg, uc, jnp.float32)
    vp, vm = neighbor_values(jnp.asarray(v), jg)
    rhs = np.sort(np.asarray(g * dt + jnp.exp(-jp.beta * dt) * (
        jnp.einsum("cnd,nd->cn", pp, vp) + jnp.einsum("cnd,nd->cn", pm, vm))), axis=0)
    near_tie = (rhs[1] - rhs[0]) <= 1e-5 * np.maximum(1.0, np.abs(rhs[0]))
    differ = (got.numpy() != want).reshape(-1)
    assert not np.any(differ & ~near_tie)


def test_default_device_is_the_card_and_nothing_falls_back_to_the_cpu():
    """``device=None`` means the CUDA device. Without one, torch raises at the
    first allocation and no CPU result comes back."""
    assert c3sc_tpu_torch.default_device() == torch.device("cuda")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal shows only without one")
    prob = tm.make_problem("pendulum")
    with pytest.raises((RuntimeError, AssertionError)):
        dense_vi(prob, prob.default_grid(11), n_controls=3, max_outer=1)
    with pytest.raises((RuntimeError, AssertionError)):
        prob.default_grid(11).node_states()
    with pytest.raises((RuntimeError, AssertionError)):
        value_from_npz(os.path.join(ART, "quad_dense_v5.npz"))
