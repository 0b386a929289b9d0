"""The port's receding-horizon MPC (c3sc_tpu_torch.sim.mpc_shoot) and iLQR
planner (c3sc_tpu_torch.sim.ilqr) against the JAX package on the CPU, on
``tests/test_mpc_shoot.py``'s pendulum 41^2, every call on device "cpu".

Plant noise: JAX draws it inside its scan from ``jax.random.split(key,
n_steps)``; the test rebuilds that noise and hands it to the port's
``receding_horizon_rollout(noise=...)``, as ``tests/test_torch_sim.py`` does
for ``rollout``. Where the JAX package differentiates with ``jax.jacfwd`` /
``jax.grad``, the port uses ``torch.func`` and ``torch.autograd``.

Bars: planned controls within 1e-4 (the control range is 8), objectives
within 1e-5 relative; closed-loop states within 1e-4, costs within 1e-5
relative, and the same survival.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3sc_tpu import models as jm
from c3sc_tpu.ops.interp import multilinear_interp as j_interp
from c3sc_tpu.sim import mpc_shoot as jms
from c3sc_tpu.sim.ilqr import make_ilqr_plan as j_ilqr
from c3sc_tpu.sim.policy import make_implicit_policy as j_policy
from c3sc_tpu.solvers.dense import dense_vi as j_dense_vi
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.ops.interp import multilinear_interp
from c3sc_tpu_torch.sim import mpc_shoot as tms
from c3sc_tpu_torch.sim.ilqr import make_ilqr_plan
from c3sc_tpu_torch.sim.policy import make_implicit_policy

B, DT = 12, 0.01


@pytest.fixture(scope="module")
def pendulum41():
    """The dense pendulum 41^2 solve (9 candidates) and swing-up starts near
    the bottom, as in tests/test_mpc_shoot.py."""
    jp, tp = jm.make_problem("pendulum"), tm.make_problem("pendulum")
    jg, tg = jp.default_grid(41), tp.default_grid(41)
    uc = jp.control_candidates(9)
    v = np.array(j_dense_vi(jp, jg, controls=uc, tol=1e-5, max_outer=3000).v)
    rng = np.random.default_rng(1)
    x0 = np.stack([np.pi - 0.05 + 0.1 * rng.standard_normal(B),
                   0.2 * rng.standard_normal(B)], -1).astype(np.float32)
    jvf = lambda p: j_interp(jg, jnp.asarray(v), p)  # noqa: E731
    tvf = lambda p: multilinear_interp(tg, torch.as_tensor(v), p)  # noqa: E731
    return jp, tp, jg, tg, uc, jvf, tvf, x0


def test_ilqr_plan_matches_jax(pendulum41):
    """Five iLQR iterations over a 32-step horizon from a random control
    sequence (some steps at the control bounds)."""
    jp, tp, jg, tg, uc, jvf, tvf, x0 = pendulum41
    u0 = np.clip(3.0 * np.random.default_rng(2).standard_normal((B, 32, 1)), -4, 4)
    u0 = u0.astype(np.float32)
    jplan, jobj = j_ilqr(jp, jvf, DT, 32, n_iters=5)
    tplan, tobj = make_ilqr_plan(tp, tvf, DT, 32, n_iters=5)
    want = np.asarray(jax.jit(jplan)(jnp.asarray(x0), jnp.asarray(u0)))
    with torch.no_grad():
        got = tplan(torch.as_tensor(x0), torch.as_tensor(u0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    jJ = np.asarray(jobj(jnp.asarray(want), jnp.asarray(x0)))
    np.testing.assert_allclose(tobj(got, torch.as_tensor(x0)).numpy(), jJ, rtol=1e-5)
    assert np.all(jJ <= np.asarray(jobj(jnp.asarray(u0), jnp.asarray(x0))))   # monotone


def test_shooting_plan_matches_jax(pendulum41):
    jp, tp, jg, tg, uc, jvf, tvf, x0 = pendulum41
    u0 = np.zeros((B, 24, 1), np.float32)
    jplan, jobj = jms.make_plan_fn(jp, jvf, DT, 24, opt_iters=6, lr=0.3)
    tplan, tobj = tms.make_plan_fn(tp, tvf, DT, 24, opt_iters=6, lr=0.3)
    want = np.asarray(jax.jit(jplan)(jnp.asarray(x0), jnp.asarray(u0)))
    with torch.no_grad():
        got = tplan(torch.as_tensor(x0), torch.as_tensor(u0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tobj(got, torch.as_tensor(x0)).numpy(),
                               np.asarray(jobj(jnp.asarray(want), jnp.asarray(x0))), rtol=1e-5)


def test_greedy_useq_matches_jax(pendulum41):
    jp, tp, jg, tg, uc, jvf, tvf, x0 = pendulum41
    want = np.asarray(jms._greedy_useq(jp, jg, j_policy(jp, jg, jvf, uc), jnp.asarray(x0),
                                       DT, 20))
    got = tms._greedy_useq(tp, tg, make_implicit_policy(tp, tg, tvf, uc), torch.as_tensor(x0),
                           DT, 20)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("planner", ["ilqr", "shooting"])
def test_receding_horizon_rollout_matches_jax(pendulum41, planner):
    """40 plant steps, a replan every 4 with greedy re-seeding, JAX's noise."""
    jp, tp, jg, tg, uc, jvf, tvf, x0 = pendulum41
    n_steps, key = 40, jax.random.key(3)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, jp.dw), jnp.float32))
                      for k in jax.random.split(key, n_steps)])
    kw = dict(dt=DT, n_steps=n_steps, horizon=24, replan_every=4, opt_iters=3, lr=0.3,
              controls=uc, planner=planner)
    want = jms.receding_horizon_rollout(jp, jg, jvf, jnp.asarray(x0), key, **kw)
    got = tms.receding_horizon_rollout(tp, tg, tvf, torch.as_tensor(x0),
                                       noise=torch.as_tensor(noise), **kw)
    assert got.xs.shape == (n_steps + 1, B, 2) and got.us.shape == (n_steps, B, 1)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-5)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))


def test_terminal_lqr_defaults_to_pure_mpc(pendulum41):
    """The dual-mode latch is off by default, as in the JAX package:
    ``terminal_lqr`` exists and defaults to None, and with None the rollout
    is bit-equal to one that omits it."""
    jp, tp, jg, tg, uc, jvf, tvf, x0 = pendulum41
    for fn in (tms.receding_horizon_rollout, tms._rh_rollout, jms.receding_horizon_rollout):
        assert inspect.signature(fn).parameters["terminal_lqr"].default is None
    noise = torch.as_tensor(np.random.default_rng(4).standard_normal((12, B, 1)),
                            dtype=torch.float32)
    kw = dict(dt=DT, n_steps=12, horizon=8, replan_every=4, opt_iters=2, controls=uc,
              noise=noise)
    omitted = tms.receding_horizon_rollout(tp, tg, tvf, torch.as_tensor(x0), **kw)
    off = tms.receding_horizon_rollout(tp, tg, tvf, torch.as_tensor(x0), terminal_lqr=None, **kw)
    for a, b in zip(omitted, off):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tms.receding_horizon_rollout(tm.make_problem("pendulum"), None, None,
                                     torch.zeros(2, 2), 0.01, 3, planner="adam",
                                     generator=torch.Generator())
