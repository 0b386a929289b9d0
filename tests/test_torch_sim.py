"""The port's interpolation, implicit policy and rollouts (c3sc_tpu_torch.ops
.interp, c3sc_tpu_torch.sim) against the JAX package, on the CPU.

Euler–Maruyama noise: JAX draws it inside its scan from
``jax.random.split(key, n_steps)``; the test rebuilds that noise and hands
it to the port's ``rollout(noise=...)``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import QUAD, V5
from c3sc_tpu import models as jm
from c3sc_tpu.ops.interp import multilinear_interp as jinterp
from c3sc_tpu.sim import integrators as jint
from c3sc_tpu.sim.policy import make_implicit_policy as jmake_policy
from c3sc_tpu.sim.policy import q_values as jq_values
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import value_from_npz
from c3sc_tpu_torch.ops.interp import multilinear_interp
from c3sc_tpu_torch.sim import (make_implicit_policy, q_values, rollout, trajectory_load,
                                trajectory_save)



def _quad5():
    jp, tp = jm.make_problem("quadcopter", **QUAD), tm.make_problem("quadcopter", **QUAD)
    v = value_from_npz(V5, "cpu")
    return jp, tp, jp.default_grid(5), tp.default_grid(5), v


def _states(prob, n, seed, margin=0.0):
    lb, ub = np.asarray(prob.lb), np.asarray(prob.ub)
    span = ub - lb
    rng = np.random.default_rng(seed)
    return rng.uniform(lb - margin * span, ub + margin * span, (n, prob.dx)).astype(np.float32)


@pytest.mark.parametrize("name", ["quadcopter", "pendulum"])
def test_multilinear_interp_matches_jax(name):
    """Inside and outside the box (clamped bounded dims, wrapped periodic ones)."""
    if name == "quadcopter":
        jp, _, jg, tg, v = _quad5()
        v = v.numpy()
    else:
        jp, tp = jm.make_problem(name), tm.make_problem(name)
        jg, tg = jp.default_grid((16, 11)), tp.default_grid((16, 11))
        v = np.random.default_rng(1).uniform(0, 5, jg.shape).astype(np.float32)
    x = _states(jp, 2000, seed=2, margin=0.2)
    want = np.asarray(jinterp(jg, jnp.asarray(v), jnp.asarray(x)))
    got = multilinear_interp(tg, torch.as_tensor(v), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # exact at the nodes
    nodes = torch.as_tensor(np.stack([m.ravel() for m in tg.meshgrid()], -1), dtype=torch.float32)
    np.testing.assert_allclose(multilinear_interp(tg, torch.as_tensor(v), nodes).numpy(),
                               v.reshape(-1), rtol=1e-6, atol=1e-5)


def test_implicit_policy_matches_jax():
    """Identical controls at 512 states except where the two best candidates
    tie to 1e-5 (relative) under JAX's own Q values."""
    jp, tp, jg, tg, v = _quad5()
    uc = jp.control_candidates(5)
    x = _states(jp, 512, seed=4)
    jvf = lambda p: jinterp(jg, jnp.asarray(v.numpy()), p)
    tvf = lambda p: multilinear_interp(tg, v, p)
    jq = np.asarray(jq_values(jp, jg, jvf, uc, jnp.asarray(x)))
    tq = q_values(tp, tg, tvf, uc, torch.as_tensor(x))
    np.testing.assert_allclose(tq.numpy(), jq, rtol=1e-5, atol=1e-5)
    want = np.asarray(jmake_policy(jp, jg, jvf, uc)(jnp.asarray(x)))
    got = make_implicit_policy(tp, tg, tvf, uc)(torch.as_tensor(x)).numpy()
    top2 = np.sort(jq, axis=-1)[:, :2]
    near_tie = (top2[:, 1] - top2[:, 0]) <= 1e-5 * np.maximum(1.0, np.abs(top2[:, 0]))
    differ = np.any(got != want, axis=-1)
    assert not np.any(differ & ~near_tie)
    assert np.mean(~differ) > 0.95


def _feedback(xp):
    """A smooth hover controller, the same arithmetic in both packages, so
    integrator parity is not clouded by argmin ties."""
    def policy(x):
        hover = 0.5 * 0.5 * 9.81
        tilt = 1.5 * x[..., 2] + 0.4 * x[..., 5] - 0.2 * x[..., 0] - 0.3 * x[..., 3]
        base = hover - 1.0 * x[..., 1] - 0.8 * x[..., 4]
        return xp.stack([xp.clip(base - tilt, 0.0, 6.0), xp.clip(base + tilt, 0.0, 6.0)], -1)
    return policy


def _run_both(method, n_steps, B, policy_every=1, seed=5):
    jp, tp, jg, tg, _ = _quad5()
    x0 = 0.6 * _states(jp, B, seed=seed)
    key = jax.random.key(seed)
    jt = jint.rollout(jp, jg, _feedback(jnp), jnp.asarray(x0), key, dt=0.01, n_steps=n_steps,
                      policy_every=policy_every, method=method)
    keys = jax.random.split(key, n_steps)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, jp.dw), jnp.float32)) for k in keys])
    tt = rollout(tp, tg, _feedback(torch), torch.as_tensor(x0), dt=0.01, n_steps=n_steps,
                 noise=torch.as_tensor(noise), policy_every=policy_every, method=method)
    return jt, tt


@pytest.mark.parametrize("method", ["euler", "rk4", "rkf45"])
def test_deterministic_rollouts_match_jax(method):
    jt, tt = _run_both(method, n_steps=120, B=64, policy_every=3)
    for field in ("xs", "us", "cost", "exit_time"):
        np.testing.assert_allclose(getattr(tt, field).numpy(), np.asarray(getattr(jt, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    np.testing.assert_array_equal(tt.alive.numpy(), np.asarray(jt.alive))


def test_euler_maruyama_matches_jax_with_its_noise():
    """Same per-step noise as JAX's scan; some rollouts exit through the
    absorbing faces, so the exit cost and exit time are exercised."""
    jt, tt = _run_both("euler_maruyama", n_steps=300, B=128)
    alive = np.asarray(jt.alive)
    assert 0 < alive[-1].sum() < alive.shape[1]
    np.testing.assert_array_equal(tt.alive.numpy(), alive)
    for field in ("xs", "us", "cost", "exit_time"):
        np.testing.assert_allclose(getattr(tt, field).numpy(), np.asarray(getattr(jt, field)),
                                   rtol=1e-4, atol=1e-4, err_msg=field)


def test_rollout_generator_and_trajectory_files(tmp_path):
    _, tp, _, tg, _ = _quad5()
    x0 = torch.as_tensor(0.5 * _states(tp, 16, seed=6))
    run = lambda: rollout(tp, tg, _feedback(torch), x0, dt=0.01, n_steps=20,
                          generator=torch.Generator().manual_seed(3))
    a, b = run(), run()
    assert torch.equal(a.xs, b.xs) and a.xs.shape == (21, 16, 6) and a.us.shape == (20, 16, 2)
    with pytest.raises(ValueError):
        rollout(tp, tg, _feedback(torch), x0, dt=0.01, n_steps=20)
    # files written by either package load in the other
    trajectory_save(str(tmp_path / "port.npz"), a)
    back = jint.trajectory_load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back.xs), a.xs.numpy())
    jint.trajectory_save(str(tmp_path / "jax.npz"), back)
    again = trajectory_load(str(tmp_path / "jax.npz"), "cpu")
    for x, y in zip(again, a):
        assert torch.equal(x, y)
