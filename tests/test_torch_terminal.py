"""The port's terminal LQR (c3sc_tpu_torch.sim.terminal) and the dual-mode
latch of its receding-horizon MPC (``receding_horizon_rollout(...,
terminal_lqr=...)``) against the JAX package on the CPU, on
tests/test_terminal.py's quadcopter, every call on device "cpu".

The checks of tests/test_terminal.py (a)-(c) on the port: the hover thrust,
the gains stabilising the linearised plant, the nonlinear plant regulated
over 600 steps. Then parity: the gains within 1e-5 relative of JAX's, the
terminal mode's action on a batch of 16 within 1e-5 with the same basin
membership, and a latched rollout under JAX's noise (rebuilt from its key
as tests/test_torch_mpc_shoot.py does) with its states within 1e-4, costs
within 1e-5 relative and the same survival.
"""

import torch_port_testing  # noqa: F401  (pins torch to one thread first)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev

from c3sc_tpu.models import make_quadcopter_problem as j_quadcopter
from c3sc_tpu.sim.mpc_shoot import receding_horizon_rollout as j_rollout
from c3sc_tpu.sim.terminal import make_terminal_lqr as j_make_terminal_lqr
from c3sc_tpu.sim.terminal import terminal_control as j_terminal_control
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.sim import TerminalLQR, make_terminal_lqr
from c3sc_tpu_torch.sim.mpc_shoot import receding_horizon_rollout
from c3sc_tpu_torch.sim.terminal import terminal_control

SCALE = np.asarray([2.0, 2.0, 1.0, 3.0, 3.0, 4.0])   # tests/test_terminal.py's


@pytest.fixture(scope="module")
def quad():
    kw = dict(sigma_v=0.15, sigma_om=0.15)
    jp, tp = j_quadcopter(**kw), tm.make_quadcopter_problem(**kw)
    return jp, tp, j_make_terminal_lqr(jp, dt=0.01), make_terminal_lqr(tp, dt=0.01, device="cpu")


def _box(tp):
    return (torch.as_tensor(tp.ulb, dtype=torch.float32),
            torch.as_tensor(tp.uub, dtype=torch.float32))


def test_equilibrium_is_hover(quad):
    _, tp, _, tl = quad
    assert isinstance(tl, TerminalLQR) and tl.K.shape == (2, 6) and tl.K.dtype == torch.float32
    hover = 0.5 * 0.5 * 9.81   # mass * g / 2 a rotor
    np.testing.assert_allclose(tl.u_eq.numpy(), [hover, hover], rtol=1e-5)
    assert tp.drift(tl.x_eq[None], tl.u_eq[None]).abs().max() < 1e-5


def test_gains_stabilize_linearization(quad):
    _, tp, _, tl = quad
    drift = lambda x, u: tp.drift(x[None], u[None])[0]   # noqa: E731
    A = jacrev(drift, argnums=0)(tl.x_eq, tl.u_eq).double().numpy()
    B = jacrev(drift, argnums=1)(tl.x_eq, tl.u_eq).double().numpy()
    Ad, Bd = np.eye(tp.dx) + 0.01 * A, 0.01 * B
    rho = np.abs(np.linalg.eigvals(Ad - Bd @ tl.K.double().numpy())).max()
    assert rho < 1.0, rho


def test_regulates_nonlinear_plant(quad):
    _, tp, _, tl = quad
    ulb, uub = _box(tp)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(0.25 * rng.uniform(-1, 1, (16, 6)) * SCALE, dtype=torch.float32)
    x = x0
    for _ in range(600):
        u, _ = terminal_control(tl, x, ulb, uub)
        x = x + 0.01 * tp.drift(x, u)
    r0 = np.linalg.norm(x0.numpy() / SCALE, axis=-1)
    rT = np.linalg.norm(x.numpy() / SCALE, axis=-1)
    assert rT.max() < 0.02, (r0.max(), rT.max())


def test_gains_match_jax(quad):
    _, _, jt, tl = quad
    for got, want in ((tl.x_eq, jt.x_eq), (tl.u_eq, jt.u_eq), (tl.K, jt.K),
                      (tl.scale, jt.scale)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(want)).max())
    assert tl.radius == jt.radius


def test_terminal_control_matches_jax(quad):
    jp, tp, jt, tl = quad
    x = (0.4 * np.random.default_rng(3).uniform(-1, 1, (16, 6)) * SCALE).astype(np.float32)
    ju, jin = j_terminal_control(jt, jnp.asarray(x), jnp.asarray(jp.ulb, jnp.float32),
                                 jnp.asarray(jp.uub, jnp.float32))
    u, inside = terminal_control(tl, torch.as_tensor(x), *_box(tp))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(jin))
    assert 0 < int(inside.sum()) < 16


def test_latched_rollout_matches_jax(quad):
    """iLQR receding-horizon MPC with the latch on tests/test_terminal.py's
    value, tilted in altitude: 8 samples, the first 4 inside the basin at
    the start, 40 plant steps, horizon 16, 2 iLQR iterations a replan every 4
    steps, greedy re-seeding from 25 candidates."""
    jp, tp, jt, tl = quad
    rng = np.random.default_rng(5)
    x0 = np.concatenate([0.1 * rng.uniform(-1, 1, (4, 6)),
                         0.3 * rng.uniform(0.5, 1, (4, 6)) * rng.choice([-1, 1], (4, 6))])
    x0 = (x0 * SCALE).astype(np.float32)
    inside = np.linalg.norm(x0 / SCALE, axis=-1) < tl.radius
    assert inside.tolist() == [True] * 4 + [False] * 4
    jscale, tscale = jnp.asarray(SCALE, jnp.float32), torch.as_tensor(SCALE, dtype=torch.float32)

    def jvf(p):
        z = p / jscale
        return 8.0 * jnp.sum(z * z, axis=-1) + 1.5 * z[..., 1]

    def tvf(p):
        z = p / tscale
        return 8.0 * torch.sum(z * z, dim=-1) + 1.5 * z[..., 1]

    n_steps, key = 40, jax.random.key(7)
    noise = np.stack([np.asarray(jax.random.normal(k, (8, jp.dw), jnp.float32))
                      for k in jax.random.split(key, n_steps)])
    grid_j, grid_t = jp.default_grid(9), tp.default_grid(9)
    kw = dict(dt=0.01, n_steps=n_steps, horizon=16, replan_every=4, opt_iters=2,
              controls=jp.control_candidates(5))
    want = j_rollout(jp, grid_j, jvf, jnp.asarray(x0), key, terminal_lqr=jt, **kw)
    got = receding_horizon_rollout(tp, grid_t, tvf, torch.as_tensor(x0),
                                   noise=torch.as_tensor(noise), terminal_lqr=tl, **kw)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-5)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    # the latch took the samples that started inside the basin at the first step
    u_lqr, _ = terminal_control(tl, torch.as_tensor(x0), *_box(tp))
    assert torch.equal(got.us[0, :4], u_lqr[:4])
    assert not torch.equal(got.us[0, 4:], u_lqr[4:])
