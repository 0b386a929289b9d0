"""The whole ported slice against the JAX package on the CPU: pendulum 31^2,
dense solve -> implicit policy on the interpolated value -> 64 x 200
Euler–Maruyama rollouts under the same noise, as the CLI's dense branch
runs it. Bar: mean cost within 1e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from c3sc_tpu import models as jm
from c3sc_tpu.ops.interp import multilinear_interp as jinterp
from c3sc_tpu.sim import make_implicit_policy as jmake_policy
from c3sc_tpu.sim import rollout as jrollout
from c3sc_tpu.solvers import dense_vi as jdense_vi
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import grid_from_numpy, value_from_npz
from c3sc_tpu_torch.ops.interp import multilinear_interp
from c3sc_tpu_torch.sim import make_implicit_policy, rollout
from c3sc_tpu_torch.solvers import dense_vi

N_ROLLOUTS, N_STEPS, DT, SEED = 64, 200, 0.01, 0


def test_pendulum_slice_matches_jax(tmp_path):
    jp, tp = jm.make_problem("pendulum"), tm.make_problem("pendulum")
    jg = jp.default_grid(31)
    tg = grid_from_numpy(jg.lb, jg.ub, jg.shape, jg.periodic, jg.nodes_override)
    uc = jp.control_candidates(9)
    jsol = jdense_vi(jp, jg, controls=uc, tol=1e-5, max_outer=600)
    sol = dense_vi(tp, tg, controls=uc, tol=1e-5, max_outer=600, device="cpu")
    # the value crosses over as the CLI stores it
    np.savez(tmp_path / "vf.npz", v=np.asarray(jsol.v))
    jv = value_from_npz(str(tmp_path / "vf.npz"), "cpu")
    assert jv.shape == sol.v.shape
    np.testing.assert_allclose(sol.v.numpy(), jv.numpy(), atol=1e-4 * float(jv.max() - jv.min()))

    # x0 as the CLI draws it; JAX's per-step noise, rebuilt for the port
    rng = np.random.default_rng(SEED)
    lb, ub = np.asarray(jp.lb), np.asarray(jp.ub)
    x0 = ((lb + ub) / 2 + 0.5 * (ub - lb) / 2 * rng.uniform(-1, 1, (N_ROLLOUTS, 2)))
    x0 = x0.astype(np.float32)
    key = jax.random.key(SEED + 1)
    jpolicy = jmake_policy(jp, jg, lambda p: jinterp(jg, jsol.v, p), uc)
    jtraj = jax.jit(lambda x, k: jrollout(jp, jg, jpolicy, x, k, DT, N_STEPS))(
        jnp.asarray(x0), key)
    noise = np.stack([np.asarray(jax.random.normal(k, (N_ROLLOUTS, 1), jnp.float32))
                      for k in jax.random.split(key, N_STEPS)])
    policy = make_implicit_policy(tp, tg, lambda p: multilinear_interp(tg, sol.v, p), uc)
    traj = rollout(tp, tg, policy, torch.as_tensor(x0), DT, N_STEPS,
                   noise=torch.as_tensor(noise))

    assert traj.xs.shape == (N_STEPS + 1, N_ROLLOUTS, 2) and torch.isfinite(traj.xs).all()
    want = float(np.mean(np.asarray(jtraj.cost)))
    got = float(traj.cost.mean())
    assert abs(got - want) <= 1e-3 * abs(want), (got, want)
