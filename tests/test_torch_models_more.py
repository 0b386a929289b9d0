"""Parity of the port's Dubins car, perching glider and 7D quadcopter
(c3sc_tpu_torch.models) with the JAX package: the same numpy inputs through
both, float32 on the CPU; and the 7D model's fused-solve smoke test.

Tolerance: rtol 1e-6 with atol 1e-6 (a few float32 ulps, for the two
libraries' own sin/cos and summation order), as tests/test_torch_models.py.
Derivatives (the glider's kink, iLQR's per-sample Jacobians of the 7D
drift) to rtol 1e-5, atol 1e-5: float32 chains of a few operations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import QUAD, close
from c3sc_tpu import models as jm
from c3sc_tpu.ops import mca as jmca
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.ops import mca as tmca

PROBLEMS = [("dubins", {}), ("dubins", dict(beta=0.5, with_obstacles=False)),
            ("glider", {}), ("quadcopter7", QUAD), ("quadcopter7", dict(wind_sigma=0.3))]
IDS = ["dubins", "dubins-no-obstacles", "glider", "quadcopter7", "quadcopter7-wind"]
TOL = dict(rtol=1e-6, atol=1e-6)
DECLARATIONS = ("drift_f0", "drift_G", "sigma2_x", "cost_q", "cost_r")


def _pair(name, kw):
    return jm.make_problem(name, **kw), tm.make_problem(name, **kw)


def _samples(prob, n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(prob.lb, prob.ub, (n, prob.dx)).astype(np.float32)
    u = rng.uniform(prob.ulb, prob.uub, (n, prob.du)).astype(np.float32)
    return x, u


@pytest.mark.parametrize("name,kw", PROBLEMS, ids=IDS)
def test_callables_match_jax(name, kw):
    jp, tp = _pair(name, kw)
    x, u = _samples(jp)
    jx, ju, tx, tu = jnp.asarray(x), jnp.asarray(u), torch.as_tensor(x), torch.as_tensor(u)
    for field in ("drift", "diff", "sigma2_diag", "stage_cost"):
        got = getattr(tp, field)(tx, tu)
        want = jax.vmap(getattr(jp, field))(jx, ju)
        assert tuple(got.shape) == want.shape, field
        close(got, want, **TOL)
    exit_cost = tp.boundary_cost(tx)
    assert exit_cost.shape == (len(x),)
    close(exit_cost, jax.vmap(jp.boundary_cost)(jx), **TOL)
    # the callables broadcast a state batch against a candidate batch
    C = 3
    assert tp.drift(tx[None], tu[:C, None]).shape == (C, len(x), tp.dx)
    assert tp.stage_cost(tx[None], tu[:C, None]).shape == (C, len(x))


@pytest.mark.parametrize("name,kw", PROBLEMS, ids=IDS)
def test_declarations_match_jax(name, kw):
    """The same declarations are set in both packages, with the same values;
    the declared pieces are the model (drift == f0 + G u where affine,
    sigma2_x == diag(L L^T), stage cost == q + r)."""
    jp, tp = _pair(name, kw)
    x, u = _samples(jp, seed=1)
    jx, ju, tx, tu = jnp.asarray(x), jnp.asarray(u), torch.as_tensor(x), torch.as_tensor(u)
    assert [getattr(tp, f) is None for f in DECLARATIONS] == \
        [getattr(jp, f) is None for f in DECLARATIONS]
    assert tp.structured == (name != "glider")
    for f in DECLARATIONS[:4]:
        if getattr(tp, f) is not None:
            close(getattr(tp, f)(tx), jax.vmap(getattr(jp, f))(jx), **TOL)
    close(tp.cost_r(tu), jax.vmap(jp.cost_r)(ju), **TOL)
    if tp.drift_f0 is not None:
        affine = tp.drift_f0(tx) + torch.einsum("bdm,bm->bd", tp.drift_G(tx), tu)
        np.testing.assert_allclose(affine.numpy(), tp.drift(tx, tu).numpy(), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(tp.sigma2_x(tx).numpy(), tp.sigma2_diag(tx, tu).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose((tp.cost_q(tx) + tp.cost_r(tu)).numpy(),
                               tp.stage_cost(tx, tu).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,kw", PROBLEMS, ids=IDS)
def test_static_description_matches_jax(name, kw):
    jp, tp = _pair(name, kw)
    for field in ("dx", "du", "dw", "lb", "ub", "ulb", "uub", "beta", "value_bounds", "name"):
        assert getattr(tp, field) == getattr(jp, field), field
    assert [int(b) for b in tp.boundary] == [int(b) for b in jp.boundary]
    assert [(o.lb, o.ub, o.cost) for o in tp.obstacles] == \
        [(o.lb, o.ub, o.cost) for o in jp.obstacles]
    for n in (7, 9):
        np.testing.assert_array_equal(tp.control_candidates(n), jp.control_candidates(n))
    jg, tg = jp.default_grid(7), tp.default_grid(7)
    assert (tg.lb, tg.ub, tg.shape, tg.periodic) == (jg.lb, jg.ub, jg.shape, jg.periodic)
    np.testing.assert_array_equal(tg.h, jg.h)


@pytest.mark.parametrize("name,kw,n", [("dubins", {}, (25, 25, 16)), ("glider", {}, (9, 7, 7, 7)),
                                       ("quadcopter7", QUAD, 4)],
                         ids=["dubins", "glider", "quadcopter7"])
def test_node_terminal_matches_jax(name, kw, n):
    """Absorbing faces, the Dubins goal and obstacles, the glider's perch:
    the same terminal nodes with the same pinned values."""
    jp, tp = _pair(name, kw)
    jg, tg = jp.default_grid(n), tp.default_grid(n)
    idx = tg.node_indices("cpu")
    t_mask, t_val = tmca.node_terminal(tp, tg, idx, tg.node_states("cpu"))
    jidx = jnp.asarray(idx.numpy(), jnp.int32)
    j_mask, j_val = jmca.node_terminal(jp, jg, jidx, jg.index_to_state(jidx))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    close(t_val, j_val, **TOL)
    assert 0 < int(t_mask.sum()) < t_mask.numel()


def test_registry_has_the_cli_systems():
    assert set(tm.REGISTRY) == set(jm.REGISTRY) == {
        "lq", "pendulum", "dubins", "glider", "quadcopter", "quadcopter7"}
    for name in ("make_dubins_problem", "make_glider_problem", "make_quadcopter7_problem"):
        assert name in tm.__all__ and callable(getattr(tm, name))


def test_glider_kink_carries_jax_derivative():
    """max(v, 0.3) in the glider's drift: d drift / dv at the tie v = 0.3 is
    JAX's (one half of each side's), not torch.clamp's."""
    jp, tp = _pair("glider", {})
    x = np.array([[-1.0, 0.2, 0.3, 0.1], [-2.0, -0.1, 0.3, -0.4], [0.0, 0.0, 2.5, 0.2]],
                 np.float32)
    u = np.array([[0.3], [-0.5], [0.7]], np.float32)
    want = jax.vmap(jax.jacfwd(jp.drift))(jnp.asarray(x), jnp.asarray(u))
    got = torch.func.vmap(torch.func.jacfwd(lambda a, b: tp.drift(a[None], b[None])[0]))(
        torch.as_tensor(x), torch.as_tensor(u))
    close(got, want, rtol=1e-5, atol=1e-5)


def test_quadcopter7_jacobians_are_float32_and_match_jax():
    """iLQR differentiates the 7D drift per sample (torch.func on a batch of
    one): the wind's concatenation keeps float32 and JAX's Jacobians."""
    jp, tp = _pair("quadcopter7", QUAD)
    x, u = _samples(jp, n=16, seed=3)
    jfx, jfu = jax.vmap(jax.jacfwd(jp.drift, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(u))
    fx, fu = torch.func.vmap(torch.func.jacfwd(
        lambda a, b: tp.drift(a[None], b[None])[0], argnums=(0, 1)))(
        torch.as_tensor(x), torch.as_tensor(u))
    assert fx.dtype == fu.dtype == torch.float32
    close(fx, jfx, rtol=1e-5, atol=1e-5)
    close(fu, jfu, rtol=1e-5, atol=1e-5)


def test_quadcopter7_smoke():
    """The counterpart of tests/test_flagship.py::test_quadcopter_7d_smoke at
    a smaller grid (4^7, 9 candidates, rank 6): the fused solve adapts its
    ranks and gives a finite value, and its greedy policy keeps most of 8
    rollouts from the hover point in the box for 100 steps."""
    from c3sc_tpu_torch.ops.tt import tt_gather_eval, tt_lerp_eval
    from c3sc_tpu_torch.sim import make_implicit_policy, rollout
    from c3sc_tpu_torch.solvers import fused_tt_vi

    prob = tm.make_quadcopter7_problem(**QUAD)
    assert prob.dx == 7 and prob.dw == 4
    grid = prob.default_grid(4)
    controls = prob.control_candidates(3)
    sol = fused_tt_vi(prob, grid, controls=controls, rmax=6, seed=0, tol=1e-3, max_iters=60,
                      patience=60, device="cpu")
    rng = np.random.default_rng(2)
    idx = torch.as_tensor(np.stack([rng.integers(0, n, 128) for n in grid.shape], -1))
    assert torch.isfinite(tt_gather_eval(sol.v, idx)).all()
    assert int(sol.v.ranks.max()) > 1
    policy = make_implicit_policy(prob, grid, lambda p: tt_lerp_eval(sol.v, grid, p),
                                  torch.as_tensor(controls, dtype=torch.float32))
    with torch.no_grad():
        traj = rollout(prob, grid, policy, torch.zeros(8, 7), 0.01, 100,
                       generator=torch.Generator().manual_seed(1))
    assert traj.alive[-1].float().mean().item() > 0.5


def test_bare_problem_is_general_everywhere():
    """dataclasses.replace strips every declaration: the stencil then takes
    transition_all_controls's per-candidate branch and equals the declared
    problem's to float32 rounding."""
    tp = tm.make_problem("quadcopter7", **QUAD)
    bare = dataclasses.replace(tp, drift_f0=None, drift_G=None, sigma2_x=None, cost_q=None,
                               cost_r=None)
    grid = tp.default_grid(3)
    x = grid.node_states("cpu")
    uc = torch.as_tensor(tp.control_candidates(3), dtype=torch.float32)
    for a, b in zip(tmca.transition_all_controls(bare, grid, x, uc),
                    tmca.transition_all_controls(tp, grid, x, uc)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tmca.stage_cost_all(bare, x, uc).numpy(),
                               tmca.stage_cost_all(tp, x, uc).numpy(), rtol=1e-5, atol=1e-5)
