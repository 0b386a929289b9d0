"""The port's receding-horizon control path against the JAX package on the
CPU: refined fused iterations, ``step_fn``'s exact-n semantics, the problem
families, the tracking solver's warm updates, and fused MPC
(c3sc_tpu_torch.sim.mpc_fused, c3sc_tpu_torch.sim.tracking). No JAX
whole-loop MPC or tracking run: the JAX side gives the pieces.

Bars, each stated at its test:
  (e) refine_steps=2 fused iterations from JAX's init carry: ranks equal,
      samples within 1e-4 x max|v| after one iteration and 1e-3 x max|v|
      after five (the bar of test_one_and_five_iterations_match_jax);
  (f) step_fn runs exactly n iterations past the stopping state, run_fn
      stops;
  (g) the families' cost_q, stage_cost and boundary_cost: rtol 1e-6, atol
      1e-5 at random states, three theta each;
  (h) a tracking update is bit-equal to a solver built at the new theta, the
      solver is built once across updates, and a warm update lands within
      0.35 of the Riccati value (tests/test_tracking.py's bar and config);
  (i) fused_mpc_run meets tests/test_mpc_fused.py's shape, finiteness and
      stabilisation bars (no wall-time bar on the CPU); one replan from
      JAX's carry as (e); one segment rollout with JAX's noise within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import QUAD, close, port_grid
from c3sc_tpu import models as jm
from c3sc_tpu.ops.tt import TT as JTT
from c3sc_tpu.ops.tt import tt_lerp_eval as jtt_lerp_eval
from c3sc_tpu.sim.integrators import rollout as jrollout
from c3sc_tpu.sim.policy import make_implicit_policy as jmake_policy
from c3sc_tpu.solvers import fused as jf
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import fused_carry_from_numpy
from c3sc_tpu_torch.ops.tt import TT, tt_lerp_eval
from c3sc_tpu_torch.sim import fused_mpc_run, make_implicit_policy, rollout
from c3sc_tpu_torch.sim import tracking
from c3sc_tpu_torch.solvers import make_fused_vi


def _carry_to_port(jc):
    fields = {k: ([np.asarray(c) for c in v] if isinstance(v, tuple) else np.asarray(v))
              for k, v in jc._asdict().items()}
    return fused_carry_from_numpy(fields, "cpu")


def _held_to_jax(tc, jc, frac):
    np.testing.assert_array_equal(tc.ranks.numpy(), np.asarray(jc.ranks))
    vs = np.asarray(jc.v_sample)
    close(tc.v_sample, vs, rtol=0, atol=frac * np.abs(vs).max())
    assert int(tc.it) == int(jc.it)


def test_refined_fused_iterations_match_jax():
    """Bar (e): JAX's init carry on LQ 21^2 (rmax 6, 9 candidates, the case
    of test_one_and_five_iterations_match_jax), then step_fn on both sides.
    (L-BFGS refinement is held in tests/test_torch_argmin.py.)"""
    jp, tp = jm.make_problem("lq"), tm.make_problem("lq")
    jg = jp.default_grid(21)
    uc = jp.control_candidates(9)
    kw = dict(rmax=6, refine_steps=2, refine_method="pgd")
    js = jf.make_fused_vi(jp, jg, uc, **kw)
    ts = make_fused_vi(tp, port_grid(jg), uc, device="cpu", **kw)
    jc = js.init_fn(jax.random.key(0))
    tc = _carry_to_port(jc)
    jc, tc = js.step_fn(jc, 1), ts.step_fn(tc, 1)
    _held_to_jax(tc, jc, 1e-4)
    jc, tc = js.step_fn(jc, 4), ts.step_fn(tc, 4)
    _held_to_jax(tc, jc, 1e-3)
    assert torch.isfinite(tc.v_sample).all()


def test_step_fn_runs_exactly_n_past_the_stopping_state():
    """Bar (f): a carry past its patience — run_fn leaves it, step_fn runs
    exactly n more iterations from it."""
    prob = tm.make_problem("lq", sigma=1.0, beta=1.0)
    grid = prob.default_grid(21)
    solver = make_fused_vi(prob, grid, prob.control_candidates(9), rmax=6, tol=0.0,
                           max_iters=10**9, window=5, patience=1, freeze_after=10,
                           device="cpu")
    stopped = solver.run_fn(solver.init_fn(0), 200)
    it = int(stopped.it)
    assert it < 200 and int(stopped.wstall) >= 1, "the case must stop on its patience"
    again = solver.run_fn(stopped, 5)
    assert int(again.it) == it and torch.equal(again.v_sample, stopped.v_sample)
    stepped = solver.step_fn(stopped, 3)
    assert int(stepped.it) == it + 3 and not torch.equal(stepped.v_sample, stopped.v_sample)
    assert torch.equal(solver.step_fn(solver.step_fn(stopped, 1), 2).v_sample, stepped.v_sample)


FAMILIES = {"lq": (jm.make_lq_family, tm.make_lq_family, dict(sigma=0.5, beta=1.0), "lq"),
            "quadcopter": (jm.make_quadcopter_family, tm.make_quadcopter_family, QUAD,
                           "quadcopter")}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_families_match_jax(name):
    """Bar (g), and the port's buffer rule: a tensor theta is read at every
    call, so writing into it moves the cost."""
    jfam, tfam, kw, base = FAMILIES[name]
    jfamily, tfamily = jfam(**kw), tfam(**kw)
    rng = np.random.default_rng(0)
    jp0 = jm.make_problem(base, **kw)
    x = rng.uniform(jp0.lb, jp0.ub, (128, jp0.dx)).astype(np.float32)
    u = rng.uniform(jp0.ulb, jp0.uub, (128, jp0.du)).astype(np.float32)
    jx, ju, tx, tu = jnp.asarray(x), jnp.asarray(u), torch.as_tensor(x), torch.as_tensor(u)
    thetas = np.array([[0.0, 0.0], [0.3, -0.2], [-0.8, 0.5]], np.float32)
    for theta in thetas:
        jp, tp = jfamily(jnp.asarray(theta)), tfamily(theta)
        for field in ("cost_q", "boundary_cost"):
            close(getattr(tp, field)(tx), jax.vmap(getattr(jp, field))(jx), rtol=1e-6, atol=1e-5)
        close(tp.stage_cost(tx, tu), jax.vmap(jp.stage_cost)(jx, ju), rtol=1e-6, atol=1e-5)
        assert tp.value_bounds == jp.value_bounds
    buf = torch.zeros(2)
    tp = tfamily(buf)
    before = tp.stage_cost(tx, tu).clone()
    buf.copy_(torch.as_tensor(thetas[2]))
    close(tp.stage_cost(tx, tu), jax.vmap(jfamily(jnp.asarray(thetas[2])).stage_cost)(jx, ju),
          rtol=1e-6, atol=1e-5)
    assert not torch.equal(before, tp.stage_cost(tx, tu))


@pytest.fixture(scope="module")
def lq_tracking():
    """tests/test_tracking.py's configuration, built by the port on the CPU
    with the builds of the fused solver counted, and its 400-iteration
    init at theta = 0."""
    builds = []
    real = tracking.make_fused_vi

    def counting(*args, **kwargs):
        builds.append(1)
        return real(*args, **kwargs)

    tracking.make_fused_vi = counting
    try:
        family = tm.make_lq_family(sigma=0.5, beta=1.0)
        prob0 = family(np.zeros(2))
        grid = prob0.default_grid(21)
        controls = prob0.control_candidates(13)
        solver = tracking.make_tracking_solver(family, grid, controls, rmax=8,
                                               solver_kwargs={"sample_size": 128}, device="cpu")
    finally:
        tracking.make_fused_vi = real
    carry = solver.init(np.zeros(2), 0, n_iters=400)
    return family, grid, controls, solver, carry, builds


def test_tracking_update_equals_a_solver_built_at_theta(lq_tracking):
    """Bar (h): update(carry, theta1, n) is bit-equal to make_fused_vi at
    theta1 stepping the same carry n times."""
    family, grid, controls, solver, carry, _ = lq_tracking
    theta1 = np.array([0.3, 0.1], np.float32)
    got = solver.update(carry, theta1, 10)
    fresh = make_fused_vi(family(theta1), grid, controls, rmax=8, tol=0.0, max_iters=10**9,
                          sample_size=128, device="cpu")
    want = fresh.step_fn(carry, 10)
    for a, b in zip(got, want):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert int(got.it) == int(carry.it) + 10


def test_tracking_solver_is_built_once_and_tracks_the_riccati_value(lq_tracking):
    """Bar (h): four cost updates build nothing; then the warm re-solve at
    the moved setpoint (200 iterations) lands within 0.35 of the analytic
    value, JAX's bar at its configuration."""
    family, grid, controls, solver, carry, builds = lq_tracking
    for t in [0.3, -0.5, 0.8, 0.1]:
        carry = solver.update(carry, np.array([t, 0.0]), 5)
    assert len(builds) == 1 and torch.equal(solver.theta, torch.tensor([0.1, 0.0]))
    theta = np.array([0.8, 0.0])
    carry = solver.update(carry, theta, 200)
    P, c, _ = tm.lqr_solution(sigma=0.5, beta=1.0)
    pts = np.array([[0.8, 0.0], [0.3, 0.0], [0.8, 0.5]], np.float32)
    v = solver.value_fn(carry, torch.as_tensor(pts)).numpy()
    e = pts - theta
    v_true = np.einsum("ni,ij,nj->n", e, P, e) + c
    assert np.abs(v - v_true).max() < 0.35, (v, v_true)
    u = solver.policy(carry, theta, torch.as_tensor(pts))
    assert u.shape == (3, 1) and torch.isfinite(u).all()


def test_fused_mpc_stabilizes_lq():
    """Bar (i), tests/test_mpc_fused.py's configuration and bars but the
    wall-time one (load-dependent there already)."""
    prob = tm.make_problem("lq", sigma=0.5, beta=1.0)
    grid = prob.default_grid(21)
    B = 16
    res = fused_mpc_run(prob, grid, torch.tensor([1.5, 0.0]).repeat(B, 1), dt=0.02,
                        steps_per_replan=25, n_replans=6, n_controls=9, rmax=8, refine_iters=3,
                        first_solve_iters=300, seed=0, device="cpu")
    assert res.xs.shape == (1 + 6 * 25, B, 2) and res.us.shape == (6 * 25, B, 1)
    assert res.xs[-1].abs().mean(0)[0] < 1.0          # decreased from 1.5 under noise
    assert torch.isfinite(res.cost).all() and res.cost.dtype == torch.float64
    assert len(res.replan_latency) == 6 and res.replan_latency[0] == 0.0
    assert all(lat > 0 for lat in res.replan_latency[1:]) and len(res.residuals) == 6


def test_mpc_replan_and_segment_match_jax():
    """Bar (i): one replan (step_fn, 3 iterations) from JAX's carry after 20
    iterations, as (e); then one 25-step segment under the implicit policy
    on JAX's TT value, with JAX's Euler–Maruyama noise, within 1e-4."""
    jp = jm.make_problem("lq", sigma=0.5, beta=1.0)
    tp = tm.make_problem("lq", sigma=0.5, beta=1.0)
    jg = jp.default_grid(21)
    tg = port_grid(jg)
    uc = jp.control_candidates(9)
    js = jf.make_fused_vi(jp, jg, uc, rmax=8, tol=0.0, max_iters=10**9)
    ts = make_fused_vi(tp, tg, uc, rmax=8, tol=0.0, max_iters=10**9, device="cpu")
    jc = js.step_fn(js.init_fn(jax.random.key(0)), 20)
    tc = _carry_to_port(jc)
    _held_to_jax(ts.step_fn(tc, 3), js.step_fn(jc, 3), 1e-3)

    B, n_steps, dt = 16, 25, 0.02
    x0 = np.tile(np.array([1.5, 0.0], np.float32), (B, 1))
    key = jax.random.key(7)
    jv = JTT(jc.cores, jc.ranks)
    jpol = jmake_policy(jp, jg, lambda p: jtt_lerp_eval(jv, jg, p), uc)
    jt = jax.jit(lambda x, k: jrollout(jp, jg, jpol, x, k, dt, n_steps))(jnp.asarray(x0), key)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, jp.dw), jnp.float32))
                      for k in jax.random.split(key, n_steps)])
    tv = TT(tc.cores, tc.ranks)
    tpol = make_implicit_policy(tp, tg, lambda p: tt_lerp_eval(tv, tg, p), uc)
    tr = rollout(tp, tg, tpol, torch.as_tensor(x0), dt, n_steps, noise=torch.as_tensor(noise))
    for field in ("xs", "us", "cost"):
        close(getattr(tr, field), getattr(jt, field), rtol=1e-4, atol=1e-4)


def test_mpc_refined_policy_runs():
    """fused_mpc_run with refine_steps > 0: the JAX keyword, passed to the
    segment policy."""
    prob = tm.make_problem("lq", sigma=0.5, beta=1.0)
    res = fused_mpc_run(prob, prob.default_grid(11), torch.zeros(4, 2), dt=0.02,
                        steps_per_replan=5, n_replans=2, n_controls=5, rmax=4, refine_iters=1,
                        first_solve_iters=10, refine_steps=2, seed=1, device="cpu")
    assert torch.isfinite(res.cost).all() and res.us.shape == (10, 4, 1)
    # the controls leave the 5-candidate set: the refinement ran
    assert not torch.isin(res.us.reshape(-1), torch.linspace(-6, 6, 5)).all()
