"""The port's continuous control refinement against the JAX package on the
CPU: the batched optimizers (c3sc_tpu_torch.ops.argmin), the continuous
Bellman right-hand side and its gradient, the refined TT backup
(c3sc_tpu_torch.solvers.ttvi), and the refined policies (sim/policy.py,
solvers/dense.py).

Bars, each stated at its test:
  (a) the optimizers: u and f within 1e-5 of JAX on the problems of
      tests/test_argmin.py, and that file's own bars in the port;
  (b) the right-hand side and its gradient in u (torch.autograd against
      jax.grad): rtol 1e-5, atol 1e-6, at the kinks f_j = 0 included;
  (c) refine_controls and bellman_backup(refine_steps=2) on identical TTs
      and nodes: within 1e-5 (relative to the largest value);
  (d) the refined policies equal JAX's but where the two best candidates
      tie (the rule of test_torch_sim.py), and beat the coarse grid as
      tests/test_argmin.py requires.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import QUAD, TIE, V5, close, port_grid, random_tt_numpy
from c3sc_tpu import models as jm
from c3sc_tpu.ops import argmin as ja
from c3sc_tpu.ops.interp import multilinear_interp as jinterp
from c3sc_tpu.ops.tt import TT as JTT
from c3sc_tpu.sim.policy import make_implicit_policy as jmake_policy
from c3sc_tpu.sim.policy import q_values as jq_values
from c3sc_tpu.solvers import ttvi as jt
from c3sc_tpu.solvers.dense import dense_policy as jdense_policy
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import tt_from_numpy, value_from_npz
from c3sc_tpu_torch.ops.dense_backup import candidate_rhs, make_dense_operands, neighbor_values
from c3sc_tpu_torch.ops import argmin as ta
from c3sc_tpu_torch.ops.interp import multilinear_interp
from c3sc_tpu_torch.sim import make_implicit_policy
from c3sc_tpu_torch.solvers import dense_policy, dense_vi
from c3sc_tpu_torch.solvers import ttvi as tt

A = np.array([[2.0, 0.3], [0.3, 1.0]], np.float32)
TARGETS = np.array([[0.4, -0.2], [0.9, 0.9], [-2.0, 0.0]], np.float32)   # the last clips


def _quadratic(xp):
    a, t = xp.asarray(A), xp.asarray(TARGETS)
    if xp is torch:
        return lambda u: torch.einsum("bi,ij,bj->b", u - t, a, u - t)
    return lambda u: jnp.einsum("bi,ij,bj->b", u - t, a, u - t)


def _ill(xp):
    t = xp.asarray(np.array([[0.35, -0.55]], np.float32))
    return lambda u: 100.0 * (u[:, 0] - t[:, 0]) ** 2 + (u[:, 1] - t[:, 1]) ** 2


# (problem, start, iterations) of tests/test_argmin.py
CASES = {"quadratic": (_quadratic, np.zeros((3, 2), np.float32), {"pgd": 30, "lbfgs": 25}),
         "ill-conditioned": (_ill, np.full((1, 2), 0.9, np.float32), {"pgd": 12, "lbfgs": 12})}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("method", ["pgd", "lbfgs"])
def test_optimizers_match_jax(case, method):
    """Bar (a): u and f within 1e-5 of JAX; the port meets test_argmin.py."""
    make_f, u0, iters = CASES[case]
    name = f"{method}_minimize"
    kw = dict(lb=(-1.0, -1.0), ub=(1.0, 1.0), n_iters=iters[method])
    ju, jf = getattr(ja, name)(make_f(jnp), jnp.asarray(u0), **kw)
    u, f = getattr(ta, name)(make_f(torch), torch.as_tensor(u0), **kw)
    close(u, ju, rtol=0, atol=1e-5)
    close(f, jf, rtol=1e-5, atol=1e-5)
    assert u.shape == u0.shape and not u.requires_grad
    if case == "quadratic":
        close(u[:2], TARGETS[:2], rtol=0, atol=2e-2)
        assert float(u[2, 0]) <= -0.95               # clipped at the box
    elif method == "lbfgs":
        _, f_pgd = ta.pgd_minimize(make_f(torch), torch.as_tensor(u0), **kw)
        assert float(f[0]) <= float(f_pgd[0]) + 1e-6 and float(f[0]) < 1e-3


def test_brute_force_and_ties_match_jax():
    """Brute force over a candidate set; a target midway between two
    candidates ties, and both packages take the lower index."""
    cands = np.linspace(-1, 1, 5, dtype=np.float32)[:, None]          # spacing 0.5
    t = np.array([0.25, -0.8, 0.6, 1.7], np.float32)                  # 0.25 ties 0 and 0.5
    jb = ja.brute_force_minimize(lambda c: (c - jnp.asarray(t)) ** 2, jnp.asarray(cands))
    tb = ta.brute_force_minimize(lambda c: (c - torch.as_tensor(t)) ** 2, torch.as_tensor(cands))
    for g, w in zip(tb, jb):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(tb[0][0, 0]) == 0.0
    a = torch.tensor([[3.0, 1.0, 1.0], [float("nan"), 2.0, 0.0]]).T
    np.testing.assert_array_equal(ta.first_argmin(a, 0).numpy(),
                                  np.asarray(jnp.argmin(jnp.asarray(a.numpy()), axis=0)))


def _rhs_case(name):
    """(jax problem, port problem, jax grid, x, vn, u): node states, random
    neighbour values, controls with rows exactly on the kinks f_j = 0."""
    rng = np.random.default_rng(3)
    if name == "lq":
        jp, tp = jm.make_problem("lq"), tm.make_problem("lq")
        jg = jp.default_grid(21)
        B = 96
        u = rng.uniform(-6, 6, (B, 1)).astype(np.float32)
        u[:24] = 0.0                                   # f_2 = u = 0
    else:
        jp, tp = jm.make_problem("quadcopter", **QUAD), tm.make_problem("quadcopter", **QUAD)
        jg = jp.default_grid(5)
        B = 96
        u = rng.uniform(0, 6, (B, 2)).astype(np.float32)
        u[:24] = 0.5 * 0.5 * 9.81                      # hover: f_4 = f_5 = 0 at th = 0
    idx = np.stack([rng.integers(0, n, B) for n in jg.shape], -1)
    idx[:12] = np.asarray(jg.shape) // 2               # the centre node, x = 0
    x = np.asarray(jg.index_to_state(jnp.asarray(idx)), np.float32)
    vn = rng.uniform(0, 5, (B, 2, jp.dx)).astype(np.float32)
    return jp, tp, jg, x, vn, u


@pytest.mark.parametrize("name", ["lq", "quad5"])
def test_rhs_continuous_and_gradient_match_jax(name):
    """Bar (b), kinks included (LQ u = 0; the quadcopter's hover at x = 0)."""
    jp, tp, jg, x, vn, u = _rhs_case(name)
    jfn = jt.rhs_continuous(jp, jg, jnp.asarray(x), jnp.asarray(vn))
    tfn = tt.rhs_continuous(tp, port_grid(jg), torch.as_tensor(x), torch.as_tensor(vn))
    want = np.asarray(jax.jit(jfn)(jnp.asarray(u)))
    want_g = np.asarray(jax.jit(jax.grad(lambda uu: jnp.sum(jfn(uu))))(jnp.asarray(u)))
    leaf = torch.as_tensor(u).requires_grad_(True)
    got = tfn(leaf)
    (got_g,) = torch.autograd.grad(got.sum(), leaf)
    close(got.detach(), want, rtol=1e-5, atol=1e-6)
    close(got_g, want_g, rtol=1e-5, atol=1e-6)
    # the kink rows carry JAX's derivatives there (not torch.abs's or clamp's)
    assert np.abs(want_g[:24]).max() > 0.0


def _tt_case(name, seed=0):
    if name == "lq":
        jp, tp = jm.make_problem("lq"), tm.make_problem("lq")
        jg, R, nc = jp.default_grid(21), 6, 9
    else:
        jp, tp = jm.make_problem("quadcopter", **QUAD), tm.make_problem("quadcopter", **QUAD)
        jg, R, nc = jp.default_grid(5), 4, 5
    d = jp.dx
    cores, ranks = random_tt_numpy(jg.shape, [R] * (d - 1), R, seed)
    cores[0] = cores[0] * 40.0
    rng = np.random.default_rng(seed + 1)
    idx = np.stack([rng.integers(0, n, 200) for n in jg.shape], -1)
    return jp, tp, jg, jp.control_candidates(nc), cores, ranks, idx


def _tied(f, got, want):
    """Rows where the port's control and JAX's are equally good: the
    objective f at both within TIE (relative) — the tie rule of the
    candidate argmin, applied to the continuous one. Near an optimum, or
    where the objective is flat to float32 (at the value bound), the
    normalised gradient is rounding noise and the two packages step to
    different points of the same objective."""
    with torch.no_grad():
        fg, fw = f(got), f(torch.as_tensor(np.asarray(want)))
    return ((fg - fw).abs() <= TIE * fw.abs().clamp(min=1.0)).numpy()


@pytest.mark.parametrize("name,method", [("lq", "pgd"), ("quad5", "lbfgs")])
def test_refined_backup_matches_jax(name, method):
    """Bar (c): refine_controls from arbitrary candidates, then the whole
    refined backup, on identical TTs and nodes; and the sampled residual.
    The controls agree but where they tie (``_tied``)."""
    jp, tp, jg, uc, cores, ranks, idx = _tt_case(name)
    tg = port_grid(jg)
    jtt = JTT(tuple(jnp.asarray(c) for c in cores), jnp.asarray(ranks))
    ttt = tt_from_numpy(cores, ranks, "cpu")
    jidx, tidx = jnp.asarray(idx, jnp.int32), torch.as_tensor(idx)
    jx, jvn = jax.jit(lambda t, i: jt._pinned_neighbor_values(jp, jg, t, i, jnp.float32))(
        jtt, jidx)
    x, vn = tt._pinned_neighbor_values(tp, tg, ttt, tidx, torch.float32)
    close(vn, jvn, rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(jvn)).max()))
    u0 = np.asarray(uc, np.float32)[np.random.default_rng(5).integers(0, len(uc), len(idx))]
    f0 = np.full(len(idx), 1e9, np.float32)                  # above every objective
    ju, jf = jax.jit(lambda *a: jt.refine_controls(jp, jg, *a, 2, method))(
        jx, jvn, jnp.asarray(u0), jnp.asarray(f0))
    u, f = tt.refine_controls(tp, tg, x, vn, torch.as_tensor(u0), torch.as_tensor(f0), 2, method)
    close(f, jf, rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(jf)).max()))
    span = float(np.max(np.asarray(tp.uub) - np.asarray(tp.ulb)))
    differ = np.abs(u.numpy() - np.asarray(ju)).max(-1) > 1e-5 * span
    tied = _tied(tt.rhs_continuous(tp, tg, x, vn), u, ju)
    assert not np.any(differ & ~tied) and differ.mean() < 0.1
    uct = torch.as_tensor(uc, dtype=torch.float32)
    want = jax.jit(lambda t, i: jt.bellman_backup(jp, jg, jnp.asarray(uc, jnp.float32), t, i,
                                                  refine_steps=2, refine_method=method))(jtt, jidx)
    got = tt.bellman_backup(tp, tg, uct, ttt, tidx, refine_steps=2, refine_method=method)
    close(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    coarse = tt.bellman_backup(tp, tg, uct, ttt, tidx)
    assert torch.all(got <= coarse) and torch.any(got < coarse)   # refinement only lowers it
    if name == "lq":
        jr, js = jax.jit(lambda t: jt.bellman_residual_sample(jp, jg, uc, t, n_samples=256))(jtt)
        r, s = tt.bellman_residual_sample(tp, tg, uc, ttt, n_samples=256)
        close(r, jr, rtol=1e-5, atol=1e-6)
        close(s, js, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def lq41():
    """The LQ value of tests/test_argmin.py (41^2, 41 candidates), solved by
    the port, and the states that test draws."""
    prob = tm.make_problem("lq", sigma=1.0, beta=1.0)
    grid = prob.default_grid(41)
    v = dense_vi(prob, grid, n_controls=41, tol=1e-5, max_outer=400, chunk=100, device="cpu").v
    x = np.random.default_rng(0).uniform(-1, 1, size=(128, 2)).astype(np.float32)
    return prob, grid, v.numpy(), x


def _tie_rows(jp, jg, jvf, uc, x):
    """Rows where JAX's two best candidates are within TIE (relative)."""
    jq = jax.jit(lambda xx: jq_values(jp, jg, jvf, uc, xx))(jnp.asarray(x))
    top2 = np.sort(np.asarray(jq), axis=-1)[:, :2]
    return (top2[:, 1] - top2[:, 0]) <= TIE * np.maximum(1.0, np.abs(top2[:, 0]))


@pytest.mark.parametrize("kind", ["pgd", "lbfgs", "value_grad_fn"])
def test_refined_implicit_policy_matches_jax_and_beats_the_grid(kind, lq41):
    """Bar (d), make_implicit_policy(refine_steps=3) on LQ 41^2 with the 5
    coarse candidates of tests/test_argmin.py. ``value_grad_fn`` is the
    Riccati gradient 2 P x, the same function in both packages. The port's
    refined policy must beat the coarse one against the Riccati control, as
    JAX's must there (10 steps of pgd: error < 0.75 x coarse and < 0.4)."""
    prob, grid, v, x = lq41
    jp = jm.make_problem("lq", sigma=1.0, beta=1.0)
    jg = jp.default_grid(41)
    coarse = jp.control_candidates(5)
    P, _, K = tm.lqr_solution(sigma=1.0, beta=1.0)
    jvf = lambda p: jinterp(jg, jnp.asarray(v), p)
    tvf = lambda p: multilinear_interp(grid, torch.as_tensor(v), p)
    kw = dict(refine_steps=3, refine_method="lbfgs" if kind == "lbfgs" else "pgd")
    jkw, tkw = dict(kw), dict(kw)
    if kind == "value_grad_fn":
        jkw["value_grad_fn"] = lambda p: 2.0 * p @ jnp.asarray(P, jnp.float32)
        tkw["value_grad_fn"] = lambda p: 2.0 * p @ torch.as_tensor(P, dtype=torch.float32)
    want = np.asarray(jax.jit(jmake_policy(jp, jg, jvf, coarse, **jkw))(jnp.asarray(x)))
    got = make_implicit_policy(prob, grid, tvf, coarse, **tkw)(torch.as_tensor(x)).numpy()
    tie = _tie_rows(jp, jg, jvf, coarse, x)
    differ = np.abs(got - want).max(-1) > 1e-4
    assert not np.any(differ & ~tie), np.nonzero(differ & ~tie)
    assert np.mean(~differ) > 0.95
    u_true = -(x @ K.T)
    e0 = np.abs(make_implicit_policy(prob, grid, tvf, coarse)(torch.as_tensor(x)).numpy()
                - u_true).mean()
    e10 = np.abs(make_implicit_policy(prob, grid, tvf, coarse, refine_steps=10, **{
        k: w for k, w in tkw.items() if k != "refine_steps"})(torch.as_tensor(x)).numpy()
        - u_true).mean()
    assert e10 < 0.75 * e0 and e10 < 0.4, (e10, e0)


def test_refined_dense_policy_matches_jax(method="pgd"):
    """Bar (d), dense_policy(refine_steps=2) on the quadcopter at 5^6 (the
    stored JAX value) with 9 candidates: equal to JAX's but where a choice
    tied on the way — the two best candidates (``TIE``), the controls after
    the first step, or the final ones (``_tied``: a tie of the line
    search's argmin at the first step sends the second from different
    points); every refined node's right-hand side at most its candidate's."""
    jp, tp = jm.make_problem("quadcopter", **QUAD), tm.make_problem("quadcopter", **QUAD)
    jg, tg = jp.default_grid(5), tp.default_grid(5)
    uc = jp.control_candidates(3)
    v = value_from_npz(V5, "cpu")
    ops = make_dense_operands(tp, tg, uc, "cpu")
    vp, vm = neighbor_values(v, tg)
    f = tt.rhs_continuous(tp, tg, ops.x, torch.stack([vp, vm], 1))
    top2 = torch.sort(candidate_rhs(ops, v), dim=0).values[:2].numpy()
    held = (top2[1] - top2[0]) > TIE * np.maximum(1.0, np.abs(top2[0]))
    for steps in (1, 2):
        want = np.asarray(jdense_policy(jp, jg, jnp.asarray(v.numpy()), uc, refine_steps=steps,
                                        refine_method=method)).reshape(-1, 2)
        got = dense_policy(tp, tg, v, uc, device="cpu", refine_steps=steps,
                           refine_method=method).reshape(-1, 2)
        differ = np.abs(got.numpy() - want).max(-1) > 1e-4
        tied = _tied(f, got, want)
        assert not np.any(differ & held & ~tied)
        held &= ~(differ & tied)
    assert np.mean(~differ) > 0.95 and held.mean() > 0.9
    brute = dense_policy(tp, tg, v, uc, device="cpu").reshape(-1, 2)
    assert torch.all(f(got) <= f(brute))
    assert float((got != brute).any(-1).float().mean()) > 0.02     # it moves controls
