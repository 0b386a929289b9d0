"""The port's PI-ALS solver (c3sc_tpu_torch.solvers.pials) against
c3sc_tpu.solvers.pials on the CPU, every call with device="cpu".

Bars, each stated at its test:
  - the deterministic device pieces on the same numpy inputs, to float32
    rounding: ``frozen_policy_rows`` (the same points; weights and right-hand
    sides within rtol 1e-5, atol 1e-5 x max|v|, except at samples whose two
    best candidates tie within TIE), ``_frames`` and the chunked normal
    equations (rtol 1e-5, atol 1e-5 x the largest entry);
  - the host core algebra (numpy float64 in both packages): equal;
  - tests/test_pials.py's bars on the port, at its sizes: (a) the rows
    reproduce the Bellman defect within 1e-3 x max|v|; (b) from the rank-20
    start, q95 < 0.002 of the range; (c) the returned iterate is the best
    sampled-residual one (or the input);
  - a 6D solve at 5^6 (interior cores, chunked assembly): finite, and never
    worse than its input by the sampled residual.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import QUAD, TIE, close, port_grid, random_tt_numpy
from c3sc_tpu import models as jm
from c3sc_tpu.ops.tt import TT as JTT
from c3sc_tpu.solvers import pials as jp_
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import tt_from_numpy
from c3sc_tpu_torch.ops.tt import _repad, tt_from_dense, tt_full, tt_gather_eval
from c3sc_tpu_torch.solvers import dense_vi
from c3sc_tpu_torch.solvers import pials as tp_
from c3sc_tpu_torch.solvers.ttvi import make_bellman_kernel


@pytest.fixture(scope="module")
def pendulum_dense():
    prob = tm.make_pendulum_problem()
    grid = prob.default_grid(31)
    controls = prob.control_candidates(9)
    vd = dense_vi(prob, grid, controls=controls, tol=1e-6, max_outer=4000, device="cpu").v
    return prob, grid, controls, vd.numpy()


def _jtt(cores, ranks):
    return JTT(tuple(jnp.asarray(c) for c in cores), jnp.asarray(ranks))


@pytest.mark.parametrize("case", ["pendulum", "quad5"])
def test_frozen_policy_rows_match_jax(case):
    if case == "pendulum":
        name, kw, shape, ranks, R, nc = "pendulum", {}, (31, 31), [6], 8, 9
    else:
        name, kw, shape, ranks, R, nc = "quadcopter", QUAD, (5,) * 6, [4] * 5, 6, 5
    jprob, tprob = jm.make_problem(name, **kw), tm.make_problem(name, **kw)
    jg = jprob.default_grid(shape)
    tg = port_grid(jg)
    cores, rk = random_tt_numpy(shape, ranks, R, seed=2)
    cores[0] = cores[0] * 30.0
    uc = np.asarray(jprob.control_candidates(nc), np.float32)
    rng = np.random.default_rng(3)
    idx = np.stack([rng.integers(0, n, 400) for n in shape], -1)
    want = jp_.frozen_policy_rows(jprob, jg, jnp.asarray(uc), _jtt(cores, rk),
                                  jnp.asarray(idx, jnp.int32))
    got = tp_.frozen_policy_rows(tprob, tg, torch.as_tensor(uc), tt_from_numpy(cores, rk, "cpu"),
                                 torch.as_tensor(idx))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # samples whose best two candidates tie may take either: hold the rest
    from c3sc_tpu_torch.ops import mca
    from c3sc_tpu_torch.solvers.ttvi import _pinned_neighbor_values

    x, vn = _pinned_neighbor_values(tprob, tg, tt_from_numpy(cores, rk, "cpu"),
                                    torch.as_tensor(idx), torch.float32)
    pp, pm, dt = mca.transition_all_controls(tprob, tg, x, torch.as_tensor(uc))
    g = mca.stage_cost_all(tprob, x, torch.as_tensor(uc))
    rhs_all = g * dt + torch.exp(-tprob.beta * dt) * (pp * vn[None, :, 0]
                                                      + pm * vn[None, :, 1]).sum(-1)
    top2 = torch.topk(rhs_all, 2, dim=0, largest=False).values
    tied = ((top2[1] - top2[0]) <= TIE * top2[0].abs().clamp(min=1.0)).numpy()
    assert tied.mean() < 0.2
    vmax = float(np.abs(np.asarray(want[2])).max())
    for a, b in ((got[1], want[1]), (got[2], want[2])):
        close(a.numpy()[~tied], np.asarray(b)[~tied], rtol=1e-5, atol=1e-5 * vmax)


@pytest.mark.parametrize("k", [0, 2, 5])
def test_frames_match_jax(k):
    shape = (5,) * 6
    cores, rk = random_tt_numpy(shape, [4] * 5, 6, seed=k)
    rng = np.random.default_rng(k)
    pts = np.stack([rng.integers(0, 5, 300) for _ in shape], -1)
    wl, wr = jp_._frames(tuple(jnp.asarray(c) for c in cores), jnp.asarray(pts, jnp.int32), k)
    gl, gr = tp_._frames(tt_from_numpy(cores, rk, "cpu").cores, torch.as_tensor(pts), k)
    for g, w in ((gl, wl), (gr, wr)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        close(g, w, rtol=1e-5, atol=1e-5 * max(np.abs(w).max(), 1e-30))


def test_normal_equations_and_row_gradient_match_jax():
    rng = np.random.default_rng(0)
    S, T, r1, r2, n = 300, 13, 5, 4, 9
    L = rng.standard_normal((S, T, r1)).astype(np.float32)
    R = rng.standard_normal((S, T, r2)).astype(np.float32)
    isl = rng.integers(0, n, (S, T))
    isl[:, 1] = isl[:, 0]                         # two stencil points on one node slice
    w = rng.standard_normal((S, T)).astype(np.float32)
    rhs = rng.standard_normal(S).astype(np.float32)
    x = rng.standard_normal(n * r1 * r2).astype(np.float32)
    j = [jnp.asarray(a) for a in (L, R, isl, w, rhs)]
    t = [torch.as_tensor(a) for a in (L, R, isl, w, rhs)]
    for got, want in ((tp_._rows_chunk(*t[:4], n), jp_._rows_chunk(*j[:4], n)),
                      *zip(tp_._normal_eq_chunk(*t, n), jp_._normal_eq_chunk(*j, n)),
                      *zip(tp_._row_grad_chunk(*t, torch.as_tensor(x), n),
                           jp_._row_grad_chunk(*j, jnp.asarray(x), n))):
        want = np.asarray(want)
        close(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_host_core_algebra_matches_jax():
    cores, rk = random_tt_numpy((5, 6, 7, 4), [3, 4, 2], 6, seed=4)
    jb = jp_.tt_to_blocks(_jtt(cores, rk))
    tb = tp_.tt_to_blocks(tt_from_numpy(cores, rk, "cpu"))
    for op in (lambda b: jp_.inflate_ranks(b, [1, 5, 6, 5, 1], seed=3),
               lambda b: jp_._orthogonalize(b, 2), lambda b: jp_._move_center(b, 2, True)):
        jb = op(jb)
    for op in (lambda b: tp_.inflate_ranks(b, [1, 5, 6, 5, 1], seed=3),
               lambda b: tp_._orthogonalize(b, 2), lambda b: tp_._move_center(b, 2, True)):
        tb = op(tb)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, b)
    back = tp_.blocks_to_tt(tb, 8, device="cpu")
    assert back.rmax == 8 and back.ranks.tolist() == [1] + [b.shape[2] for b in tb[:-1]] + [1]
    close(tt_full(back), np.einsum("aib,bjc,ckd,dle->ijkl", *tb), rtol=1e-5, atol=1e-5)


def test_rows_reproduce_bellman_defect(pendulum_dense):
    """Bar (a) of tests/test_pials.py on the port."""
    prob, grid, controls, vd = pendulum_dense
    v_tt = _repad(tt_from_dense(torch.as_tensor(vd), rmax=20, tol=1e-4), 24)
    rng = np.random.default_rng(3)
    idx = torch.as_tensor(np.stack([rng.integers(0, n, 512) for n in grid.shape], -1))
    uc = torch.as_tensor(controls, dtype=torch.float32)
    pts, w, rhs = tp_.frozen_policy_rows(prob, grid, uc, v_tt, idx)
    v_pts = tt_gather_eval(v_tt, pts.reshape(-1, grid.ndim)).reshape(pts.shape[:2])
    lhs = (torch.sum(w * v_pts, dim=1) - rhs).numpy()
    tv = make_bellman_kernel(prob, grid, controls, chunk=1024)(v_tt, idx).numpy()
    defect = tt_gather_eval(v_tt, idx).numpy() - tv
    assert np.max(np.abs(lhs - defect)) < 1e-3 * max(np.abs(vd).max(), 1.0)


def test_pials_preserves_near_exact(pendulum_dense):
    """Bars (b) and (c) of tests/test_pials.py on the port: from the rank-20
    start the solve keeps q95 < 0.002 of the range, and returns the best
    sampled-residual iterate (or the input, -1)."""
    prob, grid, controls, vd = pendulum_dense
    vrange = vd.max() - vd.min()
    v0 = _repad(tt_from_dense(torch.as_tensor(vd), rmax=20, tol=1e-6), 24)
    res = tp_.pi_als(prob, grid, controls, v0, rmax=24, schedule=((3, 20),), oversample=4.0,
                     chunk=8192, lam_rel=1e-1, device="cpu")
    q95 = np.quantile(np.abs(tt_full(res.v).numpy() - vd), 0.95) / vrange
    assert q95 < 0.002, q95
    bres = [r["bres_abs"] for r in res.history]
    assert len(bres) == 3
    assert res.best_outer == -1 or min(bres) == bres[res.best_outer]
    assert all(c.shape == (24, 31, 24) for c in res.v.cores)


def test_pials_6d_interior_cores_accept_only_improvements():
    """A 5^6 quadcopter start of rank 3 through one stage at cap 6 with the
    assembly chunked: the result is finite, padded to 8, and its sampled
    residual is at most the input's."""
    prob = tm.make_problem("quadcopter", **QUAD)
    grid = prob.default_grid(5)
    uc = prob.control_candidates(5)
    vd = dense_vi(prob, grid, controls=uc, tol=1e-5, max_outer=400, device="cpu").v
    v0 = _repad(tt_from_dense(vd, rmax=3, tol=1e-2), 8)
    res = tp_.pi_als(prob, grid, uc, v0, rmax=8, schedule=((2, 6),), oversample=2.0,
                     chunk=1000, refine_iters=2, device="cpu")
    assert all(torch.isfinite(c).all() for c in res.v.cores)
    assert res.v.rmax == 8 and int(res.v.ranks.max()) <= 6
    kernel = make_bellman_kernel(prob, grid, uc, chunk=32768)
    rng = np.random.default_rng(11)
    idx = torch.as_tensor(np.stack([rng.integers(0, n, 4096) for n in grid.shape], -1))

    def bres(v):
        return float((kernel(v, idx) - tt_gather_eval(v, idx)).abs().max())

    assert bres(res.v) <= bres(v0) + 1e-6
    assert [h["S"] for h in res.history] == [2 * 6 * 5 * 6] * 2
