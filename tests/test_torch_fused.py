"""The port's fused TT value iteration (c3sc_tpu_torch.solvers.fused) against
c3sc_tpu.solvers.fused on the CPU, at small sizes, every call with
device="cpu".

Bars, each stated at its test:
  (a)  the structured fiber evaluator against JAX and against independent
       gather-evals: rtol 1e-5 (2e-4 against the gathers, as the JAX
       package's own test), atol 1e-5 x max|v|;
  (a') the fiber backup (block K2) against a direct computation;
  (b)  one iteration from an identical carry: ranks equal, pivot rows equal
       (or the first flipped core is reported and values alone are held),
       samples within 1e-4 x max|v|; five iterations within 1e-3 x max|v|;
  (c)  full solves against the port's dense solve: relative sup error < 3 %,
       the bar of tests/test_fused.py.
Full solves are held on values, never on pivots or iteration counts: pivots
flip on float32 ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import QUAD, close, no_process_group, port_grid, random_tt_numpy
from c3sc_tpu import models as jm
from c3sc_tpu.ops.tt import TT as JTT
from c3sc_tpu.solvers import fused as jf
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import fused_carry_from_numpy, tt_from_numpy
from c3sc_tpu_torch.ops import mca
from c3sc_tpu_torch.ops.tt import TT, tt_gather_eval
from c3sc_tpu_torch.solvers import dense_vi, fused_tt_vi, make_fused_vi, pad_fused_carry
from c3sc_tpu_torch.solvers import fused as tf

FIBER_CASES = {"quad5": ("quadcopter", QUAD, (5,) * 6, 4, 5),
               "pendulum": ("pendulum", {}, (21, 17), 6, 9)}


def _fiber_case(case, seed=0, scale=1.0, interior=False):
    """(jax problem, port problem, jax grid, port grid, candidates, rmax,
    numpy cores, numpy ranks, left [R, d], right [R, d]). ``interior`` keeps
    the index rows off the faces, so that not every block node is terminal."""
    name, kw, shape, R, nc = FIBER_CASES[case]
    jp, tp = jm.make_problem(name, **kw), tm.make_problem(name, **kw)
    jg = jp.default_grid(shape)
    d = len(shape)
    cores, ranks = random_tt_numpy(shape, [R] * (d - 1), R, seed)
    cores[0] = cores[0] * scale
    rng = np.random.default_rng(seed + 1)
    lo, hi = (1, -1) if interior else (0, 0)
    left = np.stack([rng.integers(lo, n + hi, R) for n in shape], -1)
    right = np.stack([rng.integers(lo, n + hi, R) for n in shape], -1)
    return jp, tp, jg, port_grid(jg), jp.control_candidates(nc), R, cores, ranks, left, right


def _block_idx(shape, k, left, right):
    """The fiber block's multi-indices [R * n_k * R, d], built with numpy."""
    R, d, n = left.shape[0], len(shape), shape[k]
    idx = np.zeros((R, n, R, d), np.int64)
    idx[..., :k] = left[:, None, None, :k]
    idx[..., k] = np.arange(n)[None, :, None]
    idx[..., k + 1:] = right[None, None, :, k + 1:]
    return idx.reshape(-1, d)


@pytest.mark.parametrize("case,k", [("quad5", k) for k in range(6)]
                         + [("pendulum", k) for k in range(2)])
def test_structured_fiber_eval_matches_jax_and_gathers(case, k):
    """Bar (a): vp, vm, v0 of core k."""
    _, _, jg, tg, _, R, cores, ranks, left, right = _fiber_case(case)
    jcores = tuple(jnp.asarray(c) for c in cores)
    tt = tt_from_numpy(cores, ranks, "cpu")
    want = jf.make_structured_fiber_eval(jg, k, R)(jcores, jnp.asarray(left, jnp.int32),
                                                   jnp.asarray(right, jnp.int32))
    got = tf.make_structured_fiber_eval(tg, k, R)(tt.cores, torch.as_tensor(left),
                                                  torch.as_tensor(right))
    vmax = float(np.abs(np.asarray(want[2])).max())
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w, rtol=1e-5, atol=1e-5 * vmax)
    # and against independent gather-evals at the shifted indices
    d, n = tg.ndim, tg.shape[k]
    flat = torch.as_tensor(_block_idx(tg.shape, k, left, right))
    close(got[2], tt_gather_eval(tt, flat).reshape(R, n, R), rtol=2e-4, atol=2e-5 * vmax)
    for m in range(d):
        for sign, v_struct in ((1, got[0]), (-1, got[1])):
            ref = tt_gather_eval(tt, tg.neighbor_index(flat, m, sign)).reshape(R, n, R)
            close(v_struct[m], ref, rtol=2e-4, atol=2e-5 * vmax)


@pytest.mark.parametrize("case,k", [("quad5", 0), ("quad5", 2), ("quad5", 5), ("pendulum", 1)])
def test_fiber_backup_matches_direct_computation(case, k):
    """Bar (a'): the port's ``_eval_fibers`` (``make_fiber_backup``) against
    gather-evals of the neighbours, the per-candidate ``mca.transition``
    stencil and a min: rtol 1e-5, atol 1e-5 x max|v|. (The JAX closure is not
    reachable from outside; JAX is compared through the one-iteration runs.)"""
    _, tp, _, tg, uc_np, R, cores, ranks, left, right = _fiber_case(case, seed=3, scale=40.0,
                                                                   interior=True)
    tt = tt_from_numpy(cores, ranks, "cpu")
    uc = torch.as_tensor(uc_np, dtype=torch.float32)
    got = tf.make_fiber_backup(tp, tg, uc, R)(tt.cores, tt.ranks, k, torch.as_tensor(left),
                                              torch.as_tensor(right))
    d, n = tg.ndim, tg.shape[k]
    assert got.shape == (R, n, R) and torch.isfinite(got).all()
    flat = torch.as_tensor(_block_idx(tg.shape, k, left, right))
    x = tg.index_to_state(flat)
    lo, hi = tp.value_bounds
    vn = []
    for sign in (1, -1):
        per_dim = []
        for m in range(d):
            nb = tg.neighbor_index(flat, m, sign)
            v = torch.clamp(tt_gather_eval(tt, nb), lo, hi)
            mask, pinned = mca.node_terminal(tp, tg, nb, tg.index_to_state(nb))
            per_dim.append(torch.where(mask, pinned, v))
        vn.append(torch.stack(per_dim, -1))                     # [B, d]
    rhs = []
    for u in uc:
        pp, pm, dt = mca.transition(tp, tg, x, u.expand(x.shape[0], -1))
        g = tp.stage_cost(x, u.expand(x.shape[0], -1))
        rhs.append(g * dt + torch.exp(-tp.beta * dt) * (pp * vn[0] + pm * vn[1]).sum(-1))
    want = torch.clamp(torch.stack(rhs).min(0).values, lo, hi)
    mask, pinned = mca.node_terminal(tp, tg, flat, x)
    want = torch.where(mask, pinned, want).reshape(R, n, R)
    assert not mask.all() and ((case, k) != ("quad5", 0) or mask.any())
    close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def _carry_to_port(jc):
    fields = {k: ([np.asarray(c) for c in v] if isinstance(v, tuple) else np.asarray(v))
              for k, v in jc._asdict().items()}
    return fused_carry_from_numpy(fields, "cpu")


@pytest.mark.parametrize("name,n,nc,R", [("lq", 21, 9, 6), ("pendulum", 21, 9, 8)])
def test_one_and_five_iterations_match_jax(name, n, nc, R):
    """Bar (b): JAX's ``init_fn`` carry through ``fused_carry_from_numpy``,
    then ``step_fn`` on both sides."""
    jp, tp = jm.make_problem(name), tm.make_problem(name)
    jg = jp.default_grid(n)
    uc = jp.control_candidates(nc)
    js = jf.make_fused_vi(jp, jg, uc, rmax=R)
    ts = make_fused_vi(tp, port_grid(jg), uc, rmax=R, device="cpu")
    jc = js.init_fn(jax.random.key(0))
    tc = _carry_to_port(jc)
    # the port's own init draws the same pivot sets from the same integer
    own = ts.init_fn(0)
    for f in ("left", "right", "rl", "rr", "rlf", "rrf", "warm_until"):
        np.testing.assert_array_equal(getattr(own, f).numpy(), np.asarray(getattr(jc, f)))

    jc, tc = js.step_fn(jc, 1), ts.step_fn(tc, 1)
    assert int(tc.it) == int(jc.it) == 1
    for f in ("ranks", "rl", "rr"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    vs = np.asarray(jc.v_sample)
    close(tc.v_sample, vs, rtol=0, atol=1e-4 * np.abs(vs).max())
    values_only = None
    for f in ("rows_l", "rows_r"):
        differ = np.nonzero((getattr(tc, f).numpy() != np.asarray(getattr(jc, f))).any(-1))[0]
        if differ.size and values_only is None:
            values_only = f"first pivot tie flipped in {f} at core {int(differ[0])}"
    if values_only:
        print(values_only + "; values alone are held from here on")

    jc, tc = js.step_fn(jc, 4), ts.step_fn(tc, 4)
    assert int(tc.it) == int(jc.it) == 5
    vs = np.asarray(jc.v_sample)
    close(tc.v_sample, vs, rtol=0, atol=1e-3 * np.abs(vs).max())
    assert tc.ranks.dtype == torch.int32 and tc.it.dtype == torch.int32
    assert tc.left.dtype == torch.int64 and tc.frozen.dtype == torch.bool


def _fit_matrix(seed, m=40, R=8, r=5):
    """A rank-r [m, R] matrix with a clear spectrum, rows beyond 32 masked."""
    rng = np.random.default_rng(seed)
    C = (rng.standard_normal((m, r)) * np.logspace(0, -2, r)) @ rng.standard_normal((r, R))
    row_mask = (np.arange(m) < 32).astype(np.float32)
    noise = rng.standard_normal((m, R)).astype(np.float32)
    return (C * row_mask[:, None]).astype(np.float32), noise, row_mask


@pytest.mark.parametrize("frozen", [False, True])
def test_orth_basis_and_rank_matches_jax(frozen):
    """``r_need``, ``r_new`` exact, and the projector onto the KEPT columns
    (not ``qe``: QR leaves the signs free) within 1e-4.

    The kick columns are not compared with JAX. The fiber matrix has rank
    ``r_need`` < R, so QR returns arbitrary unit columns beyond it, and the
    kick noise is orthogonalised against ALL of q, those columns included:
    two LAPACK builds give two different, equally valid kick columns. They
    are held to what the solver needs of them: unit norm, orthogonal to the
    kept columns, zero on the masked rows.
    """
    C, noise, row_mask = _fit_matrix(0)
    jq, jneed, jnew = jf._orth_basis_and_rank(
        jnp.asarray(C), jnp.asarray(noise), 1e-4, 2, jnp.asarray(8), jnp.asarray(row_mask),
        jnp.asarray(4, jnp.int32), jnp.asarray(frozen))
    tq, tneed, tnew = tf._orth_basis_and_rank(
        torch.as_tensor(C), torch.as_tensor(noise), 1e-4, 2, torch.tensor(8),
        torch.as_tensor(row_mask), torch.tensor(4, dtype=torch.int32), torch.tensor(frozen))
    assert int(tneed) == int(jneed) == 5
    assert int(tnew) == int(jnew) == (4 if frozen else 7)
    assert tnew.dtype == torch.int32
    r_keep = 4 if frozen else 5
    jq = np.asarray(jq)
    close(tq[:, :r_keep] @ tq[:, :r_keep].T, jq[:, :r_keep] @ jq[:, :r_keep].T, rtol=0, atol=1e-4)
    assert float(tq[32:].abs().max()) == 0.0 and float(tq[:, int(tnew):].abs().max()) == 0.0
    kickcols = tq[:, r_keep:int(tnew)]
    if not frozen:
        close(torch.linalg.norm(kickcols, dim=0), np.ones(2), rtol=0, atol=1e-5)
        close(tq[:, :r_keep].T @ kickcols, np.zeros((r_keep, 2)), rtol=0, atol=1e-5)


def test_pivot_rows_and_interp_match_jax():
    """On an orthonormal basis without ties the pivot rows are equal; the
    interpolation core within 1e-4; G[rows] is the identity on the active
    block and the padded columns are exactly zero."""
    rng = np.random.default_rng(1)
    q = np.linalg.qr(rng.standard_normal((60, 8)))[0].astype(np.float32)
    q[:, 6:] = 0.0                                              # active rank 6
    r_new = 6
    jrows = np.array(jf._pivot_rows(jnp.asarray(q), jnp.asarray(r_new)))
    trows = tf._pivot_rows(torch.as_tensor(q), torch.tensor(r_new))
    np.testing.assert_array_equal(trows.numpy()[:r_new], jrows[:r_new])
    jG = jf._interp_from_rows(jnp.asarray(q), jnp.asarray(jrows), jnp.asarray(r_new))
    tG = tf._interp_from_rows(torch.as_tensor(q), torch.as_tensor(jrows), torch.tensor(r_new))
    close(tG, jG, rtol=0, atol=1e-4)
    close(tG[jrows[:r_new], :r_new], np.eye(r_new), rtol=0, atol=1e-4)
    assert float(tG[:, r_new:].abs().max()) == 0.0
    assert float(tG.abs().max()) <= 1.05 + 1e-4                 # maxvol bound after the swaps
    close(tf._logvol(torch.as_tensor(q), torch.as_tensor(jrows), torch.tensor(r_new)),
          jf._logvol(jnp.asarray(q), jnp.asarray(jrows), jnp.asarray(r_new)), rtol=1e-4, atol=1e-5)


def test_ties_break_by_lowest_index():
    """Masked rows have norm exactly 0: the stable sort keeps their order and
    the first-index argmax is the same on every device."""
    a = torch.tensor([1.0, 3.0, 3.0, 0.0, 3.0])
    assert int(tf._first_argmax(a)) == 1 == int(jnp.argmax(jnp.asarray(a.numpy())))
    assert int(tf._first_argmax(torch.tensor([1.0, float("nan"), 5.0]))) == 1
    q = np.zeros((12, 2), np.float32)
    q[3], q[7] = (1.0, 0.0), (0.0, 1.0)
    rows = tf._pivot_rows(torch.as_tensor(q), torch.tensor(2))
    jrows = jf._pivot_rows(jnp.asarray(q), jnp.asarray(2))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))


@pytest.mark.parametrize("r_need,r_adapt,r_prev", [(3, 5, 4), (4, 6, 4), (5, 7, 4), (4, 3, 4)])
def test_hysteresis_rank_matches_jax(r_need, r_adapt, r_prev):
    got = tf._hysteresis_rank(*(torch.tensor(v, dtype=torch.int32)
                                for v in (r_need, r_adapt, r_prev)))
    want = jf._hysteresis_rank(*(jnp.asarray(v, jnp.int32) for v in (r_need, r_adapt, r_prev)))
    assert int(got) == int(want)


@pytest.mark.parametrize("name,kw,n,nc,rmax", [
    ("lq", dict(sigma=1.0, beta=1.0), 31, 15, 10),
    ("pendulum", dict(beta=0.5, sigma=0.5), 31, 9, 16)], ids=["lq", "pendulum"])
def test_fused_vi_matches_dense(name, kw, n, nc, rmax):
    """Bar (c): relative sup error under 3 % against the port's dense solve."""
    prob = tm.make_problem(name, **kw)
    grid = prob.default_grid(n)
    controls = prob.control_candidates(nc)
    dense = dense_vi(prob, grid, controls=controls, tol=1e-5, max_outer=400, chunk=100,
                     device="cpu")
    sol = fused_tt_vi(prob, grid, controls=controls, rmax=rmax, seed=0, tol=2e-4,
                      max_iters=3000, device="cpu")
    v_tt = tt_gather_eval(sol.v, grid.node_indices("cpu")).numpy()
    v_dense = dense.v.numpy().ravel()
    err = np.abs(v_tt - v_dense).max() / np.abs(v_dense).max()
    assert err < 0.03, f"fused vs dense sup error {err:.4f} (it={sol.iterations})"
    assert sol.iterations <= 3000 and np.isfinite(sol.residual)
    assert sol.v.cores[0].device.type == "cpu" and sol.probe_cost == float("inf")


def _lq21(rmax, **kw):
    prob = tm.make_problem("lq", sigma=1.0, beta=1.0)
    grid = prob.default_grid(21)
    return prob, grid, make_fused_vi(prob, grid, prob.control_candidates(9), rmax=rmax,
                                     device="cpu", **kw)


def test_masked_loop_enqueued_blind_equals_stepping_with_a_host_check():
    """``run_fn(carry, 200)`` without a host read ends at the same iteration
    and the same cores as one iteration at a time with the loop condition
    checked on the host (an iteration that leaves ``it`` unchanged is the
    condition being false)."""
    _, _, solver = _lq21(6, tol=2e-3, max_iters=400)
    start = solver.init_fn(0)
    blind = solver.run_fn(start, 200)
    c = start
    for _ in range(200):
        nxt = solver.run_fn(c, 1)
        if int(nxt.it) == int(c.it):
            break
        c = nxt
    assert 1 < int(c.it) < 200, "the case must stop by its own condition inside the chunk"
    assert int(blind.it) == int(c.it)
    for a, b in zip(blind.cores, c.cores):
        assert torch.equal(a, b)
    assert torch.equal(blind.v_sample, c.v_sample) and torch.equal(blind.ranks, c.ranks)
    # and solve_fn, chunk by chunk, stops there too
    assert int(solver.solve_fn(start).it) == int(c.it)
    # step_fn is unmasked: it goes on past the stopping state
    assert int(solver.step_fn(blind, 2).it) == int(c.it) + 2


def test_warm_restart_continues():
    prob, grid, _ = _lq21(8)
    kw = dict(n_controls=9, rmax=8, seed=1, device="cpu")
    sol1 = fused_tt_vi(prob, grid, tol=0.0, max_iters=30, **kw)
    assert sol1.iterations == 30
    sol2 = fused_tt_vi(prob, grid, tol=1e-4, max_iters=2000, carry=sol1.carry, **kw)
    assert sol2.iterations > 30
    assert sol2.residual < sol1.residual


def test_rank_cap_growth_and_padding_keep_values():
    prob, grid, _ = _lq21(6)
    controls = prob.control_candidates(9)
    dense = dense_vi(prob, grid, controls=controls, tol=1e-5, max_outer=400, chunk=100,
                     device="cpu")
    events = []

    class Metrics:
        def log(self, name, **fields):
            events.append((name, fields))

    sol = fused_tt_vi(prob, grid, controls=controls, rmax=6, rmax_max=14, seed=0, tol=2e-4,
                      max_iters=1500, metrics=Metrics(), device="cpu")
    idx = grid.node_indices("cpu")
    v_dense = dense.v.numpy().ravel()
    err = np.abs(tt_gather_eval(sol.v, idx).numpy() - v_dense).max() / np.abs(v_dense).max()
    assert err < 0.03, err
    assert 6 <= sol.v.rmax <= 14
    names = [n for n, _ in events]
    assert "fused_vi" in names
    rec = dict(events[names.index("fused_vi")][1])
    assert {"iter", "residual", "long_res", "wstall", "frozen", "ranks"} <= set(rec)
    grown = [f for n, f in events if n == "fused_rank_growth"]
    assert all(f["rmax_to"] > f["rmax_from"] for f in grown)
    # zero-padding a carry changes no value, and the padded carry steps on
    padded = pad_fused_carry(sol.carry, sol.v.rmax + 4)
    assert padded.cores[0].shape[0] == sol.v.rmax + 4 == padded.left.shape[1]
    close(tt_gather_eval(TT(padded.cores, padded.ranks), idx),
          tt_gather_eval(TT(sol.carry.cores, sol.carry.ranks), idx), rtol=1e-5, atol=1e-5)
    assert pad_fused_carry(sol.carry, sol.v.rmax) is sol.carry


@pytest.mark.parametrize("mode,kw", [("frozen", dict(target_mode="frozen", n_inner=2)),
                                     ("identity", dict(debug_identity=True))])
def test_frozen_target_and_debug_identity_match_jax(mode, kw):
    """Three iterations of the other two sweep modes from JAX's carry; the
    identity mode starts from a rank-3 target, which it must reproduce."""
    jp, tp = jm.make_problem("lq"), tm.make_problem("lq")
    jg = jp.default_grid(21)
    uc = jp.control_candidates(9)
    js = jf.make_fused_vi(jp, jg, uc, rmax=6, **kw)
    ts = make_fused_vi(tp, port_grid(jg), uc, rmax=6, device="cpu", **kw)
    v0 = None
    if mode == "identity":
        cores, ranks = random_tt_numpy(jg.shape, [3], 6, seed=2)
        v0 = JTT(tuple(jnp.asarray(c) for c in cores), jnp.asarray(ranks))
    jc = js.init_fn(jax.random.key(0), v0)
    tc = _carry_to_port(jc)
    before = np.asarray(jc.v_sample)
    jc, tc = js.step_fn(jc, 3), ts.step_fn(tc, 3)
    vs = np.asarray(jc.v_sample)
    close(tc.v_sample, vs, rtol=0, atol=1e-3 * np.abs(vs).max())
    np.testing.assert_array_equal(tc.ranks.numpy(), np.asarray(jc.ranks))
    if mode == "identity":
        close(tc.v_sample, before, rtol=0, atol=1e-4 * np.abs(before).max())


def test_probe_harvest_runs_and_validates():
    """``probe_rollouts > 0``: the probe runs at window boundaries only, the
    harvest keeps a finite best cost, and the validation probe reports it."""
    prob = tm.make_problem("pendulum")
    grid = prob.default_grid(21)
    events = []

    class Metrics:
        def log(self, name, **fields):
            events.append((name, fields))

    sol = fused_tt_vi(prob, grid, n_controls=9, rmax=8, seed=0, tol=0.0, max_iters=40,
                      window=20, probe_rollouts=8, probe_steps=30, metrics=Metrics(),
                      device="cpu")
    assert sol.iterations == 40 and np.isfinite(sol.probe_cost)
    probes = [f for n, f in events if n == "fused_vi"]
    assert [f["iter"] for f in probes] == [20, 40]
    assert all(np.isfinite(f["probe_cost"]) and np.isfinite(f["best_cost"]) for f in probes)
    val = [f for n, f in events if n == "fused_validation_probe"]
    assert len(val) == 1 and sol.probe_cost == pytest.approx(min(val[0].values()))


@pytest.mark.parametrize("kw,waits_for", [
    (dict(mesh=object()), "multi-GPU"),
    (dict(checkpoint_path="x.npz"), "checkpoint"),
    (dict(resume_from="x.npz"), "checkpoint"),
])
def test_options_not_ported_raise(kw, waits_for, tmp_path, monkeypatch):
    """Every option this test once held to its raise is ported now.
    ``mesh=`` (the multi-GPU fiber sharding): on a world of one (gloo, this
    process) a solve equals the unsharded one bit for bit, and an object that
    is no device mesh is refused (tests/test_torch_parallel.py holds 4
    ranks). ``checkpoint_path`` and ``resume_from``: a one-iteration solve
    writes the file and a resume from it continues
    (tests/test_torch_resume.py holds the resume bit for bit)."""
    prob = tm.make_problem("lq")
    run = dict(n_controls=3, rmax=4, device="cpu")
    if waits_for == "multi-GPU":
        from c3sc_tpu_torch.parallel import make_mesh

        with pytest.raises(TypeError, match="DeviceMesh"):
            fused_tt_vi(prob, prob.default_grid(11), max_iters=1, **run, **kw)
        with no_process_group():
            one, sharded = (fused_tt_vi(prob, prob.default_grid(11), max_iters=3, **run, mesh=m)
                            for m in (None, make_mesh(device="cpu")))
        assert int(sharded.carry.it) == 3
        assert all(torch.equal(a, b) for a, b in zip(one.v.cores, sharded.v.cores))
        return
    monkeypatch.chdir(tmp_path)
    first = fused_tt_vi(prob, prob.default_grid(11), max_iters=1, checkpoint_path="x.npz", **run)
    assert int(first.carry.it) == 1
    sol = fused_tt_vi(prob, prob.default_grid(11), max_iters=2, **run, **kw)
    assert int(sol.carry.it) == 2


def test_functions_not_ported_raise():
    """``_cholqr2`` still waits for an option that selects it; the
    rectangular-maxvol helpers and ``fused_tt_vi_refined`` are ported (their
    tests: tests/test_torch_fused_refined.py) and no longer raise."""
    q = torch.zeros(4, 2)
    with pytest.raises(NotImplementedError, match="waits for"):
        tf._cholqr2(q)
    rows = tf._extend_rows(q, torch.tensor([0, 1]), torch.tensor(1), torch.tensor(2))
    assert rows.tolist() == [0, 1]
    assert tf._interp_from_rows_ls(q, rows, torch.tensor(1), torch.tensor(2)).shape == (4, 2)
    prob = tm.make_problem("lq")
    with pytest.raises(ValueError):   # a CUDA graph needs a CUDA device
        make_fused_vi(prob, prob.default_grid(11), prob.control_candidates(3), rmax=4,
                      device="cpu", cuda_graph=True)


def test_fused_entry_points_default_to_the_card():
    """``device=None`` means the CUDA device; without one torch raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal shows only without one")
    prob = tm.make_problem("lq")
    with pytest.raises((RuntimeError, AssertionError)):
        fused_tt_vi(prob, prob.default_grid(11), n_controls=3, rmax=4, max_iters=1)


@pytest.mark.parametrize("seed", range(6))
def test_sync_free_rank_count_matches_svdvals(seed):
    """The count that CUDA solves use in place of ``svdvals`` (Gram in
    float64, power iteration, Jacobi's sign-change rule on the leading
    minors) against the SVD's count, on triangular factors of matrices with
    rank 1..R, masked columns, and a zero matrix."""
    rng = np.random.default_rng(seed)
    R = 8 + 4 * (seed % 3)
    for rank in (0, 1, 3, R // 2, R - 1, R):
        spectrum = np.logspace(0, -2.5, max(rank, 1))
        C = (rng.standard_normal((5 * R, max(rank, 1))) * spectrum) @ rng.standard_normal(
            (max(rank, 1), R)) * (rank > 0) * 10.0 ** rng.integers(-3, 4)
        C[:, R - 2:] = 0.0 if rank < R else C[:, R - 2:]      # masked columns
        rfac = torch.linalg.qr(torch.as_tensor(C, dtype=torch.float32)).R
        want = tf._needed_rank(rfac, 1e-4)
        got = tf._needed_rank_sync_free(rfac, 1e-4)
        assert got.dtype == torch.int32 and int(got) == int(want), (rank, int(got), int(want))


def test_sync_free_solve_matches_the_svd_count_solve():
    """``sync_free=True`` (the CUDA default) changes how the rank is counted,
    not what is solved: 40 iterations of both on the pendulum give the same
    ranks and pivot rows, and samples within 1e-5 x max|v|."""
    prob = tm.make_problem("pendulum")
    grid = prob.default_grid(21)
    uc = prob.control_candidates(9)
    a = make_fused_vi(prob, grid, uc, rmax=8, device="cpu")
    b = make_fused_vi(prob, grid, uc, rmax=8, device="cpu", sync_free=True)
    ca, cb = a.step_fn(a.init_fn(0), 40), b.step_fn(b.init_fn(0), 40)
    assert torch.equal(ca.ranks, cb.ranks) and torch.equal(ca.rows_l, cb.rows_l)
    close(cb.v_sample, ca.v_sample, rtol=0, atol=1e-5 * float(ca.v_sample.abs().max()))
