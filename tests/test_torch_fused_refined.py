"""The port's residual solves (``base=``), its rectangular-maxvol scheme
(``oversample > 0``) and ``fused_tt_vi_refined`` against c3sc_tpu.solvers.fused
on the CPU, every call with device="cpu".

Bars, each stated at its test:
  (1) the fiber backup with a base: against the backup of the total minus
      the base (rtol 1e-5, atol 1e-5 x max|v|), and one iteration with a base
      from JAX's carry against JAX's (ranks equal, samples within
      1e-4 x max|v|, the bar of the square scheme's iteration test);
  (2) the refined round logic with both packages' ``fused_tt_vi`` replaced by
      one that returns the same given TTs: the same accept/reject sequence,
      ``refine_history`` within rtol 1e-5 and atol 1e-5 x max|v| (1e-5 for the
      normalised residual), and ``tt_full`` of the total
      within 1e-5 x max|v|; then the JAX test's bar
      (tests/test_fused.py::test_fused_refined_beats_plain_at_starved_rank)
      on the port;
  (3) ``_extend_rows`` and ``_interp_from_rows_ls`` against JAX's on seeded
      inputs with duplicate rows and tied leverages: the same rows, cores
      within rtol 1e-5, atol 1e-5 x max|G|; one oversampled iteration from
      JAX's carry as (1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import close, port_grid, random_tt_numpy
from c3sc_tpu import models as jm
from c3sc_tpu.ops.tt import TT as JTT
from c3sc_tpu.solvers import fused as jf
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import fused_carry_from_numpy, tt_from_numpy
from c3sc_tpu_torch.ops.tt import TT, _repad, tt_add, tt_from_dense, tt_full, tt_gather_eval
from c3sc_tpu_torch.solvers import dense_vi, fused_tt_vi, fused_tt_vi_refined, make_fused_vi
from c3sc_tpu_torch.solvers import fused as tf


def _jtt(cores, ranks):
    return JTT(tuple(jnp.asarray(c) for c in cores), jnp.asarray(ranks))


def _carry_to_port(jc):
    fields = {k: ([np.asarray(c) for c in v] if isinstance(v, tuple) else np.asarray(v))
              for k, v in jc._asdict().items()}
    return fused_carry_from_numpy(fields, "cpu")


def _block_idx(shape, k, left, right):
    R, d, n = left.shape[0], len(shape), shape[k]
    idx = np.zeros((R, n, R, d), np.int64)
    idx[..., :k] = left[:, None, None, :k]
    idx[..., k] = np.arange(n)[None, :, None]
    idx[..., k + 1:] = right[None, None, :, k + 1:]
    return idx.reshape(-1, d)


@pytest.mark.parametrize("k", [0, 2, 5])
def test_fiber_backup_with_base_is_total_backup_minus_base(k):
    """Bar (1): a base padded to 6 under a correction padded to 4 (the row
    counts of the base's evaluator are the correction's)."""
    tp = tm.make_problem("quadcopter", sigma_v=0.15, sigma_om=0.15)
    tg = tp.default_grid(5)
    shape, R, Rb = tg.shape, 4, 6
    uc = torch.as_tensor(tp.control_candidates(5), dtype=torch.float32)
    w = tt_from_numpy(*random_tt_numpy(shape, [4] * 5, R, seed=3), "cpu")
    bc, br = random_tt_numpy(shape, [6] * 5, Rb, seed=4)
    bc[0] = bc[0] * 40.0
    base = tt_from_numpy(bc, br, "cpu")
    rng = np.random.default_rng(5)
    left = torch.as_tensor(np.stack([rng.integers(1, 4, R) for _ in shape], -1))
    right = torch.as_tensor(np.stack([rng.integers(1, 4, R) for _ in shape], -1))
    got = tf.make_fiber_backup(tp, tg, uc, R, base=base)(w.cores, w.ranks, k, left, right)
    total = tt_add(_repad(w, R + Rb), _repad(base, R + Rb), on_overflow="raise")
    # the total's backup at its own padding, on the index sets padded with
    # zero rows; its leading [R, n, R] block is the correction's block
    pad = torch.nn.functional.pad
    want = tf.make_fiber_backup(tp, tg, uc, R + Rb)(
        total.cores, total.ranks, k, pad(left, (0, 0, 0, Rb)), pad(right, (0, 0, 0, Rb)))
    want = want[:R, :, :R]
    flat = torch.as_tensor(_block_idx(shape, k, left.numpy(), right.numpy()))
    want = want - tt_gather_eval(base, flat).reshape(R, shape[k], R)
    assert got.shape == (R, shape[k], R)
    close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("kw", [dict(base=True), dict(oversample=1.0)],
                         ids=["base", "oversample"])
def test_one_iteration_matches_jax(kw):
    """Bars (1) and (3): JAX's ``init_fn`` carry through
    ``fused_carry_from_numpy``, then ``step_fn`` on both sides; ranks, bond
    sizes and fit ranks equal after one iteration, samples within 1e-4 x
    max|v|, and within 1e-3 x max|v| after four more."""
    jp, tp = jm.make_problem("pendulum"), tm.make_problem("pendulum")
    jg = jp.default_grid(21)
    uc = jp.control_candidates(9)
    R = 8
    jkw, tkw = dict(kw), dict(kw)
    if "base" in kw:
        bc, br = random_tt_numpy(jg.shape, [5], 6, seed=7)
        bc[0] = bc[0] * 30.0
        jkw["base"], tkw["base"] = _jtt(bc, br), tt_from_numpy(bc, br, "cpu")
    js = jf.make_fused_vi(jp, jg, uc, rmax=R, **jkw)
    ts = make_fused_vi(tp, port_grid(jg), uc, rmax=R, device="cpu", **tkw)
    jc = js.init_fn(jax.random.key(0))
    tc = _carry_to_port(jc)
    jc, tc = js.step_fn(jc, 1), ts.step_fn(tc, 1)
    for f in ("ranks", "rl", "rr", "rlf", "rrf"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), f)
    vs = np.asarray(jc.v_sample)
    close(tc.v_sample, vs, rtol=0, atol=1e-4 * np.abs(vs).max())
    jc, tc = js.step_fn(jc, 4), ts.step_fn(tc, 4)
    vs = np.asarray(jc.v_sample)
    close(tc.v_sample, vs, rtol=0, atol=1e-3 * np.abs(vs).max())
    if "oversample" in kw:
        # the bonds carry more sample rows than their fit ranks
        assert (tc.rl[1:-1] >= tc.rlf[1:-1]).all() and (tc.rl > tc.rlf).any()


def _leverage_case(seed):
    """An orthonormal [m, R] basis with active rank 4 in padding 8, rows with
    equal leverage, and pivot rows with a duplicate id."""
    rng = np.random.default_rng(seed)
    m, R, r = 40, 8, 4
    q = np.zeros((m, R), np.float32)
    q[:, :r] = np.linalg.qr(rng.standard_normal((m, r)))[0]
    q[10] = q[11]                                  # tied leverages
    q[20, :r] = q[21, :r] = 0.25                   # another tie
    q[30:] = 0.0                                   # masked rows: leverage exactly 0
    rows = rng.permutation(30)[:R].astype(np.int64)
    # a selected row id repeated at a padding position, as the LU seed of
    # _pivot_rows leaves them (a scatter-set could unmark the selected row)
    rows[r + 1] = rows[0]
    return q, rows, r


@pytest.mark.parametrize("seed,s_rows", [(0, 8), (1, 6), (2, 4)])
def test_extend_rows_and_least_squares_core_match_jax(seed, s_rows):
    """Bar (3): the same rows (duplicates and ties included); the core within
    rtol 1e-5, atol 1e-5 x max|G|; masked columns and rows exactly zero."""
    q, rows, r = _leverage_case(seed)
    jq, tq = jnp.asarray(q), torch.as_tensor(q)
    jr, js = jnp.asarray(r, jnp.int32), jnp.asarray(s_rows, jnp.int32)
    tr, ts = torch.tensor(r, dtype=torch.int32), torch.tensor(s_rows, dtype=torch.int32)
    want_rows = np.asarray(jf._extend_rows(jq, jnp.asarray(rows, jnp.int32), jr, js))
    got_rows = tf._extend_rows(tq, torch.as_tensor(rows), tr, ts)
    np.testing.assert_array_equal(got_rows.numpy(), want_rows)
    assert got_rows.dtype == torch.int64
    want = np.asarray(jf._interp_from_rows_ls(jq, jnp.asarray(want_rows), jr, js))
    got = tf._interp_from_rows_ls(tq, got_rows, tr, ts)
    close(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert float(got[:, s_rows:].abs().max() if s_rows < 8 else 0.0) == 0.0
    if s_rows == r:
        # square: the least-squares core interpolates at its pivot rows
        sel = got_rows.numpy()[:r]
        if len(set(sel.tolist())) == r:
            close(got[sel, :r], np.eye(r), rtol=0, atol=1e-3)


def test_extend_rows_skips_selected_rows_under_duplicates():
    """A duplicate pivot id must never re-enter as an extension row (the
    scatter-max marking), and leverage ties go to the lowest index."""
    q = np.zeros((12, 4), np.float32)
    q[:, 0] = 0.5                                  # every row the same leverage
    rows = torch.tensor([5, 5, 0, 0])
    got = tf._extend_rows(torch.as_tensor(q), rows, torch.tensor(2), torch.tensor(4))
    want = jf._extend_rows(jnp.asarray(q), jnp.asarray([5, 5, 0, 0], jnp.int32),
                           jnp.asarray(2), jnp.asarray(4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [5, 5, 0, 1]


def _fake_solver(tts, calls, seed_key):
    """A stand-in for ``fused_tt_vi`` returning the given TTs in order and
    recording (seed, base) of every call."""
    it = iter(tts)

    def fake(problem, grid, controls=None, rmax=16, base=None, **kw):
        calls.append((kw.get(seed_key), base))
        v = next(it)
        sol = tf.FusedVISolution(v=v, residual=0.1 * len(calls), iterations=10, wall_time=0.5,
                                 carry=None, controls=np.asarray(controls))
        return sol
    return fake


def _round_tts(vd):
    """Base and four corrections as numpy (cores, ranks): a coarse base, a
    bad correction, then two corrections toward the dense value."""
    base = tt_from_dense(torch.as_tensor(vd), rmax=6, tol=3e-2)
    e1 = vd - tt_full(base).numpy()
    w1 = tt_from_dense(torch.as_tensor(e1), rmax=6, tol=1e-1)
    e2 = e1 - tt_full(w1).numpy()
    w2 = tt_from_dense(torch.as_tensor(e2), rmax=6, tol=1e-1)
    bad = tt_from_dense(torch.as_tensor(
        np.random.default_rng(0).standard_normal(vd.shape).astype(np.float32) * 5.0),
        rmax=6, tol=1e-1)
    return [(tuple(c.numpy() for c in t.cores), t.ranks.numpy()) for t in (base, bad, w1, w2)]


def test_refined_round_logic_matches_jax(monkeypatch):
    """Bar (2): the fixed sequence base, bad, w1, w2 through both packages'
    ``fused_tt_vi_refined`` (rounds=2): the bad round is rejected, w1 and w2
    accepted; each correction solve gets the running total as its base."""
    from c3sc_tpu.ops.tt import tt_full as jtt_full

    jp, tp = jm.make_problem("pendulum"), tm.make_problem("pendulum")
    jg = jp.default_grid(15)
    tg = port_grid(jg)
    uc = jp.control_candidates(5)
    vd = dense_vi(tp, tg, controls=uc, tol=1e-6, max_outer=3000, device="cpu").v.numpy()
    seq = _round_tts(vd)
    jcalls, tcalls = [], []
    monkeypatch.setattr(jf, "fused_tt_vi", _fake_solver([_jtt(c, r) for c, r in seq],
                                                        jcalls, "key"))
    monkeypatch.setattr(tf, "fused_tt_vi", _fake_solver([tt_from_numpy(c, r, "cpu")
                                                         for c, r in seq], tcalls, "seed"))
    want = jf.fused_tt_vi_refined(jp, jg, controls=uc, rounds=2, rmax=6,
                                  key=jax.random.key(0))
    got = fused_tt_vi_refined(tp, tg, controls=uc, rounds=2, rmax=6, seed=[0, 1, 2, 3, 4],
                              device="cpu")
    assert [c[0] for c in tcalls] == [0, 1, 2, 3]
    assert [c[1] is None for c in tcalls] == [True, False, False, False]
    assert [h.get("accepted") for h in got.refine_history] == [None, False, True, True]
    assert [h.get("accepted") for h in want.refine_history] == [None, False, True, True]
    vmax = float(np.abs(vd).max())
    for g, w in zip(got.refine_history, want.refine_history):
        assert g["round"] == w["round"] and g["residual"] == w["residual"]
        # the sampled residual is a difference of values near max|v|: f32
        # rounding, rtol 1e-5 and atol 1e-5 x max|v| (1e-5 once normalised)
        np.testing.assert_allclose(g["bellman_res_abs"], w["bellman_res_abs"], rtol=1e-5,
                                   atol=1e-5 * vmax)
        np.testing.assert_allclose(g["bellman_res"], w["bellman_res"], rtol=1e-5, atol=1e-5)
    # each correction's base is the running total: base, base, base + w1
    close(tt_full(tcalls[3][1]), tt_full(tt_from_numpy(*seq[0], "cpu"))
          + tt_full(tt_from_numpy(*seq[2], "cpu")), rtol=1e-5, atol=1e-5 * np.abs(vd).max())
    full_w = np.asarray(jtt_full(want.v))
    close(tt_full(got.v), full_w, rtol=1e-5, atol=1e-5 * np.abs(full_w).max())
    assert got.iterations == want.iterations == 40
    assert got.residual == pytest.approx(want.residual)


def test_seed_stream():
    """An int draws the sub-solves' seeds from default_rng(seed); a sequence
    gives them in order (an item may be a pair) and must be long enough."""
    from c3sc_tpu_torch.seeds import seed_stream

    a, b = seed_stream(5, 3), np.random.default_rng(5)
    assert [a() for _ in range(3)] == [int(b.integers(0, 2**31)) for _ in range(3)]
    s = seed_stream((7, (8, 9)), 2)
    assert (s(), s()) == (7, (8, 9))
    with pytest.raises(ValueError):
        seed_stream([1], 3)


def test_refined_beats_plain_at_starved_rank():
    """The JAX test's bar on the port: pendulum 21^2, rank 8, 5 candidates,
    two rounds; refined q95 < 0.04 and < plain / 3; the sampled Bellman
    residual strictly falls over the accepted rounds."""
    prob = tm.make_pendulum_problem()
    grid = prob.default_grid(21)
    uc = prob.control_candidates(5)
    vd = dense_vi(prob, grid, controls=uc, tol=1e-6, max_outer=3000, device="cpu").v.numpy()
    vrange = vd.max() - vd.min()
    kw = dict(controls=uc, rmax=8, tol=1e-4, max_iters=800, patience=20, device="cpu")
    plain = fused_tt_vi(prob, grid, seed=0, **kw)
    q95_plain = np.quantile(np.abs(tt_full(plain.v).numpy() - vd) / vrange, 0.95)
    ref = fused_tt_vi_refined(prob, grid, rounds=2, seed=0, **kw)
    q95_ref = np.quantile(np.abs(tt_full(ref.v).numpy() - vd) / vrange, 0.95)
    accepted = [h for h in ref.refine_history[1:] if h["accepted"]]
    assert len(accepted) >= 1
    bres = [ref.refine_history[0]["bellman_res"]] + [h["bellman_res"] for h in accepted]
    assert all(b2 < b1 for b1, b2 in zip(bres, bres[1:])), bres
    assert q95_ref < 0.04, f"refined q95 {q95_ref:.3%}"
    assert q95_ref < q95_plain / 3, (q95_ref, q95_plain)
    assert isinstance(ref.v, TT) and ref.v.rmax == 8 * (1 + len(accepted))
