"""The port's Bellman kernel, two-site polish and slow-mode corrections
(c3sc_tpu_torch.solvers.ttvi.make_bellman_kernel, c3sc_tpu_torch.solvers
.polish) against the JAX package on the CPU, every call on device "cpu".

Bars, each stated at its test:
  - ``make_bellman_kernel``: float32 rounding, rtol 1e-5 with atol 1e-5 x
    max|v|;
  - the host linear algebra (maxvol, rank rule, row selection): identical
    (both packages run the same float64 numpy);
  - ``_fit2site`` from an identical ``CrossState``: the index sets equal
    (no maxvol tie occurs on these inputs), the fitted TT's node values
    within 1e-4 x max|v|;
  - ``tt_polish`` from an identical state: the same best step, per-step
    residuals within 1e-4 relative, values within 1e-4 x max|v|;
  - ``level_correct``: the mean defect within 1e-6 x max|v| (float32
    rounding of a mean of backups), the slope within 1e-5, the shift
    d / (1 - s) within that defect bar amplified by 1 / (1 - s) (plus 1e-3
    relative); the result within 1e-4 x max|v|;
  - ``mode_correct``: coefficients within 1e-3 (relative and absolute) and the
    result within 1e-4 x max|v|.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import QUAD, random_tt_numpy
from c3sc_tpu import models as jm
from c3sc_tpu.ops import tt as jtt
from c3sc_tpu.ops.cross import init_cross_state as j_init_cross_state
from c3sc_tpu.solvers import polish as jpol
from c3sc_tpu.solvers.dense import dense_vi as j_dense_vi
from c3sc_tpu.solvers.ttvi import make_bellman_kernel as j_kernel
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import cross_state_from_numpy, tt_from_numpy
from c3sc_tpu_torch.ops import tt as ttt
from c3sc_tpu_torch.solvers import polish as tpol
from c3sc_tpu_torch.solvers.ttvi import make_bellman_kernel

CPU = "cpu"


def to_port(jt):
    """A JAX TT as the port's, on the CPU."""
    return tt_from_numpy([np.asarray(c) for c in jt.cores], np.asarray(jt.ranks), CPU)


def full(t):
    return np.asarray(jtt.tt_full(t)) if not isinstance(t, ttt.TT) else ttt.tt_full(t).numpy()


@pytest.fixture(scope="module")
def pendulum():
    """Pendulum 31^2 (9 candidates), its JAX dense solve, and a TT of that
    solve (rank at most 10, padded to 16) shifted by a constant 3 (a level
    error to correct)."""
    jp, tp = jm.make_problem("pendulum"), tm.make_problem("pendulum")
    jg, tg = jp.default_grid(31), tp.default_grid(31)
    uc = jp.control_candidates(9)
    vd = np.asarray(j_dense_vi(jp, jg, controls=uc, tol=1e-6, max_outer=4000).v)
    base = jtt._repad(jtt.tt_from_dense(jnp.asarray(vd), rmax=10, tol=1e-3), 16)
    shifted = jtt.tt_add(base, jtt.tt_constant(jg.shape, 3.0, 16))
    return jp, tp, jg, tg, uc, vd, shifted


@pytest.mark.parametrize("case", ["quad5", "pendulum"])
def test_make_bellman_kernel_matches_jax(case):
    """Random TT, random nodes (some terminal), a chunk smaller than the
    batch: float32 rounding (rtol 1e-5, atol 1e-5 x max|v|)."""
    name, kw, shape = {"quad5": ("quadcopter", QUAD, (5,) * 6),
                       "pendulum": ("pendulum", {}, (21, 17))}[case]
    jp, tp = jm.make_problem(name, **kw), tm.make_problem(name, **kw)
    jg, tg = jp.default_grid(shape), tp.default_grid(shape)
    cores, ranks = random_tt_numpy(shape, [6] * (len(shape) - 1), 6, seed=3)
    cores[0] = cores[0] * 40.0
    jt = jtt.TT(tuple(jnp.asarray(c) for c in cores), jnp.asarray(ranks))
    rng = np.random.default_rng(4)
    idx = np.stack([rng.integers(0, n, 700) for n in shape], -1)
    uc = jp.control_candidates(5)
    want = np.asarray(j_kernel(jp, jg, uc, chunk=256)(jt, jnp.asarray(idx, jnp.int32)))
    got = make_bellman_kernel(tp, tg, uc, chunk=256)(to_port(jt), idx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_host_linear_algebra_is_the_same():
    """_maxvol, _svd_rank and _select_rows (with and without oversampling)
    run the same float64 numpy in both packages: identical results."""
    rng = np.random.default_rng(0)
    U, _ = np.linalg.qr(rng.standard_normal((90, 7)))
    for a, b in zip(jpol._maxvol(U), tpol._maxvol(U)):
        np.testing.assert_array_equal(a, b)
    rows, G = tpol._maxvol(U)
    assert np.abs(G).max() <= 1.02 + 1e-9 and np.allclose(G[rows], np.eye(7), atol=1e-10)
    s = np.sort(rng.uniform(0, 1, 20))[::-1]
    assert [jpol._svd_rank(s, e, c) for e, c in ((1e-2, 20), (0.5, 20), (1e-9, 4))] == \
        [tpol._svd_rank(s, e, c) for e, c in ((1e-2, 20), (0.5, 20), (1e-9, 4))]
    for os_ in (0.0, 0.5):
        for a, b in zip(jpol._select_rows(U, os_, 12), tpol._select_rows(U, os_, 12)):
            np.testing.assert_array_equal(a, b)


def _jax_state(shape, r0, seed):
    return j_init_cross_state(jax.random.key(seed), shape, r0)


def test_fit2site_matches_jax_from_an_identical_state(pendulum):
    """Two sweeps of the two-site fit of T(v) from one JAX CrossState: the
    index sets equal, the fitted values within 1e-4 x max|v|."""
    jp, tp, jg, tg, uc, vd, v = pendulum
    state = _jax_state(jg.shape, 8, 5)
    jk, tk = j_kernel(jp, jg, uc, chunk=4096), make_bellman_kernel(tp, tg, uc, chunk=4096)
    tv = to_port(v)
    jtt_new, jstate, jn = jpol._fit2site(lambda i: jk(v, i), jg.shape, copy.deepcopy(state),
                                         16, 12, 1e-5, 2)
    ttt_new, tstate, tn = tpol._fit2site(lambda i: tk(tv, i), tg.shape,
                                         cross_state_from_numpy(state.left, state.right),
                                         16, 12, 1e-5, 2, device=CPU)
    assert jn == tn
    for a, b in zip(jstate.left + jstate.right, tstate.left + tstate.right):
        np.testing.assert_array_equal(a, b)
    assert np.asarray(jtt_new.ranks).tolist() == ttt_new.ranks.tolist()
    want = full(jtt_new)
    assert np.abs(full(ttt_new) - want).max() <= 1e-4 * np.abs(want).max()


def test_tt_polish_matches_jax_from_an_identical_state(pendulum):
    """Four polish steps (two stages, check every step, tail average of 3)
    from one JAX state: the same best step and ranks, per-step sampled
    residuals within 1e-4 relative, the result within 1e-4 x max|v|."""
    jp, tp, jg, tg, uc, vd, v = pendulum
    state = _jax_state(jg.shape, 8, 7)
    kw = dict(rmax=16, schedule=((2, 10), (2, 14)), chunk=4096, n_check=512, average_tail=3)
    jres = jpol.tt_polish(jp, jg, uc, v, state=copy.deepcopy(state), **kw)
    tres = tpol.tt_polish(tp, tg, uc, to_port(v),
                          state=cross_state_from_numpy(state.left, state.right), **kw)
    assert jres.best_step == tres.best_step
    assert [h["ranks"] for h in jres.history] == [h["ranks"] for h in tres.history]
    for a, b in zip(jres.history, tres.history):
        np.testing.assert_allclose(b["bres_abs"], a["bres_abs"], rtol=1e-4)
    want = full(jres.v)
    assert np.abs(full(tres.v) - want).max() <= 1e-4 * np.abs(want).max()


def test_tt_polish_rerolls_its_state_from_the_generator(pendulum, monkeypatch):
    """``reroll_every``: the port draws a fresh state where JAX splits its
    key. Handed JAX's states in the same order (init_cross_state replaced),
    the two packages agree as above."""
    jp, tp, jg, tg, uc, vd, v = pendulum
    key = jax.random.key(11)
    jstates = [j_init_cross_state(jax.random.split(key)[1], jg.shape, 8)]
    k = key
    for _ in range(2):
        k, sk = jax.random.split(k)
        jstates.append(j_init_cross_state(sk, jg.shape, 8))
    handed = iter(copy.deepcopy(jstates))
    monkeypatch.setattr(tpol, "init_cross_state", lambda gen, shape, r0: next(handed))
    kw = dict(rmax=16, schedule=((4, 10),), chunk=4096, n_check=512, reroll_every=2)
    jres = jpol.tt_polish(jp, jg, uc, v, key=key, **kw)
    tres = tpol.tt_polish(tp, tg, uc, to_port(v), generator=torch.Generator().manual_seed(0), **kw)
    assert next(handed, None) is not None          # two draws: step 0 and step 2
    assert jres.best_step == tres.best_step
    want = full(jres.v)
    assert np.abs(full(tres.v) - want).max() <= 1e-4 * np.abs(want).max()


def test_level_correct_matches_jax(pendulum):
    jp, tp, jg, tg, uc, vd, v = pendulum
    jv, jh = jpol.level_correct(jp, jg, uc, v, iters=3, n_samples=2048, chunk=4096)
    tv, th = tpol.level_correct(tp, tg, uc, to_port(v), iters=3, n_samples=2048, chunk=4096)
    assert len(jh) == len(th)
    bar = 1e-6 * np.abs(vd).max()
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b["mean_defect"], a["mean_defect"], rtol=0, atol=bar)
        np.testing.assert_allclose(b["slope"], a["slope"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(b["shift"], a["shift"], rtol=1e-3,
                                   atol=bar / (1.0 - a["slope"]))
    want = full(jv)
    assert np.abs(full(tv) - want).max() <= 1e-4 * np.abs(want).max()
    assert abs(sum(h["shift"] for h in th) + 3.0) < 0.5    # the shift of 3 is recovered


def test_mode_correct_matches_jax(pendulum):
    """The level, both ramps and the bounded dim's two ring modes."""
    jp, tp, jg, tg, uc, vd, v = pendulum
    kw = dict(iters=2, n_samples=2048, chunk=4096, ring_modes=True)
    jv, jh = jpol.mode_correct(jp, jg, uc, v, **kw)
    tv, th = tpol.mode_correct(tp, tg, uc, to_port(v), **kw)
    assert len(jh) == len(th)
    for a, b in zip(jh, th):
        assert len(b["coeffs"]) == 1 + 2 + 2
        np.testing.assert_allclose(b["coeffs"], a["coeffs"], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(b["rms_defect"], a["rms_defect"], rtol=1e-4)
    want = full(jv)
    assert np.abs(full(tv) - want).max() <= 1e-4 * np.abs(want).max()
