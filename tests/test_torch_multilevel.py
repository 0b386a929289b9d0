"""The port's grid-multilevel ladder (c3sc_tpu_torch.solvers.multilevel)
against c3sc_tpu.solvers.multilevel on the CPU, every call with
device="cpu".

Bars:
  - the ladder with both packages' ``fused_tt_vi`` replaced by one that
    returns the same given TT a level: each level's warm start (the
    prolonged TT) within rtol 1e-5, atol 1e-5 x max|v|, the same grids, the
    same per-level records, JAX's per-level keys reaching the port as the
    integers its ``init_fn`` reads;
  - tests/test_multilevel.py's bar on the port: pendulum [21, 31], rmax 16,
    q95 of |v - dense| / max|dense| < 0.05 at the 31^2 nodes. The coarse
    level's iteration cap is cut from the default 4,000 to 300 to keep this
    file within its time (the 21^2 lineages churn for thousands of
    iterations on one CPU thread); the fine level runs at its default cap.
    The card runs the uncut configuration (chip_smoke.py J.3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_testing import close, random_tt_numpy
from c3sc_tpu import models as jm
from c3sc_tpu.ops.tt import TT as JTT
from c3sc_tpu.ops.tt import tt_full as jtt_full
from c3sc_tpu.solvers import multilevel as jml
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import tt_from_numpy
from c3sc_tpu_torch.ops.tt import tt_full
from c3sc_tpu_torch.solvers import dense_vi
from c3sc_tpu_torch.solvers import fused as tf
from c3sc_tpu_torch.solvers import multilevel as tml


def jax_level_seeds(n_levels, key=0):
    """The integer each level's ``fused_tt_vi`` key reaches ``init_fn`` as."""
    k, out = jax.random.key(key), []
    for _ in range(n_levels):
        k, sk = jax.random.split(k)
        out.append(int(np.asarray(jax.random.key_data(sk)).ravel()[-1]))
    return out


def _fake(tts, calls, seed_key):
    it = iter(tts)

    def fake(problem, grid, rmax=16, v0=None, tol=None, max_iters=None, **kw):
        if seed_key == "key":
            seed = int(np.asarray(jax.random.key_data(kw["key"])).ravel()[-1])
        else:
            seed = kw["seed"]
        calls.append((grid.shape, v0, seed, max_iters))
        return tf.FusedVISolution(v=next(it), residual=0.01 * len(calls), iterations=7,
                                  wall_time=0.25, carry=None, controls=None)
    return fake


def test_ladder_matches_jax(monkeypatch):
    ns = [5, 9, (13, 11)]
    levels = [random_tt_numpy(jm.make_pendulum_problem().default_grid(n).shape, [3], 4, seed=i)
              for i, n in enumerate(ns)]
    jcalls, tcalls = [], []
    monkeypatch.setattr(jml, "fused_tt_vi", _fake(
        [JTT(tuple(jnp.asarray(c) for c in cs), jnp.asarray(r)) for cs, r in levels],
        jcalls, "key"))
    monkeypatch.setattr(tml, "fused_tt_vi", _fake(
        [tt_from_numpy(cs, r, "cpu") for cs, r in levels], tcalls, "seed"))
    want = jml.multilevel_tt_vi(jm.make_pendulum_problem(), ns, rmax=4, key=jax.random.key(0))
    got = tml.multilevel_tt_vi(tm.make_pendulum_problem(), ns, rmax=4,
                               seed=jax_level_seeds(len(ns)), device="cpu")
    assert got.levels == want.levels
    assert got.grid.shape == want.grid.shape == (13, 11)
    for (gs, gv, gseed, gmax), (ws, wv, wseed, wmax) in zip(tcalls, jcalls):
        assert gs == ws and gseed == wseed and gmax == wmax
        assert (gv is None) == (wv is None)
        if gv is not None:
            w = np.asarray(jtt_full(wv))
            close(tt_full(gv), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    assert [c[3] for c in tcalls] == [4000, 4000, 2000]


def test_int_seed_draws_level_seeds(monkeypatch):
    calls = []
    tts = [tt_from_numpy(*random_tt_numpy((n, n), [2], 3, seed=n), "cpu") for n in (5, 9)]
    monkeypatch.setattr(tml, "fused_tt_vi", _fake(tts, calls, "seed"))
    tml.multilevel_tt_vi(tm.make_pendulum_problem(), [5, 9], rmax=3, seed=4, device="cpu")
    rng = np.random.default_rng(4)
    assert [c[2] for c in calls] == [int(rng.integers(0, 2**31)) for _ in range(2)]


def test_multilevel_matches_dense_fixed_point():
    """The bar of tests/test_multilevel.py on the port (coarse cap cut, see
    the module docstring)."""
    prob = tm.make_pendulum_problem(beta=0.5, sigma=0.5)
    controls = prob.control_candidates(9)
    ml = tml.multilevel_tt_vi(prob, ns=[21, 31], rmax=16, seed=jax_level_seeds(2), tol=2e-4,
                              controls=controls, max_iters_coarse=300, device="cpu")
    assert len(ml.levels) == 2 and ml.levels[0][1] <= 300
    assert np.isfinite(ml.final.residual)
    assert ml.grid.shape == (31, 31)
    dense = dense_vi(prob, ml.grid, controls=controls, tol=1e-5, max_outer=400, chunk=100,
                     device="cpu")
    v_d = dense.v.numpy().ravel()
    err = np.abs(tt_full(ml.final.v).numpy().ravel() - v_d) / np.abs(v_d).max()
    assert np.quantile(err, 0.95) < 0.05, np.quantile(err, 0.95)
    assert isinstance(ml.final.v.cores[0], torch.Tensor)
