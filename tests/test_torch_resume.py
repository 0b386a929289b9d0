"""Checkpoint and resume of the port's solvers (``fused_tt_vi`` and
``tt_vi`` with ``checkpoint_path`` / ``resume_from``) on the CPU.

Bars, each stated at its test:
  - fused, LQ 21^2 at rank 8: 100 iterations straight against 50, a save, a
    resume and 50 more give bit-equal carries (every field), with no
    restart and no rank growth in between. The stopping window is 100, so
    the JAX package's resume rule (a fresh stopping state) restores exactly
    the state the straight run holds at iteration 50 (no window boundary
    has passed); the checkpoint also carries the restarts' seed stream;
  - fused, from a carry the JAX package wrote (its 5th iteration at LQ 21^2,
    rank 8): the port's resume takes one iteration that matches JAX's from
    the same file: ranks equal, samples and cores within 1e-4 x max|v|
    (float32 rounding of one iteration in two frameworks, the bar of
    tests/test_torch_fused.py);
  - tt_vi, pendulum 21^2 at rank 8: 10 + 10 iterations against 20 straight,
    bit-equal values, index sets and residuals (the seed stream resumes
    where it stopped).
"""

from torch_port_testing import port_grid  # first: pins torch's threads

import jax
import jax.numpy as jnp
import numpy as np
import torch

from c3sc_tpu import models as jm
from c3sc_tpu.ops.tt import TT as JTT, tt_gather_eval as j_gather
from c3sc_tpu.solvers import fused as jf
from c3sc_tpu.utils import checkpoint as jck
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.ops.tt import TT, tt_gather_eval
from c3sc_tpu_torch.solvers import fused_tt_vi
from c3sc_tpu_torch.solvers.ttvi import tt_vi
from c3sc_tpu_torch.utils.checkpoint import checkpoint_seed_stream, load_solver_state

CPU = "cpu"


def _equal_carries(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        for p, q in (zip(x, y) if isinstance(x, tuple) else ((x, y),)):
            assert torch.equal(p, q), name


def test_fused_resume_is_bit_equal(tmp_path):
    prob = tm.make_problem("lq")
    grid = prob.default_grid(21)
    kw = dict(n_controls=9, rmax=8, tol=1e-12, window=100, seed=3, device=CPU)
    metrics = []

    class Log:
        def log(self, name, **fields):
            metrics.append(name)

    straight = fused_tt_vi(prob, grid, max_iters=100, **kw)
    ck = str(tmp_path / "state.npz")
    first = fused_tt_vi(prob, grid, max_iters=50, checkpoint_path=ck, checkpoint_every=25,
                        metrics=Log(), **kw)
    assert int(first.carry.it) == 50 and checkpoint_seed_stream(ck) is not None
    resumed = fused_tt_vi(prob, grid, max_iters=100, resume_from=ck, metrics=Log(), **kw)
    assert int(resumed.carry.it) == int(straight.carry.it) == 100
    assert not {"fused_lineage_restart", "fused_rank_growth"} & set(metrics)
    _equal_carries(resumed.carry, straight.carry)


def test_fused_resume_from_a_jax_carry(tmp_path):
    jp, tp = jm.make_problem("lq"), tm.make_problem("lq")
    jg = jp.default_grid(21)
    uc = jp.control_candidates(9)
    js = jf.make_fused_vi(jp, jg, uc, rmax=8)
    jc = js.step_fn(js.init_fn(jax.random.key(0)), 5)
    ck = str(tmp_path / "jax_state.npz")
    jck.save_fused_carry(ck, jc, jck.fused_context(jp, jg, 8))
    # JAX's resume: the saved carry with a fresh stopping state, one iteration
    want = jck.load_fused_carry(ck)
    want = want._replace(wstall=want.wstall * 0, long_res=want.long_res * np.inf,
                         best_long=want.best_long * np.inf,
                         best_absdisp=want.best_absdisp * np.inf)
    want = js.step_fn(want, 1)
    got = fused_tt_vi(tp, port_grid(jg), controls=uc, rmax=8, max_iters=6, resume_from=ck,
                      device=CPU).carry
    assert int(got.it) == int(want.it) == 6
    for f in ("ranks", "rl", "rr"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    vs = np.asarray(want.v_sample)
    assert np.abs(got.v_sample.numpy() - vs).max() <= 1e-4 * np.abs(vs).max()
    idx = np.stack(np.meshgrid(np.arange(21), np.arange(21), indexing="ij"), -1).reshape(-1, 2)
    vj = np.asarray(j_gather(JTT(want.cores, want.ranks), jnp.asarray(idx, jnp.int32)))
    vt = tt_gather_eval(TT(got.cores, got.ranks), torch.as_tensor(idx)).numpy()
    assert np.abs(vt - vj).max() <= 1e-4 * np.abs(vj).max()


def test_tt_vi_resume_is_bit_equal(tmp_path):
    prob = tm.make_problem("pendulum")
    grid = prob.default_grid(21)
    kw = dict(n_controls=9, rmax=8, tol=0.0, cross_sweeps=1, chunk=1024, seed=5, device=CPU)
    straight = tt_vi(prob, grid, max_iters=20, **kw)
    ck = str(tmp_path / "vi.npz")
    first = tt_vi(prob, grid, max_iters=10, checkpoint_path=ck, checkpoint_every=10, **kw)
    assert first.iterations == 10 and load_solver_state(ck, CPU)["iteration"] == 9
    resumed = tt_vi(prob, grid, max_iters=20, resume_from=ck, **kw)
    assert resumed.iterations == straight.iterations == 20
    assert resumed.residual_history == straight.residual_history[10:]
    for a, b in zip(resumed.v.cores, straight.v.cores):
        assert torch.equal(a, b)
    assert torch.equal(resumed.v.ranks, straight.v.ranks)
    for a, b in zip(resumed.state.left + resumed.state.right,
                    straight.state.left + straight.state.right):
        np.testing.assert_array_equal(a, b)
