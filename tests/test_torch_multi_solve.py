"""The port's batched independent solves (c3sc_tpu_torch.parallel.multi_solve)
on the CPU, against the JAX package's and against independent solves.

LQ (sigma 1, beta 1) on 21^2 with 9 candidates at rmax 8 and the seeds 0-3:
the configuration of tests/test_multi_solve.py. A JAX key ``k`` is the
port's seed ``key_data(k)[-1]``; for ``jax.random.key(i)`` that is i.

Bars:
  one make_batch_stepper step from JAX's stacked init carry against JAX's:
      those of tests/test_torch_fused.py's one-iteration parity (ranks
      equal, samples within 1e-4 x max|v|);
  solve_batch: every instance within 0.05 of dense_vi (relative sup error,
      tests/test_multi_solve.py's bar), and equal bit for bit to the same
      seed's solve_fn(init_fn(seed)) run alone;
  solve_batch on 2 gloo ranks with the mesh (2,): the unsharded stack, bit
      for bit, on both ranks.

The solves run in spawned processes while this one runs JAX's side: the
2-rank group, and one process for the unsharded solve_batch (each started
once for the module and joined within 120 s; the children import no JAX).
"""

import numpy as np
import pytest
import torch

import torch_port_testing as tpt
from torch_port_testing import close, port_grid, to_numpy

import jax

from c3sc_tpu import models as jm
from c3sc_tpu.parallel.multi_solve import make_batch_stepper as j_make_batch_stepper
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import fused_carry_from_numpy
from c3sc_tpu_torch.ops.tt import TT, tt_gather_eval
from c3sc_tpu_torch.parallel.multi_solve import make_batch_stepper, stack_carries
from c3sc_tpu_torch.solvers import dense_vi

LQ = dict(problem=dict(sigma=1.0, beta=1.0), n=21, nc=9, rmax=8)
SEEDS = [0, 1, 2, 3]
SOLVE = dict(tol=5e-4, max_iters=400, patience=100)


def _lq():
    prob = tm.make_problem("lq", **LQ["problem"])
    return prob, prob.default_grid(LQ["n"]), prob.control_candidates(LQ["nc"])


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The 2-rank group and the unsharded solve, started at once."""
    runs = [tpt.Ranks(tpt.multi_solve_rank_job, world, tmp_path_factory.mktemp("ranks"), lq=LQ,
                      seeds=SEEDS, solve_kw=SOLVE, sharded=world == 2) for world in (2, 1)]
    yield runs
    for run in runs:
        run.kill()


@pytest.fixture(scope="module")
def ranks(started):
    """The 2 ranks' results."""
    return started[0].results()


@pytest.fixture(scope="module")
def batch(started):
    """solve_batch's stacked carry, unsharded (as numpy fields)."""
    return started[1].results()[0]["batch"]


def _carry_to_port(jc):
    fields = {k: ([np.asarray(c) for c in v] if isinstance(v, tuple) else np.asarray(v))
              for k, v in jc._asdict().items()}
    return fused_carry_from_numpy(fields, "cpu")


def test_batch_stepper_step_matches_jax(started):
    """JAX's stacked init carry (keys 0-3), each instance carried across,
    then one step of each package's batch stepper (while the ranks run)."""
    jp = jm.make_lq_problem(**LQ["problem"])
    jg = jp.default_grid(LQ["n"])
    uc = jp.control_candidates(LQ["nc"])
    j_init, j_step = j_make_batch_stepper(jp, jg, uc, rmax=LQ["rmax"])
    jc = j_init([jax.random.key(s) for s in SEEDS])
    t_init, t_step = make_batch_stepper(tm.make_problem("lq", **LQ["problem"]), port_grid(jg),
                                        uc, rmax=LQ["rmax"], device="cpu")
    # the port's own init draws the same pivot sets from the same integers
    own = t_init(SEEDS)
    for f in ("left", "right", "rl", "rr", "warm_until"):
        np.testing.assert_array_equal(to_numpy(getattr(own, f)), np.asarray(getattr(jc, f)))
    tc = stack_carries([_carry_to_port(jax.tree_util.tree_map(lambda x, i=i: x[i], jc))
                        for i in range(len(SEEDS))])
    jc, tc = j_step(jc, 1), t_step(tc, 1)
    assert tc.cores[0].shape == (len(SEEDS), LQ["rmax"], LQ["n"], LQ["rmax"])
    np.testing.assert_array_equal(to_numpy(tc.it), np.ones(len(SEEDS)))
    for f in ("ranks", "rl", "rr"):
        np.testing.assert_array_equal(to_numpy(getattr(tc, f)), np.asarray(getattr(jc, f)))
    for i in range(len(SEEDS)):
        vs = np.asarray(jc.v_sample[i])
        close(tc.v_sample[i], vs, rtol=0, atol=1e-4 * np.abs(vs).max())


def _assert_equal_carries(a, b):
    for key in ("ranks", "rl", "rr", "it", "v_sample", "residual"):
        np.testing.assert_array_equal(to_numpy(a[key]), to_numpy(b[key]))
    for x, y in zip(a["cores"], b["cores"]):
        np.testing.assert_array_equal(to_numpy(x), to_numpy(y))


def test_solve_batch_matches_dense_and_independent_solves(batch, ranks):
    prob, grid, controls = _lq()
    assert batch["residual"].shape == (len(SEEDS),)
    dense = dense_vi(prob, grid, controls=controls, tol=1e-5, max_outer=300, chunk=100,
                     device="cpu")
    idx = torch.as_tensor(np.stack(np.meshgrid(*[np.arange(n) for n in grid.shape],
                                               indexing="ij"), -1).reshape(-1, 2))
    v_dense = dense.v.reshape(-1)
    alone = {**ranks[0]["alone"], **ranks[1]["alone"]}
    assert sorted(alone) == SEEDS
    for b, seed in enumerate(SEEDS):
        c = {k: [x[b] for x in v] if k == "cores" else v[b] for k, v in batch.items()}
        v_tt = tt_gather_eval(TT(tuple(map(torch.as_tensor, c["cores"])),
                                 torch.as_tensor(c["ranks"])), idx)
        err = float((v_tt - v_dense).abs().max() / v_dense.abs().max())
        assert err < 0.05, f"instance {b}: err {err:.3f}"
        _assert_equal_carries(c, alone[seed])
    # the instances stop by their own conditions, at different iterations
    assert len(set(batch["it"].tolist())) > 1


def test_solve_batch_on_two_ranks(batch, ranks):
    """The mesh (2,): each rank solves 2 instances, gathers, and returns the
    whole stack."""
    for r in ranks:
        _assert_equal_carries(r["batch"], batch)
