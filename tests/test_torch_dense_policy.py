"""The evaluate sweeps' policy (c3sc_tpu_torch.ops.dense_backup: DensePolicy,
gather_policy, dense_backup(..., with_policy=True)) against the JAX package's
make_dense_step, whose one_outer gathers the policy's stencil once per
improve (gather_policy in c3sc_tpu/solvers/dense.py) and runs its evaluate
sweeps on it. On the CPU every sweep is K1's plain version; the kernels'
epilogue and the graphed loops run on the card (tests/test_torch_kernels.py).

Tolerance: one outer sweep (an improve and ten evaluates) within rtol 1e-5,
atol 1e-5 of JAX's, the bar of test_torch_dense_general.py's one-step
comparison (float32 rounding of a ten-term stencil, repeated).
"""

from torch_port_testing import random_v

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3sc_tpu import models as jm
from c3sc_tpu.solvers.dense import make_dense_step as jmake_dense_step
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.ops import dense_backup as db
from c3sc_tpu_torch.solvers import dense_vi
from c3sc_tpu_torch.solvers.dense import make_dense_step
from c3sc_tpu_torch.solvers.local_patch import solve_local_patch


def _bare(prob):
    """Every structure declaration stripped: per-candidate variances and cost."""
    return dataclasses.replace(prob, drift_f0=None, drift_G=None, sigma2_x=None, cost_q=None,
                               cost_r=None)


CASES = {
    "glider": ("glider", False, (7, 7, 7, 7), 9),        # 9 candidates, s2 and q, r declared
    "pendulum-bare": ("pendulum", True, 41, 9),           # 9 candidates, s2c and gc
}


def _case(name):
    model, strip, n, per_dim = CASES[name]
    jp, tp = jm.make_problem(model), tm.make_problem(model)
    if strip:
        tp = _bare(tp)
    jg, tg = jp.default_grid(n), tp.default_grid(n)
    return jp, tp, jg, tg, jp.control_candidates(per_dim)


@pytest.mark.parametrize("name", list(CASES))
def test_one_outer_sweep_matches_jax(name):
    """step(v, 1) of the port (improve with its policy, ten evaluates under
    it) against JAX's make_dense_step on the same numpy v: value and
    residual."""
    jp, tp, jg, tg, uc = _case(name)
    v = random_v(jg.shape)
    jstep, _ = jmake_dense_step(jp, jg, uc)
    step, _ = make_dense_step(tp, tg, uc, device="cpu")
    jv, jres = jstep(jnp.asarray(v), 1)
    got, res = step(torch.as_tensor(v), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(res), float(jres), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_policy_of_the_improve_is_the_gather_of_its_argmin(name):
    """dense_backup(..., with_policy=True) returns gather_policy of its own
    argmin; the evaluate under that policy is torch.equal to the evaluate
    under the bare indices; the policy's tensors are contiguous [d, N] and
    [N], present exactly where the operands are per candidate, and hold
    fc_k[best[n], :, n] (s2c_k, gc likewise)."""
    _, tp, _, tg, uc = _case(name)
    ops = db.make_dense_operands(tp, tg, uc, "cpu")
    v = torch.as_tensor(random_v(tg.shape))
    vnew, pol = db.dense_backup(ops, v, with_policy=True)
    want_v, best = db.dense_backup(ops, v)
    assert torch.equal(vnew, want_v) and torch.equal(pol.best, best)
    gathered = db.gather_policy(ops, best)
    N, d = ops.x.shape
    for got, want, per_cand, shape in (
            (pol.fpol_k, gathered.fpol_k, ops.fc_k, (d, N)),
            (pol.s2pol_k, gathered.s2pol_k, ops.s2c_k, (d, N)),
            (pol.gpol, gathered.gpol, ops.gc, (N,))):
        assert (got is None) == (per_cand is None) == (want is None)
        if got is None:
            continue
        assert torch.equal(got, want) and got.is_contiguous() and tuple(got.shape) == shape
        nodes = torch.arange(N)
        pick = per_cand[best.long(), ..., nodes]          # [N, d] or [N]
        assert torch.equal(got, pick.T if pick.dim() == 2 else pick)
    assert torch.equal(db.dense_evaluate(ops, vnew, pol), db.dense_evaluate(ops, vnew, best))
    assert torch.equal(db.dense_evaluate_reference(ops, vnew, gathered),
                       db.dense_evaluate_reference(ops, vnew, best))


def test_structured_policy_is_the_indices_alone():
    """A structured problem's evaluate reads f0_k, G_k and uc[best]: its
    policy carries best and no gathered operands."""
    tp = tm.make_problem("pendulum")
    tg = tp.default_grid(21)
    ops = db.make_dense_operands(tp, tg, tp.control_candidates(5), "cpu")
    v = torch.as_tensor(random_v(tg.shape))
    _, pol = db.dense_backup(ops, v, with_policy=True)
    assert (pol.fpol_k, pol.s2pol_k, pol.gpol) == (None, None, None)
    assert pol.best.dtype == torch.int32 and pol.best.shape == (21 * 21,)
    assert torch.equal(db.dense_evaluate(ops, v, pol), db.dense_evaluate(ops, v, pol.best))


def test_cuda_graph_on_the_cpu_raises():
    """A CUDA graph needs a CUDA device: dense_vi, make_dense_step and
    solve_local_patch refuse cuda_graph=True on the CPU instead of running
    the eager loop."""
    tp = tm.make_problem("pendulum")
    tg = tp.default_grid(15)
    uc = tp.control_candidates(5)
    with pytest.raises(ValueError, match="cuda_graph"):
        make_dense_step(tp, tg, uc, device="cpu", cuda_graph=True)
    with pytest.raises(ValueError, match="cuda_graph"):
        dense_vi(tp, tg, controls=uc, max_outer=2, device="cpu", cuda_graph=True)
    qp = tm.make_problem("lq")
    qg = qp.default_grid(15)
    with pytest.raises(ValueError, match="cuda_graph"):
        solve_local_patch(qp, qg, lambda p: torch.zeros(p.shape[0]), qp.control_candidates(5),
                          max_sweeps=2, chunk=1, device="cpu", cuda_graph=True)


def test_cpu_default_is_the_eager_loop():
    """cuda_graph=None (the default) on the CPU runs the eager loop:
    make_dense_step's and solve_local_patch's results equal those of
    cuda_graph=False, and eager_sweeps of n sweeps is n calls of the body
    with the last call's max |dv|."""
    from c3sc_tpu_torch.solvers.dense import eager_sweeps

    tp = tm.make_problem("pendulum")
    tg = tp.default_grid(15)
    uc = tp.control_candidates(5)
    v = torch.as_tensor(random_v(tg.shape))
    got = make_dense_step(tp, tg, uc, device="cpu")[0](v, 3)
    want = make_dense_step(tp, tg, uc, device="cpu", cuda_graph=False)[0](v, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    qp = tm.make_problem("lq")
    qg = qp.default_grid(15)
    patches = [solve_local_patch(qp, qg, lambda p: torch.zeros(p.shape[0]),
                                 qp.control_candidates(5), max_sweeps=6, chunk=3, device="cpu",
                                 cuda_graph=flag) for flag in (None, False)]
    assert torch.equal(patches[0].v, patches[1].v) and patches[0].sweeps == 6
    body = lambda x: 0.5 * x  # noqa: E731
    out, res = eager_sweeps(body, v, 3)
    assert torch.equal(out, v / 8) and torch.equal(res, torch.max(torch.abs(v / 8 - v / 4)))
    out, res = eager_sweeps(body, v, 0)
    assert out is v and float(res) == float("inf")


def test_launch_counts_add_and_take_back():
    """K1's launch counts by entry; add_launches adds a replay's counts and
    takes back a capture's (times=-1)."""
    before = db.launch_counts()
    assert tuple(before) == db.ENTRIES
    made = {"dense_backup_general": 1, "dense_evaluate_general": 10}
    db.add_launches(made, 3)
    after = db.launch_counts()
    assert after["dense_evaluate_general"] == before["dense_evaluate_general"] + 30
    db.add_launches(made, -3)
    assert db.launch_counts() == before
