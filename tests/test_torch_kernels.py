"""The port's CUDA kernels on the card: K1 (csrc/dense_backup.cu) against its
plain PyTorch version, the refusals of its wrapper, and dense_vi running
through it. Every test here needs a CUDA device and skips without one.

Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them: ``python -m pytest --noconftest tests/test_torch_kernels.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import value_from_npz
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.ops import dense_backup as db
from c3sc_tpu_torch.solvers import dense_vi

pytestmark = pytest.mark.cuda

QUAD = dict(sigma_v=0.15, sigma_om=0.15)
V5 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "experiments", "artifacts", "quad_dense_v5.npz")
TIE = 1e-5  # argmins may differ only where the two best rhs are this close (relative)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _random_v(shape, device):
    v = np.random.default_rng(0).uniform(0, 5, shape).astype(np.float32)
    return torch.as_tensor(v, device=device)


@pytest.mark.parametrize("n", [5, 9])
def test_kernel_matches_plain_on_card(cuda, n):
    """Both semantics; bar 2e-4 (the Pallas test's), argmins equal off near-ties."""
    tp = tm.make_problem("quadcopter", **QUAD)
    grid = tp.default_grid(n)
    ops = db.make_dense_operands(tp, grid, tp.control_candidates(5), cuda)
    v = _random_v(grid.shape, cuda)
    for clip, pin in ((tp.value_bounds, True), (None, False)):
        before = db.dense_backup.launches
        got, best = db.dense_backup(ops, v, clip, pin)
        assert db.dense_backup.launches == before + 1
        want, wbest = db.dense_backup_reference(ops, v, clip, pin)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        top2 = torch.topk(db.candidate_rhs(ops, v, clip, pin), 2, dim=0, largest=False).values
        near_tie = (top2[1] - top2[0]) <= TIE * top2[0].abs().clamp(min=1.0)
        assert not torch.any((best != wbest) & ~near_tie)
        torch.testing.assert_close(db.dense_evaluate(ops, v, wbest),
                                   db.dense_evaluate_reference(ops, v, wbest),
                                   rtol=2e-4, atol=2e-4)


def test_wrapper_raises_instead_of_falling_back(cuda):
    tp = tm.make_problem("pendulum")
    uc = tp.control_candidates(5)
    v = torch.zeros((21, 21), device=cuda)
    bare = dataclasses.replace(tp, drift_f0=None, drift_G=None, sigma2_x=None,
                               cost_q=None, cost_r=None)
    with pytest.raises(NotImplementedError):
        db.dense_backup(db.make_dense_operands(bare, tp.default_grid(21), uc, cuda), v)
    nodes = [np.linspace(-np.pi, np.pi, 21, endpoint=False), np.linspace(-8, 8, 21) ** 3 / 64]
    grid = Grid.create(tp.lb, tp.ub, (21, 21), (True, False), nodes=nodes)
    with pytest.raises(NotImplementedError):
        db.dense_backup(db.make_dense_operands(tp, grid, uc, cuda), v)
    ops = db.make_dense_operands(tp, tp.default_grid(21), uc, cuda)
    with pytest.raises(ValueError):
        db.dense_backup(ops, v.double())
    with pytest.raises(ValueError):
        db.dense_evaluate(ops, v, torch.zeros(21 * 21, dtype=torch.int64, device=cuda))


def test_dense_vi_runs_through_the_kernels(cuda):
    prob = tm.make_problem("quadcopter", **QUAD)
    before = (db.dense_backup.launches, db.dense_evaluate.launches)
    sol = dense_vi(prob, prob.default_grid(5), controls=prob.control_candidates(5), tol=1e-5,
                   max_outer=3000, chunk=25, eval_sweeps=10, device=cuda)
    assert db.dense_backup.launches - before[0] == sol.sweeps
    assert db.dense_evaluate.launches - before[1] == 10 * sol.sweeps
    assert sol.v.device.type == "cuda"
    want = value_from_npz(V5).numpy()
    assert np.abs(sol.v.cpu().numpy() - want).max() <= 1e-4 * (want.max() - want.min())
