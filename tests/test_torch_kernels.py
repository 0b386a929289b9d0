"""The port's CUDA kernels on the card: K1 (csrc/dense_backup.cu) against its
plain PyTorch version (its structured entries and its general entries, the
latter also in their run-time-d form for d > 8, on uniform and non-uniform
grids), the refusals of its wrapper, and dense_vi and the local patch
running through it. Every test here
needs a CUDA device and skips without one.

Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them: ``python -m pytest --noconftest tests/test_torch_kernels.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_testing import (QUAD, TIE, V5, double_integrator_du5, many_states, nine_states,
                                 random_v, tanh_node_sets)
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.models.base import Boundary, ControlProblem
from c3sc_tpu_torch.convert import value_from_npz
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.ops import dense_backup as db
from c3sc_tpu_torch.solvers import dense_vi

pytestmark = pytest.mark.cuda



@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _random_v(shape, device):
    return torch.as_tensor(random_v(shape), device=device)


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


def _synthetic_problem(d, du):
    """A structured problem of any (d, du): x-dependent affine drift, constant
    diagonal noise, quadratic cost, boundaries cycling periodic/absorb/reflect."""
    rng = np.random.default_rng(10 * d + du)
    A, B = 0.5 * rng.normal(size=(d, d)), rng.normal(size=(d, du))
    sig = rng.uniform(0.1, 0.5, d)

    def on(a, x):
        return torch.as_tensor(a, dtype=x.dtype, device=x.device)

    def f0(x):
        return torch.sin(x) @ on(A, x).T

    def G(x):
        return on(B, x) * (1.0 + 0.1 * torch.cos(x[..., :1, None]))

    def q(x):
        return torch.sum(x * x, dim=-1)

    def r(u):
        return 0.1 * torch.sum(u * u, dim=-1)

    return ControlProblem(
        dx=d, du=du, dw=d, lb=(-1.0,) * d, ub=(1.0,) * d,
        boundary=tuple((Boundary.PERIODIC, Boundary.ABSORB, Boundary.REFLECT)[k % 3]
                       for k in range(d)),
        ulb=(-1.0,) * du, uub=(1.0,) * du,
        drift=lambda x, u: f0(x) + torch.einsum("...dm,...m->...d", G(x), u),
        diff=lambda x, u: torch.diag(on(sig, x)).expand(*x.shape[:-1], d, d),
        stage_cost=lambda x, u: q(x) + r(u),
        boundary_cost=lambda x: 5.0 + 0.0 * x[..., 0],
        beta=0.5, name=f"synthetic{d}x{du}", value_bounds=(0.0, 50.0),
        drift_f0=f0, drift_G=G, sigma2_x=lambda x: (on(sig, x) ** 2).expand(x.shape),
        cost_q=q, cost_r=r)


@pytest.mark.parametrize("d,du,shape,n_cand", [(3, 4, (7, 16, 9), 5), (5, 3, (4, 5, 6, 3, 8), 3)])
def test_other_instantiations_and_index_widths(cuda, d, du, shape, n_cand):
    """(d, du) pairs beside the quadcopter's and the pendulum's, on unequal
    grid shapes; 625 candidates at du = 4 span two shared-memory tiles. The
    64-bit-index kernels give the 32-bit ones' bits."""
    tp = _synthetic_problem(d, du)
    grid = tp.default_grid(shape)
    ops = db.make_dense_operands(tp, grid, tp.control_candidates(n_cand), cuda)
    v = _random_v(grid.shape, cuda)
    for clip, pin in ((tp.value_bounds, True), (None, False)):
        got, best = db.dense_backup(ops, v, clip, pin)
        want, wbest = db.dense_backup_reference(ops, v, clip, pin)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        top2 = torch.topk(db.candidate_rhs(ops, v, clip, pin), 2, dim=0, largest=False).values
        near_tie = (top2[1] - top2[0]) <= TIE * top2[0].abs().clamp(min=1.0)
        assert not torch.any((best != wbest) & ~near_tie)
        wide, wide_best = db.dense_backup(ops, v, clip, pin, _wide_index=True)
        assert torch.equal(wide, got) and torch.equal(wide_best, best)
    torch.testing.assert_close(db.dense_evaluate(ops, v, wbest),
                               db.dense_evaluate_reference(ops, v, wbest), rtol=2e-4, atol=2e-4)
    assert torch.equal(db.dense_evaluate(ops, v, wbest, _wide_index=True),
                       db.dense_evaluate(ops, v, wbest))


@pytest.mark.parametrize("n", [5, 9])
def test_improve_and_evaluate_under_its_argmin_are_bit_equal(cuda, n):
    """Both kernels inline one candidate_rhs of explicit round-to-nearest
    steps, so dense_vi's evaluate under improve's own argmin repeats its value."""
    tp = tm.make_problem("quadcopter", **QUAD)
    grid = tp.default_grid(n)
    ops = db.make_dense_operands(tp, grid, tp.control_candidates(5), cuda)
    vs = [_random_v(grid.shape, cuda)] + ([value_from_npz(V5, cuda).contiguous()] if n == 5 else [])
    for v in vs:
        vnew, best = db.dense_backup(ops, v)
        assert torch.equal(db.dense_evaluate(ops, v, best), vnew)


def test_wrapper_raises_instead_of_falling_back(cuda):
    """What no kernel takes raises; a problem without the declarations runs
    the general entry, and a non-uniform grid the non-uniform kernel, never
    the plain version."""
    tp = tm.make_problem("pendulum")
    uc = tp.control_candidates(5)
    v = torch.zeros((21, 21), device=cuda)
    bare = dataclasses.replace(tp, drift_f0=None, drift_G=None, sigma2_x=None,
                               cost_q=None, cost_r=None)
    bare_ops = db.make_dense_operands(bare, tp.default_grid(21), uc, cuda)
    before = (db.dense_backup.launches, db.dense_backup_general.launches)
    db.dense_backup(bare_ops, v)
    assert (db.dense_backup.launches, db.dense_backup_general.launches) == (before[0],
                                                                           before[1] + 1)
    with pytest.raises(ValueError):
        db.dense_backup_general(db.make_dense_operands(tp, tp.default_grid(21), uc, cuda), v)
    nodes = [np.linspace(-np.pi, np.pi, 21, endpoint=False), np.linspace(-8, 8, 21) ** 3 / 64]
    grid = Grid.create(tp.lb, tp.ub, (21, 21), (True, False), nodes=nodes)
    before = db.dense_backup.launches
    assert torch.isfinite(db.dense_backup(db.make_dense_operands(tp, grid, uc, cuda), v)[0]).all()
    assert db.dense_backup.launches == before + 1   # non-uniform grids launch too
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
    want = value_from_npz(V5, "cpu").numpy()
    assert np.abs(sol.v.cpu().numpy() - want).max() <= 1e-4 * (want.max() - want.min())


@pytest.mark.parametrize("refine_steps", [0, 2])
def test_graphed_step_fn_runs_exactly_n_like_the_eager_one(cuda, refine_steps):
    """``step_fn`` under ``cuda_graph=True`` replays the one captured masked
    iteration with its force flag set: from a carry past its patience it runs
    exactly n iterations, as the eager ``step_fn`` does, while the graphed
    ``run_fn`` stops; one capture serves both, with the refinement's autograd
    inside it. Samples within 1e-5 x max|v| of the eager loop's."""
    from c3sc_tpu_torch.solvers import fused

    prob = tm.make_problem("lq", sigma=1.0, beta=1.0)
    grid = prob.default_grid(21)
    kw = dict(rmax=6, tol=0.0, max_iters=10**9, window=5, patience=1, freeze_after=10,
              refine_steps=refine_steps, device=cuda)
    eager = fused.make_fused_vi(prob, grid, prob.control_candidates(9), **kw)
    graphed = fused.make_fused_vi(prob, grid, prob.control_candidates(9), cuda_graph=True, **kw)
    captures = fused._GraphedIteration.captures
    stopped = eager.run_fn(eager.init_fn(0), 200)
    it = int(stopped.it)
    assert it < 200
    assert int(graphed.run_fn(stopped, 5).it) == it
    got, want = graphed.step_fn(stopped, 3), eager.step_fn(stopped, 3)
    assert int(got.it) == int(want.it) == it + 3
    scale = float(want.v_sample.abs().max())
    torch.testing.assert_close(got.v_sample, want.v_sample, rtol=0, atol=1e-5 * scale)
    assert fused._GraphedIteration.captures == captures + 1


def test_local_patch_solve_runs_through_the_kernel(cuda):
    """The quadcopter 9^6 patch at margin 1 (the uniform 7^6 sub-box, faces
    from the stored dense solve) through K1 against the same solve on the
    CPU's plain sweep: every sweep launches the kernel, the patches agree
    within 1e-4 x max|v| and stop after the same number of sweeps."""
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.solvers.local_patch import solve_local_patch

    tp = tm.make_problem("quadcopter", **QUAD)
    grid = tp.default_grid(9)
    uc = tp.control_candidates(5)
    path = V5.replace("quad_dense_v5", "quad_dense_v9")
    patches = {}
    for dev in ("cpu", cuda):
        v9 = value_from_npz(path, dev)
        before = db.dense_backup.launches
        patches[str(dev)] = solve_local_patch(tp, grid, lambda p: multilinear_interp(grid, v9, p),
                                              uc, margin=1, tol=1e-5, max_sweeps=200,
                                              device=dev)
        launched = db.dense_backup.launches - before
        assert launched == (patches[str(dev)].sweeps if str(dev) != "cpu" else 0)
    cpu, gpu = patches["cpu"], patches[str(cuda)]
    assert gpu.subgrid.shape == (7,) * 6 and gpu.subgrid.uniform and gpu.sweeps == cpu.sweeps
    assert (gpu.v.cpu() - cpu.v).abs().max() <= 1e-4 * cpu.v.abs().max()


def test_nonuniform_patch_on_cuda_matches_cpu(cuda):
    """A pendulum patch (a slice of the periodic theta nodes is not uniform)
    runs K1's non-uniform stencil on the card: against the same solve on the
    CPU's plain sweep every sweep launches the kernel, the patches agree
    within 1e-4 x max|v| and stop after the same number of sweeps."""
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.solvers.local_patch import solve_local_patch

    tp = tm.make_problem("pendulum")
    grid = tp.default_grid(31)
    vdeg = random_v(grid.shape, seed=3) + 10.0
    patches = {}
    for dev in ("cpu", cuda):
        v = torch.as_tensor(vdeg, device=dev)
        before = db.dense_backup.launches
        patches[str(dev)] = solve_local_patch(tp, grid, lambda p: multilinear_interp(grid, v, p),
                                              tp.control_candidates(9), lo=(8, 8), hi=(22, 22),
                                              tol=1e-5, max_sweeps=400, device=dev)
        launched = db.dense_backup.launches - before
        assert launched == (patches[str(dev)].sweeps if str(dev) != "cpu" else 0)
    cpu, gpu = patches["cpu"], patches[str(cuda)]
    assert not gpu.subgrid.uniform and gpu.sweeps == cpu.sweeps
    assert (gpu.v.cpu() - cpu.v).abs().max() <= 1e-4 * cpu.v.abs().max()


@pytest.mark.parametrize("name,shape,n_cand", [("lq", (21, 21), 9),
                                               ("glider", (7, 5, 5, 6), 3)])
def test_every_entry_on_a_nonuniform_grid(cuda, name, shape, n_cand):
    """Each K1 entry on a tanh grid against its plain version: 2e-4 (the
    Pallas test's bar) with argmins equal off near-ties; the evaluate under
    the improve's policy bit-equal to the improve, the policy bit-equal to
    gather_policy, and 64-bit indices bit-equal to 32-bit. LQ takes the
    structured entries, the glider (drift undeclared) the general ones."""
    tp = tm.make_problem(name)
    periodic = tp.default_grid(shape).periodic
    grid = Grid.create(tp.lb, tp.ub, shape, periodic,
                       nodes=tanh_node_sets(tp.lb, tp.ub, shape, periodic))
    assert not grid.uniform
    ops = db.make_dense_operands(tp, grid, tp.control_candidates(n_cand), cuda)
    improve, evaluate = ((db.dense_backup_general, db.dense_evaluate_general) if ops.general
                         else (db.dense_backup, db.dense_evaluate))
    v = _random_v(grid.shape, cuda)
    counts = (improve.launches, evaluate.launches)
    got, pol = db.dense_backup(ops, v, with_policy=True)
    want, wbest = db.dense_backup_reference(ops, v)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    top2 = torch.topk(db.candidate_rhs(ops, v), 2, dim=0, largest=False).values
    near_tie = (top2[1] - top2[0]) <= TIE * top2[0].abs().clamp(min=1.0)
    assert not torch.any((pol.best != wbest) & ~near_tie)
    gathered = db.gather_policy(ops, pol.best)
    for a, b in ((pol.fpol_k, gathered.fpol_k), (pol.s2pol_k, gathered.s2pol_k),
                 (pol.gpol, gathered.gpol)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(db.dense_evaluate(ops, v, pol), got)
    torch.testing.assert_close(db.dense_evaluate(ops, v, db.gather_policy(ops, wbest)),
                               db.dense_evaluate_reference(ops, v, wbest), rtol=2e-4, atol=2e-4)
    wide, wpol = db.dense_backup(ops, v, with_policy=True, _wide_index=True)
    assert torch.equal(wide, got) and torch.equal(wpol.best, pol.best)
    assert torch.equal(db.dense_evaluate(ops, v, pol, _wide_index=True), got)
    assert (improve.launches, evaluate.launches) == (counts[0] + 2, counts[1] + 3)


def test_receding_horizon_replans_as_one_graph(cuda):
    """iLQR receding-horizon MPC on the card, where every replan replays one
    CUDA graph captured at the first, against the same rollout on the CPU
    (eager): one capture, states within 1e-3 and costs within 1e-3 relative
    (float32 on two devices through 3 iLQR iterations a replan)."""
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.sim import mpc_shoot

    tp = tm.make_problem("pendulum")
    grid = tp.default_grid(21)
    uc = tp.control_candidates(9)
    v = dense_vi(tp, grid, controls=uc, tol=1e-5, max_outer=2000, device="cpu").v
    rng = np.random.default_rng(1)
    x0 = torch.as_tensor(np.stack([np.pi - 0.05 + 0.1 * rng.standard_normal(8),
                                   0.2 * rng.standard_normal(8)], -1), dtype=torch.float32)
    noise = torch.randn((24, 8, 1), generator=torch.Generator().manual_seed(0))
    out = {}
    captures = mpc_shoot._GraphedCall.captures
    for dev in ("cpu", cuda):
        vd = v.to(dev)
        out[str(dev)] = mpc_shoot.receding_horizon_rollout(
            tp, grid, lambda p, vd=vd: multilinear_interp(grid, vd, p), x0.to(dev), dt=0.01,
            n_steps=24, horizon=16, replan_every=4, opt_iters=3, controls=uc,
            noise=noise.to(dev))
    assert mpc_shoot._GraphedCall.captures == captures + 1
    got, want = out[str(cuda)], out["cpu"]
    assert (got.xs.cpu() - want.xs).abs().max() <= 1e-3
    torch.testing.assert_close(got.cost.cpu(), want.cost, rtol=1e-3, atol=1e-5)


def test_dual_mode_rollout_on_card_matches_cpu(cuda):
    """Dual-mode iLQR MPC (terminal_lqr=) on the 6D quadcopter with
    tests/test_terminal.py's tilted surrogate value, half the samples
    starting inside the basin: the card (replans as one CUDA graph, the
    latch outside it) against the CPU, states within 1e-3 and costs within
    1e-3 relative, as the pure-MPC test above."""
    from c3sc_tpu_torch.sim import make_terminal_lqr, mpc_shoot

    tp = tm.make_problem("quadcopter", **QUAD)
    grid = tp.default_grid(9)
    scale = np.asarray([2.0, 2.0, 1.0, 3.0, 3.0, 4.0], np.float32)
    rng = np.random.default_rng(5)
    x0 = np.concatenate([0.1 * rng.uniform(-1, 1, (4, 6)),
                         0.3 * rng.uniform(0.5, 1, (4, 6)) * rng.choice([-1, 1], (4, 6))])
    x0 = torch.as_tensor(x0 * scale, dtype=torch.float32)
    noise = torch.randn((40, 8, tp.dw), generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", cuda):
        sc = torch.as_tensor(scale, device=dev)

        def vfn(p, sc=sc):
            z = p / sc
            return 8.0 * torch.sum(z * z, dim=-1) + 1.5 * z[..., 1]

        out[str(dev)] = mpc_shoot.receding_horizon_rollout(
            tp, grid, vfn, x0.to(dev), dt=0.01, n_steps=40, horizon=16, replan_every=4,
            opt_iters=2, controls=tp.control_candidates(5), noise=noise.to(dev),
            terminal_lqr=make_terminal_lqr(tp, dt=0.01, device=dev))
    got, want = out[str(cuda)], out["cpu"]
    assert (got.xs.cpu() - want.xs).abs().max() <= 1e-3
    torch.testing.assert_close(got.cost.cpu(), want.cost, rtol=1e-3, atol=1e-5)


def _bare(prob):
    """The problem with every structure declaration stripped."""
    return dataclasses.replace(prob, drift_f0=None, drift_G=None, sigma2_x=None, cost_q=None,
                               cost_r=None)


def _general_cases():
    return {
        "pendulum-bare": (lambda: _bare(tm.make_problem("pendulum")), 21, 9),
        "glider": (lambda: tm.make_problem("glider"), (9, 7, 7, 7), 9),
        "glider-bare": (lambda: _bare(tm.make_problem("glider")), (7, 5, 5, 5), 5),
        "quadcopter7-bare": (lambda: _bare(tm.make_problem("quadcopter7", **QUAD)), 4, 3),
    }


@pytest.mark.parametrize("case", list(_general_cases()))
def test_general_entries_match_plain_on_card(cuda, case):
    """dense_backup_general and dense_evaluate_general against the plain
    version (candidate_rhs through mca.transition_all_controls's
    per-candidate branch) under both semantics: values within 2e-4 (the
    structured entry's bar), argmins equal off near-ties (TIE); the 64-bit
    offsets give the 32-bit ones' bits; evaluate under improve's own argmin
    repeats its value bit for bit; each call launches its kernel once."""
    make, n, n_cand = _general_cases()[case]
    tp = make()
    grid = tp.default_grid(n)
    ops = db.make_dense_operands(tp, grid, tp.control_candidates(n_cand), cuda)
    assert ops.general
    v = _random_v(grid.shape, cuda)
    for clip, pin in ((tp.value_bounds, True), (None, False)):
        before = db.dense_backup_general.launches
        got, best = db.dense_backup(ops, v, clip, pin)
        assert db.dense_backup_general.launches == before + 1
        want, wbest = db.dense_backup_reference(ops, v, clip, pin)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        top2 = torch.topk(db.candidate_rhs(ops, v, clip, pin), 2, dim=0, largest=False).values
        near_tie = (top2[1] - top2[0]) <= TIE * top2[0].abs().clamp(min=1.0)
        assert not torch.any((best != wbest) & ~near_tie)
        wide, wide_best = db.dense_backup_general(ops, v, clip, pin, _wide_index=True)
        assert torch.equal(wide, got) and torch.equal(wide_best, best)
    before = db.dense_evaluate_general.launches
    torch.testing.assert_close(db.dense_evaluate(ops, v, wbest),
                               db.dense_evaluate_reference(ops, v, wbest), rtol=2e-4, atol=2e-4)
    assert db.dense_evaluate_general.launches == before + 1
    assert torch.equal(db.dense_evaluate_general(ops, v, wbest, _wide_index=True),
                       db.dense_evaluate_general(ops, v, wbest))
    assert torch.equal(db.dense_evaluate_general(ops, v, best), got)


@pytest.mark.parametrize("name,n,n_cand", [("dubins", (9, 9, 8), 7), ("quadcopter7", 4, 5)])
def test_structured_new_instantiations_match_plain(cuda, name, n, n_cand):
    """The structured entry at (d, du) = (3, 1) (Dubins, a periodic heading
    and obstacles) and (7, 2) (the 7D quadcopter), both semantics, against
    the plain version: values within 2e-4, argmins off near-ties."""
    tp = tm.make_problem(name, **(QUAD if name == "quadcopter7" else {}))
    grid = tp.default_grid(n)
    ops = db.make_dense_operands(tp, grid, tp.control_candidates(n_cand), cuda)
    assert not ops.general
    v = _random_v(grid.shape, cuda)
    for clip, pin in ((tp.value_bounds, True), (None, False)):
        got, best = db.dense_backup(ops, v, clip, pin)
        want, wbest = db.dense_backup_reference(ops, v, clip, pin)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        top2 = torch.topk(db.candidate_rhs(ops, v, clip, pin), 2, dim=0, largest=False).values
        near_tie = (top2[1] - top2[0]) <= TIE * top2[0].abs().clamp(min=1.0)
        assert not torch.any((best != wbest) & ~near_tie)
    torch.testing.assert_close(db.dense_evaluate(ops, v, wbest),
                               db.dense_evaluate_reference(ops, v, wbest), rtol=2e-4, atol=2e-4)


def test_glider_dense_vi_runs_through_the_general_entries(cuda):
    """dense_vi of the glider (no drift declarations) on the card runs one
    general improve and ten general evaluates an outer sweep, no structured
    launch, and lands within 1e-4 x range of the same solve on the CPU."""
    tp = tm.make_problem("glider")
    grid = tp.default_grid((9, 7, 7, 7))
    uc = tp.control_candidates(5)
    counts = lambda: (db.dense_backup.launches, db.dense_evaluate.launches,  # noqa: E731
                      db.dense_backup_general.launches, db.dense_evaluate_general.launches)
    before = counts()
    sol = dense_vi(tp, grid, controls=uc, tol=1e-5, max_outer=400, chunk=50, device=cuda)
    made = [a - b for a, b in zip(counts(), before)]
    assert made == [0, 0, sol.sweeps, 10 * sol.sweeps]
    ref = dense_vi(tp, grid, controls=uc, tol=1e-5, max_outer=400, chunk=50, device="cpu").v.numpy()
    assert np.abs(sol.v.cpu().numpy() - ref).max() <= 1e-4 * (ref.max() - ref.min())


@pytest.mark.parametrize("case", list(_general_cases()))
def test_improve_policy_is_gather_policy_and_evaluate_reads_it(cuda, case):
    """The general improve's epilogue (with_policy=True) writes the winner's
    operands: bit for bit gather_policy of its argmin, under both semantics,
    in both index widths. The redesigned evaluate reads them: under the
    improve's own policy it repeats the improve's value bit for bit; under
    the plain argmin it is within 2e-4 of the plain version and equal to the
    evaluate under the bare indices (which the wrapper gathers first); a bad
    index still gives NaN at its node."""
    make, n, n_cand = _general_cases()[case]
    tp = make()
    grid = tp.default_grid(n)
    ops = db.make_dense_operands(tp, grid, tp.control_candidates(n_cand), cuda)
    v = _random_v(grid.shape, cuda)
    for clip, pin in ((tp.value_bounds, True), (None, False)):
        for wide in (False, True):
            got, pol = db.dense_backup(ops, v, clip, pin, with_policy=True, _wide_index=wide)
            want = db.gather_policy(ops, pol.best)
            for a, b in ((pol.best, want.best), (pol.fpol_k, want.fpol_k),
                         (pol.s2pol_k, want.s2pol_k), (pol.gpol, want.gpol)):
                assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
            bare_v, bare_best = db.dense_backup(ops, v, clip, pin, _wide_index=wide)
            assert torch.equal(bare_v, got) and torch.equal(bare_best, pol.best)
        if clip is None:
            assert torch.equal(db.dense_evaluate(ops, v, pol), got)
    _, wbest = db.dense_backup_reference(ops, v)
    want = db.dense_evaluate_reference(ops, v, wbest)
    got = db.dense_evaluate(ops, v, db.gather_policy(ops, wbest))
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert torch.equal(db.dense_evaluate(ops, v, wbest), got)
    bad = wbest.clone()
    node = int(torch.nonzero(~ops.t_mask)[0])
    bad[node] = ops.uc.shape[0]
    assert torch.isnan(db.dense_evaluate(ops, v, bad).reshape(-1)[node])


def _graphed_and_eager(solve):
    """solve(cuda_graph) run eager, then graphed: both results and the K1
    launches and graph captures each made."""
    from c3sc_tpu_torch.solvers.dense import GraphedSweeps

    out = []
    for graphed in (False, True):
        before, captures = db.launch_counts(), GraphedSweeps.captures
        sol = solve(graphed)
        torch.cuda.synchronize()
        out.append((sol, {k: n - before[k] for k, n in db.launch_counts().items()},
                    GraphedSweeps.captures - captures))
    return out


@pytest.mark.parametrize("name", ["quadcopter", "glider"])
def test_graphed_dense_vi_is_bit_equal_to_eager(cuda, name):
    """dense_vi on the card (cuda_graph=None) replays two captured graphs of
    one outer sweep, the second with the residual, for every chunk, the
    shorter last one too: the value, the sweeps and the residual equal the
    eager loop's (cuda_graph=False) bit for bit, and the launch counts count
    every replayed launch, as many as the eager loop's."""
    tp = tm.make_problem(name, **(QUAD if name == "quadcopter" else {}))
    grid = tp.default_grid(5 if name == "quadcopter" else (9, 7, 7, 7))
    uc = tp.control_candidates(5)
    (eager, e_made, e_caps), (graphed, g_made, g_caps) = _graphed_and_eager(
        lambda graphed: dense_vi(tp, grid, controls=uc, tol=1e-5, max_outer=107, chunk=25,
                                 device=cuda, cuda_graph=None if graphed else False))
    assert torch.equal(eager.v, graphed.v)
    assert (eager.sweeps, eager.residual) == (graphed.sweeps, graphed.residual)
    assert e_made == g_made and e_caps == 0
    entries = ("dense_backup_general", "dense_evaluate_general") if name == "glider" else \
        ("dense_backup", "dense_evaluate")
    assert (g_made[entries[0]], g_made[entries[1]]) == (graphed.sweeps, 10 * graphed.sweeps)
    assert g_caps == 2


def test_graphed_chunks_allocate_nothing_after_the_capture(cuda):
    """The tensors of a graphed chunk come from the graph's pool at the
    capture: device memory stays the same over later replays."""
    from c3sc_tpu_torch.solvers.dense import make_dense_step

    tp = tm.make_problem("glider")
    step, v = make_dense_step(tp, tp.default_grid((9, 7, 7, 7)), tp.control_candidates(5),
                              cuda, cuda_graph=True)
    seen = []
    for _ in range(4):
        v, res = step(v, 10)
        float(res)
        seen.append(torch.cuda.memory_allocated(cuda))
    assert len(set(seen)) == 1, seen


def test_graphed_patch_is_bit_equal_to_eager(cuda):
    """solve_local_patch on the card (a graph of one improve sweep and one
    with the residual, replayed) equals the eager patch solve bit for bit,
    with one counted improve launch per sweep."""
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.solvers.local_patch import solve_local_patch

    tp = tm.make_problem("quadcopter", **QUAD)
    grid = tp.default_grid(9)
    v9 = value_from_npz(V5.replace("quad_dense_v5", "quad_dense_v9"), cuda)
    (eager, e_made, _), (graphed, g_made, caps) = _graphed_and_eager(
        lambda graphed: solve_local_patch(tp, grid, lambda p: multilinear_interp(grid, v9, p),
                                          tp.control_candidates(5), margin=1, tol=1e-5,
                                          max_sweeps=200, chunk=20, device=cuda,
                                          cuda_graph=None if graphed else False))
    assert torch.equal(eager.v, graphed.v)
    assert (eager.sweeps, eager.residual) == (graphed.sweeps, graphed.residual)
    assert e_made == g_made and g_made["dense_backup"] == graphed.sweeps and caps == 2


def test_a_graph_replay_runs_the_kernels_it_counts(cuda):
    """The launch counts of a graphed step come from its captures: one
    replay of each of its two graphs, traced by torch.profiler, runs as many
    K1 kernels of each entry as the counts add."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from c3sc_tpu_torch.solvers.dense import make_dense_step

    tp = tm.make_problem("glider")
    step, v = make_dense_step(tp, tp.default_grid((9, 7, 7, 7)), tp.control_candidates(5), cuda)
    v, _ = step(v, 1)
    torch.cuda.synchronize()
    before = db.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(v, 2)
        torch.cuda.synchronize()
    added = {k: n - before[k] for k, n in db.launch_counts().items()}
    ran = dict.fromkeys(db.ENTRIES, 0)
    for e in prof.events():
        m = re.search(r"\b((?:wide_)?dense_(?:backup|evaluate)(?:_general)?)_kernel\b", e.name)
        if e.device_type == DeviceType.CUDA and m:
            ran[m.group(1)] += 1
    assert ran == added == {"dense_backup": 0, "dense_evaluate": 0,
                            "dense_backup_general": 2, "dense_evaluate_general": 20,
                            "wide_dense_backup_general": 0, "wide_dense_evaluate_general": 0}


def _tanh(grid):
    return Grid.create(grid.lb, grid.ub, grid.shape, grid.periodic,
                       nodes=tanh_node_sets(grid.lb, grid.ub, grid.shape, grid.periodic))


@pytest.mark.parametrize("with_policy", [False, True], ids=["bare", "policy"])
@pytest.mark.parametrize("nonuniform", [False, True], ids=["uniform", "tanh"])
@pytest.mark.parametrize("case", ["glider-4", "states-8"])
def test_runtime_d_matches_compiled_on_card(cuda, case, nonuniform, with_policy):
    """The run-time-d kernels (the wrappers' _runtime_d switch) at d <= 8
    against the compiled general entries on the same grid: the glider's d =
    4 (9 candidates; shared variances and cost) and an eight-state C3Control
    problem (3 candidates; per-candidate variances and cost),
    under both semantics, with and without the improve's policy epilogue.
    They do the same arithmetic in the same order, so value, argmin, policy
    and the evaluate sweep under that policy must agree bit for bit. The
    switched launches count on the wide entries."""
    tp, shape, per_dim = {"glider-4": (tm.make_problem("glider"), (11, 9, 9, 9), 9),
                          "states-8": (many_states(8), 5, 3)}[case]
    grid = tp.default_grid(shape)
    if nonuniform:
        grid = _tanh(grid)
    ops = db.make_dense_operands(tp, grid, tp.control_candidates(per_dim), cuda)
    assert ops.general and grid.ndim <= db.MAX_D
    v = _random_v(grid.shape, cuda)
    counts = lambda: (db.dense_backup_general.launches, db.dense_evaluate_general.launches,  # noqa: E731
                      db.wide_dense_backup_general.launches, db.wide_dense_evaluate_general.launches)
    before = counts()
    for clip, pin in ((tp.value_bounds, True), (None, False)):
        want, wpol = db.dense_backup_general(ops, v, clip, pin, with_policy=with_policy)
        got, gpol = db.dense_backup_general(ops, v, clip, pin, with_policy=with_policy,
                                            _runtime_d=True)
        assert torch.equal(got, want)
        if with_policy:
            for a, b in ((gpol.best, wpol.best), (gpol.fpol_k, wpol.fpol_k),
                         (gpol.s2pol_k, wpol.s2pol_k), (gpol.gpol, wpol.gpol)):
                assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
            policy = wpol
        else:
            assert torch.equal(gpol, wpol)
            policy = db.gather_policy(ops, wpol)
        assert torch.equal(db.dense_evaluate_general(ops, v, policy, _runtime_d=True),
                           db.dense_evaluate_general(ops, v, policy))
    assert [a - b for a, b in zip(counts(), before)] == [2, 2, 2, 2]


def _wide_cases():
    return {
        "nine-states": (nine_states, 4, 3),
        "synthetic-10x5": (lambda: _synthetic_problem(10, 5), (3, 4, 2, 2, 4, 2, 2, 4, 2, 2), 2),
        # the run-time-d form's capacities: d = 9 and 10 take the first (up to
        # 12 dims), 14 the second (16), 18 the third (32, its state in shared memory)
        "fourteen-states": (lambda: many_states(14), 2, 3),
        "synthetic-18x2": (lambda: _synthetic_problem(18, 2), (3, 2, 3) + (2,) * 15, 2),
    }


@pytest.mark.parametrize("nonuniform", [False, True], ids=["uniform", "tanh"])
@pytest.mark.parametrize("case", list(_wide_cases()))
def test_wide_entries_match_plain_on_card(cuda, case, nonuniform):
    """K1's run-time-d general kernels (d = 9 from C3Control; d = 10 with
    five controls and all five declarations, periodic, absorbing and
    reflecting faces; d = 14 and 18, the larger capacities) against the
    plain version under both semantics:
    values within 2e-4, argmins off near-ties (TIE), the improve's policy
    bit for bit gather_policy of its argmin, 64-bit offsets bit-equal to
    32-bit, evaluate under the improve's own policy bit-equal to it. Every
    launch counts on the wide entries, none on the compiled ones."""
    make, n, n_cand = _wide_cases()[case]
    tp = make()
    grid = tp.default_grid(n)
    if nonuniform:
        grid = _tanh(grid)
    ops = db.make_dense_operands(tp, grid, tp.control_candidates(n_cand), cuda)
    assert ops.general and grid.ndim > db.MAX_D
    v = _random_v(grid.shape, cuda)
    counts = lambda: (db.dense_backup_general.launches, db.dense_evaluate_general.launches,  # noqa: E731
                      db.wide_dense_backup_general.launches, db.wide_dense_evaluate_general.launches)
    before = counts()
    for clip, pin in ((tp.value_bounds, True), (None, False)):
        got, pol = db.dense_backup(ops, v, clip, pin, with_policy=True)
        want, wbest = db.dense_backup_reference(ops, v, clip, pin)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        top2 = torch.topk(db.candidate_rhs(ops, v, clip, pin), 2, dim=0, largest=False).values
        near_tie = (top2[1] - top2[0]) <= TIE * top2[0].abs().clamp(min=1.0)
        assert not torch.any((pol.best != wbest) & ~near_tie)
        gathered = db.gather_policy(ops, pol.best)
        for a, b in ((pol.fpol_k, gathered.fpol_k), (pol.s2pol_k, gathered.s2pol_k),
                     (pol.gpol, gathered.gpol)):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
        wide, wide_pol = db.dense_backup(ops, v, clip, pin, with_policy=True, _wide_index=True)
        assert torch.equal(wide, got) and torch.equal(wide_pol.best, pol.best)
        if clip is None:
            assert torch.equal(db.dense_evaluate(ops, v, pol), got)
    torch.testing.assert_close(db.dense_evaluate(ops, v, wbest),
                               db.dense_evaluate_reference(ops, v, wbest), rtol=2e-4, atol=2e-4)
    assert torch.equal(db.dense_evaluate(ops, v, wbest, _wide_index=True),
                       db.dense_evaluate(ops, v, wbest))
    made = [a - b for a, b in zip(counts(), before)]
    assert made == [0, 0, 4, 4]


@pytest.mark.parametrize("case", ["du5", "du5-declared", "nine-states"])
def test_wide_dense_vi_on_card_matches_cpu(cuda, case):
    """dense_vi of the five-control double integrator at 21^2 (243
    candidates; with and without the declarations) and of the nine-state
    problem at 3^9 on the card, through K1's general entries, against the
    same solve on the CPU: within 2e-4 of max|v|."""
    tp, n, per_dim = {"du5": (double_integrator_du5(), 21, 3),
                      "du5-declared": (double_integrator_du5(declared=True), 21, 3),
                      "nine-states": (nine_states(), 3, 3)}[case]
    grid = tp.default_grid(n)
    uc = tp.control_candidates(per_dim)
    entry = db.wide_dense_backup_general if grid.ndim > db.MAX_D else db.dense_backup_general
    before = entry.launches
    sol = dense_vi(tp, grid, controls=uc, tol=1e-6, max_outer=2000, chunk=50, device=cuda)
    assert entry.launches - before == sol.sweeps
    ref = dense_vi(tp, grid, controls=uc, tol=1e-6, max_outer=2000, chunk=50, device="cpu").v
    assert (sol.v.cpu() - ref).abs().max() <= 2e-4 * ref.abs().max()
