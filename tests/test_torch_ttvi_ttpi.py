"""The port's host-loop solvers — ``tt_vi`` (c3sc_tpu_torch.solvers.ttvi),
``tt_pi`` (solvers/ttpi.py) and warm-replan MPC (sim/mpc.py) — against
c3sc_tpu's on the CPU, every call with device="cpu".

Bars:
  - tt_vi from JAX's cross index sets and noise (every iteration's cross
    seeded with the integers JAX's split keys give), 15 iterations on the
    LQ 15^2 with both cross methods: the same ranks every iteration, the
    value within 1e-4 x max|v| (the fit's float32 rounding compounds over
    the iterations through its pivots' interpolation);
  - tests/test_ttvi.py's bars on the port: LQ 31^2 with both cross methods,
    sup error < 2 % of max|dense|; with refine_steps 5 on a coarse candidate
    set, q95 < 5 %. Its pendulum case (1,500 iterations, 20 s on one CPU
    thread) is held on the card instead, at the CLI's 41^2 (chip_smoke.py
    J.5), to keep this file near its time;
  - the policy kernels against JAX's: the greedy controls equal except where
    two candidates tie within TIE; the fixed-policy backup within rtol 1e-5,
    atol 1e-5 x max|v|;
  - tests/test_ttpi.py's bars on the port: LQ 31^2 (sup error < 3 %, the
    policy near 0 at the origin, <= 40 outer iterations). Its Dubins case
    (q95 < 2 %, mean < 0.5 %, <= 15 outer iterations; marked slow in the
    JAX suite) is held on the card at its size (chip_smoke.py J.5);
  - tests/test_mpc.py's bar on the port, with JAX's rollout noise (its
    per-cycle keys drawn as JAX's rollout draws them) passed as ``noise=``:
    the shapes, six latencies, the closed loop halves |x_0| and costs are
    finite; its final state within 0.05 of JAX's closed loop under the same
    noise;
  - ``checkpoint_path`` writes the file ``resume_from`` continues from.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import TIE, close, port_grid, random_tt_numpy
from c3sc_tpu import models as jm
from c3sc_tpu.ops.tt import TT as JTT
from c3sc_tpu.ops.tt import tt_full as jtt_full
from c3sc_tpu.sim import mpc as jmpc
from c3sc_tpu.solvers import ttpi as jpi
from c3sc_tpu.solvers import ttvi as jvi
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import tt_from_numpy
from c3sc_tpu_torch.ops.tt import tt_full, tt_gather_eval
from c3sc_tpu_torch.sim import mpc_run
from c3sc_tpu_torch.solvers import dense_vi, tt_pi, tt_vi
from c3sc_tpu_torch.solvers import ttpi as tpi


def _randint(k):
    return int(jax.random.randint(k, (), 0, 2**31 - 1))


def jax_cross_seeds(n_iters, method, key=0):
    """Per iteration of JAX's tt_vi, what its cross function turns its key
    into: (index-set seed, noise seed) for tt_cross, (index-set seed,) for
    dmrg_cross."""
    k, out = jax.random.key(key), []
    for _ in range(n_iters):
        k, sk = jax.random.split(k)
        if method == "dmrg":
            out.append([_randint(jax.random.split(sk)[1])])
        else:
            out.append([_randint(x) for x in jax.random.split(sk, 3)[1:]])
    return out


@pytest.mark.parametrize("method", ["cross", "dmrg"])
def test_ttvi_from_jax_seeds_matches_jax(method):
    jp, tp = jm.make_lq_problem(sigma=1.0, beta=1.0), tm.make_lq_problem(sigma=1.0, beta=1.0)
    jg = jp.default_grid(15)
    uc = jp.control_candidates(9)
    kw = dict(controls=uc, rmax=8, tol=0.0, max_iters=15, cross_sweeps=1, chunk=512,
              cross_method=method)
    want = jvi.tt_vi(jp, jg, key=jax.random.key(0), **kw)
    got = tt_vi(tp, port_grid(jg), seed=jax_cross_seeds(15, method), device="cpu", **kw)
    assert got.iterations == want.iterations == 15
    assert got.ranks == want.ranks
    w = np.asarray(jtt_full(want.v))
    close(tt_full(got.v), w, rtol=0, atol=1e-4 * np.abs(w).max())
    np.testing.assert_allclose(got.residual_history, want.residual_history, rtol=0, atol=1e-4)
    assert got.n_evals == want.n_evals


@pytest.mark.parametrize("method", ["cross", "dmrg"])
def test_ttvi_matches_dense(method):
    prob = tm.make_lq_problem(sigma=1.0, beta=1.0)
    grid = prob.default_grid(31)
    controls = prob.control_candidates(15)
    rmax = 10
    dense = dense_vi(prob, grid, controls=controls, tol=1e-5, max_outer=400, chunk=100,
                     device="cpu")
    sol = tt_vi(prob, grid, controls=controls, rmax=rmax, seed=0, tol=2e-4,
                max_iters=800 if method == "dmrg" else 1500, cross_sweeps=1, chunk=2048,
                cross_method=method, device="cpu")
    v_d = dense.v.numpy()
    err = np.abs(tt_full(sol.v).numpy() - v_d).max() / np.abs(v_d).max()
    assert err < 0.02, f"TT vs dense sup error {err:.3f} (ranks={sol.ranks[-1]})"
    assert max(sol.ranks[-1]) <= rmax


def test_ttvi_refine_steps_matches_dense():
    prob = tm.make_lq_problem(sigma=1.0, beta=1.0)
    grid = prob.default_grid(21)
    dense = dense_vi(prob, grid, controls=prob.control_candidates(41), tol=1e-5, max_outer=400,
                     chunk=100, device="cpu")
    sol = tt_vi(prob, grid, controls=prob.control_candidates(9), rmax=10, seed=0, tol=2e-4,
                max_iters=800, cross_sweeps=1, chunk=2048, refine_steps=5, device="cpu")
    v_d = dense.v.numpy()
    err = np.abs(tt_full(sol.v).numpy() - v_d) / np.abs(v_d).max()
    assert np.quantile(err, 0.95) < 0.05


@pytest.mark.parametrize("kw", [dict(checkpoint_path="x.npz"), dict(resume_from="x.npz")])
def test_ttvi_checkpoint_not_ported(kw, tmp_path, monkeypatch):
    """Ported since this test was written (it held the raise): one
    iteration with ``checkpoint_path`` writes the file, and ``resume_from``
    continues from it at the next iteration (tests/test_torch_resume.py
    holds the resume bit for bit)."""
    from c3sc_tpu_torch.utils import load_solver_state

    monkeypatch.chdir(tmp_path)
    prob = tm.make_lq_problem()
    grid = prob.default_grid(11)
    tt_vi(prob, grid, max_iters=1, device="cpu", checkpoint_path="x.npz", checkpoint_every=1)
    assert load_solver_state("x.npz", "cpu")["iteration"] == 0
    if "resume_from" in kw:
        assert tt_vi(prob, grid, max_iters=2, device="cpu", **kw).iterations == 2


def test_policy_kernels_match_jax():
    jp, tp = jm.make_lq_problem(sigma=1.0, beta=1.0), tm.make_lq_problem(sigma=1.0, beta=1.0)
    jg = jp.default_grid(21)
    tg = port_grid(jg)
    uc = jp.control_candidates(9)
    cores, rk = random_tt_numpy(jg.shape, [4], 6, seed=1)
    cores[0] = cores[0] * 20.0
    pc, pr = random_tt_numpy(jg.shape, [2], 6, seed=2)
    jv, tv = JTT(tuple(jnp.asarray(c) for c in cores), jnp.asarray(rk)), tt_from_numpy(cores, rk,
                                                                                       "cpu")
    jpol = (JTT(tuple(jnp.asarray(c) for c in pc), jnp.asarray(pr)),)
    tpol = (tt_from_numpy(pc, pr, "cpu"),)
    idx = np.stack(np.meshgrid(np.arange(21), np.arange(21), indexing="ij"), -1).reshape(-1, 2)
    want_u = np.asarray(jpi.make_policy_kernel(jp, jg, uc, chunk=128)(
        jv, jnp.asarray(idx, jnp.int32)))
    got_u = tpi.make_policy_kernel(tp, tg, uc, chunk=128)(tv, torch.as_tensor(idx)).numpy()
    # a choice may differ only where two candidates' RHS tie within TIE
    differ = np.nonzero((got_u != want_u).any(-1))[0]
    if differ.size:
        from c3sc_tpu_torch.ops import mca
        from c3sc_tpu_torch.solvers.ttvi import _neighbor_indices

        ix = torch.as_tensor(idx[differ])
        x = tg.index_to_state(ix)
        nb = _neighbor_indices(tg, ix).reshape(-1, 2)
        vn = tt_gather_eval(tv, nb)
        tmask, tval = mca.node_terminal(tp, tg, nb, tg.index_to_state(nb))
        vn = torch.where(tmask, tval, vn).reshape(-1, 2, 2)
        ucs = torch.as_tensor(uc, dtype=torch.float32)
        pp, pm, dt = mca.transition_all_controls(tp, tg, x, ucs)
        rhs = mca.stage_cost_all(tp, x, ucs) * dt + torch.exp(-tp.beta * dt) * (
            pp * vn[None, :, 0] + pm * vn[None, :, 1]).sum(-1)
        top2 = torch.topk(rhs, 2, dim=0, largest=False).values
        assert ((top2[1] - top2[0]) <= TIE * top2[0].abs().clamp(min=1.0)).all()
    want_b = np.asarray(jpi.make_policy_eval_kernel(jp, jg, chunk=128)(
        jv, jpol, jnp.asarray(idx, jnp.int32)))
    got_b = tpi.make_policy_eval_kernel(tp, tg, chunk=128)(tv, tpol, torch.as_tensor(idx))
    close(got_b, want_b, rtol=1e-5, atol=1e-5 * np.abs(want_b).max())


def test_ttpi_matches_dense_lq():
    prob = tm.make_lq_problem(sigma=1.0, beta=1.0)
    grid = prob.default_grid(31)
    controls = prob.control_candidates(15)
    dense = dense_vi(prob, grid, controls=controls, tol=1e-5, max_outer=400, chunk=100,
                     device="cpu")
    sol = tt_pi(prob, grid, controls=controls, rmax=10, seed=0, tol=3e-4, outer_iters=40,
                eval_iters=15, chunk=1024, device="cpu")
    v_d = dense.v.numpy()
    err = np.abs(tt_full(sol.v).numpy() - v_d).max() / np.abs(v_d).max()
    assert err < 0.03, f"PI vs dense sup error {err:.3f}"
    u0 = float(tt_gather_eval(sol.policy[0], torch.tensor([[15, 15]]))[0])
    assert abs(u0) < 1.0
    assert sol.outer_iters <= 40


def jax_mpc_noise(key, n_replans, steps, B, dw):
    """The Euler–Maruyama increments JAX's mpc_run draws: the cold solve's
    split, then per cycle a solve's split (after the first) and the
    rollout's key, split into one key a step."""
    key, _ = jax.random.split(key)
    out = []
    for cycle in range(n_replans):
        if cycle > 0:
            key, _ = jax.random.split(key)
        key, rk = jax.random.split(key)
        out.append(np.stack([np.asarray(jax.random.normal(k, (B, dw), jnp.float32))
                             for k in jax.random.split(rk, steps)]))
    return np.stack(out)


def test_mpc_stabilizes_lq():
    jp, tp = jm.make_lq_problem(sigma=0.5, beta=1.0), tm.make_lq_problem(sigma=0.5, beta=1.0)
    jg = jp.default_grid(21)
    B = 16
    kw = dict(dt=0.02, steps_per_replan=25, n_replans=6, n_controls=9, rmax=8, refine_iters=2,
              first_solve_iters=200, solver_kwargs=dict(tol=1e-3, cross_sweeps=1, chunk=1024))
    x0 = np.tile(np.array([1.5, 0.0], np.float32), (B, 1))
    noise = jax_mpc_noise(jax.random.key(0), 6, 25, B, tp.dw)
    res = mpc_run(tp, port_grid(jg), torch.as_tensor(x0), noise=torch.as_tensor(noise), seed=0,
                  device="cpu", **kw)
    assert res.xs.shape == (1 + 6 * 25, B, 2)
    assert res.us.shape == (6 * 25, B, 1)
    assert len(res.replan_latency) == 6
    final = res.xs[-1].abs().mean(0).numpy()
    start = res.xs[0].abs().mean(0).numpy()
    assert final[0] < start[0] * 0.5
    assert torch.isfinite(res.cost).all()
    want = jmpc.mpc_run(jp, jg, jnp.asarray(x0), jax.random.key(0), **kw)
    close(final, np.abs(np.asarray(want.xs[-1])).mean(0), rtol=0, atol=0.05)
