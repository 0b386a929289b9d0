"""The flagship accuracy stack of the port as a whole, against the JAX
package on the CPU, every call on device "cpu", and the carriers of its
state (``convert.cross_state_from_numpy``, ``convert.patch_from_npz``).

Bars, each stated at its test:
  - every module of the slice imports first in a fresh interpreter (the
    solvers and sim packages import each other);
  - the carriers: exact round trips;
  - the committed flagship fields of seed 0 (``northstar_seed0_v.npz``, rank
    64 at 9^6, and ``northstar_seed0_patch.npz``, 7^6): the deployed
    composite ``make_patched_value_fn(tt_lerp_eval(v), patch)`` at all 9^6
    nodes against ``quad_dense_v9.npz`` has interior q95 0.028826 +- 1e-5
    (the JAX package's value on the CPU), and agrees with the JAX composite
    at random nodes within 1e-5 x the value range;
  - the recipe of ``experiments/quad_dense_oracle.py`` cut to the quadcopter
    5^6 at rank 8 (polish, coarse correction, gated level and mode
    corrections with a probe, one two-level cycle), run by both packages from
    one base TT with the JAX cross states handed in: every gate decides the
    same, the deployed composites agree within 1e-3 x the value range at
    every node, and their interior q95 against the dense solve within 1e-3.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import ART, QUAD, REPO, V5
from c3sc_tpu import models as jm
from c3sc_tpu.grids import Grid as JGrid
from c3sc_tpu.ops import tt as jtt
from c3sc_tpu.ops.cross import init_cross_state as j_init_cross_state
from c3sc_tpu.solvers import gating as jgate
from c3sc_tpu.solvers import local_patch as jlp
from c3sc_tpu.solvers import polish as jpol
from c3sc_tpu.solvers import twogrid as jtg
from c3sc_tpu.solvers.ttvi import make_bellman_kernel as j_kernel
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import (cross_state_from_numpy, patch_from_npz, tt_from_npz,
                                    tt_from_numpy, value_from_npz)
from c3sc_tpu_torch.models.base import Boundary
from c3sc_tpu_torch.ops.cross import init_cross_state
from c3sc_tpu_torch.ops.tt import tt_lerp_eval
from c3sc_tpu_torch.solvers import gating as tgate
from c3sc_tpu_torch.solvers import local_patch as tlp
from c3sc_tpu_torch.solvers import polish as tpol
from c3sc_tpu_torch.solvers import twogrid as ttg
from c3sc_tpu_torch.solvers.ttvi import make_bellman_kernel

CPU = "cpu"
SEED0_Q95 = 0.028826     # the JAX package's interior q95 of the committed seed-0 composite


@pytest.mark.parametrize("module", ["c3sc_tpu_torch.sim", "c3sc_tpu_torch.solvers",
                                    "c3sc_tpu_torch.sim.policy",
                                    "c3sc_tpu_torch.solvers.gating"])
def test_module_imports_first(module):
    """No import cycle between the solvers and sim packages, whichever a
    program imports first."""
    run = subprocess.run([sys.executable, "-c", f"import {module}"], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]


def test_cross_state_round_trip():
    """A JAX CrossState carried across equals itself, and the port's
    init_cross_state draws the same sets from the seed a JAX key turns into."""
    key = jax.random.key(5)
    js = j_init_cross_state(key, (9,) * 6, 8)
    ts = cross_state_from_numpy(js.left, js.right)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    for other in (ts, init_cross_state(seed, (9,) * 6, 8)):
        assert other.ranks_left == js.ranks_left and other.ranks_right == js.ranks_right
        for a, b in zip(js.left + js.right, other.left + other.right):
            np.testing.assert_array_equal(b, a)
            assert b.dtype == np.int64
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a, b = init_cross_state(g1, (5, 6, 7), 4), init_cross_state(g2, (5, 6, 7), 4)
    assert all(np.array_equal(x, y) for x, y in zip(a.left + a.right, b.left + b.right))


def test_patch_round_trip(tmp_path):
    """patch_from_npz reads the keys v, lo, hi that the flagship writes and
    rebuilds the sub-box; a patch written the same way reads back equal."""
    grid = tm.make_problem("quadcopter", **QUAD).default_grid(9)
    patch = patch_from_npz(os.path.join(ART, "northstar_seed0_patch.npz"), grid, CPU)
    assert patch.lo == (1,) * 6 and patch.hi == (7,) * 6 and patch.v.shape == (7,) * 6
    assert patch.subgrid.uniform and np.allclose(patch.subgrid.h, grid.h)
    path = tmp_path / "patch.npz"
    np.savez(path, v=patch.v.numpy(), lo=patch.lo, hi=patch.hi)
    back = patch_from_npz(str(path), grid, CPU)
    assert back.lo == patch.lo and back.hi == patch.hi and back.subgrid == patch.subgrid
    assert torch.equal(back.v, patch.v)


def _interior_q95(prob, v, v_dense):
    rel = np.abs(v - v_dense) / (v_dense.max() - v_dense.min())
    sl = tuple(slice(1, -1) if b == Boundary.ABSORB else slice(None) for b in prob.boundary)
    return float(np.quantile(rel[sl], 0.95))


def test_committed_seed0_composite_q95():
    """The deployed composite of the committed seed-0 fields at all 531,441
    nodes: interior q95 0.028826 +- 1e-5 against the stored dense solve; and
    the JAX composite at 4,096 random nodes within 1e-5 x the range."""
    prob = tm.make_problem("quadcopter", **QUAD)
    grid = prob.default_grid(9)
    v_tt = tt_from_npz(os.path.join(ART, "northstar_seed0_v.npz"), CPU)
    patch = patch_from_npz(os.path.join(ART, "northstar_seed0_patch.npz"), grid, CPU)
    vfn = tlp.make_patched_value_fn(grid, lambda p: tt_lerp_eval(v_tt, grid, p), patch)
    x = grid.node_states(CPU)
    with torch.no_grad():
        comp = torch.cat([vfn(x[i:i + 65536]) for i in range(0, x.shape[0], 65536)])
    comp = comp.numpy().reshape(grid.shape)
    vd = value_from_npz(os.path.join(ART, "quad_dense_v9.npz"), CPU).numpy()
    assert abs(_interior_q95(prob, comp, vd) - SEED0_Q95) <= 1e-5

    jprob = jm.make_problem("quadcopter", **QUAD)
    jg = jprob.default_grid(9)
    jv = jtt.tt_load(os.path.join(ART, "northstar_seed0_v.npz"))
    with np.load(os.path.join(ART, "northstar_seed0_patch.npz")) as z:
        pv, lo, hi = z["v"], tuple(z["lo"].tolist()), tuple(z["hi"].tolist())
    sub = JGrid.create(
        [float(jg.nodes(k)[lo[k]]) for k in range(6)], [float(jg.nodes(k)[hi[k]]) for k in range(6)],
        [h - l + 1 for l, h in zip(lo, hi)], (False,) * 6,   # noqa: E741
        nodes=[jg.nodes(k)[lo[k]:hi[k] + 1] for k in range(6)])
    jpatch = jlp.LocalPatch(sub, jnp.asarray(pv), lo, hi, 0.0, 0)
    jfn = jlp.make_patched_value_fn(jg, lambda p: jtt.tt_lerp_eval(jv, jg, p), jpatch)
    pick = np.random.default_rng(0).integers(0, x.shape[0], 4096)
    want = np.asarray(jfn(jnp.asarray(x[pick].numpy())))
    assert np.abs(comp.reshape(-1)[pick] - want).max() <= 1e-5 * (vd.max() - vd.min())


def _jax_probe_noise(dw, n_rollouts, n_steps, seed=4242):
    keys = jax.random.split(jax.random.key(20_000 + seed), n_steps)
    return np.stack([np.asarray(jax.random.normal(k, (n_rollouts, dw), jnp.float32))
                     for k in keys])


def test_recipe_at_quad5_matches_jax(monkeypatch):
    """quad_dense_oracle.py's recipe at 5^6, rank 8, from one base (a rank-4
    truncation of the stored 5^6 dense solve, level-shifted by 2)."""
    jp, tp = jm.make_problem("quadcopter", **QUAD), tm.make_problem("quadcopter", **QUAD)
    jg, tg = jp.default_grid(5), tp.default_grid(5)
    uc = jp.control_candidates(5)
    vd = value_from_npz(V5, CPU).numpy()
    R = 8
    base = jtt.tt_add(jtt._repad(jtt.tt_from_dense(jnp.asarray(vd), rmax=4, tol=1e-6), R),
                      jtt.tt_constant(jg.shape, 2.0, R))
    # the cross states JAX draws (polish from key 0, two-level from fold_in(key 0, 0))
    states = [j_init_cross_state(jax.random.split(jax.random.key(0))[1], jg.shape, 8),
              j_init_cross_state(jax.random.split(jax.random.fold_in(jax.random.key(0), 0))[1],
                                 jg.shape, 8)]
    handed = iter(copy.deepcopy(states))
    monkeypatch.setattr(tpol, "init_cross_state", lambda gen, shape, r0: next(handed))
    probe_kw = dict(n_rollouts=8, n_steps=60)
    poly = dict(schedule=((2, R),), chunk=8192, n_check=1024)

    def run(pkg, prob, grid, v, kernel, probe, to_field):
        pol, tg_, gate, lp = pkg
        v = pol.tt_polish(prob, grid, uc, v, rmax=R, kernel=kernel, **poly).v
        v, cinfo = tg_.coarse_correct(prob, grid, uc, v, kernel=kernel, rmax_corr=8, chunk=8192)
        decisions = [cinfo.accepted]
        for name, corr in (("level", pol.level_correct), ("modes", pol.mode_correct)):
            v, rec = gate.gated_apply(prob, grid, uc, v,
                                      lambda vt: corr(prob, grid, uc, vt, kernel=kernel,
                                                      n_samples=2048)[0],
                                      name=name, kernel=kernel, n_check=1024, probe_fn=probe)
            decisions.append(rec.accepted)
        tl = lp.two_level_solve(prob, grid, uc, v, rmax=R, cycles=1, cycle_schedule=((2, R),),
                                margin=1, chunk=8192, n_check=1024)
        return decisions, to_field(tl.v, tl.patch)

    jprobe = jgate.make_greedy_probe(jp, jg, uc, **probe_kw)
    jdec, jcomp = run((jpol, jtg, jgate, jlp), jp, jg, base, j_kernel(jp, jg, uc, chunk=8192),
                      jprobe, lambda v, patch: np.asarray(jlp.make_patched_value_fn(
                          jg, lambda p: jtt.tt_lerp_eval(v, jg, p), patch)(
                          jnp.asarray(np.stack([m.ravel() for m in jg.meshgrid()], -1),
                                      jnp.float32))))
    tprobe = tgate.make_greedy_probe(tp, tg, uc, noise=_jax_probe_noise(jp.dw, 8, 60),
                                     device=CPU, **probe_kw)
    tbase = tt_from_numpy([np.asarray(c) for c in base.cores], np.asarray(base.ranks), CPU)
    tdec, tcomp = run((tpol, ttg, tgate, tlp), tp, tg, tbase,
                      make_bellman_kernel(tp, tg, uc, chunk=8192), tprobe,
                      lambda v, patch: tlp.make_patched_value_fn(
                          tg, lambda p: tt_lerp_eval(v, tg, p), patch)(
                          tg.node_states(CPU)).numpy())
    assert tdec == jdec
    vrange = vd.max() - vd.min()
    assert np.abs(tcomp - jcomp).max() <= 1e-3 * vrange
    # the statistic the flagship reports, from both composites
    q_jax = _interior_q95(tp, jcomp.reshape(tg.shape), vd)
    assert abs(_interior_q95(tp, tcomp.reshape(tg.shape), vd) - q_jax) <= 1e-3
