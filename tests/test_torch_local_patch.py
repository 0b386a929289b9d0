"""The port's local dense patch and two-level composite
(c3sc_tpu_torch.solvers.local_patch) against the JAX package on the CPU,
every call on device "cpu". On the CPU the patch's sweeps run kernel K1's
plain version (``ops/dense_backup.dense_backup_reference``); the card-only
test in ``tests/test_torch_kernels.py`` holds the kernel itself.

Bars, each stated at its test:
  - ``solve_local_patch`` on the non-uniform pendulum patch (a slice of the
    periodic theta nodes is not a uniform grid) and on the uniform quadcopter
    5^6 patch at margin 1: the same sweep count, the patch within
    1e-5 x max|v| (float32 sweeps of one operator) and the residual within
    1e-5 x max|v|;
  - ``make_patch_node_value_fn`` and the composite Bellman kernel: float32
    rounding, rtol 1e-5 with atol 1e-5 x max|v|;
  - ``make_patched_value_fn``: 1e-5 x max|v| at points inside, outside and on
    the seam;
  - ``two_level_solve`` (one cycle, the JAX cross state handed in): the
    patch and the TT within 1e-4 x max|v|.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import QUAD, V5, random_tt_numpy
from c3sc_tpu import models as jm
from c3sc_tpu.ops import tt as jtt
from c3sc_tpu.ops.cross import init_cross_state as j_init_cross_state
from c3sc_tpu.ops.interp import multilinear_interp as j_interp
from c3sc_tpu.solvers import local_patch as jlp
from c3sc_tpu.solvers.dense import dense_vi as j_dense_vi
from c3sc_tpu.solvers.ttvi import make_bellman_kernel as j_kernel
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import tt_from_numpy, value_from_npz
from c3sc_tpu_torch.ops import tt as ttt
from c3sc_tpu_torch.ops.interp import multilinear_interp
from c3sc_tpu_torch.solvers import local_patch as tlp
from c3sc_tpu_torch.solvers import polish as tpol
from c3sc_tpu_torch.solvers.ttvi import make_bellman_kernel

CPU = "cpu"
LO, HI = (8, 8), (22, 22)     # tests/test_local_patch.py's pendulum sub-box


def to_port(jt):
    return tt_from_numpy([np.asarray(c) for c in jt.cores], np.asarray(jt.ranks), CPU)


@pytest.fixture(scope="module")
def pendulum():
    jp, tp = jm.make_problem("pendulum"), tm.make_problem("pendulum")
    jg, tg = jp.default_grid(31), tp.default_grid(31)
    uc = jp.control_candidates(9)
    vd = np.array(j_dense_vi(jp, jg, controls=uc, tol=1e-6, max_outer=4000).v)
    return jp, tp, jg, tg, uc, vd


def _same_patch(jpatch, tpatch, vmax):
    assert tpatch.sweeps == jpatch.sweeps and tpatch.lo == jpatch.lo and tpatch.hi == jpatch.hi
    assert tpatch.subgrid.shape == jpatch.subgrid.shape
    assert abs(tpatch.residual - jpatch.residual) <= 1e-5 * vmax
    assert np.abs(tpatch.v.numpy() - np.asarray(jpatch.v)).max() <= 1e-5 * vmax


def test_solve_local_patch_nonuniform_pendulum(pendulum):
    """A degraded face (the dense value + a smooth bump) relaxed by the patch."""
    jp, tp, jg, tg, uc, vd = pendulum
    bump = np.asarray(jg.meshgrid()[1], np.float32)
    vdeg = (vd + 0.05 * bump).astype(np.float32)
    jpatch = jlp.solve_local_patch(jp, jg, lambda p: j_interp(jg, jnp.asarray(vdeg), p), uc,
                                   lo=LO, hi=HI, tol=1e-5, max_sweeps=400)
    tv = torch.as_tensor(vdeg)
    tpatch = tlp.solve_local_patch(tp, tg, lambda p: multilinear_interp(tg, tv, p), uc,
                                   lo=LO, hi=HI, tol=1e-5, max_sweeps=400, device=CPU)
    assert not tpatch.subgrid.uniform and not jpatch.subgrid.uniform
    _same_patch(jpatch, tpatch, np.abs(vd).max())


def test_solve_local_patch_uniform_quadcopter5():
    """The quadcopter 5^6 at margin 1 (a uniform 3^6 sub-box, the flagship's
    shape cut to the test's size), faces from the stored 5^6 dense solve."""
    jp, tp = jm.make_problem("quadcopter", **QUAD), tm.make_problem("quadcopter", **QUAD)
    jg, tg = jp.default_grid(5), tp.default_grid(5)
    uc = jp.control_candidates(5)
    v5 = value_from_npz(V5, CPU)
    jpatch = jlp.solve_local_patch(jp, jg, lambda p: j_interp(jg, jnp.asarray(v5.numpy()), p),
                                   uc, margin=1, tol=1e-5)
    tpatch = tlp.solve_local_patch(tp, tg, lambda p: multilinear_interp(tg, v5, p), uc,
                                   margin=1, tol=1e-5, device=CPU)
    assert tpatch.subgrid.uniform and jpatch.subgrid.uniform
    assert tpatch.subgrid.shape == (3,) * 6
    _same_patch(jpatch, tpatch, v5.abs().max().item())


@pytest.fixture(scope="module")
def pendulum_patch(pendulum):
    jp, tp, jg, tg, uc, vd = pendulum
    vfj = lambda p: j_interp(jg, jnp.asarray(vd), p)  # noqa: E731
    jpatch = jlp.solve_local_patch(jp, jg, vfj, uc, lo=LO, hi=HI, tol=1e-5)
    tpatch = tlp.LocalPatch(tlp.patch_subgrid(tg, LO, HI), torch.as_tensor(np.array(jpatch.v)),
                            LO, HI, jpatch.residual, jpatch.sweeps)
    return jpatch, tpatch


def test_composite_kernel_matches_jax(pendulum, pendulum_patch):
    """make_patch_node_value_fn at nodes inside and outside the sub-box, and
    the Bellman kernel of the composite field built on it."""
    jp, tp, jg, tg, uc, vd = pendulum
    jpatch, tpatch = pendulum_patch
    cores, ranks = random_tt_numpy(jg.shape, [5], 6, seed=1)
    cores[0] = cores[0] * 20.0
    jt = jtt.TT(tuple(jnp.asarray(c) for c in cores), jnp.asarray(ranks))
    tt = tt_from_numpy(cores, ranks, CPU)
    idx = np.stack([np.random.default_rng(2).integers(0, 31, 900) for _ in range(2)], -1)
    want = np.asarray(jlp.make_patch_node_value_fn(jpatch)(jt, jnp.asarray(idx, jnp.int32)))
    got = tlp.make_patch_node_value_fn(tpatch)(tt, torch.as_tensor(idx)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jk = j_kernel(jp, jg, uc, chunk=512, node_value_fn=jlp.make_patch_node_value_fn(jpatch))
    tk = make_bellman_kernel(tp, tg, uc, chunk=512,
                             node_value_fn=tlp.make_patch_node_value_fn(tpatch))
    want = np.asarray(jk(jt, jnp.asarray(idx, jnp.int32)))
    np.testing.assert_allclose(tk(tt, idx).numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_patched_value_fn_matches_jax(pendulum, pendulum_patch):
    jp, tp, jg, tg, uc, vd = pendulum
    jpatch, tpatch = pendulum_patch
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(-np.pi, np.pi, 600), rng.uniform(-8, 8, 600)], -1)
    seam = np.stack([np.full(7, jg.nodes(0)[LO[0]]), np.linspace(-7.5, 7.5, 7)], -1)
    pts = np.concatenate([pts, seam, seam + [0.01, 0.0], seam - [0.01, 0.0]]).astype(np.float32)
    want = np.asarray(jlp.make_patched_value_fn(
        jg, lambda p: j_interp(jg, jnp.asarray(vd), p), jpatch)(jnp.asarray(pts)))
    got = tlp.make_patched_value_fn(
        tg, lambda p: multilinear_interp(tg, torch.as_tensor(vd), p), tpatch)(
        torch.as_tensor(pts)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(vd).max()


def test_two_level_solve_matches_jax(pendulum, monkeypatch):
    """One two-level cycle (patch, composite polish of two steps, patch) from
    a rank-8 TT of the dense solve, the JAX cross state handed to the port."""
    jp, tp, jg, tg, uc, vd = pendulum
    v = jtt._repad(jtt.tt_from_dense(jnp.asarray(vd), rmax=8, tol=1e-4), 12)
    key = jax.random.key(0)
    state = j_init_cross_state(jax.random.split(jax.random.fold_in(key, 0))[1], jg.shape, 8)
    monkeypatch.setattr(tpol, "init_cross_state", lambda gen, shape, r0: copy.deepcopy(state))
    kw = dict(rmax=12, cycles=1, cycle_schedule=((2, 12),), margin=8, patch_tol=1e-5,
              chunk=4096, n_check=512)
    jres = jlp.two_level_solve(jp, jg, uc, v, key=key, **kw)
    tres = tlp.two_level_solve(tp, tg, uc, to_port(v), **kw)
    vmax = np.abs(vd).max()
    _same_patch(jres.patch, tres.patch, 10 * vmax)
    want = np.asarray(jtt.tt_full(jres.v))
    assert np.abs(ttt.tt_full(tres.v).numpy() - want).max() <= 1e-4 * vmax
    assert tres.history[0]["polish_best"] == jres.history[0]["polish_best"]
