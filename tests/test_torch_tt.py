"""The port's TT algebra (c3sc_tpu_torch.ops.tt) against c3sc_tpu.ops.tt on
the CPU: the same padded cores, made with numpy from a seed, through both.

Tolerances: evaluations rtol 1e-5 plus atol 1e-5 x max|v| (float32 chains of
up to six small matmuls, ordered differently by the two libraries);
arithmetic and rounding are compared on the dense tensor (``tt_full``) at
1e-5 x max|v|.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import ART, close, port_grid, random_tt_numpy
from c3sc_tpu.grids import Grid as JGrid
from c3sc_tpu.models import make_problem as jmake_problem
from c3sc_tpu.ops import tt as jtt
from c3sc_tpu_torch.convert import tt_from_npz, tt_from_numpy
from c3sc_tpu_torch.ops import tt as ttt

SHAPES = {2: (9, 7), 4: (8, 7, 9, 6), 6: (5, 6, 4, 5, 7, 4)}


def _pair(shape, rmax, seed=0, ranks=None):
    """The same random TT as a JAX TT and a port TT."""
    d = len(shape)
    ranks = [min(rmax, 3 + k) for k in range(d - 1)] if ranks is None else ranks
    cores, rk = random_tt_numpy(shape, ranks, rmax, seed)
    return (jtt.TT(tuple(jnp.asarray(c) for c in cores), jnp.asarray(rk)),
            tt_from_numpy(cores, rk, "cpu"))


def _close_values(got, want):
    want = np.asarray(want)
    close(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rmax", [4, 8])
@pytest.mark.parametrize("d", [2, 4, 6])
def test_gather_and_lerp_eval_match_jax(d, rmax):
    shape = SHAPES[d]
    jt, tt = _pair(shape, rmax, seed=d)
    assert tt.ndim == d and tt.rmax == rmax and tt.shape == shape
    rng = np.random.default_rng(rmax)
    idx = np.stack([rng.integers(0, n, 512) for n in shape], -1)
    _close_values(ttt.tt_gather_eval(tt, torch.as_tensor(idx)),
                  jtt.tt_gather_eval(jt, jnp.asarray(idx, jnp.int32)))
    # lerp on a grid whose first dim wraps, at points also outside the box
    periodic = (True,) + (False,) * (d - 1)
    jg = JGrid.create((-1.0,) * d, (1.0,) * d, shape, periodic)
    x = rng.uniform(-1.2, 1.2, (512, d)).astype(np.float32)
    _close_values(ttt.tt_lerp_eval(tt, port_grid(jg), torch.as_tensor(x)),
                  jtt.tt_lerp_eval(jt, jg, jnp.asarray(x)))


@pytest.mark.parametrize("loader", [ttt.tt_load, tt_from_npz], ids=["tt_load", "tt_from_npz"])
def test_committed_quadcopter_solve_evaluates_as_in_jax(loader):
    """experiments/artifacts/quad_v16.npz (17^6, rank 16) at 512 random nodes
    and 512 random points."""
    path = os.path.join(ART, "quad_v16.npz")
    jt, tt = jtt.tt_load(path), loader(path, "cpu")
    assert tt.shape == (17,) * 6 and tt.ranks.dtype == torch.int32
    np.testing.assert_array_equal(tt.ranks.numpy(), np.asarray(jt.ranks))
    jp = jmake_problem("quadcopter", sigma_v=0.15, sigma_om=0.15)
    jg = jp.default_grid(17)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 17, (512, 6))
    _close_values(ttt.tt_gather_eval(tt, torch.as_tensor(idx)),
                  jtt.tt_gather_eval(jt, jnp.asarray(idx, jnp.int32)))
    x = rng.uniform(jp.lb, jp.ub, (512, 6)).astype(np.float32)
    _close_values(ttt.tt_lerp_eval(tt, port_grid(jg), torch.as_tensor(x)),
                  jtt.tt_lerp_eval(jt, jg, jnp.asarray(x)))


@pytest.mark.parametrize("name", ["quad_v16", "quad_v32", "northstar_seed0_v",
                                  "northstar_seed1_v", "northstar_seed2_v"])
def test_committed_jax_solves_load_unchanged(name):
    path = os.path.join(ART, name + ".npz")
    jt, tt = jtt.tt_load(path), tt_from_npz(path, "cpu")
    np.testing.assert_array_equal(tt.ranks.numpy(), np.asarray(jt.ranks))
    for c, jc in zip(tt.cores, jt.cores):
        assert c.dtype == torch.float32
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_full_and_from_dense_round_trip():
    jt, tt = _pair(SHAPES[4], 8)
    full = ttt.tt_full(tt)
    assert full.shape == SHAPES[4]
    _close_values(full, jtt.tt_full(jt))
    # TT-SVD of the dense tensor reproduces it, with JAX's ranks
    back = ttt.tt_from_dense(full, 8)
    jback = jtt.tt_from_dense(jnp.asarray(full.numpy()), 8)
    np.testing.assert_array_equal(back.ranks.numpy(), np.asarray(jback.ranks))
    _close_values(ttt.tt_full(back), full)
    assert back.cores[0].device.type == "cpu"


@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_add_matches_jax(case):
    ranks = [2, 3, 2] if case == "fits" else [6, 7, 6]
    ja, ta = _pair(SHAPES[4], 8, seed=1, ranks=ranks)
    jb, tb = _pair(SHAPES[4], 8, seed=2, ranks=ranks)
    got, want = ttt.tt_add(ta, tb), jtt.tt_add(ja, jb)
    if case == "fits":
        np.testing.assert_array_equal(got.ranks.numpy(), np.asarray(want.ranks))
        _close_values(ttt.tt_full(got), ttt.tt_full(ta) + ttt.tt_full(tb))
    else:
        # the 2R sum rounded back to R is a best approximation, not exact:
        # both packages are held to the same distance from the true sum
        exact = (ttt.tt_full(ta) + ttt.tt_full(tb)).numpy()
        err = np.linalg.norm(ttt.tt_full(got).numpy() - exact)
        jerr = np.linalg.norm(np.asarray(jtt.tt_full(want)) - exact)
        assert err <= 1.01 * jerr + 1e-5 * np.linalg.norm(exact)
        with pytest.raises(ValueError):
            ttt.tt_add(ta, tb, on_overflow="raise")
    assert int(got.ranks.max()) <= 8
    _close_values(ttt.tt_full(ttt.tt_scale(ta, 2.5)), 2.5 * ttt.tt_full(ta))


def test_round_matches_jax():
    # a rank-3 tensor stored at rank 6: its sum with itself, exactly
    ja, ta = _pair(SHAPES[4], 8, seed=3, ranks=[3, 3, 3])
    jw, tw = jtt._tt_add_raw(ja, ja, 8), ttt._tt_add_raw(ta, ta, 8)
    np.testing.assert_array_equal(tw.ranks.numpy(), [1, 6, 6, 6, 1])
    got, want = ttt.tt_round(tw, 1e-5), jtt.tt_round(jw, 1e-5)
    np.testing.assert_array_equal(got.ranks.numpy(), np.asarray(want.ranks))
    np.testing.assert_array_equal(got.ranks.numpy(), [1, 3, 3, 3, 1])
    _close_values(ttt.tt_full(got), jtt.tt_full(want))
    _close_values(ttt.tt_full(got), 2 * ttt.tt_full(ta))
    # the padded-zero invariant holds after rounding
    masked = ttt.mask_cores(got)
    for c, m in zip(got.cores, masked.cores):
        assert torch.equal(c, m)
    capped = ttt.tt_round(tw, 1e-5, rmax_new=2)
    assert int(capped.ranks.max()) == 2


def test_constructors():
    shape = (4, 5, 3)
    z = ttt.tt_zeros(shape, 4, device="cpu")
    assert float(ttt.tt_full(z).abs().max()) == 0.0 and z.ranks.tolist() == [1, 1, 1, 1]
    c = ttt.tt_constant(shape, 2.5, 4, device="cpu")
    close(ttt.tt_full(c), np.full(shape, 2.5, np.float32), rtol=0, atol=0)
    f = [torch.arange(1.0, n + 1) for n in shape]
    want = f[0][:, None, None] * f[1][None, :, None] * f[2][None, None, :]
    close(ttt.tt_full(ttt.tt_rank1(f, 4)), want, rtol=1e-6, atol=0)
    gen = torch.Generator().manual_seed(0)
    r = ttt.tt_random(gen, shape, (2, 3), 4, device="cpu")
    assert r.ranks.tolist() == [1, 2, 3, 1]
    for a, b in zip(r.cores, ttt.mask_cores(r).cores):   # padded region is zero
        assert torch.equal(a, b)
    again = ttt.tt_random(torch.Generator().manual_seed(0), shape, (2, 3), 4, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(r.cores, again.cores))
    rp = ttt._repad(r, 6)
    assert rp.rmax == 6
    close(ttt.tt_full(rp), ttt.tt_full(r), rtol=1e-5, atol=1e-7)   # wider matmuls reorder sums
    assert all(torch.equal(a, b) for a, b in zip(ttt._repad(rp, 4).cores, r.cores))


def test_save_and_load_cross_the_packages(tmp_path):
    jt, tt = _pair(SHAPES[4], 8, seed=5)
    ttt.tt_save(tt, str(tmp_path / "port.npz"))
    back = jtt.tt_load(str(tmp_path / "port.npz"))      # port -> JAX
    assert np.asarray(back.ranks).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(back.ranks), np.asarray(jt.ranks))
    for c, jc in zip(back.cores, jt.cores):
        np.testing.assert_array_equal(np.asarray(c), np.asarray(jc))
    jtt.tt_save(jt, str(tmp_path / "jax.npz"))
    got = ttt.tt_load(str(tmp_path / "jax.npz"), "cpu")  # JAX -> port
    assert torch.equal(got.ranks, tt.ranks)
    assert all(torch.equal(a, b) for a, b in zip(got.cores, tt.cores))
    with np.load(tmp_path / "port.npz") as z:
        assert sorted(z.files) == sorted([f"core_{k}" for k in range(4)] + ["ranks"])


def test_tt_entry_points_default_to_the_card():
    """``device=None`` means the CUDA device; without one torch raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal shows only without one")
    with pytest.raises((RuntimeError, AssertionError)):
        ttt.tt_zeros((3, 3), 2)
    with pytest.raises((RuntimeError, AssertionError)):
        tt_from_npz(os.path.join(ART, "quad_v16.npz"))
