"""The port's host-loop TT cross (c3sc_tpu_torch.ops.cross.tt_cross) and
two-site DMRG cross (c3sc_tpu_torch.solvers.dmrg) against c3sc_tpu's on the
CPU, every call with device="cpu".

Bars:
  - from the same ``CrossState`` (``convert.cross_state_from_numpy``) and the
    same noise seed, the fitted TT's values against JAX's to float32
    rounding: rtol 1e-5, atol 1e-5 x max|f| (values, not cores: pivots and
    SVD signs are free), the same sweep count;
  - ``_select_and_core`` on the same fiber matrix and noise: the same pivot
    rows, the core within rtol 1e-5, atol 1e-5 x max|G|;
  - tests/test_cross.py's and tests/test_dmrg.py's bars on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import close
from c3sc_tpu.ops import cross as jc
from c3sc_tpu.ops.tt import tt_full as jtt_full
from c3sc_tpu.solvers import dmrg as jd
from c3sc_tpu_torch.convert import cross_state_from_numpy
from c3sc_tpu_torch.ops import cross as tc
from c3sc_tpu_torch.ops.tt import tt_full, tt_gather_eval
from c3sc_tpu_torch.solvers import dmrg_cross

SHAPE = (17, 13, 15)
GRIDS = [np.linspace(-1, 1, n).astype(np.float32) for n in SHAPE]


def _xyz(idx, lib):
    idx = np.asarray(idx) if lib is np else idx
    return [lib.asarray(GRIDS[k])[idx[:, k]] if lib is not torch
            else torch.as_tensor(GRIDS[k])[idx[:, k]] for k in range(3)]


def f_rank2(idx, lib=torch):
    """x + y z: TT rank 2."""
    x, y, z = _xyz(idx, lib)
    return x + y * z


def f_gauss(idx, lib=torch):
    x, y, z = _xyz(idx, lib)
    return lib.exp(-(x**2 + 2 * y**2 + 0.5 * z**2 + 0.3 * x * y))


def dense_of(f):
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in SHAPE], indexing="ij"), -1).reshape(-1, 3)
    return f(torch.as_tensor(idx)).numpy().reshape(SHAPE)


def key_seeds(key, n):
    """JAX's split keys as the integers its cross fits seed numpy with."""
    return [int(jax.random.randint(k, (), 0, 2**31 - 1)) for k in jax.random.split(key, n)]


@pytest.mark.parametrize("name,rmax,key", [("rank2", 8, 0), ("gauss", 12, 1)])
def test_cross_from_same_state_matches_jax(name, rmax, key):
    f = {"rank2": f_rank2, "gauss": f_gauss}[name]
    k0, k1 = jax.random.split(jax.random.key(key), 3)[1:]
    jstate = jc.init_cross_state(k0, SHAPE, 3)
    tstate = cross_state_from_numpy(jstate.left, jstate.right)
    want = jc.tt_cross(lambda i: f(i, jnp), SHAPE, rmax=rmax, key=jax.random.key(key),
                       state=jstate, tol=1e-4)
    got = tc.tt_cross(f, SHAPE, rmax=rmax, seed=key_seeds(jax.random.key(key), 3)[1:],
                      state=tstate, tol=1e-4, device="cpu")
    w = np.asarray(jtt_full(want.tt))
    close(tt_full(got.tt), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    assert got.sweeps == want.sweeps and got.n_evals == want.n_evals
    assert got.tt.ranks.tolist() == np.asarray(want.tt.ranks).tolist()
    np.testing.assert_allclose(got.errors, want.errors, rtol=1e-3, atol=1e-6)


def test_cross_int_seed_is_a_pair_from_default_rng():
    """An int seed draws (index-set seed, noise seed) from default_rng."""
    rng = np.random.default_rng(5)
    pair = [int(rng.integers(0, 2**31)) for _ in range(2)]
    a = tc.tt_cross(f_gauss, SHAPE, rmax=6, seed=5, max_sweeps=2, device="cpu")
    b = tc.tt_cross(f_gauss, SHAPE, rmax=6, seed=pair, max_sweeps=2, device="cpu")
    assert torch.equal(tt_full(a.tt), tt_full(b.tt))


@pytest.mark.parametrize("r_new", [3, 6])
def test_select_and_core_matches_jax(r_new):
    """r_new 3 takes the QR basis; 6 > the 4 columns adds kick directions.
    C has full column rank: beyond its rank QR's columns are the LAPACK
    build's free choice (ROADMAP §3, the kick columns)."""
    rng = np.random.default_rng(r_new)
    C = (rng.standard_normal((40, 4)) * np.logspace(0, -2, 4)).astype(np.float32)
    noise = rng.standard_normal((40, 2)).astype(np.float32)
    jrows, jG = jc._select_and_core(jnp.asarray(C), jnp.asarray(noise), r_new)
    trows, tG = tc._select_and_core(torch.as_tensor(C), torch.as_tensor(noise), r_new)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    jG = np.asarray(jG)
    close(tG, jG, rtol=1e-5, atol=1e-5 * np.abs(jG).max())
    close(tG[trows], np.eye(r_new), rtol=0, atol=1e-4)


def test_cross_exact_rank2():
    res = tc.tt_cross(f_rank2, SHAPE, rmax=8, seed=0, tol=1e-5, device="cpu")
    truth = dense_of(f_rank2)
    err = np.abs(tt_full(res.tt).numpy() - truth).max() / np.abs(truth).max()
    assert err < 1e-4, f"cross err {err:.2e}"
    assert res.converged
    assert res.n_evals < 20 * np.prod(SHAPE)


def test_cross_smooth_gaussian():
    res = tc.tt_cross(f_gauss, SHAPE, rmax=12, seed=1, tol=1e-4, device="cpu")
    truth = dense_of(f_gauss)
    err = np.abs(tt_full(res.tt).numpy() - truth).max() / np.abs(truth).max()
    assert err < 1e-3, f"cross err {err:.2e}"


def test_cross_warm_start_fewer_sweeps():
    res1 = tc.tt_cross(f_gauss, SHAPE, rmax=12, seed=2, tol=1e-4, device="cpu")
    res2 = tc.tt_cross(f_gauss, SHAPE, rmax=12, seed=3, tol=1e-4, state=res1.state,
                       device="cpu")
    assert res2.converged
    assert res2.sweeps <= res1.sweeps
    truth = dense_of(f_gauss)
    assert np.abs(tt_full(res2.tt).numpy() - truth).max() / np.abs(truth).max() < 1e-3


def test_cross_interpolation_property():
    res = tc.tt_cross(f_gauss, SHAPE, rmax=12, seed=4, tol=1e-4, device="cpu")
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(np.stack([rng.integers(0, n, 64) for n in SHAPE], -1))
    close(tt_gather_eval(res.tt, idx), f_gauss(idx), rtol=5e-3, atol=5e-4)


def _rank2_tensor(shape, lib):
    grids = [np.linspace(0, 1, n) for n in shape]

    def f(idx):
        if lib is torch:
            xs = torch.stack([torch.as_tensor(grids[k], dtype=torch.float32)[idx[:, k]]
                              for k in range(len(shape))], -1)
            return torch.prod(torch.sin(xs), -1) + torch.prod(torch.cos(xs), -1)
        xs = jnp.stack([jnp.asarray(grids[k], jnp.float32)[idx[:, k]]
                        for k in range(len(shape))], -1)
        return jnp.prod(jnp.sin(xs), -1) + jnp.prod(jnp.cos(xs), -1)

    return f


def _mixture(shape, lib):
    grids = [np.linspace(-1, 1, n) for n in shape]

    def f(idx):
        if lib is torch:
            xs = torch.stack([torch.as_tensor(grids[k], dtype=torch.float32)[idx[:, k]]
                              for k in range(3)], -1)
        else:
            xs = jnp.stack([jnp.asarray(grids[k], jnp.float32)[idx[:, k]] for k in range(3)], -1)
        out = 0.0
        for a in (0.5, 1.0, 1.5, 2.0):
            out = out + lib.prod(lib.exp(-a * xs**2), -1)
        return out

    return f


@pytest.mark.parametrize("case", ["rank2", "mixture"])
def test_dmrg_from_same_state_matches_jax(case):
    if case == "rank2":
        shape, make, kw = (11, 9, 13, 8), _rank2_tensor, dict(rmax=6, max_sweeps=4)
    else:
        shape, make, kw = (12, 12, 12), _mixture, dict(rmax=8, max_sweeps=5, r0=2)
    k0 = jax.random.split(jax.random.key(0))[1]
    jstate = jc.init_cross_state(k0, shape, kw.get("r0", 2))
    tstate = cross_state_from_numpy(jstate.left, jstate.right)
    want = jd.dmrg_cross(make(shape, jnp), shape, key=jax.random.key(0), state=jstate, **kw)
    got = dmrg_cross(make(shape, torch), shape, state=tstate, device="cpu", **kw)
    w = np.asarray(jtt_full(want.tt))
    close(tt_full(got.tt), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    assert got.sweeps == want.sweeps


def test_dmrg_recovers_rank2_exactly():
    shape = (11, 9, 13, 8)
    f = _rank2_tensor(shape, torch)
    res = dmrg_cross(f, shape, rmax=6, seed=[key_seeds(jax.random.key(0), 2)[1]],
                     max_sweeps=4, device="cpu")
    rng = np.random.default_rng(7)
    idx = torch.as_tensor(np.stack([rng.integers(0, n, 500) for n in shape], -1))
    want = f(idx)
    err = float((tt_gather_eval(res.tt, idx) - want).abs().max() / want.abs().max())
    assert err < 1e-4, f"relative error {err}"
    assert int(res.tt.ranks.max()) <= 3


def test_dmrg_adapts_rank_up():
    shape = (12, 12, 12)
    f = _mixture(shape, torch)
    res = dmrg_cross(f, shape, rmax=8, seed=1, max_sweeps=5, r0=2, device="cpu")
    rng = np.random.default_rng(3)
    idx = torch.as_tensor(np.stack([rng.integers(0, n, 400) for n in shape], -1))
    assert float((tt_gather_eval(res.tt, idx) - f(idx)).abs().max()) < 5e-4
    assert int(res.tt.ranks.max()) >= 3
    with pytest.raises(ValueError):
        dmrg_cross(f, (12,), rmax=4, device="cpu")
