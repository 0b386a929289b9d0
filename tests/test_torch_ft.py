"""The port's polynomial-core function trains (c3sc_tpu_torch.ops.ft)
against the JAX package's (c3sc_tpu.ops.ft) on the CPU, from the same nodal
TTs handed to both as numpy: tests/test_ft.py's smooth rank-2 function
sin(x) sin(y) + 0.3 x^2 y^2 on its (17, 15) grid, and a function on a grid
with a periodic dimension (cos(theta) (1 + 0.1 w^2) + sin(theta) w / 4).

Bars, each stated at its test: coefficient cores within 1e-5 x their
largest entry; evaluations within 1e-5 x the largest value and gradients
within 1e-4 x the largest gradient at seeded points (periodic dimension
included, with points past the period); integrals within 1e-5 x (box
volume x largest value); tests/test_ft.py's bars on the port; a file written
by either package's ft_save loads in the other with bit-equal arrays, and
the port's own file evaluates bit for bit as the object it saved.
"""

from torch_port_testing import to_numpy  # first: pins torch's threads

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3sc_tpu.grids import Grid as JGrid
from c3sc_tpu.ops import ft as jft
from c3sc_tpu.ops import tt as jtt
from c3sc_tpu_torch.convert import tt_from_numpy
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.ops import ft as tft
from c3sc_tpu_torch.ops import tt as ttt

CPU = "cpu"
R = 4


def _cores(f0, f1, g0, g1):
    """Rank-2 TT f0(x) g0(y) + f1(x) g1(y), padded to R, as numpy."""
    c0 = np.zeros((R, len(f0), R), np.float32)
    c0[0, :, 0], c0[0, :, 1] = f0, f1
    c1 = np.zeros((R, len(g0), R), np.float32)
    c1[0, :, 0], c1[1, :, 0] = g0, g1
    return [c0, c1], np.asarray([1, 2, 1], np.int32)


CASES = {
    "smooth": dict(lb=(-2.0, -1.5), ub=(2.0, 1.5), shape=(17, 15), periodic=(False, False),
                   f=lambda x, y: (np.sin(x), 0.3 * x**2, np.sin(y), y**2)),
    "periodic": dict(lb=(-np.pi, -2.0), ub=(np.pi, 2.0), shape=(24, 13), periodic=(True, False),
                     f=lambda x, y: (np.cos(x), np.sin(x), 1.0 + 0.1 * y**2, y / 4)),
}


def _case(name):
    c = CASES[name]
    jg = JGrid.create(c["lb"], c["ub"], c["shape"], c["periodic"])
    tg = Grid.create(c["lb"], c["ub"], c["shape"], c["periodic"])
    cores, rk = _cores(*c["f"](tg.nodes(0), tg.nodes(1)))
    jv = jtt.TT(tuple(jnp.asarray(x) for x in cores), jnp.asarray(rk))
    return jg, tg, jv, tt_from_numpy(cores, rk, CPU)


def _points(tg, n=128, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(tg.lb), np.asarray(tg.ub)
    span = np.where(tg.periodic, 1.5 * (hi - lo), hi - lo)   # past the period too
    return (lo + rng.uniform(0, 1, (n, 2)) * span).astype(np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_ft_matches_jax(name):
    jg, tg, jv, tv = _case(name)
    jf, tf = jft.ft_from_tt(jv, jg), tft.ft_from_tt(tv, tg)
    assert tf.lb == jf.lb and tf.ub == jf.ub and tf.periodic == jf.periodic
    for a, b in zip(tf.coeff, jf.coeff):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
    pts = _points(tg)
    want = np.asarray(jft.ft_eval(jf, jnp.asarray(pts)))
    assert np.abs(tft.ft_eval(tf, torch.as_tensor(pts)).numpy() - want).max() \
        <= 1e-5 * np.abs(want).max()
    gwant = np.asarray(jft.ft_grad_eval(jf, jnp.asarray(pts[:32])))
    with torch.no_grad():   # the policy calls it inside no_grad
        got = tft.ft_grad_eval(tf, torch.as_tensor(pts[:32])).numpy()
    assert np.abs(got - gwant).max() <= 1e-4 * np.abs(gwant).max()
    vol = np.prod(np.asarray(tg.ub) - np.asarray(tg.lb))
    assert abs(float(tft.ft_integrate(tf)) - float(jft.ft_integrate(jf))) \
        <= 1e-5 * vol * np.abs(want).max()


@pytest.mark.parametrize("name", list(CASES))
def test_ft_eval_copies_no_host_values(name, monkeypatch):
    """ft_eval and ft_grad_eval run in the implicit policy at every rollout
    step: on a batch already on the device they make no tensor from host
    values (a blocking copy on the card), periodic dimensions included."""
    _, tg, _, tv = _case(name)
    ft = tft.ft_from_tt(tv, tg)
    pts = torch.as_tensor(_points(tg))
    from_host = []
    for fn_name in ("as_tensor", "tensor"):
        real = getattr(torch, fn_name)

        def counting(data, *args, _real=real, _name=fn_name, **kwargs):
            if not isinstance(data, torch.Tensor):
                from_host.append(_name)
            return _real(data, *args, **kwargs)

        monkeypatch.setattr(torch, fn_name, counting)
    tft.ft_eval(ft, pts)
    with torch.no_grad():
        tft.ft_grad_eval(ft, pts[:8])
    assert from_host == []


def test_ft_bars():
    """tests/test_ft.py's bars on the port: interpolation at the nodes
    (5e-4), off-grid error below 0.3 x lerp's and below 5e-3, the exact
    integral (2e-3), the gradient (2e-2)."""
    _, tg, _, tv = _case("smooth")
    ft = tft.ft_from_tt(tv, tg)
    idx = tg.node_indices(CPU)
    np.testing.assert_allclose(tft.ft_eval(ft, tg.index_to_state(idx)).numpy(),
                               ttt.tt_gather_eval(tv, idx).numpy(), rtol=0, atol=5e-4)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-1.9, 1.9, 512), rng.uniform(-1.4, 1.4, 512)], -1).astype(
        np.float32)
    truth = np.sin(pts[:, 0]) * np.sin(pts[:, 1]) + 0.3 * pts[:, 0] ** 2 * pts[:, 1] ** 2
    err_ft = np.abs(tft.ft_eval(ft, torch.as_tensor(pts)).numpy() - truth).max()
    err_lerp = np.abs(ttt.tt_lerp_eval(tv, tg, torch.as_tensor(pts)).numpy() - truth).max()
    assert err_ft < 0.3 * err_lerp and err_ft < 5e-3, (err_ft, err_lerp)
    exact = 0.3 * (2 * 2.0 ** 3 / 3) * (2 * 1.5 ** 3 / 3)
    assert abs(float(tft.ft_integrate(ft)) - exact) / exact < 2e-3
    p = np.asarray([[0.37, 0.21], [-1.1, 0.8]], np.float32)
    g = tft.ft_grad_eval(ft, torch.as_tensor(p)).numpy()
    x, y = p[:, 0], p[:, 1]
    want = np.stack([np.cos(x) * np.sin(y) + 0.6 * x * y ** 2,
                     np.sin(x) * np.cos(y) + 0.6 * x ** 2 * y], -1)
    np.testing.assert_allclose(g, want, atol=2e-2)


def test_ft_files_move_between_packages(tmp_path):
    jg, tg, jv, tv = _case("periodic")
    jf, tf = jft.ft_from_tt(jv, jg), tft.ft_from_tt(tv, tg)
    tft.ft_save(str(tmp_path / "port_ft"), tf)
    jft.ft_save(str(tmp_path / "jax_ft"), jf)
    pts = _points(tg, seed=1)
    from_port = jft.ft_load(str(tmp_path / "port_ft"))
    from_jax = tft.ft_load(str(tmp_path / "jax_ft"), device=CPU)
    assert from_jax.lb == jf.lb and from_jax.periodic == jf.periodic
    assert from_port.ub == tf.ub and from_port.periodic == tf.periodic
    for a, b in zip(from_port.coeff, tf.coeff):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(from_jax.coeff, jf.coeff):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = tft.ft_load(str(tmp_path / "port_ft.npz"), device=CPU)
    np.testing.assert_array_equal(tft.ft_eval(back, torch.as_tensor(pts)).numpy(),
                                  tft.ft_eval(tf, torch.as_tensor(pts)).numpy())
    np.savez(str(tmp_path / "not_ft.npz"), meta=np.frombuffer(b'{"kind": "other"}', np.uint8))
    with pytest.raises(ValueError):
        tft.ft_load(str(tmp_path / "not_ft.npz"), device=CPU)
    assert to_numpy(from_jax.ranks).tolist() == [1, 2, 1]
