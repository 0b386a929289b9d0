"""The port's TT arithmetic (c3sc_tpu_torch.ops.tt: tt_dot, tt_norm,
tt_mult with its overflow rules, tt_integrate) against the JAX package's on
the CPU, on seeded TTs handed to both as numpy.

Bars, each stated at its test: rtol 1e-5 against JAX (float32 contractions
of the same cores in two orders; atol 1e-6 x the largest entry), equal
ranks; tests/test_tt_arith.py's bars on the port, including ``on_overflow``
"round" and "raise".
"""

from torch_port_testing import random_tt_numpy, to_numpy  # first: pins torch's threads

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3sc_tpu.grids import Grid as JGrid
from c3sc_tpu.ops import tt as jtt
from c3sc_tpu_torch.convert import tt_from_numpy
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.ops import tt as ttt

CPU = "cpu"


def _pair(shape, ranks, rmax, seed):
    cores, rk = random_tt_numpy(shape, ranks, rmax, seed)
    return (jtt.TT(tuple(jnp.asarray(c) for c in cores), jnp.asarray(rk)),
            tt_from_numpy(cores, rk, CPU))


def _close(got, want):
    want = to_numpy(want)
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30))


def test_dot_and_norm_match_jax():
    ja, ta = _pair((6, 5, 7), (2, 3), 12, 0)
    jb, tb = _pair((6, 5, 7), (3, 2), 12, 1)
    _close(ttt.tt_dot(ta, tb), jtt.tt_dot(ja, jb))
    _close(ttt.tt_norm(ta), jtt.tt_norm(ja))
    dense = to_numpy(ttt.tt_full(ta))
    assert float(ttt.tt_norm(ta)) == pytest.approx(np.sqrt((dense.astype(np.float64) ** 2).sum()),
                                                   rel=1e-5)


def test_mult_matches_jax_and_dense():
    ja, ta = _pair((6, 5, 7), (2, 3), 12, 0)
    jb, tb = _pair((6, 5, 7), (3, 2), 12, 1)
    prod, jprod = ttt.tt_mult(ta, tb), jtt.tt_mult(ja, jb)
    assert prod.ranks.tolist() == np.asarray(jprod.ranks).tolist() == [1, 6, 6, 1]
    for a, b in zip(prod.cores, jprod.cores):
        _close(a, b)
    dense = to_numpy(ttt.tt_full(ta)) * to_numpy(ttt.tt_full(tb))
    np.testing.assert_allclose(to_numpy(ttt.tt_full(prod)), dense, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_numpy(ttt.tt_full(ttt.tt_round(prod, 1e-5))), dense,
                               rtol=1e-3, atol=1e-4)


def test_mult_overflow_round_and_raise():
    """ranks 3 x 3 = 9 > R = 6: "raise" raises, "round" forms the product
    wide and rounds it to the cap (JAX's result within rtol 1e-5 of the
    largest entry: the same rounding of the same wide product); a rank-1
    factor overflows nothing and stays exact."""
    ja, ta = _pair((5, 6, 5), (3, 3), 6, 0)
    jb, tb = _pair((5, 6, 5), (3, 3), 6, 1)
    with pytest.raises(ValueError, match="rank overflow"):
        ttt.tt_mult(ta, tb, on_overflow="raise")
    with pytest.raises(ValueError, match="on_overflow"):
        ttt.tt_mult(ta, tb, on_overflow="clamp")
    out, jout = ttt.tt_mult(ta, tb), jtt.tt_mult(ja, jb)
    assert out.rmax == 6 and int(out.ranks.max()) <= 6
    assert out.ranks.tolist() == np.asarray(jout.ranks).tolist()
    _close(ttt.tt_full(out), jtt.tt_full(jout))
    ones = ttt.tt_constant((5, 6, 5), 3.0, rmax=6, device=CPU)
    np.testing.assert_allclose(to_numpy(ttt.tt_full(ttt.tt_mult(ta, ones))),
                               3 * to_numpy(ttt.tt_full(ta)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["uniform", "periodic", "nonuniform", "weights", "none"])
def test_integrate_matches_jax(kind):
    ja, ta = _pair((9, 8), (3,), 4, 2)
    args = {"uniform": ((0.0, 0.0), (1.0, 2.0), (False, False), None),
            "periodic": ((0.0, 0.0), (2 * np.pi, 1.0), (True, False), None),
            "nonuniform": ((0.0, -1.0), (1.0, 1.0), (False, False),
                           [np.linspace(0, 1, 9) ** 2, np.linspace(-1, 1, 8) ** 3])}.get(kind)
    if args is not None:
        lb, ub, per, nodes = args
        jg = JGrid.create(lb, ub, (9, 8), per, nodes=nodes)
        tg = Grid.create(lb, ub, (9, 8), per, nodes=nodes)
        _close(ttt.tt_integrate(ta, tg), jtt.tt_integrate(ja, jg))
    elif kind == "weights":
        w = [np.linspace(0.1, 1.0, 9), np.linspace(1.0, 2.0, 8)]
        _close(ttt.tt_integrate(ta, weights=w), jtt.tt_integrate(ja, weights=w))
    else:
        _close(ttt.tt_integrate(ta), jtt.tt_integrate(ja))


def test_integrate_bars():
    """tests/test_tt_arith.py's integrals on the port: x^2 y on [0,1]^2 (1/6
    within 1e-3) and sin^2 over the circle (pi within 1e-2)."""
    grid = Grid.create((0.0, 0.0), (1.0, 1.0), (101, 101), (False, False))
    x = torch.as_tensor(grid.nodes(0), dtype=torch.float32)
    y = torch.as_tensor(grid.nodes(1), dtype=torch.float32)
    assert abs(float(ttt.tt_integrate(ttt.tt_rank1([x**2, y], rmax=4), grid)) - 1 / 6) < 1e-3
    grid = Grid.create((0.0, 0.0), (2 * np.pi, 1.0), (64, 8), (True, False))
    th = torch.as_tensor(grid.nodes(0), dtype=torch.float32)
    tt = ttt.tt_rank1([torch.sin(th) ** 2, torch.ones(8)], rmax=4)
    assert abs(float(ttt.tt_integrate(tt, grid)) - np.pi) < 1e-2
