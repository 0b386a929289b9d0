"""The port's quadrature rules and univariate function classes
(c3sc_tpu_torch.ops.quadrature, .ops.funcs) against the JAX package's, on
the CPU, with the same callables written once in each framework.

Bars, each stated at its test: quadrature nodes and weights equal to 1e-12
(the same numpy code); fitted coefficients and values within 1e-5 relative
to the largest (float32 fits of the same data). Two exceptions, by their
conditioning: the kernel expansion's ridge system has condition number
1.7e5 with 9 centres and 1.8e10 with the JAX test's 25, so two float32
LAPACK solves agree on its coefficients only to about cond x 6e-8, and that
class is held by its values (1e-4 at 9 centres, the JAX test's own 1e-3 at
its 25); the piecewise polynomials' per-cell
least squares amplify an ulp of the callable's value, so their coefficients
are held on a polynomial callable whose float32 values the two frameworks
compute alike. Then the JAX tests' own bars (tests/test_funcs.py) on the
port, and a file written by either package's gf_save loads in the other
with equal arrays.
"""

from torch_port_testing import to_numpy  # first: pins torch's threads

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3sc_tpu.ops import funcs as jf
from c3sc_tpu.ops import quadrature as jq
from c3sc_tpu_torch.ops import funcs as tf
from c3sc_tpu_torch.ops import quadrature as tq

CPU = "cpu"


def _rel(got, want, tol):
    got, want = to_numpy(got), to_numpy(want)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("rule,args", [("gauss_legendre", (7, -0.5, 2.0)),
                                       ("gauss_hermite", (9,)), ("gauss_hermite_prob", (8,)),
                                       ("clenshaw_curtis", (33, 0.0, np.pi)),
                                       ("trapezoid", (np.array([0.0, 0.3, 1.0, 2.5]),))])
def test_quadrature_rules_match_jax(rule, args):
    for got, want in zip(getattr(tq, rule)(*args), getattr(jq, rule)(*args)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_quadrature_bars():
    """tests/test_funcs.py:21-45 on the port's rules."""
    x, w = tq.gauss_legendre(5, 0.0, 2.0)
    for p in range(10):
        assert np.sum(w * x**p) == pytest.approx(2.0 ** (p + 1) / (p + 1), rel=1e-10)
    x, w = tq.gauss_hermite_prob(8)
    assert np.sum(w) == pytest.approx(1.0) and np.sum(w * x**2) == pytest.approx(1.0)
    assert np.sum(w * x**4) == pytest.approx(3.0)
    x, w = tq.clenshaw_curtis(33, 0.0, np.pi)
    assert np.sum(w * np.sin(x)) == pytest.approx(2.0, abs=1e-10)
    nodes = np.array([0.0, 0.3, 1.0, 2.5])
    assert np.sum(tq.trapezoid(nodes)[1] * nodes**2) == pytest.approx(np.trapezoid(nodes**2,
                                                                                    nodes))
    with pytest.raises(ValueError):
        tq.clenshaw_curtis(1)


def test_poly_matches_jax_and_bars():
    """Coefficients, values, integral, inner product and derivative of the
    orthonormal Legendre expansion against JAX's (1e-5 relative); the JAX
    test's accuracy bars on the port."""
    jp = jf.poly_fit(lambda x: jnp.sin(2 * x) + 0.3 * x**2, n=16, a=-1.5, b=2.0)
    tp = tf.poly_fit(lambda x: torch.sin(2 * x) + 0.3 * x**2, n=16, a=-1.5, b=2.0, device=CPU)
    _rel(tp.coeff, jp.coeff, 1e-5)
    xs = np.linspace(-1.5, 2.0, 101).astype(np.float32)
    _rel(tf.poly_eval(tp, torch.as_tensor(xs)), jf.poly_eval(jp, jnp.asarray(xs)), 1e-5)
    np.testing.assert_allclose(to_numpy(tf.poly_eval(tp, torch.as_tensor(xs))),
                               np.sin(2 * xs) + 0.3 * xs**2, atol=2e-5)
    p = tf.poly_fit(lambda x: x**2, n=6, a=0.0, b=2.0, device=CPU)
    q = tf.poly_fit(lambda x: x, n=6, a=0.0, b=2.0, device=CPU)
    assert float(tf.poly_integrate(p)) == pytest.approx(8.0 / 3.0, rel=1e-5)
    assert float(tf.poly_inner(p, q)) == pytest.approx(4.0, rel=1e-4)
    js = jf.poly_fit(jnp.sin, n=20, a=-2.0, b=2.0)
    ts = tf.poly_fit(torch.sin, n=20, a=-2.0, b=2.0, device=CPU)
    _rel(tf.poly_deriv(ts).coeff, jf.poly_deriv(js).coeff, 1e-5)
    xd = np.linspace(-1.9, 1.9, 41).astype(np.float32)
    np.testing.assert_allclose(to_numpy(tf.poly_eval(tf.poly_deriv(ts), torch.as_tensor(xd))),
                               np.cos(xd), atol=1e-4)


def test_linelm_constelm_match_jax_and_bars():
    nodes = np.linspace(0.0, 1.0, 51)
    ja, jb = jf.linelm_fit(lambda x: 2 * x, jnp.asarray(nodes)), jf.linelm_fit(
        lambda x: 3 * x, jnp.asarray(nodes))
    a, b = (tf.linelm_fit(lambda x: 2 * x, nodes, CPU), tf.linelm_fit(lambda x: 3 * x, nodes,
                                                                       CPU))
    xs = np.random.default_rng(0).uniform(-0.2, 1.2, 64).astype(np.float32)
    _rel(tf.linelm_eval(a, torch.as_tensor(xs)), jf.linelm_eval(ja, jnp.asarray(xs)), 1e-6)
    assert float(tf.linelm_eval(a, 0.25)) == pytest.approx(0.5)
    assert float(tf.linelm_integrate(a)) == pytest.approx(1.0)
    assert float(tf.linelm_inner(a, b)) == pytest.approx(float(jf.linelm_inner(ja, jb)),
                                                         rel=1e-5)
    assert float(tf.linelm_inner(a, b)) == pytest.approx(2.0, rel=1e-6)
    ce, jce = tf.linelm_deriv(a), jf.linelm_deriv(ja)
    _rel(ce.vals, jce.vals, 1e-5)
    np.testing.assert_allclose(to_numpy(ce.vals), 2.0, atol=1e-5)
    assert float(tf.constelm_integrate(ce)) == pytest.approx(2.0, rel=1e-5)
    _rel(tf.constelm_eval(ce, torch.as_tensor(xs)), jf.constelm_eval(jce, jnp.asarray(xs)), 1e-5)


def test_pwpoly_matches_jax_and_bars():
    edges = np.linspace(-1.0, 1.0, 9)
    xs = np.linspace(-0.99, 0.99, 53).astype(np.float32)

    def quartic(x):
        return 1.0 + x * (1.0 + x * (0.5 + x * (1.0 / 6.0 + x / 24.0)))

    jq4 = jf.pwpoly_fit(quartic, edges, order=3)
    tq4 = tf.pwpoly_fit(quartic, edges, order=3, device=CPU)
    _rel(tq4.coeff, jq4.coeff, 1e-5)
    _rel(tf.pwpoly_eval(tq4, torch.as_tensor(xs)), jf.pwpoly_eval(jq4, jnp.asarray(xs)), 1e-5)
    jw = jf.pwpoly_fit(jnp.exp, edges, order=3)
    tw = tf.pwpoly_fit(torch.exp, edges, order=3, device=CPU)
    got = tf.pwpoly_eval(tw, torch.as_tensor(xs))
    _rel(got, jf.pwpoly_eval(jw, jnp.asarray(xs)), 1e-5)
    np.testing.assert_allclose(to_numpy(got), np.exp(xs), rtol=1e-4)
    assert float(tf.pwpoly_integrate(tw)) == pytest.approx(np.e - 1 / np.e, rel=1e-4)
    np.testing.assert_allclose(to_numpy(tf.pwpoly_eval(tf.pwpoly_deriv(tw), torch.as_tensor(xs))),
                               np.exp(xs), rtol=2e-3)


def test_kernel_matches_jax_and_bars():
    jk = jf.kernel_fit(jnp.sin, jnp.linspace(-1, 1, 9), width=0.5)
    tk = tf.kernel_fit(torch.sin, np.linspace(-1, 1, 9), width=0.5, device=CPU)
    xk = np.linspace(-1.0, 1.0, 41).astype(np.float32)
    _rel(tf.kernel_eval(tk, torch.as_tensor(xk)), jf.kernel_eval(jk, jnp.asarray(xk)), 1e-4)
    ke = tf.kernel_fit(torch.cos, np.linspace(-2.0, 2.0, 25), width=0.4, device=CPU)
    jke = jf.kernel_fit(jnp.cos, jnp.linspace(-2.0, 2.0, 25), width=0.4)
    xs = np.linspace(-1.8, 1.8, 37).astype(np.float32)
    got = tf.kernel_eval(ke, torch.as_tensor(xs))
    _rel(got, jf.kernel_eval(jke, jnp.asarray(xs)), 1e-3)
    np.testing.assert_allclose(to_numpy(got), np.cos(xs), atol=1e-3)
    assert float(tf.kernel_integrate(ke, -1.5, 1.5)) == pytest.approx(2 * np.sin(1.5), abs=5e-3)


def _objects():
    """The same five functions fitted by each package: (kind, JAX, port)."""
    nodes = np.linspace(-1.0, 1.0, 11)
    jl, tl = jf.linelm_fit(jnp.cos, jnp.asarray(nodes)), tf.linelm_fit(torch.cos, nodes, CPU)
    return [
        ("poly", jf.poly_fit(lambda x: x**3, n=8, a=-1.0, b=1.0),
         tf.poly_fit(lambda x: x**3, n=8, a=-1.0, b=1.0, device=CPU)),
        ("kernel", jf.kernel_fit(jnp.sin, jnp.linspace(-1, 1, 9), width=0.5),
         tf.kernel_fit(torch.sin, np.linspace(-1, 1, 9), width=0.5, device=CPU)),
        ("linelm", jl, tl),
        ("constelm", jf.linelm_deriv(jl), tf.linelm_deriv(tl)),
        ("pwpoly", jf.pwpoly_fit(jnp.exp, np.linspace(-1, 1, 5), order=2),
         tf.pwpoly_fit(torch.exp, np.linspace(-1, 1, 5), order=2, device=CPU)),
    ]


def test_generic_functions_files_move_between_packages(tmp_path):
    """gf_save of either package, gf_load of the other: the same kind,
    scalars and arrays, and evaluations equal to float32 rounding (1e-6);
    gf_integrate dispatches as JAX's."""
    xs = np.linspace(-0.95, 0.95, 13).astype(np.float32)
    for kind, jo, to in _objects():
        jg, tg = jf.GenericFunction(kind, jo), tf.GenericFunction(kind, to)
        tf.gf_save(str(tmp_path / f"t_{kind}.npz"), tg)
        jf.gf_save(str(tmp_path / f"j_{kind}.npz"), jg)
        from_port = jf.gf_load(str(tmp_path / f"t_{kind}.npz"))
        from_jax = tf.gf_load(str(tmp_path / f"j_{kind}.npz"), device=CPU)
        assert from_port.kind == from_jax.kind == kind
        for a, b in zip(from_port.obj, to):
            np.testing.assert_array_equal(to_numpy(a), to_numpy(b))
        for a, b in zip(from_jax.obj, jo):
            np.testing.assert_array_equal(to_numpy(a), to_numpy(b))
        np.testing.assert_allclose(to_numpy(tf.gf_eval(from_jax, torch.as_tensor(xs))),
                                   to_numpy(jf.gf_eval(jg, jnp.asarray(xs))), atol=1e-6, rtol=1e-5)
        ab = (-1.0, 1.0) if kind == "kernel" else (None, None)
        assert float(tf.gf_integrate(tg, *ab)) == pytest.approx(float(jf.gf_integrate(jg, *ab)),
                                                                rel=1e-5, abs=1e-6)
    with pytest.raises(ValueError):
        tf.gf_integrate(tf.GenericFunction("kernel", _objects()[1][2]))
