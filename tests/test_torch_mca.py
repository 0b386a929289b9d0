"""Parity of the port's Kushner–Dupuis stencil (c3sc_tpu_torch.ops.mca) with
c3sc_tpu.ops.mca: the same numpy nodes and candidates through both, on the
quadcopter 5^6, the pendulum, and a non-uniform grid.

Tolerance: rtol 1e-5, atol 1e-6 — float32 rounding of the sums over dims,
which the two libraries order differently. The all-candidates stencil adds
the absolute term that the rounding of the drift contraction allows where
the drift nearly cancels; ``_drift_rounding_atol`` derives it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_testing import close, port_grid
from c3sc_tpu import models as jm
from c3sc_tpu.grids import Grid as JGrid
from c3sc_tpu.ops import mca as jmca
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.ops import mca as tmca

TOL = dict(rtol=1e-5, atol=1e-6)
UNSTRUCTURED = dict(drift_f0=None, drift_G=None, sigma2_x=None, cost_q=None, cost_r=None)


def _case(name):
    """(jax problem, port problem, jax grid, port grid, candidates)."""
    if name == "quad5":
        kw = dict(sigma_v=0.15, sigma_om=0.15)
        jp, tp = jm.make_problem("quadcopter", **kw), tm.make_problem("quadcopter", **kw)
        jg = jp.default_grid(5)
        uc = jp.control_candidates(5)
    elif name == "pendulum":
        jp, tp = jm.make_problem("pendulum"), tm.make_problem("pendulum")
        jg = jp.default_grid((21, 17))
        uc = jp.control_candidates(9)
    else:  # LQ on a non-uniform grid, denser near the origin
        jp, tp = jm.make_problem("lq"), tm.make_problem("lq")
        nodes = 2.0 * np.sign(np.linspace(-1, 1, 15)) * np.linspace(-1, 1, 15) ** 2
        jg = JGrid.create(jp.lb, jp.ub, (15, 15), nodes=[nodes, nodes])
        assert not jg.uniform
        uc = jp.control_candidates(7)
    tg = port_grid(jg)
    return jp, tp, jg, tg, np.asarray(uc, np.float32)


def _nodes(jg):
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in jg.shape], indexing="ij"), -1)
    idx = idx.reshape(-1, jg.ndim).astype(np.int32)
    x = np.array(jg.index_to_state(jnp.asarray(idx)), np.float32)
    return idx, x


def _close(got, want):
    close(got, want, **TOL)


def _drift_rounding_atol(tp, tg, x, uc, ref):
    """What float32 can promise for the all-candidates stencil, elementwise.

    The drift of candidate c is f = f0(x) + G(x) u_c. Its terms are as large
    as |f0| up to 9.81 and |G_m u_m| up to 17 x 6 on the quadcopter, and they
    can cancel. However the contraction is ordered, and with or without a
    fused multiply-add, each of its few float32 operations rounds a number no
    larger than F = |f0| + sum_m |G_m| |u_m|, so

        |delta f_i| <= gamma F_i,    gamma = 8 eps32

    (two products, two sums and the roundings of G, f0 and u themselves).
    The stencil is p+-_j = N_j / Q with N_j = s2_j / (2 h_j^2) + max(+-f_j, 0) / h_j,
    Q = sum_i (s2_i / h_i^2 + |f_i| / h_i) and dt = 1 / Q, so to first order

        |delta N_j| <= |delta f_j| / h_j,   |delta Q| <= D = sum_i |delta f_i| / h_i,
        |delta p_j| <= dt (gamma F_j / h_j + p_j D),      |delta dt| <= dt^2 D.

    The second term of delta p is common to all dims of a node: a relative
    error D dt that is not small where Q is (f nearly cancels and the
    diffusion is weak), which a pure rtol of 1e-5 does not allow for.
    Returned per element for (p_plus, p_minus, dt), from the float64 run
    ``ref`` of the port's own code, and never below the file's atol. On a
    non-uniform grid h_i is the smaller of the two local spacings.
    """
    gamma = 8.0 * np.finfo(np.float32).eps
    x64, u64 = torch.as_tensor(x).double(), torch.as_tensor(uc).double()
    F = tp.drift_f0(x64).abs()[None] + torch.einsum(
        "bdm,cm->cbd", tp.drift_G(x64).abs(), u64.abs())          # [C, B, d]
    hp, hm = tg.local_h(x64)
    Fh = gamma * F / torch.minimum(hp, hm)[None]                  # gamma F_i / h_i
    D = Fh.sum(-1)                                                # [C, B]
    pp, pm, dt = ref
    floor = TOL["atol"]
    return [(dt[..., None] * (Fh + p * D[..., None])).clamp(min=floor).numpy() for p in (pp, pm)
            ] + [(dt * dt * D).clamp(min=floor).numpy()]


def _within(got, want, atol):
    """|got - want| <= atol + rtol |want|, with an elementwise atol."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    over = np.abs(got - want) - (atol + TOL["rtol"] * np.abs(want))
    assert over.max() <= 0, (f"{int((over > 0).sum())} of {over.size} elements outside the "
                             f"bound, largest excess {over.max():.3e}")


@pytest.mark.parametrize("structured", [True, False], ids=["declared", "general"])
@pytest.mark.parametrize("name", ["quad5", "pendulum", "nonuniform"])
def test_transition_all_controls_and_stage_cost(name, structured):
    """Both the declared fast path and the general broadcast path (taken by
    problems without structure declarations, as the glider).

    Each package is held against a float64 run of the port's own code, and
    the two against each other, within rtol 1e-5 plus the absolute bound of
    ``_drift_rounding_atol`` (twice that between the two float32 results).
    """
    jp, tp_declared, jg, tg, uc = _case(name)
    tp = tp_declared
    if not structured:
        jp, tp = dataclasses.replace(jp, **UNSTRUCTURED), dataclasses.replace(tp, **UNSTRUCTURED)
    _, x = _nodes(jg)
    jx, tx, juc, tuc = jnp.asarray(x), torch.as_tensor(x), jnp.asarray(uc), torch.as_tensor(uc)
    ref = tmca.transition_all_controls(tp, tg, tx.double(), tuc.double())
    atols = _drift_rounding_atol(tp_declared, tg, x, uc, ref)
    for got, want, r, atol in zip(tmca.transition_all_controls(tp, tg, tx, tuc),
                                  jmca.transition_all_controls(jp, jg, jx, juc), ref, atols):
        assert got.shape == want.shape and got.dtype == torch.float32
        _within(got.numpy(), r.numpy(), atol)
        _within(np.asarray(want), r.numpy(), atol)
        _within(got.numpy(), np.asarray(want), 2 * atol)
    _close(tmca.stage_cost_all(tp, tx, tuc), jmca.stage_cost_all(jp, jx, juc))


@pytest.mark.parametrize("name", ["quad5", "pendulum", "nonuniform"])
def test_transition_per_node_controls(name):
    jp, tp, jg, tg, uc = _case(name)
    _, x = _nodes(jg)
    u = uc[np.random.default_rng(0).integers(0, len(uc), len(x))]
    got = tmca.transition(tp, tg, torch.as_tensor(x), torch.as_tensor(u))
    want = jmca.transition_batch(jp, jg, jnp.asarray(x), jnp.asarray(u))
    for g, w in zip(got, want):
        _close(g, w)
    # probabilities are a distribution over the 2d neighbours
    np.testing.assert_allclose((got[0] + got[1]).sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("name", ["quad5", "pendulum", "nonuniform"])
def test_node_terminal(name):
    jp, tp, jg, tg, _ = _case(name)
    idx, x = _nodes(jg)
    tmask, tval = tmca.node_terminal(tp, tg, torch.as_tensor(idx).long(), torch.as_tensor(x))
    jmask, jval = jmca.node_terminal(jp, jg, jnp.asarray(idx), jnp.asarray(x))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    _close(tval, jval)


def test_stencil_gradient_wrt_u():
    """d(dt)/du through torch.autograd agrees with jax.grad."""
    jp, tp, jg, tg, uc = _case("quad5")
    _, x = _nodes(jg)
    x0, u0 = x[1234], uc[7]
    want = jax.grad(lambda u: jmca.transition(jp, jg, jnp.asarray(x0), u)[2])(jnp.asarray(u0))
    u = torch.tensor(u0, requires_grad=True)
    tmca.transition(tp, tg, torch.as_tensor(x0), u)[2].backward()
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-9)
