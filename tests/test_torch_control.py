"""The port's C3Control builder (c3sc_tpu_torch.control) against the JAX
package's (c3sc_tpu.control) on the CPU: tests/test_control_api.py's LQ
builder, written once in each package with the same maths (per point with
jnp in JAX, batched with torch in the port), with an obstacle.

Bars, each stated at its test: ``problem()``'s fields equal and its
callables within 1e-6 of JAX's at seeded points; the builder's drivers
(``vi_solve`` with ``seed=``, ``pi_solve``, ``init_value``,
``implicit_policy`` in both bases) equal to the solvers they call on the
built problem, bit for bit.
"""

import torch_port_testing  # noqa: F401  (first: pins torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3sc_tpu.control import C3Control as JC3Control
from c3sc_tpu.models import lqr_solution
from c3sc_tpu_torch.control import C3Control
from c3sc_tpu_torch.device import const_tensor
from c3sc_tpu_torch.ops.cross import tt_cross
from c3sc_tpu_torch.solvers import fused_tt_vi

CPU = "cpu"
P, C, _ = lqr_solution(sigma=1.0, beta=1.0)


def build_jax():
    return (JC3Control(dx=2, du=1, dw=1, lb=[-2, -2], ub=[2, 2], beta=1.0,
                       ulb=[-6], uub=[6], name="lq_builder")
            .add_drift(lambda x, u: jnp.stack([x[1], u[0]]))
            .add_diff(lambda x, u: jnp.array([[0.0], [1.0]]))
            .add_stagecost(lambda x, u: x @ x + u @ u)
            .add_boundcost(lambda x: x @ (jnp.asarray(P) @ x) + C)
            .set_external_boundary(0, "absorb")
            .set_external_boundary(1, "absorb")
            .add_obstacle(lb=[0.5, 0.5], ub=[1.0, 1.0], cost=50.0))


def build_port():
    def diff(x, u):
        L = const_tensor([[0.0], [1.0]], x.dtype, x.device)
        return L.expand(*torch.broadcast_shapes(x.shape[:-1], u.shape[:-1]), 2, 1)

    return (C3Control(dx=2, du=1, dw=1, lb=[-2, -2], ub=[2, 2], beta=1.0,
                      ulb=[-6], uub=[6], name="lq_builder")
            .add_drift(lambda x, u: torch.stack(torch.broadcast_tensors(x[..., 1], u[..., 0]), -1))
            .add_diff(diff)
            .add_stagecost(lambda x, u: (x * x).sum(-1) + (u * u).sum(-1))
            .add_boundcost(lambda x: torch.einsum("...i,ij,...j->...", x,
                                                  const_tensor(P, x.dtype, x.device), x) + C)
            .set_external_boundary(0, "absorb")
            .set_external_boundary(1, "absorb")
            .add_obscost(50.0, lb=[0.5, 0.5], ub=[1.0, 1.0]))


def test_problem_fields_and_callables_match_jax():
    jp, tp = build_jax().problem(), build_port().problem()
    for f in ("dx", "du", "dw", "lb", "ub", "ulb", "uub", "beta", "name", "value_bounds"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert [int(b) for b in tp.boundary] == [int(b) for b in jp.boundary]
    assert [(o.lb, o.ub, o.cost) for o in tp.obstacles] == [(o.lb, o.ub, o.cost)
                                                           for o in jp.obstacles]
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (64, 2)).astype(np.float32)
    u = rng.uniform(-6, 6, (64, 1)).astype(np.float32)
    jx, ju, tx, tu = jnp.asarray(x), jnp.asarray(u), torch.as_tensor(x), torch.as_tensor(u)
    for name in ("drift", "diff", "stage_cost"):
        want = np.asarray(jax.vmap(getattr(jp, name))(jx, ju))
        np.testing.assert_allclose(getattr(tp, name)(tx, tu).numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    want = np.asarray(jax.vmap(jp.boundary_cost)(jx))
    np.testing.assert_allclose(tp.boundary_cost(tx).numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tp.in_obstacle(tx).numpy(), np.asarray(jax.vmap(jp.in_obstacle)(jx)))
    bare = C3Control(dx=2, du=1, dw=1, lb=[-1, -1], ub=[1, 1])
    assert bare.ulb == (-1.0,) and bare.uub == (1.0,)
    assert bare._bound(tx).shape == (64,)
    with pytest.raises(ValueError):
        bare.problem()
    with pytest.raises(ValueError):
        bare.add_obstacle([0.0], [1.0])


def test_drivers_call_the_solvers():
    ctrl = build_port().set_value_bounds(0.0, 100.0)
    prob = ctrl.problem()
    assert prob.value_bounds == (0.0, 100.0)
    kw = dict(tol=1e-3, max_iters=40, device=CPU)
    sol = ctrl.vi_solve(ngrid=11, rmax=4, n_controls=5, seed=2, **kw)
    direct = fused_tt_vi(prob, prob.default_grid(11), n_controls=5, rmax=4, seed=2, **kw)
    assert sol.grid.shape == (11, 11)
    for a, b in zip(sol.v.cores, direct.v.cores):
        assert torch.equal(a, b)
    pi = ctrl.pi_solve(ngrid=9, rmax=4, n_controls=5, outer_iters=1, eval_iters=2, device=CPU)
    assert np.isfinite(pi.residual) and pi.grid.shape == (9, 9)
    guess = lambda x: (x * x).sum(-1)  # noqa: E731
    v0 = ctrl.init_value(9, guess, rmax=4, seed=1, device=CPU)
    g = prob.default_grid(9)
    want = tt_cross(lambda idx: guess(g.index_to_state(idx)), g.shape, rmax=4, seed=1,
                    device=CPU).tt
    for a, b in zip(v0.cores, want.cores):
        assert torch.equal(a, b)
    x = torch.as_tensor(np.random.default_rng(3).uniform(-1.5, 1.5, (16, 2)), dtype=torch.float32)
    for basis in ("linelm", "poly"):
        u = ctrl.implicit_policy(sol, refine_steps=2, n_controls=5, basis=basis)(x)
        assert u.shape == (16, 1) and torch.isfinite(u).all()
        assert float(u.abs().max()) <= 6.0
