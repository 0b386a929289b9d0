"""Implicit feedback policy: u*(x) = argmin_u Bellman RHS against a value
function — port of ``c3sc_tpu/sim/policy.py`` (brute force over the
candidate set, then optionally a batched continuous refinement of the
winner).
"""

from __future__ import annotations

from typing import Callable

import torch

from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops import mca
from c3sc_tpu_torch.ops.argmin import lbfgs_minimize, pgd_minimize
from c3sc_tpu_torch.solvers.ttvi import check_refine_method, rhs_continuous
from c3sc_tpu_torch.utils.metrics import span


def _neighbor_values(grid: Grid, value_fn: Callable, xf):
    """Values at the stencil's neighbour points x +- h_j(x) e_j: [B, 2, d].
    Local spacing, so the neighbours match non-uniform grids."""
    d = xf.shape[-1]
    hp, hm = grid.local_h(xf)
    eye = torch.eye(d, dtype=xf.dtype, device=xf.device)
    nb = torch.stack([xf[:, None, :] + hp[:, :, None] * eye,
                      xf[:, None, :] - hm[:, :, None] * eye], dim=1)   # [B, 2, d, d]
    return value_fn(nb.reshape(-1, d)).reshape(-1, 2, d)


def _rhs_all(problem: ControlProblem, grid: Grid, vnb, uc, xf):
    """Bellman RHS of every candidate at states xf [B, d] against the
    neighbour values vnb [B, 2, d]: [B, C]."""
    pp, pm, dt = mca.transition_all_controls(problem, grid, xf, uc)
    g = mca.stage_cost_all(problem, xf, uc)                    # [C, B]
    expect = torch.sum(pp * vnb[None, :, 0] + pm * vnb[None, :, 1], dim=-1)
    return (g * dt + torch.exp(-problem.beta * dt) * expect).T  # [B, C]


def q_values(problem: ControlProblem, grid: Grid, value_fn: Callable, controls, x):
    """Bellman RHS Q(x, u) for every control candidate: [..., C].

    value_fn: batched points [..., d] -> values [...].
    """
    uc = torch.as_tensor(controls, dtype=x.dtype, device=x.device)
    xf = x.reshape(-1, problem.dx)
    rhs = _rhs_all(problem, grid, _neighbor_values(grid, value_fn, xf), uc, xf)
    return rhs.reshape(*x.shape[:-1], uc.shape[0])


def make_implicit_policy(problem: ControlProblem, grid: Grid, value_fn: Callable,
                         controls, refine_steps: int = 0, refine_method: str = "pgd",
                         value_grad_fn: Callable | None = None):
    """Build policy(x [..., d]) -> u [..., du].

    value_fn: batched points [..., d] -> values [...] (dense interpolation or
    a TT). controls: [C, du] candidate set (a tensor on the states' device
    avoids a copy per call).

    ``refine_steps > 0`` polishes the brute-force winner with that many
    batched optimizer steps under the control box: ``refine_method`` 'pgd'
    (projected gradient, parallel line search) or 'lbfgs' (box L-BFGS).
    The objective is the stencil's right-hand side against the neighbour
    values, or, with ``value_grad_fn`` (points [B, d] -> grad v [B, d]), the
    continuous HJB Hamiltonian ``g(x, u) + grad v(x) . f(x, u)``: the
    u-dependent part of the discounted HJB at a point, smooth in u.
    """
    if refine_steps > 0:
        check_refine_method(refine_method)
    minimize = lbfgs_minimize if refine_method == "lbfgs" else pgd_minimize
    controls = torch.as_tensor(controls, dtype=torch.float32)

    def policy(x):
        with span("policy", device=False):
            uc = controls.to(x.device)
            xf = x.reshape(-1, problem.dx)
            with span("policy.values"):
                vnb = _neighbor_values(grid, value_fn, xf)
            with span("policy.argmin"):
                rhs = _rhs_all(problem, grid, vnb, uc, xf)
                u = uc[torch.argmin(rhs, dim=-1)]                       # [B, du]
                if refine_steps > 0:
                    if value_grad_fn is not None:
                        # grad v does not depend on u: once per state
                        gv = value_grad_fn(xf)

                        def f(ub):
                            return problem.stage_cost(xf, ub) + torch.sum(
                                gv * problem.drift(xf, ub), -1)
                    else:
                        f = rhs_continuous(problem, grid, xf, vnb)
                    u, _ = minimize(f, u, problem.ulb, problem.uub, n_iters=refine_steps)
            return u.reshape(*x.shape[:-1], problem.du)

    return policy
