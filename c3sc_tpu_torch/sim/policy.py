"""Implicit feedback policy: u*(x) = argmin_u Bellman RHS against a value
function — port of ``c3sc_tpu/sim/policy.py`` (brute force over the
candidate set; ``refine_steps > 0`` waits for ``ops/argmin.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops import mca


def _rhs_all(problem: ControlProblem, grid: Grid, value_fn: Callable, uc, xf):
    """Bellman RHS of every candidate at states xf [B, d]: [B, C]."""
    d = problem.dx
    # neighbour points x +- h_j(x) e_j -> [B, 2, d(which), d(coord)]; local
    # spacing so the stencil's neighbours match non-uniform grids
    hp, hm = grid.local_h(xf)
    eye = torch.eye(d, dtype=xf.dtype, device=xf.device)
    nb = torch.stack([xf[:, None, :] + hp[:, :, None] * eye,
                      xf[:, None, :] - hm[:, :, None] * eye], dim=1)
    vnb = value_fn(nb.reshape(-1, d)).reshape(-1, 2, d)        # [B, 2, d]
    pp, pm, dt = mca.transition_all_controls(problem, grid, xf, uc)
    g = mca.stage_cost_all(problem, xf, uc)                    # [C, B]
    expect = torch.sum(pp * vnb[None, :, 0] + pm * vnb[None, :, 1], dim=-1)
    return (g * dt + torch.exp(-problem.beta * dt) * expect).T  # [B, C]


def q_values(problem: ControlProblem, grid: Grid, value_fn: Callable, controls, x):
    """Bellman RHS Q(x, u) for every control candidate: [..., C].

    value_fn: batched points [..., d] -> values [...].
    """
    uc = torch.as_tensor(controls, dtype=x.dtype, device=x.device)
    rhs = _rhs_all(problem, grid, value_fn, uc, x.reshape(-1, problem.dx))
    return rhs.reshape(*x.shape[:-1], uc.shape[0])


def make_implicit_policy(problem: ControlProblem, grid: Grid, value_fn: Callable,
                         controls, refine_steps: int = 0):
    """Build policy(x [..., d]) -> u [..., du].

    value_fn: batched points [..., d] -> values [...] (e.g. dense interp).
    controls: [C, du] candidate set (a tensor on the states' device avoids
    a copy per call). ``refine_steps > 0`` (batched optimizer
    polish of the brute-force winner) needs ``ops/argmin.py``, which is not
    ported yet.
    """
    if refine_steps > 0:
        raise NotImplementedError("make_implicit_policy refine_steps > 0 needs "
                                  "ops/argmin.py (not ported yet)")

    controls = torch.as_tensor(controls, dtype=torch.float32)

    def policy(x):
        uc = controls.to(x.device)
        rhs = _rhs_all(problem, grid, value_fn, uc, x.reshape(-1, problem.dx))
        u = uc[torch.argmin(rhs, dim=-1)]                       # [B, du]
        return u.reshape(*x.shape[:-1], problem.du)

    return policy
