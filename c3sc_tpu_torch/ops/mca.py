"""Kushner–Dupuis Markov-chain-approximation transition stencil — port of
``c3sc_tpu/ops/mca.py``.

From drift f(x,u), diagonal diffusion variance sigma^2(x,u) and grid
spacings h, build the locally consistent upwind transition probabilities to
the 2*dx axis neighbours and the interpolation interval dt(x,u):

    Q_j  = sigma2_j / h_j^2 + |f_j| / h_j,        Q = sum_j Q_j
    p+_j = (sigma2_j / (2 h_j^2) + max(f_j, 0) / h_j) / Q
    p-_j = (sigma2_j / (2 h_j^2) + max(-f_j, 0) / h_j) / Q
    dt   = 1 / Q

All functions broadcast over leading axes instead of being vmapped.
"""

from __future__ import annotations

import torch

from c3sc_tpu_torch.device import const_tensor
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import Boundary, ControlProblem

_EPS = 1e-10


# The kinks of the stencil carry the JAX package's derivatives, so that
# gradients with respect to u (``solvers/ttvi.rhs_continuous``) match
# ``jax.grad`` where a drift component is exactly 0 (LQ's u = 0 candidate,
# the quadcopter's hover): d|f|/df = 1 there as for ``jnp.abs`` (torch.abs
# gives 0), and d max(f, 0)/df = 1/2 as for ``jnp.maximum`` (torch.clamp
# gives 1). The values are those of abs and clamp.
def _abs(f):
    return torch.where(f >= 0, f, -f)


def _pos(f):
    return torch.maximum(f, f.new_zeros(()))


def transition(problem: ControlProblem, grid: Grid, x, u):
    """Stencil at states x [..., d] under controls u [..., du] (leading
    axes broadcast). Returns (p_plus [..., d], p_minus [..., d], dt [...]).
    Non-uniform grids use the unequal-spacing upwind scheme."""
    f = problem.drift(x, u)
    s2 = problem.sigma2_diag(x, u)
    if grid.uniform:
        h = const_tensor(grid.h, f.dtype, f.device)
        return _stencil_from_fs2(f, s2, h)
    hp, hm = grid.local_h(x)
    return _stencil_nonuniform(f, s2, hp.to(f.dtype), hm.to(f.dtype))


def transition_batch(problem: ControlProblem, grid: Grid, x, u):
    """Stencil batched over arbitrary leading axes of x [..., d], u [..., m]:
    ``transition`` itself, whose callables broadcast (the JAX package vmaps
    ``transition`` once a leading axis)."""
    return transition(problem, grid, x, u)


def _stencil_nonuniform(f, s2, hp, hm):
    """Kushner–Dupuis upwind stencil with unequal spacings h+ / h-:

        Q_j  = s2_j/(h+ h-) + f+_j/h+ + f-_j/h-,    Q = sum_j Q_j
        p+_j = (s2_j/(h+ (h+ + h-)) + f+_j/h+) / Q
        p-_j = (s2_j/(h- (h+ + h-)) + f-_j/h-) / Q,   dt = 1/Q

    Reduces to the uniform scheme when h+ == h-. Shapes broadcast.
    """
    fp = _pos(f)
    fm = _pos(-f)
    qj = s2 / (hp * hm) + fp / hp + fm / hm
    q = torch.sum(qj, dim=-1, keepdim=True) + _EPS
    p_plus = (s2 / (hp * (hp + hm)) + fp / hp) / q
    p_minus = (s2 / (hm * (hp + hm)) + fm / hm) / q
    return p_plus, p_minus, 1.0 / q[..., 0]


def _stencil_from_fs2(f, s2, h):
    """Elementwise uniform-grid stencil given drift f [..., d] and variance
    s2 (broadcastable to f). Returns (p_plus, p_minus, dt)."""
    diffpart = 0.5 * s2 / h**2
    qj = 2.0 * diffpart + _abs(f) / h
    q = torch.sum(qj, dim=-1, keepdim=True) + _EPS
    p_plus = (diffpart + _pos(f) / h) / q
    p_minus = (diffpart + _pos(-f) / h) / q
    return p_plus, p_minus, 1.0 / q[..., 0]


def transition_all_controls(problem: ControlProblem, grid: Grid, x, uc):
    """Stencil for ALL control candidates at once: x [B, d], uc [C, du] ->
    (p_plus [C, B, d], p_minus [C, B, d], dt [C, B]).

    With the control-affine declarations the drift of every candidate is
    one [B, d, du] x [C, du] contraction; a control-independent diffusion
    (``sigma2_x``) is computed once. Other problems broadcast the full
    callables over candidates.
    """
    if problem.drift_f0 is not None and problem.drift_G is not None:
        f0 = problem.drift_f0(x)                               # [B, d]
        G = problem.drift_G(x)                                 # [B, d, du]
        f = f0[None] + torch.einsum("bdm,cm->cbd", G, uc)      # [C, B, d]
    else:
        f = problem.drift(x[None], uc[:, None])                # [C, B, d]
    if problem.sigma2_x is not None:
        s2 = problem.sigma2_x(x)[None]                         # [1, B, d]
    else:
        s2 = problem.sigma2_diag(x[None], uc[:, None])         # [C, B, d]
    if grid.uniform:
        h = const_tensor(grid.h, f.dtype, f.device)
        return _stencil_from_fs2(f, s2, h)
    hp, hm = grid.local_h(x)                                   # [B, d] each
    return _stencil_nonuniform(f, s2, hp[None].to(f.dtype), hm[None].to(f.dtype))


def stage_cost_all(problem: ControlProblem, x, uc):
    """g(x, u) for all candidates: x [B, d], uc [C, du] -> [C, B].

    Separable costs evaluate the state part once and the control part once
    (outer sum); otherwise the full cost broadcasts over both."""
    if problem.cost_q is not None and problem.cost_r is not None:
        q = problem.cost_q(x)                                  # [B]
        r = problem.cost_r(uc)                                 # [C]
        return r[:, None] + q[None, :]
    return problem.stage_cost(x[None], uc[:, None])


def node_terminal(problem: ControlProblem, grid: Grid, idx, x):
    """Classify grid nodes as terminal (absorbing) and give their pinned value.

    A node is terminal iff it lies on the face of a dimension whose external
    boundary is ABSORB, or inside an obstacle rectangle. Terminal value:
    obstacle cost inside an obstacle (obstacles take precedence), else the
    boundary exit cost psi(x).

    Args:
      idx: [..., d] int node indices.  x: [..., d] node states.
    Returns:
      (terminal_mask [...] bool, terminal_value [...]).
    """
    on_face = torch.zeros(idx.shape[:-1], dtype=torch.bool, device=idx.device)
    for k in range(problem.dx):
        if problem.boundary[k] == Boundary.ABSORB:
            on_face = on_face | (idx[..., k] == 0) | (idx[..., k] == grid.shape[k] - 1)
    in_obs = problem.in_obstacle(x)
    psi = torch.broadcast_to(problem.boundary_cost(x), x.shape[:-1])
    value = torch.where(in_obs, problem.obstacle_cost(x), psi)
    return on_face | in_obs, value
