"""The Bellman backup of a TT value at chosen nodes, with the continuous
refinement of its control — the part of ``c3sc_tpu/solvers/ttvi.py`` that
the fused solver, the policies and the residual check share.

    (T v)(x) = min_u [ g(x,u) dt(x,u) + e^{-beta dt} sum_j p_j(x,u) v(x_j) ]

``bellman_backup`` takes the min over a candidate set and, with
``refine_steps > 0``, polishes the winner by batched projected-gradient or
L-BFGS steps on the continuous right-hand side (``rhs_continuous``), whose
gradient with respect to u comes from ``torch.autograd``. Terminal nodes
are pinned both where the backup is evaluated and at the neighbours it
reads. ``make_bellman_kernel`` evaluates the backup at any number of nodes
in chunks; a ``node_value_fn`` replaces the TT's neighbour values (the
two-level composite of ``solvers/local_patch.py``). ``tt_vi`` is not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

from c3sc_tpu_torch.device import const_tensor
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops import mca
from c3sc_tpu_torch.ops.argmin import first_argmin, lbfgs_minimize, pgd_minimize
from c3sc_tpu_torch.ops.tt import TT, tt_gather_eval

REFINE_METHODS = ("pgd", "lbfgs")


def check_refine_method(method: str) -> None:
    if method not in REFINE_METHODS:
        raise ValueError(f"refine_method must be one of {REFINE_METHODS}, got {method!r}")


def _neighbor_indices(grid: Grid, idx):
    """idx [B, d] -> neighbours [B, 2, d, d] (sign, which dim, coordinates)."""
    ups = torch.stack([grid.neighbor_index(idx, j, +1) for j in range(grid.ndim)], dim=1)
    dns = torch.stack([grid.neighbor_index(idx, j, -1) for j in range(grid.ndim)], dim=1)
    return torch.stack([ups, dns], dim=1)


def rhs_continuous(problem: ControlProblem, grid: Grid, x, vn):
    """The Bellman right-hand side as a differentiable function of the
    controls: for fixed states x [B, d] and (already pinned) neighbour
    values vn [B, 2, d], returns ``f(u [B, du]) -> [B]``."""

    def f(u):
        pp, pm, dtt = mca.transition(problem, grid, x, u)
        g = problem.stage_cost(x, u)
        expect = torch.sum(pp * vn[:, 0] + pm * vn[:, 1], dim=-1)
        return g * dtt + torch.exp(-problem.beta * dtt) * expect

    return f


def refine_controls(problem: ControlProblem, grid: Grid, x, vn, u0, f0,
                    refine_steps: int, method: str = "pgd"):
    """Polish the brute-force winner u0 [B, du] (objective f0 [B]) by
    ``refine_steps`` batched projected-gradient (``'pgd'``) or L-BFGS
    (``'lbfgs'``) iterations of the continuous right-hand side under the
    control box. Monotone: the returned objective is <= f0 elementwise.
    Returns (u_opt, f_opt)."""
    check_refine_method(method)
    f = rhs_continuous(problem, grid, x, vn)
    minimize = lbfgs_minimize if method == "lbfgs" else pgd_minimize
    u_opt, f_opt = minimize(f, u0, problem.ulb, problem.uub, n_iters=refine_steps)
    return u_opt, torch.minimum(f_opt, f0)


def _pinned_neighbor_values(problem: ControlProblem, grid: Grid, v_tt: TT, idx, dtype,
                            node_value_fn=None):
    """TT neighbour values, clipped to the value bounds and pinned at
    terminal neighbours. ``node_value_fn(v_tt, idx [B, d]) -> [B]`` replaces
    the plain TT gather (the two-level composite TT + patch field).
    Returns (x [B, d], vn [B, 2, d])."""
    d = problem.dx
    x = grid.index_to_state(idx).to(dtype)
    nb_flat = _neighbor_indices(grid, idx).reshape(-1, d)
    vn = (tt_gather_eval(v_tt, nb_flat) if node_value_fn is None
          else node_value_fn(v_tt, nb_flat))
    if problem.value_bounds is not None:
        # rank-limited outliers cannot feed back through the backup
        vn = torch.clamp(vn, problem.value_bounds[0], problem.value_bounds[1])
    nx = grid.index_to_state(nb_flat).to(dtype)
    t_mask, t_val = mca.node_terminal(problem, grid, nb_flat, nx)
    vn = torch.where(t_mask, t_val.to(dtype), vn)
    return x, vn.reshape(-1, 2, d)


def bellman_backup(problem: ControlProblem, grid: Grid, uc, v_tt: TT, idx,
                   dtype=torch.float32, refine_steps: int = 0, refine_method: str = "pgd",
                   node_value_fn=None):
    """The backup at nodes idx [B, d] -> [B]: the min over the candidates uc
    [C, du] (a tensor on idx's device) of the stencil's right-hand side,
    refined by ``refine_steps`` continuous steps, clipped to the value
    bounds, terminal nodes pinned. ``node_value_fn`` as in
    ``_pinned_neighbor_values``."""
    x, vn = _pinned_neighbor_values(problem, grid, v_tt, idx, dtype, node_value_fn)
    pp, pm, dt = mca.transition_all_controls(problem, grid, x, uc)    # [C, B, d]
    g = mca.stage_cost_all(problem, x, uc)                            # [C, B]
    expect = torch.sum(pp * vn[None, :, 0] + pm * vn[None, :, 1], dim=-1)
    rhs = g * dt + torch.exp(-problem.beta * dt) * expect             # [C, B]
    val = torch.min(rhs, dim=0).values
    if refine_steps > 0:
        u0 = uc[first_argmin(rhs, 0)]
        _, val = refine_controls(problem, grid, x, vn, u0, val, refine_steps, refine_method)
    if problem.value_bounds is not None:
        val = torch.clamp(val, problem.value_bounds[0], problem.value_bounds[1])
    tm, tv = mca.node_terminal(problem, grid, idx, x)
    return torch.where(tm, tv.to(dtype), val).to(dtype)


def bellman_residual_sample(problem: ControlProblem, grid: Grid, controls, v_tt: TT,
                            n_samples: int = 4096, seed: int = 7, dtype=torch.float32):
    """Sampled Bellman residual max |T v - v| / scale at random nodes (numpy
    seed ``seed``, drawn as the JAX package draws them), on the device of
    v_tt. The contraction bound ``||v - v*|| <= ||T v - v|| / (1 - gamma)``
    makes it the quality measure where no dense solve exists. Returns
    (residual_rel, scale) as 0-d tensors."""
    dev = v_tt.cores[0].device
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(np.stack([rng.integers(0, n, n_samples) for n in grid.shape], -1),
                          dtype=torch.int64, device=dev)
    uc = torch.as_tensor(controls, dtype=dtype, device=dev)
    tv = bellman_backup(problem, grid, uc, v_tt, idx, dtype)
    v = tt_gather_eval(v_tt, idx).to(dtype)
    scale = torch.clamp(torch.max(torch.abs(v)), min=1e-12)
    return (torch.max(torch.abs(tv - v)) / scale).to(dtype), scale


def make_bellman_kernel(problem: ControlProblem, grid: Grid, controls, chunk: int = 4096,
                        dtype=torch.float32, refine_steps: int = 0,
                        refine_method: str = "pgd", node_value_fn=None):
    """The Bellman backup as a function of a TT value and any number of nodes:
    ``bellman(v_tt, idx [B, d] int) -> [B]`` on the TT's device.

    ``idx`` may be a tensor or a numpy array (uploaded once). The nodes are
    evaluated ``chunk`` at a time, which bounds the transient memory (the
    neighbour gather of a chunk is ``2 d chunk`` TT evaluations). With no
    jit there is nothing to recompile, so the last chunk is not padded.
    ``refine_steps``, ``refine_method`` and ``node_value_fn`` as in
    ``bellman_backup``.
    """
    if refine_steps > 0:
        check_refine_method(refine_method)
    controls = np.asarray(controls, np.float32)

    def bellman(v_tt: TT, idx):
        dev = v_tt.cores[0].device
        idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        uc = const_tensor(controls, dtype, dev)
        with torch.no_grad():
            pieces = [bellman_backup(problem, grid, uc, v_tt, idx[i:i + chunk], dtype,
                                     refine_steps, refine_method, node_value_fn)
                      for i in range(0, idx.shape[0], chunk)]
        return torch.cat(pieces) if len(pieces) > 1 else pieces[0]

    return bellman
