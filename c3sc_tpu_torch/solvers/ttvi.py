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
two-level composite of ``solvers/local_patch.py``).

``tt_vi`` is the value iteration whose loop runs on the host (the
reference's ``c3control_vi_solve``): every iteration cross-approximates the
backed-up value with ``ops.cross.tt_cross`` (or ``solvers.dmrg.dmrg_cross``),
warm-started from the previous iteration's index sets. The backups run on
the device; the rank choices and index sets live on the host, so an
iteration reads the device on the host several times a core, by design.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Sequence

import numpy as np
import torch

from c3sc_tpu_torch.device import const_tensor, resolve_device
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops import mca
from c3sc_tpu_torch.ops.argmin import first_argmin, lbfgs_minimize, pgd_minimize
from c3sc_tpu_torch.ops.cross import CrossState, tt_cross
from c3sc_tpu_torch.ops.tt import TT, tt_gather_eval, tt_round, tt_zeros
from c3sc_tpu_torch.seeds import seed_stream
from c3sc_tpu_torch.utils.checkpoint import load_solver_state, save_solver_state

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


@dataclasses.dataclass
class TTVISolution:
    v: TT
    state: CrossState
    residual: float
    iterations: int
    residual_history: list
    ranks: list
    n_evals: int
    wall_time: float
    controls: np.ndarray


def tt_vi(
    problem: ControlProblem,
    grid: Grid,
    controls=None,
    n_controls: int = 9,
    rmax: int = 20,
    seed: int | Sequence = 0,
    tol: float = 1e-4,
    max_iters: int = 500,
    cross_tol: float = 1e-4,
    cross_sweeps_first: int = 5,
    cross_sweeps: int = 2,
    r0: int = 3,
    kick: int = 2,
    eps_rank: float = 1e-5,
    round_tol: float | None = None,
    chunk: int = 4096,
    sample_size: int = 512,
    dtype=torch.float32,
    v0: TT | None = None,
    state: CrossState | None = None,
    verbose: bool = False,
    callback: Callable | None = None,
    metrics=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 50,
    resume_from: str | None = None,
    cross_method: str = "cross",
    refine_steps: int = 0,
    refine_method: str = "pgd",
    device=None,
) -> TTVISolution:
    """Solve the MCA Bellman fixed point with a TT-compressed value, on
    ``device`` (None: the default CUDA device; ``v0`` and ``state`` warm-
    start it).

    ``cross_method``: 'cross' (single-site, kick rank) or 'dmrg' (two-site
    SVD rank revelation). ``refine_steps``: the continuous polish of each
    node's control inside the backup (0: brute force only). ``seed``: an int
    draws each iteration's cross seed from ``np.random.default_rng(seed)``;
    a sequence gives them in order (an item is what the cross function's
    ``seed`` takes: an int, or ``tt_cross``'s pair). ``metrics`` (an object
    with ``.log(name, **fields)``) gets a ``vi_iter`` record an iteration,
    ``callback(it, v, residual)`` is called after each.

    ``checkpoint_path``: the solver state (TT, cross index sets, iteration,
    the seed stream's state) is saved there every ``checkpoint_every``
    iterations and when the residual falls below ``tol``
    (``save_solver_state``, the JAX package's file). ``resume_from``: a
    checkpoint of either package continues at the iteration after the saved
    one, warm from its TT and index sets; the port's own files also restore
    the seed stream, a JAX-written one (whose key the port cannot use)
    continues with the stream drawn from ``seed``.
    """
    if cross_method not in ("cross", "dmrg"):
        raise ValueError(f"cross_method must be 'cross' or 'dmrg', got {cross_method!r}")
    device = resolve_device(device)
    if controls is None:
        controls = problem.control_candidates(n_controls)
    start_iter, stream = 0, None
    if resume_from is not None:
        ck = load_solver_state(resume_from, device)
        v0, state = ck["v"], ck.get("state", state)
        start_iter, stream = ck["iteration"] + 1, ck.get("seed_stream")
    bellman = make_bellman_kernel(problem, grid, controls, chunk, dtype,
                                  refine_steps=refine_steps, refine_method=refine_method)
    rng = np.random.default_rng(777)
    sample_idx = np.stack([rng.integers(0, n, size=sample_size) for n in grid.shape], axis=-1)
    sample_t = torch.as_tensor(sample_idx, dtype=torch.int64, device=device)
    next_seed = seed_stream(seed, max_iters, stream)
    if cross_method == "dmrg":
        from c3sc_tpu_torch.solvers.dmrg import dmrg_cross

    v = v0 if v0 is not None else tt_zeros(grid.shape, rmax, dtype, device)
    v_sample = tt_gather_eval(v, sample_t)
    history, ranks_hist = [], []
    n_evals = 0
    t0 = time.time()
    residual = float("inf")
    it = start_iter
    for it in range(start_iter, max_iters):
        f = partial(bellman, v)
        n_sw = cross_sweeps_first if state is None else cross_sweeps
        if cross_method == "dmrg":
            res = dmrg_cross(f, grid.shape, rmax=rmax, seed=next_seed(), state=state, r0=r0,
                             tol=cross_tol, eps_rank=eps_rank, max_sweeps=n_sw,
                             sample_idx=sample_idx, dtype=dtype, device=device)
        else:
            res = tt_cross(f, grid.shape, rmax=rmax, seed=next_seed(), state=state, r0=r0,
                           kick=kick, tol=cross_tol, eps_rank=eps_rank, max_sweeps=n_sw,
                           sample_idx=sample_idx, dtype=dtype, device=device)
        v_new, state = res.tt, res.state
        if round_tol is not None:
            v_new = tt_round(v_new, round_tol, rmax)
        n_evals += res.n_evals
        new_sample = tt_gather_eval(v_new, sample_t)
        scale = float(torch.max(torch.abs(new_sample))) + 1e-12
        residual = float(torch.max(torch.abs(new_sample - v_sample))) / scale
        history.append(residual)
        ranks_hist.append([int(r) for r in v_new.ranks.tolist()])
        v, v_sample = v_new, new_sample
        if verbose and (it % 10 == 0 or residual < tol):
            print(f"[tt_vi:{problem.name}] it={it} res={residual:.3e} ranks={ranks_hist[-1]} "
                  f"evals={n_evals}")
        if metrics is not None:
            metrics.log("vi_iter", iter=it, residual=residual, ranks=ranks_hist[-1],
                        evals=n_evals)
        if callback is not None:
            callback(it, v, residual)
        if checkpoint_path is not None and ((it + 1) % checkpoint_every == 0 or residual < tol):
            save_solver_state(checkpoint_path, v, state, it, next_seed.state(),
                              extras={"residual": residual, "problem": problem.name})
        if residual < tol:
            break
    return TTVISolution(v=v, state=state, residual=residual, iterations=it + 1,
                        residual_history=history, ranks=ranks_hist, n_evals=n_evals,
                        wall_time=time.time() - t0, controls=np.asarray(controls))
