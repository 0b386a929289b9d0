"""TT policy iteration, the ``c3control_pi_solve`` analogue — port of
``c3sc_tpu/solvers/ttpi.py``.

Alternates
  (a) policy improvement: one min-backup cross of the value, then a cross
      fit of the greedy policy u*(x) = argmin_u Bellman RHS, one TT per
      control dimension;
  (b) policy evaluation: ``eval_iters`` one-sweep crosses of the linear
      backup v <- g(x, pi(x)) dt + e^{-beta dt} sum_j p_j(x, pi(x)) v(x_j),
      the control read from the policy TTs (no inner min).
Every cross runs its loop on the host (``ops.cross.tt_cross``); the black
boxes evaluate on the device in chunks.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Sequence

import numpy as np
import torch

from c3sc_tpu_torch.device import const_tensor, resolve_device
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops import mca
from c3sc_tpu_torch.ops.argmin import first_argmin
from c3sc_tpu_torch.ops.cross import tt_cross
from c3sc_tpu_torch.ops.tt import TT, tt_gather_eval, tt_zeros
from c3sc_tpu_torch.seeds import seed_stream
from c3sc_tpu_torch.solvers.ttvi import (_neighbor_indices, _pinned_neighbor_values,
                                         make_bellman_kernel)


def _chunked(fn, idx, chunk: int):
    with torch.no_grad():
        pieces = [fn(idx[i:i + chunk]) for i in range(0, idx.shape[0], chunk)]
    return torch.cat(pieces) if len(pieces) > 1 else pieces[0]


def make_policy_kernel(problem: ControlProblem, grid: Grid, controls, chunk: int = 4096,
                       dtype=torch.float32):
    """Greedy-policy black box: (v_tt, idx [B, d]) -> u* [B, du], the first
    candidate on ties. As in the reference, the neighbour values are pinned
    but not clipped to the value bounds."""
    controls = np.asarray(controls, np.float32)

    def policy(v_tt: TT, idx):
        dev = v_tt.cores[0].device
        idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        uc = const_tensor(controls, dtype, dev)

        def one(ix):
            x = grid.index_to_state(ix).to(dtype)
            nb = _neighbor_indices(grid, ix).reshape(-1, problem.dx)
            t_mask, t_val = mca.node_terminal(problem, grid, nb,
                                              grid.index_to_state(nb).to(dtype))
            vn = torch.where(t_mask, t_val.to(dtype), tt_gather_eval(v_tt, nb)).reshape(
                -1, 2, problem.dx)
            pp, pm, dt = mca.transition_all_controls(problem, grid, x, uc)
            g = mca.stage_cost_all(problem, x, uc)
            expect = torch.sum(pp * vn[None, :, 0] + pm * vn[None, :, 1], dim=-1)
            rhs = g * dt + torch.exp(-problem.beta * dt) * expect            # [C, B]
            return uc[first_argmin(rhs, 0)]

        return _chunked(one, idx, chunk)

    return policy


def make_policy_eval_kernel(problem: ControlProblem, grid: Grid, chunk: int = 4096,
                            dtype=torch.float32):
    """Fixed-policy backup: (v_tt, policy_tts, idx) -> [B] (no inner min),
    the controls read from the policy TTs and clipped to the control box."""
    ulb, uub = np.asarray(problem.ulb, np.float32), np.asarray(problem.uub, np.float32)

    def backup(v_tt: TT, policy_tts, idx):
        dev = v_tt.cores[0].device
        idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        lo, hi = const_tensor(ulb, dtype, dev), const_tensor(uub, dtype, dev)

        def one(ix):
            u = torch.stack([tt_gather_eval(p, ix) for p in policy_tts], dim=-1)
            u = torch.minimum(torch.maximum(u, lo), hi)
            x, vn = _pinned_neighbor_values(problem, grid, v_tt, ix, dtype)
            pp, pm, dt = mca.transition(problem, grid, x, u)
            g = problem.stage_cost(x, u)
            val = g * dt + torch.exp(-problem.beta * dt) * torch.sum(
                pp * vn[:, 0] + pm * vn[:, 1], dim=-1)
            if problem.value_bounds is not None:
                val = torch.clamp(val, problem.value_bounds[0], problem.value_bounds[1])
            tm, tv = mca.node_terminal(problem, grid, ix, x)
            return torch.where(tm, tv.to(dtype), val).to(dtype)

        return _chunked(one, idx, chunk)

    return backup


@dataclasses.dataclass
class TTPISolution:
    v: TT
    policy: tuple      # one TT per control dim
    residual: float
    outer_iters: int
    residual_history: list
    n_evals: int
    wall_time: float
    controls: np.ndarray


def tt_pi(
    problem: ControlProblem,
    grid: Grid,
    controls=None,
    n_controls: int = 9,
    rmax: int = 20,
    policy_rmax: int | None = None,
    seed: int | Sequence = 0,
    tol: float = 1e-4,
    outer_iters: int = 30,
    eval_iters: int = 20,
    cross_tol: float = 1e-4,
    r0: int = 3,
    kick: int = 2,
    eps_rank: float = 1e-5,
    chunk: int = 4096,
    sample_size: int = 512,
    dtype=torch.float32,
    v0: TT | None = None,
    verbose: bool = False,
    metrics=None,
    device=None,
) -> TTPISolution:
    """TT policy iteration (module docstring) on ``device`` (None: the
    default CUDA device). ``seed``: an int draws every cross's seed from
    ``np.random.default_rng(seed)``; a sequence gives them in the order the
    crosses run (per outer iteration: the value, each policy dimension, each
    evaluation)."""
    device = resolve_device(device)
    if controls is None:
        controls = problem.control_candidates(n_controls)
    if policy_rmax is None:
        policy_rmax = rmax
    du = problem.du
    bellman = make_bellman_kernel(problem, grid, controls, chunk, dtype)
    pol_kernel = make_policy_kernel(problem, grid, controls, chunk, dtype)
    pol_eval = make_policy_eval_kernel(problem, grid, chunk, dtype)
    rng = np.random.default_rng(778)
    sample_idx = np.stack([rng.integers(0, n, size=sample_size) for n in grid.shape], axis=-1)
    sample_t = torch.as_tensor(sample_idx, dtype=torch.int64, device=device)
    next_seed = seed_stream(seed, outer_iters * (1 + du + eval_iters))
    cross = partial(tt_cross, shape=grid.shape, r0=r0, kick=kick, sample_idx=sample_idx,
                    dtype=dtype, device=device)

    v = v0 if v0 is not None else tt_zeros(grid.shape, rmax, dtype, device)
    v_state = None
    pol_states = [None] * du
    v_sample = tt_gather_eval(v, sample_t)
    history = []
    n_evals = 0
    t0 = time.time()
    residual = float("inf")
    outer = 0
    policy_tts = ()
    for outer in range(outer_iters):
        # ---- improvement: one min-backup cross + greedy policy TT fit ----
        res = cross(partial(bellman, v), rmax=rmax, seed=next_seed(), state=v_state,
                    tol=cross_tol, eps_rank=eps_rank, max_sweeps=4 if v_state is None else 2)
        v, v_state = res.tt, res.state
        n_evals += res.n_evals
        policy_tts = []
        for m in range(du):
            pres = cross(lambda idx, m=m: pol_kernel(v, idx)[:, m], rmax=policy_rmax,
                         seed=next_seed(), state=pol_states[m], tol=max(cross_tol, 1e-3),
                         eps_rank=1e-4, max_sweeps=3 if pol_states[m] is None else 2)
            policy_tts.append(pres.tt)
            pol_states[m] = pres.state
            n_evals += pres.n_evals
        policy_tts = tuple(policy_tts)
        # ---- evaluation: cheap fixed-policy crosses ----
        for _ in range(eval_iters):
            eres = cross(partial(pol_eval, v, policy_tts), rmax=rmax, seed=next_seed(),
                         state=v_state, tol=cross_tol, eps_rank=eps_rank, max_sweeps=1)
            v, v_state = eres.tt, eres.state
            n_evals += eres.n_evals
        new_sample = tt_gather_eval(v, sample_t)
        scale = float(torch.max(torch.abs(new_sample))) + 1e-12
        residual = float(torch.max(torch.abs(new_sample - v_sample))) / scale
        v_sample = new_sample
        history.append(residual)
        if verbose:
            print(f"[tt_pi:{problem.name}] outer={outer} res={residual:.3e} "
                  f"ranks={v.ranks.tolist()}")
        if metrics is not None:
            metrics.log("pi_outer", iter=outer, residual=residual, evals=n_evals)
        if residual < tol:
            break
    return TTPISolution(v=v, policy=policy_tts, residual=residual, outer_iters=outer + 1,
                        residual_history=history, n_evals=n_evals, wall_time=time.time() - t0,
                        controls=np.asarray(controls))
