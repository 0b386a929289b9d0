"""The comparisons that decide ``correct``: what the timed path produced,
judged by the plain reference in ``benchmark/reference/`` in float64.

Each function takes the program's outputs as plain tensors (cores, values,
recorded trajectories) and the inputs the benchmark made, and returns the
numbers compared, by name. None of them imports the program.

- ``fused_iteration_gap``: the tensor train the fused value iteration left,
  against the train the reference builds by the same iterations from the
  program's state before them, under the pivot choices the program
  recorded. It covers the model, the stencil, the min over the candidates
  (block K2) and the interpolating fit (block K3).
- ``fused_residual``: max |T v - v| of that train at nodes drawn from the
  seed, by the reference's Bellman operator itself: what the choices the
  gap takes from the program (pivots, ranks) made of the train.
- ``dense_residual``: max |T v - v| of a dense value over the whole grid.
- ``closed_loop_gaps``: recorded closed-loop trajectories, followed step by step
  from the program's own states: how far each applied control's lookahead
  lies above the best candidate's, how far each next state lies from the
  reference's Euler-Maruyama step under the same noise, and how far each
  trajectory's cost lies from the reference's sum over its record.
"""

from __future__ import annotations

import sys

import torch

from benchmark.reference import bellman, closed_loop, fused, interp
from benchmark.reference.quadcopter import Quadcopter

F64 = torch.float64


def fused_iteration_gap(model: Quadcopter, grid: bellman.UniformGrid, uc, prev, state,
                        iterations: int, seed: int, rank_tol: float, control: bool = False,
                        n_nodes: int = 4096):
    """max |v - v_ref| over ``n_nodes`` grid nodes drawn from the seed, where v
    is the train the program left in ``state`` after ``iterations`` fused
    iterations from ``prev`` and v_ref the train the reference builds from
    ``prev`` under the choices ``state`` records (``reference.fused.follow``);
    None where the reference cannot follow them. With ``control`` the
    reference in float32 with TF32 products takes the program's place."""
    try:
        ref = fused.follow(model, grid, uc, prev, state, iterations, rank_tol=rank_tol)
    except fused.Unfollowable as e:
        print(f"the reference does not follow this fused iteration: {e}", file=sys.stderr)
        return None
    cores = state["cores"]
    if control:
        cores = fused.follow(model, grid, uc, prev, state, iterations, torch.float32, tf32=True)
    idx = seed_nodes(grid, seed, n_nodes, ref[0].device)
    gap = interp.tt_at_nodes(cores, idx, F64) - interp.tt_at_nodes(ref, idx, F64)
    return float(torch.max(torch.abs(gap)))


def fused_residual(model: Quadcopter, grid: bellman.UniformGrid, uc, prev, state, seed: int,
                   control: bool = False, n_nodes: int = 4096):
    """max |T v - v| over ``n_nodes`` grid nodes drawn from the seed, of the
    train v the program left in ``state``, with T the reference's fused
    backup (the Bellman operator of the train, neighbour values clamped and
    pinned) in float64. With ``control`` v is instead the train the
    reference builds in float32 with TF32 products from ``prev`` under the
    choices ``state`` records (one iteration)."""
    cores = state["cores"]
    if control:
        cores = fused.follow(model, grid, uc, prev, state, 1, torch.float32, tf32=True)
    cores = [c.to(F64) for c in cores]
    idx = seed_nodes(grid, seed, n_nodes, cores[0].device)
    tv = fused.backup(model, grid, uc.to(cores[0].device, F64), cores, idx)
    return float(torch.max(torch.abs(tv - interp.tt_at_nodes(cores, idx, F64))))


def seed_nodes(grid: bellman.UniformGrid, seed: int, n: int, device):
    """n multi-indices [n, d] of grid nodes drawn uniformly from the seed."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.stack([torch.randint(0, m, (n,), generator=g) for m in grid.shape],
                       dim=-1).to(device)


def dense_residual(model: Quadcopter, grid: bellman.UniformGrid, uc, v):
    """{"value_residual": max |T v - v|} of a dense value v (any shape, N values)."""
    return {"value_residual": bellman.dense_residual(
        model, grid, v.reshape(-1).to(F64), uc.to(v.device, F64))}


def closed_loop_gaps(model: Quadcopter, grid: bellman.UniformGrid, uc, value_fn, xs, us, alive,
                     noise, cost, dt: float, block: int = 1 << 14):
    """The gaps of recorded closed loops, each over every alive step: xs
    [T+1, B, d], us [T, B, du], alive [T+1, B], noise [T, B, 3] the
    increments the program was given, cost [B] its realised costs;
    ``value_fn`` maps float64 points [P, d] to the value the policy read.

    control_gap: max over steps of rhs(applied control) - min over the
    candidates of rhs, by the reference's lookahead (inf where the applied
    control is no candidate). state_gap: max |x_next - reference step|,
    leaving out steps whose exit coordinate lands within 1e-4 of its face
    (float32 may exit there where float64 does not; a disagreement on the
    exit elsewhere is inf). cost_gap: max |cost - reference| / max(1, |reference|).
    """
    d = xs.shape[2]
    dev = xs.device
    x = xs[:-1].reshape(-1, d).to(F64)
    u = us.reshape(-1, us.shape[-1]).to(F64)
    live = alive[:-1].reshape(-1)
    ucd = uc.to(dev, F64)
    member = (u[:, None, :] == ucd[None]).all(-1).any(-1)
    ctrl = torch.where(member | ~live, 0.0, float("inf"))
    gaps = []
    for s in range(0, x.shape[0], block):
        q, applied = closed_loop.lookahead(model, grid, value_fn, x[s:s + block], ucd,
                                           u[s:s + block])
        gaps.append(applied - q.min(dim=1).values)
    gap = torch.where(live, torch.cat(gaps), 0.0)
    control_gap = float(torch.max(torch.maximum(gap, ctrl)))
    nz = noise.reshape(-1, noise.shape[-1]).to(F64)
    nxt, absorbed = closed_loop.em_step(model, x, u, nz, dt)
    ambiguous = closed_loop.near_face(model, x, u, nz, dt, 1e-4)
    prog_next = xs[1:].reshape(-1, d).to(F64)
    prog_absorbed = live & ~alive[1:].reshape(-1)
    exit_apart = live & ~ambiguous & (absorbed != prog_absorbed)
    dx = torch.where((live & ~ambiguous)[:, None], torch.abs(prog_next - nxt), 0.0).amax()
    state_gap = float("inf") if bool(exit_apart.any()) else float(dx)
    ref_cost = closed_loop.discounted_cost(model, xs.to(F64), us.to(F64), alive, dt)
    cost_gap = float(torch.max(torch.abs(cost.to(F64) - ref_cost)
                               / torch.clamp(torch.abs(ref_cost), min=1.0)))
    return {"control_gap": control_gap, "state_gap": state_gap, "cost_gap": cost_gap}
