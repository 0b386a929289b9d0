"""Sharded Bellman backup and rollout over a device mesh — port of
``c3sc_tpu/parallel/sharded.py``.

JAX's ``shard_map`` runs one function on every device's block. Here every
rank of the mesh runs it on its own block: Bellman nodes shard over the
``'fibers'`` axis, control candidates over ``'ctrl'`` (each rank takes the
min over its candidate block, then a MIN collective over ``'ctrl'`` takes
the global one), TT cores stay replicated. Rollout scenarios shard over
``'fibers'``. Every rank returns the whole result, gathered over
``'fibers'``, as JAX's ``out_specs=P('fibers')`` gives the global array.
"""

from __future__ import annotations

import torch

from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops.tt import TT
from c3sc_tpu_torch.parallel.mesh import block, check_device, gather_rows, min_over
from c3sc_tpu_torch.solvers.ttvi import bellman_backup


def make_sharded_bellman(problem: ControlProblem, grid: Grid, mesh, dtype=torch.float32):
    """Sharded backup: ``(v_tt, idx [B, d], controls [C, du]) -> [B]`` on
    every rank, on the TT's device.

    B must divide by the ``'fibers'`` axis size, C by the ``'ctrl'`` one.
    Each rank backs up its row block against its candidate block, then a MIN
    over ``'ctrl'`` and a gather over ``'fibers'``. Terminal pinning and the
    value clip are per node and identical on every rank, so they commute
    with the MIN."""

    def backup(v_tt: TT, idx, controls) -> torch.Tensor:
        dev = v_tt.cores[0].device
        check_device(mesh, dev)
        idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        uc = torch.as_tensor(controls, dtype=dtype, device=dev)
        lo, hi = block(mesh, "fibers", idx.shape[0], "nodes")
        c0, c1 = block(mesh, "ctrl", uc.shape[0], "control candidates")
        with torch.no_grad():
            val = bellman_backup(problem, grid, uc[c0:c1], v_tt, idx[lo:hi], dtype)
        return gather_rows(min_over(val, mesh, "ctrl"), mesh, "fibers")

    return backup


def make_sharded_rollout(problem: ControlProblem, grid: Grid, mesh, policy, dt: float,
                         n_steps: int):
    """Sharded Monte-Carlo rollout:
    ``roll(x0 [B, d], seeds [B] | None, noise=None) -> Trajectory`` on every
    rank.

    Scenarios shard over ``'fibers'`` (B must divide by its size); each rank
    runs the whole rollout on its block. Its noise is ``noise[:, block]``
    when ``noise [n_steps, B, dw]`` is given, else a generator seeded from
    the block's first seed (JAX's ``key[0]`` of each shard). The trajectory
    has ``rollout``'s axes: ``xs [T+1, B, d]``, ``us [T, B, du]``,
    ``cost [B]``, ``alive [T+1, B]``, ``exit_time [B]``."""
    from c3sc_tpu_torch.sim.integrators import Trajectory, rollout

    def roll(x0, seeds=None, noise=None) -> Trajectory:
        check_device(mesh, x0.device)
        lo, hi = block(mesh, "fibers", x0.shape[0], "scenarios")
        gen = None
        if noise is None:
            if seeds is None:
                raise ValueError("the sharded rollout needs seeds or noise=")
            gen = torch.Generator(device=x0.device).manual_seed(int(seeds[lo]))
        else:
            noise = noise[:, lo:hi]
        traj = rollout(problem, grid, policy, x0[lo:hi], dt, n_steps, noise=noise,
                       generator=gen)

        def over_scenarios(t, axis):
            t = t.detach()
            if axis == 0:
                return gather_rows(t, mesh, "fibers")
            return gather_rows(t.transpose(0, 1), mesh, "fibers").transpose(0, 1)

        return Trajectory(xs=over_scenarios(traj.xs, 1), us=over_scenarios(traj.us, 1),
                          cost=over_scenarios(traj.cost, 0),
                          alive=over_scenarios(traj.alive, 1),
                          exit_time=over_scenarios(traj.exit_time, 0))

    return roll
