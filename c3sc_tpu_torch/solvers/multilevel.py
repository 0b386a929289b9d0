"""Grid-multilevel VI: coarse-to-fine warm starts — port of
``c3sc_tpu/solvers/multilevel.py``.

MCA value iteration contracts at about exp(-beta dt) a sweep with
dt = O(h^2 / sigma^2), so fine grids converge slowly. The ladder solves a
ladder of grids and prolongs each level's TT to the next (``tt_refine_grid``,
exact for the linear-element class) as the warm start of ``fused_tt_vi``:
coarse levels do most of the convergence cheaply, fine levels sharpen. The
last level's fixed point is that of a cold solve on its grid.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops.tt import tt_refine_grid
from c3sc_tpu_torch.seeds import seed_stream
from c3sc_tpu_torch.solvers.fused import FusedVISolution, fused_tt_vi


@dataclasses.dataclass
class MultilevelSolution:
    final: FusedVISolution     # solution on the finest grid
    grid: Grid
    levels: list               # per level: (n, iterations, residual, wall)


def multilevel_tt_vi(
    problem: ControlProblem,
    ns: list,
    rmax: int = 16,
    seed: int | Sequence[int] = 0,
    tol: float = 3e-4,
    max_iters_coarse: int = 4000,
    max_iters_fine: int = 2000,
    **kwargs,
) -> MultilevelSolution:
    """Solve on grids of sizes ns[0] < ns[1] < ... (each an int or a tuple).

    ``seed``: an int draws each level's ``fused_tt_vi`` seed from
    ``np.random.default_rng(seed)``; a sequence gives one seed a level, in
    order. ``kwargs`` go to every ``fused_tt_vi`` call (controls, device,
    cuda_graph, ...)."""
    next_seed = seed_stream(seed, len(ns))
    v0 = None
    prev_grid = None
    stats = []
    sol = None
    for i, n in enumerate(ns):
        grid = problem.default_grid(n)
        if v0 is not None:
            v0 = tt_refine_grid(v0, prev_grid, grid)
        sol = fused_tt_vi(
            problem, grid, rmax=rmax, seed=next_seed(), tol=tol,
            max_iters=max_iters_fine if i == len(ns) - 1 else max_iters_coarse,
            v0=v0, **kwargs)
        stats.append((n, sol.iterations, sol.residual, round(sol.wall_time, 2)))
        v0, prev_grid = sol.v, grid
    return MultilevelSolution(final=sol, grid=prev_grid, levels=stats)
