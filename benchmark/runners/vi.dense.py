"""Traffic of kind ``vi`` on the dense solver: whole cold solves."""

from __future__ import annotations

import torch

from benchmark import checks
from benchmark.reference import bellman
from benchmark.runners import Parts, timed_loop
from benchmark.runners.dense import DenseBase
from benchmark.trace import span, sync


class DenseSolves(DenseBase):
    """Whole cold dense solves, one after another through the window."""

    def setup(self, parts: Parts):
        self.load(parts)
        self.sol = self.solve()
        parts.mark("warmup")

    def _solve(self):
        self.sol = self.solve()
        sync()

    def window(self, seconds: float) -> dict:
        calls, took, laps = timed_loop(seconds, self._solve)
        self.attempted = calls
        self.info.update(solves=calls, seconds=took, outer_sweeps=self.sol.sweeps,
                         residual=self.sol.residual, floored=self.sol.floored,
                         solve_s_min=min(laps), solve_s_max=max(laps))
        return {"dense_solve_s": took / calls}

    def traced(self) -> dict:
        with span("solve"):
            self._solve()
        self.attempted = 1
        return {"solves": 1, "outer_sweeps": self.sol.sweeps,
                "eval_sweeps": self.cfg["eval_sweeps"]}

    def release(self):
        self.v = self.sol.v
        del self.sol
        self.free()

    def check(self) -> dict:
        return checks.dense_residual(self.model, self.ref_grid, self.uc_ref, self.v)

    def control(self, seconds: float):
        """The reference dense solve in bfloat16, as many outer sweeps as the
        program's cold solve takes, checked as the program's value is."""
        self.setup(Parts())
        sweeps = self.sol.sweeps
        self.release()
        del self.v
        self.free()
        v = bellman.dense_vi(self.model, self.ref_grid, self.uc_ref, sweeps,
                             self.cfg["eval_sweeps"], torch.bfloat16, self.dev)
        return checks.dense_residual(self.model, self.ref_grid, self.uc_ref, v), \
            {"outer_sweeps": sweeps}


RUNNER = DenseSolves
