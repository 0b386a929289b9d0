"""Traffic of kind ``vi`` on the fused solver: the graphed iteration replayed
through the window."""

from __future__ import annotations

import collections

import numpy as np
import torch

from benchmark.runners import Parts, active_backups, timed_loop
from benchmark.runners.fused import FusedBase
from benchmark.trace import span, sync


class FusedSteady(FusedBase):
    """The fused value iteration replayed through the window from a state
    warmed by ``warm_iterations``, in calls of ``iterations_per_call``: each
    call that many iterations less one, then one more, so that the state
    before each call's last iteration is the program's own."""

    def setup(self, parts: Parts):
        self.build_solver(parts, self.mix["warm_iterations"])
        self.pairs = collections.deque(maxlen=self.mix["kept_iterations"])

    def _iterate(self, n: int):
        prev = self.solver.step_fn(self.carry, n - 1)
        self.carry = self.solver.step_fn(prev, 1)
        sync()
        self.pairs.append((self.tt_state(prev), self.tt_state(self.carry)))

    def window(self, seconds: float) -> dict:
        k = self.mix["iterations_per_call"]
        ranks0 = self.carry.ranks.clone()
        calls, took, laps = timed_loop(seconds, lambda: self._iterate(k))
        c = self.carry
        per_iter = active_backups(c.rl.tolist(), c.rr.tolist(), self.grid.shape)
        self.attempted = calls * k
        med = float(np.median(laps))
        self.info.update(iterations=calls * k, seconds=took, backups_per_iteration=per_iter,
                         call_s_median=med, slow_calls=[j for j, t in enumerate(laps)
                                                        if t > 1.1 * med][:40],
                         ranks=c.ranks.tolist(), ranks_held=bool(torch.equal(ranks0, c.ranks)),
                         sample_residual=float(c.residual), frozen=bool(c.frozen),
                         iteration=int(c.it))
        return {"backups_per_s": per_iter * calls * k / took}

    def traced(self) -> dict:
        """``trace_calls`` calls of ``trace_iterations_per_call``: as many
        calls as the check needs iterations to choose from."""
        m = self.mix
        n = m["trace_calls"] * m["trace_iterations_per_call"]
        with span("iterations"):
            for _ in range(m["trace_calls"]):
                self._iterate(m["trace_iterations_per_call"])
        self.attempted = n
        return {"iterations": n}

    def release(self):
        del self.solver, self.carry
        self.free()

    def check(self, control: bool = False) -> dict:
        """The numbers of the window's last calls, newest first (with
        ``control`` the reference in float32 with TF32 products takes the
        program's place in the iterations they read)."""
        return self.fused_numbers(reversed(self.pairs), control)


RUNNER = FusedSteady
