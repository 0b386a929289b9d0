"""Traffic of kind ``rollout`` on the dense solver: Monte-Carlo closed loops
on the set-up's dense value."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import checks
from benchmark.reference import closed_loop, interp
from benchmark.runners import Parts, timed_loop
from benchmark.runners.dense import DenseBase
from benchmark.trace import span, sync


class DenseRollouts(DenseBase):
    """Batches of closed loops under the implicit policy on the set-up's
    dense value, all of one batch's scenarios in lockstep."""

    def setup(self, parts: Parts):
        from c3sc_tpu_torch.ops.interp import multilinear_interp
        from c3sc_tpu_torch.sim.integrators import rollout
        from c3sc_tpu_torch.sim.policy import make_implicit_policy

        self.rollout = rollout
        self.load(parts)
        m = self.mix
        sol = self.solve()
        self.v = sol.v
        self.info.update(value_outer_sweeps=sol.sweeps, value_residual_program=sol.residual)
        parts.mark("value_solve")
        gen = self.generator()
        self.x0 = self.middle_half(m["scenarios"], gen)
        self.noise = torch.randn((m["steps"], m["scenarios"], self.model.dw), generator=gen,
                                 device=self.dev)
        uc = torch.as_tensor(np.asarray(self.controls), dtype=torch.float32, device=self.dev)
        self.policy = make_implicit_policy(
            self.prob, self.grid, lambda p: multilinear_interp(self.grid, self.v, p), uc)
        parts.mark("inputs")
        self._batch(m["warm_steps"])    # every kernel of a step, at the batch's size
        parts.mark("warmup")

    def _batch(self, steps=None):
        m = self.mix
        steps = steps or m["steps"]
        self.traj = None      # the last batch's record goes before the next is made
        with torch.no_grad():
            self.traj = self.rollout(self.prob, self.grid, self.policy, self.x0, m["dt"],
                                     steps, noise=self.noise[:steps])
        sync()

    def window(self, seconds: float) -> dict:
        calls, took, laps = timed_loop(seconds, self._batch)
        m = self.mix
        self.attempted = calls * m["scenarios"]
        self.info.update(batches=calls, seconds=took, batch_s_min=min(laps),
                         batch_s_max=max(laps),
                         survival=float(self.traj.alive[-1].float().mean()))
        return {"rollout_steps_per_s": m["scenarios"] * m["steps"] * calls / took}

    def traced(self) -> dict:
        with span("batch"):
            self._batch()
        self.attempted = self.mix["scenarios"]
        return {"steps": self.mix["steps"], "batches": 1}

    def _checked(self):
        """The checked scenarios, drawn from the seed."""
        rng = np.random.default_rng(self.seed)
        return torch.as_tensor(np.sort(rng.choice(self.mix["scenarios"],
                                                  self.mix["checked_scenarios"], replace=False)),
                               device=self.dev)

    def release(self):
        pick = self._checked()
        t = self.traj
        self.out = (t.xs[:, pick].clone(), t.us[:, pick].clone(), t.alive[:, pick].clone(),
                    self.noise[:, pick].clone(), t.cost[pick].clone())
        del self.traj, self.noise, self.policy, self.x0
        self.free()

    def check(self) -> dict:
        xs, us, alive, noise, cost = self.out
        v = self.v.reshape(-1).to(torch.float64)
        out = checks.dense_residual(self.model, self.ref_grid, self.uc_ref, self.v)
        out.update(checks.closed_loop_gaps(self.model, self.ref_grid, self.uc_ref,
                                           lambda p: interp.multilinear(self.ref_grid, v, p),
                                           xs, us, alive, noise, cost, self.mix["dt"]))
        return out

    def control(self, seconds: float):
        """The reference closed loops of the checked scenarios in bfloat16, on
        the program's value rounded to bfloat16, from the same states and
        noise, checked as the program's trajectories are."""
        self.setup(Parts())
        pick = self._checked()
        x0, noise = self.x0[pick].to(torch.bfloat16), self.noise[:, pick]
        v = self.v.reshape(-1)
        del self.traj, self.policy, self.x0, self.noise
        self.free()
        m, grid, dt = self.model, self.ref_grid, self.mix["dt"]
        xs, us, alive, cost = closed_loop.simulate(
            m, grid, lambda p: interp.multilinear(grid, v.to(torch.bfloat16), p), x0,
            self.uc_ref, noise, dt)
        out = checks.dense_residual(m, grid, self.uc_ref, v)
        out.update(checks.closed_loop_gaps(m, grid, self.uc_ref,
                                           lambda p: interp.multilinear(grid, v.double(), p),
                                           xs, us, alive, noise, cost, dt))
        return out, {}


RUNNER = DenseRollouts
