"""Traffic of kind ``mpc`` on the fused solver: the receding-horizon loop."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import checks
from benchmark.reference import closed_loop
from benchmark.reference.interp import tt_between_nodes
from benchmark.runners import Parts, timed_loop
from benchmark.runners.fused import FusedBase
from benchmark.trace import span, sync


class FusedMPC(FusedBase):
    """The receding-horizon loop of ``sim/mpc_fused.py`` driven through its
    public pieces: a cold solve in set-up, then cycles of a warm replan
    (``replan_iterations`` graphed iterations, timed from the call to its
    synchronize) and a closed-loop segment of every scenario under the
    implicit policy on the current train. A replan calls ``step_fn`` for all
    its iterations but the last, then for the last, so that the state before
    its last iteration is the program's own."""

    def setup(self, parts: Parts):
        from c3sc_tpu_torch.ops.tt import TT, tt_lerp_eval
        from c3sc_tpu_torch.sim.integrators import rollout
        from c3sc_tpu_torch.sim.policy import make_implicit_policy

        self.TT, self.tt_lerp_eval = TT, tt_lerp_eval
        self.rollout, self.make_implicit_policy = rollout, make_implicit_policy
        m = self.mix
        self.build_solver(parts, m["cold_iterations"])
        gen = self.generator()
        self.x = self.middle_half(m["scenarios"], gen)
        self.noise = torch.randn((m["max_cycles"], m["steps_per_segment"], m["scenarios"],
                                  self.model.dw), generator=gen, device=self.dev)
        self.records, self.latencies, self.cycles_run = [], [], 0
        parts.mark("inputs")
        self.cycle()          # the first segment's shapes
        self.latencies.clear()
        parts.mark("warmup")

    def cycle(self):
        m = self.mix
        i = self.cycles_run
        if i >= m["max_cycles"]:
            raise RuntimeError(f"the window ran more than max_cycles = {m['max_cycles']} cycles")
        with span("replan"):
            sync()
            t0 = time.perf_counter()
            before_last = self.solver.step_fn(self.carry, m["replan_iterations"] - 1)
            self.carry = self.solver.step_fn(before_last, 1)
            t1 = time.perf_counter()
            sync()
            self.latencies.append((time.perf_counter() - t0, t1 - t0))
        with span("segment"):
            v = self.TT(self.carry.cores, self.carry.ranks)
            policy = self.make_implicit_policy(
                self.prob, self.grid, lambda p: self.tt_lerp_eval(v, self.grid, p), self.uc)
            with torch.no_grad():
                traj = self.rollout(self.prob, self.grid, policy, self.x, m["dt"],
                                    m["steps_per_segment"], noise=self.noise[i])
            self.x = traj.xs[-1]
            sync()
        self.records.append((self.tt_state(before_last), self.tt_state(self.carry), i, traj))
        self.cycles_run += 1

    def window(self, seconds: float) -> dict:
        calls, took, _ = timed_loop(seconds, self.cycle)
        self.attempted = calls
        lat_ms = 1e3 * np.asarray([t for t, _ in self.latencies])
        med = float(np.median(lat_ms))
        slow = [(j, round(t, 2), round(1e3 * e, 2)) for j, (t, e) in
                enumerate(zip(lat_ms, (e for _, e in self.latencies))) if t > 1.1 * med]
        self.info.update(cycles=calls, seconds=took, replan_ms_median=med,
                         replan_ms_min=float(lat_ms.min()), replan_ms_max=float(lat_ms.max()),
                         slow_replans=slow[:40], ranks=self.carry.ranks.tolist(),
                         frozen=bool(self.carry.frozen))
        return {"replan_p95_ms": float(np.percentile(lat_ms, 95))}

    def traced(self) -> dict:
        n = self.mix["trace_cycles"]
        for _ in range(n):
            self.cycle()
        self.attempted = n
        return {"cycles": n, "replan_iterations": n * self.mix["replan_iterations"]}

    def release(self):
        """Order the window's cycles for the check: the last, then the others
        in an order drawn from the seed (records[0] is set-up's cycle)."""
        n = len(self.records) - 1
        order = [n] + (1 + np.random.default_rng(self.seed).permutation(n - 1)).tolist()
        self.ordered = [self.records[j] for j in order]
        del self.records, self.solver, self.carry
        self.free()

    def check(self, control: bool = False) -> dict:
        """The segment numbers of the first ``checked_cycles`` cycles in the
        check's order, each the largest over them; the replans' largest
        iteration gap over the first ``checked_iterations`` of them the
        reference follows; the Bellman residual of the last replan's train.
        With ``control`` the reference takes the program's place one
        precision below float32: the replan's last iteration in float32
        with TF32 products, and the segment (no products but the train's
        evaluation) in bfloat16 on the program's train, from the same states
        under the same noise."""
        out = {}
        for prev, state, i, traj in self.ordered[:self.mix["checked_cycles"]]:
            xs, us, alive, cost = traj.xs, traj.us, traj.alive, traj.cost
            if control:
                xs, us, alive, cost = closed_loop.simulate(
                    self.model, self.ref_grid,
                    lambda p, c=state["cores"]: tt_between_nodes(self.ref_grid, c, p),
                    traj.xs[0].to(torch.bfloat16), self.uc_ref, self.noise[i], self.mix["dt"])
            nums = checks.closed_loop_gaps(
                self.model, self.ref_grid, self.uc_ref,
                lambda p, c=state["cores"]: tt_between_nodes(self.ref_grid, c, p),
                xs, us, alive, self.noise[i], cost, self.mix["dt"])
            for k, val in nums.items():
                out[k] = max(out.get(k, 0.0), val)
        out.update(self.fused_numbers(((prev, state) for prev, state, _, _ in self.ordered),
                                      control))
        return out


RUNNER = FusedMPC
