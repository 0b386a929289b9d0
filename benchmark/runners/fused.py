"""What the runners of the fused tensor-train value iteration share: the
solver built and warmed in set-up, the program's state as the reference
reads it, and the reference's iterations followed from it."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import checks
from benchmark.runners import Parts, Runner


class FusedBase(Runner):
    def build_solver(self, parts: Parts, cold_iterations: int):
        from c3sc_tpu_torch.solvers.fused import make_fused_vi

        parts.mark("import")
        c = self.cfg
        self.prob, self.grid, controls = self.program()
        self.solver = make_fused_vi(self.prob, self.grid, controls, rmax=c["rmax"],
                                    kick=c["kick"], eps_rank=c["eps_rank"], tol=c["tol"],
                                    max_iters=10 ** 9, device=self.dev,
                                    cuda_graph=c["cuda_graph"])
        self.uc = torch.as_tensor(np.asarray(controls), dtype=torch.float32, device=self.dev)
        carry = self.solver.init_fn(self.seed)
        parts.mark("operands")
        carry = self.solver.step_fn(carry, 1)
        parts.mark("capture")
        self.carry = self.solver.step_fn(carry, cold_iterations - 1)
        parts.mark("warmup")

    @staticmethod
    def tt_state(carry) -> dict:
        """What the reference reads of a carry: the train and the choices."""
        return dict(cores=tuple(carry.cores), left=carry.left, right=carry.right,
                    rows_l=carry.rows_l, rows_r=carry.rows_r, rl=carry.rl, rr=carry.rr)

    def iteration_gaps(self, pairs, control: bool):
        """The gap of the last iteration of each (state before it, state after
        it) in turn, until ``checked_iterations`` could be followed: the
        gaps, and how many pairs were tried."""
        gaps, tried = [], 0
        for prev, state in pairs:
            tried += 1
            gap = checks.fused_iteration_gap(self.model, self.ref_grid, self.uc_ref, prev, state,
                                             1, self.seed, self.cfg["eps_rank"], control)
            if gap is not None:
                gaps.append(gap)
                if len(gaps) == self.mix["checked_iterations"]:
                    break
        self.info.update(iterations_followed=len(gaps), iterations_tried=tried)
        return gaps

    def fused_numbers(self, pairs, control: bool) -> dict:
        """``iteration_gap``, the largest over the newest iterations of
        ``pairs`` (newest first) that the reference follows (inf where it
        follows none). The Bellman residual of the newest train, against the
        reference's operator itself, goes on the info line: it is not
        compared (PERF.md, the checks)."""
        pairs = list(pairs)
        gaps = self.iteration_gaps(pairs, control)
        prev, last = pairs[0]
        self.info["bellman_residual"] = checks.fused_residual(
            self.model, self.ref_grid, self.uc_ref, prev, last, self.seed, control)
        return {"iteration_gap": max(gaps) if gaps else float("inf")}

    def control(self, seconds: float):
        """The window as the cell runs it; then the reference in float32 with
        TF32 products takes the program's place in what the check reads."""
        self.setup(Parts())
        self.window(seconds)
        self.release()
        return self.check(control=True), self.info
