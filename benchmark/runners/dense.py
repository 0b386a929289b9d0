"""What the runners of the dense solver share: K1 loaded and the problem made
in set-up, and one cold solve at the configuration's settings."""

from __future__ import annotations

from benchmark.runners import Parts, Runner


class DenseBase(Runner):
    def load(self, parts: Parts):
        """Import the dense solver, load K1 (built in a checkout's first run)
        and make the configuration's problem."""
        from c3sc_tpu_torch import _ext
        from c3sc_tpu_torch.solvers.dense import dense_vi

        self.dense_vi = dense_vi
        parts.mark("import")
        if self.dev.type == "cuda":
            _ext.load()
        parts.mark("k1_load")
        self.prob, self.grid, self.controls = self.program()

    def solve(self):
        """One cold ``dense_vi`` solve at the configuration's settings."""
        c = self.cfg
        return self.dense_vi(self.prob, self.grid, controls=self.controls, tol=c["tol"],
                             max_outer=c["max_outer"], chunk=c["chunk"],
                             eval_sweeps=c["eval_sweeps"], device=self.dev)
