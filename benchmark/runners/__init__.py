"""The general generator. A cell's runner is the file
``benchmark/runners/<kind>.<solver>.py`` named by its traffic mix's ``kind``
and its configuration's ``solver``, and its model is the file
``benchmark/models/<model>.py`` named by the configuration's ``model``; both
are found by name (``benchmark/run.py`` ``module``), and everything else a
runner needs comes from the numbers in those data files. A new cell of new
sizes or a new mix needs only data files; a new kind of traffic, solver or
model needs only new files.

A runner makes every input from the seed, sets up and warms the program,
runs the measured window or a traced piece of it, keeps what the timed path
produced, frees the program's state, and hands those outputs to the checks
in ``benchmark/checks.py``. Its ``control`` runs the same with the plain
reference one precision lower in the program's place
(``benchmark/controls.py``). From the program it takes only its public
entry points: the model factory, the solvers, the policy, the integrator
and the value evaluators.

This file holds what every runner shares; ``fused.py`` and ``dense.py``
what the runners of one solver share.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark.reference.bellman import UniformGrid
from benchmark.trace import sync


def make_runner(cfg: dict, mix: dict, seed: int, device):
    """The runner of ``benchmark/runners/<kind>.<solver>.py`` for this
    configuration and traffic mix."""
    from benchmark.run import module

    return module("runners", f"{mix['kind']}.{cfg['solver']}").RUNNER(cfg, mix, seed, device)


class Parts:
    """Seconds of the set-up's parts, in order."""

    def __init__(self):
        self.parts, self._t = {}, time.perf_counter()

    def mark(self, name: str):
        sync()
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self._t
        self._t = now


class Runner:
    """What every runner shares: the configuration, the mix, the seed, the
    device, the model's file, and the reference's model, grid and candidates."""

    def __init__(self, cfg, mix, seed, device):
        from benchmark.run import module

        self.cfg, self.mix, self.seed, self.dev = cfg, mix, int(seed), device
        self.info = {}        # printed on an earlier line than the result
        self.attempted = 0    # answers the window (or the traced piece) produced
        self.models = module("models", cfg["model"])
        self.model = self.models.reference(cfg)
        self.ref_grid = UniformGrid.of(self.model, cfg["grid_n"])
        self.uc_ref = torch.as_tensor(self.model.candidates(cfg["candidates_per_axis"]))

    def program(self):
        """The program's problem, grid and candidate set for this configuration."""
        prob = self.models.program(self.cfg)
        return prob, prob.default_grid(self.cfg["grid_n"]), \
            prob.control_candidates(self.cfg["candidates_per_axis"])

    def generator(self):
        return torch.Generator(device=self.dev).manual_seed(self.seed)

    def middle_half(self, n: int, gen):
        """n states drawn uniformly from the middle half of the box, on the device."""
        lb = torch.tensor(self.model.lb, device=self.dev)
        ub = torch.tensor(self.model.ub, device=self.dev)
        r = torch.rand((n, self.model.dx), generator=gen, device=self.dev)
        return (lb + ub) / 2 + 0.5 * (ub - lb) / 2 * (2 * r - 1)

    def free(self):
        gc.collect()
        torch.cuda.empty_cache()


def timed_loop(seconds: float, body):
    """Call ``body()`` (which ends on a synchronize) until ``seconds`` have
    passed: (calls, seconds taken, one per call)."""
    sync()
    t0 = time.perf_counter()
    laps, last = [], t0
    while True:
        body()
        now = time.perf_counter()
        laps.append(now - last)
        last = now
        if now - t0 >= seconds:
            return len(laps), now - t0, laps


def active_backups(rl, rr, shape) -> int:
    """Active Bellman backups of one fused iteration (bench.py's count): every
    core-step backs up its active fiber block rl[k] x n_k x rr[k + 1], once in
    each half sweep (exact while the ranks hold still)."""
    return 2 * sum(rl[k] * n * rr[k + 1] for k, n in enumerate(shape))
