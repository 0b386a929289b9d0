"""Measured accept/reject gating of value-correction stages — port of
``c3sc_tpu/solvers/gating.py``.

No correction stage touches the deliverable unless measurement says it did
not regress: the sampled sup Bellman defect and, optionally, a small
common-random-number closed-loop probe cost. The defect gate is one-sided
with slack (corrections of defect-invisible smooth error may leave the
defect unchanged); the probe gate catches a correction that helps the
defect but worsens the deployed policy.

The probe's common random numbers are one x0 and one noise tensor, made
once when the probe is built and used at every call. Where the JAX package
draws the noise from ``jax.random.key(20_000 + seed)``, the port takes it
as a tensor or draws it once from a ``torch.Generator`` seeded so.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.grids import Grid
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.ops.tt import tt_constant, tt_gather_eval, tt_lerp_eval
from c3sc_tpu_torch.solvers.polish import _axis_mode, _ramp
from c3sc_tpu_torch.solvers.ttvi import make_bellman_kernel
from c3sc_tpu_torch.solvers.twogrid import _blend


@dataclasses.dataclass
class GateRecord:
    name: str
    accepted: bool
    bres_before: float
    bres_after: float
    probe_before: float | None
    probe_after: float | None


def probe_x0(problem: ControlProblem, n_rollouts: int, seed: int) -> np.ndarray:
    """The probe's initial states [n_rollouts, dx] (float32): the middle 40 %
    of the box, numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    lbn, ubn = np.asarray(problem.lb), np.asarray(problem.ub)
    mid, span = (lbn + ubn) / 2, (ubn - lbn) / 2
    return (mid + 0.4 * span * rng.uniform(-1, 1, (n_rollouts, problem.dx))).astype(np.float32)


def make_greedy_probe(problem: ControlProblem, grid: Grid, controls, n_rollouts: int = 24,
                      n_steps: int = 250, dt: float = 0.01, seed: int = 4242,
                      value_fn_of=None, noise=None, device=None):
    """CRN closed-loop probe: ``probe(v) -> float``, the mean discounted cost
    of greedy implicit-policy rollouts on the value iterate v, from fixed
    initial states (``probe_x0``) under fixed Euler–Maruyama noise: ``noise``
    [n_steps, n_rollouts, dw], or drawn once from a ``torch.Generator``
    seeded ``20_000 + seed`` on ``device`` (None: the default CUDA device).
    ``value_fn_of(v) -> (p [B, d] -> [B])`` overrides the plain TT lerp
    (e.g. the composite TT + patch field)."""
    # imported here: sim.policy imports solvers.ttvi, whose package imports
    # this module
    from c3sc_tpu_torch.sim.integrators import rollout
    from c3sc_tpu_torch.sim.policy import make_implicit_policy

    device = resolve_device(device)
    x0 = torch.as_tensor(probe_x0(problem, n_rollouts, seed), device=device)
    if noise is None:
        gen = torch.Generator(device=device).manual_seed(20_000 + seed)
        noise = torch.randn((n_steps, n_rollouts, problem.dw), generator=gen, device=device)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=device)
    uc = torch.as_tensor(np.asarray(controls), dtype=torch.float32, device=device)
    if value_fn_of is None:
        value_fn_of = lambda v: (lambda p: tt_lerp_eval(v, grid, p))  # noqa: E731

    def probe(v) -> float:
        policy = make_implicit_policy(problem, grid, value_fn_of(v), uc)
        with torch.no_grad():
            traj = rollout(problem, grid, policy, x0, dt, n_steps, noise=noise)
        return float(traj.cost.mean())

    return probe


def _check_nodes(grid: Grid, n_check: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.stack([rng.integers(0, n, n_check) for n in grid.shape], -1),
                           device=device)


def gated_apply(
    problem: ControlProblem,
    grid: Grid,
    controls,
    v,
    stage_fn: Callable,
    name: str = "stage",
    kernel=None,
    n_check: int = 4096,
    seed: int = 23,
    bres_slack: float = 1.05,
    probe_fn=None,
    probe_slack: float = 1.02,
    verbose: bool = False,
):
    """Apply ``stage_fn(v) -> v_new`` and keep the result ONLY if the sampled
    sup-defect and (when given) the CRN probe cost do not regress beyond
    their slacks. Returns (v_out, GateRecord); a rejected stage returns v
    itself."""
    if kernel is None:
        kernel = make_bellman_kernel(problem, grid, controls, chunk=32768)
    check = _check_nodes(grid, n_check, seed, v.cores[0].device)

    def _bres(vt):
        with torch.no_grad():
            return float((kernel(vt, check) - tt_gather_eval(vt, check)).abs().max())

    b0 = _bres(v)
    p0 = probe_fn(v) if probe_fn is not None else None
    v_new = stage_fn(v)
    b1 = _bres(v_new)
    p1 = probe_fn(v_new) if probe_fn is not None else None
    ok = b1 <= bres_slack * b0
    if probe_fn is not None:
        ok = ok and (p1 <= probe_slack * max(p0, 1e-12))
    rec = GateRecord(name=name, accepted=bool(ok), bres_before=b0, bres_after=b1,
                     probe_before=p0, probe_after=p1)
    if verbose:
        pr = "" if p0 is None else f" probe {p0:.4f}->{p1:.4f}"
        print(f"[gate:{name}] bres {b0:.4f}->{b1:.4f}{pr} accepted={ok}", flush=True)
    return (v_new if ok else v), rec


def probe_trim(
    problem: ControlProblem,
    grid: Grid,
    controls,
    v,
    probe_fn=None,
    dims=None,
    deltas=(-0.04, -0.02, 0.0, 0.02, 0.04),
    rounds: int = 2,
    verbose: bool = False,
):
    """Oracle-free closed-loop trim of the slowest field modes: coordinate
    search over the coefficients of {level} + {per-dim centred ramps}, scored
    by the CRN greedy-probe cost. ``deltas`` are fractions of the value
    range (estimated at 2,048 random nodes, numpy seed 5). Returns
    (v, history)."""
    dev = v.cores[0].device
    if probe_fn is None:
        probe_fn = make_greedy_probe(problem, grid, controls, device=dev)
    if dims is None:
        dims = list(range(problem.dx))
    shape = tuple(grid.shape)
    R = v.rmax
    vals = tt_gather_eval(v, _check_nodes(grid, 2048, 5, dev)).cpu().numpy()
    vrange = max(float(vals.max() - vals.min()), 1e-9)

    modes = [("level", tt_constant(shape, 1.0, R, device=dev))]
    modes += [(f"ramp{k}", _axis_mode(shape, k, _ramp(grid, k), R, dev)) for k in dims]

    best_cost = probe_fn(v)
    history = [{"stage": "init", "probe": best_cost}]
    for rd in range(rounds):
        improved = False
        for name, m in modes:
            cand_best = (0.0, v, best_cost)
            for dl in deltas:
                if dl == 0.0:
                    continue
                v_try = _blend(v, m, torch.tensor(dl * vrange, dtype=torch.float32, device=dev))
                c = probe_fn(v_try)
                if c < cand_best[2]:
                    cand_best = (dl, v_try, c)
            if cand_best[0] != 0.0:
                v, best_cost = cand_best[1], cand_best[2]
                improved = True
                history.append({"stage": f"r{rd}:{name}", "delta": cand_best[0],
                                "probe": best_cost})
                if verbose:
                    print(f"[trim] {name} delta={cand_best[0]:+0.3f} probe -> {best_cost:.4f}",
                          flush=True)
        if not improved:
            break
    return v, history
