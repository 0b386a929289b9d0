"""A run with the timed path broken underneath must come out not correct:
each cell, small on the CPU, with each fault its timed path can have
planted in the program. (No cell exchanges data between chips, so that
fault has no place here.)"""

import pytest
import torch

from benchmark import run
from benchmark.tests.small import CPU, small


def _fused_step(monkeypatch, wrap):
    import c3sc_tpu_torch.solvers.fused as fused

    real = fused.make_fused_vi

    def make(*a, **kw):
        s = real(*a, **kw)
        return s._replace(step_fn=wrap(s.step_fn))

    monkeypatch.setattr(fused, "make_fused_vi", make)


def step_unchanged(monkeypatch):
    _fused_step(monkeypatch, lambda step: lambda carry, n=1: carry)


def step_altered(monkeypatch):
    def wrap(step):
        def altered(carry, n=1):
            out = step(carry, n)
            return out._replace(cores=(out.cores[0] * 1.001,) + tuple(out.cores[1:]))
        return altered
    _fused_step(monkeypatch, wrap)


def dense_unchanged(monkeypatch):
    import c3sc_tpu_torch.solvers.dense as dense

    real = dense.make_dense_step

    def make(*a, **kw):
        step, v0 = real(*a, **kw)
        return (lambda v, n: (v, torch.zeros(()))), v0

    monkeypatch.setattr(dense, "make_dense_step", make)


def dense_altered(monkeypatch):
    import c3sc_tpu_torch.solvers.dense as dense

    real = dense.make_dense_step

    def make(*a, **kw):
        step, v0 = real(*a, **kw)

        def altered(v, n):
            v, res = step(v, n)
            v = v.clone()
            v.view(-1)[v.numel() // 2] += 0.05
            return v, res
        return altered, v0

    monkeypatch.setattr(dense, "make_dense_step", make)


def half_batch(monkeypatch):
    """Only the first half of the scenarios advance; the rest stay put."""
    import c3sc_tpu_torch.sim.integrators as integrators

    real = integrators.rollout

    def rollout(problem, grid, policy, x0, dt, n_steps, noise=None, **kw):
        h = x0.shape[0] // 2
        t = real(problem, grid, policy, x0[:h], dt, n_steps,
                 noise=None if noise is None else noise[:, :h], **kw)
        rest = x0[h:]
        T = t.us.shape[0]
        return t._replace(
            xs=torch.cat([t.xs, rest[None].expand(T + 1, -1, -1)], 1),
            us=torch.cat([t.us, t.us[:, :1].expand(-1, rest.shape[0], -1)], 1),
            cost=torch.cat([t.cost, t.cost.mean().expand(rest.shape[0])]),
            alive=torch.cat([t.alive, torch.ones(T + 1, rest.shape[0], dtype=torch.bool)], 1),
            exit_time=torch.cat([t.exit_time, t.exit_time[:1].expand(rest.shape[0])]))

    monkeypatch.setattr(integrators, "rollout", rollout)


def control_altered(monkeypatch):
    """The policy applies the next candidate after its argmin at every
    fourth scenario."""
    import c3sc_tpu_torch.sim.policy as policy_mod

    real = policy_mod.make_implicit_policy

    def make(problem, grid, value_fn, controls, *a, **kw):
        pol = real(problem, grid, value_fn, controls, *a, **kw)
        uc = torch.as_tensor(controls, dtype=torch.float32)

        def altered(x):
            u = pol(x)
            idx = (u[:, None, :] == uc.to(u.device)[None]).all(-1).float().argmax(-1)
            nxt = uc.to(u.device)[(idx + 1) % uc.shape[0]]
            every = (torch.arange(u.shape[0], device=u.device) % 4 == 0)[:, None]
            return torch.where(every, nxt, u)
        return altered

    monkeypatch.setattr(policy_mod, "make_implicit_policy", make)


FAULTS = {   # by the runner, ``<kind>.<solver>``
    "vi.fused": [step_unchanged, step_altered],
    "vi.dense": [dense_unchanged, dense_altered],
    "mpc.fused": [step_unchanged, step_altered, half_batch, control_altered],
    "rollout.dense": [dense_altered, half_batch, control_altered],
}


def _runner_of(name):
    _, _, cfg, mix, _ = run.load_cell(name)
    return f"{mix['kind']}.{cfg['solver']}"


CELLS = [w["name"] for w in run.load_json(run.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in FAULTS[_runner_of(c)]],
                         ids=lambda v: getattr(v, "__name__", v))
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    cfg, mix = small(name)
    result = run.run_cell(name, 2 ** 31 + 5, 0.2, False, CPU, cfg, mix)
    assert not result["correct"], result["checks"]
