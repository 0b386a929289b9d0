"""The port's stage gating (c3sc_tpu_torch.solvers.gating) against the JAX
package on the CPU, on ``tests/test_gating.py``'s cases, every call on
device "cpu".

The probe's common random numbers: JAX draws its Euler–Maruyama noise from
``jax.random.key(20_000 + seed)`` inside ``rollout``; the test rebuilds that
noise (``jax.random.split(key, n_steps)``, one normal draw per step) and
hands it to the port's ``make_greedy_probe(noise=...)``.

Bars: the same accept/reject decision at every gate; the sampled defects
within 1e-4 relative plus 1e-6 x max|v| (a sup of differences of float32
backups near the fixed point); probe costs within 1e-4 relative (the same
noise and the same greedy controls, up to float32 rounding of the states).
``probe_trim`` takes the same steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_testing import random_tt_numpy
from c3sc_tpu import models as jm
from c3sc_tpu.ops import tt as jtt
from c3sc_tpu.solvers import gating as jgate
from c3sc_tpu.solvers.dense import dense_vi as j_dense_vi
from c3sc_tpu.solvers.polish import level_correct as j_level
from c3sc_tpu.solvers.twogrid import _blend as j_blend
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import tt_from_numpy
from c3sc_tpu_torch.ops import tt as ttt
from c3sc_tpu_torch.solvers import gating as tgate
from c3sc_tpu_torch.solvers.polish import level_correct as t_level
from c3sc_tpu_torch.solvers.twogrid import _blend as t_blend

CPU = "cpu"
PROBE = dict(n_rollouts=16, n_steps=200)


def to_port(jt):
    return tt_from_numpy([np.asarray(c) for c in jt.cores], np.asarray(jt.ranks), CPU)


def jax_probe_noise(dw, n_rollouts, n_steps, seed=4242):
    """The noise JAX's probe draws inside its rollout, [n_steps, B, dw]."""
    keys = jax.random.split(jax.random.key(20_000 + seed), n_steps)
    return np.stack([np.asarray(jax.random.normal(k, (n_rollouts, dw), jnp.float32))
                     for k in keys])


@pytest.fixture(scope="module")
def pendulum_v():
    """tests/test_gating.py's fixture: the dense pendulum 31^2 solve as a TT
    (rank <= 20, padded to 24)."""
    jp, tp = jm.make_problem("pendulum"), tm.make_problem("pendulum")
    jg, tg = jp.default_grid(31), tp.default_grid(31)
    uc = jp.control_candidates(9)
    vd = np.asarray(j_dense_vi(jp, jg, controls=uc, tol=1e-6, max_outer=4000).v)
    v = jtt._repad(jtt.tt_from_dense(jnp.asarray(vd), rmax=20, tol=1e-7), 24)
    return jp, tp, jg, tg, uc, v


@pytest.fixture(scope="module")
def probes(pendulum_v):
    jp, tp, jg, tg, uc, _ = pendulum_v
    noise = jax_probe_noise(jp.dw, PROBE["n_rollouts"], PROBE["n_steps"])
    return (jgate.make_greedy_probe(jp, jg, uc, **PROBE),
            tgate.make_greedy_probe(tp, tg, uc, noise=noise, device=CPU, **PROBE))


def _same_record(a, b, vmax=20.0):
    """vmax: the fixture's max|v| (19.7)."""
    assert a.accepted == b.accepted
    np.testing.assert_allclose([b.bres_before, b.bres_after], [a.bres_before, a.bres_after],
                               rtol=1e-4, atol=1e-6 * vmax)
    if a.probe_before is not None:
        np.testing.assert_allclose([b.probe_before, b.probe_after],
                                   [a.probe_before, a.probe_after], rtol=1e-4)


def test_probe_x0_and_cost_match_jax(pendulum_v, probes):
    jp, tp, jg, tg, uc, v = pendulum_v
    rng = np.random.default_rng(4242)
    lbn, ubn = np.asarray(jp.lb), np.asarray(jp.ub)
    want_x0 = jnp.asarray((lbn + ubn) / 2 + 0.4 * (ubn - lbn) / 2
                          * rng.uniform(-1, 1, (16, jp.dx)), jnp.float32)
    np.testing.assert_array_equal(tgate.probe_x0(tp, 16, 4242), np.asarray(want_x0))
    jprobe, tprobe = probes
    np.testing.assert_allclose(tprobe(to_port(v)), jprobe(v), rtol=1e-4)


def test_gate_rejects_harmful_stage(pendulum_v):
    """A large random rank-4 perturbation (the same numpy TT on both sides)."""
    jp, tp, jg, tg, uc, v = pendulum_v
    cores, ranks = random_tt_numpy(jg.shape, [4], 24, seed=3)
    noise_j = jtt.TT(tuple(jnp.asarray(c) for c in cores), jnp.asarray(ranks))
    noise_t = tt_from_numpy(cores, ranks, CPU)
    jout, jrec = jgate.gated_apply(jp, jg, uc, v, lambda vt: jtt.tt_add(vt, noise_j),
                                   name="harmful")
    tv = to_port(v)
    tout, trec = tgate.gated_apply(tp, tg, uc, tv, lambda vt: ttt.tt_add(vt, noise_t),
                                   name="harmful")
    _same_record(jrec, trec)
    assert not trec.accepted and tout is tv and trec.bres_after > trec.bres_before


def test_gate_accepts_helpful_stage(pendulum_v):
    """level_correct of a value shifted by 3."""
    jp, tp, jg, tg, uc, v = pendulum_v
    jbad = jtt.tt_add(v, jtt.tt_constant(jg.shape, 3.0, 24))
    tbad = to_port(jbad)
    jout, jrec = jgate.gated_apply(
        jp, jg, uc, jbad, lambda vt: j_level(jp, jg, uc, vt, iters=4, chunk=8192)[0],
        name="level")
    tout, trec = tgate.gated_apply(
        tp, tg, uc, tbad, lambda vt: t_level(tp, tg, uc, vt, iters=4, chunk=8192)[0],
        name="level")
    _same_record(jrec, trec)
    assert trec.accepted and trec.bres_after < 0.7 * trec.bres_before


def test_probe_gate_catches_policy_damage(pendulum_v, probes):
    """A stage that zeroes the value fails the probe gate at a loose defect slack."""
    jp, tp, jg, tg, uc, v = pendulum_v
    jprobe, tprobe = probes
    jout, jrec = jgate.gated_apply(jp, jg, uc, v, lambda vt: jtt.tt_scale(vt, 0.0),
                                   name="zero", bres_slack=1e9, probe_fn=jprobe)
    tv = to_port(v)
    tout, trec = tgate.gated_apply(tp, tg, uc, tv, lambda vt: ttt.tt_scale(vt, 0.0),
                                   name="zero", bres_slack=1e9, probe_fn=tprobe)
    _same_record(jrec, trec)
    assert not trec.accepted and tout is tv


def test_probe_trim_matches_jax(pendulum_v, probes):
    """One round over the level and the omega ramp after an injected 6 %
    omega tilt (test_gating.py's case): the same steps and probe costs."""
    jp, tp, jg, tg, uc, v = pendulum_v
    jprobe, tprobe = probes
    nk = np.asarray(jg.nodes(1), np.float32)
    ramp = (nk - nk.mean()) / (nk.max() - nk.min())
    tilt = jtt.tt_rank1([jnp.ones(jg.shape[0], jnp.float32), jnp.asarray(ramp)], v.rmax)
    jbad = j_blend(v, tilt, jnp.asarray(0.06 * 21.0, jnp.float32))
    tbad = t_blend(to_port(v), to_port(tilt), 0.06 * 21.0)
    np.testing.assert_allclose(ttt.tt_full(tbad).numpy(), np.asarray(jtt.tt_full(jbad)),
                               rtol=0, atol=1e-4)
    jv, jh = jgate.probe_trim(jp, jg, uc, jbad, probe_fn=jprobe, dims=[1], rounds=1)
    tv, th = tgate.probe_trim(tp, tg, uc, to_port(jbad), probe_fn=tprobe, dims=[1], rounds=1)
    assert [h.get("stage") for h in th] == [h.get("stage") for h in jh]
    assert [h.get("delta") for h in th] == [h.get("delta") for h in jh]
    np.testing.assert_allclose([h["probe"] for h in th], [h["probe"] for h in jh], rtol=1e-4)
    assert th[-1]["probe"] <= th[0]["probe"]
