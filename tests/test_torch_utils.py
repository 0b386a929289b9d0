"""The port's utilities (c3sc_tpu_torch.utils: metrics, checkpoints, NaN
checks) against the JAX package's (c3sc_tpu.utils) on the CPU.

Bars, each stated at its test: the same records give the same JSONL lines
but for ``t``, strict JSON (non-finite values null); a checkpoint either
package writes loads in the other field for field (arrays equal, each
package casting to its own dtypes), a context mismatch raises ValueError
in both, and the JAX package's ``key_data`` is the one field the port does
not read (its own stream state travels in ``meta["seed_stream"]``, which
the JAX loader ignores); the debug context turns anomaly mode on with NaN
checks and restores the mode before it.
"""

from torch_port_testing import random_tt_numpy, to_numpy  # first: pins torch's threads

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3sc_tpu import models as jm
from c3sc_tpu.ops.cross import CrossState as JCrossState
from c3sc_tpu.ops.tt import TT as JTT
from c3sc_tpu.solvers import fused as jf
from c3sc_tpu.utils import checkpoint as jck
from c3sc_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import tt_from_numpy
from c3sc_tpu_torch.ops.cross import CrossState
from c3sc_tpu_torch.solvers import make_fused_vi
from c3sc_tpu_torch.utils import checkpoint as tck
from c3sc_tpu_torch.utils import debug
from c3sc_tpu_torch.utils.metrics import MetricsLogger

CPU = "cpu"


def test_metrics_lines_match_jax(tmp_path):
    recs = [("vi_iter", dict(iter=0, residual=0.5, ranks=[1, 3, 1])),
            ("vi_iter", dict(iter=1, residual=float("inf"), nested={"a": [float("nan"), 2.0]})),
            ("summary", dict(solver="fused", ok=True, mean_cost=float("-inf")))]
    lines = {}
    for name, cls in (("port", MetricsLogger), ("jax", JMetricsLogger)):
        m = cls(str(tmp_path / f"{name}.jsonl"))
        for phase, fields in recs:
            m.log(phase, **fields)
        m.close()
        lines[name] = [json.loads(line) for line in open(tmp_path / f"{name}.jsonl")]
        for line in open(tmp_path / f"{name}.jsonl"):
            assert "Infinity" not in line and "NaN" not in line
    for a, b in zip(lines["port"], lines["jax"]):
        a.pop("t"), b.pop("t")
        assert a == b
    assert len(lines["port"]) == 3 and lines["port"][1]["residual"] is None
    mem = MetricsLogger()
    assert mem.log("x", v=float("inf"))["v"] == float("inf")     # records keep the floats


def _tt_pair(seed=3):
    cores, rk = random_tt_numpy((5, 6, 7), (2, 3), 4, seed)
    return JTT(tuple(jnp.asarray(c) for c in cores), jnp.asarray(rk)), tt_from_numpy(cores, rk,
                                                                                      CPU)


def test_solver_state_files_move_between_packages(tmp_path):
    jv, tv = _tt_pair()
    rng = np.random.default_rng(0)
    left = [rng.integers(0, 5, (3, 3)) for _ in range(4)]
    right = [rng.integers(0, 5, (3, 3)) for _ in range(4)]
    tck.save_solver_state(str(tmp_path / "p.npz"), tv, CrossState(left, right), 7,
                          stream={"position": 3}, extras={"a": 1})
    jck.save_solver_state(str(tmp_path / "j.npz"), jv, JCrossState(left, right), 7,
                          key=jax.random.key(9), extras={"a": 1})
    from_port = jck.load_solver_state(str(tmp_path / "p.npz"))
    from_jax = tck.load_solver_state(str(tmp_path / "j.npz"), CPU)
    own = tck.load_solver_state(str(tmp_path / "p.npz"), CPU)
    for out in (from_port, from_jax, own):
        assert out["iteration"] == 7 and out["extras"] == {"a": 1}
        for a, b in zip(out["v"].cores, tv.cores):
            np.testing.assert_array_equal(to_numpy(a), b.numpy())
        np.testing.assert_array_equal(to_numpy(out["v"].ranks), tv.ranks.numpy())
        for a, b in zip(out["state"].left + out["state"].right, left + right):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert "key" not in from_port and "key_data" in np.load(tmp_path / "j.npz").files
    assert own["seed_stream"] == {"position": 3} and "seed_stream" not in from_jax
    assert own["v"].ranks.dtype == torch.int32 and own["state"].left[0].dtype == np.int64


def _carries():
    """A JAX carry and a port carry, each after 3 iterations of LQ 11^2 at
    rank 4 from its package's own init."""
    jp, tp = jm.make_problem("lq"), tm.make_problem("lq")
    jg, tg = jp.default_grid(11), tp.default_grid(11)
    uc = jp.control_candidates(5)
    js = jf.make_fused_vi(jp, jg, uc, rmax=4)
    ts = make_fused_vi(tp, tg, uc, rmax=4, device=CPU)
    return (jp, jg, js.step_fn(js.init_fn(jax.random.key(0)), 3),
            tp, tg, ts.step_fn(ts.init_fn(0), 3))


def _same_carry(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, tuple):
            for p, q in zip(x, y):
                np.testing.assert_array_equal(to_numpy(p), to_numpy(q))
        else:
            np.testing.assert_array_equal(to_numpy(x), to_numpy(y), err_msg=name)


def test_fused_carry_files_move_between_packages(tmp_path):
    jp, jg, jc, tp, tg, tc = _carries()
    ctx = tck.fused_context(tp, tg, 4)
    assert ctx == jck.fused_context(jp, jg, 4)
    tck.save_fused_carry(str(tmp_path / "p"), tc, ctx, stream={"rng": {"x": 1}})
    jck.save_fused_carry(str(tmp_path / "j"), jc, ctx)
    assert sorted(os.listdir(tmp_path)) == ["j.npz", "p.npz"]     # the renames are atomic
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert sorted(p.files) == sorted(j.files)
    for path in ("p.npz", "j.npz"):
        assert tck.is_fused_checkpoint(str(tmp_path / path))
        assert jck.is_fused_checkpoint(str(tmp_path / path))
    _same_carry(jck.load_fused_carry(str(tmp_path / "p.npz"), expect=ctx), tc)
    from_jax = tck.load_fused_carry(str(tmp_path / "j.npz"), expect=ctx, device=CPU)
    _same_carry(from_jax, jc)
    assert from_jax.left.dtype == torch.int64 and from_jax.ranks.dtype == torch.int32
    assert tck.checkpoint_seed_stream(str(tmp_path / "p.npz")) == {"rng": {"x": 1}}
    assert tck.checkpoint_seed_stream(str(tmp_path / "j.npz")) is None
    other = dict(ctx, problem="pendulum")
    with pytest.raises(ValueError, match="mismatch"):
        tck.load_fused_carry(str(tmp_path / "j.npz"), expect=other, device=CPU)
    with pytest.raises(ValueError, match="mismatch"):
        jck.load_fused_carry(str(tmp_path / "p.npz"), expect=other)
    jck.save_solver_state(str(tmp_path / "plain.npz"), JTT(jc.cores, jc.ranks), None, 3)
    assert not tck.is_fused_checkpoint(str(tmp_path / "plain.npz"))
    with pytest.raises(ValueError, match="not a fused solver checkpoint"):
        tck.load_fused_carry(str(tmp_path / "plain.npz"), device=CPU)


def test_debug_context_turns_anomaly_mode_on_and_restores_it():
    assert not torch.is_anomaly_enabled()
    with debug.debug_context():
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError):
            torch.sqrt(x - 1.0).backward()       # a NaN gradient is trapped
    assert not torch.is_anomaly_enabled()
    debug.enable_nan_checks()
    try:
        with debug.debug_context():
            pass
        assert torch.is_anomaly_enabled()        # the mode before is what returns
    finally:
        debug.disable_nan_checks()
    assert not torch.is_anomaly_enabled()
