"""The port's registry CLI (``python -m c3sc_tpu_torch.cli``) with ``--cpu``:
the two flows of tests/test_cli.py at LQ 21^2, rank 8, at most 150
iterations a solve (tests/test_torch_cli.py holds the dense path against the
JAX CLI).

Bars, each stated at its test: the fused run with rollouts, resume from
``solver_state.npz`` (iterations >= the first run's), warm start from
``vf.npz``; ``--save-format c3tt --policy-basis poly`` (the file reloads to
the active cores exactly), warm start from ``vf.c3tt``; strict-JSON
``metrics.jsonl``; the JAX CLI's summary keys.
"""

import torch_port_testing  # noqa: F401  (first: pins torch's threads)

import json
import os

import numpy as np

from c3sc_tpu_torch import cli
from c3sc_tpu_torch.native import have_native, tt_load_binary, tt_to_active
from c3sc_tpu_torch.utils import load_solver_state

FUSED = ["lq", "--n", "21", "--solver", "fused", "--rmax", "8", "--cpu"]


def _strict_json(path):
    for line in open(path):
        json.loads(line)
        assert "Infinity" not in line and "NaN" not in line


def test_fused_solve_and_load_modes(tmp_path):
    out = str(tmp_path / "run")
    s = cli.main(FUSED + ["--max-iters", "120", "--save-every", "50", "--rollouts", "8",
                          "--steps", "50", "--outdir", out])
    assert set(s) == {"solver", "residual", "iterations", "ranks", "wall", "solve_wall_s",
                      "rollouts", "mean_cost", "rollout_wall_s"}
    assert s["solver"] == "fused" and np.isfinite(s["residual"]) and np.isfinite(s["mean_cost"])
    for f in ("vf.npz", "solver_state.npz", "traj.npz", "metrics.jsonl"):
        assert os.path.exists(os.path.join(out, f)), f
    _strict_json(os.path.join(out, "metrics.jsonl"))
    assert np.load(os.path.join(out, "traj.npz"))["xs"].shape == (51, 8, 2)
    s2 = cli.main(FUSED + ["--max-iters", "150", "--outdir", str(tmp_path / "resume"),
                           "--load", os.path.join(out, "solver_state.npz")])
    assert s2["iterations"] >= s["iterations"]
    s3 = cli.main(FUSED + ["--max-iters", "150", "--outdir", str(tmp_path / "warm"),
                           "--load", os.path.join(out, "vf.npz")])
    assert np.isfinite(s3["residual"])


def test_c3tt_format_and_poly_policy(tmp_path):
    out = str(tmp_path / "c3tt")
    s = cli.main(FUSED + ["--max-iters", "150", "--rollouts", "8", "--steps", "50",
                          "--outdir", out, "--save-format", "c3tt", "--policy-basis", "poly"])
    tt_path = os.path.join(out, "vf.c3tt")
    assert s["c3tt_file"] == tt_path and os.path.exists(tt_path)
    assert s["c3tt_native"] is have_native() and np.isfinite(s["mean_cost"])
    v = load_solver_state(os.path.join(out, "vf.npz"), "cpu")["v"]
    for a, b in zip(tt_load_binary(tt_path), tt_to_active(v)):
        np.testing.assert_array_equal(a, b)
    s2 = cli.main(FUSED + ["--max-iters", "100", "--outdir", str(tmp_path / "from_c3tt"),
                           "--load", tt_path])
    assert np.isfinite(s2["residual"])
