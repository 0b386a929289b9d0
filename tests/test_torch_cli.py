"""The port's registry CLI (``python -m c3sc_tpu_torch.cli``) and its
per-system examples, with ``--cpu``, against the JAX CLI.

Bars, each stated at its test:
  (a) ``lq --n 21 --solver dense``: ``vf.npz`` within 1e-4 x max|v| of the
      JAX CLI's, and the same summary keys;
  (b) the tt and pi solvers at LQ 11^2 (their checkpoint and resume), and
      the dense solver's refusal above dx = 3 (the flows of
      tests/test_cli.py: tests/test_torch_cli_flows.py);
  (c) each example forwards its system name; without ``--cpu`` the CLI
      computes on the card (here, with none, torch raises).
"""

import torch_port_testing  # noqa: F401  (first: pins torch's threads)

import importlib
import json

import numpy as np
import pytest

from c3sc_tpu.cli import main as jax_main
from c3sc_tpu_torch import cli
from c3sc_tpu_torch.utils import load_solver_state



def _strict_json(path):
    for line in open(path):
        json.loads(line)
        assert "Infinity" not in line and "NaN" not in line


def test_dense_matches_the_jax_cli(tmp_path):
    args = ["lq", "--n", "21", "--solver", "dense", "--cpu"]
    s = cli.main(args + ["--outdir", str(tmp_path / "port")])
    js = jax_main(args + ["--outdir", str(tmp_path / "jax")])
    assert set(s) == set(js)
    got, want = (np.load(tmp_path / d / "vf.npz")["v"] for d in ("port", "jax"))
    assert got.shape == want.shape == (21, 21)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    _strict_json(tmp_path / "port" / "metrics.jsonl")


def test_tt_and_pi_solvers(tmp_path):
    s = cli.main(["lq", "--n", "11", "--solver", "tt", "--rmax", "6", "--max-iters", "4",
                  "--save-every", "2", "--cpu", "--outdir", str(tmp_path / "tt")])
    assert set(s) >= {"solver", "residual", "iterations", "evals", "ranks", "wall"}
    assert load_solver_state(str(tmp_path / "tt" / "vf.npz"), "cpu")["iteration"] == 3
    s2 = cli.main(["lq", "--n", "11", "--solver", "tt", "--rmax", "6", "--max-iters", "6",
                   "--cpu", "--outdir", str(tmp_path / "tt2"),
                   "--load", str(tmp_path / "tt" / "vf.npz")])
    assert s2["iterations"] == 6
    p = cli.main(["lq", "--n", "11", "--solver", "pi", "--rmax", "6", "--max-iters", "1",
                  "--cpu", "--outdir", str(tmp_path / "pi")])
    assert p["solver"] == "pi" and p["outer_iters"] == 1
    with pytest.raises(SystemExit):
        cli.main(["quadcopter", "--solver", "dense", "--cpu", "--outdir", str(tmp_path / "q")])


def test_runs_on_the_card_unless_cpu(tmp_path):
    """Without ``--cpu`` the CLI computes on the CUDA device: with no card,
    torch raises (nothing carries on on the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run on it")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["lq", "--n", "5", "--solver", "dense", "--outdir", str(tmp_path)])


@pytest.mark.parametrize("system", ["lq", "pendulum", "dubins", "glider", "quadcopter"])
def test_examples_forward_their_system(system, monkeypatch):
    mod = importlib.import_module(f"c3sc_tpu_torch.examples.{system}")
    seen = []
    monkeypatch.setattr(cli, "main", lambda argv: seen.append(argv) or "ran")
    assert mod.main(["--n", "5"]) == "ran"
    assert seen == [[system, "--n", "5"]]
