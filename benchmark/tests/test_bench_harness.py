"""The harness on the CPU: every cell found by name, the result line's
schema, the counts the metrics rest on, a new cell from data files alone,
and the reference against the port at a small size."""

import ast
import json
import pathlib
import shutil

import pytest
import torch

from benchmark import run
from benchmark.runners import active_backups
from benchmark.roofline.k1 import config_bounds_s
from benchmark.tests.small import CPU, small

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell, bench, cfg, mix, limits = run.load_cell(name)
    assert isinstance(run.module("runners", f"{mix['kind']}.{cfg['solver']}").RUNNER, type)
    assert callable(run.module("models", cfg["model"]).program)
    assert limits, f"benchmark/limits/{name}.json holds the limits of the cell's checks"
    for m in run.metrics_of(bench, name, "per_layer"):
        assert callable(run.metric_reader(m["name"]))
    names = {m["name"] for m in run.metrics_of(bench, name, "end_to_end")}
    assert "setup_s" in names and len(names) >= 2
    assert run.metrics_of(bench, name, "per_layer")


def test_every_metric_moves_a_metric_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


def test_backup_count_at_rank_16():
    ranks = [1, 16, 16, 16, 16, 16, 1]
    assert active_backups(ranks, ranks, (31,) * 6) == 2 * (496 + 4 * 7936 + 496) == 65472


def test_k1_roofline_from_shapes():
    b = config_bounds_s(run.load_json(run.HERE / "configs" / "quad6_dense11.json"))
    assert round(1e3 * b["dense_backup"], 4) == 0.0619
    assert round(1e3 * b["dense_evaluate"], 4) == 0.0430


def _schema(result, bench, name, trace):
    assert list(result)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert result["attempted"] > 0
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in result["device"]
    group = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in run.metrics_of(bench, name, group)}
    for k, v in result["metrics"].items():
        assert allowed[k] == v["unit"] and isinstance(v["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        for key in ("device_ops", "idle_gaps"):
            assert len(result["breakdown"][key]) <= 10
    else:
        assert set(result["metrics"]) == set(allowed)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_small_and_correct(name, trace):
    cfg, mix = small(name)
    result = run.run_cell(name, 2 ** 31 + 77, 0.2, bool(trace), CPU, cfg, mix)
    _schema(result, BENCH, name, trace)
    assert result["correct"], result["checks"]
    assert not run.forbidden_modules()


def _bench_copy(tmp_path, monkeypatch):
    """BENCHMARK.json and every folder the harness finds files in by name,
    copied under tmp_path, which the harness then reads in their place."""
    bench = json.loads(json.dumps(BENCH))
    dst = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics", "models", "runners"):
        shutil.copytree(run.HERE / sub, dst / sub)
    monkeypatch.setattr(run, "ROOT", tmp_path)
    monkeypatch.setattr(run, "HERE", dst)
    return bench, dst


def _add_cell(bench, dst, name, config, traffic, like, metrics=True):
    """A workloads entry for cell ``name`` with the limits of cell ``like``,
    and (with ``metrics``) in every metric of ``like``."""
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if metrics and like in m.get("workloads", []):
            m["workloads"].append(name)
    shutil.copy(dst / "limits" / f"{like}.json", dst / "limits" / f"{name}.json")
    (dst.parent / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_cell_needs_only_data_files(tmp_path, monkeypatch):
    """A cell of new sizes and a new mix: new data files and a workloads entry."""
    bench, dst = _bench_copy(tmp_path, monkeypatch)
    cfg = run.load_json(dst / "configs" / "quad6_dense11.json")
    cfg.update(grid_n=5)
    (dst / "configs" / "quad6_dense5.json").write_text(json.dumps(cfg))
    mix = run.load_json(dst / "traffic" / "vi.json")
    (dst / "traffic" / "vi_again.json").write_text(json.dumps(mix))
    _add_cell(bench, dst, "quad6_dense5.vi", "quad6_dense5", "vi_again", "quad6_dense11.vi")
    result = run.run_cell("quad6_dense5.vi", 5, 0.1, False, CPU)
    assert result["correct"] and set(result["metrics"]) == {"dense_solve_s", "setup_s"}


HEAVY_MODEL = """
import dataclasses

from benchmark.models import quadcopter6


def reference(cfg):
    return dataclasses.replace(quadcopter6.reference(cfg), mass=2 * cfg["problem"]["mass"])


def program(cfg):
    from c3sc_tpu_torch.models.quadcopter import make_quadcopter_problem

    return make_quadcopter_problem(**{**cfg["problem"], "mass": 2 * cfg["problem"]["mass"]})
"""

SOLVES_KIND = """
from benchmark.run import module


class Solves(module("runners", "vi.dense").RUNNER):
    def window(self, seconds):
        took = super().window(seconds)["dense_solve_s"]
        self.info["reference_mass"] = self.model.mass
        return {"solves_per_s": 1.0 / took}


RUNNER = Solves
"""


def test_new_model_and_kind_need_only_new_files(tmp_path, monkeypatch, capsys):
    """A new model (``models/<model>.py``) and a new kind of traffic
    (``runners/<kind>.<solver>.py``) with its own end-to-end metric: new
    files, a workloads entry and the metric's entry, no file edited."""
    bench, dst = _bench_copy(tmp_path, monkeypatch)
    (dst / "models" / "quadcopter6_heavy.py").write_text(HEAVY_MODEL)
    (dst / "runners" / "solves.dense.py").write_text(SOLVES_KIND)
    cfg = run.load_json(dst / "configs" / "quad6_dense11.json")
    cfg.update(model="quadcopter6_heavy", grid_n=5)
    (dst / "configs" / "heavy6_dense5.json").write_text(json.dumps(cfg))
    (dst / "traffic" / "solves.json").write_text(json.dumps({"kind": "solves"}))
    bench["end_to_end"].insert(0, {"name": "solves_per_s", "unit": "1/s", "better": "higher",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": ["heavy6_dense5.solves"]})
    _add_cell(bench, dst, "heavy6_dense5.solves", "heavy6_dense5", "solves", "quad6_dense11.vi",
              metrics=False)
    result = run.run_cell("heavy6_dense5.solves", 6, 0.1, False, CPU)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"solves_per_s", "setup_s"}
    info = [json.loads(line)["info"] for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"info"')]
    assert info[-1]["reference_mass"] == 2 * cfg["problem"]["mass"]


def test_an_unknown_model_is_an_error():
    cfg, mix = small("quad6_dense11.vi")
    cfg["model"] = "no_such_model"
    with pytest.raises(LookupError, match="benchmark/models/no_such_model.py"):
        run.run_cell("quad6_dense11.vi", 7, 0.1, False, CPU, cfg, mix)


@pytest.mark.parametrize("metric", ["idle_pct.vi", "idle_pct.dense", "idle_pct.mpc",
                                    "idle_pct.rollout"])
def test_forms_of_one_quantity_share_a_reader(metric):
    assert run.metric_reader(metric).__module__ == "bench_metrics_idle_pct"


def test_dense_sweep_against_the_port():
    """The reference's improve sweep and the port's (its plain version on the
    CPU) on one value agree to float32 rounding."""
    from benchmark.runners import Runner
    from benchmark.reference import bellman
    from c3sc_tpu_torch.ops.dense_backup import dense_backup, make_dense_operands

    cfg, _ = small("quad6_dense11.vi")
    runner = Runner(cfg, {}, 0, CPU)
    prob, grid, controls = runner.program()
    ops = make_dense_operands(prob, grid, controls, CPU)
    v = torch.rand(grid.shape, generator=torch.Generator().manual_seed(1)) * 100
    port, _ = dense_backup(ops, v)
    ref, _ = bellman.dense_sweep(runner.model, runner.ref_grid, v.reshape(-1).double(),
                                 runner.uc_ref.double())
    assert torch.allclose(port.reshape(-1).double(), ref, rtol=1e-5, atol=1e-4)


def test_reference_imports_nothing_of_the_program():
    """benchmark/reference/ imports nothing whose top-level name is the port's
    or the JAX package's, and no benchmark file imports JAX or its package."""
    def imported(path):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                yield from (a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                yield node.module.split(".")[0]

    for path in (run.HERE / "reference").glob("*.py"):
        assert not set(imported(path)) & {"c3sc_tpu_torch", "c3sc_tpu", "jax"}, path
    for path in run.HERE.rglob("*.py"):
        assert not set(imported(path)) & set(run.FORBIDDEN), path


def test_without_a_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_paths_hold_the_benchmark_alone():
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    for c in BENCH["configs"]:
        assert pathlib.Path(run.ROOT / c["file"]).is_file()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_small_on_the_card(name, card):
    """The cell's timed path on the card (graphed, K1's kernels), small."""
    cfg, mix = small(name)
    if cfg["solver"] == "fused":
        cfg["cuda_graph"] = True
    result = run.run_cell(name, 2 ** 31 + 78, 0.5, False, card, cfg, mix)
    _schema(result, BENCH, name, False)
    assert result["correct"], result["checks"]
