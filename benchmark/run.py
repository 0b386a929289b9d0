"""Run one cell of the port's benchmark once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is looked up by name in
``BENCHMARK.json``; its configuration (``benchmark/configs/<config>.json``),
traffic mix (``benchmark/traffic/<traffic>.json``), model
(``benchmark/models/<model>.py``, by the configuration's ``model``), runner
(``benchmark/runners/<kind>.<solver>.py``, by the mix's ``kind`` and the
configuration's ``solver``), per-layer metric readers
(``benchmark/metrics/<metric>.py``) and the limits of its checks
(``benchmark/limits/<cell>.json``) are found by name.

With ``--trace 0`` the run sets up, measures the window for ``--seconds``
and reports the cell's end-to-end metrics; with ``--trace 1`` it sets up,
traces a short steady piece of the same work and reports the per-layer
metrics. Both then free the program's state and check what the timed path
produced against the plain reference. The last line of standard output is
the result; the checks' numbers and limits are the last lines of standard
error. Without a CUDA card (or with fewer than the cell asks for) the run
fails and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "c3sc_tpu")


def cache_dirs():
    """Every build and kernel cache at a fixed place inside the checkout."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str):
    """(the workload entry named ``name``, BENCHMARK.json)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell, bench
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def module(folder: str, name: str):
    """The module of ``benchmark/<folder>/<name>.py``, found by name; a name
    with no file is an error that names the file it looked for."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {path.relative_to(HERE.parent)}: nothing in benchmark/{folder}/ "
                          f"is named {name!r}")
    key = f"bench_{folder}_{name}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(ctx)`` of ``benchmark/metrics/<name>.py``, or, where there is
    no such file, of the reader that the forms of one quantity in several
    cells share: ``<quantity>.py`` for ``<quantity>.<cell>``."""
    quantity = name.split(".")[0]
    if not (HERE / "metrics" / f"{name}.py").is_file() and quantity != name:
        name = quantity
    return module("metrics", name).read


def metrics_of(bench: dict, cell: str, group: str) -> list:
    """The cell's metrics of one group, in BENCHMARK.json's order."""
    return [m for m in bench[group] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class TraceContext:
    """What a per-layer metric reader reads: the traced window, the counts of
    the traced work, the configuration and the traffic mix."""

    def __init__(self, trace, counts, cfg, mix):
        self.trace, self.counts, self.cfg, self.mix = trace, counts, cfg, mix


def load_cell(name: str):
    """(cell, BENCHMARK.json, configuration, traffic mix, limits) of a cell."""
    cell, bench = find_cell(name)
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits_path = HERE / "limits" / f"{cell['name']}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return cell, bench, cfg, mix, limits


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, cfg=None, mix=None,
             t_start: float = T_START) -> dict:
    """One run of a cell on ``device``: set-up, the window (or the traced
    piece), the check; returns the result line's object. ``cfg`` and ``mix``
    replace the cell's files (the tests run the cells small on the CPU)."""
    import torch

    from benchmark.runners import Parts, make_runner
    from benchmark.trace import TracedWindow

    cell, bench, cfg0, mix0, limits = load_cell(name)
    cfg, mix = cfg or cfg0, mix or mix0
    parts = Parts()
    parts.parts["python"] = parts._t - t_start
    runner = make_runner(cfg, mix, seed, device)
    runner.setup(parts)
    setup_s = time.perf_counter() - t_start
    print(json.dumps({"setup_parts_s": parts.parts, "setup_s": setup_s}), flush=True)

    cuda = device.type == "cuda"
    metrics = {}
    device_out = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1}
    breakdown = None
    if trace:
        with TracedWindow() as tw:
            counts = runner.traced()
        ctx = TraceContext(tw, counts, cfg, mix)
        for m in metrics_of(bench, cell["name"], "per_layer"):
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_out.update(busy_s=tw.busy_s, window_s=tw.window_s)
        breakdown = tw.breakdown()
        runner.info.update(traced=counts)
    else:
        e2e = runner.window(seconds)
        e2e["setup_s"] = setup_s
        for m in metrics_of(bench, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device_out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0

    runner.release()
    t_check = time.perf_counter()
    numbers = runner.check()
    print(json.dumps({"info": runner.info}), flush=True)
    compared = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    correct = all(c["limit"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in compared.values())
    print(f"check took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    result = {"correct": correct, "attempted": runner.attempted, "failed": 0 if correct else 1,
              "metrics": metrics, "device": device_out}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    cell = find_cell(args.workload)[0]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), dev)
    found = forbidden_modules()
    if found:
        print(f"modules of the JAX package or of JAX are loaded: {found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        ok = c["limit"] is not None and c["value"] <= c["limit"]
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
