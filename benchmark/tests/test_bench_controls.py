"""Each cell's control (the reference one precision below float32 in the
program's place, ``benchmark/controls.py``), small on the CPU, must fail
one of the cell's numbers against the cell's own limits."""

import pytest

from benchmark import controls, run
from benchmark.tests.small import CPU, small

CELLS = [w["name"] for w in run.load_json(run.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    _, _, _, _, limits = run.load_cell(name)
    cfg, mix = small(name)
    numbers, _ = controls.control(cfg, mix, 2 ** 31 + 3, 0.2, CPU)
    assert any(v > limits[k] for k, v in numbers.items()), numbers
