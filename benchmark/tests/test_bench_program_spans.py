"""The per-layer metrics that read the program's own spans
(``c3sc_tpu_torch.utils.metrics``), on the CPU: the small cells give a
number for each one the CPU path produces, the K2 and K3 readers split the
trace's busy time by the spans' shares, and each reads nothing, without
raising, from a program that has no spans (the parent of the change that
added them)."""

import pytest

from benchmark import run
from benchmark.tests.small import CPU, small

# the new metrics of each cell that its CPU path produces; the CPU captures no
# graph, so capture_ms.dense reads nothing there, and its trace holds no
# device operation, whose busy time the K2 and K3 readers split
ON_THE_CPU = {
    "quad6_tt31.vi": [],
    "quad6_dense11.vi": ["host_syncs.dense"],
    "quad6_dense11.rollout": ["policy_values_ms.rollout", "policy_argmin_ms.rollout",
                              "integrate_ms.rollout"],
}
NEW = ["fiber_backup_ms.vi", "core_fit_ms.vi", "policy_values_ms.rollout",
       "policy_argmin_ms.rollout", "integrate_ms.rollout", "capture_ms.dense", "host_syncs.dense"]


@pytest.mark.parametrize("name", sorted(ON_THE_CPU))
def test_program_span_metrics_on_the_cpu(name):
    from c3sc_tpu_torch.utils.metrics import reset, snapshot

    reset()      # one traced window a process in a run; several here
    cfg, mix = small(name)
    result = run.run_cell(name, 2 ** 31 + 91, 0.2, True, CPU, cfg, mix)
    got = result["metrics"]
    for metric in ON_THE_CPU[name]:
        assert isinstance(got[metric]["value"], float), (metric, got)
    if name == "quad6_dense11.vi":
        assert got["host_syncs.dense"]["value"] == 0.0     # no device to wait for
        assert "capture_ms.dense" not in got
    elif name == "quad6_tt31.vi":
        assert "fiber_backup_ms.vi" not in got and "core_fit_ms.vi" not in got
        spans = {r["name"]: r for r in snapshot()["spans"]}
        for tile in ("fiber_backup", "core_fit", "fused.rest"):
            assert spans[tile]["entries"] > 0 and spans[tile]["device_s"] > 0, spans
    else:
        assert all(got[metric]["value"] > 0 for metric in ON_THE_CPU[name])
    reset()


class _BusyTrace:
    """A traced window whose iterations kept the device busy 0.17 s."""

    @staticmethod
    def busy_s_in(name):
        return 0.17 if name == "iterations" else 0.0


@pytest.mark.parametrize("metric,share", [("fiber_backup_ms.vi", 0.3), ("core_fit_ms.vi", 0.65)])
def test_fused_split_scales_the_traced_busy_time(metric, share, monkeypatch):
    """K2's and K3's milliseconds are their spans' share of the harvested
    replays' time times the trace's busy time an iteration (17 ms for 10
    iterations here), whatever the events' own total, which the profiler
    stretches."""
    from c3sc_tpu_torch.utils import metrics

    def row(name, device_s):
        return dict(name=name, parent="fused.iteration", entries=4, host_s=0.0,
                    device_s=device_s, self_host_s=0.0, self_device_s=device_s)

    rows = [row("fused.iteration", 2.0) | {"parent": "fused.step", "self_device_s": 0.0},
            row("fiber_backup", 0.6), row("core_fit", 1.3), row("fused.rest", 0.1),
            row("fused.step", None) | {"parent": None}]
    monkeypatch.setattr(metrics, "snapshot", lambda: {"spans": rows})
    ctx = run.TraceContext(_BusyTrace(), {"iterations": 10}, {}, {})
    assert run.metric_reader(metric)(ctx) == pytest.approx(17.0 * share)
    assert run.metric_reader(metric)(run.TraceContext(_BusyTrace(), {}, {}, {})) is None


class _EmptyTrace:
    host = []

    @staticmethod
    def spans(name):
        return []


@pytest.mark.parametrize("metric", NEW)
def test_a_program_without_spans_reads_nothing(metric, monkeypatch):
    from c3sc_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "snapshot")
    ctx = run.TraceContext(_EmptyTrace(), {}, {}, {})
    assert run.metric_reader(metric)(ctx) is None
