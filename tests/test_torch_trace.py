"""The port's spans (``c3sc_tpu_torch.utils.metrics``): off, they record
nothing and enter no profiler range; under ``tracing()`` they aggregate
entries and self time by (name, parent), host-only spans without device
time; under ``torch.profiler`` they are user annotations; a graph's
harvested replay adds its root to the host span it ran under; the fused
iteration, the closed loop and ``dense_vi`` record the spans their readers
count. On the card: timing events captured into a CUDA graph read after a
replay, the graphed fused iteration's tiles take the time of a replay timed
apart from them, and harvesting its events adds no synchronize.

Bars, each stated at its test. Sizes: the pendulum on 9^2, the quadcopter
on 5^6 at rank 4; every case takes seconds.
"""

from torch_port_testing import QUAD  # first: pins torch's threads

import gc
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from c3sc_tpu_torch.models import make_problem
from c3sc_tpu_torch.models.quadcopter import make_quadcopter_problem
from c3sc_tpu_torch.sim.integrators import rollout
from c3sc_tpu_torch.sim.policy import make_implicit_policy
from c3sc_tpu_torch.solvers import fused, make_fused_vi
from c3sc_tpu_torch.solvers.dense import dense_vi
from c3sc_tpu_torch.utils import metrics
from c3sc_tpu_torch.utils.metrics import reset, snapshot, span, tracing

SYNC_NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
TILES = ("fiber_backup", "core_fit", "fused.rest")


@pytest.fixture(autouse=True)
def _fresh():
    reset()
    yield
    reset()


def rows(name=None):
    """The snapshot's rows, by (name, parent); only ``name``'s with it."""
    return {(r["name"], r["parent"]): r for r in snapshot()["spans"]
            if name is None or r["name"] == name}


def entries(name):
    return sum(r["entries"] for r in rows(name).values())


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    """With no profiler and no ``tracing()``, a span is the same null context
    each time: no aggregate, no ``record_function``, no event."""
    entered = []
    real = torch.autograd.profiler.record_function
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: entered.append("event"))
    assert span("a") is span("b")
    with span("a"):
        with span("b"):
            torch.ones(3).sum()
    assert snapshot() == {"spans": []} and entered == []


def test_nested_spans_entries_and_self_time():
    """Under ``tracing()`` each (name, parent) counts its entries; a span's
    self time is its time less its children's (host time is the device's
    on the CPU)."""
    with tracing():
        for _ in range(2):
            with span("outer"):
                time.sleep(0.02)
                for _ in range(3):
                    with span("inner"):
                        time.sleep(0.01)
        with span("inner"):
            pass
    got = rows()
    outer, inner = got[("outer", None)], got[("inner", "outer")]
    assert outer["entries"] == 2 and inner["entries"] == 6 and got[("inner", None)]["entries"] == 1
    assert inner["host_s"] >= 0.06 and outer["host_s"] >= 0.1
    assert outer["self_host_s"] == pytest.approx(outer["host_s"] - inner["host_s"])
    assert 0.04 <= outer["self_host_s"] < outer["host_s"] - 0.05
    assert inner["self_host_s"] == inner["host_s"]
    for r in got.values():
        assert r["device_s"] == r["host_s"]
    reset()
    assert snapshot() == {"spans": []}


def test_host_only_spans_take_no_device_time():
    """A span of ``device=False`` records entries and host time, and no
    device time (None), itself or as its self time; its device-timed
    children keep theirs."""
    with tracing():
        with span("solve", device=False):
            with span("sweep"):
                time.sleep(0.01)
            with span("read", device=False):
                pass
    got = rows()
    solve, sweep, read = got[("solve", None)], got[("sweep", "solve")], got[("read", "solve")]
    assert solve["entries"] == sweep["entries"] == read["entries"] == 1
    assert solve["host_s"] >= sweep["host_s"] >= 0.01
    assert solve["device_s"] is solve["self_device_s"] is read["device_s"] is None
    assert sweep["device_s"] == sweep["host_s"]


class _Stamp:
    """A completed timing event stamped at ``t`` seconds."""

    def __init__(self, t):
        self.t = t

    def query(self):
        return True

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def test_graph_harvest_adds_the_root_to_its_parent():
    """A harvested replay counts one entry of its root, under the host span
    its replays were launched in, and of each tile, under the root; the
    root's time is its parent's children's, so the parent's self time
    leaves it out."""
    g = metrics.GraphSpans()
    g.events = [_Stamp(t) for t in (0.0, 0.002, 0.005, 0.006)]
    g.root = ["fused.iteration", 0, 3]
    g.tiles = [["fiber_backup", 0, 1], ["core_fit", 1, 2], ["fused.rest", 2, 3]]
    with tracing():
        with span("fused.step"):
            time.sleep(0.01)
            g.replayed()
        g.harvest()
        g.harvest()         # nothing new to harvest
    got = rows()
    step, it = got[("fused.step", None)], got[("fused.iteration", "fused.step")]
    assert it["entries"] == 1 and it["device_s"] == pytest.approx(0.006)
    assert it["self_device_s"] == pytest.approx(0.0, abs=1e-12)
    assert step["self_device_s"] == pytest.approx(step["device_s"] - 0.006)
    for tile, t in (("fiber_backup", 0.002), ("core_fit", 0.003), ("fused.rest", 0.001)):
        assert got[(tile, "fused.iteration")]["entries"] == 1
        assert got[(tile, "fused.iteration")]["device_s"] == pytest.approx(t)


def test_spans_are_user_annotations_under_the_profiler():
    """A profiler turns recording on: the spans are ``record_function``
    ranges in its events, nested as entered, and aggregated as well."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with span("inner"):
                torch.ones(8).sum()
    ev = {e.name: e for e in prof.events() if e.name in ("outer", "inner")}
    assert ev["outer"].is_user_annotation and ev["inner"].is_user_annotation
    assert ev["outer"].time_range.start <= ev["inner"].time_range.start
    assert ev["inner"].time_range.end <= ev["outer"].time_range.end
    assert set(rows()) == {("outer", None), ("inner", "outer")}


def _small_fused(cuda_graph=False, device="cpu"):
    prob = make_quadcopter_problem(**QUAD)
    grid = prob.default_grid(5)
    solver = make_fused_vi(prob, grid, prob.control_candidates(3), rmax=4, tol=0.0,
                           max_iters=10 ** 6, device=device, cuda_graph=cuda_graph)
    return prob, solver, solver.init_fn(0)


class _OutsideTiles(TorchDispatchMode):
    """Operators dispatched inside ``fused.iteration`` but in none of its
    tiles; views (an argument's ``left[k]``), which launch nothing, aside."""

    def __init__(self):
        super().__init__()
        self.outside = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        names = [f.key[0] for f in metrics.REGISTRY.stack()]
        if names and names[-1] == "fused.iteration" and not func.is_view:
            self.outside.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("fn", ["step_fn", "run_fn"])
def test_eager_fused_iteration_spans(fn):
    """An eager iteration at d = 6 is one ``fused.iteration`` under
    ``fused.step``, with 2d ``fiber_backup`` (K2: every core of both half
    sweeps) and 2(d - 1) ``core_fit`` (K3) in it, and every operator it
    dispatches inside one of the tiles ``fiber_backup``, ``core_fit``,
    ``fused.rest``: what the graphed iteration's one event a boundary needs."""
    prob, solver, carry = _small_fused()
    d, n = prob.dx, 2
    carry = solver.step_fn(carry, 1)
    with tracing(), _OutsideTiles() as mode:
        getattr(solver, fn)(carry, n)
    assert mode.outside == []
    got = rows()
    assert got[("fused.step", None)]["entries"] == 1
    assert got[("fused.iteration", "fused.step")]["entries"] == n
    assert got[("fiber_backup", "fused.iteration")]["entries"] == 2 * d * n
    assert got[("core_fit", "fused.iteration")]["entries"] == 2 * (d - 1) * n
    assert got[("fused.rest", "fused.iteration")]["entries"] >= 3 * n
    it = got[("fused.iteration", "fused.step")]
    tiles = sum(got[(t, "fused.iteration")]["device_s"] for t in TILES)
    assert tiles == pytest.approx(it["device_s"] - it["self_device_s"])


def test_rollout_spans_per_step():
    """A closed loop records, each step, one ``policy`` with one
    ``policy.values`` and one ``policy.argmin`` in it, and one ``integrate``."""
    prob = make_problem("pendulum")
    grid = prob.default_grid(9)
    uc = torch.as_tensor(np.asarray(prob.control_candidates(5)), dtype=torch.float32)
    policy = make_implicit_policy(prob, grid, lambda p: (p ** 2).sum(-1), uc)
    x0 = torch.zeros((4, prob.dx)) + 0.1
    steps = 5
    with tracing(), torch.no_grad():
        rollout(prob, grid, policy, x0, 0.01, steps, noise=torch.zeros((steps, 4, prob.dw)))
    got = rows()
    assert {k: r["entries"] for k, r in got.items()} == {
        ("policy", None): steps, ("policy.values", "policy"): steps,
        ("policy.argmin", "policy"): steps, ("integrate", None): steps}


def test_dense_vi_spans():
    """A CPU ``dense_vi`` records ``dense_vi`` once, with ``dense.operands``
    once, ``dense.sweeps`` once a chunk and ``dense.read`` once or twice a
    chunk (the residual, and the scale unless the solve stops there) in it;
    no capture on the CPU."""
    prob = make_problem("pendulum")
    grid = prob.default_grid(9)
    with tracing():
        sol = dense_vi(prob, grid, n_controls=5, tol=1e-30, max_outer=12, chunk=4,
                       device="cpu")
    chunks = len(sol.residual_history)
    got = rows()
    assert got[("dense_vi", None)]["entries"] == 1
    assert got[("dense.operands", "dense_vi")]["entries"] == 1
    assert got[("dense.sweeps", "dense_vi")]["entries"] == chunks == 3
    assert chunks <= got[("dense.read", "dense_vi")]["entries"] <= 2 * chunks
    assert entries("dense.capture") == 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_timing_events_captured_into_a_graph():
    """Timing events recorded while a 3-kernel graph is captured (external
    events) are re-stamped by every replay: each replay's elapsed times are
    positive and add up to its first-to-last time."""
    dev = _card()
    x = torch.randn(1 << 20, device=dev)
    ev = [torch.cuda.Event(enable_timing=True, external=True) for _ in range(4)]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        torch.sin(x * 2 + 1)
    torch.cuda.current_stream(dev).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        ev[0].record()
        a = x * 2
        ev[1].record()
        b = a + 1
        ev[2].record()
        torch.sin(b)
        ev[3].record()
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize(dev)
        assert ev[3].query()
        parts = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        assert min(parts) > 0
        assert sum(parts) == pytest.approx(ev[0].elapsed_time(ev[3]), abs=2e-3)


@pytest.mark.cuda
def test_eager_spans_record_their_events_again(monkeypatch):
    """A span records the timing events of a span already read: twenty spans,
    each waited for, make at most two pairs of events, and each span's
    device time is counted."""
    dev = _card()
    made, real = [], torch.cuda.Event
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1) or real(*a, **k))
    x = torch.zeros(1 << 20, device=dev)
    with tracing():
        for _ in range(20):
            with span("add"):
                x.add_(1)
            torch.cuda.synchronize(dev)
    add = rows()[("add", None)]
    assert add["entries"] == 20 and add["device_s"] > 0
    assert len(made) <= 4


def _graphed_iterations():
    return {id(o): o for o in gc.get_objects() if isinstance(o, fused._GraphedIteration)}


@pytest.mark.cuda
def test_graphed_iteration_tiles_cover_the_replay():
    """In a graphed iteration each tile (K2, K3, the rest) of the harvested
    replays takes time, and their sum a replay is within 2 % of a replay of
    the same graph timed apart from the spans: CUDA events around it,
    launched behind a sleep of the device, so that the host's launch is not
    timed. A call harvests the previous call's last replay: one a call
    here, since each call ends on a synchronize."""
    dev = _card()
    before = _graphed_iterations()
    _, solver, carry = _small_fused(cuda_graph=True, device=dev)
    carry = solver.step_fn(carry, 2)
    torch.cuda.synchronize(dev)
    graphed, = [g for k, g in _graphed_iterations().items() if k not in before]
    reset()
    calls = 4
    with tracing():
        for _ in range(calls):
            carry = solver.step_fn(carry, 2)
            torch.cuda.synchronize(dev)
    got = rows()
    it = got[("fused.iteration", "fused.step")]
    assert it["entries"] == calls
    tiles = {t: got[(t, "fused.iteration")] for t in TILES}
    assert tiles["fiber_backup"]["entries"] == 12 * calls
    assert tiles["core_fit"]["entries"] == 10 * calls
    assert all(t["device_s"] > 0 for t in tiles.values())
    per_replay = sum(t["device_s"] for t in tiles.values()) / calls
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    apart = []
    for _ in range(3):
        torch.cuda._sleep(50_000_000)
        start.record()
        graphed.traced.replay()
        end.record()
        torch.cuda.synchronize(dev)
        apart.append(start.elapsed_time(end) / 1e3)
    assert abs(per_replay - min(apart)) <= 0.02 * min(apart), (per_replay, apart)


def _syncs_in_graphed_calls(solver, carry, dev, recording: bool):
    """Host syncs inside four graphed calls under the profiler (three back to
    back, then one after a synchronize, which harvests the third's replay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if not recording:
            torch.autograd.profiler._is_profiler_enabled = False   # the flag spans follow
        with record_function("calls"):
            for _ in range(3):
                carry = solver.step_fn(carry, 2)
        torch.cuda.synchronize(dev)
        with record_function("calls"):
            carry = solver.step_fn(carry, 1)
        torch.cuda.synchronize(dev)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    calls = [e.time_range for e in events if e.name == "calls"]
    assert len(calls) == 2
    return sum(1 for e in events if e.name in SYNC_NAMES
               and any(r.start <= e.time_range.start <= r.end for r in calls))


@pytest.mark.cuda
def test_harvest_adds_no_synchronize():
    """The graphed calls make no synchronize with recording on (the profiler
    runs, the replays are harvested) nor with it off (the profiler's flag,
    which recording follows, turned off inside the session)."""
    dev = _card()
    _, solver, carry = _small_fused(cuda_graph=True, device=dev)
    carry = solver.step_fn(carry, 2)
    torch.cuda.synchronize(dev)
    on = _syncs_in_graphed_calls(solver, carry, dev, recording=True)
    assert entries("fused.iteration") >= 1
    reset()
    off = _syncs_in_graphed_calls(solver, carry, dev, recording=False)
    assert entries("fused.iteration") == 0
    assert on == off == 0
