"""A traced window: ``torch.profiler`` over a piece of steady work, reduced
to what the per-layer metric readers take (device operations by time and
by the harness's span they ran in, the device's busy time, the window's
length) and to the breakdown the result line carries.

The harness marks its spans with ``span`` (``record_function``) around the calls into
each layer and ends each span with a device synchronize, so the device
operations a span enqueued run inside it; an operation belongs to the span
in which it starts on the device. Operations inside CUDA graph replays are
reported by the profiler like any other (chip_smoke.py counts K1's kernels
in a replay this way).
"""

from __future__ import annotations

import bisect
import dataclasses

import torch


def sync():
    """Wait for the card (nothing to wait for on the CPU, where the tests run)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


WINDOW = "bench_window"
SPANS = {WINDOW}   # every name the harness gives a span (``span``)


def span(name: str):
    """``record_function(name)``: a span of the harness around a call into a layer."""
    from torch.profiler import record_function

    SPANS.add(name)
    return record_function(name)


@dataclasses.dataclass
class Span:
    name: str
    start: float   # microseconds, the profiler's clock
    end: float


class TracedWindow:
    """``with TracedWindow() as tw: ...work...`` profiles the work; afterwards
    ``tw`` holds the reduction. The work itself marks spans with ``span``."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_initialized()
                                         else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = span(WINDOW)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        sync()
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce(self._prof.events())
        del self._prof
        return False

    def _reduce(self, events):
        from torch.autograd import DeviceType

        host, device = [], []
        for e in events:
            tr = e.time_range
            if getattr(e, "is_user_annotation", False) or e.name in SPANS:
                # record_function's ranges, which the profiler also lays on
                # the device's timeline: no operation ran there
                if e.device_type == DeviceType.CPU:
                    host.append(Span(e.name, tr.start, tr.end))
            elif e.device_type == DeviceType.CUDA:
                device.append((tr.start, tr.end, e.name))
            elif e.device_type == DeviceType.CPU:
                host.append(Span(e.name, tr.start, tr.end))
        window = [s for s in host if s.name == WINDOW]
        if len(window) != 1:
            raise RuntimeError(f"the traced window's span was recorded {len(window)} times")
        w0, w1 = window[0].start, window[0].end
        self.window_s = (w1 - w0) / 1e6
        self.ops = sorted((max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1)
        self.host = [s for s in host if s.end > w0 and s.start < w1 and s.name != WINDOW]
        self.busy = _union(self.ops)
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6

    def spans(self, name: str) -> list[Span]:
        return [s for s in self.host if s.name == name]

    def ops_in(self, name: str):
        """Device operations that start inside any span called ``name``."""
        spans = sorted((s.start, s.end) for s in self.spans(name))
        starts = [a for a, _ in spans]
        out = []
        for op in self.ops:
            i = bisect.bisect_right(starts, op[0]) - 1
            if i >= 0 and op[0] <= spans[i][1]:
                out.append(op)
        return out

    def busy_s_in(self, name: str) -> float:
        """Seconds of the device's busy time (the union of its operations)
        spent on operations of spans called ``name``."""
        return sum(b - a for a, b in _union(self.ops_in(name))) / 1e6

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps of the device, each named by the innermost host
        span or operation running at its middle."""
        by_name = {}
        for a, b, name in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = []
        edges = [(self.busy[i][1], self.busy[i + 1][0]) for i in range(len(self.busy) - 1)]
        for a, b in sorted(edges, key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (a + b)
            inner = [s for s in self.host if s.start <= mid <= s.end]
            label = min(inner, key=lambda s: s.end - s.start).name if inner else "host idle"
            gaps.append([label, (b - a) / 1e6])
        return {"device_ops": [[k[:160], v] for k, v in top], "idle_gaps": gaps}


def is_kernel(op) -> bool:
    """A device operation that is a kernel, not a copy or a fill."""
    return not op[2].startswith(("Memcpy", "Memset"))


def _union(ops):
    """Merged [start, end] intervals of operations sorted by start."""
    out = []
    for a, b, *_ in ops:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out
