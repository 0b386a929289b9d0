"""Structured solver metrics (JSONL records) and the port's spans.

``MetricsLogger`` is the port of ``c3sc_tpu/utils/metrics.py``. Reference:
printf diagnostics + ``struct Diag`` threaded through
``c3control_vi_solve`` (SURVEY.md §5). Records (residual, ranks, wall time)
are appended as one JSON object a line.

Spans. ``with span(name):`` marks a phase of the program. While recording
is on, a span records its name, its parent (the span it was entered in),
its host time (``perf_counter``) and its device time: a pair of CUDA timing
events on the current stream where CUDA is initialized, its host time on
the CPU, where operations are synchronous. ``span(name, device=False)``
marks a phase whose device time no reader takes (a host loop, a read of
the device): it records no event, and its device time is None. On the host
a span is also a ``record_function`` range while a profiler runs, so the
program's phases lie in the profiler's trace on the device's clock.
Records are aggregated by (name, parent): entries, host seconds, device
seconds, and what child spans took of them; ``snapshot()`` returns the
aggregates with each span's self time (its time less its children's) and
``reset()`` clears them.

Recording is on while a ``torch.profiler`` session runs, and inside
``with tracing():``, the switch for an operator who wants the aggregates
without the profiler. Otherwise a span is a flag check: no
``record_function``, no event, no synchronize. The device's events are read
only once ``query()`` says they have completed; nothing here ever waits for
the device.

Spans inside a CUDA graph. A graph replays the device's work, not the
host's: a span entered while the graph is captured runs once, at the
capture. ``GraphSpans`` captures timing events into the graph instead, so
that every replay re-stamps them. Each event node costs the replay about
4 us on an H100, so a program captures such a graph beside its plain one
and replays it only while ``recording()``. Inside
``with graph_spans.capturing():`` the first span entered is the graph's
root and the spans entered directly in it are its tiles: they must cover
the root, every captured operation inside one of them and nothing between
them, so one event at each boundary times them all (consecutive tiles of
one name are one tile). Deeper spans record nothing there. ``harvest()`` reads the last replay's events if it
has completed, and a replay whose events the next replay overwrote first
is not counted: the root's entries are the replays harvested.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
import weakref

import torch
from torch.autograd import profiler as _autograd_profiler

ENTRIES, HOST, HOST_CHILD, DEVICE, DEVICE_CHILD = range(5)


class MetricsLogger:
    """Append-only JSONL metrics writer (`None` path -> in-memory only)."""

    def __init__(self, path: str | None = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self.records: list[dict] = []
        self._t0 = time.time()
        self._fh = open(path, "a") if path else None

    @classmethod
    def _jsonsafe(cls, v):
        # strict-JSON consumers (jq, JSON.parse, pandas) reject the bare
        # Infinity/NaN tokens Python's json emits: non-finite floats become
        # null in every serialized output (the stream on disk and the echo;
        # in-memory records keep the floats). Recurses into containers.
        if isinstance(v, float) and (v != v or v in (float("inf"), float("-inf"))):
            return None
        if isinstance(v, dict):
            return {k: cls._jsonsafe(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [cls._jsonsafe(x) for x in v]
        return v

    def log(self, phase: str, **fields) -> dict:
        rec = {"t": round(time.time() - self._t0, 4), "phase": phase, **fields}
        self.records.append(rec)
        safe = None
        if self._fh or self.echo:
            safe = {k: self._jsonsafe(v) for k, v in rec.items()}
        if self._fh:
            self._fh.write(json.dumps(safe) + "\n")
            self._fh.flush()
        if self.echo:
            print(json.dumps(safe))
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class _Frame:
    """An open span: its key (name, parent's name), its parent's key, whether
    it takes device time, and what it started (host clock, timing events,
    the profiler's range)."""

    __slots__ = ("key", "parent_key", "device", "t0", "events", "range")

    def __init__(self, key, parent_key, device):
        self.key, self.parent_key, self.device = key, parent_key, device
        self.events = self.range = None


class SpanRegistry:
    """The aggregates of the spans of one process (``REGISTRY``)."""

    def __init__(self):
        # (name, parent) -> [entries, host, host child, device, device child]
        self.rows = {}
        self.timed = set()        # the keys that take device time
        self.forced = 0           # open ``tracing()`` blocks
        self.capture = None       # the GraphSpans being captured
        self.armed = False        # forced or capture: spans act without the profiler
        self.graphs = weakref.WeakSet()   # every GraphSpans, for snapshot's harvest
        self.pending = collections.deque()   # eager spans' events the device has yet to pass
        self.free = []            # pairs of timing events read and free to record again
        self._local = threading.local()

    def recording(self) -> bool:
        return bool(self.forced) or _autograd_profiler._is_profiler_enabled

    def stack(self) -> list:
        """The open spans of the calling thread, outermost first."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def row(self, key) -> list:
        r = self.rows.get(key)
        if r is None:
            r = self.rows[key] = [0, 0.0, 0.0, 0.0, 0.0]
        return r

    def add(self, key, parent_key, field: int, seconds: float):
        """``seconds`` to a span's field and to its parent's children's."""
        self.row(key)[field] += seconds
        if field == DEVICE:
            self.timed.add(key)
        if parent_key is not None:
            self.row(parent_key)[field + 1] += seconds

    def _arm(self):
        self.armed = bool(self.forced) or self.capture is not None

    def open(self, name: str, device: bool):
        """Start recording span ``name``: its frame, or None where nothing can
        be recorded (inside a CUDA graph capture that no GraphSpans owns)."""
        cuda = torch.cuda.is_initialized()
        if cuda and torch.cuda.is_current_stream_capturing():
            return None
        stack = self.stack()
        parent = stack[-1] if stack else None
        f = _Frame((name, parent.key[0] if parent else None), parent.key if parent else None,
                   device)
        if _autograd_profiler._is_profiler_enabled:
            f.range = _autograd_profiler.record_function(name)
            f.range.__enter__()
        f.t0 = time.perf_counter()
        if cuda and device:
            # an event made a span costs its host tens of microseconds more
            # than one recorded again
            f.events = self.free.pop() if self.free else (
                torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            f.events[0].record()
        stack.append(f)
        return f

    def close(self, f: _Frame):
        if f.events is not None:
            f.events[1].record()
        host = time.perf_counter() - f.t0
        self.stack().pop()
        self.row(f.key)[ENTRIES] += 1
        self.add(f.key, f.parent_key, HOST, host)
        if f.events is None:
            if f.device:
                self.add(f.key, f.parent_key, DEVICE, host)
        else:
            self.pending.append(f)
            self.drain()
        if f.range is not None:
            f.range.__exit__(None, None, None)

    def drain(self):
        """Add the device time of every eager span the device has passed, in
        the order they closed, without waiting."""
        while self.pending and self.pending[0].events[1].query():
            f = self.pending.popleft()
            start, end = f.events
            self.add(f.key, f.parent_key, DEVICE, start.elapsed_time(end) / 1e3)
            self.free.append(f.events)

    def snapshot(self) -> dict:
        self.drain()
        for g in list(self.graphs):
            g.harvest(overwrite=False)
        rows = []
        for key, r in self.rows.items():
            timed = key in self.timed
            rows.append(dict(name=key[0], parent=key[1], entries=r[ENTRIES], host_s=r[HOST],
                             device_s=r[DEVICE] if timed else None,
                             self_host_s=r[HOST] - r[HOST_CHILD],
                             self_device_s=r[DEVICE] - r[DEVICE_CHILD] if timed else None))
        return {"spans": rows}

    def reset(self):
        self.rows.clear()
        self.timed.clear()
        self.pending.clear()
        for g in list(self.graphs):
            g.armed = False


REGISTRY = SpanRegistry()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "device", "frame", "captured")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        g = REGISTRY.capture
        self.captured = g is not None
        if self.captured:
            g.enter(self.name)
        else:
            self.frame = REGISTRY.open(self.name, self.device)
        return self

    def __exit__(self, *exc):
        if self.captured:
            REGISTRY.capture.exit()
        elif self.frame is not None:
            REGISTRY.close(self.frame)
        return False


def span(name: str, device: bool = True):
    """``with span(name):`` marks a phase of the program (the module's
    docstring); a flag check while recording is off. ``device=False``: no
    timing events, for a phase whose device time nothing reads."""
    if not (REGISTRY.armed or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device)


def recording() -> bool:
    """Whether spans record now: a profiler runs or ``tracing()`` is on."""
    return REGISTRY.recording()


@contextlib.contextmanager
def tracing():
    """Record spans inside the block with no profiler running."""
    REGISTRY.forced += 1
    REGISTRY._arm()
    try:
        yield REGISTRY
    finally:
        REGISTRY.forced -= 1
        REGISTRY._arm()


def snapshot() -> dict:
    """``{"spans": [...]}``: one row for each (name, parent) recorded since the
    last ``reset()``, with its entries, ``host_s``, ``device_s``,
    ``self_host_s`` and ``self_device_s`` (the device's None for a span of
    ``device=False``). Harvests every graph's completed
    replay and every eager span the device has passed first; waits for
    nothing, so call it after a synchronize to count everything."""
    return REGISTRY.snapshot()


def reset():
    """Clear the aggregates (and forget replays not yet harvested)."""
    REGISTRY.reset()


class GraphSpans:
    """The spans of one CUDA graph as timing events captured into it (the
    module's docstring). Keep it as long as the graph: the graph's event
    nodes refer to its events. The host span open when the replays are
    launched is the root's parent in the aggregates.

        spans = GraphSpans()
        with torch.cuda.graph(g), spans.capturing():
            with span("root"): ...tiles...
        if recording():
            spans.harvest(); g.replay(); spans.replayed()
    """

    def __init__(self):
        self.events = []        # in capture order; one at each boundary
        self.root = None        # [name, first event, last event]
        self.tiles = []         # [name, first event, last event]
        self.depth = 0
        self.open_tile = None   # the tile being captured
        self.last = None        # the tile whose end was the last boundary, not yet closed
        self.armed = False      # a replay made while recording awaits harvest
        self.parent_key = None  # the host span the armed replay ran under

    @contextlib.contextmanager
    def capturing(self):
        if REGISTRY.capture is not None:
            raise RuntimeError("spans of two CUDA graphs captured at once")
        if self.root is not None:
            raise RuntimeError("a GraphSpans captures one graph")
        REGISTRY.capture = self
        REGISTRY._arm()
        REGISTRY.graphs.add(self)
        try:
            yield self
        finally:
            REGISTRY.capture = None
            REGISTRY._arm()
        if self.depth:
            raise RuntimeError("a span entered in the capture was left open")

    def _boundary(self) -> int:
        e = torch.cuda.Event(enable_timing=True, external=True)
        e.record()
        self.events.append(e)
        return len(self.events) - 1

    def enter(self, name: str):
        self.depth += 1
        if self.depth == 1:
            if self.root is not None:
                raise RuntimeError("a graph's spans have one root")
            self.root = [name, self._boundary(), None]
        elif self.depth == 2:
            last = self.last
            if last is not None and last[0] == name:
                self.open_tile, self.last = last, None      # the same tile goes on
                return
            if last is None:            # the root's first tile starts with it
                start = self.root[1]
            else:
                start = last[2] = self._boundary()
            self.open_tile = [name, start, None]
            self.tiles.append(self.open_tile)
            self.last = None

    def exit(self):
        if self.depth == 2:
            self.last, self.open_tile = self.open_tile, None
        elif self.depth == 1:
            end = self._boundary()
            if self.last is not None:
                self.last[2] = end
                self.last = None
            self.root[2] = end
        self.depth -= 1

    def harvest(self, overwrite: bool = True):
        """Add the last replay's times if it was made while recording and has
        completed. ``overwrite``: a replay is about to be launched, which
        would overwrite the events, so an unfinished one is dropped."""
        if not self.armed or self.root is None:
            return
        if not self.events[-1].query():
            self.armed = not overwrite
            return
        self.armed = False
        ev = self.events
        at = [0.0]
        for a, b in zip(ev, ev[1:]):
            at.append(at[-1] + a.elapsed_time(b) / 1e3)
        name, i0, i1 = self.root
        parent = self.parent_key
        key = (name, parent[0] if parent else None)
        REGISTRY.row(key)[ENTRIES] += 1
        REGISTRY.add(key, parent, DEVICE, at[i1] - at[i0])
        for tile, i0, i1 in self.tiles:
            REGISTRY.row((tile, name))[ENTRIES] += 1
            REGISTRY.add((tile, name), key, DEVICE, at[i1] - at[i0])

    def replayed(self):
        """Call after launching replays while recording: the last one is
        harvested later."""
        stack = REGISTRY.stack()
        self.parent_key = stack[-1].key if stack else None
        self.armed = self.root is not None
