"""Structured solver metrics: JSONL records + a profiler trace — port of
``c3sc_tpu/utils/metrics.py``.

Reference: printf diagnostics + ``struct Diag`` threaded through
``c3control_vi_solve`` (SURVEY.md §5). Records (residual, ranks, wall time)
are appended as one JSON object a line; ``profile_trace`` wraps a block in
``torch.profiler`` and writes its Chrome trace.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager


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


@contextmanager
def profile_trace(logdir: str | None):
    """``torch.profiler`` over the block (host and, where there is a card,
    device activity), its Chrome trace written to ``logdir/trace.json``; a
    no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
