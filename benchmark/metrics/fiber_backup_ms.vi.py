"""Device milliseconds of the fiber backup K2 in one fused iteration: the device's
busy time inside the traced calls of the iteration over the iterations
they ran (``fused_iter_ms.vi``), times the share of the program's
``fiber_backup`` spans (``c3sc_tpu_torch.utils.metrics``) in the
``fused.iteration`` spans they ran in: the timing events of the graphed
iteration's harvested replays, or the eager iterations'. The events give
the share alone: under the profiler a replay's events also count the
device's waits for the host inside it, which the busy time leaves out."""


def read(ctx):
    try:
        from c3sc_tpu_torch.utils.metrics import snapshot
    except ImportError:     # a program without the port's spans
        return None
    n, busy = ctx.counts.get("iterations"), ctx.trace.busy_s_in("iterations")
    if not n or busy <= 0:
        return None
    rows = snapshot()["spans"]
    part = sum(r["device_s"] or 0.0 for r in rows if r["name"] == "fiber_backup")
    whole = sum(r["device_s"] or 0.0 for r in rows if r["name"] == "fused.iteration")
    return 1e3 * busy / n * part / whole if part > 0 and whole > 0 else None
