"""Times a cold dense solve waits for the device on the host: the profiler's
host events of a synchronize that start inside the program's ``dense_vi``
ranges (``c3sc_tpu_torch.utils.metrics``' spans, on the profiler's clock),
over those ranges."""

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def read(ctx):
    solves = ctx.trace.spans("dense_vi")
    if not solves:
        return None
    n = sum(1 for s in ctx.trace.host if s.name in SYNCS
            and any(r.start <= s.start <= r.end for r in solves))
    return n / len(solves)
