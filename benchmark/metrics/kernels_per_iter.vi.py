"""Kernels one fused iteration runs on the device (the fiber backup K2 and the
core fit K3 with the copies in and out of the graph's buffers): kernels
inside the traced calls of the iteration, over the iterations they ran."""

from benchmark.trace import is_kernel


def read(ctx):
    n = ctx.counts.get("iterations")
    k = sum(1 for op in ctx.trace.ops_in("iterations") if is_kernel(op))
    return k / n if n and k else None
