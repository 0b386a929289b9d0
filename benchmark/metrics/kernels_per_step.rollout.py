"""Kernels one closed-loop step of the whole batch runs: kernels inside the
traced batch, over its steps."""

from benchmark.trace import is_kernel


def read(ctx):
    n = ctx.counts.get("steps")
    k = sum(1 for op in ctx.trace.ops_in("batch") if is_kernel(op))
    return k / n if n and k else None
