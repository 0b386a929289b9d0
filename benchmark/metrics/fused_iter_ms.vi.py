"""Device milliseconds of one graphed fused iteration: the device's busy time
inside the traced calls of the iteration, over the iterations they ran."""


def read(ctx):
    n = ctx.counts.get("iterations")
    busy = ctx.trace.busy_s_in("iterations")
    return 1e3 * busy / n if n and busy > 0 else None
