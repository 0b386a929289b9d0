"""Device milliseconds of one closed-loop step of the whole batch (the
implicit policy on the dense value, the Euler-Maruyama step, the cost): the
device's busy time inside the traced batch, over its steps."""


def read(ctx):
    n = ctx.counts.get("steps")
    busy = ctx.trace.busy_s_in("batch")
    return 1e3 * busy / n if n and busy > 0 else None
