"""Device milliseconds of one fused iteration inside the warm replans of the
receding-horizon loop: the device's busy time inside the traced replans,
over the iterations they ran."""


def read(ctx):
    n = ctx.counts.get("replan_iterations")
    busy = ctx.trace.busy_s_in("replan")
    return 1e3 * busy / n if n and busy > 0 else None
