"""The whole dense solve's share of the card's peak: the least time of the
K1 sweeps it ran (one improve and ``eval_sweeps`` evaluates an outer sweep,
bounds from the configuration's shapes) over the traced window's length,
idle time and every other kernel included."""

from benchmark.roofline.k1 import config_bounds_s


def read(ctx):
    sweeps, evals = ctx.counts.get("outer_sweeps"), ctx.counts.get("eval_sweeps")
    if not sweeps or ctx.trace.busy_s <= 0:
        return None
    b = config_bounds_s(ctx.cfg)
    return 100.0 * sweeps * (b["dense_backup"] + evals * b["dense_evaluate"]) \
        / ctx.trace.window_s
