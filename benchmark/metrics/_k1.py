"""Shared by the K1 roofline readers: the mean device time a launch of one
of K1's structured entries took in the trace, against its least time on the
card from the configuration's shapes (``benchmark/roofline/k1.py``)."""

import re

from benchmark.roofline.k1 import config_bounds_s


def roofline_pct(ctx, entry: str):
    pattern = re.compile(rf"\b{entry}_kernel\b")
    times = [b - a for a, b, name in ctx.trace.ops if pattern.search(name)]
    if not times:
        return None
    return 100.0 * config_bounds_s(ctx.cfg)[entry] / (sum(times) / len(times) / 1e6)
