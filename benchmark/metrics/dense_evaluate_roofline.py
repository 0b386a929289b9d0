"""K1's fixed-policy sweep (``dense_evaluate``) as a share of its roofline
bound: the least time from the configuration's shapes over its mean device
time a launch in the traced solve."""

from benchmark.metrics._k1 import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "dense_evaluate")
