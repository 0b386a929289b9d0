"""Outer sweeps (one improve and the evaluates under its policy) that a cold
dense solve took to converge: the solver's own count, over the traced solves."""


def read(ctx):
    n, sweeps = ctx.counts.get("solves"), ctx.counts.get("outer_sweeps")
    return sweeps / n if n and sweeps else None
