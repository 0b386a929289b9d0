"""Seeds of sub-solves.

Where the JAX package takes a key and splits it for every sub-solve (the
rounds of ``fused_tt_vi_refined``, the levels of ``multilevel_tt_vi``, the
cross fits of ``tt_vi``), the port takes ``seed: int | Sequence``: an int
draws each sub-solve's seed from ``np.random.default_rng(seed)``, a
sequence gives each sub-solve its seed in order. A JAX key ``k`` reaches the
numpy draws it seeds as an integer (``key_data(k)[-1]`` in ``fused_tt_vi``,
``randint(k, (), 0, 2**31 - 1)`` in the cross fits), which is what a
sequence passes across.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def seed_stream(seed: int | Sequence, count: int):
    """The seeds of ``count`` sub-solves as a function that returns the next
    one: ints drawn from ``np.random.default_rng(seed)`` for an int seed,
    the items of a sequence in order (which must hold ``count`` of them;
    an item may itself be a sequence, for a sub-solve that takes several)."""
    if isinstance(seed, (int, np.integer)):
        rng = np.random.default_rng(int(seed))
        return lambda: int(rng.integers(0, 2**31))
    seeds = list(seed)
    if len(seeds) < count:
        raise ValueError(f"{count} sub-solves need {count} seeds, got {len(seeds)}")
    it = iter(seeds)
    return lambda: next(it)
