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


class SeedStream:
    """The seeds of sub-solves, one a call (see ``seed_stream``), with a
    state that a checkpoint stores and a resumed solve restores, so the
    resumed run draws what the run it continues would have drawn."""

    def __init__(self, seed: int | Sequence, count: int, state: dict | None = None):
        if isinstance(seed, (int, np.integer)):
            self._rng = np.random.default_rng(int(seed))
            if state is not None:
                self._rng.bit_generator.state = state["rng"]
            return
        self._rng = None
        self._seeds = list(seed)
        self._pos = 0 if state is None else int(state["position"])
        if len(self._seeds) < count:
            raise ValueError(f"{count} sub-solves need {count} seeds, got {len(self._seeds)}")

    def __call__(self):
        if self._rng is not None:
            return int(self._rng.integers(0, 2**31))
        self._pos += 1
        return self._seeds[self._pos - 1]

    def state(self) -> dict:
        """The stream's state, as JSON: the bit generator's state for an int
        seed, the position in the sequence otherwise."""
        if self._rng is not None:
            return {"rng": self._rng.bit_generator.state}
        return {"position": self._pos}


def seed_stream(seed: int | Sequence, count: int, state: dict | None = None) -> SeedStream:
    """The seeds of ``count`` sub-solves as a callable that returns the next
    one: ints drawn from ``np.random.default_rng(seed)`` for an int seed,
    the items of a sequence in order (which must hold ``count`` of them;
    an item may itself be a sequence, for a sub-solve that takes several).
    ``state`` (from ``SeedStream.state``) continues a stream where it was."""
    return SeedStream(seed, count, state)
