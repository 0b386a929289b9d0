"""Nested cross index sets of a TT-cross fit — the ``CrossState`` part of
``c3sc_tpu/ops/cross.py``.

The sets live on the host as numpy integer arrays with exact shapes; the
two-site polish (``solvers/polish.py``) carries them from one fit to the
next, as the reference carries its ``CrossIndex`` across Bellman iterations.
Where the JAX package draws the first sets from a JAX key, ``init_cross_state``
here draws them from a ``torch.Generator`` (or takes the numpy seed itself,
which is what a JAX key turns into). ``tt_cross`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass
class CrossState:
    """Nested cross index sets (host-side, exact shapes).

    left[k]:  [r_k, k]   multi-indices into dims 0..k-1   (left boundary k)
    right[k]: [r_k, d-k] multi-indices into dims k..d-1   (right boundary k)
    left[0] and right[d] are [1, 0] (empty prefix/suffix).
    """

    left: list
    right: list

    @property
    def ranks_left(self):
        return [a.shape[0] for a in self.left]

    @property
    def ranks_right(self):
        return [a.shape[0] for a in self.right]


def cross_seed(generator: torch.Generator | None) -> int:
    """The numpy seed in [0, 2^31 - 1) that ``init_cross_state`` draws from
    ``generator`` (None: a CPU generator seeded 0)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return int(torch.randint(0, 2**31 - 1, (), generator=generator, device=generator.device))


def init_cross_state(seed: int | torch.Generator | None, shape: Sequence[int],
                     r0: int) -> CrossState:
    """Random nested right index sets at rank r0 (the left sets are built on
    the first sweep), from the numpy seed ``seed`` or one drawn from a
    ``torch.Generator`` (``cross_seed``). The JAX package's state for a key
    is this function's for ``int(jax.random.randint(key, (), 0, 2**31 - 1))``."""
    if not isinstance(seed, (int, np.integer)):
        seed = cross_seed(seed)
    d = len(shape)
    rng = np.random.default_rng(int(seed))
    left = ([np.zeros((1, 0), np.int64)]
            + [np.stack([rng.integers(0, shape[j], size=r0) for j in range(k)], axis=-1)
               for k in range(1, d)]
            + [np.zeros((1, 0), np.int64)])
    right = ([np.zeros((1, d), np.int64)]  # right[0] unused
             + [np.stack([rng.integers(0, shape[j], size=r0) for j in range(k, d)], axis=-1)
                for k in range(1, d)]
             + [np.zeros((1, 0), np.int64)])
    return CrossState(left=left, right=right)
