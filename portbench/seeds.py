"""Everything a run draws from its ``--seed``: 64-bit words for the
generators of the inputs, the order of the requests and the sample of
answers the reference checks."""

from __future__ import annotations

import numpy as np

# the words of a run's seed, by use
INPUTS, ORDER, CHECK = 0, 1, 2


def seed_words(seed, count: int = 3) -> list:
    """``count`` 64-bit words derived from a seed (an int or a list of
    ints)."""
    ss = np.random.SeedSequence(seed)
    return [int(w) for w in ss.generate_state(count, np.uint64)]


def sample(n: int, k: int, rng) -> list:
    """Up to k of the indices 0 .. n - 1: the last, and k - 1 others drawn
    by ``rng``."""
    rest = rng.permutation(n - 1)[:max(0, k - 1)].tolist() if n > 1 else []
    return sorted(set(rest) | {n - 1})
