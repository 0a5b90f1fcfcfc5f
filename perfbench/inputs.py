"""Input streams made from ``--seed``.

The values are those of the port's on-card smoke test (``chip_smoke.py``'s
``seeded_inputs``, copied here): uniform(-4, 4) in float32, rounded to 2
decimals. Drawing 16384 x 64 fresh values for every input of every batch
would cost the host more than the device spends on the batch, so one pool of
``POOL_STREAMS`` streams' worth of values is drawn from the seed in set-up,
and each input of each batch is a window of the pool at an offset drawn from
the seed and the batch's key. Every seed gives the same sizes; only the
values and the offsets differ.
"""

from __future__ import annotations

import zlib

import numpy as np

#: The pool holds this many streams' worth of values.
POOL_STREAMS = 16


def seed_words(seed: int, *key) -> list[int]:
    """Entropy for numpy's SeedSequence from the run's seed (any whole
    number) and a key of ints and strings."""
    words = [seed & (2**64 - 1)]
    for k in key:
        words.append(zlib.crc32(k.encode()) if isinstance(k, str) else int(k) & (2**64 - 1))
    return words


class StreamPool:
    """Windows of one seeded pool of values, as [num_iters, batch] streams."""

    def __init__(self, seed: int, num_iters: int, batch: int):
        self.seed = seed
        self.num_iters = num_iters
        self.batch = batch
        self.size = num_iters * batch
        rng = np.random.default_rng(seed_words(seed, "pool"))
        self.values = rng.uniform(-4, 4, POOL_STREAMS * self.size).astype(np.float32).round(2)

    def streams(self, nodes: list[int], *key) -> dict[int, np.ndarray]:
        """One stream per input node for the batch named by ``key``."""
        rng = np.random.default_rng(seed_words(self.seed, "batch", *key))
        offsets = rng.integers(0, len(self.values) - self.size + 1, len(nodes))
        return {v: self.values[o:o + self.size].reshape(self.num_iters, self.batch)
                for v, o in zip(nodes, offsets.tolist())}
