"""The one generator of served traffic: requests from a traffic mix's
parameters and a seed.

Requests come in blocks of ``block``. Every block holds the same
``block`` prompt lengths, the distribution's quantiles at (j + 0.5) /
block, and the same output lengths; the seed only pairs them and orders
them within the block, and draws the token ids. So every seed asks for the same work in another order, and any run of
consecutive requests is close to the whole distribution.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The ``n`` values at quantiles (j + 0.5) / n of ``dist``:
    ``{"dist": "lognormal", "median", "sigma"}`` or ``{"dist":
    "uniform"}``, each clamped to [``min``, ``max``]."""
    qs = (np.arange(n) + 0.5) / n
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(q) for q in qs])
        values = dist["median"] * np.exp(dist["sigma"] * z)
    elif dist["dist"] == "uniform":
        values = dist["min"] + qs * (dist["max"] - dist["min"])
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(values, dist["min"], dist["max"])


def quantile_lengths(dist: dict, n: int) -> np.ndarray:
    """:func:`quantiles` rounded to whole tokens."""
    return np.rint(quantiles(dist, n)).astype(np.int64)


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use (``stream``) of a run's seed: any
    whole number, negative or above 64 bits included."""
    return np.random.default_rng([seed % (1 << 63), stream])


class Requests:
    """The endless request sequence of a traffic mix under a seed: call
    :meth:`next` for the next (prompt token ids, output tokens)."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.block = int(traffic["block"])
        self.prompts = quantile_lengths(traffic["prompt"], self.block)
        self.outputs = quantile_lengths(traffic["output"], self.block)
        self.vocab = vocab
        self._rng = rng(seed, 1)
        self._queue: list = []

    def next(self) -> tuple[list[int], int]:
        if not self._queue:
            order, outs = (self._rng.permutation(self.block) for _ in range(2))
            self._queue = [(int(self.prompts[i]), int(self.outputs[j]))
                           for i, j in zip(order, outs)][::-1]
        prompt_len, out_len = self._queue.pop()
        ids = self._rng.integers(0, self.vocab, size=prompt_len)
        return ids.tolist(), out_len
