"""Exact sample statistics: the port's own copy of
``nanotpu/metrics/stats.py:percentile``."""

from __future__ import annotations

import math


def percentile(samples: list[float], p: float) -> float | None:
    """Exact p-quantile (0 < p <= 1) by the nearest-rank method; None on an
    empty sample set."""
    if not samples:
        return None
    xs = sorted(samples)
    return xs[min(len(xs) - 1, max(0, math.ceil(p * len(xs)) - 1))]
