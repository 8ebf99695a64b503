"""Percentiles and the arithmetic of a measured window.

A served request is a :class:`Served`: when the harness sent it, when it
saw its first token and its end, and how many output tokens it had seen at
each poll where the count moved (``seen``). Every time is the harness's
own ``time.perf_counter()``; none is read from the program.
"""

from __future__ import annotations

import dataclasses


def percentile(values, q: float) -> float:
    """The ``q`` quantile (0..1) of ``values``, linear between the two
    nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclasses.dataclass
class Served:
    sent: float
    prompt_len: int
    first: float | None = None
    done: float | None = None
    error: str | None = None
    #: (time, output tokens seen) at each poll where the count moved
    seen: list = dataclasses.field(default_factory=list)

    def count_at(self, t: float) -> int:
        n = 0
        for when, count in self.seen:
            if when > t:
                break
            n = count
        return n

    @property
    def n_out(self) -> int:
        return self.seen[-1][1] if self.seen else 0


def tokens_in_window(reqs, t0: float, t1: float) -> int:
    """Output tokens that became visible inside [t0, t1]: each request's
    count at the close less its count at the open."""
    return sum(r.count_at(t1) - r.count_at(t0) for r in reqs)


def ttft_samples(reqs, t0: float, t1: float) -> list[float]:
    """Seconds from send to first token of every request sent inside
    [t0, t1). One with no first token by ``t1`` counts with the time it has
    waited by then, so a stall cannot hide."""
    out = []
    for r in reqs:
        if not t0 <= r.sent < t1:
            continue
        first = r.first if r.first is not None and r.first <= t1 else t1
        out.append(first - r.sent)
    return out


def tpot_samples(reqs, t0: float, t1: float) -> list[float]:
    """Seconds between output tokens, ``(done - first) / (n_out - 1)``, of
    every request that finished inside [t0, t1] with at least two."""
    return [(r.done - r.first) / (r.n_out - 1) for r in reqs
            if r.done is not None and r.error is None and t0 <= r.done <= t1
            and r.first is not None and r.n_out >= 2]
