"""Minimal Prometheus exposition (text format 0.0.4): the port's own copy
of ``nanotpu/metrics/registry.py``.

stdlib-only; thread-safe; enough of the text format for scrapers: counter,
gauge, histogram with cumulative buckets.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

#: Default latency buckets (seconds) tuned for scheduler verbs: sub-ms to 2.5s.
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5
)


def _escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline (exposition format spec). Without it a node name
    or verb label containing ``"`` silently corrupts the whole scrape."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items())
        for key, val in items or [((), 0.0)]:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {val}")
        return out


class Gauge:
    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}
        self._fn = None

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value

    def set_function(self, fn) -> None:
        """Lazily evaluated unlabeled gauge (e.g. live occupancy)."""
        self._fn = fn

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        if self._fn is not None:
            try:
                out.append(f"{self.name} {float(self._fn())}")
            except Exception:  # metric must never break the scrape
                out.append(f"{self.name} NaN")
            return out
        with self._lock:
            items = sorted(self._values.items())
        for key, val in items or [((), 0.0)]:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {val}")
        return out


class Histogram:
    def __init__(self, name: str, help_: str, buckets: tuple[float, ...] = LATENCY_BUCKETS):
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        # per label-set: (bucket counts, total count, sum)
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            series = self._series.setdefault(
                key, [[0] * len(self.buckets), 0, 0.0]
            )
            # store per-bucket raw counts; cumulative sums computed at render.
            # le-semantics: value lands in the first bucket with le >= value
            idx = bisect_left(self.buckets, value)
            if idx < len(self.buckets):
                series[0][idx] += 1
            series[1] += 1
            series[2] += value

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            series = {k: (list(v[0]), v[1], v[2]) for k, v in self._series.items()}
        for key, (raw, count, total) in sorted(series.items()):
            labels = dict(key)
            cum = 0
            for le, c in zip(self.buckets, raw):
                cum += c
                out.append(
                    f"{self.name}_bucket{_fmt_labels({**labels, 'le': repr(le)})} {cum}"
                )
            out.append(
                f"{self.name}_bucket{_fmt_labels({**labels, 'le': '+Inf'})} {count}"
            )
            out.append(f"{self.name}_sum{_fmt_labels(labels)} {total}")
            out.append(f"{self.name}_count{_fmt_labels(labels)} {count}")
        return out


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: list = []

    def counter(self, name: str, help_: str) -> Counter:
        m = Counter(name, help_)
        with self._lock:
            self._metrics.append(m)
        return m

    def gauge(self, name: str, help_: str) -> Gauge:
        m = Gauge(name, help_)
        with self._lock:
            self._metrics.append(m)
        return m

    def histogram(self, name: str, help_: str, buckets: tuple[float, ...] = LATENCY_BUCKETS) -> Histogram:
        m = Histogram(name, help_, buckets)
        with self._lock:
            self._metrics.append(m)
        return m

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"
