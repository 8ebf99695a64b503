"""A traced run's spans (:mod:`nanotpu_torch.metrics.spans`) on the device
trace's clock, and what the metrics read from them.

The port records its spans on the host's ``time.perf_counter_ns()``, while
the trace (:class:`~gpubench.yardstick.trace.Timeline`) is in microseconds
on the profiler's clock. :func:`on_trace` maps the one onto the other. The
base mapping puts the window's opening (``out["t_open"]``, read beside the
first mark) on the slice's first mark (``tl.lo``); the harness's thread
can read it some 100 ms late while the engine's holds the interpreter.
Where ``engine.sync``
spans that waited (``WAITED_US`` or longer) lie in the slice, the offset
is sharpened by the median difference between each one's end and the end
of the CUDA runtime call it waited in: a copy to pageable memory
(``cudaMemcpyAsync``) returns when it is done. Two passes: the first
takes, within ``REACH_US`` of the span's end, the copy whose length is
nearest the span's (within 5% and ``NEAR_US``); the second, by the
first's offset, the copy of the nearest length that lies in the span
widened by ``NEAR_US``.

Each kernel goes to the innermost span open when the host call that
launched it began, matched by correlation id between
``Timeline.kernels`` and ``Timeline.runtime``; a CUDA graph's kernels
share its ``cudaGraphLaunch``'s. A kernel launched by ``cuLaunchKernelEx``
(cuBLAS's GEMMs), whose call the timeline does not keep, takes the launch
of the kernel that ran before it. Spans of waiting (``engine.queue``) own no
kernel and no idle gap. "Device time" is the union of the kernels'
intervals, clipped to the slice.

The tracer starts the profiler before the serving loop or before the
training window, so a traced run records exactly the profiled session.
Where the program records no span (a port without
``nanotpu_torch.metrics.spans``, or a run without the profiler),
:func:`on_trace` gives None and nothing is read.

    python3 -m gpubench.yardstick.spans --workload <cell> --seed <n>

runs one cell traced and prints its per-layer metrics and :func:`report`
as one JSON line.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import heapq
import json
import statistics
import sys
import time

from gpubench.yardstick.trace import Timeline

SYNC = "engine.sync"
#: spans of waiting, not of host work
WAITS = frozenset({"engine.queue"})
#: the CUDA runtime calls a host fetch (``.cpu()``) waits in
WAIT_CALLS = frozenset({"cudaMemcpyAsync", "cudaMemcpy"})
#: a sync span this long (us) or longer waited for the device
WAITED_US = 1_000.0
#: how far from a sync span's end (us) its call may end, by the mark-only
#: offset
REACH_US = 1_000_000.0
#: the slack (us) of a call's length and, by the first pass's offset, of
#: its ends
NEAR_US = 1_000.0


@dataclasses.dataclass
class On:
    """A recorded span and its interval on the trace's clock (us)."""

    span: object
    start: float
    end: float

    @property
    def name(self) -> str:
        return self.span.name


@dataclasses.dataclass
class SpanTrace:
    """A run's spans on the trace's clock, and the span that launched
    each of the timeline's kernels."""

    tl: Timeline
    spans: list[On]
    #: trace us = host ns / 1e3 + offset: the mark-only one and the one
    #: used, sharpened by the sync spans where the slice holds some
    base: float
    offset: float
    #: each sync span's call's end less the span's end after mapping (us)
    residuals: list[float]
    #: the innermost span that launched each kernel of ``tl.kernels``
    owners: list[On | None]

    def named(self, name: str) -> list[On]:
        return [s for s in self.spans if s.name == name]

    def inside(self, name: str) -> list[On]:
        """The spans of ``name`` that lie wholly in the slice."""
        return [s for s in self.named(name)
                if self.tl.lo <= s.start and s.end <= self.tl.hi]

    def ending_inside(self, name: str) -> list[On]:
        """The spans of ``name`` that end in the slice."""
        return [s for s in self.named(name)
                if self.tl.lo <= s.end < self.tl.hi]

    def device_s(self, spans: list[On]) -> float:
        """Device seconds of the kernels launched in ``spans`` or in spans
        inside them."""
        ids = {s.span.id for s in spans}
        parent = {s.span.id: s.span.parent for s in self.spans}

        def within(owner):
            at = None if owner is None else owner.span.id
            while at is not None:
                if at in ids:
                    return True
                at = parent.get(at)
            return False

        return self._busy([k for k, o in zip(self.tl.kernels, self.owners)
                           if within(o)])

    def device_by_span(self) -> dict[str, float]:
        """Device seconds of the slice by the name of the innermost span
        that launched each kernel ("no span": launched outside every
        span)."""
        groups: dict[str, list] = {}
        for k, o in zip(self.tl.kernels, self.owners):
            groups.setdefault("no span" if o is None else o.name, []).append(k)
        return dict(sorted(((n, self._busy(ks)) for n, ks in groups.items()),
                           key=lambda kv: -kv[1]))

    def idle_by_span(self) -> dict[str, float]:
        """The slice's idle seconds split by the innermost span open on the
        host when each gap began ("no span" where none was)."""
        at = _innermost([s for s in self.spans if s.name not in WAITS])
        idle: dict[str, float] = {}
        for lo, hi in _gaps(self.tl):
            owner = at(lo)
            name = "no span" if owner is None else owner.name
            idle[name] = idle.get(name, 0.0) + (hi - lo) / 1e6
        return dict(sorted(idle.items(), key=lambda kv: -kv[1]))

    def _busy(self, kernels) -> float:
        return Timeline(kernels, [], self.tl.lo, self.tl.hi).busy_s()


def recorded() -> list | None:
    """The spans the port recorded, or None where it records none."""
    try:
        from nanotpu_torch.metrics import spans
    except ImportError:  # a port older than its spans
        return None
    return spans.recorded()


def on_trace(out: dict) -> SpanTrace | None:
    """The run's spans on its timeline's clock (kept in ``out`` for the
    next reader), or None without a timeline or spans."""
    if "span_trace" not in out:
        tl, found = out.get("timeline"), recorded()
        out["span_trace"] = (None if tl is None or not found
                             or out.get("t_open") is None
                             else map_spans(tl, found, out["t_open"]))
    return out["span_trace"]


def map_spans(tl: Timeline, found: list, t_open: float) -> SpanTrace:
    """``found`` (the port's spans, ended ones) on ``tl``'s clock, where
    the host's ``perf_counter()`` read ``t_open`` at ``tl.lo``."""
    ended = [s for s in found if s.end is not None]
    base = tl.lo - t_open * 1e6
    syncs = [s for s in ended if s.name == SYNC
             and s.end - s.start >= WAITED_US * 1e3
             and tl.lo <= s.end / 1e3 + base < tl.hi]
    waits = sorted((c for c in tl.runtime
                    if c.name.split("_v")[0] in WAIT_CALLS),
                   key=lambda c: c.end)
    offset, residuals = base, []
    for first in (True, False):
        diffs = _sync_diffs(syncs, waits, offset, first)
        if not diffs:
            break
        offset += statistics.median(diffs)
        residuals = [d - statistics.median(diffs) for d in diffs]
    on = [On(s, s.start / 1e3 + offset, s.end / 1e3 + offset) for s in ended]
    at = _innermost([s for s in on if s.name not in WAITS])
    launched = {c.correlation: c.start for c in tl.runtime
                if c.correlation is not None}
    owners, last = [], None
    for k in tl.kernels:
        # a kernel launched by cuLaunchKernelEx (cuBLAS's), whose call
        # the timeline does not keep, was launched after the kernel that
        # ran before it: one stream runs its kernels in launch order
        last = launched.get(k.correlation, last)
        owners.append(None if last is None else at(last))
    return SpanTrace(tl, on, base, offset, residuals, owners)


def _sync_diffs(syncs, waits, offset: float, first: bool) -> list[float]:
    """For each sync span, the end of the copy it waited in less the
    span's end (us): the copy of the nearest length, within 5% and
    ``NEAR_US``, that ends within ``REACH_US`` of it (``first``), or that
    lies in it widened by ``NEAR_US``."""
    ends = [c.end for c in waits]
    diffs = []
    for s in syncs:
        start, end = s.start / 1e3 + offset, s.end / 1e3 + offset
        reach = REACH_US if first else NEAR_US
        near = [c for c in waits[bisect.bisect_left(ends, end - reach):
                                 bisect.bisect_right(ends, end + reach)]
                if first or c.start >= start - NEAR_US]
        length = end - start
        near = [c for c in near if abs(c.end - c.start - length)
                <= 0.05 * length + NEAR_US]
        if near:
            call = min(near, key=lambda c: abs(c.end - c.start - length))
            diffs.append(call.end - end)
    return diffs


def _innermost(spans: list[On]):
    """``at(t)``: the innermost of ``spans`` open at ``t``, the one that
    opened last (spans of one thread nest), or None."""
    bounds = sorted({s.start for s in spans} | {s.end for s in spans})
    by_start = sorted(spans, key=lambda s: (s.start, s.span.id))
    cuts, owners, heap, i = [], [], [], 0
    for t in bounds:
        while i < len(by_start) and by_start[i].start <= t:
            s = by_start[i]
            heapq.heappush(heap, (-s.start, -s.span.id, i, s))
            i += 1
        while heap and heap[0][3].end <= t:
            heapq.heappop(heap)
        cuts.append(t)
        owners.append(heap[0][3] if heap else None)

    def at(t: float) -> On | None:
        j = bisect.bisect_right(cuts, t) - 1
        return owners[j] if j >= 0 else None

    return at


def _gaps(tl: Timeline) -> list[tuple[float, float]]:
    """The stretches of the slice with no kernel running (us)."""
    gaps, edge = [], tl.lo
    for k in sorted(tl.kernels, key=lambda k: k.start):
        lo, hi = max(k.start, tl.lo), min(k.end, tl.hi)
        if hi <= lo:
            continue
        if lo > edge:
            gaps.append((edge, lo))
        edge = max(edge, hi)
    if tl.hi > edge:
        gaps.append((edge, tl.hi))
    return gaps


def report(out: dict) -> dict | None:
    """What a traced run's spans say of its slice: the clock (the offset's
    sharpening and the sync spans' residuals, us), the share of device
    time launched outside every span, device and idle seconds by span, and
    the spans in the slice by name."""
    st = on_trace(out)
    if st is None:
        return None
    busy = st.tl.busy_s()
    by_span = st.device_by_span()
    res = [abs(r) for r in st.residuals]
    return {
        "window_s": st.tl.window_s, "busy_s": busy,
        "sharpened_by_us": st.offset - st.base,
        "syncs": len(res),
        "sync_residual_us": {
            "median": statistics.median(res) if res else None,
            "max": max(res, default=None),
            "over_100": sum(r > 100 for r in res)},
        "unattributed_share": (100.0 * by_span.get("no span", 0.0) / busy
                               if busy else None),
        "device_s_by_span": by_span,
        "idle_s_by_span": st.idle_by_span(),
        "spans_inside": {name: len(st.inside(name)) for name in
                         sorted({s.name for s in st.spans})},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    args = p.parse_args(argv)
    import torch

    from gpubench.run import Run
    from gpubench.spec import Bench
    from gpubench.yardstick.flops import Shape
    from gpubench.yardstick.trace import Tracer

    bench = Bench()
    cell = bench.cell(args.workload)
    config, traffic = bench.config(cell), bench.traffic(cell)
    device = torch.device("cuda", 0)
    run = Run(config, traffic, bench.family(config["model_type"]),
              Shape.of(config), args.seed, args.seconds, device,
              time.perf_counter())
    out = bench.driver(traffic["driver"]).run(run, Tracer(device))
    metrics = {m["name"]: bench.reader(m["name"]).read(run, out)
               for m in bench.per_layer(args.workload)}
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "metrics": metrics, "spans": report(out),
                      "compared": out["compared"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
