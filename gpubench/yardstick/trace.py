"""The device's timeline from ``torch.profiler``, and what the metrics read
from it.

:class:`Tracer` starts the profiler (CUDA activity only) where the caller
says: a serving engine must be idle then, since starting it while an
engine's thread replays CUDA graphs hung a call. :meth:`Tracer.mark` puts a
marker kernel (``spin_kernel``, from ``torch.cuda._sleep``) on a stream of
its own, which runs at once: two marks bound the slice the metrics read,
on the device's own clock. :meth:`Tracer.stop` writes the Chrome trace
under ``$TMPDIR``, reads it back into a :class:`Timeline` and deletes it.
The busy time is the union of the kernels' intervals (chip_smoke.py's
``decode_only_profile``, copied), so that kernels on two streams are not
counted twice.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

MARKER = "spin_kernel"
#: a kernel's name in a breakdown: templated names run to thousands of
#: characters
NAME_CHARS = 160


@dataclasses.dataclass
class Kernel:
    start: float  # microseconds, the trace's clock
    end: float
    name: str
    correlation: int | None


@dataclasses.dataclass
class Timeline:
    """The kernels of a trace between its first two marks, and the host's
    CUDA runtime calls (for naming idle gaps)."""

    kernels: list[Kernel]  # every kernel of the trace, in start order
    runtime: list[Kernel]  # the host's CUDA runtime calls
    lo: float
    hi: float

    @staticmethod
    def from_events(events: list[dict]) -> "Timeline":
        kernels, runtime = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            k = Kernel(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e.get("name", ""),
                       (e.get("args") or {}).get("correlation"))
            if e.get("cat") == "kernel":
                kernels.append(k)
            elif e.get("cat") == "cuda_runtime":
                runtime.append(k)
        kernels.sort(key=lambda k: k.start)
        runtime.sort(key=lambda k: k.start)
        marks = [k for k in kernels if MARKER in k.name]
        if len(marks) < 2:
            raise RuntimeError(f"the trace holds {len(marks)} marker kernels, "
                               "not the 2 that bound its slice")
        work = [k for k in kernels if MARKER not in k.name]
        return Timeline(work, runtime, marks[0].start, marks[1].end)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def inside(self) -> list[Kernel]:
        """Kernels that start inside the slice."""
        return [k for k in self.kernels if self.lo <= k.start < self.hi]

    def busy_s(self) -> float:
        """Seconds of the slice in which some kernel ran: the union of the
        kernels' intervals, clipped to the slice."""
        busy, run = 0.0, None
        for lo, hi in self._clipped():
            if run is None or lo > run[1]:
                busy += 0.0 if run is None else run[1] - run[0]
                run = [lo, hi]
            else:
                run[1] = max(run[1], hi)
        busy += 0.0 if run is None else run[1] - run[0]
        return busy / 1e6

    def _clipped(self):
        for k in self.kernels:
            lo, hi = max(k.start, self.lo), min(k.end, self.hi)
            if hi > lo:
                yield lo, hi

    def top_ops(self, n: int = 10) -> list[list]:
        """[name, seconds] of the kernels that took most time in the slice,
        summed by name."""
        by_name: dict[str, float] = {}
        for k in self.kernels:
            lo, hi = max(k.start, self.lo), min(k.end, self.hi)
            if hi > lo:
                by_name[k.name] = by_name.get(k.name, 0.0) + (hi - lo) / 1e6
        return [[name[:NAME_CHARS], s] for name, s in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """[what the host was doing, seconds] of the longest stretches of
        the slice with no kernel running: named by the host's CUDA runtime
        call that was in progress when the gap closed, or by the call that
        launched the kernel that closed it."""
        gaps, edge = [], self.lo
        for lo, hi in sorted(self._clipped()):
            if lo > edge:
                gaps.append((edge, lo))
            edge = max(edge, hi)
        if self.hi > edge:
            gaps.append((edge, self.hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        launched = {k.correlation: k for k in self.runtime
                    if k.correlation is not None}
        closers = {k.start: k for k in self.kernels}
        out = []
        for lo, hi in gaps[:n]:
            out.append([self._host_at(lo, hi, launched, closers.get(hi)),
                        (hi - lo) / 1e6])
        return out

    def _host_at(self, lo, hi, launched, closer) -> str:
        for call in self.runtime:
            if call.start > hi:
                break
            if call.end >= hi and call.start <= hi:
                return f"host in {call.name}"
        if closer is not None and closer.correlation in launched:
            return (f"host launching {closer.name[:NAME_CHARS]} by "
                    f"{launched[closer.correlation].name}")
        if closer is not None:
            return f"before {closer.name[:NAME_CHARS]}"
        return "until the slice's end"


class Tracer:
    """``torch.profiler`` over CUDA activity, with marks on the device's
    clock; the trace goes to a temporary directory under ``$TMPDIR``."""

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self.device = device
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._stream = torch.cuda.Stream(device)

    def start(self) -> None:
        self._prof.start()

    def mark(self) -> None:
        with self._torch.cuda.stream(self._stream):
            self._torch.cuda._sleep(1000)

    def stop(self) -> Timeline:
        self._torch.cuda.synchronize(self.device)
        self._prof.stop()
        with tempfile.TemporaryDirectory(prefix="gpubench-trace-") as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return Timeline.from_events(events)
