"""The spans' clock and the six readers that use them, on a synthetic
timeline and span list with hand-worked answers.

The serving world, on the trace's clock (us), slice [1000, 21000]:

- ``engine.admit`` [2000, 3600]: ``engine.queue`` [500, 2005] (request 7),
  ``engine.prefill`` [2010, 2300] (300 tokens in a bucket of 512; kernels
  [2100, 2250] and [2250, 2500], the second launched by
  ``cuLaunchKernelEx``, whose call the timeline lacks), ``engine.sync``
  [2300, 3580], which waited in ``cudaMemcpyAsync`` [2305, 3560];
- ``engine.chunk`` [4000, 9000] (2 units, 4 slots, 5 emitted): two
  ``cudaGraphLaunch`` calls whose kernels share their correlations
  ([4100, 5000] and [5000, 6000]; [6000, 6500] and [6500, 7000]), and an
  ``engine.sync`` [7000, 8920], which waited in ``cudaMemcpyAsync``
  [7010, 8900] (a ``cudaStreamSynchronize`` ends beside it);
- ``engine.admit`` [9100, 9200]: ``engine.queue`` [4000, 9150] (request 8),
  ``engine.prefill`` [9110, 9170] (100 tokens in 128; kernel [9200, 9400])
  and an ``engine.sync`` [9175, 9190] that did not wait, too short to set
  the clock (a copy of about its length runs at 9600);
- a kernel [9600, 9700] launched outside every span;
- ``engine.chunk`` [20000, 30000] past the slice's end (kernel [20100,
  22000], 900 us of it in the slice).

Each sync span ends 20 us after its call, and the harness read ``t_open``
3000 us late: the mark-only offset is 3000 us off, and the sync spans move
it by 3020 us.
"""

from __future__ import annotations

import sys

import pytest

from gpubench.spec import Bench
from gpubench.yardstick import spans as ys
from gpubench.yardstick.trace import Kernel, Timeline
from nanotpu_torch.metrics.spans import Span

#: trace us = host ns / 1e3 + TRUE
TRUE = -5e6
LATE_US = 3000.0
LO, HI = 1000.0, 21000.0


def _ns(us: float) -> int:
    return round((us - TRUE) * 1e3)


def _span(name, id, parent, start, end, rid=None, **counts):
    return Span(name, id, parent, rid, _ns(start), _ns(end), counts)


def _t_open() -> float:
    return (LO - TRUE - LATE_US) / 1e6


def _timeline(kernels, runtime) -> Timeline:
    return Timeline([Kernel(a, b, n, c) for a, b, n, c in kernels],
                    [Kernel(a, b, n, c) for a, b, n, c in runtime], LO, HI)


def _serving():
    found = [
        _span("engine.queue", 1, 0, 500, 2005, rid=7),
        _span("engine.prefill", 2, 0, 2010, 2300, rid=7, tokens=300,
              bucket=512),
        _span("engine.sync", 3, 0, 2300, 3580),
        _span("engine.admit", 0, None, 2000, 3600, admitted=1),
        _span("engine.sync", 5, 4, 7000, 8920),
        _span("engine.chunk", 4, None, 4000, 9000, k=0, units=2, slots=4,
              active=3, emitted=5),
        _span("engine.queue", 7, 6, 4000, 9150, rid=8),
        _span("engine.prefill", 8, 6, 9110, 9170, rid=8, tokens=100,
              bucket=128),
        _span("engine.sync", 10, 6, 9175, 9190),
        _span("engine.admit", 6, None, 9100, 9200, admitted=1),
        _span("engine.chunk", 9, None, 20000, 30000, k=0, units=2, slots=4,
              active=4, emitted=8),
    ]
    kernels = [(2100, 2250, "prefill_a", 1), (2250, 2500, "prefill_b", 2),
               (4100, 5000, "step", 10), (5000, 6000, "step", 10),
               (6000, 6500, "step", 11), (6500, 7000, "step", 11),
               (9200, 9400, "prefill_a", 30), (9600, 9700, "stray", 20),
               (20100, 22000, "step", 40)]
    runtime = [(2050, 2055, "cudaLaunchKernel", 1),
               (2305, 3560, "cudaMemcpyAsync", 3),
               (4010, 4020, "cudaGraphLaunch", 10),
               (4050, 4060, "cudaGraphLaunch", 11),
               (7010, 8900, "cudaMemcpyAsync", 12),
               (8901, 8905, "cudaStreamSynchronize", 13),
               (9120, 9125, "cudaLaunchKernel", 30),
               (9500, 9505, "cudaLaunchKernel", 20),
               (9600, 9612, "cudaMemcpyAsync", 50),
               (20010, 20020, "cudaGraphLaunch", 40)]
    return found, _timeline(kernels, runtime)


def _read(name, out, monkeypatch, found):
    monkeypatch.setattr(ys, "recorded", lambda: found)
    return Bench().reader(name).read(None, out)


def test_sync_spans_correct_the_mark_only_offset():
    found, tl = _serving()
    st = ys.map_spans(tl, found, _t_open())
    assert st.base == pytest.approx(TRUE + LATE_US)
    assert st.offset == pytest.approx(TRUE - 20)
    assert st.residuals == pytest.approx([0.0, 0.0])
    chunk = st.named("engine.chunk")[0]
    assert (chunk.start, chunk.end) == pytest.approx((3980, 8980))


def test_without_sync_spans_the_marks_alone_set_the_clock():
    found, tl = _serving()
    st = ys.map_spans(tl, [s for s in found if s.name != "engine.sync"],
                      _t_open())
    assert st.offset == st.base and st.residuals == []


def test_kernels_go_to_the_span_that_launched_them():
    found, tl = _serving()
    st = ys.map_spans(tl, found, _t_open())
    owners = [None if o is None else (o.name, o.span.id) for o in st.owners]
    assert owners == [("engine.prefill", 2), ("engine.prefill", 2)] + [
        ("engine.chunk", 4)] * 4 + [("engine.prefill", 8), None,
                                    ("engine.chunk", 9)]
    assert st.device_s(st.named("engine.admit")) == pytest.approx(600e-6)
    assert st.device_by_span() == pytest.approx(
        {"engine.chunk": 3800e-6, "engine.prefill": 600e-6,
         "no span": 100e-6})


def test_idle_time_splits_by_the_span_open_when_each_gap_began():
    found, tl = _serving()
    st = ys.map_spans(tl, found, _t_open())
    assert st.idle_by_span() == pytest.approx(
        {"no span": 11700e-6, "engine.sync": 3800e-6})
    assert sum(st.idle_by_span().values()) == pytest.approx(
        tl.window_s - tl.busy_s())


def test_the_report_names_what_no_span_launched(monkeypatch):
    found, tl = _serving()
    monkeypatch.setattr(ys, "recorded", lambda: found)
    got = ys.report({"timeline": tl, "t_open": _t_open()})
    assert got["unattributed_share"] == pytest.approx(100 * 100 / 4500)
    assert got["sharpened_by_us"] == pytest.approx(-3020)
    assert got["syncs"] == 2 and got["sync_residual_us"]["over_100"] == 0
    assert got["spans_inside"]["engine.chunk"] == 1


@pytest.mark.parametrize("name,want", [
    ("queue_wait_ms.serve", (1505 + 5150) / 2 / 1e3),
    ("prefill_true_share.serve", 100 * 400 / 640),
    ("decode_row_use.serve", 100 * 5 / 8),
    ("prefill_us_per_token.serve", 600 / 400),
    ("decode_step_ms.serve", 2.9 / 2),
])
def test_serving_readers(name, want, monkeypatch):
    found, tl = _serving()
    out = {"timeline": tl, "t_open": _t_open()}
    assert _read(name, out, monkeypatch, found) == pytest.approx(want)


def test_optimizer_share_reads_the_steps_inside_the_slice(monkeypatch):
    """Two steps inside the slice, a third that ends past it; each
    launches a forward kernel of 1000 us, a backward one of 2000 and an
    optimizer one of 1000. Training has no sync span: the marks set the
    clock."""
    found, kernels, runtime = [], [], []
    for i, t in enumerate((2000.0, 8000.0, 20900.0)):
        step, dev = 10 * i, t + 400
        found.append(_span("train.step", step, None, t, t + 300))
        for j, (name, us) in enumerate((("train.forward", 1000),
                                        ("train.backward", 2000),
                                        ("train.optimizer", 1000))):
            lo = t + 10 + 100 * j
            found.append(_span(name, step + j + 1, step, lo, lo + 90))
            runtime.append((lo + 5, lo + 8, "cudaLaunchKernel", step + j))
            kernels.append((dev, dev + us, name, step + j))
            dev += us
    tl = _timeline(kernels, runtime)
    t_open = (LO - TRUE) / 1e6
    out = {"timeline": tl, "t_open": t_open}
    assert _read("optimizer_share.train", out, monkeypatch,
                 found) == pytest.approx(100 * 2000 / 8000)
    st = ys.map_spans(tl, found, t_open)
    assert st.offset == st.base == pytest.approx(TRUE)


@pytest.mark.parametrize("name", ["queue_wait_ms.serve",
                                  "prefill_true_share.serve",
                                  "decode_row_use.serve",
                                  "prefill_us_per_token.serve",
                                  "decode_step_ms.serve",
                                  "optimizer_share.train"])
def test_readers_read_nothing_without_spans(name, monkeypatch):
    """A port that records no span (an older one) leaves the metric out."""
    _, tl = _serving()
    for found in (None, []):
        out = {"timeline": tl, "t_open": _t_open()}
        assert _read(name, out, monkeypatch, found) is None
    assert _read(name, {"t_open": 0.0}, monkeypatch, _serving()[0]) is None


def test_a_port_without_spans_records_none(monkeypatch, tmp_path):
    """Where ``nanotpu_torch.metrics`` has no ``spans`` module (the port
    before its spans), the readers find nothing and raise nothing."""
    import nanotpu_torch.metrics as package

    monkeypatch.delattr(package, "spans")
    monkeypatch.delitem(sys.modules, "nanotpu_torch.metrics.spans")
    monkeypatch.setattr(package, "__path__", [str(tmp_path)])
    assert ys.recorded() is None
    _, tl = _serving()
    out = {"timeline": tl, "t_open": _t_open()}
    for name in ("queue_wait_ms.serve", "optimizer_share.train"):
        assert Bench().reader(name).read(None, out) is None
