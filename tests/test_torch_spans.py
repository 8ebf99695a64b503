"""The port's spans (``nanotpu_torch/metrics/spans.py``) on the CPU: when
recording is on, what a span holds, the bounded buffer, and the spans and
counts that the serving engine and the trainer record, which must not
change a token, a loss or a state."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from nanotpu_torch.metrics import spans
from nanotpu_torch.models import llama as tl
from nanotpu_torch.parallel import train as ttrain
from nanotpu_torch.parallel.mesh import make_mesh
from nanotpu_torch.serving.server import build_engine
from nanotpu_torch.tree import leaves

torch.set_num_threads(2)

TRAIN_CHILDREN = ["train.forward", "train.backward", "train.optimizer"]


@pytest.fixture(autouse=True)
def fresh_recorder():
    spans.enable(False)
    spans.clear()
    yield
    spans.enable(False)
    spans.clear()


def _names():
    return [s.name for s in spans.recorded()]


# -- the recorder --------------------------------------------------------------

def test_the_profiler_flag_the_recorder_reads_is_where_it_was():
    """The recorder reads ``torch.autograd.profiler._is_profiler_enabled``,
    a private module-level bool: a torch that moves it fails here."""
    from torch.autograd import profiler

    assert profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled is True
    assert profiler._is_profiler_enabled is False


def test_recording_is_off_by_default():
    with spans.span("engine.chunk", k=0) as chunk:
        chunk.set(emitted=3)
    spans.record("engine.queue", 0, 1, rid=1)
    assert chunk is spans.NULL and not chunk
    assert spans.recorded() == []


def test_a_profiler_session_records_and_shows_the_spans():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("train.step") as step:
            torch.ones(4).sum()
    assert _names() == ["train.step"] and step
    assert "train.step" in {e.key for e in prof.key_averages()}
    with spans.span("train.step"):
        pass
    assert len(spans.recorded()) == 1


def test_enable_records_outside_a_profiler_session():
    spans.enable()
    with spans.span("engine.sync"):
        pass
    spans.enable(False)
    with spans.span("engine.sync"):
        pass
    assert _names() == ["engine.sync"]
    s = spans.recorded()[0]
    assert s.parent is None and s.rid is None and s.counts == {}
    assert 0 < s.start <= s.end


def test_parents_request_ids_and_counts():
    """A span's parent is the span open on its own thread; a recorded wait
    takes the open span as its parent too."""
    spans.enable()
    seen = []

    def other():
        with spans.span("engine.chunk") as c:
            seen.append(c)

    with spans.span("engine.admit") as admit:
        spans.record("engine.queue", 5, 9, rid=41)
        with spans.span("engine.prefill", rid=41, tokens=3,
                        bucket=32) as prefill:
            worker = threading.Thread(target=other)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
            with spans.span("engine.sync") as sync:
                pass
        admit.set(admitted=1)
    queue = spans.recorded()[0]
    assert (queue.name, queue.parent, queue.rid, queue.start,
            queue.end) == ("engine.queue", admit.id, 41, 5, 9)
    assert prefill.parent == admit.id and prefill.rid == 41
    assert prefill.counts == {"tokens": 3, "bucket": 32}
    assert sync.parent == prefill.id and admit.parent is None
    assert seen[0].parent is None
    assert admit.counts == {"admitted": 1}
    assert admit.start <= prefill.start <= sync.start <= sync.end \
        <= prefill.end <= admit.end
    assert len({s.id for s in spans.recorded()}) == 5


def test_the_buffer_keeps_the_newest_spans():
    rec = spans.Recorder(capacity=3)
    rec.enabled = True
    for i in range(5):
        with rec.span("engine.sync", rid=i):
            pass
    assert [s.rid for s in rec.recorded()] == [2, 3, 4]
    rec.clear()
    assert rec.recorded() == []


def test_nothing_is_recorded_while_a_graph_is_captured(monkeypatch):
    spans.enable()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with spans.span("train.step") as step:
        pass
    assert step is spans.NULL and spans.recorded() == []


# -- the engine ----------------------------------------------------------------

PROMPTS = [[1 + i, 7, 3 + 2 * i] * (2 + 5 * i) for i in range(6)]
NEW = [5, 9, 3, 12, 1, 7]


def _serve(record: bool):
    """Six requests on three slots, queued before the loop takes them."""
    eng = build_engine("tiny", slots=3, max_len=96, device="cpu",
                       buckets=(16, 32, 64), chunk_steps=4,
                       chunk_steps_max=8)
    try:
        assert eng.wait_warm(120)
        spans.enable(record)
        with eng._cv:  # hold the loop until every request is queued
            reqs = [eng.submit(p, n) for p, n in zip(PROMPTS, NEW)]
        for r in reqs:
            assert r.wait(120) and r.error is None
    finally:
        eng.stop()
        spans.enable(False)
    return eng, reqs


@pytest.fixture(scope="module")
def served():
    """(engine, requests, spans) with recording on, and the tokens served
    with it off."""
    spans.enable(False)
    spans.clear()
    _, off = _serve(False)
    assert spans.recorded() == []
    eng, reqs = _serve(True)
    found = spans.recorded()
    spans.clear()
    return eng, reqs, found, [r.out for r in off]


def test_engine_tokens_are_the_same_with_recording_on_and_off(served):
    _, reqs, _, off = served
    assert [r.out for r in reqs] == off
    assert [len(r.out) for r in reqs] == NEW


def test_engine_records_one_queue_span_per_request_from_its_submission(
        served):
    _, reqs, found, _ = served
    queue = {s.rid: s for s in found if s.name == "engine.queue"}
    assert sorted(queue) == sorted(r.id for r in reqs)
    by_id = {s.id: s for s in found}
    for r in reqs:
        q = queue[r.id]
        assert q.start == round(r.submitted_at * 1e9) < q.end
        assert by_id[q.parent].name == "engine.admit"
        assert q.end <= r.first_token_at * 1e9


def test_engine_prefill_counts_sum_to_the_prompts_and_their_buckets(served):
    eng, reqs, found, _ = served
    prefills = [s for s in found if s.name == "engine.prefill"]
    assert sorted(s.rid for s in prefills) == sorted(r.id for r in reqs)
    assert sum(s.counts["tokens"] for s in prefills) == sum(map(len, PROMPTS))
    assert sum(s.counts["bucket"] for s in prefills) == sum(
        eng._prefill_len(len(p)) for p in PROMPTS)
    by_id = {s.id: s for s in found}
    assert {by_id[s.parent].name for s in prefills} == {"engine.admit"}
    admits = [s for s in found if s.name == "engine.admit"]
    assert sum(s.counts["admitted"] for s in admits) == len(PROMPTS)


def test_engine_chunk_counts_sum_to_the_decode_tokens(served):
    """``emitted`` counts every token after each request's first, which
    its prefill gave; each chunk's host fetch is its ``engine.sync``."""
    eng, reqs, found, _ = served
    chunks = [s for s in found if s.name == "engine.chunk"]
    assert sum(s.counts["emitted"] for s in chunks) == \
        eng.tokens_total - len(reqs) == sum(NEW) - len(NEW)
    for s in chunks:
        assert s.counts["k"] == 0 and s.counts["slots"] == 3
        assert 1 <= s.counts["active"] <= 3
        assert s.counts["emitted"] <= s.counts["units"] * s.counts["active"]
    parents = {}
    for s in found:
        if s.name == "engine.sync":
            parents.setdefault(s.parent, []).append(s)
    by_id = {s.id: s for s in found}
    assert {by_id[p].name for p in parents} == {"engine.admit",
                                                "engine.chunk"}
    assert all(len(parents.get(c.id, [])) == 1 for c in chunks)


# -- the trainer ---------------------------------------------------------------

def _tokens(seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (2, 33)).astype(np.int64))


def _train(step_fn, record: bool, n: int = 2):
    cfg = tl.LlamaConfig.tiny()
    opt = ttrain.make_optimizer()
    state = ttrain.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                    device="cpu")
    losses = []
    spans.enable(record)
    try:
        for i in range(n):
            state, loss = step_fn(cfg, opt)(state, _tokens(i))
            losses.append(loss)
    finally:
        spans.enable(False)
    return losses, leaves(state.params) + leaves(state.opt_state)


def _plain(cfg, opt):
    return ttrain.build_train_step(cfg, opt)


def _assert_steps(found, n):
    steps = [s for s in found if s.name == "train.step"]
    assert len(steps) == n and all(s.parent is None for s in steps)
    for step in steps:
        kids = [s for s in found if s.parent == step.id]
        assert [s.name for s in kids] == TRAIN_CHILDREN
        assert step.start <= kids[0].start
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
        assert kids[-1].end <= step.end


@pytest.mark.parametrize("n_fused", [1, 2])
def test_train_steps_are_the_same_with_recording_on_and_off(n_fused):
    """One eager step a call, and two a fused call (eager on the CPU):
    equal losses and states, and each step records its three children
    inside ``train.step``."""
    def fused(cfg, opt):
        step = ttrain.build_train_step(cfg, opt, n_fused=2)
        return lambda state, tokens: step(
            state, torch.stack([tokens, tokens.flip(0)]))

    make = _plain if n_fused == 1 else fused
    off_losses, off_state = _train(make, False)
    assert spans.recorded() == []
    on_losses, on_state = _train(make, True)
    for a, b in zip(on_losses + on_state, off_losses + off_state):
        assert torch.equal(a, b)
    _assert_steps(spans.recorded(), 2 * n_fused)


def test_the_mesh_step_records_the_same_spans(tmp_path):
    """``mesh_train_body`` over a group of one: the backward (with the
    gradients' sums) and the optimizer (with the global norm) are spans."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()

        def meshed(cfg, opt):
            step = ttrain.build_train_step(cfg, opt, mesh=mesh)
            return lambda state, tokens: step(
                ttrain.place_state(state, cfg, mesh), tokens)

        losses, _ = _train(meshed, True, n=1)
        assert torch.isfinite(losses[0])
    finally:
        dist.destroy_process_group()
    _assert_steps(spans.recorded(), 1)


def test_a_graphed_step_is_one_span_a_replay(monkeypatch):
    """``GraphedTrainStep`` records ``train.step`` around each replay,
    and nothing of the captured body (a graph stands in for the card's)."""
    spans.enable()

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    g = ttrain.GraphedTrainStep.__new__(ttrain.GraphedTrainStep)
    g.tokens, g.graph, g.replays = torch.zeros(2), Graph(), 0
    g.launches_per_replay = [0] * len(ttrain._COUNTED)
    for _ in range(3):
        g.step(torch.ones(2))
    assert Graph.replays == g.replays == 3
    assert _names() == ["train.step"] * 3
    assert all(s.parent is None for s in spans.recorded())


def test_the_cli_trace_shows_the_trainers_spans(tmp_path):
    """``--profile-dir`` (CPU activity) shows the spans on the profiler's
    clock."""
    prof = tmp_path / "prof"
    ttrain.run(["--device", "cpu", "--steps", "2", "--seq", "17",
                "--batch", "2", "--data", "markov",
                "--profile-dir", str(prof)])
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    text = traces[0].read_text()
    for name in ["train.step"] + TRAIN_CHILDREN:
        assert f'"{name}"' in text
    assert not spans.RECORDER.enabled

