"""The yardstick's arithmetic against hand-worked cases: window edges,
percentiles, FLOP and byte counts, the trace's busy time and gaps, and
the traffic generator."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from gpubench.yardstick import flops, markov, traffic
from gpubench.yardstick.stats import (Served, percentile, tokens_in_window,
                                      tpot_samples, ttft_samples)
from gpubench.yardstick.trace import Timeline


def test_percentile_interpolates_like_numpy():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0, 10.0, 7.0]
    for q in (0.0, 0.5, 0.95, 1.0):
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, 100 * q))


def _served():
    # a: sent before the window, tokens 1 at 1.0, 5 at 2.5, done at 4.0 (9)
    a = Served(sent=0.5, prompt_len=10, first=1.0, done=4.0,
               seen=[(1.0, 1), (2.5, 5), (4.0, 9)])
    # b: sent inside, first token inside, still running at the close
    b = Served(sent=2.2, prompt_len=20, first=2.8,
               seen=[(2.8, 1), (4.5, 7)])
    # c: sent inside, no first token by the close
    c = Served(sent=4.0, prompt_len=30)
    # d: one token only, done inside
    d = Served(sent=2.1, prompt_len=5, first=2.3, done=2.3,
               seen=[(2.3, 1)])
    return [a, b, c, d]


def test_tokens_at_the_window_edges():
    reqs = _served()
    # window [2.0, 5.0]: a 9-1, b 7-0, c 0, d 1-0
    assert tokens_in_window(reqs, 2.0, 5.0) == 8 + 7 + 0 + 1
    # window [2.0, 3.0]: a 5-1, b 1, d 1
    assert tokens_in_window(reqs, 2.0, 3.0) == 4 + 1 + 1


def test_ttft_counts_stalled_requests_to_the_close():
    reqs = _served()
    got = sorted(ttft_samples(reqs, 2.0, 5.0))
    # a was sent before the window; b 0.6; c waited 1.0; d 0.2
    assert got == pytest.approx([0.2, 0.6, 1.0])


def test_tpot_needs_two_tokens_and_an_end_inside():
    reqs = _served()
    assert tpot_samples(reqs, 2.0, 5.0) == pytest.approx([(4.0 - 1.0) / 8])
    assert tpot_samples(reqs, 4.5, 5.0) == []


def test_active_params_and_flops_by_hand():
    mistral = flops.Shape(layers=32, dim=4096, heads=32, kv_heads=8,
                          head_dim=128, ffn=14336, vocab=32768)
    # attention 4096*128*(64+16) + mlp 3*4096*14336, 32 layers, head
    per_layer = 4096 * 128 * 80 + 3 * 4096 * 14336
    assert mistral.active_params() == 32 * per_layer + 4096 * 32768
    assert mistral.active_params() == 7_113_539_584
    # one token at 100 keys: 2 N + 4 * 32 * 128 * 32 * 100
    assert flops.forward_flops(mistral, 1, 100) == pytest.approx(
        2 * 7_113_539_584 + 4 * 32 * 128 * 32 * 100)
    mixtral = flops.Shape(layers=4, dim=4096, heads=32, kv_heads=8,
                          head_dim=128, ffn=14336, vocab=32000, experts=8,
                          top_k=2)
    per_layer = 4096 * 128 * 80 + 2 * 3 * 4096 * 14336 + 4096 * 8
    assert mixtral.active_params() == 4 * per_layer + 4096 * 32000
    # a step: 3 x (2 N tokens + attention over the causal pairs)
    B, S = 2, 4096
    want = 3 * (2 * mixtral.active_params() * B * S
                + 4 * 32 * 128 * 4 * B * S * (S + 1) / 2)
    assert flops.train_flops(mixtral, B, S) == pytest.approx(want)


def test_flash_bounds_by_hand():
    # S=2048, B=1, 32/8 heads of 128: 4*128*(2048*2049/2)*32 flops
    f = 4 * 128 * (2048 * 2049 // 2) * 32
    b = 2 * 2048 * 128 * (64 + 16)
    assert flops.flash_fwd_bound_s(1, 2048, 32, 8, 128) == pytest.approx(
        max(f / 989e12, b / 3.35e12))
    # chip_smoke's Mixtral row: 0.0348 ms bound
    assert flops.flash_fwd_bound_s(1, 2048, 32, 8, 128) * 1e3 == pytest.approx(
        0.0348, abs=5e-4)
    # chip_smoke's fused backward row: B=4 S=2048 32/8 D=128, 0.348 ms
    assert flops.flash_bwd_bound_s(4, 2048, 32, 8, 128) * 1e3 == pytest.approx(
        0.348, abs=1e-3)
    # a short call is bound by its bytes
    short_bytes = 2 * 16 * 128 * 80
    assert flops.flash_fwd_bound_s(1, 16, 32, 8, 128) == pytest.approx(
        short_bytes / 3.35e12)


def _events(kernels, runtime=()):
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": s, "dur": d,
           "args": {"correlation": c}} for n, s, d, c in kernels]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": n, "ts": s, "dur": d,
            "args": {"correlation": c}} for n, s, d, c in runtime]
    return ev


def test_busy_time_is_the_union_of_intervals():
    tl = Timeline.from_events(_events([
        ("spin_kernel", 100.0, 1.0, 0),
        ("a", 90.0, 20.0, 1),    # starts before the slice: clipped to 100
        ("b", 105.0, 12.0, 2),   # overlaps a (another stream)
        ("c", 130.0, 10.0, 3),
        ("d", 195.0, 50.0, 4),   # runs past the slice: clipped to 201
        ("spin_kernel", 200.0, 1.0, 5),
    ], runtime=[("cudaMemcpyAsync", 118.0, 15.0, 9),
                ("cudaLaunchKernel", 190.0, 2.0, 4)]))
    assert tl.window_s == pytest.approx(101e-6)
    # [100, 117] + [130, 140] + [195, 201] = 17 + 10 + 6
    assert tl.busy_s() == pytest.approx(33e-6)
    gaps = tl.idle_gaps()
    assert [round(g[1] * 1e6, 6) for g in gaps] == [55.0, 13.0]
    assert gaps[0][0].startswith("host launching d by cudaLaunchKernel")
    assert gaps[1][0] == "host in cudaMemcpyAsync"
    top = tl.top_ops()
    assert top[0][0] == "b" and top[0][1] == pytest.approx(12e-6)
    assert [k.name for k in tl.inside()] == ["b", "c", "d"]


def test_a_trace_without_its_marks_is_refused():
    with pytest.raises(RuntimeError):
        Timeline.from_events(_events([("a", 0.0, 1.0, 1)]))


def test_every_seed_asks_for_the_same_work():
    mix = {"block": 64,
           "prompt": {"dist": "lognormal", "median": 512, "sigma": 0.9,
                      "min": 32, "max": 3072},
           "output": {"dist": "uniform", "min": 16, "max": 64}}
    for seed in (0, 7, 2**33 + 1):
        reqs = traffic.Requests(mix, seed, vocab=1000)
        drawn = [reqs.next() for _ in range(128)]
        assert all(0 <= t < 1000 for ids, _ in drawn for t in ids)
        lengths = sorted(len(ids) for ids, _ in drawn[:64])
        assert lengths == sorted(traffic.quantile_lengths(mix["prompt"], 64))
        outs = sorted(n for _, n in drawn[64:])
        assert outs == sorted(traffic.quantile_lengths(mix["output"], 64))
    a = traffic.Requests(mix, 5, 1000)
    b = traffic.Requests(mix, 5, 1000)
    assert [a.next() for _ in range(70)] == [b.next() for _ in range(70)]


def test_quantile_lengths():
    lengths = traffic.quantile_lengths(
        {"dist": "lognormal", "median": 512, "sigma": 0.9, "min": 32,
         "max": 3072}, 64)
    assert lengths.min() >= 32 and lengths.max() == 3072
    assert np.median(lengths) == pytest.approx(512, rel=0.05)
    uni = traffic.quantile_lengths({"dist": "uniform", "min": 16, "max": 64}, 4)
    assert uni.tolist() == [22, 34, 46, 58]


def test_markov_batches_follow_the_table():
    succ = markov.table(50, 4, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(1)
    b = markov.batches(succ, [2.0, 1.0, 0.0, -1.0], (3, 2, 33), gen)
    assert b.shape == (3, 2, 33)
    rows = b.reshape(-1, 33)
    for row in rows:
        for s in range(32):
            assert int(row[s + 1]) in succ[int(row[s])].tolist()
    assert not math.isclose(float(rows.float().std()), 0.0)


def test_the_serving_number_is_the_mean_gap():
    from gpubench.yardstick.compare import logit_gaps, serve_numbers

    ref = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.5, 2.5], [1.0, 1.0, 0.0]])
    gaps = logit_gaps(ref, [1, 2, 2])
    assert gaps == pytest.approx([0.0, 0.5, 1.0])
    assert serve_numbers(gaps) == {"mean_gap": pytest.approx(0.5)}
    assert math.isinf(serve_numbers([])["mean_gap"])


def test_the_forward_roofline_reads_only_one_call_a_layer_a_prefill():
    from types import SimpleNamespace

    from gpubench.spec import Bench

    reader = Bench().reader("flash_fwd_roofline.serve")
    shape = flops.Shape(layers=2, dim=64, heads=4, kv_heads=2, head_dim=16,
                        ffn=128, vocab=100, experts=0, top_k=0)
    run = SimpleNamespace(shape=shape)
    calls = [("flash_fwd_bf16<16, 2>", 10.0 + 10 * i, 5.0, i) for i in range(4)]
    tl = Timeline.from_events(_events(
        [("spin_kernel", 0.0, 1.0, 90)] + calls
        + [("spin_kernel", 100.0, 1.0, 91)]))
    reqs = [Served(sent=0.0, prompt_len=n) for n in (64, 32)]
    out = {"timeline": tl, "requests": reqs, "prefilled": 2}
    want = sum(2 * flops.flash_fwd_bound_s(1, n, 4, 2, 16) for n in (64, 32))
    assert reader.read(run, out) == pytest.approx(100 * want / 20e-6)
    # a third prefill whose calls the trace lacks, or a batched prefill
    assert reader.read(run, dict(out, prefilled=3)) is None
    assert reader.read(run, dict(out, prefilled=1)) is None
