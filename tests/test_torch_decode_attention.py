"""The decode attend over the slot cache (``nanotpu_torch.ops.decode_attention``)
on the CPU: the wrapper's dispatch and checks, the plain version against an
independent dense float32 reference and against nanotpu's ``_attend_rows``,
the split span's rule, and the engine's call site. The kernel itself is
held against the plain version on the card (``tests/test_torch_cuda.py``).

The dense reference repeats each kv head over its query heads and masks
each (row, query) on its own, in loops: it shares no reshape, einsum or
broadcast with the plain version. float32 throughout; 1e-5 absolute
(summation order only)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanotpu.serving import engine as je
from nanotpu_torch.ops import decode_attention as da


def _inputs(B, S, H, KV, D, T, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=gen).to(dtype)
    k = torch.randn((B, T, KV, D), generator=gen).to(dtype)
    v = torch.randn((B, T, KV, D), generator=gen).to(dtype)
    base = torch.randint(0, T, (B,), generator=gen)
    base[:2] = torch.tensor([0, T - 1])  # an empty slot, a frozen row
    return q, k, v, base.to(torch.int32)


def _dense_ref(q, k, v, base):
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    kr = k.float().repeat_interleave(H // KV, dim=2)
    vr = v.float().repeat_interleave(H // KV, dim=2)
    out = torch.zeros((B, S, H, D))
    for b in range(B):
        for s in range(S):
            n = min(int(base[b]) + s + 1, T)
            for h in range(H):
                w = kr[b, :n, h] @ q[b, s, h].float() / math.sqrt(D)
                out[b, s, h] = torch.softmax(w, dim=0) @ vr[b, :n, h]
    return out


@pytest.mark.parametrize("S", [1, 3, 5])
@pytest.mark.parametrize("H,KV", [(8, 2), (4, 4), (8, 1)])
def test_plain_equals_a_dense_reference_at_ragged_lengths(S, H, KV):
    q, k, v, base = _inputs(5, S, H, KV, 16, 37, seed=S * H + KV)
    got = da.attend_rows_ref(q, k, v, base)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert (got - _dense_ref(q, k, v, base)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("S", [1, 4])
def test_plain_equals_nanotpus_attend_rows(S):
    q, k, v, base = _inputs(4, S, 8, 2, 16, 29, seed=S)
    want = je._attend_rows(*(jnp.asarray(t.numpy()) for t in (q, k, v, base)))
    got = da.attend_rows_ref(q, k, v, base)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch(dtype):
    q, k, v, base = _inputs(3, 2, 8, 2, 16, 21, seed=1, dtype=dtype)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, base)
    assert da.decode_attention.launches == before
    assert torch.equal(got, da.attend_rows_ref(q, k, v, base))


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "rank", "head_split",
                                 "cache_shape", "base_dtype", "base_shape"])
def test_wrapper_refuses_what_no_path_takes(bad):
    q, k, v, base = _inputs(3, 2, 8, 2, 16, 21, seed=2)
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "rank":
        q = q[:, 0]
    elif bad == "head_split":
        q = torch.randn((3, 2, 6, 16))
        k = v = torch.randn((3, 21, 4, 16))
    elif bad == "cache_shape":
        v = v[:, :20]
    elif bad == "base_dtype":
        base = base.long()
    else:
        base = base[:2]
    with pytest.raises((TypeError, ValueError)):
        da.decode_attention(q, k, v, base)


def test_split_span_follows_the_shapes_alone():
    """512 where a full cache's units fill four blocks an SM, halved down
    to one 64-position tile where they do not; always a multiple of 64."""
    assert da.split_span(32, 8, 4096, 132) == 512  # chat's cache
    assert da.split_span(8, 8, 8192, 132) == 512   # long prompts'
    assert da.split_span(4, 8, 4096, 132) == 128
    assert da.split_span(4, 2, 200, 132) == 64
    for B, KV, T in ((1, 1, 1), (3, 4, 77), (64, 8, 32768)):
        span = da.split_span(B, KV, T, 132)
        assert span in (64, 128, 256, 512)


def test_engine_rows_forward_attends_through_the_wrapper(monkeypatch):
    """``_rows_forward`` calls the wrapper once a layer, with each layer's
    whole cache views and the rows' lengths."""
    from nanotpu_torch.models.llama import LlamaConfig, init_params
    from nanotpu_torch.serving import engine

    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = engine.SlotCache.create(cfg, 3, 32, device="cpu")
    cache.lengths.copy_(torch.tensor([0, 4, 31], dtype=torch.int32))
    calls = []

    def spy(q, k_view, v_view, base):
        calls.append((tuple(k_view.shape), base.clone()))
        return da.decode_attention(q, k_view, v_view, base)

    monkeypatch.setattr(engine, "decode_attention", spy)
    tokens = torch.tensor([[1, 2], [3, 4], [5, 6]])
    engine._rows_forward(params, cfg, cache, tokens,
                         torch.ones(3, dtype=torch.int32))
    assert len(calls) == cfg.n_layers
    for shape, base in calls:
        assert shape == (3, 32, cfg.n_kv_heads, cfg.head_dim)
        assert base.tolist() == [0, 4, 31]


@pytest.mark.parametrize("speculative", [False, True])
def test_engine_attends_once_a_layer_of_every_unit_it_runs(monkeypatch,
                                                           speculative):
    """An eager engine attends once a layer of each ``_rows_forward``: a
    decode unit runs the target's once and a speculative cycle of K the
    draft's K + 1 times besides, in the warm-up's one run of each unit and
    in every unit its chunks ran (``Engine.units_run``). On a card these
    are the decode kernel's launches, which ``chip_smoke.py`` holds to this
    count."""
    from nanotpu_torch.models import distill
    from nanotpu_torch.models.llama import LlamaConfig, init_params
    from nanotpu_torch.serving import engine

    calls = []

    def spy(q, k_view, v_view, base):
        calls.append(q.shape[1])
        return da.decode_attention(q, k_view, v_view, base)

    monkeypatch.setattr(engine, "decode_attention", spy)
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    kw, dcfg = {}, None
    if speculative:
        dcfg = distill.draft_config(cfg, n_layers=1)
        kw = dict(draft_params=distill.init_draft(
            torch.Generator().manual_seed(1), params, cfg, dcfg),
            draft_cfg=dcfg, draft_tokens=2, spec_policy="always")
    eng = engine.Engine(params, cfg, slots=2, max_len=64, buckets=(16,),
                        device="cpu", **kw)
    try:
        reqs = [eng.submit(p, 5) for p in ([1, 2, 3], [4, 5, 6, 7, 8])]
        assert all(r.wait(60) and not r.error for r in reqs)
    finally:
        eng.stop()
    want = 0
    for k, units in eng.units_run.items():
        per_unit = cfg.n_layers + (k + 1) * dcfg.n_layers if k else \
            cfg.n_layers
        want += (1 + units) * per_unit
    assert sum(eng.units_run.values()) > 0
    assert (sum(n for k, n in eng.units_run.items() if k) > 0) == speculative
    assert len(calls) == want
