"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a card. This file imports no jax,
so it runs where the card is: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``.

Tolerances: forward, bf16 2e-2 against the plain version in f32 on the same
inputs (the kernel rounds only its output to bf16); f32 1e-4 (summation
order). Backward, bf16 2e-2 element by element, of |want| plus the RMS of
want's row over the last axis (at least 1e-3): p and ds are rounded to bf16
for their products, as on the TPU, and the fused pass sums dq (by tile
in bf16, by element in f32) in no fixed order, while a dropped tile costs
most of |want| in each row it touches; f32 1e-4 of the largest magnitude,
at least 1.

Serving extensions (int8 weights, int8 KV cache, speculative decoding,
Mixtral MoE): the same code on card tensors against CPU tensors, f32 with TF32 off (products
within 1e-5 of their largest magnitude, bf16 within 2e-2; greedy tokens
equal), and greedy speculative decoding equal to plain greedy in f32."""

import dataclasses

import pytest
import torch

from nanotpu_torch.models import generate as tg
from nanotpu_torch.models import llama as tl
from nanotpu_torch.models import quant as tq
from nanotpu_torch.models import speculative as tspec
from nanotpu_torch.models.distill import draft_config, init_draft
from nanotpu_torch.models.llama import LlamaConfig, init_params
from nanotpu_torch.ops import attention as att
from nanotpu_torch.ops.attention import attention_lse_ref, flash_attention
from nanotpu_torch.tree import leaves

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,causal", [(1, True), (77, True), (300, False)])
@pytest.mark.parametrize("H,KV", [(8, 2), (4, 4)])
def test_kernel_matches_plain(card, dtype, D, S, causal, H, KV):
    gen = torch.Generator(device=card).manual_seed(S + D)
    q = torch.randn((2, S, H, D), generator=gen, device=card).to(dtype)
    k = torch.randn((2, S, KV, D), generator=gen, device=card).to(dtype)
    v = torch.randn((2, S, KV, D), generator=gen, device=card).to(dtype)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal, need_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref_out, ref_lse = attention_lse_ref(q.float(), k.float(), v.float(),
                                         causal)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - ref_out).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_reads_strided_inputs(card, dtype):
    """q/k/v as views of one fused projection: no copy, same answer."""
    qkv = torch.randn((1, 50, 16, 64), device=card).to(dtype)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:12], qkv[:, :, 12:]
    assert not q.is_contiguous()
    out = flash_attention(q, k, v, True)
    ref, _ = attention_lse_ref(q.float(), k.float(), v.float(), True)
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_bf16_kernel_refuses_misaligned_rows(card):
    x = torch.randn((1, 8, 2, 65), device=card).bfloat16()[..., 1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(x, x, x)


@pytest.mark.cuda
def test_flash_prefill_launches_once_per_layer(card):
    cfg = dataclasses.replace(LlamaConfig.tiny(), dim=256, n_heads=4,
                              n_kv_heads=2, attn_impl="flash")
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0),
                         device=card)
    prompt = torch.randint(0, cfg.vocab_size, (1, 40), device=card)
    before = flash_attention.launches
    flash = tg.generate(params, prompt, cfg, 8)
    assert flash_attention.launches == before + cfg.n_layers
    dense = tg.generate(params, prompt, dataclasses.replace(cfg, attn_impl="dense"), 8)
    assert flash.tolist() == dense.tolist()


# -- the decode attend over the slot cache (ops/csrc/decode_attn.cu) --------

def _decode_inputs(card, dtype, B, S, H, KV, D, T, seed):
    """q, k, v on the card and ragged bases: an empty slot (0), a frozen
    row at T - 1 (with S > 1 its later frontiers pass T), a row whose last
    query ends exactly at T, and the rest drawn."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    q, k, v = mk(B, S, H, D), mk(B, T, KV, D), mk(B, T, KV, D)
    base = torch.randint(0, T, (B,), generator=gen, device=card)
    base[:3] = torch.tensor([0, T - 1, max(T - S, 0)])
    return q, k, v, base.to(torch.int32)


#: the decode kernel besides TOL: each error over |want| plus the RMS of
#: want's row (one query row of one head). At a serving cache's lengths the
#: outputs are ~0.02-0.07, under TOL's 2e-2. At chat's and long prompts'
#: caches a 64-position tile left out reads 0.65-3.4, the kernel in bf16
#: 0.005-0.007 (chip_smoke.py's DECODE_ROW_TOL, H100).
DECODE_ROW_TOL = 0.02


def _decode_err(card, dtype, B, S, H, KV, D, T, seed=0):
    """(largest absolute error, largest row-scaled error) of the kernel
    against the plain version in f32; NaN fails every bound."""
    from nanotpu_torch.ops.decode_attention import (attend_rows_ref,
                                                    decode_attention)

    q, k, v, base = _decode_inputs(card, dtype, B, S, H, KV, D, T, seed)
    before = decode_attention.launches
    out = decode_attention(q, k, v, base)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = attend_rows_ref(q.float(), k.float(), v.float(), base)
    diff = (out.float() - want).abs()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    return diff.max().item(), (diff / (want.abs() + rms)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 3, 5])
@pytest.mark.parametrize("H,KV", [(32, 8), (8, 2), (4, 4), (8, 1)])
def test_decode_kernel_matches_plain(card, dtype, D, S, H, KV):
    """The kernel against the plain version in f32 on the same inputs, at
    ragged bases and T = 200 (a split's span is 64 positions at this
    size: several spans a row, the last one ragged)."""
    err, row_err = _decode_err(card, dtype, 6, S, H, KV, D, 200, seed=S)
    assert err <= TOL[dtype] and row_err <= DECODE_ROW_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,KV,D,T", [
    (32, 1, 32, 8, 128, 4096),  # a Mistral decode step over chat's cache
    (8, 1, 32, 8, 128, 8192),   # over long prompts' cache
    (3, 9, 32, 4, 64, 300),     # 72 query rows a kv head: two groups
    (3, 17, 8, 8, 128, 77),     # one position tile, S past a group
])
def test_decode_kernel_matches_plain_at_scale(card, dtype, B, S, H, KV, D, T):
    """Spans of 512 on the grid of every span (those past a row's length
    return at once), and query rows past one group of 64."""
    err, row_err = _decode_err(card, dtype, B, S, H, KV, D, T, seed=T)
    assert err <= TOL[dtype] and row_err <= DECODE_ROW_TOL


@pytest.mark.cuda
def test_decode_kernel_refuses_what_it_cannot_take(card):
    from nanotpu_torch.ops.decode_attention import decode_attention

    q, k, v, base = _decode_inputs(card, torch.bfloat16, 4, 1, 8, 2, 64, 64, 0)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                         v[..., :32].contiguous(), base)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, k.transpose(0, 1).contiguous().transpose(0, 1),
                         v, base)
    with pytest.raises(ValueError, match="one device"):
        decode_attention(q, k, v, base.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_launches_once_per_layer_in_a_captured_unit(card,
                                                                   dtype):
    """The plain decode unit of a tiny Llama captured as a CUDA graph: one
    decode kernel launch a layer in each of the two eager warm-up runs and
    the capture, none in a replay (the counter is the host's); the replay
    writes the eager run's logits."""
    from nanotpu_torch.ops.decode_attention import decode_attention
    from nanotpu_torch.serving.engine import SlotCache, _rows_forward
    from nanotpu_torch.serving.graphs import StepGraph

    cfg, _, _, (params, _) = _serving_models(card)
    if dtype == "bfloat16":
        cfg, params = dataclasses.replace(cfg, dtype=dtype), _bf16(params)
    cache = SlotCache.create(cfg, 4, 128, device=card)
    cache.lengths.copy_(torch.tensor([0, 5, 64, 127], dtype=torch.int32))
    tokens = torch.tensor([[3], [1], [4], [1]], device=card)
    frozen = torch.zeros((4,), dtype=torch.int32, device=card)
    logits = torch.empty((4, 1, cfg.vocab_size), device=card)

    def body():
        logits.copy_(_rows_forward(params, cfg, cache, tokens, frozen)[0])

    before = decode_attention.launches
    graph = StepGraph(body, torch.Generator(device=card),
                      torch.cuda.graph_pool_handle(), torch.cuda.Stream(card))
    assert decode_attention.launches - before == \
        (StepGraph.WARMUP_RUNS + 1) * cfg.n_layers
    eager = logits.clone()
    logits.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert decode_attention.launches - before == \
        (StepGraph.WARMUP_RUNS + 1) * cfg.n_layers
    assert torch.equal(logits, eager)


def _bwd_inputs(card, dtype, B, S, H, KV, D, causal, seed):
    gen = torch.Generator(device=card).manual_seed(seed)

    def mk(heads):
        return torch.randn((B, S, heads, D), generator=gen, device=card).to(dtype)

    q, k, v, dout = mk(H), mk(KV), mk(KV), mk(H)
    out, lse = flash_attention(q, k, v, causal, need_lse=True)
    return q, k, v, out.detach(), lse.detach(), dout


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1.0)).item()


def _row_err(got, want):
    """The largest |got - want| / (|want| + the RMS of want's row over the
    last axis, at least 1e-3): no gradient row is too small to be held."""
    want = want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-3)
    return ((got.float() - want).abs() / (want.abs() + rms)).max().item()


def _grad_err(got, want, dtype):
    return _row_err(got, want) if dtype == torch.bfloat16 else _rel_err(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "two_pass"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 77, 300])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(8, 2), (4, 4)])
def test_bwd_kernels_match_plain(card, path, dtype, D, S, causal, H, KV):
    q, k, v, out, lse, dout = _bwd_inputs(card, dtype, 2, S, H, KV, D, causal,
                                          S + D + H)
    want = att.attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                 lse, dout.float(), causal)
    dvec = att._dvec(out, dout)
    if path == "fused":
        before = att.flash_bwd_fused.launches
        got = att.flash_bwd_fused(q, k, v, dout, lse, dvec, causal)
        assert att.flash_bwd_fused.launches == before + 1
    else:
        before = (att.flash_bwd_dq.launches, att.flash_bwd_dkv.launches)
        got = (att.flash_bwd_dq(q, k, v, dout, lse, dvec, causal),
               *att.flash_bwd_dkv(q, k, v, dout, lse, dvec, causal))
        assert (att.flash_bwd_dq.launches,
                att.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    for name, g, w, like in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == like.shape and g.dtype == dtype, name
        err = _row_err(g, w) if dtype == torch.bfloat16 else (
            (g - w).abs().max().item())
        assert err <= TOL[dtype], (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lse_cotangent_reaches_qkv_on_card(card, dtype):
    """flash_attention_lse's lse gradient folds into D: the same q/k/v
    gradients as autograd of the plain version, taken at the cotangents the
    loss gives the kernel's outputs (2 out, 2 lse). In bf16 these differ
    from the plain version's own (out is rounded), which moves short rows'
    dq by more than the kernels' rounding does."""
    gen = torch.Generator(device=card).manual_seed(7)
    q, k, v = (torch.randn((2, 100, h, 64), generator=gen, device=card)
               .to(dtype).requires_grad_(True) for h in (8, 2, 2))
    out, lse = att.flash_attention_lse(q, k, v, True)
    g = torch.autograd.grad((lse ** 2).sum() + (out.float() ** 2).sum(),
                            (q, k, v))
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(attention_lse_ref(qf, kf, vf, True), (qf, kf, vf),
                               (2 * out.detach().float(), 2 * lse.detach()))
    for a, b in zip(g, want):
        assert _grad_err(a, b, dtype) <= TOL[dtype]


@pytest.mark.cuda
def test_flash_attention_has_a_gradient_on_card(card):
    """The regression test of a forward kernel whose output had no grad_fn:
    q, k and v all get gradients, equal to the plain version's."""
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn((1, 64, h, 64), generator=gen, device=card)
               .requires_grad_(True) for h in (4, 2, 2))
    out = flash_attention(q, k, v, True)
    assert out.grad_fn is not None
    g = torch.autograd.grad(out.sum(), (q, k, v))
    qf, kf, vf = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(attention_lse_ref(qf, kf, vf, True)[0].sum(),
                               (qf, kf, vf))
    for a, b in zip(g, want):
        assert (a - b).abs().max().item() <= TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["off", "full", "dots"])
def test_llama_flash_loss_gives_every_weight_a_gradient(card, remat):
    """loss.backward() through attn_impl="flash" reaches wq/wk/wv, and every
    gradient equals the dense path's (f32, 1e-4 of its magnitude)."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), dim=256, n_heads=4,
                              n_kv_heads=2, attn_impl="flash",
                              remat=remat != "off",
                              remat_policy="full" if remat == "off" else remat)
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0),
                         device=card)
    weights = leaves(params)
    for leaf in weights:
        leaf.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 70), device=card)
    before = att.flash_bwd_fused.launches
    flash = torch.autograd.grad(tl.loss_fn(params, tokens, cfg), weights)
    assert att.flash_bwd_fused.launches == before + cfg.n_layers
    dense = torch.autograd.grad(
        tl.loss_fn(params, tokens, dataclasses.replace(cfg, attn_impl="dense")),
        weights)
    for a, b in zip(flash, dense):
        assert a is not None and a.abs().sum().item() > 0
        assert _rel_err(a, b) <= TOL[torch.float32]


def _bwd_case(card, dtype, B, S, H, KV, D, causal, seed):
    """Inputs, the plain version's (dq, dk, dv) in f32, and D."""
    q, k, v, out, lse, dout = _bwd_inputs(card, dtype, B, S, H, KV, D, causal,
                                          seed)
    want = att.attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                 lse, dout.float(), causal)
    return q, k, v, dout, lse, att._dvec(out, dout), want


#: the bf16 dk/dv kernel's tile edges: S around its 64-query and 128-key
#: tiles, with a ragged long S; GQA 4:1, MHA and MQA; both head dims. Every
#: combination causal, and the non-causal ones where S is ragged.
_EDGE_CASES = [(S, hk, D, True) for S in (63, 64, 65, 127, 128, 129, 2047)
               for hk in ((16, 4), (8, 8), (8, 1)) for D in (64, 128)] + [
    (S, hk, D, False) for S in (63, 129, 2047)
    for hk in ((16, 4), (8, 8), (8, 1)) for D in (64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,hk,D,causal", _EDGE_CASES)
def test_bf16_kv_kernels_at_tile_edges(card, S, hk, D, causal):
    """The fused pass and the dk/dv pass against the plain version where
    the tiles end: a key tile that is partly or wholly past S, a query
    tile that is, and the causal diagonal inside a 128-key tile."""
    H, KV = hk
    B = 1 if S > 1000 else 2
    q, k, v, dout, lse, dvec, want = _bwd_case(card, torch.bfloat16, B, S, H,
                                               KV, D, causal, S + H + D)
    fused = att.flash_bwd_fused(q, k, v, dout, lse, dvec, causal)
    dkv = att.flash_bwd_dkv(q, k, v, dout, lse, dvec, causal)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv", "dk 2-pass", "dv 2-pass"),
                          (*fused, *dkv), (*want, *want[1:])):
        assert _row_err(g, w) <= TOL[torch.bfloat16], name


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "two_pass"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_kernels_read_strided_inputs(card, path, dtype):
    """q/k/v as views of one fused projection (the tensor maps and the
    f32 kernels read them through their strides): the same gradients."""
    gen = torch.Generator(device=card).manual_seed(11)
    qkv = torch.randn((2, 200, 24, 64), generator=gen, device=card).to(dtype)
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:20], qkv[:, :, 20:]
    assert not q.is_contiguous() and not k.is_contiguous()
    dout = torch.randn((2, 200, 16, 64), generator=gen, device=card).to(dtype)
    out, lse = flash_attention(q, k, v, True, need_lse=True)
    dvec = att._dvec(out, dout)
    want = att.attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                 lse, dout.float(), True)
    if path == "fused":
        got = att.flash_bwd_fused(q, k, v, dout, lse, dvec, True)
    else:
        got = (att.flash_bwd_dq(q, k, v, dout, lse, dvec, True),
               *att.flash_bwd_dkv(q, k, v, dout, lse, dvec, True))
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _grad_err(g, w, dtype) <= TOL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_bf16_dk_dv_repeat_bit_for_bit(card, D):
    """dk and dv stay in registers and are written once (no atomics touch
    them): two runs give the same bits, in the fused pass and in the dk/dv
    pass; dq's tile reduce has no fixed order and is not held to this."""
    q, k, v, dout, lse, dvec, _ = _bwd_case(card, torch.bfloat16, 2, 1000, 8,
                                            2, D, True, D)
    for fn in (att.flash_bwd_fused, att.flash_bwd_dkv):
        first = fn(q, k, v, dout, lse, dvec, True)[-2:]
        again = fn(q, k, v, dout, lse, dvec, True)[-2:]
        for a, b in zip(first, again):
            assert torch.equal(a, b), fn.__name__


#: the Q-stationary bf16 kernels' (forward and two-pass dq) tile edges: S
#: around their 128-row blocks, 64-row warpgroups and 64- or 128-key
#: tiles, and a ragged long S
_Q_EDGES = [1, 63, 64, 65, 127, 128, 129, 2047]


@pytest.mark.cuda
@pytest.mark.parametrize("need_lse", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV,D", [(16, 4, 64), (8, 1, 128)])
@pytest.mark.parametrize("S", _Q_EDGES)
def test_bf16_forward_at_tile_edges(card, S, H, KV, D, causal, need_lse):
    """The bf16 forward against the plain version where its tiles end: a
    query block or key tile partly or wholly past S, and the causal
    diagonal inside a 128-key tile; out, and lse where asked for."""
    B = 1 if S > 1000 else 2
    gen = torch.Generator(device=card).manual_seed(S + H + D)
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=card).bfloat16()
               for h in (H, KV, KV))
    got = flash_attention(q, k, v, causal, need_lse=need_lse)
    out, lse = got if need_lse else (got, None)
    torch.cuda.synchronize()
    ref_out, ref_lse = attention_lse_ref(q.float(), k.float(), v.float(),
                                         causal)
    assert (out.float() - ref_out).abs().max().item() <= TOL[torch.bfloat16]
    if need_lse:
        assert (lse - ref_lse).abs().max().item() <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 129, 191, 192, 193, 383, 385, 2047])
def test_bf16_forward_three_warpgroups_at_tile_edges(card, S, causal):
    """At D=64 the forward gives an item three warpgroups (192 rows) when
    there are items enough for two rounds of its one-block-an-SM grid: B is
    sized for that here, and S is taken around the 192-row items, whose
    causal diagonal can cross two 128-key tiles."""
    H, KV, D = 16, 4, 64
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    B = -(-2 * sms // (H * -(-S // 192)))
    gen = torch.Generator(device=card).manual_seed(S + 3)
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=card).bfloat16()
               for h in (H, KV, KV))
    out, lse = flash_attention(q, k, v, causal, need_lse=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = attention_lse_ref(q.float(), k.float(), v.float(),
                                         causal)
    assert (out.float() - ref_out).abs().max().item() <= TOL[torch.bfloat16]
    assert (lse - ref_lse).abs().max().item() <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV,D", [(16, 4, 64), (8, 1, 128)])
@pytest.mark.parametrize("S", _Q_EDGES)
def test_bf16_dq_at_tile_edges(card, S, H, KV, D, causal):
    """The two-pass dq kernel against the plain version at the same edges."""
    B = 1 if S > 1000 else 2
    q, k, v, dout, lse, dvec, want = _bwd_case(card, torch.bfloat16, B, S, H,
                                               KV, D, causal, S + H + D + 1)
    dq = att.flash_bwd_dq(q, k, v, dout, lse, dvec, causal)
    torch.cuda.synchronize()
    assert dq.shape == q.shape and dq.dtype == torch.bfloat16
    assert _row_err(dq, want[0]) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_bf16_forward_and_dq_read_strided_inputs(card, D):
    """q/k/v and dO as views of fused projections, at a ragged S: the
    tensor maps read them through their strides, no copy, same answers."""
    gen = torch.Generator(device=card).manual_seed(D + 5)
    qkv = torch.randn((2, 300, 12, D), generator=gen, device=card).bfloat16()
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    dout = torch.randn((2, 300, 16, D), generator=gen,
                       device=card).bfloat16()[:, :, ::2]
    assert not q.is_contiguous() and not dout.is_contiguous()
    out, lse = flash_attention(q, k, v, True, need_lse=True)
    ref_out, ref_lse = attention_lse_ref(q.float(), k.float(), v.float(), True)
    dvec = att._dvec(out, dout)
    dq = att.flash_bwd_dq(q, k, v, dout, lse, dvec, True)
    torch.cuda.synchronize()
    assert (out.float() - ref_out).abs().max().item() <= TOL[torch.bfloat16]
    assert (lse - ref_lse).abs().max().item() <= TOL[torch.bfloat16]
    want = att.attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                 lse, dout.float(), True)
    assert _row_err(dq, want[0]) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_bf16_dq_repeats_bit_for_bit(card, D):
    """The two-pass dq stays in registers and is written once (no atomics):
    two runs give the same bits."""
    q, k, v, dout, lse, dvec, _ = _bwd_case(card, torch.bfloat16, 2, 1000, 8,
                                            2, D, True, D + 1)
    first = att.flash_bwd_dq(q, k, v, dout, lse, dvec, True)
    again = att.flash_bwd_dq(q, k, v, dout, lse, dvec, True)
    assert torch.equal(first, again)


# -- serving extensions: int8 weights, int8 KV cache, speculation -----------

def _serving_models(card):
    """A small f32 target with flash prefill and its 1-layer draft (tied,
    truncated init), on the card and as CPU copies."""
    from nanotpu_torch.tree import map_tree

    cfg = dataclasses.replace(LlamaConfig.tiny(), dim=256, n_heads=4,
                              n_kv_heads=2, max_seq_len=128,
                              attn_impl="flash")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    dcfg = draft_config(cfg, n_layers=1, ffn_dim=cfg.ffn_dim)
    draft = init_draft(torch.Generator().manual_seed(1), params, cfg, dcfg)
    on_card = map_tree(lambda t: t.to(card), params)
    d_card = map_tree(lambda t: t.to(card), draft)
    for name in ("embed", "final_norm", "lm_head"):
        d_card[name] = on_card[name]
    return cfg, dcfg, (params, draft), (on_card, d_card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_in,n_out", [(1024, 2816), (2816, 1024),
                                        (1024, 32768)])
def test_quant_matmul_on_card_matches_cpu(card, dtype, n_in, n_out):
    gen = torch.Generator().manual_seed(n_out)
    w = torch.randn((n_in, n_out), generator=gen) / n_in ** 0.5
    x = torch.randn((8, 1, n_in), generator=gen).to(dtype)
    q = tq.quantize(w)
    assert torch.equal(tq.quantize(w.to(card)).q.cpu(), q.q)
    got = tq.matmul(x.to(card), tq.QArray(q.q.to(card), q.s.to(card)))
    want = tq.matmul(x.float(), q)
    err = (got.float().cpu() - want).abs().max() / want.abs().max()
    assert got.dtype == dtype
    assert err.item() <= (2e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
def test_quantize_kv_on_card_matches_cpu(card):
    from nanotpu_torch.serving.engine import quantize_kv

    x = torch.randn((8, 300, 8, 64), generator=torch.Generator().manual_seed(3))
    for dtype in (torch.bfloat16, torch.float32):
        q, s = quantize_kv(x.to(dtype))
        qc, sc = quantize_kv(x.to(dtype).to(card))
        assert torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), s)


@pytest.mark.cuda
def test_kv_int8_engine_on_card_matches_cpu(card):
    """The int8-KV engine over int8 weights gives the same greedy tokens on
    the card as on the CPU, flash prefill included."""
    from nanotpu_torch.serving.engine import Engine, SlotCache8

    cfg, _, (params, _), (on_card, _) = _serving_models(card)
    prompts = [[3, 1, 4, 1, 5], list(range(40)), [9]]
    outs = []
    for tree, dev in ((params, "cpu"), (on_card, card)):
        eng = Engine(tq.quantize_params(tree), cfg, slots=2, max_len=128,
                     buckets=(16, 64), kv_int8=True, device=dev)
        try:
            outs.append([eng.generate(p, 12) for p in prompts])
            assert isinstance(eng._cache, SlotCache8)
        finally:
            eng.stop()
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_stale_rows_past_a_frontier_change_no_token_on_card(card):
    """One slot serves a 100-token prompt and then a 5-token one, whose
    row keeps the first's rows past its 16 prefilled positions: the
    graphed decode kernel reads none of them, so the short prompt's greedy
    tokens equal a fresh engine's and generate()'s."""
    from nanotpu_torch.serving.engine import Engine

    cfg, _, _, (params, _) = _serving_models(card)
    short = [3, 1, 4, 1, 5]
    outs = []
    for prompts in ([short], [list(range(1, 101)), short]):
        eng = Engine(params, cfg, slots=1, max_len=128, buckets=(16, 64),
                     device=card)
        try:
            outs.append([eng.generate(p, 8) for p in prompts][-1])
        finally:
            eng.stop()
    assert eng._cache.k[0][0, 16:100].any()  # the long prompt's rows
    want = tg.generate(params, torch.tensor([short], device=card), cfg, 8)
    assert outs == [want[0].tolist()] * 2


@pytest.mark.cuda
def test_speculative_greedy_equals_plain_f32_on_card(card):
    from nanotpu_torch.serving.engine import Engine

    cfg, dcfg, _, (params, draft) = _serving_models(card)
    prompt = torch.randint(0, cfg.vocab_size, (3, 20), device=card,
                           generator=torch.Generator(device=card).manual_seed(2))
    for K in (1, 4):
        got = tspec.speculative_generate(params, draft, prompt, cfg, dcfg, 24,
                                         draft_tokens=K)
        assert torch.equal(got, tg.generate(params, prompt, cfg, 24))
    prompts = [prompt[i].tolist() for i in range(3)]
    outs = []
    for kw in ({}, {"draft_params": draft, "draft_cfg": dcfg,
                    "spec_policy": "always", "draft_tokens": 3}):
        eng = Engine(params, cfg, slots=4, max_len=128, buckets=(32,),
                     device=card, **kw)
        try:
            outs.append([eng.generate(p, 20) for p in prompts])
            if kw:
                assert eng.spec_cycles_total > 0
        finally:
            eng.stop()
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_reprime_draft_after_plain_phase_on_card(card):
    """A plain phase (2 active rows > the rule's 1) and then speculation:
    the re-prime scatters only real rows, so no device assert fires and the
    tokens stay the plain greedy ones."""
    from nanotpu_torch.serving.engine import Engine

    cfg, dcfg, _, (params, draft) = _serving_models(card)
    eng = Engine(params, cfg, slots=4, max_len=128, buckets=(16, 32),
                 chunk_steps=4, chunk_steps_max=8, draft_params=draft,
                 draft_cfg=dcfg, draft_tokens=3, spec_policy=[(1, 3)],
                 device=card)
    try:
        long_req = eng.submit([5, 3, 1], 40)
        short_req = eng.submit([2, 7, 1, 8], 6)
        assert short_req.wait(120) and short_req.error is None
        assert long_req.wait(120) and long_req.error is None
        torch.cuda.synchronize()
        assert eng.spec_cycles_total > 0
    finally:
        eng.stop()
    for req, prompt, n in ((long_req, [5, 3, 1], 40),
                           (short_req, [2, 7, 1, 8], 6)):
        assert req.out == tg.generate(params, torch.tensor([prompt],
                                                           device=card),
                                      cfg, n)[0].tolist()


# -- CUDA graphs of the decode step and the speculative cycle ---------------

def _bf16(tree):
    from nanotpu_torch.convert import cast_params

    return cast_params(tree, torch.bfloat16)


def _engine_run(params, cfg, prompts, n, temperature=0.0, slots=4,
                max_len=128, buckets=(16, 64), **kw):
    """(tokens of each request, the stopped engine): an engine on the card
    over ``params``, warmed up and driven with every prompt at once."""
    from nanotpu_torch.serving.engine import Engine

    eng = Engine(params, cfg, slots=slots, max_len=max_len, buckets=buckets,
                 device="cuda", **kw)
    try:
        assert eng.wait_warm(300)
        reqs = [eng.submit(p, n, temperature) for p in prompts]
        for r in reqs:
            assert r.wait(300) and r.error is None, r.error
    finally:
        eng.stop()
    return [r.out for r in reqs], eng


def _self_draft(params, cfg):
    return dict(draft_params=params, draft_tokens=3, spec_policy="always",
                draft_cfg=dataclasses.replace(cfg, attn_impl="dense"))


@pytest.mark.cuda
@pytest.mark.parametrize("flavour", ["bf16", "kv_int8", "spec_f32"])
def test_graphed_engine_greedy_equals_eager(card, flavour):
    """The graphed engine's greedy tokens equal the eager engine's, token
    for token: bf16, the int8 KV cache, and f32 speculation with the target
    as its own draft. The graphed engine captured one graph per K the
    policy can pick and replayed each; the eager one captured none."""
    cfg, _, _, (params, _) = _serving_models(card)
    kw = {}
    if flavour == "bf16":
        cfg, params = dataclasses.replace(cfg, dtype="bfloat16"), _bf16(params)
    elif flavour == "kv_int8":
        kw = dict(kv_int8=True)
    else:
        kw = _self_draft(params, cfg)
    prompts = [[3, 1, 4, 1, 5], list(range(40)), [9], [7] * 60]
    outs = {}
    for graphs in (False, True):
        outs[graphs], eng = _engine_run(params, cfg, prompts, 24,
                                        cuda_graphs=graphs, **kw)
        if graphs:
            assert set(eng.graphs) == set(eng._variant_ks)
            assert all(g.replays > 0 for g in eng.graphs.values())
        else:
            assert eng.graphs == {}
    assert outs[True] == outs[False]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True])
def test_graphed_sampling_draws_fresh_noise_each_replay(card, spec):
    """A flat next-token distribution (a zero lm_head, 256 tokens): a
    sampled row's tokens from successive replays differ. A graph that
    reused its captured uniforms would repeat one token a step (a few a
    cycle)."""
    cfg, _, _, (params, _) = _serving_models(card)
    flat = {**params, "lm_head": torch.zeros_like(params["lm_head"])}
    kw = _self_draft(flat, cfg) if spec else {}
    outs, eng = _engine_run(flat, cfg, [[3, 1, 4], [2, 7]], 48,
                            temperature=1.0, **kw)
    assert eng.graphs and all(g.replays > 0 for g in eng.graphs.values())
    for out in outs:
        assert len(set(out[1:])) > 16, out


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True])
def test_graphed_sampled_output_matches_generate_distribution(card, spec):
    """Per-position marginals of the graphed engine's sampled tokens (T=0.8,
    sharpened heads, a plain engine or "always" speculation with the
    distilled-shape draft) against sampled generate on the card, within
    tests/test_torch_speculative.py's bound: TV < 0.12 at 1536 samples a
    side."""
    cfg, dcfg, _, (params, draft) = _serving_models(card)
    target = {**params, "lm_head": params["lm_head"] * 25.0}
    kw = {}
    if spec:
        kw = dict(draft_params={**draft, "lm_head": target["lm_head"]},
                  draft_cfg=dcfg, draft_tokens=3, spec_policy="always")
    B, T, n_seeds, prompt = 64, 0.8, 24, [3, 1, 4, 1, 5]
    outs, eng = _engine_run(target, cfg, [prompt] * (B * n_seeds), 3,
                            temperature=T, slots=B, max_len=32,
                            buckets=(16,), **kw)
    assert eng.graphs and all(g.replays > 0 for g in eng.graphs.values())
    got = torch.tensor(outs)
    want = torch.cat([
        tg.generate(target, torch.tensor([prompt] * B, device=card), cfg, 3,
                    temperature=T,
                    generator=torch.Generator(device=card).manual_seed(i))
        for i in range(n_seeds)]).cpu()
    V = cfg.vocab_size
    for pos in range(3):
        f_got = torch.bincount(got[:, pos], minlength=V) / len(got)
        f_want = torch.bincount(want[:, pos], minlength=V) / len(want)
        tv = 0.5 * (f_got - f_want).abs().sum().item()
        assert tv < 0.12, (pos, tv)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_int8", [False, True])
def test_graphed_engine_keeps_its_tensors_in_place(card, kv_int8):
    """Admission, the draft's re-prime (a plain phase at 2 active rows,
    then speculation at 1) and graphed chunks of both kinds write the
    caches and the decode carry in place: no plane's data_ptr() moves, and
    the tokens stay the plain greedy ones."""
    from nanotpu_torch.serving.engine import Engine

    cfg, dcfg, _, (params, draft) = _serving_models(card)
    eng = Engine(params, cfg, slots=4, max_len=128, buckets=(16, 32),
                 chunk_steps=4, chunk_steps_max=8, draft_params=draft,
                 draft_cfg=dcfg, draft_tokens=3, spec_policy=[(1, 3)],
                 kv_int8=kv_int8, device=card)

    def pointers():
        b = eng._bufs
        planes = [b.tokens, b.temps, b.done, b.remaining, b.step, b.toks,
                  *b.emits.values(), *b.counts.values()]
        for cache in (eng._cache, eng._d_cache):
            for field in cache:
                planes += field if isinstance(field, tuple) else [field]
        return [t.data_ptr() for t in planes]

    reprimes = []
    reprime = eng._reprime_draft

    def spy():
        reprimes.append(sorted(eng._draft_stale))
        reprime()

    eng._reprime_draft = spy
    try:
        assert eng.wait_warm(300)
        before = pointers()
        long_req = eng.submit([5, 3, 1], 40)
        short_req = eng.submit([2, 7, 1, 8], 6)
        assert short_req.wait(120) and short_req.error is None
        assert long_req.wait(120) and long_req.error is None
        torch.cuda.synchronize()
        assert pointers() == before
        assert reprimes, "re-prime path never exercised"
        assert eng.graphs[0].replays > 0 and eng.graphs[3].replays > 0
    finally:
        eng.stop()
    if not kv_int8:
        for req, prompt, n in ((long_req, [5, 3, 1], 40),
                               (short_req, [2, 7, 1, 8], 6)):
            assert req.out == tg.generate(
                params, torch.tensor([prompt], device=card), cfg,
                n)[0].tolist()


@pytest.mark.cuda
def test_a_step_that_reads_the_host_fails_to_capture(card):
    """A host read inside the body breaks the capture, which raises; the
    device serves on afterwards."""
    from nanotpu_torch.serving.graphs import StepGraph

    x = torch.zeros(4, device=card)

    def body():
        x.add_(1)
        if x.sum().item() < 0:
            x.zero_()

    with pytest.raises(RuntimeError):
        StepGraph(body, torch.Generator(device=card),
                  torch.cuda.graph_pool_handle(), torch.cuda.Stream(card))
    assert torch.ones(3, device=card).sum().item() == 3


@pytest.mark.cuda
def test_engine_warm_up_fails_when_its_step_cannot_be_captured(card,
                                                               monkeypatch):
    """A copy of the decode step with a host read in it: the engine's
    capture fails, wait_warm raises, and the engine serves nothing (no
    eager fallback)."""
    from nanotpu_torch.serving import engine as te

    step = te.serving_chunk_step

    def with_a_host_read(*args, **kw):
        out = step(*args, **kw)
        out[1].sum().item()
        return out

    monkeypatch.setattr(te, "serving_chunk_step", with_a_host_read)
    cfg, _, _, (params, _) = _serving_models(card)
    eng = te.Engine(params, cfg, slots=2, max_len=64, buckets=(16,),
                    device=card)
    try:
        with pytest.raises(RuntimeError, match="warm-up failed"):
            eng.wait_warm(300)
        req = eng.submit([1, 2, 3], 4)
        assert req.wait(10) and req.error == "engine stopped"
    finally:
        eng.stop()
    assert torch.ones(3, device=card).sum().item() == 3


# -- Mixtral MoE ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,causal", [(1, True), (77, True), (300, True),
                                      (300, False)])
def test_kernels_at_mixtral_heads(card, dtype, S, causal):
    """The forward (with lse) and the fused backward at Mixtral 8x7B's
    heads, 32 query heads over 8 KV heads at head_dim 128, against their
    plain versions."""
    q, k, v, out, lse, dout = _bwd_inputs(card, dtype, 2, S, 32, 8, 128,
                                          causal, S)
    ref_out, ref_lse = attention_lse_ref(q.float(), k.float(), v.float(),
                                         causal)
    assert (out.float() - ref_out).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= TOL[dtype]
    want = att.attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                 lse, dout.float(), causal)
    before = att.flash_bwd_fused.launches
    got = att.flash_bwd_fused(q, k, v, dout, lse, att._dvec(out, dout), causal)
    torch.cuda.synchronize()
    assert att.flash_bwd_fused.launches == before + 1
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = _row_err(g, w) if dtype == torch.bfloat16 else (
            (g - w).abs().max().item())
        assert err <= TOL[dtype], (name, err)


def _moe_models(card, dtype="float32"):
    """A small Mixtral with flash prefill (head_dim 64), on the card."""
    from nanotpu_torch.models import mixtral

    cfg = dataclasses.replace(mixtral.MixtralConfig.tiny(), dim=256,
                              ffn_dim=192, max_seq_len=128,
                              attn_impl="flash", dtype=dtype)
    params = mixtral.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=card)
    return cfg, params


@pytest.mark.cuda
@pytest.mark.parametrize("flavour", ["f32", "bf16", "int8", "spec"])
def test_graphed_moe_engine_greedy_equals_eager(card, flavour):
    """The MoE decode step (and with a dense draft, the speculative cycle
    verifying at full expert capacity) captures as a CUDA graph, which
    fails on any host sync, and replays: greedy tokens equal the eager
    engine's, token for token."""
    from nanotpu_torch.models.distill import init_draft

    cfg, params = _moe_models(card, "bfloat16" if flavour == "bf16"
                              else "float32")
    kw = {}
    if flavour == "int8":
        params, kw = tq.quantize_params(params), dict(kv_int8=True)
    elif flavour == "spec":
        dcfg = LlamaConfig(vocab_size=cfg.vocab_size, dim=cfg.dim, n_layers=1,
                           n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                           ffn_dim=cfg.ffn_dim, max_seq_len=cfg.max_seq_len,
                           dtype=cfg.dtype)
        draft = init_draft(torch.Generator(device=card).manual_seed(1),
                           params, cfg, dcfg, truncate=False)
        kw = dict(draft_params=draft, draft_cfg=dcfg, draft_tokens=3,
                  spec_policy="always")
    prompts = [[3, 1, 4, 1, 5], list(range(40)), [9], [7] * 60]
    outs = {}
    for graphs in (False, True):
        outs[graphs], eng = _engine_run(params, cfg, prompts, 24,
                                        cuda_graphs=graphs, **kw)
        if graphs:
            assert set(eng.graphs) == set(eng._variant_ks)
            assert all(g.replays > 0 for g in eng.graphs.values())
    assert outs[True] == outs[False]


@pytest.mark.cuda
def test_moe_quantize_on_card_matches_cpu(card):
    """quantize_params of a Mixtral tree on the card: the same int8 values
    and per-expert scales as on the CPU, bit for bit; the router stays
    f32."""
    from nanotpu_torch.models import mixtral
    from nanotpu_torch.tree import map_tree

    cfg = dataclasses.replace(mixtral.MixtralConfig.tiny(), dim=512,
                              ffn_dim=1024, n_experts=8)
    params = mixtral.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    on_cpu = tq.quantize_params(params)
    on_card = tq.quantize_params(map_tree(lambda t: t.to(card), params))
    assert on_card["layers"][0]["moe"]["router"].dtype == torch.float32
    assert on_card["layers"][0]["moe"]["w_gate"].s.shape == (8, 1, 1024)
    for a, b in zip(leaves(on_card), leaves(on_cpu)):
        assert torch.equal(a.cpu(), b)


# -- the trainer's fused steps: one step captured as a CUDA graph ------------

def _train_models(card, model, dtype):
    """A tiny training config with the flash kernels (head_dim 64) and its
    (cfg, params, loss_fn, init_fn)."""
    from nanotpu_torch.models import mixtral

    if model == "mixtral":
        cfg = dataclasses.replace(mixtral.MixtralConfig.tiny(), dim=128,
                                  n_heads=2, n_kv_heads=1, ffn_dim=128,
                                  attn_impl="flash", dtype=dtype)
        return cfg, mixtral.loss_fn, mixtral.init_params
    cfg = LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=2,
                      n_kv_heads=1, ffn_dim=256, max_seq_len=256,
                      attn_impl="flash", dtype=dtype)
    return cfg, None, None


def _train_run(card, model, dtype, n_fused, calls, tokens):
    """``calls`` calls of a fresh state's train step (``tokens`` [steps,
    B, S+1]): (losses a call, final state, step function)."""
    from nanotpu_torch.parallel import train

    cfg, loss_fn, init_fn = _train_models(card, model, dtype)
    opt = train.make_optimizer()
    state = train.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   opt, device=card, init_fn=init_fn)
    step = train.build_train_step(cfg, opt, loss_fn=loss_fn, n_fused=n_fused)
    losses = []
    for c in range(calls):
        block = tokens[c * n_fused:(c + 1) * n_fused]
        state, loss = step(state, block[0] if n_fused == 1 else block)
        losses.append(loss)
    torch.cuda.synchronize()
    return [x.item() for x in losses], state, step


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["llama", "mixtral"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_train_steps_equal_eager(card, model, dtype):
    """Two calls of a fused step of 4 (2 eager warm-up steps, a capture,
    6 replays of the captured step with the flash forward and fused
    backward in it) against 8 eager steps from the same state on the same
    batches: each call's last loss within 1e-6 in f32 (2e-2 in bf16) of
    the eager loss at its step, parameters, moments and count after 8
    steps within a tenth of an Adam step in f32 (2e-2 in bf16)."""
    gen = torch.Generator(device=card).manual_seed(1)
    tokens = torch.randint(0, 256, (8, 2, 65), device=card,
                           generator=gen)
    eager, want, _ = _train_run(card, model, dtype, 1, 8, tokens)
    got, graphed, step = _train_run(card, model, dtype, 4, 2, tokens)
    loss_tol, state_tol = (1e-6, 3e-5) if dtype == "float32" else (2e-2, 2e-2)
    assert step.graphed.graph is not None and step.graphed.replays == 6
    assert step.graphed.warmup_steps == 2
    assert graphed.step == want.step == 8
    assert abs(got[0] - eager[3]) <= loss_tol
    assert abs(got[1] - eager[7]) <= loss_tol
    assert torch.equal(graphed.opt_state["count"], want.opt_state["count"])
    for a, b in zip(leaves(graphed.params) + leaves(graphed.opt_state),
                    leaves(want.params) + leaves(want.opt_state)):
        assert (a.float() - b.float()).abs().max().item() <= state_tol


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "two_pass"])
def test_graphed_train_step_launches_are_exact(card, path, monkeypatch):
    """The wrappers count on the host: capture's launches are taken back
    and each replay adds one step's, so 8 steps of a 2-layer model count
    16 forward and 16 backward launches (fused, or dq and dk/dv with
    FUSED_BWD_MAX_S = 0) whether a step ran eagerly or replayed."""
    if path == "two_pass":
        monkeypatch.setattr(att, "FUSED_BWD_MAX_S", 0)
    tokens = torch.randint(0, 256, (8, 2, 65), device=card)
    fns = (att.flash_attention, att.flash_bwd_fused, att.flash_bwd_dq,
           att.flash_bwd_dkv)
    before = [fn.launches for fn in fns]
    _, _, step = _train_run(card, "llama", "float32", 4, 2, tokens)
    counts = [fn.launches - n for fn, n in zip(fns, before)]
    assert counts == ([16, 16, 0, 0] if path == "fused" else [16, 0, 16, 16])
    assert step.graphed.launches_per_replay == [c // 8 for c in counts]


@pytest.mark.cuda
def test_fused_step_refuses_another_state(card):
    from nanotpu_torch.parallel import train

    tokens = torch.randint(0, 256, (4, 2, 65), device=card)
    _, state, step = _train_run(card, "llama", "float32", 4, 1, tokens)
    cfg, _, _ = _train_models(card, "llama", "float32")
    other = train.init_train_state(torch.Generator().manual_seed(1), cfg,
                                   train.make_optimizer(), device=card)
    with pytest.raises(ValueError, match="bound to the tensors"):
        step(other, tokens)
    step(state, tokens)  # its own state still replays
    assert step.graphed.replays == 6


@pytest.mark.cuda
def test_capture_survives_a_dead_graph_awaiting_collection(card):
    """A CUDA graph left in a dead reference cycle (an engine's, say) is
    destroyed when the cycle is collected, and destroying a graph while
    another captures invalidates that capture: the graphed step collects
    before it captures. Here a collection runs inside the capture, with
    automatic collection off until then."""
    import gc

    from nanotpu_torch.parallel import train

    cfg, _, _ = _train_models(card, "llama", "float32")

    def collecting_loss(params, tokens, cfg):
        if torch.cuda.is_current_stream_capturing():
            gc.collect()
        return tl.loss_fn(params, tokens, cfg)

    x = torch.zeros(4, device=card)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        x.add_(1)
    torch.cuda.current_stream().wait_stream(stream)
    opt = train.make_optimizer()
    state = train.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   opt, device=card)
    step = train.build_train_step(cfg, opt, loss_fn=collecting_loss,
                                  n_fused=4)
    tokens = torch.randint(0, 256, (4, 2, 65), device=card,
                           generator=torch.Generator(device=card).manual_seed(2))
    collecting = gc.isenabled()
    gc.disable()
    try:
        dead = torch.cuda.CUDAGraph()
        with torch.cuda.graph(dead, stream=stream):
            x.add_(1)
        cycle = {"graph": dead}
        cycle["self"] = cycle
        del dead, cycle
        step(state, tokens)
    finally:
        if collecting:
            gc.enable()
    torch.cuda.synchronize()
    assert step.graphed.replays == 2 and int(state.opt_state["count"]) == 4


# -- ring attention's body on one card ----------------------------------------

#: the ring's bf16 gradients: TOL plus bf16's unit roundoff (2^-8) for each
#: rounding the ring adds to a gradient: 4 blocks' gradients rounded to
#: bf16 and 3 sums in bf16 (nanotpu's ring rounds and sums the same way)
_RING_TOL = TOL[torch.bfloat16] + 7 * 2**-8

def _ring_all_ranks(q, k, v, sp):
    """``chip_smoke.ring_all_ranks``: ring_attention's loop for each of
    ``sp`` virtual ranks; the whole (out, lse)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.ring_all_ranks(q, k, v, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "two_pass"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
def test_ring_body_matches_whole_sequence_flash(card, monkeypatch, path,
                                                dtype, D):
    """S=512 over 4 virtual ranks (blocks of 128): out and q/k/v gradients
    of the ring's blocks, merged, against flash over the whole sequence;
    10 forward launches and 10 backward (fused, or dq and dk/dv) for the
    10 visible blocks. The merge hands each block's backward a non-zero
    lse cotangent. bf16 gradients: against the plain backward at the
    ring's own out and lse to _RING_TOL, and against flash's to TOL +
    _RING_TOL (each of the two may lie that far from the exact gradient)."""
    if path == "two_pass":
        monkeypatch.setattr(att, "FUSED_BWD_MAX_S", 0)
    gen = torch.Generator(device=card).manual_seed(D)
    q, k, v = (torch.randn((2, 512, h, D), generator=gen, device=card)
               .to(dtype).requires_grad_(True) for h in (8, 2, 2))
    dout = torch.randn(q.shape, generator=gen, device=card).to(dtype)
    before = [f.launches for f in (flash_attention, att.flash_bwd_fused,
                                   att.flash_bwd_dq, att.flash_bwd_dkv)]
    out, lse = _ring_all_ranks(q, k, v, 4)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    after = [f.launches for f in (flash_attention, att.flash_bwd_fused,
                                  att.flash_bwd_dq, att.flash_bwd_dkv)]
    want_n = [10, 10, 0, 0] if path == "fused" else [10, 0, 10, 10]
    assert [a - b for a, b in zip(after, before)] == want_n
    ref = att.flash_attention_lse(q, k, v, True)[0]
    want = torch.autograd.grad(ref, (q, k, v), dout)
    assert _rel_err(out, ref) <= TOL[dtype]
    plain = att.attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                  lse, dout.float(), True)
    for a, b, c in zip(got, want, plain):
        if dtype == torch.bfloat16:
            assert _row_err(a, c) <= _RING_TOL
            assert _row_err(a, b) <= TOL[dtype] + _RING_TOL
        else:
            assert _rel_err(a, b) <= TOL[dtype]
            assert _rel_err(a, c) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
def test_noncausal_lse_forward_at_2048(card, dtype, D):
    """The forward of a ring's past blocks: non-causal, with lse, at the
    training flagship's block length."""
    gen = torch.Generator(device=card).manual_seed(11)
    q, k, v = (torch.randn((1, 2048, h, D), generator=gen, device=card)
               .to(dtype) for h in (16 * 64 // D, 4 * 64 // D, 4 * 64 // D))
    out, lse = att.flash_attention_lse(q, k, v, False)
    ref_out, ref_lse = attention_lse_ref(q.float(), k.float(), v.float(), False)
    assert (out.float() - ref_out).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "two_pass"])
@pytest.mark.parametrize("causal", [True, False])
def test_lse_cotangent_backward_at_2048(card, monkeypatch, path, causal):
    """The backward kernels with D - g_lse at S=2048 (bf16, 16/4 heads of
    64): q/k/v gradients against the plain backward given the same lse
    cotangent."""
    if path == "two_pass":
        monkeypatch.setattr(att, "FUSED_BWD_MAX_S", 0)
    q, k, v, out, lse, dout = _bwd_inputs(card, torch.bfloat16, 1, 2048, 16,
                                          4, 64, causal, 13)
    g_lse = torch.randn(lse.shape, device=card,
                        generator=torch.Generator(device=card).manual_seed(14))
    got = att.flash_backward(q, k, v, out, lse, dout, causal, g_lse=g_lse)
    want = att.attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                 lse, dout.float(), causal, g_lse=g_lse)
    for a, b in zip(got, want):
        assert _row_err(a, b) <= TOL[torch.bfloat16]


# -- sharded serving and the pipeline on a one-process NCCL mesh ------------

@pytest.fixture(scope="module")
def nccl_mesh():
    """``make_mesh()`` (six axes of size 1) over an NCCL group of this one
    process, torn down after the module's last test."""
    import socket

    import torch.distributed as dist

    from nanotpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    yield make_mesh()
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("flavour", ["bf16", "kv_int8", "spec_f32"])
def test_mesh_engine_graphed_equals_eager_and_plain(card, nccl_mesh,
                                                    flavour):
    """``Engine(mesh=)`` at world 1, its decode step and speculative cycles
    captured with their NCCL collectives in them (tp all-reduces, the
    logits' all-gather): greedy tokens equal to the same engine eager and
    to the plain engine's, token for token (a group of one changes no
    bit)."""
    cfg, _, _, (params, _) = _serving_models(card)
    kw = {}
    if flavour == "bf16":
        cfg, params = dataclasses.replace(cfg, dtype="bfloat16"), _bf16(params)
    elif flavour == "kv_int8":
        kw = dict(kv_int8=True)
    else:
        kw = _self_draft(params, cfg)
    prompts = [[3, 1, 4, 1, 5], list(range(40)), [9], [7] * 60]
    plain, _ = _engine_run(params, cfg, prompts, 24, **kw)
    for graphs in (False, True):
        outs, eng = _engine_run(params, cfg, prompts, 24, cuda_graphs=graphs,
                                mesh=nccl_mesh, **kw)
        assert outs == plain, graphs
        assert eng.stats()["chips"] == 1
        if graphs:
            assert all(g.replays > 0 for g in eng.graphs.values())


@pytest.mark.cuda
@pytest.mark.parametrize("attn", ["flash", "ring"])
def test_pipeline_step_at_512_equals_plain(card, nccl_mesh, attn):
    """The pipelined step at pp=1 (M=4, S=512, the stacked tree placed on
    the mesh) against the plain step from the same state on the same
    batches, f32: losses within 1e-5, the updated parameters within 1e-4
    (a third of one Adam step: the microbatches' products sum in another
    order); flash forward and fused backward launched once a layer a
    microbatch."""
    from nanotpu_torch.parallel import pipeline as tpp
    from nanotpu_torch.parallel import train
    from nanotpu_torch.tree import map_tree

    cfg, _, _ = _train_models(card, "llama", "float32")
    cfg = dataclasses.replace(cfg, max_seq_len=512)
    opt = train.make_optimizer()
    base = train.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                  device=card)
    tokens = torch.randint(0, cfg.vocab_size, (3, 8, 513),
                           generator=torch.Generator(device=card
                                                     ).manual_seed(1),
                           device=card)
    plain = train.TrainState(map_tree(lambda t: t.detach().clone(),
                                      base.params), opt.init(base.params), 0)
    step = train.build_train_step(cfg, opt)
    want = []
    for row in tokens:
        plain, loss = step(plain, row)
        want.append(loss.item())
    c = dataclasses.replace(cfg, attn_impl=attn)
    stacked = tpp.stack_layers(map_tree(lambda t: t.detach().clone(),
                                        base.params))
    specs = tpp.llama_pp_param_specs(c)
    state = train.place_state(
        train.TrainState(stacked, opt.init(stacked), 0), c, nccl_mesh,
        param_specs=specs)
    pstep = train.build_train_step(
        c, opt, loss_fn=tpp.make_pipelined_loss(nccl_mesh, 4),
        mesh=nccl_mesh, param_specs=specs)
    before = (flash_attention.launches, att.flash_bwd_fused.launches)
    got = []
    for row in tokens:
        state, loss = pstep(state, row)
        got.append(loss.item())
    assert got == pytest.approx(want, abs=1e-5)
    assert flash_attention.launches - before[0] == 3 * 4 * cfg.n_layers
    assert att.flash_bwd_fused.launches - before[1] == 3 * 4 * cfg.n_layers
    mine = tpp.unstack_layers(map_tree(lambda t: t.full_tensor().detach(),
                                       state.params))
    for a, b in zip(leaves(mine), leaves(plain.params)):
        assert (a - b).abs().max() <= 1e-4


def _recorded_routing(fn):
    """``fn()``'s result and the routing decisions it took, as (expert,
    capacity slot, kept) per choice per call of ``route_decisions``."""
    from nanotpu_torch.models import mixtral

    route, seen = mixtral.route_decisions, []

    def recording(logits, cfg, capacity=None):
        choices, aux, C = route(logits, cfg, capacity)
        seen.append([(c[0].argmax(-1), c[1], c[2]) for c in choices])
        return choices, aux, C

    mixtral.route_decisions = recording
    try:
        return fn(), seen
    finally:
        mixtral.route_decisions = route


def _assert_same_routing(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for (ge, gp, gk), (we, wp, wk) in zip(a, b):
            assert torch.equal(ge, we) and torch.equal(gk, wk)
            assert torch.equal(gp[wk], wp[wk])


@pytest.mark.cuda
def test_moe_mesh_step_equals_plain(card, nccl_mesh):
    """The Mixtral mesh step at world 1 (experts placed over ep, routing
    gathered over the data axes, the ep collectives on groups of one)
    against the plain step from the same state on the same batches, f32:
    routing decisions equal on the first batch, losses within 1e-5,
    updated parameters within 1e-4; flash forward and fused backward once
    a layer a step."""
    from nanotpu_torch.models import mixtral
    from nanotpu_torch.parallel import train
    from nanotpu_torch.tree import map_tree

    cfg, loss_fn, init_fn = _train_models(card, "mixtral", "float32")
    opt = train.make_optimizer()
    base = train.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                  device=card, init_fn=init_fn)
    tokens = torch.randint(0, cfg.vocab_size, (3, 4, 129),
                           generator=torch.Generator(device=card
                                                     ).manual_seed(1),
                           device=card)
    _, want_routing = _recorded_routing(
        lambda: loss_fn(base.params, tokens[0], cfg))
    plain = train.TrainState(map_tree(lambda t: t.detach().clone(),
                                      base.params), opt.init(base.params), 0)
    step = train.build_train_step(cfg, opt, loss_fn=loss_fn)
    want = []
    for row in tokens:
        plain, loss = step(plain, row)
        want.append(loss.item())
    state = train.place_state(
        train.TrainState(map_tree(lambda t: t.detach().clone(), base.params),
                         opt.init(base.params), 0), cfg, nccl_mesh)
    assert state.params["layers"][0]["moe"]["w_gate"].placements[-1] \
        .is_shard(0)
    mstep = train.build_train_step(cfg, opt, loss_fn=mixtral.loss_fn,
                                   mesh=nccl_mesh)
    before = (flash_attention.launches, att.flash_bwd_fused.launches)
    got = []
    for i, row in enumerate(tokens):
        if i == 0:
            (state, loss), routing = _recorded_routing(
                lambda: mstep(state, row))
            _assert_same_routing(routing, want_routing)
        else:
            state, loss = mstep(state, row)
        got.append(loss.item())
    assert got == pytest.approx(want, abs=1e-5)
    assert flash_attention.launches - before[0] == 3 * cfg.n_layers
    assert att.flash_bwd_fused.launches - before[1] == 3 * cfg.n_layers
    for a, b in zip(leaves(state.params), leaves(plain.params)):
        assert (a.full_tensor().detach() - b).abs().max() <= 1e-4


@pytest.mark.cuda
def test_moe_pipeline_step_equals_microbatch_averaged_plain(card, nccl_mesh):
    """The pipelined Mixtral step at pp=1 (M=4, the stacked tree) against
    the plain step on the mean of ``mixtral.loss_fn`` over the same four
    microbatches (capacity and the aux loss are per microbatch), f32:
    losses within 1e-5, updated parameters within 1e-4; flash forward and
    fused backward once a layer a microbatch."""
    from nanotpu_torch.models import mixtral
    from nanotpu_torch.parallel import pipeline as tpp
    from nanotpu_torch.parallel import train
    from nanotpu_torch.tree import map_tree

    cfg, _, init_fn = _train_models(card, "mixtral", "float32")
    cfg = dataclasses.replace(cfg, max_seq_len=512)
    M = 4

    def averaged(params, tokens, cfg):
        mb = tokens.shape[0] // M
        return sum(mixtral.loss_fn(params, tokens[i * mb:(i + 1) * mb], cfg)
                   for i in range(M)) / M

    opt = train.make_optimizer()
    base = train.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                  device=card, init_fn=init_fn)
    tokens = torch.randint(0, cfg.vocab_size, (3, 8, 513),
                           generator=torch.Generator(device=card
                                                     ).manual_seed(1),
                           device=card)
    plain = train.TrainState(map_tree(lambda t: t.detach().clone(),
                                      base.params), opt.init(base.params), 0)
    step = train.build_train_step(cfg, opt, loss_fn=averaged)
    want = []
    for row in tokens:
        plain, loss = step(plain, row)
        want.append(loss.item())
    stacked = tpp.stack_layers(map_tree(lambda t: t.detach().clone(),
                                        base.params))
    specs = tpp.mixtral_pp_param_specs(cfg)
    state = train.place_state(
        train.TrainState(stacked, opt.init(stacked), 0), cfg, nccl_mesh,
        param_specs=specs)
    pstep = train.build_train_step(
        cfg, opt, loss_fn=tpp.make_pipelined_loss(nccl_mesh, M, "mixtral"),
        mesh=nccl_mesh, param_specs=specs)
    before = (flash_attention.launches, att.flash_bwd_fused.launches)
    got = []
    for row in tokens:
        state, loss = pstep(state, row)
        got.append(loss.item())
    assert got == pytest.approx(want, abs=1e-5)
    assert flash_attention.launches - before[0] == 3 * M * cfg.n_layers
    assert att.flash_bwd_fused.launches - before[1] == 3 * M * cfg.n_layers
    mine = tpp.unstack_layers(map_tree(lambda t: t.full_tensor().detach(),
                                       state.params))
    for a, b in zip(leaves(mine), leaves(plain.params)):
        assert (a - b).abs().max() <= 1e-4


def _mesh_train_run(card, mesh, model, attn, n_micro, n_fused, tokens):
    """``tokens`` [8, B, S+1] through a fresh f32 state's mesh step
    (pipelined over ``n_micro`` microbatches when that is not 0), in calls
    of ``n_fused`` steps: (each call's loss, final state, step function,
    flash launches)."""
    from nanotpu_torch.parallel import pipeline as tpp
    from nanotpu_torch.parallel import train

    cfg, loss_fn, init_fn = _train_models(card, model, "float32")
    cfg = dataclasses.replace(cfg, attn_impl=attn)
    opt = train.make_optimizer()
    specs = None
    if n_micro:
        base = init_fn or tl.init_params
        init_fn = lambda c, g, device=None: tpp.stack_layers(  # noqa: E731
            base(c, g, device=device))
        specs = tpp.pp_param_specs(cfg)
        loss_fn = tpp.make_pipelined_loss(mesh, n_micro, model)
    state = train.place_state(
        train.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                               device=card, init_fn=init_fn),
        cfg, mesh, param_specs=specs)
    step = train.build_train_step(cfg, opt, loss_fn=loss_fn, n_fused=n_fused,
                                  mesh=mesh, param_specs=specs)
    before = (flash_attention.launches, att.flash_bwd_fused.launches)
    losses = []
    for c in range(len(tokens) // n_fused):
        block = tokens[c * n_fused:(c + 1) * n_fused]
        state, loss = step(state, block[0] if n_fused == 1 else block)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = (flash_attention.launches - before[0],
                att.flash_bwd_fused.launches - before[1])
    return [x.item() for x in losses], state, step, launches


@pytest.mark.cuda
@pytest.mark.parametrize("model,attn", [("llama", "flash"), ("llama", "ring"),
                                        ("mixtral", "flash")])
def test_graphed_mesh_step_equals_eager_mesh_step(card, nccl_mesh, model,
                                                  attn):
    """The mesh step at world 1 fused 4 to a call (2 eager warm-up steps,
    a capture holding its NCCL collectives, 6 replays) against 8 eager
    mesh steps from the same state on the same batches, f32: each call's
    last loss within 1e-6 of the eager loss at its step, every local shard
    of the state within 3e-5 after 8 steps, the count equal; flash forward
    and fused backward once a layer a step, replays counted."""
    from nanotpu_torch.parallel.mesh import local

    gen = torch.Generator(device=card).manual_seed(1)
    tokens = torch.randint(0, 256, (8, 2, 65), device=card,
                           generator=gen)
    eager, want, _, _ = _mesh_train_run(card, nccl_mesh, model, attn, 0, 1,
                                        tokens)
    got, graphed, step, launches = _mesh_train_run(card, nccl_mesh, model,
                                                   attn, 0, 4, tokens)
    assert step.graphed.graph is not None and step.graphed.replays == 6
    assert graphed.step == want.step == 8
    assert abs(got[0] - eager[3]) <= 1e-6 and abs(got[1] - eager[7]) <= 1e-6
    assert launches == (8 * 2, 8 * 2)
    mine, theirs = local(graphed.opt_state), local(want.opt_state)
    assert torch.equal(mine["count"], theirs["count"])
    for a, b in zip(leaves(local(graphed.params)) + leaves(mine),
                    leaves(local(want.params)) + leaves(theirs)):
        assert (a - b).abs().max().item() <= 3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["llama", "mixtral"])
def test_graphed_pipelined_step_captures(card, nccl_mesh, model):
    """The pipelined step (pp=1, M=4) fused 4 to a call captures: its stage
    masks are filled on the device (a tensor copied from the host inside
    the step would synchronize, which capture refuses), and 6 replays
    follow the 2 warm-up steps; each call's last loss within 1e-6 of the
    eager pipelined step's (f32), one forward and one fused backward a
    layer a microbatch a step."""
    gen = torch.Generator(device=card).manual_seed(2)
    tokens = torch.randint(0, 256, (8, 4, 65), device=card,
                           generator=gen)
    eager, _, _, _ = _mesh_train_run(card, nccl_mesh, model, "flash", 4, 1,
                                     tokens)
    got, _, step, launches = _mesh_train_run(card, nccl_mesh, model, "flash",
                                             4, 4, tokens)
    assert step.graphed.graph is not None and step.graphed.replays == 6
    assert abs(got[0] - eager[3]) <= 1e-6 and abs(got[1] - eager[7]) <= 1e-6
    assert launches == (8 * 4 * 2, 8 * 4 * 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mesh_engine_graphed_equals_eager_and_plain(card, nccl_mesh,
                                                        dtype):
    """``Engine(mesh=)`` on a Mixtral placed from a tree on the CPU (each
    shard moved to the card), its decode graphs holding the ep and tp
    all-reduces: greedy tokens equal to the same engine eager and to the
    plain engine's, and the same prefill drops."""
    from nanotpu_torch.tree import map_tree

    cfg, params = _moe_models(card, dtype)
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    prompts = [[3, 1, 4, 1, 5], list(range(40)), [9], [7] * 60]
    plain, plain_eng = _engine_run(params, cfg, prompts, 24)
    on_cpu = map_tree(lambda t: t.cpu(), params)
    for graphs in (False, True):
        outs, eng = _engine_run(on_cpu, cfg, prompts, 24, cuda_graphs=graphs,
                                mesh=nccl_mesh)
        assert outs == plain, graphs
        assert (eng.moe_prefill_dropped_total
                == plain_eng.moe_prefill_dropped_total > 0)
        assert all(t.device.type == "cuda" for t in leaves(eng.params))
        if graphs:
            assert all(g.replays > 0 for g in eng.graphs.values())


@pytest.mark.cuda
def test_uncapturable_train_step_raises(card):
    """A step with a host sync in its loss captures nothing: the capture
    raises, after the two eager warm-up steps, and never runs eagerly in
    its place. Last in the file: a failed capture leaves the process's
    default CUDA generator in its capture state."""
    from nanotpu_torch.parallel import train

    cfg, _, _ = _train_models(card, "llama", "float32")

    def syncing_loss(params, tokens, cfg):
        loss = tl.loss_fn(params, tokens, cfg)
        if loss.item() < 0:  # a host read: refused under capture
            raise AssertionError("negative loss")
        return loss

    opt = train.make_optimizer()
    state = train.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   opt, device=card)
    step = train.build_train_step(cfg, opt, loss_fn=syncing_loss, n_fused=4)
    tokens = torch.randint(0, 256, (4, 2, 65), device=card)
    with pytest.raises(RuntimeError):
        step(state, tokens)
    assert step.graphed.graph is None and step.graphed.replays == 0
    assert step.graphed.warmup_steps == 2
    torch.cuda.synchronize()
    assert int(state.opt_state["count"]) == 2

