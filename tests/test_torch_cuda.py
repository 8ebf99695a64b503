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
at least 1."""

import dataclasses

import pytest
import torch

from nanotpu_torch.models import generate as tg
from nanotpu_torch.models import llama as tl
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
