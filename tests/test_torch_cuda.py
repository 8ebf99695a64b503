"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a card. This file imports no jax,
so it runs where the card is: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``.

Tolerances: forward, bf16 2e-2 against the plain version in f32 on the same
inputs (the kernel rounds only its output to bf16); f32 1e-4 (summation
order). Backward, bf16 2e-2 element by element, of |want| plus the RMS of
want's row over the last axis (at least 1e-3): p and ds are rounded to bf16
for their products, as on the TPU, and dq's atomic sum runs in no fixed
order, while a dropped tile costs most of |want| in each row it touches;
f32 1e-4 of the largest magnitude, at least 1."""

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
