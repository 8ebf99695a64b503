"""The port's CUDA kernel on the card, against its plain version.

Marked ``cuda``: each test skips without a card. This file imports no jax,
so it runs where the card is: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``.

Tolerances: bf16 2e-2 against the plain version in f32 on the same inputs
(the kernel rounds only its output to bf16); f32 1e-4 (summation order)."""

import dataclasses

import pytest
import torch

from nanotpu_torch.models import generate as tg
from nanotpu_torch.models.llama import LlamaConfig, init_params
from nanotpu_torch.ops.attention import attention_lse_ref, flash_attention

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
