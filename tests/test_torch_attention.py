"""nanotpu_torch flash attention on the CPU (its plain version) against
nanotpu's Pallas kernel in interpret mode and its dense XLA reference.

Inputs are made by numpy from a seed and fed to both. Tolerance: atol 1e-5
in float32 (the two differ only in summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanotpu.ops.attention import _xla_attention_lse
from nanotpu.ops.attention import flash_attention_lse as jax_flash_lse
from nanotpu_torch.ops.attention import (
    NEG_INF,
    attention_lse_ref,
    flash_attention,
)

torch.set_num_threads(2)
ATOL = 1e-5


def make_qkv(seed, S, H, KV, D, B=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32) * 0.5
    k = rng.standard_normal((B, S, KV, D), dtype=np.float32) * 0.5
    v = rng.standard_normal((B, S, KV, D), dtype=np.float32)
    return q, k, v


def to_torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("S,D", [(37, 16), (130, 64)])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_pallas_interpret_and_xla(causal, H, KV, S, D):
    q, k, v = make_qkv(S * D + H + KV, S, H, KV, D)
    out, lse = flash_attention(*to_torch(q, k, v), causal, need_lse=True)
    assert out.shape == (1, S, H, D) and lse.shape == (1, H, S)
    assert lse.dtype == torch.float32
    k_out, k_lse = jax_flash_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 64, 64, True
    )
    x_out, x_lse = _xla_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal
    )
    for ref_out, ref_lse in ((k_out, k_lse), (x_out, x_lse)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=ATOL)


def test_out_only_and_no_launch_counted_on_cpu():
    q, k, v = to_torch(*make_qkv(1, 20, 4, 2, 16))
    before = flash_attention.launches
    out = flash_attention(q, k, v)  # causal by default, no lse
    assert isinstance(out, torch.Tensor) and out.shape == q.shape
    ref, _ = attention_lse_ref(q, k, v, True)
    torch.testing.assert_close(out, ref, atol=0.0, rtol=0.0)
    assert flash_attention.launches == before


def test_gqa_reads_kv_head_h_over_rep():
    """q head h must read kv head h // (H // KV): equal to running each
    q-head group against its own kv head as plain multi-head attention."""
    q, k, v = to_torch(*make_qkv(2, 24, 4, 2, 16))
    out, lse = flash_attention(q, k, v, True, need_lse=True)
    for h in range(4):
        g = h // 2
        o1, l1 = flash_attention(q[:, :, h:h + 1], k[:, :, g:g + 1],
                                 v[:, :, g:g + 1], True, need_lse=True)
        torch.testing.assert_close(out[:, :, h:h + 1], o1, atol=ATOL, rtol=0)
        torch.testing.assert_close(lse[:, h:h + 1], l1, atol=ATOL, rtol=0)


def test_plain_version_masks_like_the_kernel_contract():
    """Causal row 0 attends only key 0: its output is v[0] and its lse the
    single scaled logit; NEG_INF never leaks into a causal output."""
    q, k, v = to_torch(*make_qkv(3, 9, 2, 2, 16))
    out, lse = attention_lse_ref(q, k, v, True)
    torch.testing.assert_close(out[:, 0], v[:, 0], atol=ATOL, rtol=0)
    logit0 = (q[0, 0] * k[0, 0]).sum(-1) / 4.0
    torch.testing.assert_close(lse[0, :, 0], logit0, atol=ATOL, rtol=0)
    assert (lse > NEG_INF / 2).all()


@pytest.mark.parametrize("bad", ["kv_heads", "seq", "rank"])
def test_rejects_bad_shapes(bad):
    q, k, v = to_torch(*make_qkv(4, 8, 4, 2, 16))
    if bad == "kv_heads":
        k, v = k[:, :, :1].expand(1, 8, 3, 16), v[:, :, :1].expand(1, 8, 3, 16)
    elif bad == "seq":
        k, v = k[:, :4], v[:, :4]
    else:
        q = q[0]
    with pytest.raises(ValueError):
        flash_attention(q, k, v)


def test_other_devices_raise_rather_than_fall_back():
    q, k, v = (t.to("meta") for t in to_torch(*make_qkv(5, 8, 2, 2, 16)))
    with pytest.raises(ValueError, match="no path"):
        flash_attention(q, k, v)
