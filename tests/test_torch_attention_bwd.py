"""Gradients of nanotpu_torch's flash attention on the CPU (the autograd
wiring of the card, with the kernels' plain versions behind it) against
nanotpu's Pallas backward in interpret mode, fused and two-pass, and
attention_bwd_ref against autograd of attention_lse_ref.

Inputs are made by numpy from a seed and fed to both. Tolerance: atol 1e-4
in float32 against JAX (the Pallas kernels sum in blocks, the plain version
densely), atol 1e-5 against torch autograd (the same dense math)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanotpu.ops import attention as jatt
from nanotpu_torch.ops import attention as att

torch.set_num_threads(2)
ATOL_JAX = 1e-4
ATOL = 1e-5


def make(seed, S, H, KV, D, B=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32) * 0.5
    k = rng.standard_normal((B, S, KV, D), dtype=np.float32) * 0.5
    v = rng.standard_normal((B, S, KV, D), dtype=np.float32)
    w = rng.standard_normal((B, S, H, D), dtype=np.float32)
    return q, k, v, w


def leaf(a):
    return torch.from_numpy(a).requires_grad_(True)


@pytest.mark.parametrize("path", ["fused", "two_pass"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [77, 128])
def test_grads_match_pallas_backward(monkeypatch, path, causal, S):
    """GQA 4/2, ragged S: the port's gradients equal those of nanotpu's
    Pallas kernels (interpret mode) through the same backward regime."""
    if path == "two_pass":
        monkeypatch.setattr(jatt, "FUSED_BWD_MAX_S", 0)
        monkeypatch.setattr(att, "FUSED_BWD_MAX_S", 0)
    q, k, v, w = make(S + causal, S, 4, 2, 16)
    want = jax.grad(
        lambda q, k, v: (jatt.flash_attention(q, k, v, causal, 64, 64, True)
                         * w).sum(),
        argnums=(0, 1, 2),
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = leaf(q), leaf(k), leaf(v)
    out = att.flash_attention(tq, tk, tv, causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for name, g, j in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == j.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=ATOL_JAX,
                                   err_msg=name)


def test_lse_cotangent_matches_pallas():
    """A loss on both outputs of flash_attention_lse: the lse cotangent
    folds into D exactly as nanotpu's does."""
    q, k, v, _ = make(12, 64, 4, 2, 16)

    def jloss(q, k, v):
        out, lse = jatt.flash_attention_lse(q, k, v, True, 64, 64, True)
        return (lse ** 2).sum() + (out ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = leaf(q), leaf(k), leaf(v)
    out, lse = att.flash_attention_lse(tq, tk, tv, True)
    got = torch.autograd.grad((lse ** 2).sum() + (out ** 2).sum(), (tq, tk, tv))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=ATOL_JAX)


@pytest.mark.parametrize("with_g_lse", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 2), (2, 2)])
def test_bwd_ref_matches_autograd(H, KV, causal, with_g_lse):
    q, k, v, w = make(H * 10 + KV + causal, 23, H, KV, 16)
    g_lse = np.random.default_rng(5).standard_normal((1, H, 23)).astype(np.float32)
    tq, tk, tv = leaf(q), leaf(k), leaf(v)
    out, lse = att.attention_lse_ref(tq, tk, tv, causal)
    loss = (out * torch.from_numpy(w)).sum()
    if with_g_lse:
        loss = loss + (lse * torch.from_numpy(g_lse)).sum()
    want = torch.autograd.grad(loss, (tq, tk, tv))
    got = att.attention_bwd_ref(
        tq.detach(), tk.detach(), tv.detach(), out.detach(), lse.detach(),
        torch.from_numpy(w), causal,
        g_lse=torch.from_numpy(g_lse) if with_g_lse else None)
    for g, want_g in zip(got, want):
        torch.testing.assert_close(g, want_g, atol=ATOL, rtol=0)


def test_rows_with_neg_inf_lse_give_zero_gradients():
    q, k, v, w = (torch.from_numpy(a) for a in make(3, 10, 2, 2, 16))
    out, lse = att.attention_lse_ref(q, k, v, False)
    lse[0, :, 4] = att.NEG_INF  # a fully masked row, as the kernel marks it
    dq, dk, dv = att.attention_bwd_ref(q, k, v, out, lse, w, False)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    assert (dq[0, 4] == 0).all()


def test_cpu_backward_counts_no_launch_and_paths_agree(monkeypatch):
    """On CPU tensors the backward wrappers run the plain version (no
    launch counted); the fused and two-pass dispatches agree."""
    q, k, v, w = make(4, 40, 4, 2, 16)
    counts = (att.flash_attention.launches, att.flash_bwd_fused.launches,
              att.flash_bwd_dq.launches, att.flash_bwd_dkv.launches)
    grads = []
    for limit in (4096, 0):
        monkeypatch.setattr(att, "FUSED_BWD_MAX_S", limit)
        tq, tk, tv = leaf(q), leaf(k), leaf(v)
        out = att.flash_attention(tq, tk, tv, True)
        grads.append(torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                         (tq, tk, tv)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert counts == (att.flash_attention.launches, att.flash_bwd_fused.launches,
                      att.flash_bwd_dq.launches, att.flash_bwd_dkv.launches)


def test_no_graph_without_grad_mode():
    """The serving path (no grad mode) runs the forward alone: no graph,
    no lse kept."""
    q, k, v, _ = make(6, 12, 2, 2, 16)
    with torch.no_grad():
        out = att.flash_attention(leaf(q), leaf(k), leaf(v))
    assert out.grad_fn is None and not out.requires_grad
