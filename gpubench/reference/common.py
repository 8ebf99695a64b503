"""What both reference models share, in float32: RMSNorm, rotary
embeddings, causal grouped-query attention and the SwiGLU MLP; the
decoder's frame around its layers (the embedding, the layer loop, the
final norm and the head) and the next-token cross entropy.

:class:`Numerics` is where a matrix product's operands are rounded: not at
all (``float32``), or to float8 e4m3 with one scale a tensor (``fp8``), the
precision below the configurations' bfloat16 that the control runs in. In
``fp8`` the backward's products round their operands too: the incoming
gradient to e4m3 under its own scale, the saved operands as the forward
rounded them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: e4m3's largest finite value
FP8_MAX = 448.0


def strict_float32() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one absmax scale, back in float32 (no
    gradient flows through it)."""
    x = x.detach()
    if not x.numel():
        return x
    scale = FP8_MAX / x.abs().amax().clamp_min(1e-12)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8MatMul(torch.autograd.Function):
    """``x @ w`` with every product's operands in e4m3, forward and
    backward: x [..., K], w [K, N]."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = to_fp8(x), to_fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, grad):
        xq, wq = ctx.saved_tensors
        gq = to_fp8(grad)
        dx = gq @ wq.T
        dw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return dx, dw


class Numerics:
    """How a reference rounds its products' operands."""

    def __init__(self, mode: str = "float32"):
        if mode not in ("float32", "fp8"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.float(), w.float()
        if self.mode == "fp8":
            return _Fp8MatMul.apply(x, w)
        return x @ w


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * weight.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half form: x [..., S, heads, hd] at
    ``positions`` [S]."""
    hd = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                             device=x.device) / hd))
    angles = positions.double()[:, None] * inv_freq[None, :]
    cos = torch.cos(angles).float()[:, None, :]
    sin = torch.sin(angles).float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 1024) -> torch.Tensor:
    """q [B, S, H, hd] over k, v [B, S, KV, hd], query i seeing keys 0..i;
    query head h reads kv head h // (H / KV). Softmax in float32, in
    blocks of ``block`` queries so that the [H, block, S] scores fit."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    outs = []
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        scores = torch.einsum("bqhd,bkhd->bhqk", q[:, lo:hi], k[:, :hi])
        scores = scores / math.sqrt(hd)
        keep = (torch.arange(hi, device=q.device)[None, :]
                <= torch.arange(lo, hi, device=q.device)[:, None])
        scores = scores.masked_fill(~keep, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, v[:, :hi]))
    return torch.cat(outs, dim=1)


def attention(attn: dict, h: torch.Tensor, conf: dict, positions, num: Numerics):
    """The attention block on normed h [B, S, D]."""
    B, S, D = h.shape
    H, KV = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or D // H
    q = num.mm(h, attn["wq"]).view(B, S, H, hd)
    k = num.mm(h, attn["wk"]).view(B, S, KV, hd)
    v = num.mm(h, attn["wv"]).view(B, S, KV, hd)
    q = rope(q, positions, conf["rope_theta"])
    k = rope(k, positions, conf["rope_theta"])
    out = causal_attention(q, k, v)
    return num.mm(out.reshape(B, S, H * hd), attn["wo"])


def swiglu(h: torch.Tensor, w_gate, w_up, w_down, num: Numerics):
    return num.mm(F.silu(num.mm(h, w_gate)) * num.mm(h, w_up), w_down)


def float32(tree):
    """``tree`` with every leaf in float32 (a float32 leaf is itself, so a
    gradient reaches it)."""
    if isinstance(tree, dict):
        return {k: float32(v) for k, v in tree.items()}
    return tree.float()


def decoder(params: dict, ids: torch.Tensor, block):
    """(the residual stream [B, S, D] after every layer, [what each layer's
    block returned beside it]) on tokens ``ids`` [B, S] at positions 0..S-1.

    ``block(layer, x, positions) -> (x, extra)`` gets one layer's weights
    cast to float32, one layer at a time, so that the float32 copy of a
    whole bfloat16 model is never held; it runs under a checkpoint, so
    that a backward holds one layer's activations at a time."""
    positions = torch.arange(ids.shape[1], device=ids.device)
    x = params["embed"][ids].float()
    extras = []
    for layer in params["layers"]:
        x, extra = checkpoint(block, float32(layer), x, positions,
                              use_reentrant=False)
        extras.append(extra)
    return x, extras


def _head(params: dict, x: torch.Tensor, conf: dict, num: Numerics):
    """Float32 logits of the residual stream ``x``: the final RMSNorm, then
    the untied head."""
    return num.mm(rms_norm(x, params["final_norm"], conf["rms_norm_eps"]),
                  params["lm_head"])


@torch.no_grad()
def window_logits(weights: dict, conf: dict, tokens: list[int],
                  wanted: range, block, num: Numerics) -> torch.Tensor:
    """Float32 logits [len(wanted), vocab] at positions ``wanted`` of the
    one sequence ``tokens``, teacher forced (position p predicts token
    p + 1), through the layers' ``block`` (:func:`decoder`)."""
    ids = torch.tensor(tokens, dtype=torch.long,
                       device=weights["embed"].device)[None]
    x, _ = decoder(weights, ids, block)
    return _head(weights, x[0, wanted.start:wanted.stop], conf, num)


def next_token_loss(params: dict, conf: dict, tokens: torch.Tensor, block,
                    num: Numerics):
    """(the mean cross entropy of tokens[:, 1:] given tokens[:, :-1], [what
    each layer's ``block`` returned beside the stream])."""
    x, extras = decoder(params, tokens[:, :-1], block)
    logits = _head(params, x, conf, num)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          tokens[:, 1:].reshape(-1))
    return nll, extras
