"""Llama-3-style decoder in PyTorch: the forward pass of
``nanotpu/models/llama.py`` over the same parameter tree.

RMSNorm with f32 accumulation, rotary embeddings, GQA attention and a
SwiGLU MLP; parameters are a dict of ``[in, out]`` weights used as
``x @ w``, per-layer dicts in a list. ``attn_impl="flash"`` routes
attention through :func:`nanotpu_torch.ops.attention.flash_attention`;
``"dense"`` is the plain einsum chain. :func:`loss_fn` is the chunked
next-token cross entropy, and ``remat`` recomputes each layer in backward
through ``torch.utils.checkpoint``.

On a mesh, the train step passes ``shard``
(:class:`nanotpu_torch.parallel.mesh.Shards`) and the same functions run
on this rank's shards: its batch rows and, over sp, its sequence block
(rope positions offset to match); weights gathered over fsdp at use;
heads, ffn and vocab split over tp, with the tp collectives around each
split product, the embedding and the cross entropy. ``attn_impl="ring"``
(ring attention over sp, nanotpu's ``"ring"``) needs one, as does
``"ring_manual"``, which the pipeline's stages take (nanotpu's per-shard
ring inside its manual region; here the same call on the sp group).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from nanotpu_torch import resolve_device
from nanotpu_torch.models.quant import QArray, embedding_lookup, matmul
from nanotpu_torch.ops.attention import NEG_INF, flash_attention
from nanotpu_torch.parallel.ring_attention import ring_attention
from nanotpu_torch.tree import leaves


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    #: "dense" (einsum chain), "flash" (the CUDA kernel) or "ring" (ring
    #: attention over a mesh's sp axis, each block through the kernel;
    #: "ring_manual" inside a pipeline stage)
    attn_impl: str = "dense"
    remat: bool = False
    #: "full" recomputes the whole layer in backward; "dots" saves the
    #: matmul outputs and recomputes the rest
    remat_policy: str = "full"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def tiny(vocab: int = 256) -> "LlamaConfig":
        """CPU-testable config: 2 layers, 64-dim."""
        return LlamaConfig(
            vocab_size=vocab, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, max_seq_len=256, dtype="float32",
        )


# -- init ------------------------------------------------------------------

def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> dict:
    """Truncated-normal init, scaled residual projections (GPT-2 style):
    nanotpu's tree and scales. Draws from ``generator`` on the generator's
    device, then places the tree on ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    dt = cfg.torch_dtype
    hd = cfg.head_dim

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.empty(shape, dtype=torch.float32, device=generator.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0,
                                    generator=generator)
        return (w * scale).to(device=device, dtype=dt)

    def ones():
        return torch.ones((cfg.dim,), dtype=torch.float32, device=device)

    embed = dense((cfg.vocab_size, cfg.dim), scale=0.02)
    resid_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn": {
                "wq": dense((cfg.dim, cfg.n_heads * hd)),
                "wk": dense((cfg.dim, cfg.n_kv_heads * hd)),
                "wv": dense((cfg.dim, cfg.n_kv_heads * hd)),
                "wo": dense((cfg.n_heads * hd, cfg.dim),
                            scale=resid_scale / math.sqrt(cfg.dim)),
            },
            "mlp": {
                "w_gate": dense((cfg.dim, cfg.ffn_dim)),
                "w_up": dense((cfg.dim, cfg.ffn_dim)),
                "w_down": dense((cfg.ffn_dim, cfg.dim),
                                scale=resid_scale / math.sqrt(cfg.ffn_dim)),
            },
            "attn_norm": ones(),
            "mlp_norm": ones(),
        })
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": ones(),
        "lm_head": dense((cfg.dim, cfg.vocab_size)),
    }


# -- building blocks -------------------------------------------------------

def linear(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul that dispatches on int8-quantized weights (the serving path,
    :mod:`nanotpu_torch.models.quant`); nothing else in the model knows
    about quantization."""
    if isinstance(w, QArray):
        return matmul(x, w)
    return x @ w


def embed_lookup(w, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """Row gather: a plain table in its own dtype, a quantized one in
    ``dtype`` (the model's)."""
    return embedding_lookup(w, tokens, dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 accumulation regardless of activation dtype."""
    orig = x.dtype
    x = x.float()
    rms = torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (x * rms * weight).to(orig)


def rope_freqs(cfg: LlamaConfig, positions: torch.Tensor):
    """cos/sin tables for rotary embedding, fp32. positions: [B, S] or [S]."""
    hd = cfg.head_dim
    exponent = torch.arange(
        0, hd, 2, dtype=torch.float32, device=positions.device
    ) / hd
    # a Python base keeps this on the device: a tensor built from the
    # scalar would be a host-to-device copy, which waits for the stream
    inv_freq = 1.0 / (cfg.rope_theta ** exponent)
    angles = positions[..., None].float() * inv_freq  # [..., hd/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; cos/sin broadcast over heads."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.dim() == 2:  # [S, hd/2] -> [1, S, 1, hd/2]
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # [B, S, hd/2] -> [B, S, 1, hd/2]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _dense_attention(q, k, v, causal: bool = True):
    """Batched MHA: q [B,S,H,hd], k/v [B,S,H,hd] (kv already repeated)."""
    S, hd = q.shape[1], q.shape[3]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / math.sqrt(hd))
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(params: dict, x: torch.Tensor, cfg: LlamaConfig,
              cos: torch.Tensor, sin: torch.Tensor, shard=None) -> torch.Tensor:
    B, S, _ = x.shape
    hd = cfg.head_dim
    if shard is not None:
        x = shard.tp_in(x)
    # heads from the weights' widths: this rank's share of them under tp
    q = linear(x, params["wq"]).reshape(B, S, -1, hd)
    k = linear(x, params["wk"]).reshape(B, S, -1, hd)
    v = linear(x, params["wv"]).reshape(B, S, -1, hd)
    H, KV = q.shape[2], k.shape[2]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cfg.attn_impl in ("ring", "ring_manual"):
        if shard is None:
            raise ValueError(f"attn_impl {cfg.attn_impl!r} runs on a mesh: "
                             "build_train_step(..., mesh=...)")
        # k/v stay at KV heads: each hop of the ring moves H/KV x fewer bytes
        out = ring_attention(q, k, v, shard.group["sp"], causal=True)
    elif cfg.attn_impl == "flash":
        # GQA-native kernel: k/v stay at kv-head granularity
        out = flash_attention(q, k, v, causal=True)
    elif cfg.attn_impl == "dense":
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=2)
            v = v.repeat_interleave(H // KV, dim=2)
        out = _dense_attention(q, k, v, causal=True)
    else:
        raise ValueError(f"attn_impl {cfg.attn_impl!r} is not ported")
    out = linear(out.reshape(B, S, H * hd), params["wo"])
    return out if shard is None else shard.tp_out(out)


def mlp(params: dict, x: torch.Tensor, shard=None) -> torch.Tensor:
    """SwiGLU."""
    if shard is not None:
        x = shard.tp_in(x)
    out = linear(
        F.silu(linear(x, params["w_gate"])) * linear(x, params["w_up"]),
        params["w_down"],
    )
    return out if shard is None else shard.tp_out(out)


def decoder_layer(params: dict, x: torch.Tensor, cfg: LlamaConfig,
                  cos: torch.Tensor, sin: torch.Tensor,
                  shard=None) -> torch.Tensor:
    x = x + attention(params["attn"], rms_norm(x, params["attn_norm"], cfg.norm_eps), cfg, cos, sin, shard)
    x = x + mlp(params["mlp"], rms_norm(x, params["mlp_norm"], cfg.norm_eps), shard)
    return x


# -- forward ---------------------------------------------------------------

#: the ops whose outputs remat_policy="dots" keeps (jax's dots_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_layer(cfg: LlamaConfig):
    """decoder_layer under a non-reentrant checkpoint: nothing saved
    ("full"), or the matmul outputs saved ("dots"). No op in a layer draws
    a random number, so the RNG state is not stashed: reading the CUDA
    generator's state is refused while a graph captures the step."""
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r} is not one of "
                         "'full', 'dots'")
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def layer(params, x, cfg, cos, sin, shard=None):
        return checkpoint(decoder_layer, params, x, cfg, cos, sin, shard,
                          use_reentrant=False, preserve_rng_state=False,
                          **kw)

    return layer


def hidden_states(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
                  positions: torch.Tensor | None = None,
                  shard=None) -> torch.Tensor:
    """tokens [B, S] int -> final-norm hidden states [B, S, D]. With
    ``shard``, tokens are this rank's sequence block over sp, at positions
    from ``rank * S`` unless ``positions`` are given."""
    S = tokens.shape[1]
    if positions is None:
        start = 0 if shard is None else shard.rank["sp"] * S
        positions = torch.arange(start, start + S, dtype=torch.int32,
                                 device=tokens.device)
    cos, sin = rope_freqs(cfg, positions)
    if shard is None:
        x = embed_lookup(params["embed"], tokens, cfg.torch_dtype)
    else:
        x = shard.embed(shard.use(params["embed"], shard.specs["embed"]),
                        tokens)
    layer_fn = _remat_layer(cfg) if cfg.remat else decoder_layer
    for i, layer_params in enumerate(params["layers"]):
        if shard is not None:  # ZeRO-3: each layer's weights gathered here
            layer_params = shard.use(layer_params, shard.specs["layers"][i])
        x = layer_fn(layer_params, x, cfg, cos, sin, shard)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            positions: torch.Tensor | None = None) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, vocab] float32."""
    x = hidden_states(params, tokens, cfg, positions)
    return linear(x, params["lm_head"]).float()


#: Sequence-chunk length of the cross entropy: the [B, S, vocab] f32 logits
#: and their gradient never exist whole, only [B, CE_CHUNK, vocab] at a time;
#: each chunk's lm_head product is recomputed in backward.
CE_CHUNK = 256


def _chunk_nll(lm_head: torch.Tensor, h: torch.Tensor,
               targets: torch.Tensor, shard=None) -> torch.Tensor:
    """Summed next-token NLL of one hidden-state chunk (f32); with
    ``shard``, over the vocab split of ``lm_head`` across tp."""
    if shard is not None:
        logits = linear(shard.tp_in(h), lm_head).float()
        return shard.nll_sum(logits.reshape(-1, logits.shape[-1]),
                             targets.reshape(-1))
    logits = linear(h, lm_head).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long(), reduction="sum")


def next_token_nll(lm_head, x: torch.Tensor, targets: torch.Tensor,
                   shard=None) -> torch.Tensor:
    """Mean NLL of ``targets [B, S]`` under the logits ``x @ lm_head``, in
    sequence chunks of CE_CHUNK (each under a non-reentrant checkpoint,
    without the RNG stash, as in :func:`_remat_layer`) when the length
    divides, in one piece otherwise. With ``shard``, this rank's share of
    the mean over the global batch: its sum over the tokens of every data
    shard (``lm_head`` gathered over fsdp)."""
    B, S = targets.shape
    count = B * S
    if shard is not None:
        lm_head = shard.use(lm_head, shard.specs["lm_head"])
        count *= shard.token_shards()
    if S <= CE_CHUNK or S % CE_CHUNK:
        return _chunk_nll(lm_head, x, targets, shard) / count
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, CE_CHUNK):
        total = total + checkpoint(
            _chunk_nll, lm_head, x[:, i:i + CE_CHUNK],
            targets[:, i:i + CE_CHUNK], shard, use_reentrant=False,
            preserve_rng_state=False,
        )
    return total / count


def loss_fn(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            shard=None) -> torch.Tensor:
    """Next-token cross entropy over tokens[:, :-1] -> tokens[:, 1:]
    (:func:`next_token_nll`). With ``shard``, ``tokens`` are this rank's
    batch rows and it takes its sequence block of both over sp; the
    result is its share of the global mean, which sums over the data axes
    to the whole."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if shard is not None:
        inputs, targets = shard.seq_block(inputs), shard.seq_block(targets)
    x = hidden_states(params, inputs, cfg, shard=shard)
    return next_token_nll(params["lm_head"], x, targets, shard)


def param_count(params) -> int:
    return sum(p.numel() for p in leaves(params))
