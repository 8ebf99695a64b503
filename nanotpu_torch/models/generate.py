"""Autoregressive decoding with a preallocated KV cache: the port of
``nanotpu/models/generate.py``.

The cache holds ``max_len`` positions per layer, allocated once; prefill
writes the prompt's k/v, and each decode step attends one new token against
the cache under a position mask. GQA caches the KV heads unexpanded
(``[.., n_kv_heads, hd]``), and the attend einsum groups q heads onto them.

Unlike the JAX original, the cache is updated in place (JAX returns a new
array for each update): one cache lives on the device, not two. Its
``length`` is a host integer, so no step waits on the device to learn it.
A prefill into an empty cache with ``attn_impl="flash"`` runs the flash
kernel. A Mixtral layer (a ``moe`` entry) routes a decode step (S == 1) at
full expert capacity, so co-batched rows stay independent, and a prefill at
the capacity factor of the full forward.

``mesh=`` (:mod:`nanotpu_torch.parallel.infer`) runs the same functions on
this rank's shards of params placed by ``place_params``: its H/tp query and
KV/tp kv heads (the GQA ratio unchanged), the flash kernel on that head
shard, a tp all-reduce after ``wo`` and ``w_down``, weights gathered over
fsdp at use, the vocab-parallel embedding, and the vocab-split head's
logits all-gathered over tp so that every rank samples the same token from
the same generator. The cache holds the rank's kv heads only. A Mixtral
layer runs its E/ep experts a rank, each split over tp, and all-reduces
the combine over ep; every rank holds every row, so it routes them as one
device does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nanotpu_torch import resolve_device
from nanotpu_torch.models.llama import (
    LlamaConfig,
    apply_rope,
    embed_lookup,
    linear,
    mlp,
    rms_norm,
    rope_freqs,
)
from nanotpu_torch.models.mixtral import moe_block
from nanotpu_torch.ops.attention import NEG_INF, flash_attention


class KVCache(NamedTuple):
    """Per-layer cache: k/v are LENGTH-L TUPLES of [B, max_len, n_kv_heads,
    head_dim] tensors; ``length`` is the number of valid positions."""

    k: tuple
    v: tuple
    length: int

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, max_len: int,
               device=None, tp: int = 1) -> "KVCache":
        """Zeroed, at one tp rank's ``n_kv_heads / tp`` heads."""
        shape = (batch, max_len, cfg.n_kv_heads // tp, cfg.head_dim)
        device = resolve_device(device)
        return KVCache(
            k=tuple(torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                    for _ in range(cfg.n_layers)),
            v=tuple(torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                    for _ in range(cfg.n_layers)),
            length=0,
        )


def _attend_cached(q, k_cache, v_cache, valid_len: int):
    """q [B,S,H,hd] against cache [B,max_len,KV,hd]; positions >= valid_len
    masked. For prefill S>1, q position i attends cache[: start+i+1] where
    start = valid_len - S (causal within the new block)."""
    B, S, H, hd = q.shape
    KV, max_len = k_cache.shape[2], k_cache.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, KV, H // KV, hd)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, k_cache).float() * scale
    pos = torch.arange(max_len, device=q.device)
    q_end = valid_len - S + torch.arange(S, device=q.device) + 1
    mask = pos[None, :] < q_end[:, None]  # [S, max_len]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v_cache)
    return out.reshape(B, S, H, hd)


def ffn(layer, x, cfg, full_capacity: bool, drop_acc=None, shard=None):
    """The FFN half of a cached layer on x [B,S,D] (its norm included):
    the SwiGLU MLP of a Llama layer, or the routed experts of a Mixtral
    layer (``moe``), whose aux loss inference drops; with ``shard``, split
    over tp (and a Mixtral layer's experts over ep). ``full_capacity`` and
    ``drop_acc`` go to :func:`~nanotpu_torch.models.mixtral.moe_block`."""
    if "moe" in layer:
        out, _aux = moe_block(
            layer["moe"], rms_norm(x, layer["moe_norm"], cfg.norm_eps), cfg,
            full_capacity=full_capacity, drop_acc=drop_acc, shard=shard,
        )
        return out
    return mlp(layer["mlp"], rms_norm(x, layer["mlp_norm"], cfg.norm_eps),
               shard)


def embed_rows(params, tokens, cfg, shard=None):
    """The embedding of ``tokens`` in the model's dtype: a lookup, or with
    ``shard`` the vocab-parallel one over the table gathered over fsdp."""
    if shard is None:
        return embed_lookup(params["embed"], tokens, cfg.torch_dtype)
    table = shard.use(params["embed"], shard.specs["embed"])
    return shard.embed(table, tokens, cfg.torch_dtype)


def head_logits(params, x, shard=None):
    """f32 logits of hidden states ``x`` (final norm applied) over the
    whole vocabulary: with ``shard``, each rank's vocab slice all-gathered
    over tp."""
    if shard is None:
        return linear(x, params["lm_head"]).float()
    w = shard.use(params["lm_head"], shard.specs["lm_head"])
    return shard.gather(linear(shard.tp_in(x), w).float(), "tp", -1)


def project_qkv(attn, h, cfg, cos, sin, shard=None):
    """q [B,S,H,hd], k and v [B,S,KV,hd] of normed hidden states ``h``
    [B,S,D], rope applied to q and k; with ``shard``, this rank's heads
    (their count read off the weights)."""
    B, S, _ = h.shape
    hd = cfg.head_dim
    if shard is not None:
        h = shard.tp_in(h)
    q = linear(h, attn["wq"]).reshape(B, S, -1, hd)
    k = linear(h, attn["wk"]).reshape(B, S, -1, hd)
    v = linear(h, attn["wv"]).reshape(B, S, -1, hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def project_out(attn, out, shard=None):
    """The output projection of attention ``out`` [B,S,H,hd]; with
    ``shard``, row-parallel over tp and all-reduced."""
    B, S = out.shape[:2]
    o = linear(out.reshape(B, S, -1), attn["wo"])
    return o if shard is None else shard.tp_out(o)


def layer_params(params, i: int, shard=None):
    """Layer ``i``'s weights, gathered over fsdp with ``shard``."""
    layer = params["layers"][i]
    return layer if shard is None else shard.use(layer,
                                                 shard.specs["layers"][i])


def _layer_with_cache(layer, x, cfg, cos, sin, k_cache, v_cache, start: int,
                      full_prefill: bool = False, drop_acc=None, shard=None):
    """One decoder layer over new tokens x [B,S,D], writing this layer's
    k/v at [start, start+S) of the cache in place. Returns x.

    ``full_prefill`` marks the cache-was-empty case: attention is plain
    causal self-attention over the prompt, so ``attn_impl="flash"`` runs it
    through the flash kernel instead of attending the whole cache. A decode
    step (S == 1) of a Mixtral layer routes at full capacity; a prefill
    keeps the capacity factor over this call's B*S tokens, as ``forward``
    does, and appends its per-token drops to ``drop_acc``. With ``shard``
    the layer runs on this rank's heads."""
    S = x.shape[1]
    q, k, v = project_qkv(layer["attn"],
                          rms_norm(x, layer["attn_norm"], cfg.norm_eps), cfg,
                          cos, sin, shard)
    k_cache[:, start:start + S] = k
    v_cache[:, start:start + S] = v
    if full_prefill and cfg.attn_impl == "flash":
        # GQA-native kernel: k/v enter at kv-head granularity (no repeat)
        out = flash_attention(q, k, v, causal=True)
    else:
        out = _attend_cached(q, k_cache, v_cache, start + S)
    x = x + project_out(layer["attn"], out, shard)
    return x + ffn(layer, x, cfg, full_capacity=(S == 1), drop_acc=drop_acc,
                   shard=shard)


def _run(params, tokens, cfg, cache: KVCache, full_prefill: bool = False,
         logits_at=-1, head: bool = True, drop_acc=None, shard=None):
    """Shared prefill/step body: tokens [B,S] appended at cache.length.
    ``logits_at`` indexes the fed positions whose logits it returns, and
    the final norm and lm_head run on those alone: the last by default
    ([B,V]), a padded prompt's last real token, or ``slice(None)`` for
    every position ([B,S,V], the speculative verify).
    ``head=False`` skips the final norm and lm_head and returns
    ``(None, cache)``: for callers that only prime the cache (a speculative
    draft's prefill), whose discarded projection can cost more than the
    shallow draft itself. ``drop_acc`` collects a Mixtral prefill's
    per-token drops, one [B*S] vector a layer. ``shard`` runs it on this
    rank's shards (local ``params``, a cache at its local heads)."""
    S = tokens.shape[1]
    start = cache.length
    positions = start + torch.arange(S, dtype=torch.int32, device=tokens.device)
    cos, sin = rope_freqs(cfg, positions)
    x = embed_rows(params, tokens, cfg, shard)
    for i in range(len(params["layers"])):
        x = _layer_with_cache(
            layer_params(params, i, shard), x, cfg, cos, sin, cache.k[i],
            cache.v[i], start, full_prefill=full_prefill, drop_acc=drop_acc,
            shard=shard,
        )
    new_cache = cache._replace(length=start + S)
    if not head:
        return None, new_cache
    x = rms_norm(x[:, logits_at], params["final_norm"], cfg.norm_eps)
    return head_logits(params, x, shard), new_cache


def mesh_args(params, cfg, mesh):
    """(params, shard) for :func:`_run`: ``params`` and None without a
    mesh; on one, the local shards of a tree placed by
    :func:`nanotpu_torch.parallel.infer.place_params` and their
    :class:`~nanotpu_torch.parallel.mesh.Shards`."""
    if mesh is None:
        return params, None
    from nanotpu_torch.parallel.infer import on_mesh

    return on_mesh(params, cfg, mesh)


def prefill(params, prompt: torch.Tensor, cfg: LlamaConfig, max_len: int,
            head: bool = True, mesh=None, shard=None):
    """prompt [B,S] -> (last-token logits [B,V], primed cache). The cache
    starts empty, so attention is causal self-attention over the prompt,
    through the flash kernel when ``attn_impl="flash"``. ``head=False``
    returns (None, cache). ``mesh`` runs it on the local shards of
    ``params`` placed by ``place_params`` (``shard``: on local shards
    already), each rank's cache at its kv heads."""
    if mesh is not None:
        params, shard = mesh_args(params, cfg, mesh)
    tp = 1 if shard is None else shard.size["tp"]
    cache = KVCache.create(cfg, prompt.shape[0], max_len, device=prompt.device,
                           tp=tp)
    return _run(params, prompt, cfg, cache, full_prefill=True, head=head,
                shard=shard)


def decode_step(params, token: torch.Tensor, cfg: LlamaConfig,
                cache: KVCache, mesh=None, shard=None):
    """token [B] -> (logits [B,V], cache advanced by one); ``mesh`` and
    ``shard`` as for :func:`prefill`."""
    if mesh is not None:
        params, shard = mesh_args(params, cfg, mesh)
    return _run(params, token[:, None], cfg, cache, shard=shard)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but each row's k highest logits to NEG_INF."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]  # [B, 1]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability reaches p; the top token always survives (a p <= 0 keeps it
    alone rather than masking everything)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs  # exclusive cumsum
    first = torch.arange(logits.shape[-1], device=logits.device) == 0
    keep = (cum_before < p) | first
    # lowest kept logit per row is the admission threshold
    threshold = torch.where(keep, sorted_logits, math.inf).amin(
        dim=-1, keepdim=True
    )
    return torch.where(logits < threshold, NEG_INF, logits)


def warp_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                top_p: float = 1.0) -> torch.Tensor:
    """Shared sampling warp: temperature, then top-k, then nucleus."""
    logits = logits / temperature
    if top_k:
        logits = apply_top_k(logits, top_k)
    if top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    return logits


def sample_categorical(logits: torch.Tensor,
                       generator: torch.Generator | None) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick, as
    ``jax.random.categorical`` draws; no host sync. The uniforms start at
    the smallest normal float, as jax's do, so every noise term is finite:
    a token whose logit is -inf (probability 0) is never drawn."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@torch.inference_mode()
def generate(
    params, prompt: torch.Tensor, cfg: LlamaConfig, max_new_tokens: int,
    temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
    generator: torch.Generator | None = None, max_len: int | None = None,
    eos_id: int = -1, mesh=None,
) -> torch.Tensor:
    """Greedy (temperature=0) or sampled generation, with optional top-k
    and/or nucleus filtering when temperature > 0.

    prompt [B, S] -> generated tokens [B, max_new_tokens]. ``eos_id >= 0``
    enables stop-token semantics: once a row emits eos, every later
    position repeats eos. ``mesh`` decodes over it: ``params`` placed by
    :func:`nanotpu_torch.parallel.infer.place_params`, the same prompt and
    an identically seeded ``generator`` on every process, which all return
    the same tokens."""
    B, S = prompt.shape
    max_len = max_len or min(cfg.max_seq_len, S + max_new_tokens)
    if S + max_new_tokens > max_len:
        raise ValueError(
            f"prompt {S} + new {max_new_tokens} exceeds max_len {max_len}"
        )
    params, shard = mesh_args(params, cfg, mesh)
    logits, cache = prefill(params, prompt, cfg, max_len, shard=shard)

    def sample(logits):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        return sample_categorical(
            warp_logits(logits, temperature, top_k, top_p), generator
        )

    token = sample(logits)
    done = (token == eos_id) if eos_id >= 0 else None
    out = [token]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(params, token, cfg, cache, shard=shard)
        token = sample(logits)
        if eos_id >= 0:
            token = torch.where(done, eos_id, token)
            done = done | (token == eos_id)
        out.append(token)
    return torch.stack(out, dim=1)  # [B, max_new_tokens]
