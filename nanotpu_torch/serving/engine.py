"""Continuous-batching serving engine over the KV-cache decode path: the
port of ``nanotpu/serving/engine.py``.

* **Slot-based batch.** The cache is [SLOTS, max_len] per layer, allocated
  once. A request is admitted into a free slot at prefill and evicted at
  eos/max-new; the decode step always runs the full slot batch (inactive
  rows compute garbage that is never read).
* **Per-row cache lengths.** Every slot has its own frontier: rope
  positions, cache writes and attention masks are per row, which lets
  requests at different depths share one step.
* **Sampling on the device.** The step samples per row (per-row
  temperature; engine-wide top-k/top-p), and a decode chunk of n steps
  keeps tokens, done flags and budgets on the device, fetching its
  [n_steps, SLOTS] token block with one host sync.
* **Prefill through the flash kernel.** Admission runs
  :func:`nanotpu_torch.models.generate._run` over the prompt padded to its
  prefill length (:func:`prefill_len`: a bucket up to 128 tokens,
  beyond that the length rounded up to the flash forward's 128-row block),
  so a flash config's prefill launches the CUDA kernel once per layer, and
  the head runs on the last real token alone; the rows, at the prefilled
  length, are then copied into the slot (:func:`insert_rows`).
* **Decode attend through its own kernel.** Every ``_rows_forward`` (a
  decode step, a speculative draft or verify) attends each layer's slot
  cache through :func:`nanotpu_torch.ops.decode_attention.decode_attention`:
  on a card one launch of a split-KV kernel that reads each row only up to
  its own length, on the CPU nanotpu's einsum.
* **int8** composes: ``linear`` dispatches on ``QArray`` leaves, so an
  engine built from ``quantize_params(params)`` runs weight-only int8, and
  ``kv_int8`` keeps the cache in int8 with one f32 scale per (row,
  position, kv head). In eager PyTorch the attend dequantizes the whole
  cache layer to the model's dtype first (XLA fuses that into the product).
* **Per-row speculative decoding.** With ``draft_params`` a draft proposes
  K tokens per cycle, the target verifies the whole slot batch in one
  forward at per-row frontiers, and each row advances by its own
  acceptance; a policy picks plain or speculative chunks per host sync.
* **CUDA graphs.** On a card the engine captures its decode step and each
  speculative cycle as a CUDA graph at warm-up (:mod:`.graphs`), and a
  chunk replays one a step: the counterpart of the JAX engine's compiled
  chunk. On the CPU the same bodies run eagerly.
* **Spans** (:mod:`nanotpu_torch.metrics.spans`, recorded only under the
  profiler or after ``enable()``): ``engine.queue`` (a request's wait from
  submission to its pop), ``engine.admit`` over ``engine.prefill`` (one a
  request: ``tokens``, the true length, and ``bucket``, the length
  prefilled), ``engine.chunk`` (its kind, units, slots, active rows and
  the tokens it emitted) and ``engine.sync`` (each fetch of first tokens
  or of a chunk's tokens); none inside a captured unit.

MoE (a ``MixtralConfig`` engine) routes every decode step, speculative
draft and verify at **full expert capacity** (C = rows x positions x
top_k), so each slot's routing is independent of its batch-mates. Prefill
keeps Switch capacity over the padded length, and counts the real tokens
it drops (``moe_prefill_dropped_total``); where that capacity can drop
(``capacity_factor * top_k < n_experts``) the padded length stays the
bucket, so that C, and which tokens are dropped, are the JAX engine's.

The caches and the decode carry are allocated once and updated in place
(the JAX engine donates its buffers to the same end), so a graph's
addresses hold.

**On a mesh** (``mesh=``, :mod:`nanotpu_torch.parallel.infer`) each process
holds its shards: params placed tp x fsdp (a MoE model's experts over ep
too), from a tree on its card or on the CPU, the caches at its kv heads. The
JAX engine drives the whole mesh from one process; here one process drives
each card, and what the loop decides hangs on the host (when requests
arrive, the measured policy's clock, what each row still owes). So rank 0
leads: its loop decides each unit and first broadcasts a fixed-size
descriptor of it over the world group (:meth:`Engine._announce`): an
admission (slot, the prompt, true length, temperature, token budget), a
draft re-prime, a chunk (K, its unit count), a reset after a failed
cycle, an idle heartbeat, or the stop. Every other rank follows
(:meth:`Engine._follow`): it blocks on that broadcast and runs the same
unit body on its shards, with the same host bookkeeping, from a generator
seeded as rank 0's, so its requests (``followed``) end with the same
tokens. ``submit`` on a follower raises. The captured graphs then
hold the NCCL collectives of a step: the tp all-reduces, the logits'
all-gather, the fsdp gathers and a MoE layer's ep all-reduce.
"""

from __future__ import annotations

import functools
import itertools
import logging
import threading
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from nanotpu_torch import resolve_device
from nanotpu_torch.metrics import spans
from nanotpu_torch.metrics.stats import percentile
from nanotpu_torch.models.generate import (
    KVCache,
    _run,
    apply_top_k,
    embed_rows,
    ffn,
    apply_top_p,
    head_logits,
    layer_params,
    project_out,
    project_qkv,
    sample_categorical,
    warp_logits,
)
from nanotpu_torch.models.llama import rms_norm, rope_freqs
from nanotpu_torch.models.quant import absmax_scale
from nanotpu_torch.models.speculative import (
    _accepted_prefix,
    rejection_step,
    sample_probs,
)
from nanotpu_torch.ops import _build
from nanotpu_torch.ops.decode_attention import decode_attention
from nanotpu_torch.serving.graphs import DecodeBuffers, StepGraph

log = logging.getLogger("nanotpu_torch.serving")

#: Prompt lengths are padded up to one of these before prefill in the JAX
#: engine, where each bucket is one compiled program; here they bound the
#: prefill length (:func:`prefill_len`).
DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)

#: A prompt longer than this is prefilled at its length rounded up to a
#: multiple of it: the bf16 flash forward's query block
#: (``flash_fwd_bf16<128, 2>``, two warpgroups of 64 rows) and its key tile
#: (``kFwdKeys``, ``ops/csrc/flash_fwd.cu``), so that no block is emptier
#: than the prompt's own tail and every prefill GEMM's M is a multiple of
#: it. The eager prefill takes any length; a bucket buys only padding.
PREFILL_BLOCK = 128


def prefill_len(n: int, buckets: tuple = DEFAULT_BUCKETS,
                capacity_bound: bool = False) -> int:
    """The length a prompt of ``n`` tokens is prefilled at: ``n`` rounded
    up to :data:`PREFILL_BLOCK`, never past its bucket (the first of the
    sorted ``buckets`` that holds it, else the last), so never past
    ``max_len``. ``capacity_bound`` (a MoE whose Switch capacity can drop
    a token) keeps the bucket: its capacity is a share of the padded
    length, and a shorter one would drop more real tokens."""
    bucket = next((b for b in buckets if n <= b), buckets[-1])
    if capacity_bound:
        return bucket
    return min(bucket, -(-n // PREFILL_BLOCK) * PREFILL_BLOCK)


class SlotCache(NamedTuple):
    """Per-layer k/v [SLOTS, max_len, KV, hd] + per-row valid lengths."""

    k: tuple
    v: tuple
    lengths: torch.Tensor  # [SLOTS] int32, on the device

    @staticmethod
    def create(cfg, slots: int, max_len: int, device=None,
               tp: int = 1) -> "SlotCache":
        """Zeroed, at one tp rank's ``n_kv_heads / tp`` heads."""
        shape = (slots, max_len, cfg.n_kv_heads // tp, cfg.head_dim)
        device = resolve_device(device)
        return SlotCache(
            k=tuple(torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                    for _ in range(cfg.n_layers)),
            v=tuple(torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                    for _ in range(cfg.n_layers)),
            lengths=torch.zeros((slots,), dtype=torch.int32, device=device),
        )


class SlotCache8(NamedTuple):
    """int8 variant of :class:`SlotCache`: k/v stored int8 with one f32
    scale per (row, position, kv head), half the bytes a decode step reads
    from the cache."""

    k: tuple  # per-layer int8 [SLOTS, max_len, KV, hd]
    v: tuple
    k_scale: tuple  # per-layer f32 [SLOTS, max_len, KV]
    v_scale: tuple
    lengths: torch.Tensor  # [SLOTS] int32

    @staticmethod
    def create(cfg, slots: int, max_len: int, device=None,
               tp: int = 1) -> "SlotCache8":
        """Zeroed, at one tp rank's ``n_kv_heads / tp`` heads."""
        shape = (slots, max_len, cfg.n_kv_heads // tp, cfg.head_dim)
        device = resolve_device(device)
        L = cfg.n_layers

        def zeros(shape, dtype):
            return tuple(torch.zeros(shape, dtype=dtype, device=device)
                         for _ in range(L))

        return SlotCache8(
            k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
            k_scale=zeros(shape[:-1], torch.float32),
            v_scale=zeros(shape[:-1], torch.float32),
            lengths=torch.zeros((slots,), dtype=torch.int32, device=device),
        )


def quantize_kv(x):
    """x [..., hd] -> (int8 values, f32 scale [...]): symmetric per-vector
    absmax quantization, one (position, kv head) vector per cache entry."""
    x = x.float()
    scale = absmax_scale(x.abs().amax(dim=-1))
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def _write_rows(cache_arr, new, offsets):
    """Write new [B, S, ...] into cache_arr [B, T, ...] at per-row offsets,
    in place; returns cache_arr. Rank-generic: serves the [T, KV, hd] value
    caches and the [T, KV] scale planes.

    Keeps ``dynamic_update_slice``'s clamp: a row's start is
    ``min(offset, T - S)``. INVARIANT (never-read-after-freeze): an offset
    within S-1 of max_len is only possible for FROZEN rows (active rows are
    admitted with >= S positions of slack); the clamp then writes over the
    row's still-valid prefix, which is safe solely because frozen rows are
    evicted and never attended again. Plain indexing would instead raise
    or write out of range.

    Positions at and past a row's length hold stale values (an earlier
    occupant's rows, a prefill's pads, a rolled-back speculation): this
    holds only because nothing reads past a row's frontier."""
    B, S = new.shape[:2]
    T = cache_arr.shape[1]
    start = torch.clamp(offsets.long(), 0, T - S)
    cols = start[:, None] + torch.arange(S, device=cache_arr.device)[None, :]
    rows = torch.arange(B, device=cache_arr.device)[:, None]
    cache_arr[rows, cols] = new.to(cache_arr.dtype)
    return cache_arr


def _cache_update_and_views(cache, i, k, v, dtype):
    """Write this step's k/v into layer i of either cache flavour at each
    row's frontier; returns the full-cache k and v to attend (for the int8
    cache, dequantized to ``dtype``)."""
    if isinstance(cache, SlotCache8):
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        for arr, new in ((cache.k[i], kq), (cache.k_scale[i], ks),
                         (cache.v[i], vq), (cache.v_scale[i], vs)):
            _write_rows(arr, new, cache.lengths)
        return (dequantize_kv(cache.k[i], cache.k_scale[i], dtype),
                dequantize_kv(cache.v[i], cache.v_scale[i], dtype))
    return (_write_rows(cache.k[i], k, cache.lengths),
            _write_rows(cache.v[i], v, cache.lengths))


def _rows_forward(params, cfg, cache, tokens, advance, head: bool = True,
                  shard=None):
    """Forward ``tokens [B, S]`` fed at each row's frontier; returns
    (logits [B, S, V] fp32, cache with per-row lengths advanced by
    ``advance [B]``). The shared body of the plain decode step (S=1) and
    the speculative draft and verify steps (S=K+1): k/v for all S positions
    are written at each row's current frontier regardless of ``advance``,
    and positions past the advanced length are stale until the next write
    at that row's length overwrites them (the speculative rollback).
    Frozen rows (advance 0) still write, see the invariant on
    :func:`_write_rows`. ``head=False`` skips the final norm and lm_head and
    returns (None, cache): the draft's cache-extension step. A Mixtral
    layer routes all B*S positions at full capacity: no token is dropped,
    and no row's routing depends on another's. ``shard`` runs it on this
    rank's shards (:mod:`nanotpu_torch.models.generate`'s mesh path), the
    logits all-gathered over tp."""
    B, S = tokens.shape
    positions = cache.lengths[:, None] + torch.arange(
        S, dtype=torch.int32, device=tokens.device
    )[None, :]
    cos, sin = rope_freqs(cfg, positions)
    x = embed_rows(params, tokens, cfg, shard)
    for i in range(len(params["layers"])):
        layer = layer_params(params, i, shard)
        q, k, v = project_qkv(layer["attn"],
                              rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                              cfg, cos, sin, shard)
        k_view, v_view = _cache_update_and_views(cache, i, k, v, x.dtype)
        out = decode_attention(q, k_view, v_view, cache.lengths)
        x = x + project_out(layer["attn"], out, shard)
        x = x + ffn(layer, x, cfg, full_capacity=True, shard=shard)
    new_cache = cache._replace(lengths=cache.lengths + advance.to(torch.int32))
    if not head:
        return None, new_cache
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return head_logits(params, x, shard), new_cache  # [B,S,V]


def _warp_rows(logits, temps, top_k: int, top_p: float):
    """Per-row warped logits: temperature is per row (greedy rows get a
    near-zero temperature floor only to keep the division defined; their
    tokens come from argmax, never from these logits)."""
    sl = logits / torch.clamp(temps, min=1e-6)[:, None]
    if top_k:
        sl = apply_top_k(sl, top_k)
    if top_p < 1.0:
        sl = apply_top_p(sl, top_p)
    return sl


def serving_step(params, cfg, cache, tokens, active, temps, generator,
                 top_k: int = 0, top_p: float = 1.0, shard=None):
    """One decode step for the whole slot batch.

    tokens/active/temps: [SLOTS]; returns (next_tokens [SLOTS], cache with
    active rows advanced by one). Greedy where temps <= 0, temperature /
    top-k / top-p sampling elsewhere."""
    logits_all, new_cache = _rows_forward(
        params, cfg, cache, tokens[:, None], active.to(torch.int32),
        shard=shard,
    )
    logits = logits_all[:, -1]  # [B, V]
    greedy = torch.argmax(logits, dim=-1)
    sampled = sample_categorical(_warp_rows(logits, temps, top_k, top_p),
                                 generator)
    return torch.where(temps > 0, sampled, greedy), new_cache


def serving_chunk_step(params, cfg, cache, tokens, done, temps, remaining,
                       generator, eos_id: int = -1, top_k: int = 0,
                       top_p: float = 1.0, shard=None):
    """One step of :func:`serving_chunk` (the body of nanotpu's scan, and
    what the engine captures as a CUDA graph): a decode step plus the
    freeze rule. A row freezes when it emits ``eos_id`` or its
    ``remaining`` budget hits zero; frozen rows re-feed their token and do
    not advance their length.

    Returns (cache, tokens, done, remaining), each a new value: the cache's
    k/v are written in place, its ``lengths`` is a new tensor."""
    active = ~done
    nxt, cache = serving_step(
        params, cfg, cache, tokens, active, temps, generator,
        top_k=top_k, top_p=top_p, shard=shard,
    )
    tokens = torch.where(done, tokens, nxt)  # frozen rows hold theirs
    remaining = remaining - active.to(remaining.dtype)
    done = done | (remaining <= 0)
    if eos_id >= 0:
        done = done | (tokens == eos_id)
    return cache, tokens, done, remaining


def serving_chunk(params, cfg, cache, tokens, done, temps, remaining,
                  generator, n_steps: int, eos_id: int = -1, top_k: int = 0,
                  top_p: float = 1.0, shard=None):
    """``n_steps`` decode steps with tokens/done/remaining kept on the
    device (the JAX engine's ``lax.scan`` chunk as a loop of
    :func:`serving_chunk_step`): no step waits on the host.

    Returns (cache, tokens, done, remaining, toks [n_steps, SLOTS]) with
    ``toks`` still on the device; the caller fetches it in one sync."""
    toks = []
    for _ in range(n_steps):
        cache, tokens, done, remaining = serving_chunk_step(
            params, cfg, cache, tokens, done, temps, remaining, generator,
            eos_id=eos_id, top_k=top_k, top_p=top_p, shard=shard,
        )
        toks.append(tokens)
    return cache, tokens, done, remaining, torch.stack(toks)


def speculative_serving_cycle(params, draft_params, cfg, dcfg, cache,
                              d_cache, tokens, active, temps, generator,
                              draft_tokens: int, top_k: int = 0,
                              top_p: float = 1.0, shard=None, dshard=None):
    """One speculative cycle for the whole slot batch, each row advancing by
    ITS OWN acceptance.

    The draft proposes K tokens per row, plus one extension step that
    writes d_K's cache entry (needed where a row accepts everything, stale
    elsewhere); the target verifies every row's K+1 tokens in ONE forward
    at per-row frontiers; greedy matching (temps <= 0) or rejection
    sampling (temps > 0) decides each row's acceptance a_i, and row i emits
    a_i+1 tokens and advances both caches by a_i+1. No host sync.

    tokens/active/temps: [SLOTS]. Returns (cache, d_cache, next_tokens
    [SLOTS], emit [SLOTS, K+1], counts [SLOTS]): counts[i] of emit[i] are
    valid (0 for inactive rows). ``shard`` and ``dshard`` run the target
    and the draft on this rank's shards."""
    B = tokens.shape[0]
    K = draft_tokens
    t_base, d_base = cache.lengths, d_cache.lengths
    ones = torch.ones((B,), dtype=torch.int32, device=tokens.device)
    zeros = torch.zeros_like(ones)

    # -- draft: K proposals per row + the cache-extension step ------------
    tok, drafts, qs = tokens, [], []
    for _ in range(K):
        logits, d_cache = _rows_forward(draft_params, dcfg, d_cache,
                                        tok[:, None], ones, shard=dshard)
        q_warp = torch.softmax(
            _warp_rows(logits[:, -1], temps, top_k, top_p), dim=-1)
        sampled = sample_probs(q_warp, generator)
        tok = torch.where(temps > 0, sampled,
                          torch.argmax(logits[:, -1], dim=-1))
        drafts.append(tok)
        qs.append(q_warp)
    drafts = torch.stack(drafts, dim=1)  # [B, K]
    q_probs = torch.stack(qs, dim=1)  # [B, K, V]
    _, d_cache = _rows_forward(draft_params, dcfg, d_cache, tok[:, None],
                               zeros, head=False, shard=dshard)

    # -- target verifies cur + d1..dK in one per-row-frontier forward -----
    verify = torch.cat([tokens[:, None], drafts], dim=1)  # [B, K+1]
    v_logits, cache = _rows_forward(params, cfg, cache, verify, zeros,
                                    shard=shard)
    greedy = torch.argmax(v_logits, dim=-1)  # [B, K+1]
    flat = v_logits.reshape(B * (K + 1), -1)
    p_all = torch.softmax(
        _warp_rows(flat, temps.repeat_interleave(K + 1), top_k, top_p),
        dim=-1,
    ).reshape(B, K + 1, -1)
    accepted, resampled = rejection_step(p_all[:, :K], q_probs, drafts,
                                         generator)
    a = torch.where(temps > 0, _accepted_prefix(accepted),
                    _accepted_prefix(drafts == greedy[:, :K]))  # [B]

    # the token at each row's emit position a: all accepted -> a bonus
    # draw from the K+1-th target distribution; rejected at a -> the
    # residual draw (sampled rows) or the target's greedy token
    bonus = sample_probs(p_all[:, K], generator)
    res_pad = torch.cat([resampled, resampled[:, -1:]], dim=1)
    res_a = res_pad.gather(1, a[:, None])[:, 0]
    greedy_a = greedy.gather(1, a[:, None])[:, 0]
    tok_a = torch.where(temps > 0, torch.where(a == K, bonus, res_a),
                        greedy_a)
    # emit[i] = d1..d_{a_i}, tok_a_i, <junk beyond counts[i]>
    emit = torch.cat([drafts, drafts[:, -1:]], dim=1)  # [B, K+1]
    at_a = torch.arange(K + 1, device=emit.device)[None, :] == a[:, None]
    emit = torch.where(at_a, tok_a[:, None], emit)

    counts = torch.where(active, a + 1, 0).to(torch.int32)
    cache = cache._replace(lengths=t_base + counts)
    d_cache = d_cache._replace(lengths=d_base + counts)
    nxt = emit.gather(1, torch.clamp(counts - 1, min=0)[:, None].long())[:, 0]
    nxt = torch.where(active, nxt, tokens)
    return cache, d_cache, nxt, emit, counts


def speculative_serving_chunk(params, draft_params, cfg, dcfg, cache,
                              d_cache, tokens, done, temps, remaining,
                              generator, n_cycles: int, draft_tokens: int,
                              eos_id: int = -1, top_k: int = 0,
                              top_p: float = 1.0, shard=None, dshard=None):
    """``n_cycles`` speculative cycles with every carried value on the device
    (the speculative analogue of :func:`serving_chunk`, with its freeze
    rule, emitting up to K+1 tokens per row per cycle).

    Returns (cache, d_cache, tokens, done, remaining, emits [n_cycles,
    SLOTS, K+1], counts [n_cycles, SLOTS]), the last two still on the
    device. Per-cycle counts may overshoot ``remaining`` by up to K, and
    the host replay trims to the budget."""
    emits, counts = [], []
    for _ in range(n_cycles):
        cache, d_cache, tokens, done, remaining, emit, count = (
            speculative_chunk_cycle(
                params, draft_params, cfg, dcfg, cache, d_cache, tokens, done,
                temps, remaining, generator, draft_tokens, eos_id=eos_id,
                top_k=top_k, top_p=top_p, shard=shard, dshard=dshard,
            ))
        emits.append(emit)
        counts.append(count)
    return (cache, d_cache, tokens, done, remaining, torch.stack(emits),
            torch.stack(counts))


def speculative_chunk_cycle(params, draft_params, cfg, dcfg, cache, d_cache,
                            tokens, done, temps, remaining, generator,
                            draft_tokens: int, eos_id: int = -1,
                            top_k: int = 0, top_p: float = 1.0, shard=None,
                            dshard=None):
    """One cycle of :func:`speculative_serving_chunk` (what the engine
    captures as a CUDA graph): a speculative cycle plus the freeze rule. A
    row freezes when its valid emitted prefix holds ``eos_id`` or its
    budget runs out.

    Returns (cache, d_cache, tokens, done, remaining, emit [SLOTS, K+1],
    counts [SLOTS]), each a new value: both caches' k/v are written in
    place, their ``lengths`` are new tensors."""
    K = draft_tokens
    cache, d_cache, tokens, emit, count = speculative_serving_cycle(
        params, draft_params, cfg, dcfg, cache, d_cache, tokens, ~done,
        temps, generator, K, top_k=top_k, top_p=top_p, shard=shard,
        dshard=dshard,
    )
    remaining = remaining - count
    done = done | (remaining <= 0)
    if eos_id >= 0:
        valid = torch.arange(K + 1, device=emit.device)[None, :] < count[:, None]
        done = done | (valid & (emit == eos_id)).any(dim=1)
    return cache, d_cache, tokens, done, remaining, emit, count


def _tp(shard) -> int:
    return 1 if shard is None else shard.size["tp"]


def _fetch(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``: the host's wait for the device, as an ``engine.sync``
    span."""
    with spans.span("engine.sync"):
        return t.cpu()


def prefill_cache_only(params, cfg, prompt_padded, shard=None):
    """Prefill that only primes cache rows, no lm_head (the speculative
    draft's admission path). Takes a [B, S] batch (the re-prime path's
    rows of one prefill length in one call); returns (k rows, v rows),
    per layer [B, S, KV, hd], for :func:`insert_rows`; ``shard``: at this
    rank's kv heads."""
    cache = KVCache.create(cfg, *prompt_padded.shape,
                           device=prompt_padded.device, tp=_tp(shard))
    _, cache = _run(params, prompt_padded, cfg, cache, full_prefill=True,
                    head=False, shard=shard)
    return cache.k, cache.v


def prefill_request(params, cfg, prompt_padded, true_len: int, temp: float,
                    generator, top_k: int = 0, top_p: float = 1.0,
                    count_drops: bool = False, shard=None):
    """Prefill one request (B=1, padded prompt) and sample its first token
    from the logits of its last real token, the one position the head
    runs on.

    Returns (first_token 0-dim tensor, k rows, v rows) where rows are
    per-layer [1, S_pad, KV, hd] for :func:`insert_rows`. The pad region's
    k/v are garbage but sit at positions >= true_len, beyond the row's
    frontier: never attended.

    ``count_drops`` (MoE models) appends a fourth value, a 0-dim int32
    tensor on the device: the real tokens' choices that expert capacity
    dropped, over every layer. Prefill routes at Switch capacity over the
    padded prompt, and capacity fills in token order, so the trailing pads
    lose their slots first: they are masked out of the count. ``shard``
    runs it on this rank's shards, its rows at the rank's kv heads."""
    cache = KVCache.create(cfg, *prompt_padded.shape,
                           device=prompt_padded.device, tp=_tp(shard))
    drop_acc = [] if count_drops else None
    logits, cache = _run(
        params, prompt_padded, cfg, cache, full_prefill=True,
        logits_at=true_len - 1, drop_acc=drop_acc, shard=shard,
    )  # [1, V]; drop_acc holds one [S_pad] vector a MoE layer
    if temp > 0:
        first = sample_categorical(warp_logits(logits, temp, top_k, top_p),
                                   generator)
    else:
        first = torch.argmax(logits, dim=-1)
    if not count_drops:
        return first[0], cache.k, cache.v
    real = torch.arange(prompt_padded.shape[1],
                        device=prompt_padded.device) < true_len
    drops = torch.zeros((), dtype=torch.int32, device=prompt_padded.device)
    if drop_acc:
        drops = torch.where(real, sum(drop_acc), 0).sum().to(torch.int32)
    return first[0], cache.k, cache.v, drops


def _cache_planes(cache, ks, vs):
    """(cache array, row values) pairs of every layer: k and v, and for the
    int8 cache the rows quantized (once, here) and their scale planes."""
    if isinstance(cache, SlotCache8):
        kq = [quantize_kv(rk) for rk in ks]
        vq = [quantize_kv(rv) for rv in vs]
        return (list(zip(cache.k, (q for q, _ in kq)))
                + list(zip(cache.v, (q for q, _ in vq)))
                + list(zip(cache.k_scale, (s for _, s in kq)))
                + list(zip(cache.v_scale, (s for _, s in vq))))
    return list(zip(cache.k, ks)) + list(zip(cache.v, vs))


def insert_rows(cache, ks, vs, slots, lengths):
    """Copy row j of a prefilled batch (per layer [B, S, KV, hd]) into the
    first S positions of slot ``slots[j]``, in place, and set that slot's
    length to ``lengths[j]`` (host sequences, indexed as Python ints: no
    index is uploaded). The slot's positions from S on keep its previous
    occupant's rows: this holds only because nothing reads past a row's
    frontier. A row whose slot lies outside [0, SLOTS) is dropped, as the
    JAX engine's ``mode="drop"`` scatter drops it: on a card an
    out-of-range index would be a device-side assert that ends the
    process's CUDA context."""
    n_slots = cache.lengths.shape[0]
    keep = [(j, int(s), int(n)) for j, (s, n) in enumerate(zip(slots, lengths))
            if 0 <= int(s) < n_slots]
    for arr, new in _cache_planes(cache, ks, vs):
        for j, s, _ in keep:
            arr[s, :new.shape[1]] = new[j]
    for _, s, n in keep:
        cache.lengths[s].fill_(n)
    return cache


#: the unit descriptor rank 0 broadcasts on a mesh: [kind, six fields, its
#: sequence number], then an admission's prompt padded to max_len
_NOOP, _ADMIT, _REPRIME, _CHUNK, _RESET, _STOP = range(6)
_HEADER = 8


def _f64_bits(x: float) -> int:
    return int(np.float64(x).view(np.int64))


def _bits_f64(x) -> float:
    return float(np.int64(x).view(np.float64))


class Request:
    """One generation request; wait() blocks until completion."""

    _ids = itertools.count()

    def __init__(self, tokens: list[int], max_new_tokens: int,
                 temperature: float = 0.0):
        self.id = next(self._ids)
        self.prompt = list(tokens)
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.out: list[int] = []
        self.submitted_at = time.perf_counter()
        self.first_token_at: float | None = None
        self.done_at: float | None = None
        self.error: str | None = None
        self._done = threading.Event()
        #: signaled by the engine loop whenever new tokens landed in
        #: ``out`` (once per decode chunk per row): stream()'s wakeup
        self._progress = threading.Condition()

    # -- results -----------------------------------------------------------
    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def stream(self, timeout: float | None = None):
        """Yield lists of new tokens as the engine emits them (one batch
        per decode-chunk boundary), returning when the request completes.
        ``timeout`` bounds the wait for EACH batch; no progress within it
        raises TimeoutError. Check ``self.error`` after exhaustion."""
        cursor = 0
        while True:
            with self._progress:
                while cursor >= len(self.out) and not self._done.is_set():
                    if not self._progress.wait(timeout):
                        raise TimeoutError(
                            f"request {self.id}: no progress in {timeout}s"
                        )
                batch = list(self.out[cursor:])
            cursor += len(batch)
            if batch:
                yield batch
            if self._done.is_set() and cursor >= len(self.out):
                return

    def _notify_progress(self) -> None:
        with self._progress:
            self._progress.notify_all()

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def latency_s(self) -> float | None:
        if self.done_at is None:
            return None
        return self.done_at - self.submitted_at

    def _finish(self, error: str | None = None) -> None:
        self.error = error
        self.done_at = time.perf_counter()
        self._done.set()
        self._notify_progress()


class Engine:
    """Continuous-batching engine: one background loop interleaves
    admission prefills with whole-batch decode chunks.

    ``slots`` bounds concurrent requests; extras queue. ``eos_id >= 0``
    stops a row early. ``top_k``/``top_p`` apply engine-wide to sampled
    (temperature > 0) rows; temperature is per request. ``params`` must
    already sit on ``device`` (``cuda`` unless the caller names another).
    ``kv_int8`` keeps the target's cache in int8. ``draft_params`` (with
    ``draft_cfg``) turns on per-row speculative decoding with
    ``draft_tokens`` proposals per cycle, under ``spec_policy``:

    * ``"auto"``: speculate only at <= 2 active rows, plain chunks above;
    * ``"always"``: speculate at every occupancy;
    * ``"off"``: plain chunks only;
    * ``"measured"``: pick plain or speculative per sync from the engine's
      own tokens/s per occupancy bucket (:meth:`_bandit_pick`);
    * ``[(max_active, K), ...]``: the first rule whose max_active covers
      the active rows decides K (at most ``draft_tokens``); none, plain.

    The draft's cache is always plain, whatever ``kv_int8`` says: at one or
    two layers it is small next to the target's.

    ``cuda_graphs`` replays each decode step and speculative cycle as a
    CUDA graph captured at warm-up: on by default on a ``cuda`` device, off
    on the CPU (where ``True`` raises). ``False`` on a card runs the same
    bodies eagerly.

    ``mesh`` (a DeviceMesh over every process of the job, from
    :func:`nanotpu_torch.parallel.mesh.make_mesh`) serves over it: every
    process builds the engine from the same whole ``params`` (and draft)
    and the same arguments; the engine places them (``place_params``) and
    keeps its shards. Rank 0 leads and takes requests; the others follow
    (see the module docstring), and their ``stop`` waits for rank 0's.
    """

    #: EWMA weight of one new tokens/s sample (the engine's rate and the
    #: measured policy's arms); the last ~6 chunks dominate
    BANDIT_ALPHA = 0.3
    #: per-arm samples required before exploitation starts
    BANDIT_MIN_SAMPLES = 3
    #: re-probe a losing arm every N syncs per bucket (tracks drift)
    BANDIT_PROBE_EVERY = 12
    #: on a mesh, an idle leader broadcasts a no-op this often, so that no
    #: follower's pending broadcast reaches its collective timeout
    HEARTBEAT_S = 10.0

    def __init__(self, params, cfg, slots: int = 8, max_len: int | None = None,
                 buckets: tuple = DEFAULT_BUCKETS, eos_id: int = -1,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 chunk_steps: int = 32, chunk_steps_max: int = 96,
                 kv_int8: bool = False, draft_params=None, draft_cfg=None,
                 draft_tokens: int = 4, spec_policy="auto", device=None,
                 cuda_graphs: bool | None = None, mesh=None):
        self.device = resolve_device(device)
        if mesh is not None and self.device.type == "cuda":
            from nanotpu_torch.parallel.distributed import local_device

            self.device = local_device(self.device)
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        elif cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a cuda device, not "
                             f"{self.device}")
        self.cuda_graphs = cuda_graphs
        # the norm gains are never quantized: their device is the tree's.
        # On a mesh a whole tree may be held elsewhere (on the CPU): each
        # rank places its own shards on its device (place_params).
        on = params["final_norm"].device
        if mesh is None and on.type != self.device.type:
            raise ValueError(
                f"params live on {on}, the engine on {self.device}"
            )
        #: on a mesh: this rank's shards and the Shards that run the target
        #: (and the draft) on them; rank 0 leads
        self.mesh = mesh
        self._shard = self._dshard = None
        self.world = 1
        self.leader = True
        tp = 1
        if mesh is not None:
            from nanotpu_torch.parallel.infer import on_mesh, place_params

            # the draft's tied embedding and head: the target's shards
            placed, tied = {}, {}
            params, self._shard = on_mesh(
                place_params(params, cfg, mesh, placed), cfg, mesh, tied)
            if draft_params is not None:
                if draft_cfg is None:
                    raise ValueError("draft_params needs draft_cfg")
                draft_params, self._dshard = on_mesh(
                    place_params(draft_params, draft_cfg, mesh, placed),
                    draft_cfg, mesh, tied)
            self.world = dist.get_world_size()
            self.leader = dist.get_rank() == 0
            tp = self._shard.size["tp"]
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len or cfg.max_seq_len
        self.buckets = tuple(b for b in sorted(buckets) if b <= self.max_len)
        if not self.buckets or self.buckets[-1] < self.max_len:
            self.buckets = self.buckets + (self.max_len,)
        self.eos_id = eos_id
        self.top_k = top_k
        self.top_p = top_p
        #: decode steps (speculative: cycles) per host sync: the small chunk
        #: keeps admission latency low while requests queue; the large one
        #: amortizes the per-chunk sync when every row has a long runway
        self.chunk_steps = max(1, chunk_steps)
        self.chunk_steps_max = max(self.chunk_steps, chunk_steps_max)

        self.kv_int8 = kv_int8
        cache_cls = SlotCache8 if kv_int8 else SlotCache
        self._cache = cache_cls.create(cfg, slots, self.max_len,
                                       device=self.device, tp=tp)

        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.draft_tokens = draft_tokens
        self._measured = spec_policy == "measured" and draft_params is not None
        if draft_params is None or spec_policy == "off":
            if draft_params is None and spec_policy != "off":
                # "auto" is the default, so a plain engine built with no
                # speculation settings notes it at INFO only
                log.log(
                    logging.INFO if spec_policy == "auto" else logging.WARNING,
                    "spec_policy=%r requested but draft_params is None: "
                    "speculative decoding is DISABLED, falling back to "
                    "plain decoding (pass draft_params+draft_cfg, or "
                    "spec_policy='off' to silence this)",
                    spec_policy,
                )
            rules: list[tuple[int, int]] = []
        elif spec_policy in ("measured", "always"):
            rules = [(slots, draft_tokens)]
        elif spec_policy == "auto":
            rules = [(2, draft_tokens)]
        else:
            rules = sorted((int(m), int(k)) for m, k in spec_policy)
            for _, k in rules:
                if not 1 <= k <= draft_tokens:
                    raise ValueError(
                        f"spec_policy K={k} outside [1, draft_tokens="
                        f"{draft_tokens}]"
                    )
        self.spec_rules = rules
        #: the K the policy can select, and 0 (plain) when an occupancy
        #: falls through the rules or the bandit needs its plain arm
        variant_ks = sorted({k for _, k in rules})
        if not rules or rules[-1][0] < slots or self._measured:
            variant_ks = [0] + variant_ks
        self._variant_ks = variant_ks
        #: measured-policy state, keyed by (occupancy bucket, chunk
        #: flavour): {k: EWMA tokens/s}, sample counts, and a sync counter
        #: for re-probes. Small and large chunks never share a cell: their
        #: per-sync overhead differs by about their size ratio.
        self._bandit_rate: dict[tuple[int, str], dict[int, float | None]] = {}
        self._bandit_n: dict[tuple[int, str], dict[int, int]] = {}
        self._bandit_t: dict[tuple[int, str], int] = {}
        #: (k, flavour) chunks that have run at least once: the first run's
        #: sample carries first-launch costs and is dropped
        self._chunk_seen: set[tuple[int, str]] = set()
        #: slots whose draft row trails the target (plain chunks ran while
        #: they were active); re-primed before the next speculative chunk
        self._draft_stale: set[int] = set()
        #: speculative cycles run (per active row) and the tokens they
        #: emitted: tokens/cycle - 1 is the realized acceptance x K
        self.spec_cycles_total = 0
        self.spec_cycle_tokens_total = 0
        self._d_cache = None
        if draft_params is not None:
            if draft_cfg is None:
                raise ValueError("draft_params needs draft_cfg")
            self._d_cache = SlotCache.create(draft_cfg, slots, self.max_len,
                                             device=self.device, tp=tp)

        self._slot_req: list[Request | None] = [None] * slots
        # host mirrors of per-row decode state; re-uploaded when _dirty
        self._tokens = np.zeros((slots,), np.int64)  # last token per slot
        self._temps = np.zeros((slots,), np.float32)
        self._done = np.ones((slots,), np.bool_)  # empty slots are frozen
        self._remaining = np.zeros((slots,), np.int32)
        self._dirty = True
        # their device copies, carried across chunks, and each chunk's
        # output blocks: fixed tensors that every decode unit reads
        self._bufs = DecodeBuffers(slots, self.chunk_steps_max, variant_ks,
                                   self.device)
        #: K -> the callable that runs one unit of that kind (0: a plain
        #: step), set at warm-up: a graph's replay, or the eager body
        self._units: dict[int, object] = {}
        #: K -> the captured :class:`~.graphs.StepGraph` (graph mode)
        self.graphs: dict[int, StepGraph] = {}
        #: K -> the units of that kind chunks have run, replays or eager
        #: runs (the warm-up's not counted)
        self.units_run: dict[int, int] = dict.fromkeys(variant_ks, 0)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        #: the unit descriptor (a mesh's broadcast buffer), the count of
        #: descriptors sent or received, and a follower's requests, in
        #: admission order
        self._desc = torch.zeros((_HEADER + self.buckets[-1],),
                                 dtype=torch.int64, device=self.device)
        self._seq = 0
        self.followed: list[Request] = []
        self._queue: deque[Request] = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._warm = threading.Event()
        self._warm_error: BaseException | None = None

        # stats (served by /metrics and /v1/stats)
        self.requests_total = 0
        self.tokens_total = 0
        #: realized decode tokens/s EWMA over warm decode chunks; None until
        #: the first. Read/written under self._cv.
        self.tok_s_ewma: float | None = None
        self.ttft_samples: deque[float] = deque(maxlen=4096)
        self.latency_samples: deque[float] = deque(maxlen=4096)
        #: MoE only: real tokens' expert choices that capacity dropped in
        #: admission prefills (decode routes at full capacity and cannot
        #: drop); see prefill_request
        self.moe_prefill_dropped_total = 0
        self._count_drops = hasattr(cfg, "n_experts")
        #: MoE at a capacity that can drop a token: the prefill's C grows
        #: with its padded length, so that length stays the bucket
        self._capacity_bound = self._count_drops and (
            cfg.capacity_factor * cfg.top_k < cfg.n_experts)

        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serving-engine"
        )
        self._thread.start()

    # -- public API --------------------------------------------------------
    def submit(self, tokens: list[int], max_new_tokens: int,
               temperature: float = 0.0) -> Request:
        if not self.leader:
            raise RuntimeError(
                f"rank {dist.get_rank()} follows rank 0 on the mesh: submit "
                "requests to rank 0's engine")
        req = Request(tokens, max_new_tokens, temperature)
        if not tokens or max_new_tokens < 1:
            req._finish("empty prompt or max_new_tokens < 1")
            return req
        if len(tokens) >= self.max_len:
            req._finish(
                f"prompt length {len(tokens)} >= engine max_len {self.max_len}"
            )
            return req
        if not all(0 <= t < self.cfg.vocab_size for t in tokens):
            req._finish(f"token ids must lie in [0, {self.cfg.vocab_size})")
            return req
        with self._cv:
            if self._stop:
                req._finish("engine stopped")
                return req
            self._queue.append(req)
            self.requests_total += 1
            self._cv.notify()
        return req

    def generate(self, tokens: list[int], max_new_tokens: int,
                 temperature: float = 0.0, timeout: float = 600.0) -> list[int]:
        """Blocking convenience wrapper."""
        req = self.submit(tokens, max_new_tokens, temperature)
        if not req.wait(timeout):
            raise TimeoutError(f"request {req.id} timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.out

    def wait_warm(self, timeout: float | None = None) -> bool:
        """Block until the kernel library is built, one warm-up prefill
        (and with a draft, one draft prefill) has run, and every decode
        unit the policy can pick has run once and, in graph mode, been
        captured, so none of it lands inside the first request's time to
        first token. Raises ``RuntimeError`` if any of it failed."""
        ready = self._warm.wait(timeout)
        if self._warm_error is not None:
            raise RuntimeError("engine warm-up failed") from self._warm_error
        return ready

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the loop, failing what it has not finished; on a mesh,
        rank 0's broadcasts the stop, and a follower's waits (up to
        ``timeout`` seconds) for it."""
        if self.leader:
            with self._cv:
                self._stop = True
                self._cv.notify()
        self._thread.join(timeout=timeout)
        if not self._thread.is_alive():
            # the units hold bound methods of this engine: drop the cycle
            # and the graphs' memory now, not at a later collection
            self._units.clear()
            for graph in self.graphs.values():
                graph.release()

    def metrics(self) -> dict:
        """Cheap feedback snapshot with the JAX engine's key set (the
        serving-provider contract that ``/v1/stats`` consumers read).
        Host-side state only: safe to call from a scrape thread."""
        with self._cv:
            queued = len(self._queue)
            tok_s = self.tok_s_ewma
            ttft_p99 = percentile(list(self.ttft_samples), 0.99)
        active = 0
        kv_used = 0
        for req in self._slot_req:
            if req is None:
                continue
            active += 1
            kv_used += min(self.max_len, len(req.prompt) + len(req.out))
        return {
            "tok_s": round(tok_s, 4) if tok_s is not None else 0.0,
            "queue_depth": float(queued),
            "active": float(active),
            "slots": float(self.slots),
            "kv_occupancy": round(kv_used / (self.slots * self.max_len), 6),
            "chips": float(self.world),
            "ttft_p99_ms": (
                round(ttft_p99 * 1e3, 2) if ttft_p99 is not None else 0.0
            ),
        }

    def stats(self) -> dict:
        """The JAX engine's ``/v1/stats`` fields."""
        m = self.metrics()
        with self._cv:
            queued = len(self._queue)
            ttft = sorted(self.ttft_samples)
            lat = sorted(self.latency_samples)
            # copied under the lock: the loop adds buckets as it goes
            bandit = {b: dict(arms) for b, arms in self._bandit_rate.items()}
        active = sum(1 for r in self._slot_req if r is not None)

        def pct(xs, p):
            return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else None

        return {
            "slots": self.slots,
            "active": active,
            "queued": queued,
            "tok_s": m["tok_s"],
            "kv_occupancy": m["kv_occupancy"],
            "chips": int(m["chips"]),
            "requests_total": self.requests_total,
            "tokens_total": self.tokens_total,
            "moe_prefill_dropped_total": self.moe_prefill_dropped_total,
            "ttft_p50_ms": pct(ttft, 0.5) and round(pct(ttft, 0.5) * 1e3, 2),
            "ttft_p99_ms": pct(ttft, 0.99) and round(pct(ttft, 0.99) * 1e3, 2),
            "latency_p50_ms": pct(lat, 0.5) and round(pct(lat, 0.5) * 1e3, 2),
            # mean emitted tokens per speculative cycle (1 + realized
            # acceptance x K); None until a speculative chunk has run
            "spec_cycles_total": self.spec_cycles_total,
            "spec_tokens_per_cycle": (
                round(self.spec_cycle_tokens_total / self.spec_cycles_total,
                      3)
                if self.spec_cycles_total else None
            ),
            # the measured policy's arm table, keys "occupancy/flavour"
            "spec_bandit_tok_s": (
                {
                    f"{b[0]}/{b[1]}": {
                        str(k): (r if r is None else round(r, 1))
                        for k, r in arms.items()
                    }
                    for b, arms in bandit.items()
                }
                if self._measured else None
            ),
        }

    # -- engine loop -------------------------------------------------------
    def _prefill_len(self, n: int) -> int:
        """:func:`prefill_len` over this engine's buckets and config."""
        return prefill_len(n, self.buckets, self._capacity_bound)

    def _warm_up(self) -> None:
        """Build the kernel library, run one prefill at a one-token
        prompt's prefill length (with a draft, one draft prefill too), and
        run each decode unit the policy can pick eagerly; in graph mode,
        then capture it. Every slot is frozen meanwhile (the buffers'
        initial state): the units' writes land at and past each row's
        frontier, where nothing reads, and no length, token or budget
        moves."""
        if self.device.type == "cuda":
            if self.device.index is not None:
                # the loop's thread: its collectives and graphs use this card
                torch.cuda.set_device(self.device)
            _build.build_all()
        padded = torch.zeros((1, self._prefill_len(1)), dtype=torch.long,
                             device=self.device)
        prefill_request(self.params, self.cfg, padded, 1, 0.0, self._gen,
                        shard=self._shard)
        if self.draft_params is not None and self.spec_rules:
            prefill_cache_only(self.draft_params, self.draft_cfg, padded,
                               shard=self._dshard)
        if self.cuda_graphs:
            # one pool for all of this engine's graphs: they never run at
            # once, and each keeps its outputs in the fixed buffers
            pool = torch.cuda.graph_pool_handle()
            stream = torch.cuda.Stream(self.device)
        for k in self._variant_ks:
            body = (self._plain_unit if k == 0
                    else functools.partial(self._spec_unit, k))
            if self.cuda_graphs:  # eager warm runs, then the capture
                self.graphs[k] = StepGraph(body, self._gen, pool, stream)
                body = self.graphs[k].replay
            else:
                body()
            self._units[k] = body
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _plain_unit(self) -> None:
        """One decode step on the fixed tensors: the body of the plain
        graph."""
        b = self._bufs
        cache, tokens, done, remaining = serving_chunk_step(
            self.params, self.cfg, self._cache, b.tokens, b.done, b.temps,
            b.remaining, self._gen, eos_id=self.eos_id, top_k=self.top_k,
            top_p=self.top_p, shard=self._shard,
        )
        self._cache.lengths.copy_(cache.lengths)
        b.carry(tokens, done, remaining)
        b.record((b.toks, tokens))

    def _spec_unit(self, k: int) -> None:
        """One speculative cycle proposing ``k`` tokens on the fixed
        tensors: the body of the graph for ``k``."""
        b = self._bufs
        cache, d_cache, tokens, done, remaining, emit, count = (
            speculative_chunk_cycle(
                self.params, self.draft_params, self.cfg, self.draft_cfg,
                self._cache, self._d_cache, b.tokens, b.done, b.temps,
                b.remaining, self._gen, k, eos_id=self.eos_id,
                top_k=self.top_k, top_p=self.top_p, shard=self._shard,
                dshard=self._dshard,
            ))
        self._cache.lengths.copy_(cache.lengths)
        self._d_cache.lengths.copy_(d_cache.lengths)
        b.carry(tokens, done, remaining)
        b.record((b.emits[k], emit), (b.counts[k], count))

    def _admit_all(self) -> None:
        """Move queued requests into free slots (rank 0; on a mesh each
        admission is announced first). Prefills are enqueued per request,
        and their first tokens come back in ONE stacked fetch. One
        ``engine.admit`` span; each request's wait in the queue ends at its
        pop, an ``engine.queue`` span from its submission."""
        with spans.span("engine.admit") as admit:
            free = [i for i, r in enumerate(self._slot_req) if r is None]
            with self._cv:
                reqs = [self._queue.popleft()
                        for _ in range(min(len(free), len(self._queue)))]
            if admit:
                popped = time.perf_counter_ns()
                for req in reqs:
                    spans.record("engine.queue",
                                 round(req.submitted_at * 1e9), popped,
                                 rid=req.id)
            admit.set(admitted=len(reqs))
            # speculative mode reserves K+1 positions for the last cycle's
            # write overshoot
            slack = (self.draft_tokens + 1 if self.draft_params is not None
                     else 0)
            occupied = self.slots - len(free)
            admitted = []
            for j, (req, slot) in enumerate(zip(reqs, free)):
                S = len(req.prompt)
                # cap generation to the cache row; the floor of 1 keeps a
                # near-max_len prompt at one prefill token, no decode steps (a
                # one-token budget freezes before any speculative cycle writes)
                req.max_new_tokens = max(1, min(req.max_new_tokens,
                                                self.max_len - S - slack))
                # prime the draft row only when the occupancy after this
                # admission could speculate (the measured policy always may);
                # otherwise regime entry re-primes it
                prime = self._d_cache is not None and (
                    self._measured or self._policy_k(occupied + j + 1) > 0)
                self._announce(_ADMIT, slot, S, _f64_bits(req.temperature),
                               req.max_new_tokens, int(prime),
                               int(j == len(reqs) - 1), tokens=req.prompt)
                admitted.append(self._admit_one(req, slot, prime))
            self._finish_admissions(admitted)

    def _admit_one(self, req: Request, slot: int, prime: bool) -> tuple:
        """Prefill ``req`` into ``slot`` (and its draft row when ``prime``)
        as one ``engine.prefill`` span; returns (req, slot, first token, MoE
        drops), all on the device."""
        S = len(req.prompt)
        padded_len = self._prefill_len(S)
        with spans.span("engine.prefill", rid=req.id, tokens=S,
                        bucket=padded_len):
            padded = np.zeros((1, padded_len), np.int64)
            padded[0, :S] = req.prompt
            padded = torch.from_numpy(padded).to(self.device)
            out = prefill_request(
                self.params, self.cfg, padded, S, req.temperature, self._gen,
                top_k=self.top_k, top_p=self.top_p,
                count_drops=self._count_drops, shard=self._shard,
            )
            first, ks, vs = out[:3]
            # MoE: the drop count rides the same fetch as the first tokens
            drops = out[3] if self._count_drops else None
            insert_rows(self._cache, ks, vs, [slot], [S])
            if self._d_cache is not None:
                if prime:
                    dks, dvs = prefill_cache_only(
                        self.draft_params, self.draft_cfg, padded,
                        shard=self._dshard)
                    insert_rows(self._d_cache, dks, dvs, [slot], [S])
                    self._draft_stale.discard(slot)
                else:
                    self._draft_stale.add(slot)
            return req, slot, first, drops

    def _finish_admissions(self, admitted: list) -> None:
        """One fetch of the admitted rows' first tokens (and MoE drops),
        then their bookkeeping: a row done at its first token finishes,
        the others take their slots."""
        if not admitted:
            return
        fetched = [f for _, _, f, _ in admitted]
        if self._count_drops:
            fetched += [d.to(f.dtype) for (_, _, f, d) in admitted]
        fetched = _fetch(torch.stack(fetched)).numpy()
        firsts = fetched[:len(admitted)]
        self.moe_prefill_dropped_total += int(fetched[len(admitted):].sum())
        now = time.perf_counter()
        for (req, slot, _, _), tok in zip(admitted, firsts):
            tok = int(tok)
            req.first_token_at = now
            with self._cv:  # stats() sorts these concurrently
                self.ttft_samples.append(req.ttft_s)
            req.out.append(tok)
            self.tokens_total += 1
            if len(req.out) >= req.max_new_tokens or (
                self.eos_id >= 0 and tok == self.eos_id
            ):
                req._finish()
                with self._cv:
                    self.latency_samples.append(req.latency_s)
                continue
            req._notify_progress()  # first token is streamable immediately
            self._slot_req[slot] = req
            self._tokens[slot] = tok
            self._temps[slot] = req.temperature
            self._done[slot] = False
            self._remaining[slot] = req.max_new_tokens - 1  # first already out
            self._dirty = True

    def _policy_k(self, n_active: int, flavor: str = "large") -> int:
        """Speculation depth for a chunk at ``n_active`` occupied slots:
        the first rule covering the count decides; none -> 0 (plain).
        ``flavor`` picks the measured policy's arm table."""
        if self._measured:
            return self._bandit_pick(n_active, flavor)
        for max_active, rule_k in self.spec_rules:
            if n_active <= max_active:
                return rule_k
        return 0

    @staticmethod
    def _bandit_bucket(n_active: int) -> int:
        """Occupancy bucket: 1, 2, 3-4, 5-8, 9-16, ... (powers of two)."""
        b = 1
        while b < n_active:
            b *= 2
        return b

    def _bandit_pick(self, n_active: int, flavor: str = "large") -> int:
        """Measured policy: explore under-sampled arms, then exploit the
        best EWMA tokens/s of this (occupancy bucket, chunk flavour) cell,
        re-probing the stalest loser every BANDIT_PROBE_EVERY syncs. Greedy
        outputs are the same on every arm, so exploring changes no emitted
        token."""
        b = (self._bandit_bucket(n_active), flavor)
        with self._cv:  # stats() snapshots the tables under this lock
            rate = self._bandit_rate.setdefault(
                b, {k: None for k in self._variant_ks})
            n = self._bandit_n.setdefault(b, {k: 0 for k in self._variant_ks})
            for k in self._variant_ks:
                if n[k] < self.BANDIT_MIN_SAMPLES:
                    return k
            t = self._bandit_t.get(b, 0) + 1
            self._bandit_t[b] = t
            best = max(rate, key=lambda k: rate[k])
            if t % self.BANDIT_PROBE_EVERY == 0:
                losers = [k for k in self._variant_ks if k != best]
                if losers:
                    return min(losers, key=lambda k: n[k])
            return best

    def _bandit_update(self, n_active: int, k: int, tokens: int, dt: float,
                       flavor: str = "large", cold: bool = False) -> None:
        """Fold one chunk's tokens/s into its (bucket, flavour, arm) EWMA.
        ``cold`` marks the first run of that chunk, whose time holds
        first-launch costs: dropped."""
        if cold or not self._measured or tokens <= 0 or dt <= 0:
            return
        b = (self._bandit_bucket(n_active), flavor)
        r = tokens / dt
        with self._cv:
            rate = self._bandit_rate.setdefault(
                b, {arm: None for arm in self._variant_ks})
            n = self._bandit_n.setdefault(
                b, {arm: 0 for arm in self._variant_ks})
            cur = rate[k]
            rate[k] = (r if cur is None else
                       (1 - self.BANDIT_ALPHA) * cur + self.BANDIT_ALPHA * r)
            n[k] += 1

    def _reprime_draft(self) -> None:
        """Catch stale draft rows up to the target's frontier: the
        admission-time draft prefill re-run over each row's prompt and
        emitted tokens (all but the last, the next input), batched by
        prefill length (:meth:`_prefill_len`): one draft forward and one
        insert per length, over exactly the stale rows of that length.
        Numeric wobble between a prefilled and an incrementally built draft
        row only perturbs proposals, never emitted tokens."""
        by_len: dict[int, list[tuple[int, int, list[int]]]] = {}
        for i in sorted(self._draft_stale):
            req = self._slot_req[i]
            if req is None or self._done[i]:
                continue
            seq = req.prompt + req.out
            t_len = len(seq) - 1
            by_len.setdefault(self._prefill_len(t_len), []).append(
                (i, t_len, seq))
        self._draft_stale.clear()
        for padded_len, rows in by_len.items():
            padded = np.zeros((len(rows), padded_len), np.int64)
            for j, (_, t_len, seq) in enumerate(rows):
                padded[j, :t_len] = seq[:t_len]
            dks, dvs = prefill_cache_only(
                self.draft_params, self.draft_cfg,
                torch.from_numpy(padded).to(self.device), shard=self._dshard)
            insert_rows(self._d_cache, dks, dvs, [i for i, _, _ in rows],
                        [t_len for _, t_len, _ in rows])

    def _decode_cycle(self) -> None:
        """One chunk of decode steps or speculative cycles, then host-side
        bookkeeping. The device carries tokens/done/remaining between
        chunks; the host mirrors go up only when admission or eviction
        changed them, and the chunk's tokens come back in one fetch. Rank 0
        decides the chunk (and on a mesh announces it), :meth:`_run_chunk`
        runs it."""
        # Chunk policy: an oversized chunk is harmless to correctness (rows
        # freeze on device), so the only reason to run a small one is
        # admission latency: a finished row is refilled only at a sync.
        with self._cv:
            queued = bool(self._queue)
        flavor = "small" if queued else "large"
        # the policy decides per sync, from the live occupancy, so a
        # request can cross regimes mid-stream
        n_active = sum(r is not None for r in self._slot_req)
        k = self._policy_k(n_active, flavor)
        # no row owes more than this many tokens, and a step or cycle emits
        # at least one a row, so later ones would only recompute frozen rows
        owed = int(self._remaining[~self._done].max(initial=1))
        n_units = min(self.chunk_steps if queued else self.chunk_steps_max,
                      owed)
        if k > 0 and self._draft_stale:
            self._announce(_REPRIME)
            self._reprime_draft()
        self._announce(_CHUNK, k, n_units, int(queued), n_active)
        self._run_chunk(k, n_units, flavor, n_active)

    def _run_chunk(self, k: int, n_units: int, flavor: str,
                   n_active: int) -> None:
        """Run ``n_units`` units of kind ``k`` (0: plain steps) and replay
        their tokens into the requests, as one ``engine.chunk`` span: the
        same on every rank."""
        with spans.span("engine.chunk", k=k, units=n_units, slots=self.slots,
                        active=n_active) as chunk:
            bufs = self._bufs
            if self._dirty:
                bufs.upload(self._tokens, self._temps, self._done,
                            self._remaining)
                self._dirty = False
            # timed after the re-prime: the bandit estimates each arm's steady
            # rate, and a switch-only re-prime would sink the speculative arm
            t_chunk = time.perf_counter()
            cold = (k, flavor) not in self._chunk_seen
            self._chunk_seen.add((k, flavor))
            bufs.start()
            unit = self._units[k]
            for _ in range(n_units):
                unit()
            self.units_run[k] += n_units
            if k > 0:
                # emits [n_cycles, SLOTS, K+1] and counts [n_cycles, SLOTS] in
                # the one host sync
                emits = bufs.emits[k][:n_units]
                counts = bufs.counts[k][:n_units]
                host = torch.cat([emits.flatten(), counts.flatten().long()])
                host = _fetch(host).numpy()
                emits = host[:emits.numel()].reshape(emits.shape)
                counts = host[emits.size:].reshape(counts.shape)
                self.spec_cycles_total += int((counts > 0).sum())
                self.spec_cycle_tokens_total += int(counts.sum())

                def row_tokens(i):
                    return [int(t) for c in range(emits.shape[0])
                            for t in emits[c, i, :counts[c, i]]]
            else:
                # [n_steps, SLOTS]; the one host sync
                toks = _fetch(bufs.toks[:n_units]).numpy()
                if self.spec_rules:
                    # the target moved on and the draft did not
                    self._draft_stale.update(
                        i for i, r in enumerate(self._slot_req)
                        if r is not None)

                def row_tokens(i):
                    return [int(t) for t in toks[:, i]]
            now = time.perf_counter()
            toks_before = self.tokens_total
            # every row's carried token (frozen rows hold theirs)
            for i in range(self.slots):
                rt = row_tokens(i)
                if rt:
                    self._tokens[i] = rt[-1]
            for i, req in enumerate(self._slot_req):
                if req is None:
                    continue
                # replay the device's freeze logic to pick the real tokens
                for tok in row_tokens(i):
                    if self._done[i]:
                        break
                    req.out.append(tok)
                    self.tokens_total += 1
                    self._remaining[i] -= 1
                    if self._remaining[i] <= 0 or (
                        self.eos_id >= 0 and tok == self.eos_id
                    ):
                        self._done[i] = True
                if self._done[i]:
                    req.done_at = now
                    req._finish()
                    with self._cv:  # stats() sorts these concurrently
                        self.latency_samples.append(req.latency_s)
                    self._slot_req[i] = None
                    self._temps[i] = 0.0
                    # evicted: nothing to re-prime
                    self._draft_stale.discard(i)
                else:
                    req._notify_progress()
            emitted = self.tokens_total - toks_before
            chunk.set(emitted=emitted)
            dt = now - t_chunk
            self._bandit_update(n_active, k, emitted, dt, flavor=flavor,
                                cold=cold)
            if not cold and emitted > 0 and dt > 0:
                rate = emitted / dt
                with self._cv:  # metrics()/stats() read concurrently
                    cur = self.tok_s_ewma
                    self.tok_s_ewma = (
                        rate if cur is None
                        else (1 - self.BANDIT_ALPHA) * cur
                        + self.BANDIT_ALPHA * rate
                    )

    def _loop(self) -> None:
        with torch.inference_mode():
            try:
                self._warm_up()
            except Exception as e:  # no request can be served: stop
                log.exception("engine warm-up failed")
                self._warm_error = e
                with self._cv:
                    self._stop = True
            finally:
                self._warm.set()
            self._serve()

    def _serve(self) -> None:
        if not self.leader:
            self._follow()
            return
        while True:
            with self._cv:
                beat = True
                while (
                    not self._stop
                    and not self._queue
                    and all(r is None for r in self._slot_req)
                    and beat
                ):
                    beat = self._cv.wait(
                        self.HEARTBEAT_S if self.mesh is not None else None)
                stop = self._stop
                if stop:
                    for r in self._slot_req:
                        if r is not None:
                            r._finish("engine stopped")
                    for r in self._queue:
                        r._finish("engine stopped")
                    self._queue.clear()
            if stop:
                self._announce(_STOP)
                return
            if not beat:  # idle on a mesh: keep the followers' wait short
                self._announce(_NOOP)
                continue
            try:
                # continuous batching: fill every free slot, then run one
                # decode chunk for the active rows
                self._admit_all()
                if any(r is not None for r in self._slot_req):
                    self._decode_cycle()
            except Exception as e:  # fail requests, keep the engine alive
                log.exception("engine cycle failed")
                self._fail_rows(e)
                self._announce(_RESET)

    def _fail_rows(self, error) -> None:
        for i, r in enumerate(self._slot_req):
            if r is not None:
                r._finish(f"engine error: {error}")
                self._slot_req[i] = None
                self._done[i] = True
                self._temps[i] = 0.0
        self._dirty = True

    # -- the mesh's leader and followers ------------------------------------
    def _announce(self, kind: int, *fields: int, tokens=()) -> None:
        """Rank 0: broadcast the descriptor of the unit it is about to run
        (nothing without a mesh). Every rank's loop runs the unit next."""
        if self.mesh is None:
            return
        d = np.zeros(self._desc.shape, np.int64)
        d[0] = kind
        d[1:1 + len(fields)] = fields
        d[_HEADER - 1] = self._seq
        d[_HEADER:_HEADER + len(tokens)] = tokens
        self._desc.copy_(torch.from_numpy(d))
        dist.broadcast(self._desc, src=0)
        self._seq += 1

    def _receive(self) -> np.ndarray:
        dist.broadcast(self._desc, src=0)
        d = self._desc.cpu().numpy()
        if d[_HEADER - 1] != self._seq:
            raise RuntimeError(f"descriptor {d[_HEADER - 1]} from rank 0, "
                               f"expected {self._seq}")
        self._seq += 1
        return d

    def _follow(self) -> None:
        """A follower's loop: run each unit rank 0 announces, on this
        rank's shards, until the stop."""
        admitted = []
        while True:
            d = self._receive()
            kind = int(d[0])
            if kind == _STOP:
                break
            try:
                if kind == _ADMIT:
                    slot, S, temp, budget, prime, last = (int(x)
                                                          for x in d[1:7])
                    req = Request([int(t) for t in d[_HEADER:_HEADER + S]],
                                  budget, _bits_f64(temp))
                    self.followed.append(req)
                    self.requests_total += 1
                    admitted.append(self._admit_one(req, slot, bool(prime)))
                    if last:
                        with spans.span("engine.admit",
                                        admitted=len(admitted)):
                            self._finish_admissions(admitted)
                        admitted = []
                elif kind == _REPRIME:
                    self._reprime_draft()
                elif kind == _CHUNK:
                    k, n_units, queued, n_active = (int(x) for x in d[1:5])
                    self._run_chunk(k, n_units,
                                    "small" if queued else "large", n_active)
                elif kind == _RESET:
                    self._fail_rows("rank 0's cycle failed")
            except Exception as e:  # the leader's reset keeps rows in step
                log.exception("engine cycle failed")
                self._fail_rows(e)
        for r in self._slot_req:
            if r is not None:
                r._finish("engine stopped")
