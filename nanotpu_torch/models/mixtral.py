"""Mixtral-style sparse MoE decoder in PyTorch: the port of
``nanotpu/models/mixtral.py`` over the same parameter tree.

The Llama block with its SwiGLU MLP replaced by a top-k-routed mixture of
SwiGLU experts. Routing is nanotpu's Switch-style dense dispatch and
combine: one-hot ``[T, E, C]`` tensors and batched einsums with a capacity
``C`` from static shapes, no gather, no scatter and no data-dependent
shape, so a decode step that routes stays capturable as a CUDA graph.
Experts are stacked on a leading ``E`` axis (``w_gate``/``w_up``
``[E, dim, ffn]``, ``w_down`` ``[E, ffn, dim]``); the ``router`` is f32.

On a mesh the functions take ``shard``
(:class:`nanotpu_torch.parallel.mesh.Shards`), as Llama's do, and run on
this rank's shards: its rows and sequence block of the tokens, weights
gathered over fsdp at use, attention's heads and each expert's ffn split
over tp, and E/ep experts a rank. Routing binds capacity over the global
token set, as nanotpu's one program does (and as its ``seq_axis`` branch
does by hand): the [T, E] router logits are gathered over the axes that
split the tokens, every rank decides on the whole, expands the [T, E, C]
dispatch and combine for its own tokens only, and the expert inputs sum
over those axes. Over ep each rank expands and dispatches to its own
experts only, and the combine's partial sums are all-reduced.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from nanotpu_torch import resolve_device
from nanotpu_torch.models.llama import (
    LlamaConfig,
    attention,
    embed_lookup,
    linear,
    next_token_nll,
    rms_norm,
    rope_freqs,
)
from nanotpu_torch.models.quant import QArray, dequantize


def _w(w, dtype):
    """An expert stack as the einsums consume it: a quantized one
    (per-expert scales, :mod:`nanotpu_torch.models.quant`) dequantized to
    ``dtype``."""
    if isinstance(w, QArray):
        return dequantize(w, dtype)
    return w


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32_000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    max_seq_len: int = 8192
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    attn_impl: str = "dense"
    router_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def as_llama(self) -> LlamaConfig:
        """The attention-relevant view, for the Llama blocks."""
        return LlamaConfig(
            vocab_size=self.vocab_size, dim=self.dim, n_layers=self.n_layers,
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            ffn_dim=self.ffn_dim, max_seq_len=self.max_seq_len,
            rope_theta=self.rope_theta, norm_eps=self.norm_eps,
            dtype=self.dtype, attn_impl=self.attn_impl,
        )

    @staticmethod
    def mixtral_8x7b() -> "MixtralConfig":
        return MixtralConfig()

    @staticmethod
    def tiny(vocab: int = 256) -> "MixtralConfig":
        return MixtralConfig(
            vocab_size=vocab, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=96, n_experts=4, top_k=2, max_seq_len=256,
            dtype="float32",
        )


def init_params(cfg: MixtralConfig, generator: torch.Generator,
                device=None) -> dict:
    """nanotpu's tree and scales: truncated normals over the fan-in (axis
    -2), scaled residual projections, the router drawn at scale 0.02 in the
    model's dtype and kept in f32, the norm gains f32 ones. Draws from
    ``generator`` on its device, then places the tree on ``device``
    (``cuda`` by default)."""
    device = resolve_device(device)
    dt = cfg.torch_dtype
    hd = cfg.head_dim
    E = cfg.n_experts

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        w = torch.empty(shape, dtype=torch.float32, device=generator.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0,
                                    generator=generator)
        return (w * scale).to(device=device, dtype=dt)

    def ones():
        return torch.ones((cfg.dim,), dtype=torch.float32, device=device)

    embed = dense((cfg.vocab_size, cfg.dim), scale=0.02)
    resid = 1.0 / math.sqrt(2 * cfg.n_layers)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn": {
                "wq": dense((cfg.dim, cfg.n_heads * hd)),
                "wk": dense((cfg.dim, cfg.n_kv_heads * hd)),
                "wv": dense((cfg.dim, cfg.n_kv_heads * hd)),
                "wo": dense((cfg.n_heads * hd, cfg.dim),
                            scale=resid / math.sqrt(cfg.dim)),
            },
            "moe": {
                "router": dense((cfg.dim, E), scale=0.02).float(),
                "w_gate": dense((E, cfg.dim, cfg.ffn_dim)),
                "w_up": dense((E, cfg.dim, cfg.ffn_dim)),
                "w_down": dense((E, cfg.ffn_dim, cfg.dim),
                                scale=resid / math.sqrt(cfg.ffn_dim)),
            },
            "attn_norm": ones(),
            "moe_norm": ones(),
        })
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": ones(),
        "lm_head": dense((cfg.dim, cfg.vocab_size)),
    }


def _onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes, by comparison with an
    arange: no host sync, so it stays inside a CUDA graph."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def route_decisions(logits: torch.Tensor, cfg: MixtralConfig,
                    capacity: int | None = None):
    """The ``[T, E]``-sized half of top-k routing: which experts each token
    picked, the capacity slot it won (or lost) and its renormalized combine
    weight, without the ``[T, E, C]`` expansion.

    Returns (choices, aux, C) with ``choices`` a length-k list of (onehot
    [T, E] f32, pos [T] int32, keep [T] bool, weight [T] f32). Tokens win
    capacity slots in token order, earlier first; ``capacity`` overrides
    ``C = ceil(capacity_factor * T * k / E)``."""
    T, E = logits.shape
    k = cfg.top_k
    if capacity is not None:
        C = max(1, capacity)
    else:
        C = max(1, int(math.ceil(cfg.capacity_factor * T * k / E)))
    probs = torch.softmax(logits, dim=-1)  # [T, E]

    # aux load-balancing loss (Switch eq. 4): E * sum_e f_e * p_e
    f = _onehot(torch.argmax(probs, dim=-1), E).mean(dim=0)
    p = probs.mean(dim=0)
    aux = E * (f * p).sum()

    # argmax takes the first maximum, as jnp.argmax does; the chosen expert
    # is masked by a product, not -inf, so ties break the same way
    masked = probs
    topk_weights, topk_onehots = [], []
    for _ in range(k):
        onehot = _onehot(torch.argmax(masked, dim=-1), E)
        topk_weights.append((probs * onehot).sum(dim=-1))
        topk_onehots.append(onehot)
        masked = masked * (1.0 - onehot)

    # renormalize the k weights per token (Mixtral renormalizes over top-k)
    wsum = sum(topk_weights)
    fill = torch.zeros((E,), dtype=torch.int32, device=logits.device)
    choices = []
    for onehot, w in zip(topk_onehots, topk_weights):
        weight = w / torch.clamp(wsum, min=1e-9)
        # each token's position in its chosen expert's buffer, after the
        # slots the earlier choices filled
        pos_in_expert = (torch.cumsum(onehot, dim=0) - 1.0) + fill[None, :]
        pos = (pos_in_expert * onehot).sum(dim=-1).to(torch.int32)
        keep = (pos < C) & (onehot.amax(dim=-1) > 0)
        choices.append((onehot, pos, keep, weight))
        fill = fill + (onehot * keep[:, None]).sum(dim=0).to(torch.int32)
    return choices, aux, C


def expand_routing(choices, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(dispatch [T, E, C], combine [T, E, C]), both f32, from routing
    decisions: the memory-heavy expansion."""
    dispatch = combine = None
    for onehot, pos, keep, weight in choices:
        pos_oh = _onehot(torch.where(keep, pos, 0), C)
        contrib = onehot[:, :, None] * pos_oh[:, None, :] * keep[:, None, None]
        dispatch = contrib if dispatch is None else dispatch + contrib
        wc = contrib * weight[:, None, None]
        combine = wc if combine is None else combine + wc
    return dispatch, combine


def route_topk(logits: torch.Tensor, cfg: MixtralConfig,
               capacity: int | None = None):
    """Top-k routing with capacity: logits [T, E] f32 -> (dispatch
    [T, E, C], combine [T, E, C] f32, aux loss). Tokens past an expert's
    capacity are dropped: their combine weights are 0 and the residual
    stream passes them through."""
    choices, aux, C = route_decisions(logits, cfg, capacity)
    dispatch, combine = expand_routing(choices, C)
    return dispatch, combine, aux


def _decide(logits: torch.Tensor, B: int, S: int, cfg: MixtralConfig,
            full_capacity: bool, shard=None):
    """(choices, aux, C) of :func:`route_decisions` for this rank's T = B*S
    tokens, from their router ``logits`` [T, E]. With a ``shard`` whose
    tokens are split, the decisions are taken on the global token set (the
    logits gathered, capacity from its size, slots won in its order) and
    this rank's rows of them returned."""
    if shard is None or not shard.split_tokens:
        T = B * S
        return route_decisions(
            logits, cfg, capacity=T * cfg.top_k if full_capacity else None)
    whole = shard.all_tokens(logits.reshape(B, S, -1))
    T = whole.shape[0] * whole.shape[1]
    choices, aux, C = route_decisions(
        whole.reshape(T, -1), cfg,
        capacity=T * cfg.top_k if full_capacity else None)
    mine = [tuple(shard.own_tokens(part, B, S) for part in choice)
            for choice in choices]
    return mine, aux, C


def moe_block(params: dict, x: torch.Tensor, cfg: MixtralConfig,
              full_capacity: bool = False, drop_acc: list | None = None,
              shard=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], aux loss): dense dispatch and combine
    einsums around the experts' SwiGLU, batched over E.

    ``full_capacity`` sets C = T * top_k, so no token is dropped and each
    row routes independently of its batch-mates: the decode paths use it.
    ``drop_acc`` is a list the block appends each token's dropped choices
    to ([T] int32: top_k less its kept choices), so that serving prefill
    can leave the pad positions out of its count.

    With ``shard``, ``x`` holds this rank's tokens and ``params`` its
    experts (E/ep of them, each at ffn/tp): routing is global over the
    tokens (:func:`_decide`), the aux loss the whole batch's on every
    rank; the dispatch and combine are expanded for this rank's experts
    only ([T, E/ep, C]), the expert inputs sum over the axes that split
    the tokens, the SwiGLU is the Megatron pair over tp, and the
    combine's output is all-reduced over ep. Each choice's combine weight
    ([T]) enters through the ep copy, so that its gradient, and the
    router's, sums every ep rank's experts' share."""
    B, S, D = x.shape
    T = B * S
    flat = x.reshape(T, D)
    logits = flat.float() @ params["router"]  # [T, E]
    choices, aux, C = _decide(logits, B, S, cfg, full_capacity, shard)
    if drop_acc is not None:
        kept = sum(keep.to(torch.int32) for _, _, keep, _ in choices)
        drop_acc.append(cfg.top_k - kept)
    if shard is not None:
        mine = shard.experts(cfg.n_experts)
        choices = [(onehot[:, mine], pos, keep, shard.ep_in(weight))
                   for onehot, pos, keep, weight in choices]
        flat = shard.ep_in(flat)
    dispatch, combine = expand_routing(choices, C)
    dt = x.dtype
    # tokens into per-expert buffers: [E, C, D]
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt), flat)
    if shard is not None:
        expert_in = shard.tp_in(shard.sum_tokens(expert_in))
    gate = F.silu(torch.einsum("ecd,edf->ecf", expert_in,
                               _w(params["w_gate"], dt)))
    up = torch.einsum("ecd,edf->ecf", expert_in, _w(params["w_up"], dt))
    expert_out = torch.einsum("ecf,efd->ecd", gate * up,
                              _w(params["w_down"], dt))
    if shard is not None:
        expert_out = shard.tp_out(expert_out)
    # back to the tokens with their routing weights: [T, D]
    out = torch.einsum("tec,ecd->td", combine.to(dt), expert_out)
    if shard is not None:
        out = shard.ep_out(out)
    return out.reshape(B, S, D), aux


def decoder_layer(layer: dict, x: torch.Tensor, cfg: MixtralConfig,
                  cos: torch.Tensor, sin: torch.Tensor, shard=None):
    """Attention residual, then routed-experts residual; returns (x, this
    layer's router aux loss). ``shard``: on this rank's shards (the
    layer's weights gathered over fsdp already)."""
    x = x + attention(layer["attn"],
                      rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                      cfg.as_llama(), cos, sin, shard)
    moe_out, aux = moe_block(
        layer["moe"], rms_norm(x, layer["moe_norm"], cfg.norm_eps), cfg,
        shard=shard)
    return x + moe_out, aux


def hidden_states(params: dict, tokens: torch.Tensor, cfg: MixtralConfig,
                  positions: torch.Tensor | None = None, shard=None):
    """tokens [B, S] int -> (final-norm hidden states [B, S, D], total aux
    loss). With ``shard``, tokens are this rank's rows and sequence block
    over sp, at positions from ``rank * S``, and the aux loss is the global
    batch's."""
    S = tokens.shape[1]
    if positions is None:
        start = 0 if shard is None else shard.rank["sp"] * S
        positions = torch.arange(start, start + S, dtype=torch.int32,
                                 device=tokens.device)
    cos, sin = rope_freqs(cfg.as_llama(), positions)
    if shard is None:
        x = embed_lookup(params["embed"], tokens, cfg.torch_dtype)
    else:
        x = shard.embed(shard.use(params["embed"], shard.specs["embed"]),
                        tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params["layers"]):
        if shard is not None:  # ZeRO-3: each layer's weights gathered here
            layer = shard.use(layer, shard.specs["layers"][i])
        x, aux = decoder_layer(layer, x, cfg, cos, sin, shard)
        aux_total = aux_total + aux
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux_total


def forward(params: dict, tokens: torch.Tensor, cfg: MixtralConfig,
            positions: torch.Tensor | None = None):
    """tokens [B, S] -> (logits [B, S, V] f32, total aux loss)."""
    x, aux = hidden_states(params, tokens, cfg, positions)
    return linear(x, params["lm_head"]).float(), aux


def loss_fn(params: dict, tokens: torch.Tensor, cfg: MixtralConfig,
            shard=None) -> torch.Tensor:
    """Mean next-token NLL over tokens[:, :-1] -> tokens[:, 1:] plus
    ``router_aux_weight`` times the summed aux loss. The NLL is the Llama
    loss's chunked cross entropy: nanotpu's value, without the whole
    [B, S, V] f32 logits. With ``shard`` (the mesh step's), ``tokens`` are
    this rank's rows, each rank takes its sequence block over sp, and the
    result is its share of the global loss, which sums over the data axes
    to the whole: the aux loss, the whole batch's on every rank, counts
    once a data shard's share."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if shard is not None:
        inputs, targets = shard.seq_block(inputs), shard.seq_block(targets)
    x, aux = hidden_states(params, inputs, cfg, shard=shard)
    nll = next_token_nll(params["lm_head"], x, targets, shard)
    if shard is not None:
        aux = aux / shard.token_shards()
    return nll + cfg.router_aux_weight * aux
