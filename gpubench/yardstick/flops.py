"""Operations and bytes of the work a cell asks for, from shapes alone, and
the published peaks of one NVIDIA H100 that they are held against.

The model FLOPs are those of the mathematics, not of the program's way of
doing it: 2 per multiply-add of every matmul weight a token uses (the
experts it is routed to, not the capacity slots the program fills), plus
attention's two products over the positions each query sees, and nothing
recomputed. The flash kernels' bounds are those of ``chip_smoke.py``
(``attention_bound_ms``, ``bwd_bound_ms``), copied here: each input byte
read once and each output byte written once at the HBM rate, or the
products the call needs at the bf16 peak, whichever is longer.
"""

from __future__ import annotations

import dataclasses

#: NVIDIA's H100 SXM data sheet, dense (no sparsity), at a 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


@dataclasses.dataclass(frozen=True)
class Shape:
    layers: int
    dim: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    vocab: int
    experts: int = 0
    top_k: int = 0

    @staticmethod
    def of(conf: dict) -> "Shape":
        """From a configuration file's published keys."""
        heads = conf["num_attention_heads"]
        return Shape(
            layers=conf["num_hidden_layers"], dim=conf["hidden_size"],
            heads=heads, kv_heads=conf["num_key_value_heads"],
            head_dim=conf.get("head_dim") or conf["hidden_size"] // heads,
            ffn=conf["intermediate_size"], vocab=conf["vocab_size"],
            experts=conf.get("num_local_experts", 0),
            top_k=conf.get("num_experts_per_tok", 0))

    def active_params(self) -> int:
        """Matmul weights one token multiplies: attention's projections,
        its experts (or the dense MLP) and the router in every layer, and
        the output head. The embedding is a lookup."""
        attn = self.dim * self.head_dim * (2 * self.heads + 2 * self.kv_heads)
        mlp = 3 * self.dim * self.ffn
        if self.experts:
            per_layer = attn + self.top_k * mlp + self.dim * self.experts
        else:
            per_layer = attn + mlp
        return self.layers * per_layer + self.dim * self.vocab

    def attention_flops(self, keys: float) -> float:
        """Forward FLOPs of one query token over ``keys`` positions, in all
        layers: q.k and p.v, 2*head_dim each per key and head."""
        return 4.0 * self.heads * self.head_dim * self.layers * keys


def forward_flops(shape: Shape, tokens: float, keys: float) -> float:
    """Forward FLOPs of ``tokens`` query tokens that together attend
    ``keys`` positions (a prefill of S tokens: S(S+1)/2; a decoded token
    at context c: c+1)."""
    return 2.0 * shape.active_params() * tokens + shape.attention_flops(keys)


def train_flops(shape: Shape, batch: int, seq: int) -> float:
    """FLOPs of one training step on ``batch`` rows of ``seq`` tokens:
    forward and backward (twice the forward), no recompute."""
    return 3.0 * forward_flops(shape, batch * seq,
                               batch * seq * (seq + 1) / 2)


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def flash_fwd_bound_s(B: int, S: int, H: int, KV: int, D: int,
                      lse: bool = False, esize: int = 2) -> float:
    """Least seconds of a causal forward call: q, k, v read and o (and the
    f32 lse) written once, or its 2 products over the causal pairs."""
    nbytes = esize * B * S * D * (2 * H + 2 * KV) + (4 * B * H * S if lse else 0)
    flops = 4 * D * causal_pairs(S) * B * H
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)


def flash_bwd_bound_s(B: int, S: int, H: int, KV: int, D: int,
                      products: int = 5, outputs: str = "q kv") -> float:
    """Least seconds of a causal bf16 backward call: q, k, v, dO (bf16),
    lse and D (f32) read once and its outputs (``q`` for dq, ``kv`` for dk
    and dv) written once, or ``products`` products over the causal pairs.
    The fused kernel makes 5 (s = q k^T again, dp, dv, dk, dq)."""
    nbytes = 2 * B * S * D * (2 * H + 2 * KV) + 2 * 4 * B * H * S
    nbytes += 2 * B * S * D * (H * ("q" in outputs) + 2 * KV * ("kv" in outputs))
    flops = products * 2 * D * causal_pairs(S) * B * H
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)
