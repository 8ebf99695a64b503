"""Mistral-7B (and any Llama-shaped decoder) as published: token embedding,
``num_hidden_layers`` pre-norm blocks of grouped-query attention with
rotary embeddings and a SwiGLU MLP, a final RMSNorm and an untied head.
No sliding window (the v0.3 config has none).

:func:`logits` is the serving check's forward: one sequence, teacher
forced, float32, one layer's weights cast from the harness's tensors at a
time, so it fits beside whatever else the card holds. :func:`loss` is the
training check's: the mean next-token cross entropy over float32 leaves,
each layer under a checkpoint. Departure: none in the mathematics; the
weights are the bfloat16 values the program is given, read as float32.
"""

from __future__ import annotations

from functools import partial

import torch

from gpubench.reference.common import (Numerics, attention, next_token_loss,
                                       rms_norm, swiglu, window_logits)


def _layer(layer: dict, x, positions, *, conf: dict, num: Numerics):
    eps = conf["rms_norm_eps"]
    x = x + attention(layer["attn"], rms_norm(x, layer["attn_norm"], eps),
                      conf, positions, num)
    mlp = layer["mlp"]
    x = x + swiglu(rms_norm(x, layer["mlp_norm"], eps), mlp["w_gate"],
                   mlp["w_up"], mlp["w_down"], num)
    return x, None


def logits(weights: dict, conf: dict, tokens: list[int], wanted: range,
           num: Numerics | None = None) -> torch.Tensor:
    """Float32 logits [len(wanted), vocab] at positions ``wanted`` of the
    sequence ``tokens`` (position p predicts token p + 1)."""
    num = num or Numerics()
    return window_logits(weights, conf, tokens, wanted,
                         partial(_layer, conf=conf, num=num), num)


def loss(params: dict, conf: dict, tokens: torch.Tensor,
         num: Numerics | None = None) -> torch.Tensor:
    """Mean next-token cross entropy of tokens[:, 1:] given tokens[:, :-1];
    ``params`` float32 leaves."""
    num = num or Numerics()
    return next_token_loss(params, conf, tokens,
                           partial(_layer, conf=conf, num=num), num)[0]
