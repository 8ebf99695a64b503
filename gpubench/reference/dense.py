"""Mistral-7B (and any Llama-shaped decoder) as published: token embedding,
``num_hidden_layers`` pre-norm blocks of grouped-query attention with
rotary embeddings and a SwiGLU MLP, a final RMSNorm and an untied head.
No sliding window (the v0.3 config has none).

:func:`logits` is the serving check's forward: one sequence, teacher
forced, float32, one layer's weights cast from the harness's tensors at a
time, so it fits beside whatever else the card holds. Departure: none in
the mathematics; the weights are the bfloat16 values the program is
given, read as float32.
"""

from __future__ import annotations

import torch

from gpubench.reference.common import Numerics, attention, rms_norm, swiglu


@torch.no_grad()
def logits(weights: dict, conf: dict, tokens: list[int], wanted: range,
           num: Numerics | None = None) -> torch.Tensor:
    """Float32 logits [len(wanted), vocab] at positions ``wanted`` of the
    sequence ``tokens`` (position p predicts token p + 1)."""
    num = num or Numerics()
    eps = conf["rms_norm_eps"]
    device = weights["embed"].device
    ids = torch.tensor(tokens, dtype=torch.long, device=device)
    positions = torch.arange(len(tokens), device=device)
    x = weights["embed"][ids].float()[None]
    for layer in weights["layers"]:
        attn = {k: w.float() for k, w in layer["attn"].items()}
        x = x + attention(attn, rms_norm(x, layer["attn_norm"], eps), conf,
                          positions, num)
        del attn
        mlp = {k: w.float() for k, w in layer["mlp"].items()}
        x = x + swiglu(rms_norm(x, layer["mlp_norm"], eps), mlp["w_gate"],
                       mlp["w_up"], mlp["w_down"], num)
        del mlp
    x = rms_norm(x[0, wanted.start:wanted.stop], weights["final_norm"], eps)
    return num.mm(x, weights["lm_head"])
