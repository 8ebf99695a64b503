"""Mixtral-8x7B as published (the Mistral block with its MLP replaced by
a top-2 mixture of 8 SwiGLU experts, the two routing weights renormalised
to sum to one): its serving forward and its training loss.

:func:`logits`, the serving check's forward, is always the published,
dropless model: every token keeps both choices (the capacity is the
sequence's length). It runs one sequence, teacher forced, in float32, one
layer's weights cast from the harness's tensors at a time, so that it fits
beside a served bfloat16 tree. A capacity in a configuration's
``assumed`` is a departure of the training loss only: a served
configuration that states one is held to the published model, and the
choices the program drops show as a gap.

:func:`loss` departs from the published model as the configuration's
``assumed`` says:

* Capacity. It routes at Switch capacity C = ceil(capacity_factor * T *
  top_k / E) over the step's T tokens. Tokens win an expert's slots in
  token order, every token's first choice before any second choice; a
  choice that finds its expert full contributes nothing (its weight is
  not renormalised away).
* The loss adds ``router_aux_loss_coef`` times each layer's Switch
  load-balancing loss, E * sum_e f_e * p_e, with f_e the share of tokens
  whose first choice is e and p_e the mean router probability of e.

The experts run on the rows routed to them (a gather, one SwiGLU an
expert, an ``index_add`` back), in float32; the loss runs each layer
under a checkpoint so that only one layer's activations live at a time.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from gpubench.reference.common import (Numerics, attention, next_token_loss,
                                       rms_norm, swiglu, window_logits)


def route(probs: torch.Tensor, top_k: int, capacity: int):
    """(expert [k, T], weight [k, T], kept [k, T]) of every token's choices:
    the k largest probabilities (ties to the lower expert id), their
    weights renormalised over the k, and whether each won a slot."""
    T, E = probs.shape
    picks, masked = [], probs.detach().clone()
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)
        picks.append(idx)
        masked.scatter_(1, idx[:, None], -1.0)
    expert = torch.stack(picks)  # [k, T]
    chosen = probs.gather(1, expert.T).T  # [k, T], differentiable
    weight = chosen / chosen.sum(dim=0, keepdim=True)
    kept, fill = [], torch.zeros(E, dtype=torch.long, device=probs.device)
    for j in range(top_k):
        onehot = F.one_hot(expert[j], E)
        pos = (torch.cumsum(onehot, dim=0) - 1 + fill[None, :]).gather(
            1, expert[j][:, None])[:, 0]
        keep = pos < capacity
        kept.append(keep)
        fill = fill + (onehot * keep[:, None]).sum(dim=0)
    return expert, weight, torch.stack(kept)


def moe(block: dict, h: torch.Tensor, conf: dict,
        capacity_factor: float | None, num: Numerics):
    """(out [T, D], aux loss) of the expert layer on normed h [T, D]; a
    ``capacity_factor`` of None keeps every choice."""
    T, D = h.shape
    E, k = conf["num_local_experts"], conf["num_experts_per_tok"]
    probs = torch.softmax(num.mm(h, block["router"]), dim=-1)
    capacity = (T if capacity_factor is None
                else max(1, math.ceil(capacity_factor * T * k / E)))
    expert, weight, kept = route(probs, k, capacity)
    first = F.one_hot(expert[0], E).float().mean(dim=0)
    aux = E * (first * probs.mean(dim=0)).sum()
    out = torch.zeros_like(h)
    for e in range(E):
        rows, w = [], []
        for j in range(k):
            sel = torch.nonzero((expert[j] == e) & kept[j])[:, 0]
            rows.append(sel)
            w.append(weight[j, sel])
        rows, w = torch.cat(rows), torch.cat(w)
        y = swiglu(h[rows], block["w_gate"][e], block["w_up"][e],
                   block["w_down"][e], num)
        out = out.index_add(0, rows, y * w[:, None])
    return out, aux


def _layer(layer: dict, x, positions, *, conf: dict,
           capacity_factor: float | None, num: Numerics):
    eps = conf["rms_norm_eps"]
    x = x + attention(layer["attn"], rms_norm(x, layer["attn_norm"], eps),
                      conf, positions, num)
    B, S, D = x.shape
    out, aux = moe(layer["moe"], rms_norm(x, layer["moe_norm"], eps)
                   .reshape(B * S, D), conf, capacity_factor, num)
    return x + out.view(B, S, D), aux


def logits(weights: dict, conf: dict, tokens: list[int], wanted: range,
           num: Numerics | None = None) -> torch.Tensor:
    """Float32 logits [len(wanted), vocab] at positions ``wanted`` of the
    sequence ``tokens`` (position p predicts token p + 1), no choice
    dropped."""
    num = num or Numerics()
    block = partial(_layer, conf=conf, capacity_factor=None, num=num)
    return window_logits(weights, conf, tokens, wanted, block, num)


def loss(params: dict, conf: dict, tokens: torch.Tensor,
         capacity_factor: float, num: Numerics | None = None) -> torch.Tensor:
    """Mean next-token cross entropy of tokens[:, 1:] given tokens[:, :-1],
    plus the weighted load-balancing loss; ``params`` float32 leaves."""
    num = num or Numerics()
    block = partial(_layer, conf=conf, capacity_factor=capacity_factor,
                    num=num)
    nll, auxes = next_token_loss(params, conf, tokens, block, num)
    aux = sum(auxes, torch.zeros((), device=tokens.device))
    return nll + conf["router_aux_loss_coef"] * aux
