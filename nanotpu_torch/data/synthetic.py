"""Structured synthetic corpus, generated on the device: the port of
``nanotpu/data/synthetic.py``.

A first-order Markov chain over the model's own vocabulary. Each token has
``n_succ`` fixed successor tokens (a ``[V, n_succ]`` table drawn once from
a seed with numpy, so the port's table is nanotpu's, element for element)
with fixed logits, e.g. ``[2, 1, 0, -1]`` -> probabilities
``[0.64, 0.24, 0.09, 0.03]`` and a per-token entropy of ~0.95 nats
(:func:`ideal_ce`, the cross entropy a trained model approaches), against
ln(V) for uniform noise. Batches are sampled on the device from an explicit
``torch.Generator``: the sampled tokens differ from nanotpu's (another
random stream), their distribution does not.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nanotpu_torch import resolve_device

#: successor logits: ~0.95 nats/token of irreducible entropy
DEFAULT_SUCC_LOGITS = (2.0, 1.0, 0.0, -1.0)


def markov_table(vocab_size: int, n_succ: int = len(DEFAULT_SUCC_LOGITS),
                 seed: int = 0, device=None) -> torch.Tensor:
    """The corpus definition: ``[V, n_succ]`` int64 successor ids drawn
    once from ``seed`` by numpy (nanotpu's draw), on ``device``."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, vocab_size, size=(vocab_size, n_succ),
                         dtype=np.int32)
    return torch.from_numpy(table).to(resolve_device(device), torch.int64)


def ideal_ce(succ_logits=DEFAULT_SUCC_LOGITS) -> float:
    """Per-token entropy of the chain in nats: the cross-entropy floor."""
    z = np.asarray(succ_logits, np.float64)
    p = np.exp(z - z.max())
    p /= p.sum()
    return float(-(p * np.log(p)).sum())


def markov_batch(generator: torch.Generator, table: torch.Tensor,
                 shape: tuple[int, ...],
                 succ_logits=DEFAULT_SUCC_LOGITS) -> torch.Tensor:
    """Token sequences of ``shape = (..., S)`` (int64) sampled from the
    chain on the table's device, from ``generator`` (which lives there
    too). Sequence starts are uniform-random tokens; every later token is
    ``table[previous, choice]`` with choice ~ softmax(succ_logits)."""
    *lead, S = shape
    B = math.prod(lead) if lead else 1
    dev = table.device
    probs = torch.softmax(torch.tensor(succ_logits, dtype=torch.float32), 0)
    choices = torch.multinomial(probs.to(dev), B * max(S - 1, 0),
                                replacement=True, generator=generator)
    choices = choices.view(max(S - 1, 0), B)
    tokens = torch.empty((B, S), dtype=torch.int64, device=dev)
    tokens[:, 0] = torch.randint(0, table.shape[0], (B,), generator=generator,
                                 device=dev)
    for s in range(S - 1):
        tokens[:, s + 1] = table[tokens[:, s], choices[s]]
    return tokens.reshape(*lead, S) if lead else tokens[0]
