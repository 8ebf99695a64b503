"""Training tokens: a first-order Markov chain over the model's vocabulary,
a copy of ``nanotpu_torch/data/synthetic.py`` (``markov_table``,
``markov_batch``) kept with the benchmark.

Each token has ``n_succ`` fixed successors with fixed logits (``[2, 1, 0,
-1]``: ~0.95 nats a token), so a model's loss falls from ln(V) towards
that floor. The table is drawn from the run's seed by numpy; the batches
are sampled on the device from a ``torch.Generator`` seeded from it, all
the steps' batches in one pass over the sequence.
"""

from __future__ import annotations

import torch

from gpubench.yardstick.traffic import rng


def table(vocab: int, n_succ: int, seed: int, device) -> torch.Tensor:
    """[V, n_succ] int64 successor ids."""
    ids = rng(seed, 2).integers(0, vocab, size=(vocab, n_succ))
    return torch.from_numpy(ids).to(device=device, dtype=torch.int64)


def batches(succ: torch.Tensor, succ_logits, shape: tuple[int, int, int],
            generator: torch.Generator) -> torch.Tensor:
    """[steps, B, S] int64 sequences on the table's device: uniform first
    tokens, every later one ``succ[previous, choice]`` with choice ~
    softmax(succ_logits)."""
    steps, B, S = shape
    rows = steps * B
    dev = succ.device
    probs = torch.softmax(torch.tensor(succ_logits, dtype=torch.float32), 0)
    choices = torch.multinomial(probs.to(dev), rows * (S - 1),
                                replacement=True, generator=generator)
    choices = choices.view(S - 1, rows)
    tokens = torch.empty((rows, S), dtype=torch.int64, device=dev)
    tokens[:, 0] = torch.randint(0, succ.shape[0], (rows,),
                                 generator=generator, device=dev)
    for s in range(S - 1):
        tokens[:, s + 1] = succ[tokens[:, s], choices[s]]
    return tokens.view(steps, B, S)
