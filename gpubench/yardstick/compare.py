"""The numbers that decide ``correct``, each compared with its limit.

* Serving: at each sampled position, the gap by which the served token's
  logit lies below the reference's best logit there (0 where the served
  token is the reference's own greedy choice), averaged over the
  positions (``mean_gap``). The mean counts every reordered token with its
  size, and so tells the port's int8 path from its bfloat16 one; the
  widest gap, which follows the one closest call among a thousand
  positions, does not (int8 reads under three times bfloat16's).
* Training: the second step's loss against the reference's
  (``loss_gap_2``); and, leaf by leaf, the norm of the first clipped
  gradient and of the parameters' change after the two checked steps,
  each gap taken against the larger of the reference's norm of that leaf
  and the median leaf's, the worst leaf reported. The change leaves out
  leaves whose reference gradient is under a thousandth of the median
  leaf's: Adam moves them by round-off. The first step's loss is not
  compared: the program reads within 0.003 of the reference on every
  seed, and neither the control nor a fault reads three (ten) times that.
"""

from __future__ import annotations

import statistics

import torch

#: a leaf whose first reference gradient is under this share of the
#: median leaf's is left out of the change
NEGLIGIBLE_GRAD = 1e-3


def logit_gaps(ref_logits: torch.Tensor, served: list[int]) -> list[float]:
    """ref.max - ref[served] at each position of ``served``."""
    idx = torch.tensor(served, dtype=torch.long, device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, idx[:, None])[:, 0]
    return (best - got).tolist()


def serve_numbers(gaps: list[float]) -> dict:
    """{number: value} of a serving cell from the gaps of its sampled
    positions; nothing sampled reads as infinitely wrong."""
    return {"mean_gap": sum(gaps) / len(gaps) if gaps else float("inf")}


def worst_leaf_gap(prog: list[float], ref: list[float],
                   keep: list[bool] | None = None) -> float:
    """max over kept leaves of |prog - ref| / max(ref, median ref)."""
    keep = keep or [True] * len(ref)
    floor = statistics.median([r for r, k in zip(ref, keep) if k])
    return max(abs(p - r) / max(r, floor)
               for p, r, k in zip(prog, ref, keep) if k)


def moved_leaves(first_grad_ref: list[float]) -> list[bool]:
    floor = NEGLIGIBLE_GRAD * statistics.median(first_grad_ref)
    return [g >= floor for g in first_grad_ref]


def train_numbers(prog: dict, ref: dict) -> dict:
    """{number: value} of a training cell from the program's and the
    reference's readings (``losses``, ``first_grad_norms``,
    ``change_norms``)."""
    keep = moved_leaves(ref["first_grad_norms"])
    return {
        "loss_gap_2": abs(prog["losses"][1] - ref["losses"][1]),
        "grad_norm_gap": worst_leaf_gap(prog["first_grad_norms"],
                                        ref["first_grad_norms"]),
        "change_norm_gap": worst_leaf_gap(prog["change_norms"],
                                          ref["change_norms"], keep),
    }
