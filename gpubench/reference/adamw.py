"""AdamW with global-norm clipping, as optax's ``chain(clip_by_global_norm,
adamw)`` defines it, and the readings of a reference run of two steps.

A step: the gradient's global norm n over every leaf; if n >= max_norm
every gradient is scaled by max_norm / n; then m = b1 m + (1 - b1) g,
v = b2 v + (1 - b2) g^2, and p -= lr * (m / (1 - b1^t) / (sqrt(v / (1 -
b2^t)) + eps) + weight_decay * p), every leaf decayed.

Two steps need the first step's moments at the second. Both are functions
of the first clipped gradient (m1 = (1 - b1) g1, v1 = (1 - b2) g1^2), so
only g1 is kept, in float32 in host memory: beside the float32 parameters
and the second step's gradients it would not fit on one card.
"""

from __future__ import annotations

import torch


def _clipped(grads: list, max_norm: float) -> list:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
    if norm >= max_norm:
        scale = (max_norm / norm).float()
        grads = [g * scale for g in grads]
    return grads


@torch.no_grad()
def _update(p, m, v, t: int, opt: dict) -> None:
    m_hat = m / (1 - opt["b1"] ** t)
    v_hat = v / (1 - opt["b2"] ** t)
    p.sub_(opt["lr"] * (m_hat / (torch.sqrt(v_hat) + opt["eps"])
                        + opt["weight_decay"] * p))


def two_steps(params: list, loss_of, batches, opt: dict) -> dict:
    """Run two steps from ``params`` (float32 leaves, updated in place) on
    ``batches[0]`` and ``batches[1]``; ``loss_of(batch)`` is the loss at
    the current parameters. Returns each step's loss and the norm of every
    leaf's first clipped gradient."""
    b1, b2 = opt["b1"], opt["b2"]
    losses, first_norms, first = [], [], []
    for t, batch in ((1, batches[0]), (2, batches[1])):
        for p in params:
            p.requires_grad_(True)
        value = loss_of(batch)
        grads = _clipped(list(torch.autograd.grad(value, params)),
                         opt["max_norm"])
        losses.append(float(value.detach()))
        del value
        for i, (p, g) in enumerate(zip(params, grads)):
            p.requires_grad_(False)
            if t == 1:
                first_norms.append(float(torch.linalg.vector_norm(g)))
                _update(p, (1 - b1) * g, (1 - b2) * g * g, 1, opt)
                first.append(g.to("cpu"))
            else:
                g1 = first[i].to(p.device)
                m = b1 * (1 - b1) * g1 + (1 - b1) * g
                v = b2 * (1 - b2) * g1 * g1 + (1 - b2) * g * g
                _update(p, m, v, 2, opt)
                first[i] = None
            grads[i] = None
    return {"losses": losses, "first_grad_norms": first_norms}
