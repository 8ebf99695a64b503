"""Weight-only int8 quantization for serving: the port of
``nanotpu/models/quant.py``.

Weights are quantized per OUTPUT channel (symmetric, int8): ``w ~ q * s``
with ``q`` int8 [in, out] and ``s`` f32 [1, out]. Activations stay in the
model's dtype: :func:`matmul` multiplies by ``q`` cast to the activation's
dtype and applies the scale after the product. :class:`QArray` is a
``NamedTuple``, so a quantized tree is walked like any other;
:func:`nanotpu_torch.models.llama.linear` and ``embed_lookup`` dispatch on
it, and nothing else in the model knows about quantization.

In eager PyTorch the cast ``q.to(x.dtype)`` materialises the weight in the
activation dtype on every call (XLA fuses it into the product), so on the
card this path trades transient memory and a copy per product for the
halved weight bytes at rest.

``torch.load(weights_only=True)`` refuses a ``NamedTuple``: a quantized tree
is saved as plain dicts of tensors (:func:`save_params`) and turned back into
``QArray`` leaves on load (:func:`load_params`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nanotpu_torch.tree import leaves, rebuild


class QArray(NamedTuple):
    """Symmetric per-output-channel int8 weight: ``w ~ q * s``."""

    q: torch.Tensor  # int8, same shape as the original weight
    s: torch.Tensor  # f32, the original shape with axis -2 of size 1

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):  # the dtype compute sees after dequantization
        return torch.bfloat16


def absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` in f32, correctly rounded on every device:
    on CUDA, PyTorch divides by a Python number as a multiply by its
    reciprocal, which can land one ulp off the true quotient (and move a
    rounded int8 value by one), so the divisor is a tensor."""
    return torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)


def quantize(w: torch.Tensor) -> QArray:
    """Quantize one weight (last axis = output channels). The amax reduces
    only the contraction axis (-2): stacked expert weights [E, d, f] get
    per-expert scales [E, 1, f]; plain [in, out] matrices get [1, out].
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    w32 = w.float()
    s = absmax_scale(w32.abs().amax(dim=-2, keepdim=True))
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return QArray(q=q, s=s)


def dequantize(w: QArray, dtype=torch.bfloat16) -> torch.Tensor:
    return (w.q.float() * w.s).to(dtype)


def matmul(x: torch.Tensor, w: QArray) -> torch.Tensor:
    """x @ (q * s) with the scale folded in after the product (one multiply
    per output element instead of one per weight)."""
    return (x @ w.q.to(x.dtype)) * w.s.to(x.dtype)


def embedding_lookup(w, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """Row gather for a (possibly quantized) embedding table. The table is
    quantized per embedding dimension (its last axis), so gathered rows
    rescale with the same broadcast; ``dtype`` is the activation dtype
    (bfloat16 by default for a quantized table)."""
    if isinstance(w, QArray):
        dt = dtype or torch.bfloat16
        return w.q[tokens].to(dt) * w.s[0].to(dt)
    return w[tokens]


#: Weight names that stay unquantized even though they are 2-D (1-D leaves,
#: the norm gains, are excluded by the ndim guard): the MoE router stays
#: f32, its argmax being sensitive to logit noise and the matrix tiny.
_SKIP = {"router"}


def quantize_params(params):
    """Quantize every matmul weight of a Llama or Mixtral parameter
    tree (the expert stacks with per-expert scales; the router stays)."""

    def walk(node):
        if isinstance(node, dict):
            return {k: (node[k] if k in _SKIP else walk(node[k]))
                    for k in node}
        if isinstance(node, list):
            return [walk(x) for x in node]
        if getattr(node, "ndim", 0) >= 2:
            return quantize(node)
        return node

    return walk(params)


def param_bytes(params) -> int:
    """Total bytes of all leaves (one byte an int8 element): the weight
    bytes a decode step streams."""
    return sum(t.numel() * t.element_size() for t in leaves(params))


def _plain(tree):
    """``tree`` with each QArray as a ``{"q": .., "s": ..}`` dict."""
    if isinstance(tree, QArray):
        return {"q": tree.q, "s": tree.s}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return rebuild(tree, [_plain(v) for v in tree])
    return tree


def _from_plain(tree):
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            return QArray(tree["q"], tree["s"])
        return {k: _from_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return rebuild(tree, [_from_plain(v) for v in tree])
    return tree


def save_params(path: str, params) -> None:
    """``torch.save`` a parameter tree, quantized or not, as plain dicts
    and lists of tensors."""
    torch.save(_plain(params), path)


def load_params(path: str, device=None):
    """A tree written by :func:`save_params`, on ``device`` (where it was
    saved from when None), with its QArray leaves restored."""
    return _from_plain(torch.load(path, map_location=device,
                                  weights_only=True))
