"""Carry a nanotpu parameter tree over to torch tensors.

The tree is nanotpu's: dicts and lists (or tuples) whose leaves are numpy
arrays, for instance ``jax.tree_util.tree_map(np.asarray, params)``.
nanotpu's quantized leaves (a named tuple with the fields ``q`` and ``s``)
become the port's :class:`~nanotpu_torch.models.quant.QArray`, recognised
by those fields, their int8 values and f32 scales kept as they are. bf16
leaves arrive as ml_dtypes ``bfloat16`` arrays; their bits are viewed as
16-bit integers and reinterpreted by torch, so neither ml_dtypes nor jax is
needed here.
"""

from __future__ import annotations

import numpy as np
import torch

from nanotpu_torch.models.quant import QArray
from nanotpu_torch.tree import rebuild


def _leaf(arr, device, dtype):
    arr = np.array(arr)  # a writable copy: jax hands out read-only views
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype: torch.dtype | None = None):
    """The same tree with every leaf a torch tensor on ``device``.
    ``dtype`` casts the floating-point leaves; None keeps each leaf's."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if getattr(tree, "_fields", None) == ("q", "s"):
        return QArray(_leaf(tree.q, device, None), _leaf(tree.s, device, None))
    if isinstance(tree, (list, tuple)):
        return rebuild(tree, [params_from_numpy(v, device, dtype) for v in tree])
    return _leaf(tree, device, dtype)
