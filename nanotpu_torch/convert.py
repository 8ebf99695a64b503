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

#: matrices that nanotpu keeps in f32 in a bf16 model: the MoE router
#: (``nanotpu/models/mixtral.py`` draws it in the model's dtype and stores
#: it in f32), whose argmax a rounded logit can flip
KEEP_F32 = frozenset({"router"})


def _leaf(arr, device):
    arr = np.array(arr)  # a writable copy: jax hands out read-only views
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def cast_params(tree, dtype: torch.dtype):
    """``tree`` as nanotpu's presets of model dtype ``dtype`` hold it: every
    floating matrix (2-D and up) cast, except those under a
    :data:`KEEP_F32` key; the norm gains (1-D) and quantized leaves keep
    theirs."""
    if isinstance(tree, QArray):
        return tree
    if isinstance(tree, dict):
        return {k: (v if k in KEEP_F32 else cast_params(v, dtype))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return rebuild(tree, [cast_params(v, dtype) for v in tree])
    if tree.is_floating_point() and tree.dim() >= 2:
        return tree.to(dtype)
    return tree


def params_from_numpy(tree, device, dtype: torch.dtype | None = None):
    """The same tree with every leaf a torch tensor on ``device``.
    ``dtype`` casts it as :func:`cast_params` does; None keeps each leaf's."""
    if isinstance(tree, dict):
        out = {k: params_from_numpy(v, device) for k, v in tree.items()}
    elif getattr(tree, "_fields", None) == ("q", "s"):
        out = QArray(_leaf(tree.q, device), _leaf(tree.s, device))
    elif isinstance(tree, (list, tuple)):
        out = rebuild(tree, [params_from_numpy(v, device) for v in tree])
    else:
        out = _leaf(tree, device)
    return out if dtype is None else cast_params(out, dtype)
