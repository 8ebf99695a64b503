"""nanotpu's serving and training paths in PyTorch, for one NVIDIA H100.

A port of the JAX package ``nanotpu`` that stays beside it as the
reference. The layout mirrors nanotpu's, so each module's counterpart has
the same path: ``models/llama.py``, ``models/generate.py``,
``ops/attention.py``, ``serving/engine.py``, ``serving/server.py``,
``parallel/train.py`` and ``data/``. The parameter tree is nanotpu's (dicts
and lists, ``[in, out]`` weights used as ``x @ w``);
:func:`nanotpu_torch.convert.params_from_numpy` carries one over.

The package imports torch, numpy and the standard library, never jax and
never nanotpu. Entry points that allocate run on ``cuda`` unless the caller
passes ``device="cpu"``; without a card and without that choice they raise.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent,
    so nothing quietly carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
