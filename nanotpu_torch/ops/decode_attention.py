"""Decode attention over the serving engine's slot cache: a hand-written
CUDA kernel and its plain version.

Row b's s-th new query sits at position ``base[b] + s`` and attends the
cache positions ``< min(base[b] + s + 1, T)`` of its kv head, at scale
``1/sqrt(hd)``; q head h reads kv head ``h // (H // KV)``. This is the
attend of every ``_rows_forward`` call of :mod:`nanotpu_torch.serving.engine`:
the plain decode step (S=1), the speculative verify (S=K+1) and the
draft's steps, on a mesh at the local kv heads, and the int8 cache's
dequantized views.

:func:`decode_attention` runs :func:`attend_rows_ref` (nanotpu's
``_attend_rows`` einsum) on a CPU tensor, launches ``csrc/decode_attn.cu``
on a CUDA tensor, and raises on any other device or on a tensor the
kernel does not take. The kernel reads each row's cache only up to its
own frontier, once per kv head, in the cache's own [B, T, KV, hd] layout.
"""

from __future__ import annotations

import ctypes
import math

import torch

from nanotpu_torch.ops import _build
from nanotpu_torch.ops.attention import _DTYPE_CODE, _HEAD_DIMS, NEG_INF

#: positions a kernel tile holds; a split's span is a multiple of it
_TILE = 64


def attend_rows_ref(q, k_cache, v_cache, base):
    """q [B,S,H,hd] against cache [B,T,KV,hd]; row b's s-th new token sits
    at position base[b]+s and attends positions <= itself. GQA stays
    unexpanded (q heads grouped onto kv heads). S=1 is the decode step."""
    B, S, H, hd = q.shape
    KV, T = k_cache.shape[2], k_cache.shape[1]
    qg = q.reshape(B, S, KV, H // KV, hd)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, k_cache).float()
    logits = logits * (1.0 / math.sqrt(hd))
    frontier = base[:, None] + torch.arange(S, device=q.device)[None, :] + 1
    mask = torch.arange(T, device=q.device)[None, None, :] < frontier[:, :, None]
    logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v_cache)
    return out.reshape(B, S, H, hd)


def _check(q, k_cache, v_cache, base) -> None:
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"want q [B,S,H,hd] and caches [B,T,KV,hd]; got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, S, H, hd = q.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != hd:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % k_cache.shape[2]:
        raise ValueError(f"n_kv_heads {k_cache.shape[2]} must divide "
                         f"n_heads {H}")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise TypeError("decode attention takes float32 or bfloat16 q and "
                        f"caches of one dtype; got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if base.dim() != 1 or base.shape[0] != B or base.dtype != torch.int32:
        raise ValueError(f"base must be int32 [B={B}]; got {base.dtype} "
                         f"{tuple(base.shape)}")


def decode_attention(q, k_cache, v_cache, base):
    """out [B,S,H,hd] in q's dtype: :func:`attend_rows_ref` on a CPU
    tensor, ``decode_attn.cu`` on a CUDA tensor."""
    _check(q, k_cache, v_cache, base)
    if q.device.type == "cpu":
        return attend_rows_ref(q, k_cache, v_cache, base)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention has no path for {q.device}")
    return _decode_cuda(q, k_cache, v_cache, base)


#: kernel launches since the last reset (CPU calls do not count)
decode_attention.launches = 0


def split_span(B: int, KV: int, T: int, sms: int) -> int:
    """Positions a work unit (a block) of the kernel covers, from the
    shapes and the card's SM count alone (never from the lengths, so a
    captured graph stays valid): 512, halved down to one tile while the
    units of a full cache would fill fewer than four blocks an SM. A unit
    fills its ring before its first tile, so long units pay (H100, chat's
    and long prompts' caches: 512 beat 128, 256 and 1024 at S=1)."""
    span = 512
    while span > _TILE and B * KV * -(-T // span) < 4 * sms:
        span //= 2
    return span


def _kernel():
    fn = _build.library("decode_attn").nanotpu_decode_attn
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 7 + [i32] * 8 + [ctypes.c_float, ptr]
        fn.restype = i32
    return fn


def _decode_cuda(q, k_cache, v_cache, base):
    B, S, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the decode kernel takes head_dim in {_HEAD_DIMS}, "
                         f"not {hd}")
    tensors = (q, k_cache, v_cache, base)
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode attention inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the decode kernel takes contiguous q, caches and "
                         "base")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    span = split_span(B, KV, T, sms)
    rows = B * KV * -(-T // span) * S * (H // KV)
    part_o = torch.empty((rows, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((rows, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _kernel()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            base.data_ptr(), out.data_ptr(), part_o.data_ptr(),
            part_ml.data_ptr(), _DTYPE_CODE[q.dtype], B, S, H, KV, hd, T,
            span, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"decode_attn kernel launch failed: CUDA error {rc}")
    decode_attention.launches += 1
    return out
