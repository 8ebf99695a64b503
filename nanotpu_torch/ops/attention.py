"""Flash attention, forward half: a hand-written CUDA kernel and its plain
version.

Counterpart of ``nanotpu/ops/attention.py``. On a CUDA tensor
:func:`flash_attention` launches ``csrc/flash_fwd.cu`` (the port of
``_flash_kernel``); on a CPU tensor it runs :func:`attention_lse_ref`, the
dense plain version that mirrors ``_xla_attention_lse``. Layouts at the
public functions are nanotpu's: q ``[B, S, H, D]``, k/v ``[B, S, KV, D]``
with KV dividing H, where q head h reads kv head ``h // (H // KV)``.

The backward kernels come with the training path.
"""

from __future__ import annotations

import ctypes
import math

import torch

from nanotpu_torch.ops import _build

NEG_INF = -1e30
#: dtype code the C interface takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def attention_lse_ref(q, k, v, causal: bool):
    """Dense plain version: (out [B,S,H,D], lse [B,H,S] f32), with NEG_INF
    lse on fully masked rows. Equal to nanotpu's ``_xla_attention_lse``,
    GQA repeat included."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    if KV != H:
        if H % KV:
            raise ValueError(f"n_kv_heads {KV} must divide n_heads {H}")
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1)
    m_safe = torch.where(m == NEG_INF, 0.0, m)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(logits == NEG_INF, 0.0, p)
    l = p.sum(dim=-1)
    out = torch.einsum(
        "bhqk,bkhd->bqhd", (p / l.clamp_min(1e-30)[..., None]).to(q.dtype), v
    )
    lse = torch.where(l > 0.0, m_safe + torch.log(l.clamp_min(1e-30)), NEG_INF)
    return out, lse


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"want q [B,S,H,D] and k, v [B,S,KV,D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}"
        )
    if H % k.shape[2]:
        raise ValueError(f"n_kv_heads {k.shape[2]} must divide n_heads {H}")


def flash_attention(q, k, v, causal: bool = True, need_lse: bool = False):
    """q [B,S,H,D], k/v [B,S,KV,D] -> out [B,S,H,D], or (out, lse [B,H,S]
    f32) with ``need_lse``. A CUDA tensor goes through the kernel, a CPU
    tensor through :func:`attention_lse_ref`; any other device raises."""
    _check(q, k, v)
    if q.device.type == "cpu":
        out, lse = attention_lse_ref(q, k, v, causal)
    elif q.device.type == "cuda":
        out, lse = _flash_cuda(q, k, v, causal, need_lse)
    else:
        raise ValueError(f"flash_attention has no path for {q.device}")
    return (out, lse) if need_lse else out


#: kernel launches since the last reset (CPU calls do not count)
flash_attention.launches = 0


def _kernel():
    fn = _build.library("flash_fwd").nanotpu_flash_fwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = (
            [ptr] * 5 + [i32] * 6 + [i64] * 12
            + [i32, ctypes.c_float, ptr]
        )
        fn.restype = i32
    return fn


def _flash_cuda(q, k, v, causal: bool, need_lse: bool):
    B, S, H, D = q.shape
    KV = k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes float32 or bfloat16 q/k/v of one dtype; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, not {D}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash kernel needs a unit stride on head_dim")
    if q.dtype == torch.bfloat16 and not all(
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
        for t in (q, k, v)
    ):
        # the tensor-core kernel moves 16-byte rows of 8 bf16
        raise ValueError("bf16 flash kernel needs 16-byte aligned rows: "
                         "strides in multiples of 8 elements")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        if need_lse else None
    )
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _DTYPE_CODE[q.dtype], B, S, H, KV, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(causal), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out, lse
