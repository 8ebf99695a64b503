"""Flash attention: hand-written CUDA kernels, forward and backward, and
their plain versions.

Counterpart of ``nanotpu/ops/attention.py``. Layouts at the public
functions are nanotpu's: q ``[B, S, H, D]``, k/v ``[B, S, KV, D]`` with KV
dividing H, where q head h reads kv head ``h // (H // KV)``; lse
``[B, H, S]`` f32, NEG_INF on fully masked rows.

:func:`flash_attention` and :func:`flash_attention_lse` are
``torch.autograd.Function``s on both devices. On a CUDA tensor the forward
launches ``csrc/flash_fwd.cu`` (the port of ``_flash_kernel``) and the
backward ``csrc/flash_bwd.cu``: the fused single pass (``_flash_bwd_fused_kernel``)
while S <= :data:`FUSED_BWD_MAX_S`, else the two-pass dq and dk/dv kernels
(``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``). On a CPU tensor the
same wiring runs the plain versions, :func:`attention_lse_ref` (=
``_xla_attention_lse``) and :func:`attention_bwd_ref` (= ``_flash_backward``
written densely). Any other device raises.
"""

from __future__ import annotations

import ctypes
import logging
import math
import os

import torch

from nanotpu_torch.ops import _build

NEG_INF = -1e30
#: dtype code the C interface takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _env_int(name: str, default: int) -> int:
    """An int from the environment; a value that is not one logs and keeps
    the default (a typo must not break unrelated imports)."""
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        logging.getLogger("nanotpu_torch.ops").warning(
            "%s=%r is not a valid int; using default %d", name, raw, default
        )
        return default


#: Up to this S the backward runs the fused single-pass kernel, above it the
#: two-pass dq + dk/dv pair. Read at import from
#: NANOTPU_FLASH_FUSED_BWD_MAX_S, as nanotpu does; 0 (or negative) always
#: takes the two-pass pair. The default is nanotpu's, not yet an H100
#: measurement.
FUSED_BWD_MAX_S = max(_env_int("NANOTPU_FLASH_FUSED_BWD_MAX_S", 4096), 0)


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


def attention_bwd_ref(q, k, v, out, lse, dout, causal: bool, g_lse=None):
    """Dense plain backward: (dq, dk, dv) shaped and typed like q, k, v, as
    ``_flash_backward`` defines them, in f32. ``D = rowsum(dO * O)``, minus
    ``g_lse`` (the lse cotangent) when one is given."""
    return _bwd_ref(q, k, v, dout, lse, _dvec(out, dout, g_lse), causal)


def _dvec(out, dout, g_lse=None):
    """[B, H, S] f32 ``rowsum(dO * O) - g_lse``: a torch reduction, as
    nanotpu computes it outside its kernels."""
    d = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        d = d - g_lse.float()
    return d.contiguous()


def _bwd_ref(q, k, v, dout, lse, dvec, causal: bool):
    """The plain version of every backward kernel: p rebuilt from lse (zero
    where masked or where lse is NEG_INF), ds = p (dO v^T - D),
    dq = scale ds k, dk = scale ds^T q, dv = p^T dO, with GQA dk/dv summed
    over each kv head's query heads."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    rep = H // KV
    qf, dof = q.float(), dout.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    valid = (lse != NEG_INF)[..., None]
    if causal:
        valid = valid & torch.ones(
            (S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.where(valid, torch.exp(logits - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - dvec[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, S, KV, rep, D).sum(3)
    dv = dv.reshape(B, S, KV, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention has no path for {q.device}")


def _attend(q, k, v, causal: bool, need_lse: bool):
    """(out, lse or None): the kernel on a CUDA tensor, the plain version
    (which always has lse) on a CPU tensor."""
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, causal, need_lse)
    return attention_lse_ref(q, k, v, causal)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        # lse is the backward's residual: asked of the kernel only when an
        # input needs a gradient
        need = any(ctx.needs_input_grad[:3])
        out, lse = _attend(q, k, v, causal, need)
        ctx.causal = causal
        if need:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_backward(q, k, v, out, lse, dout, ctx.causal), None)


class _FlashAttentionLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _attend(q, k, v, causal, True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        return (*flash_backward(q, k, v, out, lse, dout, ctx.causal,
                                g_lse=dlse), None)


def flash_attention(q, k, v, causal: bool = True, need_lse: bool = False):
    """q [B,S,H,D], k/v [B,S,KV,D] -> out [B,S,H,D], or (out, lse [B,H,S]
    f32) with ``need_lse`` (then as :func:`flash_attention_lse`, lse
    differentiable). Differentiable in q, k and v; without grad mode (the
    serving path) it runs the forward alone and asks for no lse."""
    _check(q, k, v)
    if need_lse:
        return flash_attention_lse(q, k, v, causal)
    if not torch.is_grad_enabled():
        return _attend(q, k, v, causal, False)[0]
    return _FlashAttention.apply(q, k, v, causal)


#: forward-kernel launches since the last reset (CPU calls do not count)
flash_attention.launches = 0


def flash_attention_lse(q, k, v, causal: bool = True):
    """:func:`flash_attention` that also returns the per-row log-sum-exp,
    (out [B,S,H,D], lse [B,H,S] f32), both differentiable: the lse
    cotangent folds into the backward's D vector (``D - g_lse``), so the
    backward kernels serve unchanged. Ring attention merges on it."""
    _check(q, k, v)
    if not torch.is_grad_enabled():
        return _attend(q, k, v, causal, True)
    return _FlashAttentionLse.apply(q, k, v, causal)


def flash_backward(q, k, v, out, lse, dout, causal: bool, g_lse=None):
    """(dq, dk, dv) of flash attention from the forward's out and lse:
    D = rowsum(dO * O) - g_lse as a torch reduction, then the fused kernel
    while S <= FUSED_BWD_MAX_S, else the two-pass dq and dk/dv kernels."""
    dout = dout.contiguous()  # autograd may hand over a broadcast or a view
    dvec = _dvec(out, dout, g_lse)
    if q.shape[1] <= FUSED_BWD_MAX_S:
        return flash_bwd_fused(q, k, v, dout, lse, dvec, causal)
    dq = flash_bwd_dq(q, k, v, dout, lse, dvec, causal)
    return (dq, *flash_bwd_dkv(q, k, v, dout, lse, dvec, causal))


def flash_bwd_fused(q, k, v, dout, lse, dvec, causal: bool):
    """(dq, dk, dv) in one pass: ``flash_bwd.cu`` on a CUDA tensor,
    :func:`attention_bwd_ref`'s math on a CPU tensor."""
    if q.device.type == "cpu":
        return _bwd_ref(q, k, v, dout, lse, dvec, causal)
    B, S, H, D = q.shape
    dq32 = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k, memory_format=torch.contiguous_format), \
        torch.empty_like(v, memory_format=torch.contiguous_format)
    _bwd_cuda(0, q, k, v, dout, lse, dvec, dq32, dk, dv, causal)
    flash_bwd_fused.launches += 1
    return dq32.to(q.dtype), dk, dv


def flash_bwd_dq(q, k, v, dout, lse, dvec, causal: bool):
    """dq, the two-pass backward's first half."""
    if q.device.type == "cpu":
        return _bwd_ref(q, k, v, dout, lse, dvec, causal)[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_cuda(1, q, k, v, dout, lse, dvec, dq, None, None, causal)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, dvec, causal: bool):
    """(dk, dv), the two-pass backward's second half."""
    if q.device.type == "cpu":
        return _bwd_ref(q, k, v, dout, lse, dvec, causal)[1:]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_cuda(2, q, k, v, dout, lse, dvec, None, dk, dv, causal)
    flash_bwd_dkv.launches += 1
    return dk, dv


#: backward-kernel launches since the last reset (CPU calls do not count)
flash_bwd_fused.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def _fwd_kernel():
    fn = _build.library("flash_fwd").nanotpu_flash_fwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = (
            [ptr] * 5 + [i32] * 6 + [i64] * 12
            + [i32, ctypes.c_float, ptr]
        )
        fn.restype = i32
    return fn


def _bwd_kernel():
    fn = _build.library("flash_bwd").nanotpu_flash_bwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = (
            [i32] + [ptr] * 9 + [i32] * 6 + [i64] * 21
            + [i32, ctypes.c_float, ptr]
        )
        fn.restype = i32
    return fn


def _check_cuda(*tensors) -> None:
    """What the kernels take: float32 or bfloat16 of one dtype on one
    device, head_dim 64 or 128 with a unit stride, and for bf16 16-byte
    aligned rows (the tensor-core kernels move 16-byte rows of 8 bf16)."""
    q = tensors[0]
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(
            "flash kernels take float32 or bfloat16 tensors of one dtype; "
            f"got {[t.dtype for t in tensors]}"
        )
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(
            f"flash kernels take head_dim in {_HEAD_DIMS}, not {q.shape[3]}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash kernel inputs must be on one device")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError("flash kernels need a unit stride on head_dim")
    if q.dtype == torch.bfloat16 and not all(
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
        for t in tensors
    ):
        raise ValueError("bf16 flash kernels need 16-byte aligned rows: "
                         "strides in multiples of 8 elements")


def _flash_cuda(q, k, v, causal: bool, need_lse: bool):
    B, S, H, D = q.shape
    KV = k.shape[2]
    _check_cuda(q, k, v)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        if need_lse else None
    )
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        rc = _fwd_kernel()(
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


def _bwd_cuda(which, q, k, v, dout, lse, dvec, dq, dk, dv, causal) -> None:
    """Launch one backward kernel (0 fused, 1 dq, 2 dk/dv) on the current
    stream; outputs not written by it are None."""
    _check_cuda(q, k, v, dout)
    B, S, H, D = q.shape
    for name, t in (("lse", lse), ("D", dvec)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, S)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous f32 [B, H, S] on "
                             f"{q.device}; got {t.dtype} {tuple(t.shape)}")
    if S == 0 or B == 0:
        if dq is not None:
            dq.zero_()
        return
    strides = []
    for t in (q, k, v, dout, dq if dq is not None else q,
              dk if dk is not None else k, dv if dv is not None else v):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    with torch.cuda.device(q.device):
        rc = _bwd_kernel()(
            which, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in (dq, dk, dv)),
            _DTYPE_CODE[q.dtype], B, S, H, k.shape[2], D, *strides,
            int(causal), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_bwd kernel {which} launch failed: "
                           f"CUDA error {rc}")
