"""Ring attention: exact attention with the sequence split over the ``sp``
group, the port of ``nanotpu/parallel/ring_attention.py``.

Each rank holds a contiguous sequence block of q/k/v. K/V blocks rotate one
hop a step around the ring (:class:`_RingShift`, a ``batch_isend_irecv``
exchange with its neighbours) while every rank merges its queries'
attention over each visiting block by log-sum-exp: the sequence-parallel
counterpart of flash attention's key loop. The [S, S] scores never exist.

The block held at step ``s`` came from rank ``src = (rank - s) % n`` and
covers positions ``[src * S_blk, (src + 1) * S_blk)``. Causally, rank
``r``'s queries see blocks with ``src < r`` whole, the self block causally
and blocks with ``src > r`` not at all. With ``impl="flash"`` each visible
block is one :func:`nanotpu_torch.ops.attention.flash_attention_lse` call
(the forward kernel; in backward the fused or two-pass kernels, with the
lse cotangent folded into their D vector) and a future block is skipped:
zero output, NEG_INF lse, no launch. ``impl="dense"`` attends each block
with masked einsums, the plain version.

K/V rotate at KV heads, unexpanded (H/KV times fewer bytes a hop under
GQA). A step is :func:`attend_block` then :func:`merge`; ``chip_smoke.py``
drives both for every virtual rank of a ring on one card.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from nanotpu_torch.ops.attention import NEG_INF, flash_attention_lse


def _block_attend(q, k, v, scale, mask):
    """Partial attention of q against one k/v block.

    q [B,Sq,H,D]; k/v [B,Sk,KV,D] with KV | H, grouped (not repeated);
    mask [Sq,Sk] bool or None. Returns (m [B,H,Sq,1], l, acc [B,Sq,H,D]
    f32) for LSE merging."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    logits = logits.reshape(B, H, Sq, Sk)
    if mask is not None:
        logits = torch.where(mask[None, None], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m == NEG_INF, 0.0, m)
    p = torch.exp(torch.where(logits == NEG_INF, NEG_INF, logits - m_safe))
    l = p.sum(dim=-1, keepdim=True)
    pg = p.to(q.dtype).reshape(B, KV, G, Sq, Sk)
    acc = torch.einsum("bkgqs,bskd->bqkgd", pg, v).reshape(B, Sq, H, D).float()
    return m, l, acc


def _dense_block_lse(q, k, v, scale, mask):
    """Dense single-block attend returning the (out [B,Sq,H,D] f32, lse
    [B,H,Sq] f32) merge state."""
    m, l, acc = _block_attend(q, k, v, scale, mask)
    m_safe = torch.where(m == NEG_INF, 0.0, m)
    lse = torch.where(
        l[..., 0] > 0.0,
        m_safe[..., 0] + torch.log(l[..., 0].clamp_min(1e-30)),
        NEG_INF,
    )
    l_t = l.permute(0, 2, 1, 3)  # [B,Sq,H,1]
    return acc / l_t.clamp_min(1e-30), lse


def attend_block(q, k, v, src: int, rank: int, causal: bool = True,
                 impl: str = "flash"):
    """(out [B,Sq,H,D] f32, lse [B,H,Sq] f32) of rank ``rank``'s queries
    against the k/v block that started on rank ``src``: a past block whole,
    the self block causally (when ``causal``), a future block not at all
    (zeros and NEG_INF, nothing launched)."""
    if impl not in ("flash", "dense"):
        raise ValueError(f"unknown ring attention impl: {impl!r}")
    if causal and src > rank:
        return _Skipped.apply(q, k, v)
    diagonal = causal and src == rank
    if impl == "dense":
        Sq, Sk = q.shape[1], k.shape[1]
        mask = (torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril()
                if diagonal else None)
        return _dense_block_lse(q, k, v, 1.0 / math.sqrt(q.shape[3]), mask)
    out, lse = flash_attention_lse(q, k, v, diagonal)
    return out.float(), lse


class _Skipped(torch.autograd.Function):
    """A future block's merge state: zeros (out, f32, q's shape) and NEG_INF
    (lse [B,H,Sq]). Its backward gives k and v zero gradients, so the
    block stays in the graph: every rank then runs the backward of every
    ring shift, whose exchanges the other ranks wait on."""

    @staticmethod
    def forward(ctx, q, k, v):
        B, Sq, H, _ = q.shape
        ctx.kv = (k.shape, k.dtype, k.device)
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.full((B, H, Sq), NEG_INF, dtype=torch.float32,
                           device=q.device))

    @staticmethod
    def backward(ctx, g_out, g_lse):
        shape, dtype, device = ctx.kv
        zero = torch.zeros(shape, dtype=dtype, device=device)
        return None, zero, zero.clone()


def merge(o_run, lse_run, o_blk, lse_blk):
    """LSE merge of two normalized partial attentions, nanotpu's: out
    [B,S,H,D] f32, lse [B,H,S] f32; a NEG_INF side weighs nothing."""
    lse_new = torch.logaddexp(lse_run, lse_blk)
    c_run = torch.where(lse_run == NEG_INF, 0.0, torch.exp(lse_run - lse_new))
    c_blk = torch.where(lse_blk == NEG_INF, 0.0, torch.exp(lse_blk - lse_new))
    o_new = (o_run * c_run.transpose(1, 2)[..., None]
             + o_blk * c_blk.transpose(1, 2)[..., None])
    return o_new, lse_new


def _shift(tensors, group, step: int):
    """Send each tensor to the group rank ``step`` on and receive the one
    from ``step`` back, all in one ``batch_isend_irecv``: every rank posts
    its sends, then its receives, in the same order."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    to = dist.get_global_rank(group, (r + step) % n)
    frm = dist.get_global_rank(group, (r - step) % n)
    tensors = [t.contiguous() for t in tensors]
    got = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, to, group) for t in tensors]
           + [dist.P2POp(dist.irecv, g, frm, group) for g in got])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


class _RingShift(torch.autograd.Function):
    """(k, v) one hop along the ring, to rank r+1 from rank r-1; backward:
    the gradients one hop back (JAX's transpose of ``ppermute``)."""

    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        return tuple(_shift((k, v), group, 1))

    @staticmethod
    def backward(ctx, gk, gv):
        return (*_shift((gk, gv), ctx.group, -1), None)


def ring_attention(q, k, v, group, causal: bool = True, impl: str = "flash"):
    """Per-rank q [B, S_blk, H, D], k/v [B, S_blk, KV, D] (KV | H), the
    sequence split over ``group`` in rank order -> per-rank out [B, S_blk,
    H, D] in q's dtype. Differentiable in q, k and v."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    B, S, H, _ = q.shape
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for s in range(n):
        o_blk, lse_blk = attend_block(q, k_cur, v_cur, (rank - s) % n, rank,
                                      causal, impl)
        o, lse = merge(o, lse, o_blk, lse_blk)
        if s < n - 1:
            k_cur, v_cur = _RingShift.apply(k_cur, v_cur, group)
    return o.to(q.dtype)


def _check_seq_split(t, mesh, axis_name: str) -> None:
    names = list(mesh.mesh_dim_names)
    for name, pl in zip(names, t.placements):
        on_seq = pl.is_shard(1)
        if (name == axis_name) != on_seq or pl.is_partial():
            raise ValueError(f"ring attention wants the sequence (dim 1) split "
                             f"over {axis_name!r} alone; got {t.placements} "
                             f"on {names}")


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient leaves contiguous: a DTensor leaf then takes
    it as it is. (Accumulating a strided one costs a DTensor ``copy_``,
    whose sharding search over six mesh axes takes most of a minute.)"""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def ring_attention_sharded(q, k, v, mesh, causal: bool = True,
                           axis_name: str = "sp", impl: str = "flash"):
    """Global DTensors q [B, S, H, D], k/v [B, S, KV, D] with S split over
    ``axis_name`` of ``mesh`` (batch and heads may be split over the other
    axes) -> out, a DTensor placed like q. Each rank runs
    :func:`ring_attention` on its shards over the axis's group."""
    for t in (q, k, v):
        _check_seq_split(t, mesh, axis_name)
    out = ring_attention(*(_ContiguousGrad.apply(t.to_local())
                           for t in (q, k, v)),
                         mesh.get_group(axis_name), causal, impl)
    return DTensor.from_local(out, mesh, q.placements, run_check=False,
                              shape=q.shape, stride=q.stride())
