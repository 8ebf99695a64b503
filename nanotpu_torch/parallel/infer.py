"""Sharded inference: tp x fsdp placement of decode, the port of
``nanotpu/parallel/infer.py``.

Llama-3-8B's bf16 weights (16 GB) fill a 16 GB chip, so nanotpu decodes
over a mesh; one H100 holds them, and the port's mesh spreads a model over
several cards the same way. This module is the placement layer that the
decode paths (:mod:`nanotpu_torch.models.generate`,
:mod:`nanotpu_torch.models.speculative`, :mod:`nanotpu_torch.serving.engine`)
share:

* **params** take the training specs (tp over heads, ffn and vocab, fsdp
  over the other matmul axis: :func:`.mesh.llama_param_specs`; a MoE
  config's experts over ep as well, :func:`.mesh.mixtral_param_specs`),
  placed as DTensors from the whole tree that every process holds, on the
  card or on the CPU: each process keeps a copy of its own shard only. An
  fsdp > 1 inference mesh gathers each layer's weights at use (ZeRO-style
  decode). int8 ``QArray`` leaves are placed member-wise: ``q`` under the
  weight's spec, ``s`` under it with the contraction axis dropped
  (:func:`.mesh.qarray_scale_spec`).
* **KV caches** split the ``n_kv_heads`` axis over tp: each rank attends its
  own heads and the cache needs no collective. Batch, slot and position
  axes stay whole, so dp ranks compute the same rows.
* the model runs on the local shards (:func:`on_mesh`): the q/k/v and
  gate/up products are column-parallel, ``wo`` and ``w_down`` row-parallel
  with a tp all-reduce after them, the embedding vocab-parallel, and the
  vocab-split head's logits are all-gathered over tp before sampling, so
  every rank draws the same token. A MoE layer runs its E/ep experts a
  rank and all-reduces the combine over ep. Every rank holds every row,
  so routing needs no collective.

nanotpu's ``constrain_cache`` has no counterpart: it pins the sharding of a
cache that XLA builds inside a jitted function, and the port builds each
rank's cache at its local shape (``n_kv_heads / tp`` heads) to begin with.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from nanotpu_torch.models.quant import QArray
from nanotpu_torch.parallel.mesh import (
    P,
    Shards,
    check_divisibility,
    check_moe_divisibility,
    local,
    param_specs,
    placements_for,
    qarray_scale_spec,
)
from nanotpu_torch.tree import map_tree, rebuild

def infer_param_specs(cfg) -> dict:
    """PartitionSpec tree for an inference param tree: the training specs
    (tp x fsdp) unchanged; a MoE config (one with ``n_experts``) gets the
    expert-sharded ones."""
    return param_specs(cfg)


def check_infer_divisibility(cfg, mesh) -> None:
    if hasattr(cfg, "n_experts"):
        check_moe_divisibility(cfg, mesh)
    else:
        check_divisibility(cfg, mesh)


def tree_specs(params, specs):
    """``specs`` with each spec of a ``QArray`` leaf of ``params`` made a
    ``QArray`` of specs: ``q`` under the weight's, ``s`` under
    :func:`qarray_scale_spec` of it."""
    if isinstance(params, QArray):
        return QArray(specs, qarray_scale_spec(specs, params.q.dim()))
    if isinstance(params, dict):
        return {k: tree_specs(v, specs[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return rebuild(params, [tree_specs(v, specs[i])
                                for i, v in enumerate(params)])
    return specs


def _put(t, mesh, spec):
    """``t``, whole on every process, as a DTensor: each keeps its shard, no
    traffic. A shard that is a strict part of ``t`` is a copy of its own
    bytes (a view would keep the whole tensor alive); a shard that is the
    whole of ``t`` on the mesh's device is ``t`` itself (a mesh of one
    copies nothing). A tensor held elsewhere (a tree on the CPU, for a
    mesh of cards) is moved shard by shard, so that no card holds the
    whole tree. A dimension split over several axes splits outermost
    first, as DTensor's do."""
    placements = placements_for(mesh, spec, t.dim())
    shard = t
    for axis, pl in enumerate(placements):
        if pl.is_shard():
            shard = shard.chunk(mesh.size(axis), pl.dim)[
                mesh.get_local_rank(axis)]
    device = torch.device(mesh.device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if shard.device != device:
        shard = shard.to(device, memory_format=torch.contiguous_format)
    elif shard.numel() < t.numel():
        shard = shard.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(shard.contiguous(), mesh, placements,
                              run_check=False)


def place_params(params, cfg, mesh, shared: dict | None = None):
    """A (possibly int8-quantized) whole param tree, the same on every
    process, on the mesh's device or on the CPU, as DTensors on ``mesh`` by
    :func:`infer_param_specs`; QArray leaves member-wise. A tensor the tree
    holds twice is placed once; pass the same ``shared`` dict to place a
    second tree (a speculative draft) whose tied tensors (embedding, final
    norm, head) are then the first tree's DTensors."""
    check_infer_divisibility(cfg, mesh)
    done = {} if shared is None else shared

    def place(t, spec):
        if id(t) not in done:
            done[id(t)] = (t, _put(t, mesh, spec))
        return done[id(t)][1]

    return map_tree(place, params, tree_specs(params,
                                              infer_param_specs(cfg)))


def on_mesh(params, cfg, mesh, shared: dict | None = None):
    """(local shards, :class:`Shards`) of a tree placed by
    :func:`place_params`: what the decode functions run on. ``shared``
    (id of a DTensor -> its local tensor) makes two trees placed from tied
    tensors share their local shards too (a speculative draft's tied
    embedding and head)."""
    specs = tree_specs(params, infer_param_specs(cfg))
    shared = {} if shared is None else shared

    def one(t):
        if not isinstance(t, DTensor) and mesh.size() > 1:
            raise ValueError("a tree decoded over a mesh of more than one "
                             "device is placed first: place_params")
        if id(t) not in shared:
            shared[id(t)] = (t, local(t))
        return shared[id(t)][1]

    return map_tree(one, params), Shards(mesh, specs, split_tokens=False)


#: Per-layer cache entry [B|SLOTS, max_len, n_kv_heads, head_dim]: kv heads
#: over tp, everything else whole (see the module docstring).
KV_ENTRY_SPEC = P(None, None, "tp", None)
#: int8 scale planes [B|SLOTS, max_len, n_kv_heads].
KV_SCALE_SPEC = P(None, None, "tp")


def kv_cache_specs(cfg):
    """Spec tree matching :class:`nanotpu_torch.models.generate.KVCache`
    (its host ``length`` replicated)."""
    from nanotpu_torch.models.generate import KVCache

    n = cfg.n_layers
    return KVCache(k=tuple(KV_ENTRY_SPEC for _ in range(n)),
                   v=tuple(KV_ENTRY_SPEC for _ in range(n)), length=P())


def slot_cache_specs(cfg, kv_int8: bool = False):
    """Spec tree matching the serving engine's SlotCache / SlotCache8."""
    from nanotpu_torch.serving.engine import SlotCache, SlotCache8

    n = cfg.n_layers
    ent = tuple(KV_ENTRY_SPEC for _ in range(n))
    if kv_int8:
        sc = tuple(KV_SCALE_SPEC for _ in range(n))
        return SlotCache8(k=ent, v=ent, k_scale=sc, v_scale=sc, lengths=P())
    return SlotCache(k=ent, v=ent, lengths=P())


class _CfgView:
    def __init__(self, n_layers: int):
        self.n_layers = n_layers


def _cache_specs_of(cache):
    """Spec tree for any of the three cache flavours, by inspection."""
    from nanotpu_torch.serving.engine import SlotCache8

    cfg_like = _CfgView(n_layers=len(cache.k))
    if hasattr(cache, "lengths"):
        return slot_cache_specs(cfg_like,
                                kv_int8=isinstance(cache, SlotCache8))
    return kv_cache_specs(cfg_like)


def place_cache(cache, mesh):
    """Any of the three cache flavours, whole and the same on every
    process, as DTensors on ``mesh`` (a host ``length`` stays as it is)."""
    def put(t, spec):
        return t if isinstance(t, int) else _put(t, mesh, spec)

    return map_tree(put, cache, _cache_specs_of(cache))

