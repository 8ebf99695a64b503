"""Pipeline parallelism: GPipe microbatched stages over the ``pp`` mesh axis,
the port of ``nanotpu/parallel/pipeline.py`` (the dense Llama stack and
the Mixtral MoE stack).

Layer stages live on ``pp`` ranks, and activations hop stage to stage once
a microbatch tick. nanotpu writes the schedule as a ``lax.scan`` under a
``shard_map`` manual over ``pp`` and lets ``jax.grad`` transpose it; the
port runs the same ticks as an eager loop on each rank's shards, and the
hop is :class:`_PipeShift`, one send to the next stage and one receive from
the previous (``batch_isend_irecv``), an autograd function whose backward
is the reverse hop (the transpose of nanotpu's ``ppermute``).

Schedule (GPipe): with M microbatches and P stages there are M + P - 1
ticks, and at tick t stage r works on microbatch t - r. Stage 0 feeds
microbatch ``clip(t)``; the others take what the previous stage sent. Ticks
outside [0, M) are bubbles: every rank runs every tick on whatever it holds
(garbage in a bubble), so that the hops pair up in the forward, and every
hop's backward runs on every rank too, each tick's output reaching the loss
through the stage mask (``torch.where``, zero gradient off the last stage).
A skipped bubble would leave a hop's backward unpaired and hang it.

The embedding, final norm and head stay outside the stages, as in nanotpu:
every pp rank embeds the tokens (entering the pipeline through
:meth:`.mesh.Shards.pp_in`, whose backward sums the embedding's gradient
over pp), and the last stage's output is summed over pp
(:meth:`.mesh.Shards.pp_out`) so that every rank has the logits and the
loss. Inside a stage the dp/fsdp/tp shardings are the mesh step's
(:class:`.mesh.Shards`): weights gathered over fsdp at use, tp collectives
around each split product. With ``attn_impl="ring"`` the stages see this
rank's sequence block and call the per-shard ring over sp directly
(nanotpu's ``"ring_manual"``).

Parameters are nanotpu's stacked tree (:func:`stack_layers`): each layer
leaf carries a leading [n_layers] axis, which ``pp`` splits into a
contiguous block of L/pp layers a rank (:func:`llama_pp_param_specs`). A
stage unbinds its block once a step and runs it layer by layer.

A Mixtral stage (:func:`mixtral_pp_param_specs`: each expert leaf keeps
its ep split after the layer axis, so pp composes with ep) runs
:func:`nanotpu_torch.models.mixtral.decoder_layer`, the plain forward's
layer, and sums its router aux losses over the ticks that carry a real
microbatch. Routing, capacity and the aux loss are per microbatch, and
within one global over the tokens that the data axes split (its rows
over dp and fsdp, its sequence over sp under the ring, nanotpu's
``seq_axis="sp"``); the aux term is the mean over the microbatches.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from nanotpu_torch.models import llama, mixtral
from nanotpu_torch.parallel.mesh import (
    P,
    Shards,
    axis_sizes,
    llama_param_specs,
    local,
    mixtral_param_specs,
    param_specs,
    placements_for,
)
from nanotpu_torch.parallel.ring_attention import _shift
from nanotpu_torch.tree import leaves, map_tree


# -- parameter layout ---------------------------------------------------------

def stack_layers(params: dict) -> dict:
    """``layers`` from a list of per-layer trees to one tree whose leaves
    carry a leading [n_layers] axis: the axis ``pp`` splits."""
    layers = params["layers"]
    return {**params, "layers": map_tree(lambda *xs: torch.stack(xs),
                                         layers[0], *layers[1:])}


def unstack_layers(params: dict) -> dict:
    """Inverse of :func:`stack_layers` (a pipelined checkpoint handed back
    to the plain forward)."""
    n = leaves(params["layers"])[0].shape[0]
    return {**params, "layers": [map_tree(lambda x, i=i: x[i],
                                          params["layers"])
                                 for i in range(n)]}


def _map_specs(fn, tree):
    """``tree`` of specs (dicts and lists of :class:`P`) with each spec
    replaced by ``fn(spec)``."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return [_map_specs(fn, v) for v in tree]


def _stacked_specs(base: dict) -> dict:
    """``pp`` prefixed onto every layer leaf's spec (the stacked leading
    axis); the embedding, final norm and head keep theirs (they run outside
    the pipeline, replicated over pp)."""
    return {**base, "layers": _map_specs(lambda spec: P("pp", *spec),
                                         base["layers"][0])}


def llama_pp_param_specs(cfg) -> dict:
    """Specs of the stacked dense tree: ``pp`` on the leading layer axis,
    each layer leaf's tp/fsdp spec shifted right."""
    return _stacked_specs(llama_param_specs(cfg))


def mixtral_pp_param_specs(cfg) -> dict:
    """Specs of the stacked MoE tree: ``pp`` on the leading layer axis, each
    expert leaf's (ep, fsdp/tp) spec shifted right, so the experts stay
    split over ep inside each stage."""
    return _stacked_specs(mixtral_param_specs(cfg))


def pp_param_specs(cfg) -> dict:
    """:func:`mixtral_pp_param_specs` for a MoE config, else
    :func:`llama_pp_param_specs`."""
    return _stacked_specs(param_specs(cfg))


def check_pp_divisibility(cfg, mesh, batch: int, n_micro: int) -> None:
    """Fail fast with nanotpu's message."""
    pp = axis_sizes(mesh)["pp"]
    problems = []
    if cfg.n_layers % pp:
        problems.append(f"n_layers {cfg.n_layers} % pp {pp}")
    if batch % n_micro:
        problems.append(f"batch {batch} % n_micro {n_micro}")
    if n_micro < pp:
        problems.append(f"n_micro {n_micro} < pp {pp} (pipeline can never "
                        "fill)")
    if problems:
        raise ValueError("pipeline misconfigured: " + ", ".join(problems))


# -- the pipelined region -----------------------------------------------------

class _PipeShift(torch.autograd.Function):
    """``y`` one hop along the stage ring, to pp rank r+1 from rank r-1;
    backward: the gradient one hop back."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _shift((y,), group, 1)[0]

    @staticmethod
    def backward(ctx, g):
        return _shift((g,), ctx.group, -1)[0], None


def _layer(block, i: int):
    """Layer ``i`` of a tree whose leaves are tuples of per-layer tensors."""
    if isinstance(block, dict):
        return {k: _layer(v, i) for k, v in block.items()}
    return block[i]


def _pipeline_body(local_layers, xm, cos, sin, cfg, shard: Shards,
                   n_micro: int):
    """xm [M, mB, S, D] hidden states (the same on every pp rank) -> (out
    [M, mB, S, D] through all n_layers across the stages, on every rank;
    the router aux losses of every layer and microbatch summed, on every
    rank, or None for the dense stack). ``local_layers``: this rank's
    stacked block [L/pp, ...]."""
    n_stages, rank = shard.size["pp"], shard.rank["pp"]
    ticks = n_micro + n_stages - 1
    block = map_tree(lambda t: t.unbind(0), local_layers)
    n_local = leaves(local_layers)[0].shape[0]
    moe = hasattr(cfg, "n_experts")
    layer_specs = param_specs(cfg)["layers"][0]
    if moe:
        layer_fn = mixtral.decoder_layer
    elif cfg.remat:
        layer_fn = llama._remat_layer(cfg)
    else:
        layer_fn = llama.decoder_layer
    # fills on the device: a tensor copied from the host would synchronize,
    # which a captured step cannot
    first = torch.full((), rank == 0, dtype=torch.bool, device=xm.device)
    last = torch.full((), rank == n_stages - 1, dtype=torch.bool,
                      device=xm.device)

    recv = torch.zeros_like(xm[0])
    outs = [None] * n_micro
    aux_run = torch.zeros((), dtype=torch.float32, device=xm.device)
    for t in range(ticks):
        # stage 0 feeds itself microbatch clip(t); the others take what the
        # previous stage sent last tick (a bubble computes on garbage)
        h = torch.where(first, xm[min(t, n_micro - 1)], recv)
        for i in range(n_local):
            h = layer_fn(shard.use(_layer(block, i), layer_specs), h, cfg,
                         cos, sin, shard)
            if moe:
                h, aux = h
                # this rank works on microbatch t - rank: a bubble's aux
                # does not count
                if 0 <= t - rank < n_micro:
                    aux_run = aux_run + aux
        # the last stage's y at tick t is microbatch t-(P-1); writes before
        # the pipeline fills land on slot 0 and are overwritten at t = P-1
        outs[min(max(t - (n_stages - 1), 0), n_micro - 1)] = h
        if t < ticks - 1:
            recv = _PipeShift.apply(h, shard.group["pp"]) if n_stages > 1 \
                else h
    out = torch.stack(outs)
    out = shard.pp_out(torch.where(last, out, torch.zeros_like(out)))
    # every (stage, microbatch) pair ran on one rank: the sum over pp counts
    # each layer's aux on each microbatch once
    return out, (shard.pp_out(aux_run) if moe else None)


def _pipelined_logits(params, tokens, cfg, shard: Shards, n_micro: int):
    """This rank's rows and sequence block of tokens [B, S] -> (logits
    [B, S, vocab/tp] f32 through embed -> stages -> final norm and head;
    for a MoE model the router aux loss, the mean over microbatches of
    each one's summed over layers, else None)."""
    B, S = tokens.shape
    if B % n_micro:
        raise ValueError(f"local batch {B} does not split into {n_micro} "
                         "microbatches")
    if cfg.attn_impl == "ring":
        cfg = dataclasses.replace(cfg, attn_impl="ring_manual")
    start = shard.rank["sp"] * S
    positions = torch.arange(start, start + S, dtype=torch.int32,
                             device=tokens.device)
    cos, sin = llama.rope_freqs(cfg, positions)
    x = shard.embed(shard.use(params["embed"], shard.specs["embed"]), tokens)
    xm = shard.pp_in(x).reshape(n_micro, B // n_micro, S, cfg.dim)
    h, aux = _pipeline_body(params["layers"], xm, cos, sin, cfg, shard,
                            n_micro)
    h = llama.rms_norm(h.reshape(B, S, cfg.dim), params["final_norm"],
                       cfg.norm_eps)
    head = shard.use(params["lm_head"], shard.specs["lm_head"])
    logits = llama.linear(shard.tp_in(h), head).float()
    return logits, (None if aux is None else aux / n_micro)


def _forward(params, tokens, cfg, mesh, n_micro: int):
    check_pp_divisibility(cfg, mesh, tokens.shape[0], n_micro)
    shard = Shards(mesh, pp_param_specs(cfg))
    # this rank's rows and sequence block of the global tokens
    logits, aux = _pipelined_logits(local(params),
                                    shard.seq_block(shard.rows(tokens)),
                                    cfg, shard, n_micro)
    split = placements_for(mesh, P(("dp", "fsdp"), "sp", "tp"), 3)
    return DTensor.from_local(logits, mesh, split, run_check=False
                              ).full_tensor(), aux


def pipelined_forward(params, tokens, cfg, mesh, n_micro: int):
    """tokens [B, S] (the same on every process) -> logits [B, S, vocab]
    f32, whole on every process, via the pp-staged dense decoder.
    ``params``: the stacked tree (:func:`stack_layers`) placed on ``mesh``
    by :func:`llama_pp_param_specs` (``train.place_state``'s DTensors)."""
    return _forward(params, tokens, cfg, mesh, n_micro)[0]


def mixtral_pipelined_forward(params, tokens, cfg, mesh, n_micro: int):
    """The MoE counterpart: (logits, the router aux loss), both on every
    process; ``params`` placed by :func:`mixtral_pp_param_specs`. The aux
    loss and the experts' capacity are per microbatch (its mB * S tokens
    compete for an expert's slots), and the aux term is the mean over the
    microbatches, as nanotpu's is."""
    return _forward(params, tokens, cfg, mesh, n_micro)


class PipelinedLoss:
    """nanotpu's ``pipelined_loss_fn`` (``model="llama"``) or
    ``mixtral_pipelined_loss_fn`` (``"mixtral"``) bound to ``n_micro``, in
    the port's mesh-loss form ``(params, tokens, cfg, shard)`` that
    ``train.build_train_step(..., mesh=...)`` calls on local shards:
    ``tokens`` [B, S+1] this rank's rows; the next-token cross entropy of
    the pipelined logits (plus ``router_aux_weight`` times the aux loss
    for Mixtral), this rank's share of the global batch's loss (summed
    over the data axes, the whole)."""

    def __init__(self, mesh, n_micro: int, model: str = "llama"):
        if model not in ("llama", "mixtral"):
            raise ValueError(f"model {model!r} is not one of 'llama', "
                             "'mixtral'")
        self.mesh = mesh
        self.n_micro = n_micro
        self.model = model

    def __call__(self, params, tokens, cfg, shard: Shards):
        if (self.model == "mixtral") != hasattr(cfg, "n_experts"):
            raise ValueError(f"a {self.model} pipelined loss got a "
                             f"{type(cfg).__name__}")
        inputs = shard.seq_block(tokens[:, :-1])
        targets = shard.seq_block(tokens[:, 1:])
        logits, aux = _pipelined_logits(params, inputs, cfg, shard,
                                        self.n_micro)
        nll = shard.nll_sum(logits.reshape(-1, logits.shape[-1]),
                            targets.reshape(-1))
        loss = nll / (targets.numel() * shard.token_shards())
        if aux is None:
            return loss
        # every data shard holds the whole aux: its share counts it once
        return loss + cfg.router_aux_weight * aux / shard.token_shards()


def pipelined_loss_fn(params, tokens, cfg, *, shard: Shards, n_micro: int):
    """:class:`PipelinedLoss`'s loss, unbound."""
    return PipelinedLoss(shard.mesh, n_micro)(params, tokens, cfg, shard)


def mixtral_pipelined_loss_fn(params, tokens, cfg, *, shard: Shards,
                              n_micro: int):
    """The MoE :class:`PipelinedLoss`'s loss, unbound."""
    return PipelinedLoss(shard.mesh, n_micro, "mixtral")(params, tokens, cfg,
                                                         shard)


def make_pipelined_loss(mesh, n_micro: int, model: str = "llama"):
    """The loss ``build_train_step(loss_fn=..., mesh=mesh)`` takes for a
    pipelined ``model``, "llama" or "mixtral" (on the stacked tree placed
    by :func:`llama_pp_param_specs` or :func:`mixtral_pp_param_specs`)."""
    return PipelinedLoss(mesh, n_micro, model)
