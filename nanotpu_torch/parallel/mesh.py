"""Device mesh and sharding rules, the port of ``nanotpu/parallel/mesh.py``.

nanotpu's recipe is a six-axis mesh, PartitionSpecs on the parameters, and
XLA inserting the collectives. The port keeps the mesh (a ``DeviceMesh``
over every process of the job, one process a card; over several hosts,
:func:`make_hybrid_mesh`), the axes and the specs, and places parameters
as DTensors by those specs. Axes, in nanotpu's order:

* ``dp``   — pure data parallel (gradients all-reduced)
* ``pp``   — pipeline stages (GPipe, :mod:`.pipeline`)
* ``fsdp`` — data parallel with parameters and optimizer state sharded
  (ZeRO-3: each weight gathered at use, its gradient reduce-scattered)
* ``tp``   — tensor parallel over attention heads, ffn hidden and vocab
* ``sp``   — sequence parallel, ring attention
* ``ep``   — expert parallel: each rank holds E/ep of a MoE layer's
  experts (their stacked leading axis)

Where XLA inserts collectives from the shardings, the port's model runs on
the local shards and :class:`Shards` issues them, each an autograd
function whose backward is its transpose: the fsdp all-gather of a weight
at its use (backward: reduce-scatter), tp's identity-forward copy
(backward: all-reduce) and all-reduce (backward: identity), the same pair
over pp around a pipeline and over ep around a rank's experts, and the
vocab-parallel embedding and cross entropy over tp. MoE routing is the
one decision over the global token set: the router logits are gathered
over the axes that split the tokens (backward: reduce-scatter), and the
experts' inputs summed over them (backward: the same sum).
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from nanotpu_torch.models.quant import embedding_lookup
from nanotpu_torch.tree import map_tree

#: nanotpu's canonical axis order
AXES = ("dp", "pp", "fsdp", "tp", "sp", "ep")
#: the axes over which tokens differ: a parameter's gradient sums over each
#: of them that its spec does not shard
DATA_AXES = ("dp", "fsdp", "sp")


def _entry_axes(entry) -> list[str]:
    """The axis names one spec entry splits its dimension over."""
    return [entry] if isinstance(entry, str) else list(entry or ())


class P(tuple):
    """A PartitionSpec as ``jax.sharding.PartitionSpec`` reads: one entry a
    tensor dimension, from the first, each an axis name, a tuple of axis
    names (the dimension split over all of them, the first outermost), or
    None; dimensions past the last entry are not split."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"

    def axes(self) -> list[str]:
        """The axis names the spec shards over, in its order."""
        return [a for entry in self for a in _entry_axes(entry)]


def mesh_size_error(dp=1, fsdp=1, tp=1, sp=1, ep=1, pp=1,
                    world: int = 1) -> str | None:
    """nanotpu's message when the axis sizes do not multiply to the
    device count (the world size), else None."""
    want = dp * pp * fsdp * tp * sp * ep
    if want == world:
        return None
    return (f"mesh {dp}x{pp}x{fsdp}x{tp}x{sp}x{ep} needs {want} devices, "
            f"have {world}")


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, sp: int = 1,
              ep: int = 1, pp: int = 1, device=None) -> DeviceMesh:
    """A DeviceMesh over every process of the joined group with the
    canonical axis order (dp, pp, fsdp, tp, sp, ep). Axis sizes must
    multiply to the world size; size-1 axes are kept (specs may always name
    them). The device type is ``device``'s, by default the group's: ``cuda``
    under nccl, ``cpu`` under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a joined process group: "
                           "nanotpu_torch.parallel.distributed.initialize, "
                           "or torch.distributed.init_process_group")
    err = mesh_size_error(dp, fsdp, tp, sp, ep, pp, dist.get_world_size())
    if err:
        raise ValueError(err)
    return init_device_mesh(_mesh_device_type(device),
                            (dp, pp, fsdp, tp, sp, ep), mesh_dim_names=AXES)


def _mesh_device_type(device) -> str:
    """``device``'s type, by default the group's: ``cuda`` under nccl,
    ``cpu`` under gloo."""
    if device is None:
        return "cuda" if dist.get_backend() == "nccl" else "cpu"
    return torch.device(device).type


def host_of_rank():
    """The default ``slice_of`` of :func:`make_hybrid_mesh`: a rank's host,
    ``rank // local_world``, where ``local_world`` is torchrun's
    ``LOCAL_WORLD_SIZE`` when it is set, else the host's card count under
    nccl (one process a card); a gloo group without the variable is one
    host."""
    n = os.environ.get("LOCAL_WORLD_SIZE")
    if n:
        local_world = int(n)
    elif dist.get_backend() == "nccl":
        local_world = torch.cuda.device_count()
    else:
        return lambda rank: 0
    return lambda rank: rank // local_world


def make_hybrid_mesh(dcn_dp: int = 0, dp: int = 1, fsdp: int = 1,
                     tp: int = 1, sp: int = 1, ep: int = 1, pp: int = 1,
                     device=None, slice_of=None) -> DeviceMesh:
    """A mesh over several slices, nanotpu's: ``dcn_dp`` is the outermost
    axis and the only one that crosses slices, so only the gradient
    all-reduce of pure data parallelism rides the slow network between
    them; every other axis stays inside a slice.

    GPUs have no slice: NVLink inside a host plays ICI's part and the
    network between hosts DCN's, so a slice is a host. ``slice_of(rank)``
    names a rank's slice (:func:`host_of_rank` by default; the dry run
    gives synthetic slices). ``dcn_dp=0`` takes the slice count; a
    ``dcn_dp`` that contradicts it is refused; one slice gives
    :func:`make_mesh`. Each slice must hold ``dp*pp*fsdp*tp*sp*ep``
    ranks. The axes are :data:`AXES`, ``dp`` of size ``dcn_dp * dp`` with
    each slice's ranks a contiguous block of it, slices in sorted order
    and each slice's ranks in order."""
    if not dist.is_initialized():
        raise RuntimeError("make_hybrid_mesh needs a joined process group")
    slice_of = slice_of or host_of_rank()
    by_slice: dict = {}
    for r in range(dist.get_world_size()):
        by_slice.setdefault(slice_of(r), []).append(r)
    slice_ids = sorted(by_slice)
    n_slices = len(slice_ids)
    if dcn_dp == 0:
        dcn_dp = n_slices
    if dcn_dp != n_slices:
        # also refuses an explicit dcn_dp=1 over several slices: the plain
        # mesh would lay the inner axes across the network
        raise ValueError(f"dcn_dp={dcn_dp} but devices span {n_slices} "
                         "slice(s)")
    if dcn_dp == 1:
        return make_mesh(dp=dp, fsdp=fsdp, tp=tp, sp=sp, ep=ep, pp=pp,
                         device=device)
    per_slice = dp * pp * fsdp * tp * sp * ep
    for s, members in by_slice.items():
        if len(members) != per_slice:
            raise ValueError(f"slice {s} has {len(members)} devices, mesh "
                             f"needs {per_slice} per slice")
    layout = torch.tensor([by_slice[s] for s in slice_ids])
    return DeviceMesh(_mesh_device_type(device),
                      layout.reshape(dcn_dp * dp, pp, fsdp, tp, sp, ep),
                      mesh_dim_names=AXES)


def axis_sizes(mesh) -> dict[str, int]:
    """Each axis's size: of a DeviceMesh, or of a dict of sizes (axes it
    does not name are of size 1)."""
    if isinstance(mesh, dict):
        return {a: mesh.get(a, 1) for a in AXES}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def qarray_scale_spec(spec: P, ndim: int) -> P:
    """Spec for a QArray's per-output-channel scale given its weight's
    spec: the contraction axis (-2, size 1 in the scale) cannot shard and
    is dropped."""
    axes = list(spec) + [None] * (ndim - len(spec))
    axes[ndim - 2] = None
    return P(*axes)


#: Token batches shard over every data-ish axis; the sequence is not split
#: here (its length is S+1) but in the model, whose activations ring
#: attention takes sequence-sharded over sp.
BATCH_SPEC = P(("dp", "fsdp"))


def _attn_specs() -> dict:
    """Shared attention-projection shardings (dense and MoE models)."""
    return {
        "wq": P("fsdp", "tp"),
        "wk": P("fsdp", "tp"),
        "wv": P("fsdp", "tp"),
        "wo": P("tp", "fsdp"),
    }


def _backbone_specs(cfg, layer: dict) -> dict:
    return {
        "embed": P("tp", "fsdp"),
        "layers": [layer for _ in range(cfg.n_layers)],
        "final_norm": P(),
        "lm_head": P("fsdp", "tp"),
    }


def llama_param_specs(cfg) -> dict:
    """Specs matching ``init_params``' tree: tp over heads/ffn/vocab, fsdp
    over the other matmul axis (ZeRO-3), norms replicated."""
    layer = {
        "attn": _attn_specs(),
        "mlp": {
            "w_gate": P("fsdp", "tp"),
            "w_up": P("fsdp", "tp"),
            "w_down": P("tp", "fsdp"),
        },
        "attn_norm": P(),
        "mlp_norm": P(),
    }
    return _backbone_specs(cfg, layer)


def mixtral_param_specs(cfg) -> dict:
    """Specs for the Mixtral tree: experts over ep on their stacked leading
    axis, inner matmul dims over tp/fsdp as in the dense model, the router
    replicated."""
    layer = {
        "attn": _attn_specs(),
        "moe": {
            "router": P(),
            "w_gate": P("ep", "fsdp", "tp"),
            "w_up": P("ep", "fsdp", "tp"),
            "w_down": P("ep", "tp", "fsdp"),
        },
        "attn_norm": P(),
        "moe_norm": P(),
    }
    return _backbone_specs(cfg, layer)


def param_specs(cfg) -> dict:
    """The spec tree of ``cfg``'s model: Mixtral's for a MoE config (one
    with ``n_experts``), Llama's otherwise."""
    if hasattr(cfg, "n_experts"):
        return mixtral_param_specs(cfg)
    return llama_param_specs(cfg)


def check_divisibility(cfg, mesh) -> None:
    """Fail fast on shardings the model shapes cannot honor (``mesh``: a
    DeviceMesh, or a dict of axis sizes)."""
    tp = axis_sizes(mesh)["tp"]
    problems = []
    if cfg.n_heads % tp:
        problems.append(f"n_heads {cfg.n_heads} % tp {tp}")
    if cfg.n_kv_heads % tp:
        problems.append(f"n_kv_heads {cfg.n_kv_heads} % tp {tp}")
    if cfg.ffn_dim % tp:
        problems.append(f"ffn_dim {cfg.ffn_dim} % tp {tp}")
    if cfg.vocab_size % tp:
        problems.append(f"vocab {cfg.vocab_size} % tp {tp}")
    if problems:
        raise ValueError("indivisible sharding: " + ", ".join(problems))


def check_moe_divisibility(cfg, mesh) -> None:
    """The dense checks, plus ep over the experts."""
    ep = axis_sizes(mesh)["ep"]
    if cfg.n_experts % ep:
        raise ValueError(f"indivisible sharding: n_experts {cfg.n_experts} % ep {ep}")
    check_divisibility(cfg, mesh)


def placements_for(mesh: DeviceMesh, spec: P, ndim: int) -> list:
    """DTensor placements of a tensor of ``ndim`` dims under ``spec``: for
    each mesh axis, ``Shard(d)`` when dim ``d`` names it, else
    ``Replicate()``. A dim split over several axes is split outermost first,
    as DTensor splits over mesh dims in mesh order, so its axes must come
    in mesh order."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec!r} has more entries than {ndim} dims")
    names = list(mesh.mesh_dim_names)
    dim_of = {}
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec!r} splits dim {d} over {axes}, "
                             f"out of the mesh's order {names}")
        for a in axes:
            if a in dim_of:
                raise ValueError(f"spec {spec!r} names axis {a!r} twice")
            dim_of[a] = d
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in names]


def spec_leaves(specs, params) -> list:
    """The spec of each leaf of ``params``, in ``leaves(params)``'s order
    (matched by key and index, whatever order either tree's dicts keep)."""
    out = []
    map_tree(lambda _, spec: out.append(spec), params, specs)
    return out


# -- collectives with their transposes ---------------------------------------

def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _GatherAtUse(torch.autograd.Function):
    """All-gather along ``dim``; backward: reduce-scatter (the sum of every
    rank's gradient of the whole, each rank keeping its own slice)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _Copy(torch.autograd.Function):
    """Identity; backward: all-reduce. Enters a tp-split computation whose
    input every rank holds whole (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce; backward: identity. Leaves a tp-split computation whose
    partial sums every rank needs whole (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    """All-reduce; backward: all-reduce. Sums per-rank shares of a value
    that every rank then uses in its own share of the loss (JAX's
    ``psum``, whose transpose is ``psum``): the gradient of the sum is
    the sum of every rank's gradient of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class Shards:
    """What a model running on local shards needs of a mesh: each axis's
    group, size and this process's rank on it, the parameter specs, and the
    collectives nanotpu leaves to XLA. Every rank issues the same
    collectives in the same order (the same code on same-shaped shards), as
    a group's collectives require."""

    def __init__(self, mesh: DeviceMesh, specs, split_tokens: bool = True):
        self.mesh = mesh
        self.specs = specs
        self.size = axis_sizes(mesh)
        self.group = {a: mesh.get_group(a) for a in AXES}
        self.rank = {a: mesh.get_local_rank(a) for a in AXES}
        #: whether the model's tokens are split over the data axes (rows
        #: over dp and fsdp, the sequence over sp), as in training; an
        #: inference mesh holds every row whole on every rank
        self.split_tokens = split_tokens

    # -- parameters: fsdp gathered at use --------------------------------
    def use(self, params, specs):
        """``params`` (local shards) with every leaf whose spec names fsdp
        all-gathered over fsdp along that dim: the weight whole on fsdp,
        still split over tp. Over an fsdp group of one the gather is the
        identity (and its reduce-scatter too) and is skipped: it would
        copy every weight at each use."""
        if self.size["fsdp"] == 1:
            return params

        def one(w, spec):
            for d, entry in enumerate(spec):
                if "fsdp" in _entry_axes(entry):
                    return _GatherAtUse.apply(w, d, self.group["fsdp"])
            return w
        return map_tree(one, params, specs)

    # -- tensor parallel ---------------------------------------------------
    def tp_in(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.group["tp"])

    def tp_out(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group["tp"])

    def embed(self, table, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
        """Rows of a vocab-split table: each rank looks up the tokens in its
        vocab slice, zeros the others, and the sum over tp holds them all.
        An int8 table (``QArray``) gives rows in ``dtype``, as
        :func:`~nanotpu_torch.models.quant.embedding_lookup` does."""
        rows = table.shape[0]
        lo = self.rank["tp"] * rows
        local = tokens.long() - lo
        hit = (local >= 0) & (local < rows)
        x = embedding_lookup(table, local.clamp(0, rows - 1), dtype)
        return self.tp_out(torch.where(hit[..., None], x, torch.zeros_like(x)))

    def gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """``x`` all-gathered over ``axis`` along ``dim``, in rank order (no
        autograd: the serving path's logits)."""
        return _gather(x, dim % x.dim(), self.group[axis])

    # -- expert parallel -----------------------------------------------------
    def experts(self, n_experts: int) -> slice:
        """This rank's slice of the stacked expert axis."""
        n = n_experts // self.size["ep"]
        return slice(self.rank["ep"] * n, (self.rank["ep"] + 1) * n)

    def ep_in(self, x: torch.Tensor) -> torch.Tensor:
        """Enter this rank's experts with ``x`` every ep rank holds whole:
        identity, whose gradient (each rank's, from its own experts) sums
        over ep."""
        return _Copy.apply(x, self.group["ep"])

    def ep_out(self, x: torch.Tensor) -> torch.Tensor:
        """Leave the experts: each rank's partial sum over its own experts,
        all-reduced over ep; its gradient every rank has whole."""
        return _Reduce.apply(x, self.group["ep"])

    # -- the global token set (MoE routing) --------------------------------
    def all_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [B, S, ...] of this rank's rows and sequence block as the
        global [B * dp * fsdp, S * sp, ...], rows in BATCH_SPEC's order (dp
        outermost) and the sequence in sp's; backward: every rank's
        gradient of the whole summed, each keeping its own block (the
        reduce-scatter)."""
        x = _GatherAtUse.apply(x, 1, self.group["sp"])
        for a in ("fsdp", "dp"):
            x = _GatherAtUse.apply(x, 0, self.group[a])
        return x

    def own_tokens(self, x: torch.Tensor, B: int, S: int) -> torch.Tensor:
        """This rank's [B * S, ...] token block of ``x`` [T_global, ...] in
        the global token order of :meth:`all_tokens` (t = b * S_global +
        s)."""
        row = (self.rank["dp"] * self.size["fsdp"] + self.rank["fsdp"]) * B
        col = self.rank["sp"] * S
        rest = x.shape[1:]
        whole = x.reshape(-1, S * self.size["sp"], *rest)
        return whole[row:row + B, col:col + S].reshape(B * S, *rest)

    def sum_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, this rank's share of a sum over the global tokens, summed
        over the axes that split them (backward: the same sum, as
        :class:`_Psum`). Without split tokens, ``x`` itself."""
        if not self.split_tokens:
            return x
        for a in DATA_AXES:
            x = _Psum.apply(x, self.group[a])
        return x

    # -- pipeline ------------------------------------------------------------
    def pp_in(self, x: torch.Tensor) -> torch.Tensor:
        """Enter a pipeline every pp rank holds ``x`` for: identity, whose
        gradient sums over pp (only the first stage's is not zero)."""
        return _Copy.apply(x, self.group["pp"])

    def pp_out(self, x: torch.Tensor) -> torch.Tensor:
        """Leave a pipeline: the sum over pp of each rank's ``x`` (zeros but
        on the last stage), whose gradient every rank has whole."""
        return _Reduce.apply(x, self.group["pp"])

    def nll_sum(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Summed next-token NLL of ``logits`` [N, V/tp] f32 (this rank's
        vocab slice) against global ``targets`` [N]: the log-sum-exp and the
        target's logit summed over tp, every rank getting the whole loss."""
        with torch.no_grad():
            m = logits.amax(-1)
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group["tp"])
        total = self.tp_out(torch.exp(logits - m[:, None]).sum(-1))
        rows = logits.shape[-1]
        local = targets.long() - self.rank["tp"] * rows
        hit = (local >= 0) & (local < rows)
        picked = logits.gather(-1, local.clamp(0, rows - 1)[:, None])[:, 0]
        picked = self.tp_out(torch.where(hit, picked, torch.zeros_like(picked)))
        return (m + torch.log(total) - picked).sum()

    # -- the step's batch: rows over dp and fsdp, the sequence over sp -----
    def rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global batch ``tokens`` [B, ...] that
        every process holds, by BATCH_SPEC (dp outermost, then fsdp): a
        view, so a captured step reads them from the batch's buffer."""
        n = self.size["dp"] * self.size["fsdp"]
        if tokens.shape[0] % n:
            raise ValueError(f"batch {tokens.shape[0]} does not split over "
                             f"dp*fsdp = {n}")
        B = tokens.shape[0] // n
        row = (self.rank["dp"] * self.size["fsdp"] + self.rank["fsdp"]) * B
        return tokens[row:row + B]

    def seq_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous sp slice of dim 1."""
        n, r = self.size["sp"], self.rank["sp"]
        S = x.shape[1]
        if S % n:
            raise ValueError(f"sequence {S} does not split into sp {n}")
        return x[:, r * S // n:(r + 1) * S // n]

    # -- the step's reductions -------------------------------------------------
    def token_shards(self) -> int:
        return math.prod(self.size[a] for a in DATA_AXES)

    def sum_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over every data axis (the loss of the global batch
        from each rank's share)."""
        for a in DATA_AXES:
            x = _all_reduce(x, self.group[a])
        return x

    def reduce_grads(self, grads: list, specs: list) -> list:
        """Each local gradient summed over every data axis its parameter's
        spec does not shard (fsdp's sum came with the reduce-scatter); one
        flat all-reduce per axis and dtype."""
        grads = [g.contiguous() for g in grads]
        for a in DATA_AXES:
            todo = [g for g, s in zip(grads, specs) if a not in s.axes()]
            for dtype in sorted({g.dtype for g in todo}, key=str):
                same = [g for g in todo if g.dtype == dtype]
                flat = torch.cat([g.reshape(-1) for g in same])
                dist.all_reduce(flat, group=self.group[a])
                off = 0
                for g in same:
                    g.copy_(flat[off:off + g.numel()].view_as(g))
                    off += g.numel()
        return grads

    def global_norm(self, grads: list, specs: list) -> torch.Tensor:
        """The L2 norm of the whole gradient tree, every element counted
        once: each shard's squared sum over its parameter's copies (the
        product of the axes its spec does not shard), summed over the
        world."""
        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for g, s in zip(grads, specs):
            named = s.axes()
            copies = math.prod(n for a, n in self.size.items() if a not in named)
            total = total + (g.float() ** 2).sum() / copies
        dist.all_reduce(total)
        return total.sqrt()


def local(tree):
    """The local shards of a tree of DTensors (plain tensors pass), the
    tensors the DTensors hold: an in-place update of one updates its
    DTensor."""
    with torch.no_grad():
        return map_tree(lambda t: t.to_local() if isinstance(t, DTensor)
                        else t, tree)

