"""Training on one device: loss -> gradients -> clipped AdamW, the port of
``nanotpu/parallel/train.py``.

A step is ``loss_fn`` (the Llama chunked cross entropy by default;
``--model mixtral`` trains the MoE model on
:func:`nanotpu_torch.models.mixtral.loss_fn`), ``torch.autograd.grad`` over
the parameter tree's leaves, then :class:`AdamW`, which updates parameters,
moments and its device step count in place (nanotpu's jitted step donates
its state; in place is the eager counterpart and holds one copy of each).
One step a call runs eagerly. ``n_fused`` steps a call (``--fuse-steps``,
nanotpu's ``lax.scan`` over a token block) replay one step captured as a
CUDA graph on a card (:class:`GraphedTrainStep`), and run the same body
eagerly on the CPU. ``--profile-dir`` traces the steady-state calls with
``torch.profiler``. An eager step is a ``train.step`` span
(:mod:`nanotpu_torch.metrics.spans`) over ``train.forward`` (the loss),
``train.backward`` (the gradients, summed over a mesh) and
``train.optimizer`` (clipping and AdamW); a replayed graph is one
``train.step`` with nothing inside.

On a mesh (``build_train_step(..., mesh=...)``; the CLI's ``--dp --fsdp
--tp --sp --ep --pp`` in a job of several processes, :mod:`.distributed`)
the state is placed as DTensors by nanotpu's PartitionSpecs
(:func:`place_state`), and each rank runs the model on its shards
(:class:`.mesh.Shards`), sums the gradients over the data axes each
parameter is not split on, clips by the global norm and updates its shards
in place. Mixtral's experts split over ``ep`` (their gradients stay with
their rank); its routing is global over the step's tokens. ``--pp`` > 1
trains nanotpu's stacked tree through the GPipe pipeline (:mod:`.pipeline`,
``--microbatches`` of them), Llama's or Mixtral's. ``--fuse-steps`` takes
any of these meshes: on a card each step replays one CUDA graph of the
sharded step, its NCCL collectives captured in it.

Run:  python -m nanotpu_torch.parallel.train --preset flagship --attn flash
      --seq 2049 --batch 8 --data markov --steps 24 --fuse-steps 8
      (one CUDA card)
      JOB_COMPLETION_INDEX=i GANG_SIZE=4 COORDINATOR_SERVICE=host:port \
      python -m nanotpu_torch.parallel.train --fsdp 2 --tp 2 ...
      (one process a card, i = 0..3)
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import os
import time
from collections import deque
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from nanotpu_torch import resolve_device
from nanotpu_torch.metrics import spans
from nanotpu_torch.models import llama, mixtral
from nanotpu_torch.ops import attention
from nanotpu_torch.parallel import distributed, pipeline
from nanotpu_torch.parallel.mesh import (
    P,
    Shards,
    check_divisibility,
    check_moe_divisibility,
    local,
    make_mesh,
    mesh_size_error,
    param_specs as model_param_specs,
    placements_for,
    spec_leaves,
)
from nanotpu_torch.tree import leaves, map_tree

log = logging.getLogger("nanotpu_torch.train")


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``chain(clip_by_global_norm(max_norm), adamw(...))``:
    gradients scaled by ``max_norm / norm`` only when their global norm is
    at least ``max_norm``, then Adam with bias correction and decoupled
    weight decay on every leaf. Moments live in the parameter's dtype, the
    first in ``mu_dtype`` when one is given. The global norm is summed in
    f32 whatever the gradients' dtype."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_norm: float = 1.0
    mu_dtype: torch.dtype | None = None

    def init(self, params) -> dict:
        """Zeroed moments and an int32 step count (optax's), all on the
        parameters' device."""
        return {
            "count": torch.zeros((), dtype=torch.int32,
                                 device=leaves(params)[0].device),
            "mu": map_tree(lambda p: torch.zeros_like(
                p, dtype=self.mu_dtype or p.dtype, requires_grad=False), params),
            "nu": map_tree(lambda p: torch.zeros_like(
                p, requires_grad=False), params),
        }

    @torch.no_grad()
    def update(self, grads, opt_state: dict, params, norm=None):
        """Apply one step to ``params`` and ``opt_state`` in place, from
        ``grads`` (the parameters' leaves' gradients, in order); returns
        both. ``norm`` is the gradients' global norm, taken from ``grads``
        unless given (a mesh's, over every shard). Nothing leaves the
        device: the count, the bias corrections and the clip decision are
        tensors, so a captured step replays every one of them."""
        ps, mus, nus = leaves(params), leaves(opt_state["mu"]), leaves(opt_state["nu"])
        grads = list(grads)
        if norm is None:
            norm = torch.stack([(g.float() ** 2).sum() for g in grads]).sum().sqrt()
        keep = norm < self.max_norm
        count = opt_state["count"]
        count.add_(1)
        corrections = bias_corrections(count, self.b1, self.b2)
        cast = {}  # (which, dtype) -> that correction in that dtype
        for p, g, mu, nu in zip(ps, grads, mus, nus):
            g = torch.where(keep, g, (g / norm.to(g.dtype)) * self.max_norm)
            m = (1 - self.b1) * g + self.b1 * mu
            v = (1 - self.b2) * (g * g) + self.b2 * nu
            mu.copy_(m.to(mu.dtype))
            nu.copy_(v)
            # m / bc1 and v / bc2 in place, each correction in the moment's
            # dtype: a 0-d CUDA tensor costs a plain binary op its
            # vectorized kernel, where a foreach op reads it on the device
            for which, t in enumerate((m, v)):
                key = (which, t.dtype)
                if key not in cast:
                    cast[key] = corrections[which].to(t.dtype)
                torch._foreach_div_([t], cast[key])
            u = m / (torch.sqrt(v) + self.eps)
            u = -self.lr * (u + self.weight_decay * p)
            p.copy_((p + u).to(p.dtype))
        return params, opt_state


def bias_corrections(count: torch.Tensor, b1: float, b2: float):
    """``1 - b ** count`` for both decays as f32 tensors on the count's
    device (a moment divides by its correction in its own dtype, as optax's
    ``astype`` does). Taken in f64 from the f32 decay and rounded once to
    f32: the value the host computed in numpy when the count lived there.
    A f32 ``pow`` kernel is exact only to an ulp or two of ``b ** count``,
    and the subtraction from 1 magnifies that several times."""
    t = count.double()
    return tuple((1 - float(np.float32(b)) ** t).float() for b in (b1, b2))


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                   mu_dtype: torch.dtype | None = None) -> AdamW:
    """AdamW (b1 0.9, b2 0.95, eps 1e-8) with global-norm clipping at 1.0."""
    return AdamW(lr=lr, weight_decay=weight_decay, mu_dtype=mu_dtype)


def init_train_state(generator: torch.Generator, cfg, optimizer: AdamW,
                     device=None, init_fn: Callable | None = None) -> TrainState:
    """Fresh parameters from ``init_fn(cfg, generator, device=device)``
    (Llama's ``init_params`` by default) on ``device`` (``cuda`` unless
    named), ready for autograd, with zeroed moments."""
    params = (init_fn or llama.init_params)(cfg, generator, device=device)
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params, optimizer.init(params), 0)


def build_train_step(
    cfg, optimizer: AdamW, loss_fn: Callable | None = None, n_fused: int = 1,
    *, mesh=None, param_specs=None,
) -> Callable[[TrainState, torch.Tensor], tuple[TrainState, torch.Tensor]]:
    """(state, tokens) -> (state, loss), nanotpu's signature. With
    ``n_fused == 1``, tokens [B, S+1] and one eager optimizer step; with
    ``n_fused > 1``, tokens [n_fused, B, S+1] and that many steps in one
    call (:class:`FusedTrainStep`), returning the last step's loss. The
    state's tensors are updated in place; the loss is detached and stays
    on the device.

    With ``mesh`` (any size, one included) the step's body is the sharded
    one, :func:`mesh_train_body`, on a state from :func:`place_state`: the
    Llama or the Mixtral loss (``cfg``'s specs unless ``param_specs`` are
    given), or a pipelined one (:func:`.pipeline.make_pipelined_loss`, on
    the stacked tree placed by :func:`.pipeline.pp_param_specs`); fused,
    each of its steps is that body."""
    if n_fused < 1:
        raise ValueError(f"n_fused must be at least 1, not {n_fused}")
    if mesh is not None:
        if not (loss_fn in (None, llama.loss_fn, mixtral.loss_fn)
                or isinstance(loss_fn, pipeline.PipelinedLoss)):
            raise ValueError("a mesh trains the Llama or Mixtral loss, or a "
                             "pipelined one: a loss that takes a mesh's "
                             "shards")
        body = mesh_train_body(cfg, optimizer, mesh,
                               param_specs or model_param_specs(cfg),
                               loss_fn or llama.loss_fn)
    else:
        loss_fn = loss_fn or llama.loss_fn

        def body(params, opt_state, tokens: torch.Tensor) -> torch.Tensor:
            with spans.span("train.step"):
                ps = leaves(params)
                for p in ps:
                    if not p.requires_grad:
                        p.requires_grad_(True)
                with spans.span("train.forward"):
                    loss = loss_fn(params, tokens, cfg)
                with spans.span("train.backward"):
                    grads = torch.autograd.grad(loss, ps)
                with spans.span("train.optimizer"):
                    optimizer.update(grads, opt_state, params)
                return loss.detach()

    if n_fused > 1:
        return FusedTrainStep(body, n_fused)

    def step_fn(state: TrainState, tokens: torch.Tensor):
        loss = body(state.params, state.opt_state, tokens)
        return TrainState(state.params, state.opt_state, state.step + 1), loss

    return step_fn


def mesh_train_body(cfg, optimizer: AdamW, mesh, specs,
                    loss_fn: Callable = llama.loss_fn):
    """``body(params, opt_state, tokens [B, S+1]) -> loss``, one step on
    ``mesh``: ``params`` and ``opt_state`` are trees of DTensors (or their
    local shards), and every process passes the same global batch and
    keeps its rows by BATCH_SPEC, a view; the model runs on this rank's
    shards (``loss_fn(params, rows, cfg, shard=...)``, this rank's share
    of the mean); each gradient sums over the data axes its parameter is
    not split on (fsdp's by the reduce-scatter of the gather at use);
    AdamW clips by the norm of the whole gradient tree and updates the
    local shards in place, so every DTensor keeps its placements. The loss
    returned is the global batch's, on every rank. Nothing in it reads
    the device from the host, so a card captures it as a CUDA graph."""
    shards = Shards(mesh, specs)

    def body(params, opt_state, tokens: torch.Tensor) -> torch.Tensor:
        with spans.span("train.step"):
            params, opt_state = local(params), local(opt_state)
            ps, flat_specs = leaves(params), spec_leaves(specs, params)
            for p in ps:
                p.requires_grad_(True)
            with spans.span("train.forward"):
                loss = loss_fn(params, shards.rows(tokens), cfg, shard=shards)
            with spans.span("train.backward"):
                grads = shards.reduce_grads(torch.autograd.grad(loss, ps),
                                            flat_specs)
            with spans.span("train.optimizer"):
                optimizer.update(grads, opt_state, params,
                                 norm=shards.global_norm(grads, flat_specs))
            return shards.sum_over_data(loss.detach())

    return body


def place_state(state: TrainState, cfg, mesh,
                param_specs=None) -> TrainState:
    """``state`` (whole tensors, the same on every process) as DTensors on
    ``mesh``: parameters by spec (``cfg``'s model's unless given), each
    AdamW moment placed like its parameter, the count replicated. Process
    0's tensors are scattered."""
    specs = param_specs or model_param_specs(cfg)

    def put(t, spec):
        return distribute_tensor(t.detach(), mesh,
                                 placements_for(mesh, spec, t.dim()))

    opt = state.opt_state
    return TrainState(
        map_tree(put, state.params, specs),
        {"count": put(opt["count"], P()),
         "mu": map_tree(put, opt["mu"], specs),
         "nu": map_tree(put, opt["nu"], specs)},
        state.step)


#: the kernel wrappers whose host-side ``launches`` a graphed step keeps
#: exact
_COUNTED = (attention.flash_attention, attention.flash_bwd_fused,
            attention.flash_bwd_dq, attention.flash_bwd_dkv)


class GraphedTrainStep:
    """``body(tokens)``, one optimizer step that reads the token buffer
    ``tokens`` [B, S+1] and updates fixed parameter, moment and count
    tensors in place, run as a CUDA graph: the port's counterpart of the
    body of nanotpu's ``lax.scan``.

    :meth:`step` copies a batch into ``tokens``. The first ``WARMUP_STEPS``
    steps run the body eagerly on a side stream, as capture requires
    (cuBLAS and autograd set up their per-stream state there); they are
    the run's own first steps, not extra ones. The next step captures the
    body on that stream into a private pool, which executes nothing, then
    replays it; every later step replays. The last step's loss is in
    ``loss``, which the next step overwrites. A failed capture or replay
    raises: nothing falls back to eager steps.

    The kernel wrappers count launches on the host, where a replay does
    not pass: capture's counts are taken back, and each replay adds the
    launches one step made (``launches_per_replay``). ``capture_s`` is the
    capture's time, ``replays`` counts replays."""

    WARMUP_STEPS = 2

    def __init__(self, body: Callable[[torch.Tensor], torch.Tensor],
                 tokens_like: torch.Tensor):
        self.body = body
        self.tokens = torch.empty_like(tokens_like)
        self.loss = torch.zeros((), dtype=torch.float32,
                                device=tokens_like.device)
        self.stream = torch.cuda.Stream(tokens_like.device)
        self.graph = None
        self.warmup_steps = self.replays = 0
        self.capture_s = None
        self.launches_per_replay = None

    def step(self, tokens: torch.Tensor) -> None:
        self.tokens.copy_(tokens)
        if self.graph is None and self.warmup_steps < self.WARMUP_STEPS:
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                self.loss.copy_(self.body(self.tokens))
            torch.cuda.current_stream().wait_stream(self.stream)
            self.warmup_steps += 1
            return
        if self.graph is None:
            self._capture()
        with spans.span("train.step"):
            self.graph.replay()
        self.replays += 1
        for fn, n in zip(_COUNTED, self.launches_per_replay):
            fn.launches += n

    def _capture(self) -> None:
        t0 = time.perf_counter()
        before = [fn.launches for fn in _COUNTED]
        graph = torch.cuda.CUDAGraph()
        # a collection during capture that frees a dead CUDA graph (an
        # engine's, say) destroys it there, which invalidates the capture:
        # collect now and not again until the capture ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: another thread's CUDA calls (a serving engine's
            # in the same process) do not touch this capture's stream
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                self.loss.copy_(self.body(self.tokens))
        finally:
            if collecting:
                gc.enable()
        self.launches_per_replay = [fn.launches - n
                                    for fn, n in zip(_COUNTED, before)]
        for fn, n in zip(_COUNTED, before):
            fn.launches = n
        self.graph = graph
        self.capture_s = time.perf_counter() - t0


class FusedTrainStep:
    """(state, tokens [n_fused, B, S+1]) -> (state, loss): ``n_fused``
    optimizer steps in one call, the state's step advanced by ``n_fused``
    and the last step's loss returned (a copy, detached, on the device).

    On a card every step is one :class:`GraphedTrainStep` replay
    (``graphed``), bound to the state of the first call: a call with
    other tensors raises. On the CPU the same body runs eagerly, step
    after step."""

    def __init__(self, body: Callable, n_fused: int):
        self.body = body
        self.n_fused = n_fused
        self.graphed: GraphedTrainStep | None = None
        self._bound: list = []

    def __call__(self, state: TrainState, tokens: torch.Tensor):
        if tokens.dim() != 3 or tokens.shape[0] != self.n_fused:
            raise ValueError(f"want tokens [{self.n_fused}, B, S+1], got "
                             f"{tuple(tokens.shape)}")
        tensors = leaves(state.params) + leaves(state.opt_state)
        if tensors[0].device.type != "cuda":
            for row in tokens:
                loss = self.body(state.params, state.opt_state, row)
        else:
            if self.graphed is None:
                self.graphed = GraphedTrainStep(
                    lambda t: self.body(state.params, state.opt_state, t),
                    tokens[0])
                self._bound = tensors
            elif len(tensors) != len(self._bound) or any(
                    a is not b for a, b in zip(tensors, self._bound)):
                raise ValueError("a fused step is bound to the tensors of "
                                 "the state it first ran on")
            for row in tokens:
                self.graphed.step(row)
            loss = self.graphed.loss.clone()
        return (TrainState(state.params, state.opt_state,
                           state.step + self.n_fused), loss)


# -- checkpoint / resume ---------------------------------------------------

def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank (a collective), a plain tensor
    as it is; detached."""
    with torch.no_grad():
        return t.full_tensor() if isinstance(t, DTensor) else t.detach()


def save_checkpoint(ckpt_dir: str, state: TrainState) -> None:
    """``<ckpt_dir>/step_<N>/state.pt`` with torch.save, written to a
    temporary name first so a crash leaves no half-written checkpoint. A
    state on a mesh is gathered whole (every process calls this) and
    process 0 writes it."""
    blob = {
        "params": map_tree(_whole, state.params),
        "opt_state": map_tree(_whole, state.opt_state),
        "step": state.step,
    }
    if not dist.is_initialized() or dist.get_rank() == 0:
        path = _ckpt_path(ckpt_dir, state.step)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f"state.pt.{os.getpid()}.tmp")
        torch.save(blob, tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))
    if dist.is_initialized():
        dist.barrier()


def restore_checkpoint(ckpt_dir: str, like: TrainState) -> TrainState | None:
    """The newest ``step_<N>`` under ``ckpt_dir``, placed on the device, in
    the dtypes and (for DTensors) on the mesh and placements of ``like``'s
    leaves; None when there is none."""
    steps = []
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            if (name.startswith("step_") and name[5:].isdigit()
                    and os.path.exists(os.path.join(ckpt_dir, name, "state.pt"))):
                steps.append(int(name[5:]))
    if not steps:
        return None
    blob = torch.load(os.path.join(_ckpt_path(ckpt_dir, max(steps)), "state.pt"),
                      map_location="cpu", weights_only=True)

    def place(saved, want):
        t = saved.to(device=want.device, dtype=want.dtype)
        if isinstance(want, DTensor):
            return distribute_tensor(t, want.device_mesh, want.placements)
        return t.requires_grad_(want.requires_grad)

    params = map_tree(place, blob["params"], like.params)
    opt = like.opt_state
    # a checkpoint written before the count moved to the device holds an int
    count = torch.as_tensor(blob["opt_state"]["count"], dtype=torch.int32)
    opt_state = {
        "count": place(count, opt["count"]),
        "mu": map_tree(place, blob["opt_state"]["mu"], opt["mu"]),
        "nu": map_tree(place, blob["opt_state"]["nu"], opt["nu"]),
    }
    return TrainState(params, opt_state, blob["step"])


# -- CLI ---------------------------------------------------------------------

_PRESETS = {
    ("llama", "tiny"): dict(
        vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
        ffn_dim=256, max_seq_len=256, dtype="float32",
    ),
    # the training flagship (nanotpu's __graft_entry__._flagship_config)
    ("llama", "flagship"): dict(
        vocab_size=32_768, dim=1024, n_layers=8, n_heads=16, n_kv_heads=4,
        ffn_dim=4096, max_seq_len=2048, dtype="bfloat16",
    ),
    ("llama", "flagship-hd128"): dict(
        vocab_size=32_768, dim=1024, n_layers=8, n_heads=8, n_kv_heads=2,
        ffn_dim=4096, max_seq_len=2048, dtype="bfloat16",
    ),
    ("llama", "8b"): dict(
        vocab_size=128_256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_dim=14_336, max_seq_len=8192, dtype="bfloat16",
    ),
    ("mixtral", "tiny"): dict(
        vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
        ffn_dim=256, n_experts=4, top_k=2, max_seq_len=256, dtype="float32",
    ),
    ("mixtral", "8x7b"): dict(
        vocab_size=32_000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_dim=14_336, n_experts=8, top_k=2, max_seq_len=8192,
        dtype="bfloat16",
    ),
}


def _auto_mesh_factors(n: int, model: str) -> dict[str, int]:
    """nanotpu's default factorization of the device count: MoE prefers an
    ep axis, dense prefers fsdp x tp."""
    if model == "mixtral":
        ep = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
        return {"dp": n // ep, "ep": ep}
    for tp in (4, 2, 1):
        if n % tp:
            continue
        rest = n // tp
        for fsdp in (4, 2, 1):
            if rest % fsdp == 0:
                return {"dp": rest // fsdp, "fsdp": fsdp, "tp": tp}
    raise AssertionError("unreachable: tp=1/fsdp=1 divides any n")


def _stacked(init: Callable) -> Callable:
    def stacked_init(cfg, generator, device=None):
        return pipeline.stack_layers(init(cfg, generator, device=device))
    return stacked_init


def _parser():
    import argparse

    p = argparse.ArgumentParser(description="nanotpu_torch trainer")
    p.add_argument("--model", choices=["llama", "mixtral"], default="llama")
    p.add_argument("--preset", default="tiny")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=0, help="0 = 2")
    p.add_argument("--seq", type=int, default=0,
                   help="0 = min(preset max_seq_len, 512); the model sees "
                        "seq-1 tokens after the loss shift")
    p.add_argument("--dp", type=int, default=0,
                   help="0 = auto factorize the processes")
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1,
                   help=">1 switches attention to the sp ring")
    p.add_argument("--ep", type=int, default=1,
                   help="expert parallelism: Mixtral's experts split over ep")
    p.add_argument("--pp", type=int, default=1,
                   help=">1 pipelines the layers over pp stages")
    p.add_argument("--microbatches", type=int, default=0,
                   help="pipeline microbatches (0 = 2*pp)")
    p.add_argument("--attn", choices=["dense", "flash", "ring"], default="",
                   help="attention: flash = the CUDA kernels; ring (over sp, "
                        "each block through them) is implied by --sp")
    p.add_argument("--remat", action="store_true",
                   help="recompute layer activations in backward")
    p.add_argument("--remat-policy", choices=["full", "dots"], default="full",
                   help="with --remat: 'dots' keeps matmul outputs")
    p.add_argument("--bf16-momentum", action="store_true",
                   help="keep Adam's first moment in bfloat16")
    p.add_argument("--fuse-steps", type=int, default=1,
                   help="optimizer steps per call: on a card one step "
                        "captured as a CUDA graph and replayed")
    p.add_argument("--profile-dir", default="",
                   help="torch.profiler trace of the steady-state calls "
                        "(TensorBoard format; needs --steps >= 2x "
                        "--fuse-steps, the first call is left out)")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data", choices=["random", "markov", "file"],
                   default="random",
                   help="'random' = uniform tokens; 'markov' = the seeded "
                        "synthetic chain (nanotpu_torch.data); 'file' = a "
                        "flat token file (--data-path)")
    p.add_argument("--data-seed", type=int, default=0)
    p.add_argument("--data-path", default="")
    p.add_argument("--data-dtype", choices=["uint16", "uint32"],
                   default="uint16")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


class _LaggedLosses:
    """Step losses logged one step behind: on a card, each loss is copied
    to pinned host memory behind an event, and reading it waits for that
    event only, not for the step in flight."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pending: deque = deque()
        self.logged: list[tuple[int, float]] = []

    def push(self, step: int, loss: torch.Tensor) -> None:
        if self.cuda:
            host = torch.empty((), dtype=loss.dtype, pin_memory=True)
            host.copy_(loss, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self.pending.append((step, host, ev))
        else:
            self.pending.append((step, loss, None))
        while len(self.pending) > 1:
            self._log(*self.pending.popleft())

    def flush(self) -> None:
        while self.pending:
            self._log(*self.pending.popleft())

    def _log(self, step, value, ev) -> None:
        if ev is not None:
            ev.synchronize()
        loss = float(value)
        self.logged.append((step, loss))
        log.info("step %d loss %.4f", step, loss)


def _start_profiler(profile_dir: str, device: torch.device):
    """A started ``torch.profiler`` (CPU activity, and CUDA on a card) whose
    stop writes a TensorBoard trace into ``profile_dir``."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))
    prof.start()
    return prof


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv: list[str] | None = None) -> dict:
    """Parse ``argv`` and train. Returns the logged (step, loss) pairs,
    steady-state tokens/s (None with one call), the device, the mesh's
    axis sizes, the final state and the step function (``FusedTrainStep``
    with ``--fuse-steps`` > 1).

    A process of a gang (:func:`.distributed.process_info_from_env`) joins
    its job first and leaves it at the end; a job of one process trains
    with the plain step."""
    parser = _parser()
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    joined = distributed.initialize(device=device)
    try:
        return _run(parser, args, distributed.local_device(device))
    finally:
        if joined:
            dist.destroy_process_group()


def _run(parser, args, device: torch.device) -> dict:
    fuse = max(1, args.fuse_steps)
    if args.steps % fuse:
        parser.error(f"--steps {args.steps} must be a multiple of "
                     f"--fuse-steps {fuse}")
    key = (args.model, args.preset)
    if key not in _PRESETS:
        parser.error(f"no preset {key}; have {sorted(_PRESETS)}")
    if args.sp > 1 and args.attn and args.attn != "ring":
        parser.error(
            f"--attn {args.attn} conflicts with --sp {args.sp}: sequence "
            "parallelism requires the ring implementation")
    preset = dict(_PRESETS[key])
    if args.attn:
        preset["attn_impl"] = args.attn
    if args.sp > 1:
        preset["attn_impl"] = "ring"
    if args.remat:
        if args.model != "llama":
            parser.error("--remat is wired for the dense llama stack only")
        preset["remat"] = True
        preset["remat_policy"] = args.remat_policy
    if args.model == "llama":
        cfg = llama.LlamaConfig(**preset)
        loss, init = None, None  # build_train_step's and Llama's defaults
    else:
        cfg = mixtral.MixtralConfig(**preset)
        loss, init = mixtral.loss_fn, mixtral.init_params

    world = dist.get_world_size() if dist.is_initialized() else 1
    if (args.dp or args.fsdp > 1 or args.tp > 1 or args.ep > 1 or args.sp > 1
            or args.pp > 1):
        # --dp 0 with explicit parallelism flags: dp absorbs the remainder
        denom = args.fsdp * args.tp * args.ep * args.sp * args.pp
        if world % denom:
            parser.error(f"fsdp*tp*ep*sp*pp={denom} does not divide {world} "
                         "devices")
        factors = {"dp": args.dp or world // denom, "fsdp": args.fsdp,
                   "tp": args.tp, "ep": args.ep, "sp": args.sp, "pp": args.pp}
    else:
        factors = _auto_mesh_factors(world, args.model)
    err = mesh_size_error(**factors, world=world)
    if err:
        parser.error(err)
    mesh = None
    if world > 1:
        try:
            if args.model == "mixtral":
                check_moe_divisibility(cfg, factors)
            else:
                check_divisibility(cfg, factors)
        except ValueError as e:
            parser.error(str(e))
        mesh = make_mesh(**factors, device=device)
    elif cfg.attn_impl == "ring":
        parser.error("--attn ring runs over the sp axis of a mesh: a job of "
                     "more than one process")
    data_shards = factors["dp"] * factors.get("fsdp", 1)
    n_micro = args.microbatches or 2 * args.pp
    batch = args.batch or max(2, data_shards)
    # the batch splits over the dp*fsdp data shards and, pipelined, each
    # shard's rows into n_micro microbatches
    unit = data_shards * (n_micro if args.pp > 1 else 1)
    rounded = -(-batch // unit) * unit
    if rounded != batch:
        log.warning("--batch %d rounded up to %d (must split into %d data "
                    "shards%s)", batch, rounded, data_shards,
                    f" of {n_micro} microbatches" if args.pp > 1 else "")
        batch = rounded
    seq = args.seq or min(cfg.max_seq_len, 512)
    if args.sp > 1:
        # the model sees seq-1 tokens after the loss shift; keep that
        # divisible by sp for the ring's equal sequence shards
        if seq - 1 < args.sp:
            parser.error(
                f"--seq {seq} too short for --sp {args.sp}: the model sees "
                f"seq-1 tokens and needs at least one per sequence shard")
        shrunk = seq - (seq - 1) % args.sp
        if args.seq and shrunk != args.seq:
            log.warning("--seq %d shrunk to %d (seq-1 must divide into %d "
                        "sequence shards)", args.seq, shrunk, args.sp)
        seq = shrunk
    log.info("device %s | mesh %s | %s/%s | batch=%d seq=%d attn=%s", device,
             factors if mesh is not None else None, *key, batch, seq,
             cfg.attn_impl)

    optimizer = make_optimizer(
        mu_dtype=torch.bfloat16 if args.bf16_momentum else None)
    specs = None
    if args.pp > 1:
        pipeline.check_pp_divisibility(cfg, mesh, batch, n_micro)
        # the stacked tree, so that the moments are made for the layout
        # that trains
        init = _stacked(init or llama.init_params)
        specs = pipeline.pp_param_specs(cfg)
        loss = pipeline.make_pipelined_loss(mesh, n_micro, model=args.model)
    state = init_train_state(
        torch.Generator(device=device).manual_seed(args.seed), cfg, optimizer,
        device=device, init_fn=init)
    log.info("params %d", llama.param_count(state.params))
    if mesh is not None:
        state = place_state(state, cfg, mesh, param_specs=specs)
    if args.checkpoint_dir:
        restored = restore_checkpoint(args.checkpoint_dir, state)
        if restored is not None:
            state = restored
            log.info("resumed from step %d", state.step)
    step_fn = build_train_step(cfg, optimizer, loss_fn=loss, n_fused=fuse,
                               mesh=mesh, param_specs=specs)

    # every chunk of gen_chunk steps' batches is made in one go on the
    # device, a whole number of calls; file data uses a fixed chunk so that
    # (seed, chunk index) names the same batches whatever --steps is
    gen_chunk = max(64 // fuse * fuse, fuse)
    if args.data != "file":
        gen_chunk = min(args.steps, gen_chunk)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    if args.data == "file":
        from nanotpu_torch.data.tokens import open_tokens, sample_chunk

        if not args.data_path:
            parser.error("--data file requires --data-path")
        corpus = open_tokens(args.data_path, dtype=np.dtype(args.data_dtype))

        def make(index):
            rows = sample_chunk(corpus, gen_chunk, batch, seq, args.data_seed,
                                index)
            if int(rows.max(initial=0)) >= cfg.vocab_size:
                raise ValueError(
                    f"--data-path has token ids >= vocab {cfg.vocab_size}")
            return torch.from_numpy(rows).to(device)
    elif args.data == "markov":
        from nanotpu_torch.data.synthetic import markov_batch, markov_table

        table = markov_table(cfg.vocab_size, seed=args.data_seed, device=device)

        def make(index):
            return markov_batch(gen, table, (gen_chunk, batch, seq))
    else:
        def make(index):
            return torch.randint(0, cfg.vocab_size, (gen_chunk, batch, seq),
                                 generator=gen, device=device)

    losses = _LaggedLosses(device)
    start = state.step
    tokens_buf, buf_base = None, -1
    profiler = None
    t0 = t_end = time.perf_counter()
    try:
        for i in range(start, start + args.steps, fuse):
            if i // gen_chunk != buf_base:
                buf_base = i // gen_chunk
                tokens_buf = make(buf_base)
            off = i % gen_chunk
            tokens = (tokens_buf[off] if fuse == 1
                      else tokens_buf[off:off + fuse])
            state, loss = step_fn(state, tokens)
            losses.push(i + fuse, loss)
            if i == start:  # the first call (allocation, warm-up) is left out
                _sync(device)
                t0 = time.perf_counter()
                if args.profile_dir and args.steps < 2 * fuse:
                    log.warning("--profile-dir ignored: needs --steps >= 2x "
                                "--fuse-steps (the first call is warm-up "
                                "and is left out)")
                elif args.profile_dir:
                    profiler = _start_profiler(args.profile_dir, device)
            if args.checkpoint_dir and (i + fuse) % args.save_every < fuse:
                save_checkpoint(args.checkpoint_dir, state)
        _sync(device)
        t_end = time.perf_counter()
    finally:
        # a crashed run keeps its trace and the losses it finished
        if profiler is not None:
            profiler.stop()
            log.info("profile trace written to %s", args.profile_dir)
        losses.flush()
    tok_s = None
    steady = args.steps - fuse  # the first call is left out
    if steady > 0:
        tok_s = steady * batch * seq / max(t_end - t0, 1e-9)
        log.info("done: %d steps, %.0f tokens/s (steady-state)", args.steps,
                 tok_s)
    else:
        log.info("done: %d steps in one call (use --steps >= 2x "
                 "--fuse-steps for throughput)", args.steps)
    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir, state)
    return {"losses": losses.logged, "tok_s": tok_s, "batch": batch,
            "seq": seq, "device": str(device), "cfg": cfg, "state": state,
            "steady_s": t_end - t0, "step_fn": step_fn,
            "mesh": factors if mesh is not None else None}


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    run(argv)
    return 0


if __name__ == "__main__":  # pragma: no cover - binary entry
    raise SystemExit(main())
