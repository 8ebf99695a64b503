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
``torch.profiler``. The mesh of nanotpu's step (dp, fsdp, tp, ep, sp, pp)
is not ported: the CLI refuses its flags.

Run:  python -m nanotpu_torch.parallel.train --preset flagship --attn flash
      --seq 2049 --batch 8 --data markov --steps 24 --fuse-steps 8
      (one CUDA card)
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

from nanotpu_torch import resolve_device
from nanotpu_torch.models import llama, mixtral
from nanotpu_torch.ops import attention
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
    def update(self, grads, opt_state: dict, params):
        """Apply one step to ``params`` and ``opt_state`` in place, from
        ``grads`` (the parameters' leaves' gradients, in order); returns
        both. Nothing leaves the device: the count, the bias corrections
        and the clip decision are tensors, so a captured step replays
        every one of them."""
        ps, mus, nus = leaves(params), leaves(opt_state["mu"]), leaves(opt_state["nu"])
        grads = list(grads)
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
) -> Callable[[TrainState, torch.Tensor], tuple[TrainState, torch.Tensor]]:
    """(state, tokens) -> (state, loss), nanotpu's signature. With
    ``n_fused == 1``, tokens [B, S+1] and one eager optimizer step; with
    ``n_fused > 1``, tokens [n_fused, B, S+1] and that many steps in one
    call (:class:`FusedTrainStep`), returning the last step's loss. The
    state's tensors are updated in place; the loss is detached and stays
    on the device."""
    if n_fused < 1:
        raise ValueError(f"n_fused must be at least 1, not {n_fused}")
    loss_fn = loss_fn or llama.loss_fn

    def body(params, opt_state, tokens: torch.Tensor) -> torch.Tensor:
        ps = leaves(params)
        for p in ps:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = loss_fn(params, tokens, cfg)
        grads = torch.autograd.grad(loss, ps)
        optimizer.update(grads, opt_state, params)
        return loss.detach()

    if n_fused > 1:
        return FusedTrainStep(body, n_fused)

    def step_fn(state: TrainState, tokens: torch.Tensor):
        loss = body(state.params, state.opt_state, tokens)
        return TrainState(state.params, state.opt_state, state.step + 1), loss

    return step_fn


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


def save_checkpoint(ckpt_dir: str, state: TrainState) -> None:
    """``<ckpt_dir>/step_<N>/state.pt`` with torch.save, written to a
    temporary name first so a crash leaves no half-written checkpoint."""
    path = _ckpt_path(ckpt_dir, state.step)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"state.pt.{os.getpid()}.tmp")
    blob = {
        "params": map_tree(lambda t: t.detach(), state.params),
        "opt_state": state.opt_state,
        "step": state.step,
    }
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, "state.pt"))


def restore_checkpoint(ckpt_dir: str, like: TrainState) -> TrainState | None:
    """The newest ``step_<N>`` under ``ckpt_dir``, placed on the device and
    in the dtypes of ``like``'s leaves; None when there is none."""
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
        return saved.to(device=want.device, dtype=want.dtype)

    params = map_tree(place, blob["params"], like.params)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = like.opt_state
    # a checkpoint written before the count moved to the device holds an int
    count = torch.as_tensor(blob["opt_state"]["count"], dtype=torch.int32)
    opt_state = {
        "count": count.to(opt["count"].device),
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

#: flags of nanotpu's trainer that the port refuses, with their idle values
_NOT_PORTED = {"dp": (0, 1), "fsdp": (1,), "tp": (1,), "ep": (1,),
               "sp": (1,), "pp": (1,), "microbatches": (0,)}


def _parser():
    import argparse

    p = argparse.ArgumentParser(description="nanotpu_torch trainer (one device)")
    p.add_argument("--model", choices=["llama", "mixtral"], default="llama")
    p.add_argument("--preset", default="tiny")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=0, help="0 = 2")
    p.add_argument("--seq", type=int, default=0,
                   help="0 = min(preset max_seq_len, 512); the model sees "
                        "seq-1 tokens after the loss shift")
    for flag in ("dp", "fsdp", "tp", "ep", "sp", "pp", "microbatches"):
        p.add_argument(f"--{flag}", type=int, default=_NOT_PORTED[flag][0],
                       help="mesh flag of nanotpu's trainer: not ported yet")
    p.add_argument("--attn", choices=["dense", "flash"], default="",
                   help="attention: flash = the CUDA kernels")
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
    steady-state tokens/s (None with one call), the device, the final
    state and the step function (``FusedTrainStep`` with
    ``--fuse-steps`` > 1)."""
    parser = _parser()
    args = parser.parse_args(argv)
    for flag, idle in _NOT_PORTED.items():
        if getattr(args, flag) not in idle:
            parser.error(f"--{flag.replace('_', '-')} is not ported yet: the "
                         "port trains on one device")
    fuse = max(1, args.fuse_steps)
    if args.steps % fuse:
        parser.error(f"--steps {args.steps} must be a multiple of "
                     f"--fuse-steps {fuse}")
    key = (args.model, args.preset)
    if key not in _PRESETS:
        parser.error(f"no preset {key}; have {sorted(_PRESETS)}")
    device = resolve_device(args.device)
    preset = dict(_PRESETS[key])
    if args.attn:
        preset["attn_impl"] = args.attn
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
    batch = args.batch or 2
    seq = args.seq or min(cfg.max_seq_len, 512)
    log.info("device %s | %s/%s | batch=%d seq=%d attn=%s", device, *key,
             batch, seq, cfg.attn_impl)

    optimizer = make_optimizer(
        mu_dtype=torch.bfloat16 if args.bf16_momentum else None)
    state = init_train_state(
        torch.Generator(device=device).manual_seed(args.seed), cfg, optimizer,
        device=device, init_fn=init)
    log.info("params %d", llama.param_count(state.params))
    if args.checkpoint_dir:
        restored = restore_checkpoint(args.checkpoint_dir, state)
        if restored is not None:
            state = restored
            log.info("resumed from step %d", state.step)
    step_fn = build_train_step(cfg, optimizer, loss_fn=loss, n_fused=fuse)

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
            "steady_s": t_end - t0, "step_fn": step_fn}


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    run(argv)
    return 0


if __name__ == "__main__":  # pragma: no cover - binary entry
    raise SystemExit(main())
