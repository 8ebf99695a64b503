"""Training on one device: loss -> gradients -> clipped AdamW, the port of
``nanotpu/parallel/train.py``.

The step is eager PyTorch: ``loss_fn`` (the Llama chunked cross entropy by
default), ``torch.autograd.grad`` over the parameter tree's leaves, then
:class:`AdamW`, which updates parameters and moments in place (nanotpu's
jitted step donates its state; in place is the eager counterpart and holds
one copy of each). The mesh of nanotpu's step (dp, fsdp, tp, ep, sp, pp)
and its fused multi-step programs are not ported: the CLI refuses their
flags.

Run:  python -m nanotpu_torch.parallel.train --preset flagship --attn flash
      --seq 2049 --batch 8 --data markov --steps 10     (one CUDA card)
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from collections import deque
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from nanotpu_torch import resolve_device
from nanotpu_torch.models import llama
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
        return {
            "count": 0,
            "mu": map_tree(lambda p: torch.zeros_like(
                p, dtype=self.mu_dtype or p.dtype, requires_grad=False), params),
            "nu": map_tree(lambda p: torch.zeros_like(
                p, requires_grad=False), params),
        }

    @torch.no_grad()
    def update(self, grads, opt_state: dict, params):
        """Apply one step to ``params`` and ``opt_state`` in place, from
        ``grads`` (the parameters' leaves' gradients, in order); returns
        both."""
        ps, mus, nus = leaves(params), leaves(opt_state["mu"]), leaves(opt_state["nu"])
        grads = list(grads)
        norm = torch.stack([(g.float() ** 2).sum() for g in grads]).sum().sqrt()
        keep = norm < self.max_norm
        count = opt_state["count"] + 1
        # 1 - decay**count in f32, as optax computes it
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.int32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.int32(count))
        for p, g, mu, nu in zip(ps, grads, mus, nus):
            g = torch.where(keep, g, (g / norm.to(g.dtype)) * self.max_norm)
            m = (1 - self.b1) * g + self.b1 * mu
            v = (1 - self.b2) * (g * g) + self.b2 * nu
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = -self.lr * (u + self.weight_decay * p)
            p.copy_((p + u).to(p.dtype))
            mu.copy_(m.to(mu.dtype))
            nu.copy_(v)
        opt_state["count"] = count
        return params, opt_state


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                   mu_dtype: torch.dtype | None = None) -> AdamW:
    """AdamW (b1 0.9, b2 0.95, eps 1e-8) with global-norm clipping at 1.0."""
    return AdamW(lr=lr, weight_decay=weight_decay, mu_dtype=mu_dtype)


def init_train_state(generator: torch.Generator, cfg, optimizer: AdamW,
                     device=None) -> TrainState:
    """Fresh Llama parameters from ``generator`` on ``device`` (``cuda``
    unless named), ready for autograd, with zeroed moments."""
    params = llama.init_params(cfg, generator, device=device)
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params, optimizer.init(params), 0)


def build_train_step(
    cfg, optimizer: AdamW, loss_fn: Callable | None = None,
) -> Callable[[TrainState, torch.Tensor], tuple[TrainState, torch.Tensor]]:
    """(state, tokens [B, S+1]) -> (state, loss): one optimizer step. The
    state's tensors are updated in place; the loss is detached and stays
    on the device."""
    loss_fn = loss_fn or llama.loss_fn

    def step_fn(state: TrainState, tokens: torch.Tensor):
        ps = leaves(state.params)
        for p in ps:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = loss_fn(state.params, tokens, cfg)
        grads = torch.autograd.grad(loss, ps)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params)
        return TrainState(params, opt_state, state.step + 1), loss.detach()

    return step_fn


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
    opt_state = {
        "count": blob["opt_state"]["count"],
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
    # nanotpu's Mixtral rows: the model is not ported yet
    ("mixtral", "tiny"): None,
    ("mixtral", "8x7b"): None,
}

#: flags of nanotpu's trainer that the port refuses, with their idle values
_NOT_PORTED = {"dp": (0, 1), "fsdp": (1,), "tp": (1,), "ep": (1,),
               "sp": (1,), "pp": (1,), "microbatches": (0,),
               "fuse_steps": (1,), "profile_dir": ("",)}


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
                   help="steps per device program: not ported yet")
    p.add_argument("--profile-dir", default="",
                   help="profiler trace: not ported yet")
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv: list[str] | None = None) -> dict:
    """Parse ``argv`` and train. Returns the logged (step, loss) pairs,
    steady-state tokens/s (None with one step), the device and the final
    state."""
    parser = _parser()
    args = parser.parse_args(argv)
    for flag, idle in _NOT_PORTED.items():
        if getattr(args, flag) not in idle:
            parser.error(f"--{flag.replace('_', '-')} is not ported yet: the "
                         "port trains on one device, one step per call")
    key = (args.model, args.preset)
    if key not in _PRESETS:
        parser.error(f"no preset {key}; have {sorted(_PRESETS)}")
    if _PRESETS[key] is None:
        parser.error(f"{args.model} is not ported yet")
    device = resolve_device(args.device)
    preset = dict(_PRESETS[key])
    if args.attn:
        preset["attn_impl"] = args.attn
    if args.remat:
        preset["remat"] = True
        preset["remat_policy"] = args.remat_policy
    cfg = llama.LlamaConfig(**preset)
    batch = args.batch or 2
    seq = args.seq or min(cfg.max_seq_len, 512)
    log.info("device %s | %s/%s | batch=%d seq=%d attn=%s", device, *key,
             batch, seq, cfg.attn_impl)

    optimizer = make_optimizer(
        mu_dtype=torch.bfloat16 if args.bf16_momentum else None)
    state = init_train_state(
        torch.Generator(device=device).manual_seed(args.seed), cfg, optimizer,
        device=device)
    log.info("params %d", llama.param_count(state.params))
    if args.checkpoint_dir:
        restored = restore_checkpoint(args.checkpoint_dir, state)
        if restored is not None:
            state = restored
            log.info("resumed from step %d", state.step)
    step_fn = build_train_step(cfg, optimizer)

    # every chunk of gen_chunk steps' batches is made in one go on the
    # device; file data uses a fixed chunk so that (seed, chunk index)
    # names the same batches whatever --steps is
    gen_chunk = min(args.steps, 64) if args.data != "file" else 64
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
    t0 = t_end = time.perf_counter()
    try:
        for i in range(start, start + args.steps):
            if i // gen_chunk != buf_base:
                buf_base = i // gen_chunk
                tokens_buf = make(buf_base)
            state, loss = step_fn(state, tokens_buf[i % gen_chunk])
            losses.push(i + 1, loss)
            if i == start:  # the first step (allocation, kernel loads) is left out
                _sync(device)
                t0 = time.perf_counter()
            if args.checkpoint_dir and (i + 1) % args.save_every == 0:
                save_checkpoint(args.checkpoint_dir, state)
        _sync(device)
        t_end = time.perf_counter()
    finally:
        losses.flush()
    tok_s = None
    if args.steps > 1:
        tok_s = (args.steps - 1) * batch * seq / max(t_end - t0, 1e-9)
        log.info("done: %d steps, %.0f tokens/s (steady-state)", args.steps,
                 tok_s)
    else:
        log.info("done: 1 step (use --steps>=2 for throughput)")
    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir, state)
    return {"losses": losses.logged, "tok_s": tok_s, "batch": batch,
            "seq": seq, "device": str(device), "cfg": cfg, "state": state,
            "steady_s": t_end - t0}


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    run(argv)
    return 0


if __name__ == "__main__":  # pragma: no cover - binary entry
    raise SystemExit(main())
