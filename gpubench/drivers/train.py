"""Driver kind ``train``: the port's train step (``build_train_step`` with
one eager clipped-AdamW step a call, as ``python -m
nanotpu_torch.parallel.train --fuse-steps 1`` builds it) on seeded Markov
batches.

Set-up builds one state from the harness's weights and drives it through
its first ``check_steps`` (two) steps with the window's own call and feed,
reading after the first the norm of each leaf's first gradient as AdamW
holds it (its first moment over 1 - b1) and after the second the norm of
each leaf's change from its initial value. The same state then trains
through the window, one step in flight behind the one the host waits
for; the window closes on a synchronised step, and counts every step it
ran. A traced run profiles ``trace_steps`` steps instead.

After the close the program's state is freed, and the float32 reference
runs the same two steps from the same initial weights on the same
batches; the losses, the first gradients and the changes are compared
leaf by leaf (:mod:`gpubench.yardstick.compare`). ``control`` puts the
reference in the program's place: in float8 (``"fp8"``, the control),
with half of each batch left out and the mean taken over the rest
(``"half_batch"``, a fault), or with every step returning its state
unchanged (``"unchanged"``, a fault: both losses at the initial weights,
no gradient in the optimizer, no change); none needs a window.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from gpubench.reference.adamw import two_steps
from gpubench.reference.common import Numerics, strict_float32
from gpubench.yardstick import compare, markov, weights
from gpubench.yardstick.traffic import rng


def _batches(run, shape) -> torch.Tensor:
    t = run.traffic
    data = t["data"]
    succ = markov.table(shape.vocab, data["n_succ"], run.seed, run.device)
    gen = torch.Generator(device=run.device).manual_seed(
        int(rng(run.seed, 4).integers(0, 2**62)))
    return markov.batches(succ, data["succ_logits"],
                          (t["pool_steps"], t["batch"], t["seq"] + 1), gen)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(run, tracer) -> dict:
    pool = _batches(run, run.shape)
    if run.control == "unchanged":
        prog = _unchanged(run, pool)
    elif run.control in ("fp8", "half_batch"):
        fp8, half = run.control == "fp8", run.control == "half_batch"
        prog = _reference(run, pool, Numerics("fp8") if fp8 else None,
                          rows=pool.shape[1] // 2 if half else None)
    if run.control is not None:
        out = {"t_open": None, "t_close": None, "steps": 0, "attempted": 0,
               "failed": 0, "memory_peak_bytes": 0}
    else:
        out, prog = _program(run, pool, tracer)
    out["compared"] = compare.train_numbers(prog, _reference(run, pool))
    return out


def _program(run, pool, tracer) -> tuple[dict, dict]:
    from nanotpu_torch.parallel.train import AdamW, TrainState, build_train_step

    t = run.traffic
    cfg, loss_fn = run.family.port(run.config)
    opt = AdamW(**t["optimizer"])
    params = weights.tree(run.shape, run.seed, cfg.torch_dtype, run.device)
    for p in weights.leaves(params):
        p.requires_grad_(True)
    state = TrainState(params, opt.init(params), 0)
    step = build_train_step(cfg, opt, loss_fn=loss_fn, n_fused=1)

    # the checked steps: the window's call on the window's feed
    losses = []
    state, loss = step(state, pool[0])
    losses.append(loss)
    mu = weights.leaves(state.opt_state["mu"])
    first = torch.stack([torch.linalg.vector_norm(m.float()) for m in mu])
    first = (first / (1 - opt.b1)).tolist()
    state, loss = step(state, pool[1])
    losses.append(loss)
    prog = {"losses": [float(x) for x in losses], "first_grad_norms": first,
            "change_norms": weights.change_norms(
                run.shape, run.seed, state.params, cfg.torch_dtype)}

    window_losses = []
    n_pool = pool.shape[0]
    i = len(losses)
    _sync(run.device)
    if tracer is not None:
        tracer.start()
        tracer.mark()
    t0 = time.perf_counter()
    pending = None
    while True:
        state, loss = step(state, pool[i % n_pool])
        window_losses.append(loss)
        i += 1
        if run.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            if pending is not None:
                pending.synchronize()
            pending = done
        if tracer is not None:
            if len(window_losses) >= t["trace_steps"]:
                break
        elif time.perf_counter() - t0 >= run.seconds:
            break
    _sync(run.device)
    t1 = time.perf_counter()
    out = {"t_open": t0, "t_close": t1, "steps": len(window_losses),
           "tokens_per_step": t["batch"] * t["seq"],
           "attempted": len(window_losses),
           "failed": sum(1 for x in torch.stack(window_losses).tolist()
                         if not math.isfinite(x))}
    if tracer is not None:
        tracer.mark()
        out["timeline"] = tracer.stop()
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(run.device)
                                if run.device.type == "cuda" else 0)
    del state, step, params, loss, losses, window_losses, mu
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return out, prog


def _unchanged(run, pool) -> dict:
    """The readings of a step that returns its state unchanged: the float32
    reference's losses at the initial weights on both checked batches, a
    first moment of nought and no change."""
    strict_float32()
    dtype = getattr(torch, run.config["torch_dtype"])
    stacks = {kind: weights.draw(run.shape, run.seed, kind, dtype,
                                 run.device).float()
              for kind in weights.kinds(run.shape)}
    tree = weights.tree_of(run.shape, stacks, run.device)
    n = len(weights.leaves(tree))
    with torch.no_grad():
        losses = [float(run.family.reference_loss(tree, run.config, b))
                  for b in (pool[0], pool[1])]
    del tree, stacks
    gc.collect()
    return {"losses": losses, "first_grad_norms": [0.0] * n,
            "change_norms": [0.0] * n}


def _reference(run, pool, num: Numerics | None = None,
               rows: int | None = None) -> dict:
    """Two float32 (or ``num``) reference steps from the initial weights,
    on each batch's first ``rows`` rows (all by default)."""
    strict_float32()
    t = run.traffic
    dtype = getattr(torch, run.config["torch_dtype"])
    stacks = {}
    for kind in weights.kinds(run.shape):
        stacks[kind] = weights.draw(run.shape, run.seed, kind, dtype,
                                    run.device).float()
    tree = weights.tree_of(run.shape, stacks, run.device)
    del stacks
    leaves = weights.leaves(tree)
    readings = two_steps(
        leaves,
        lambda batch: run.family.reference_loss(tree, run.config,
                                                batch[:rows], num),
        [pool[0], pool[1]], t["optimizer"])
    readings["change_norms"] = weights.change_norms(run.shape, run.seed,
                                                    tree, dtype)
    del tree, leaves
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return readings
