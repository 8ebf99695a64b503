"""Draft-model distillation for speculative decoding: the port of
``nanotpu/models/distill.py``.

* The draft **shares the target's embedding, final norm and lm_head,
  frozen**: the two models live in one representation and vocabulary, so
  the draft's few layers only approximate the target's deeper mixing.
* With the target's FFN width the draft's layers start as the target's
  first layers (truncated-teacher init), copied so that training them
  leaves the target untouched.
* Training data is sampled from the target at the serving temperature, and
  the loss is soft-label cross entropy against the target's full-vocabulary
  distribution (or MSE on centred logits).
* The optimizer is AdamW (b1 0.9, b2 0.95, no weight decay, no clipping)
  over the draft's layers only: the frozen leaves get no gradient and no
  moments, and stay the target's tensors.

CLI: ``python -m nanotpu_torch.models.distill --steps 300`` distills,
measures acceptance and tokens/s against plain sampled decoding (T=0.8,
K=4), and prints one JSON line. It runs on ``cuda`` unless ``--device``
names another.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from nanotpu_torch.models.llama import (
    LlamaConfig,
    hidden_states,
    init_params,
    linear,
)
from nanotpu_torch.parallel.train import AdamW
from nanotpu_torch.tree import leaves, map_tree

#: the draft's leaves tied to the target's and never trained
FROZEN = ("embed", "final_norm", "lm_head")


def draft_config(cfg: LlamaConfig, n_layers: int = 2,
                 ffn_dim: int | None = None) -> LlamaConfig:
    """A shallow draft with the target's width and vocabulary (the tied
    embed/head need the same dim) and a slimmer FFN by default."""
    return dataclasses.replace(
        cfg, n_layers=n_layers, ffn_dim=ffn_dim or cfg.ffn_dim // 2,
        attn_impl="dense",  # one-token decode steps: flash buys nothing
    )


def init_draft(generator: torch.Generator, target_params: dict,
               cfg: LlamaConfig, dcfg: LlamaConfig,
               truncate: bool = True) -> dict:
    """Draft params on the target's device with the target's embed, final
    norm and lm_head tied in (the same tensors). ``truncate`` starts the
    draft's layers as copies of the target's first layers where the layer
    shapes match (``draft_config(cfg, ffn_dim=cfg.ffn_dim)``)."""
    device = target_params["final_norm"].device
    draft = init_params(dcfg, generator, device=device)
    for name in FROZEN:
        draft[name] = target_params[name]
    if truncate and dcfg.ffn_dim == cfg.ffn_dim:
        for i in range(dcfg.n_layers):
            draft["layers"][i] = map_tree(lambda t: t.detach().clone(),
                                          target_params["layers"][i])
    return draft


def _trainable_mask(draft_params: dict) -> dict:
    """True for the leaves distillation updates (the draft's own layers)."""
    return {
        "embed": False,
        "layers": map_tree(lambda _: True, draft_params["layers"]),
        "final_norm": False,
        "lm_head": False,
    }


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax's ``cosine_decay_schedule``: the learning rate at update
    ``count`` (0 for the first), from ``init_value`` down to
    ``alpha * init_value`` at ``decay_steps``."""

    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac))
                             + alpha)

    return schedule


def distill_loss(draft_params, tokens, teacher_logits, dcfg: LlamaConfig,
                 label_temperature: float = 1.0, loss: str = "ce"):
    """The distillation loss of ``draft_params`` on ``tokens [B, S+1]``
    against ``teacher_logits [B, S, V]``: soft-label CE with both sides at
    ``label_temperature`` (acceptance is decided on the warped
    distributions), or with ``loss="mse"`` the mean squared error of the
    centred logits (acceptance responds to logit differences)."""
    h = hidden_states(draft_params, tokens[:, :-1], dcfg)
    logits = linear(h, draft_params["lm_head"]).float()
    if loss == "mse":
        d = logits - teacher_logits
        d = d - d.mean(dim=-1, keepdim=True)  # softmax is shift-invariant
        return (d * d).mean()
    inv_t = 1.0 / label_temperature
    logq = torch.log_softmax(logits * inv_t, dim=-1)
    p = torch.softmax(teacher_logits * inv_t, dim=-1)
    return -(p * logq).sum(dim=-1).mean()


def make_distill_step(dcfg: LlamaConfig, lr=3e-4,
                      label_temperature: float = 1.0, loss: str = "ce"):
    """Returns (init_opt_state, step):
    step(draft_params, opt_state, tokens [B, S+1], teacher_logits [B, S, V])
    -> (draft_params, opt_state, loss), the draft's layers and the moments
    updated in place, the loss that of :func:`distill_loss` before the
    update. ``lr`` is a float or a schedule of the update count."""
    base = AdamW(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                 max_norm=math.inf)

    def init_opt(draft_params):
        return base.init(draft_params["layers"])

    def step(draft_params, opt_state, tokens, teacher_logits):
        # the mask laid over the draft's own key order
        mask = map_tree(lambda _, train: train, draft_params,
                        _trainable_mask(draft_params))
        trainable = [p for p, train in zip(leaves(draft_params), leaves(mask))
                     if train]
        with torch.enable_grad():
            for p in trainable:
                p.requires_grad_(True)
            # no gradient through the frozen leaves: their vocabulary-sized
            # backward products are skipped
            value = distill_loss(
                map_tree(lambda t, train: t if train else t.detach(),
                         draft_params, mask),
                tokens, teacher_logits, dcfg, label_temperature, loss)
            grads = torch.autograd.grad(value, trainable)
        # a schedule reads the update count on the host
        rate = lr(int(opt_state["count"])) if callable(lr) else lr
        dataclasses.replace(base, lr=rate).update(grads, opt_state,
                                                  draft_params["layers"])
        return draft_params, opt_state, value.detach()

    return init_opt, step


def target_config() -> LlamaConfig:
    """The CLI's target: nanotpu's distill target (the training flagship's
    widths, dense attention)."""
    return LlamaConfig(
        vocab_size=32_768, dim=1024, n_layers=8, n_heads=16, n_kv_heads=4,
        ffn_dim=4096, max_seq_len=2048, dtype="bfloat16",
    )


def main(argv=None) -> int:
    import argparse
    import json
    import logging
    import os
    import statistics
    import time

    from nanotpu_torch import resolve_device
    from nanotpu_torch.models.generate import generate
    from nanotpu_torch.models.llama import forward
    from nanotpu_torch.models.quant import (
        load_params,
        quantize_params,
        save_params,
    )
    from nanotpu_torch.models.speculative import speculative_generate

    parser = argparse.ArgumentParser("nanotpu-torch-distill")
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seq", type=int, default=256)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--temperature", type=float, default=0.8)
    parser.add_argument("--draft-k", type=int, default=4)
    parser.add_argument("--eval-new-tokens", type=int, default=256)
    parser.add_argument("--eval-batch", type=int, default=8)
    parser.add_argument("--fresh-sample-every", type=int, default=4,
                        help="sample a new on-policy batch every N steps "
                             "(sampling costs several draft steps)")
    parser.add_argument("--full-ffn", action="store_true",
                        help="draft keeps the target's ffn_dim so its "
                             "layers can initialize from the target's "
                             "first layers (truncated-teacher init)")
    parser.add_argument("--loss", choices=["ce", "mse"], default="ce")
    parser.add_argument("--eval-pairs", type=int, default=4,
                        help="back-to-back (plain, speculative) timing "
                             "pairs per K; the speedup is their median "
                             "ratio")
    parser.add_argument("--lr-decay", action="store_true",
                        help="cosine-decay the learning rate to 10%% over "
                             "the run")
    parser.add_argument("--eval-ks", default="",
                        help="comma-separated speculation depths to eval "
                             "(default: just --draft-k)")
    parser.add_argument("--save-draft", default="",
                        help="directory to save the distilled draft in "
                             "(torch.save, draft.pt)")
    parser.add_argument("--load-draft", default="",
                        help="directory of a saved draft to evaluate "
                             "instead of distilling (--steps 0)")
    parser.add_argument("--target-ckpt", default="",
                        help="checkpoint directory of nanotpu_torch.parallel."
                             "train: distill against this trained target "
                             "instead of a random init")
    parser.add_argument("--prompt-data", choices=["random", "markov"],
                        default="random",
                        help="eval prompt distribution; 'markov' draws "
                             "on-corpus prompts (the synthetic chain of "
                             "nanotpu_torch.data, --data-seed)")
    parser.add_argument("--data-seed", type=int, default=0)
    parser.add_argument("--int8-draft", action="store_true",
                        help="quantize the draft weight-only int8 for the "
                             "eval")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s", force=True)
    log = logging.getLogger("nanotpu_torch.distill")

    device = resolve_device(args.device)
    cfg = target_config()
    dcfg = draft_config(cfg, ffn_dim=cfg.ffn_dim if args.full_ffn else None)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    if args.target_ckpt:
        from nanotpu_torch.parallel.train import (
            init_train_state,
            make_optimizer,
            restore_checkpoint,
        )

        template = init_train_state(
            torch.Generator(device=device).manual_seed(0), cfg,
            make_optimizer(), device=device)
        restored = restore_checkpoint(args.target_ckpt, template)
        if restored is None:
            parser.error(f"no checkpoint under {args.target_ckpt}")
        params = map_tree(lambda t: t.detach().requires_grad_(False),
                          restored.params)
        del template
        log.info("loaded trained target from %s (step %d)", args.target_ckpt,
                 restored.step)
        del restored
    draft = init_draft(torch.Generator(device=device).manual_seed(1), params,
                       cfg, dcfg)
    lr = args.lr
    if args.lr_decay and args.steps > 0:
        lr = cosine_decay(args.lr, args.steps, alpha=0.1)
    init_opt, dstep = make_distill_step(
        dcfg, lr, label_temperature=args.temperature, loss=args.loss)
    opt_state = init_opt(draft)
    if args.load_draft:
        if args.steps:
            parser.error(
                "--load-draft evaluates a saved draft; pass --steps 0 "
                "(further training would mutate its weights under a fresh "
                "optimizer state)"
            )
        draft = load_params(os.path.join(args.load_draft, "draft.pt"),
                            device)
        log.info("loaded draft from %s", args.load_draft)

    B, S, T = args.batch, args.seq, args.temperature
    gen = torch.Generator(device=device).manual_seed(2)
    t0 = time.time()
    tokens = labels = loss = None
    # clamped: 0 would divide by zero, a negative never resample
    fresh_every = max(1, args.fresh_sample_every)
    for i in range(args.steps):
        if i % fresh_every == 0:
            with torch.no_grad():
                prompts = torch.randint(0, cfg.vocab_size, (B, 1),
                                        generator=gen, device=device)
                sampled = generate(params, prompts, cfg, S, temperature=T,
                                   generator=gen, max_len=S + 1)
                tokens = torch.cat([prompts, sampled], dim=1)  # [B, S+1]
                labels = forward(params, tokens[:, :-1], cfg)
        draft, opt_state, loss = dstep(draft, opt_state, tokens, labels)
        if i % 25 == 0:
            log.info("distill step %d soft-CE %.4f", i, float(loss))
    log.info("distilled %d steps in %.0fs (final soft-CE %s)", args.steps,
             time.time() - t0,
             f"{float(loss):.4f}" if loss is not None else "n/a")
    del tokens, labels
    if args.save_draft:
        os.makedirs(args.save_draft, exist_ok=True)
        save_params(os.path.join(args.save_draft, "draft.pt"), draft)
        log.info("saved draft to %s", args.save_draft)

    # -- evaluation at the bench settings ---------------------------------
    eval_draft = quantize_params(draft) if args.int8_draft else draft
    EB, N = args.eval_batch, args.eval_new_tokens
    ks = [int(x) for x in args.eval_ks.split(",") if x] or [args.draft_k]
    if args.prompt_data == "markov":
        from nanotpu_torch.data.synthetic import markov_batch, markov_table

        table = markov_table(cfg.vocab_size, seed=args.data_seed,
                             device=device)
        prompt = markov_batch(gen, table, (EB, 8))
    else:
        prompt = torch.randint(0, cfg.vocab_size, (EB, 8), generator=gen,
                               device=device)

    def plain(seed):
        return generate(params, prompt, cfg, N, temperature=T,
                        generator=torch.Generator(device=device).manual_seed(
                            seed))

    def spec(K, seed):
        return speculative_generate(
            params, eval_draft, prompt, cfg, dcfg, N, draft_tokens=K,
            temperature=T, return_stats=True,
            generator=torch.Generator(device=device).manual_seed(seed))

    def one_timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        first = out[0] if isinstance(out, tuple) else out
        int(first.sum())  # waits for the device and fetches
        return out, time.perf_counter() - t0

    result = {"distill_steps": args.steps, "temperature": T,
              "eval_batch": EB, "per_k": {}}
    # plain and speculative are timed in back-to-back pairs and the speedup
    # is the median of the pairs' ratios: robust to drift between them
    one_timed(plain, 0)  # warm-up
    pairs = max(1, args.eval_pairs)
    for K in ks:
        one_timed(spec, K, 1)  # warm-up
        ratios, plain_dts, spec_dts = [], [], []
        stats = None
        for r in range(pairs):
            _, p_dt = one_timed(plain, 1000 * K + r)
            (_, stats), s_dt = one_timed(spec, K, 2000 * K + r)
            ratios.append(p_dt / s_dt)
            plain_dts.append(p_dt)
            spec_dts.append(s_dt)
        acc = stats["accepted"] / max(stats["drafted"], 1)
        result["per_k"][K] = {
            "acceptance": round(acc, 4),
            "cycles": stats["cycles"],
            "speedup_median_of_pairs": round(statistics.median(ratios), 3),
            "speedup_pairs": [round(x, 3) for x in ratios],
            "plain_tok_s_best": round(EB * N / min(plain_dts), 1),
            "speculative_tok_s_best": round(EB * N / min(spec_dts), 1),
        }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
