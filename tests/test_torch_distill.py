"""nanotpu_torch.models.distill on the CPU, against nanotpu's distill.

The cases of tests/test_distill.py on nanotpu's tiny model (f32), plus the
distillation step held against nanotpu's ``make_distill_step`` (optax's
masked AdamW) from the same draft on the same batches: losses within 1e-5
and the trained leaves within 3e-5 after 1 and 3 steps (as the trainer's
parity test holds AdamW: summation order in f32 moves Adam's update by a
few ulps of lr), the frozen leaves exactly the target's tensors. The CLI
runs end to end on the CPU with its target configuration swapped for a
tiny one, so that the CLI itself is the one that ships.

Run as a script, the file sets both packages' distillation side by side
at the serving flagship's width for 48 steps and prints their held-out
soft-CE (see :func:`main`)."""

import dataclasses
import json
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanotpu.models import distill as jd
from nanotpu.models import llama as jl
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.models import distill as td
from nanotpu_torch.models import llama as tl
from nanotpu_torch.models import speculative as ts
from nanotpu_torch.models.generate import generate
from nanotpu_torch.tree import leaves

torch.set_num_threads(2)
CFG_J, CFG_T = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()


def port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def jax_target():
    return jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                     CFG_J)


def setup(jax_target):
    """(port target, draft config, port draft): a 1-layer draft at the
    target's FFN width, so its layer starts as the target's first."""
    params = port(jax_target)
    dcfg = td.draft_config(CFG_T, n_layers=1, ffn_dim=CFG_T.ffn_dim)
    draft = td.init_draft(torch.Generator().manual_seed(1), params, CFG_T,
                          dcfg)
    return params, dcfg, draft


def test_draft_config_matches_jax():
    for kw in ({}, {"n_layers": 1, "ffn_dim": 128}):
        want = dataclasses.asdict(jd.draft_config(CFG_J, **kw))
        assert dataclasses.asdict(td.draft_config(CFG_T, **kw)) == want
    assert td.draft_config(CFG_T).attn_impl == "dense"


def test_draft_shares_frozen_leaves_and_truncated_layers(jax_target):
    params, dcfg, draft = setup(jax_target)
    for name in ("embed", "lm_head", "final_norm"):
        assert draft[name] is params[name]
    # truncated init: the draft's layer 0 equals the target's layer 0, as a
    # copy that training leaves the target's alone
    for a, b in zip(leaves(draft["layers"][0]), leaves(params["layers"][0])):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert td._trainable_mask(draft) == {
        "embed": False, "final_norm": False, "lm_head": False,
        "layers": [{"attn": dict.fromkeys(("wq", "wk", "wv", "wo"), True),
                    "mlp": dict.fromkeys(("w_gate", "w_up", "w_down"), True),
                    "attn_norm": True, "mlp_norm": True}],
    }
    # a slimmer FFN keeps the draft's own random layers
    slim = td.draft_config(CFG_T, n_layers=1)
    other = td.init_draft(torch.Generator().manual_seed(1), params, CFG_T,
                          slim)
    assert other["layers"][0]["mlp"]["w_up"].shape == (64, 64)


@pytest.mark.parametrize("loss", ["ce", "mse"])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_distill_steps_match_jax(jax_target, loss, n_steps):
    jcfg = jd.draft_config(CFG_J, n_layers=1, ffn_dim=CFG_J.ffn_dim)
    jdraft = jd.init_draft(jax.random.PRNGKey(1), jax_target, CFG_J, jcfg)
    init_j, step_j = jd.make_distill_step(jcfg, lr=3e-4,
                                          label_temperature=0.8, loss=loss)
    opt_j = init_j(jdraft)
    params, dcfg, draft = setup(jax_target)
    target_layers = [t.clone() for t in leaves(params["layers"])]
    init_t, step_t = td.make_distill_step(dcfg, lr=3e-4,
                                          label_temperature=0.8, loss=loss)
    opt_t = init_t(draft)
    rng = np.random.default_rng(2)
    for _ in range(n_steps):
        tokens = rng.integers(0, CFG_T.vocab_size, (2, 17))
        labels = jl.forward(jax_target, jnp.asarray(tokens[:, :-1]), CFG_J)
        jdraft, opt_j, loss_j = step_j(jdraft, opt_j, jnp.asarray(tokens),
                                       labels)
        draft, opt_t, loss_t = step_t(draft, opt_t, torch.from_numpy(tokens),
                                      torch.from_numpy(np.array(labels)))
        assert abs(loss_t.item() - float(loss_j)) <= 1e-5
    for a, b in zip(leaves(draft["layers"]),
                    jax.tree_util.tree_leaves(jdraft["layers"])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=3e-5)
    assert opt_t["count"] == n_steps
    for name in ("embed", "lm_head", "final_norm"):
        assert draft[name] is params[name]
        assert not draft[name].requires_grad
    # the target's own layers did not move with the draft's copies
    for a, b in zip(leaves(params["layers"]), target_layers):
        assert torch.equal(a, b)


def test_distill_step_trains_layers_freezes_tied_leaves(jax_target):
    params, dcfg, draft = setup(jax_target)
    init_opt, step = td.make_distill_step(dcfg, lr=1e-2,
                                          label_temperature=0.8)
    opt_state = init_opt(draft)
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, CFG_T.vocab_size, (2, 17)))
    with torch.no_grad():
        labels = tl.forward(params, tokens[:, :-1], CFG_T)
    before_layer = draft["layers"][0]["attn"]["wq"].detach().clone()
    before_embed = draft["embed"].clone()
    draft, opt_state, loss = step(draft, opt_state, tokens, labels)
    assert torch.isfinite(loss)
    assert not torch.equal(draft["layers"][0]["attn"]["wq"], before_layer)
    assert torch.equal(draft["embed"], before_embed)
    assert draft["lm_head"] is params["lm_head"]


def test_distill_reduces_soft_ce(jax_target):
    """A few steps on one fixed batch reduce the distillation loss."""
    params, dcfg, draft = setup(jax_target)
    init_opt, step = td.make_distill_step(dcfg, lr=5e-3,
                                          label_temperature=1.0)
    opt_state = init_opt(draft)
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, CFG_T.vocab_size, (4, 33)))
    with torch.no_grad():
        labels = tl.forward(params, tokens[:, :-1], CFG_T)
    losses = []
    for _ in range(30):
        draft, opt_state, loss = step(draft, opt_state, tokens, labels)
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.01, (losses[0], losses[-1])


def test_distilled_draft_raises_acceptance(jax_target):
    """Distilling on the target's own samples lifts the speculative
    acceptance above the untrained draft's on held-out target samples."""
    params, dcfg, draft = setup(jax_target)
    init_opt, step = td.make_distill_step(dcfg, lr=5e-3,
                                          label_temperature=0.8)
    opt_state = init_opt(draft)
    gen = torch.Generator().manual_seed(4)

    def acceptance(d):
        _, stats = ts.speculative_generate(
            params, d, torch.tensor([[5, 3]]), CFG_T, dcfg, 48,
            draft_tokens=4, temperature=0.8, return_stats=True,
            generator=torch.Generator().manual_seed(9))
        return stats["accepted"] / max(stats["drafted"], 1)

    acc_before = acceptance(draft)
    for _ in range(60):
        prompts = torch.randint(0, CFG_T.vocab_size, (4, 1), generator=gen)
        with torch.no_grad():
            sampled = generate(params, prompts, CFG_T, 32, temperature=0.8,
                               generator=gen, max_len=33)
            tokens = torch.cat([prompts, sampled], dim=1)
            labels = tl.forward(params, tokens[:, :-1], CFG_T)
        draft, opt_state, _ = step(draft, opt_state, tokens, labels)
    acc_after = acceptance(draft)
    assert acc_after > acc_before, (acc_before, acc_after)


def ce_trajectories(jax_target, cfg_j, draft_layers, lrs, steps, batch, seq,
                    temperature=0.8, fresh=4, seed=2):
    """The held-out soft-CE of a truncated-teacher draft distilled from
    ``jax_target`` by nanotpu's ``make_distill_step`` and by the port's at
    each of ``lrs``, on the same batches: the target's own samples at
    ``temperature`` (drawn by nanotpu from a fresh prompt token, a new batch
    every ``fresh`` steps) with nanotpu's logits as the labels, and one
    held-out batch drawn first. Returns {lr: {"jax": [...], "torch": [...]}},
    each list read before the first step and after every step."""
    from nanotpu.models.generate import generate as jgenerate

    cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
    jcfg = jd.draft_config(cfg_j, n_layers=draft_layers, ffn_dim=cfg_j.ffn_dim)
    dcfg = td.draft_config(cfg_t, n_layers=draft_layers, ffn_dim=cfg_t.ffn_dim)
    sample = jax.jit(lambda p, prompt, key: jgenerate(
        p, prompt, cfg_j, seq, temperature=temperature, rng=key,
        max_len=seq + 1))
    teacher = jax.jit(lambda p, tokens: jl.forward(p, tokens, cfg_j))
    key = jax.random.PRNGKey(seed)
    batches = []
    for _ in range(1 + -(-steps // fresh)):
        key, k1, k2 = jax.random.split(key, 3)
        prompt = jax.random.randint(k1, (batch, 1), 0, cfg_j.vocab_size)
        tokens = jnp.concatenate([prompt, sample(jax_target, prompt, k2)], 1)
        batches.append((np.asarray(tokens),
                        np.asarray(teacher(jax_target, tokens[:, :-1]))))
    held_out, batches = batches[0], batches[1:]

    @jax.jit
    def jax_ce(draft, tokens, labels):
        h = jl.hidden_states(draft, tokens[:, :-1], jcfg)
        logits = jl.linear(h, draft["lm_head"]).astype(jnp.float32)
        logq = jax.nn.log_softmax(logits / temperature, axis=-1)
        p = jax.nn.softmax(labels / temperature, axis=-1)
        return -(p * logq).sum(-1).mean()

    params = port(jax_target)
    held_t = tuple(torch.from_numpy(a.copy()) for a in held_out)
    init_draft = jax.jit(jd.init_draft, static_argnums=(2, 3))
    out = {}
    for lr in lrs:
        jdraft = init_draft(jax.random.PRNGKey(1), jax_target, cfg_j, jcfg)
        init_j, step_j = jd.make_distill_step(jcfg, lr=lr,
                                              label_temperature=temperature)
        opt_j = init_j(jdraft)
        draft = td.init_draft(torch.Generator().manual_seed(1), params, cfg_t,
                              dcfg)
        init_t, step_t = td.make_distill_step(dcfg, lr=lr,
                                              label_temperature=temperature)
        opt_t = init_t(draft)

        def read():
            with torch.no_grad():
                ce_t = td.distill_loss(draft, *held_t, dcfg, temperature)
            return float(jax_ce(jdraft, *held_out)), ce_t.item()

        ces = [read()]
        for i in range(steps):
            tokens, labels = batches[i // fresh]
            jdraft, opt_j, _ = step_j(jdraft, opt_j, jnp.asarray(tokens),
                                      jnp.asarray(labels))
            draft, opt_t, _ = step_t(draft, opt_t,
                                     torch.from_numpy(tokens.copy()),
                                     torch.from_numpy(labels.copy()))
            ces.append(read())
        out[lr] = {"jax": [a for a, _ in ces], "torch": [b for _, b in ces]}
    return out


def test_cosine_decay_matches_optax():
    import optax

    want = optax.cosine_decay_schedule(3e-4, 50, alpha=0.1)
    got = td.cosine_decay(3e-4, 50, alpha=0.1)
    for count in (0, 1, 17, 49, 50, 80):
        assert math.isclose(got(count), float(want(count)), rel_tol=1e-6)


# -- the CLI -----------------------------------------------------------------

CLI_ARGS = ["--device", "cpu", "--batch", "2", "--seq", "16",
            "--eval-new-tokens", "8", "--eval-batch", "2", "--eval-pairs",
            "1", "--full-ffn", "--draft-k", "3"]


def run_cli(monkeypatch, capsys, cfg, argv):
    """The CLI's last stdout line, parsed; the root logger, which the CLI
    reconfigures (``basicConfig(force=True)``), is restored after."""
    monkeypatch.setattr(td, "target_config", lambda: cfg)
    root = logging.getLogger()
    level, handlers = root.level, root.handlers[:]
    try:
        assert td.main(argv) == 0
    finally:
        root.setLevel(level)
        root.handlers[:] = handlers
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_distills_evaluates_and_saves(monkeypatch, capsys, tmp_path):
    cfg = dataclasses.replace(CFG_T, max_seq_len=64)
    out = run_cli(monkeypatch, capsys, cfg, CLI_ARGS + [
        "--steps", "3", "--eval-ks", "1,3", "--lr-decay", "--save-draft",
        str(tmp_path / "draft")])
    assert out["distill_steps"] == 3 and out["eval_batch"] == 2
    assert set(out["per_k"]) == {"1", "3"}
    for row in out["per_k"].values():
        assert set(row) == {"acceptance", "cycles", "speedup_median_of_pairs",
                            "speedup_pairs", "plain_tok_s_best",
                            "speculative_tok_s_best"}
        assert 0.0 <= row["acceptance"] <= 1.0 and row["cycles"] >= 1
        assert len(row["speedup_pairs"]) == 1
    assert (tmp_path / "draft" / "draft.pt").exists()
    # the saved draft evaluates again, quantized, on corpus prompts
    out = run_cli(monkeypatch, capsys, cfg, CLI_ARGS + [
        "--steps", "0", "--load-draft", str(tmp_path / "draft"),
        "--int8-draft", "--prompt-data", "markov", "--loss", "mse"])
    assert out["distill_steps"] == 0 and set(out["per_k"]) == {"3"}
    with pytest.raises(SystemExit):
        run_cli(monkeypatch, capsys, cfg, CLI_ARGS + [
            "--steps", "2", "--load-draft", str(tmp_path / "draft")])


def test_cli_distills_against_a_trained_target(monkeypatch, capsys,
                                               tmp_path):
    """--target-ckpt restores a checkpoint of the port's trainer."""
    from nanotpu_torch.parallel import train

    ckpt = str(tmp_path / "ckpt")
    train.run(["--device", "cpu", "--steps", "2", "--seq", "17",
               "--checkpoint-dir", ckpt])
    cfg = tl.LlamaConfig(**train._PRESETS[("llama", "tiny")])
    out = run_cli(monkeypatch, capsys, cfg, CLI_ARGS + [
        "--steps", "1", "--target-ckpt", ckpt])
    assert set(out["per_k"]) == {"3"}
    with pytest.raises(SystemExit):
        run_cli(monkeypatch, capsys, cfg, CLI_ARGS + [
            "--steps", "1", "--target-ckpt", str(tmp_path / "none")])


def main(argv=None) -> None:
    """The held-out soft-CE of both packages' distillation, side by side,
    at the serving flagship's widths (dim 1024, 16/8 heads, FFN 2816, vocab
    32768, f32, dense attention) on a random target of ``--layers`` layers,
    with a 2-layer truncated-teacher draft: B=8, S=128, T=0.8, a fresh
    batch every 4 steps, as chip_smoke.py distills. One JSON line.

    PYTHONPATH=. python tests/test_torch_distill.py --layers 12 --steps 48
    """
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--steps", type=int, default=48)
    p.add_argument("--lrs", default="3e-4,1e-4,1e-5")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    cfg = jl.LlamaConfig(vocab_size=32768, dim=1024, n_layers=args.layers,
                         n_heads=16, n_kv_heads=8, ffn_dim=2816,
                         max_seq_len=256)
    target = jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(args.seed), cfg)
    lrs = [float(x) for x in args.lrs.split(",")]
    got = ce_trajectories(target, cfg, 2, lrs, args.steps, batch=8, seq=128,
                          seed=args.seed + 2)
    print(json.dumps({"layers": args.layers, "steps": args.steps,
                      "seed": args.seed, "held_out_ce": {
                          str(lr): v for lr, v in got.items()}}))


if __name__ == "__main__":
    main()
