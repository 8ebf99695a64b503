"""nanotpu_torch's training slice on the CPU against nanotpu's: the chunked
loss and its gradients, AdamW train steps from the same parameters, the
synthetic corpus, checkpoint resume and the CLI.

Everything runs LlamaConfig.tiny() in float32 with the JAX parameters
carried over by params_from_numpy. Tolerances: loss atol 1e-5 and
gradients atol 2e-5 (two frameworks' matmul and reduction orders over 2
layers and a 256-way softmax); train-step losses atol 1e-5, Adam moments
atol 1e-6, updated parameters atol 3e-5: a tenth of one Adam step (lr
3e-4), since where a gradient is near zero Adam's m / (sqrt(v) + eps)
magnifies the frameworks' ~1e-8 gradient differences up to a whole step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanotpu.data.synthetic as jsyn
from nanotpu.models import llama as jl
from nanotpu.parallel import train as jtrain
from nanotpu.parallel.mesh import make_mesh
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.data import synthetic as tsyn
from nanotpu_torch.data.tokens import write_tokens
from nanotpu_torch.models import llama as tl
from nanotpu_torch.parallel import train as ttrain
from nanotpu_torch.tree import leaves, map_tree

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_params():
    return jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jl.LlamaConfig.tiny())


def port(params):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


def tokens_for(seed, B, S1, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S1)).astype(np.int32)


@pytest.mark.parametrize("S,attn,remat", [
    (64, "dense", "off"), (64, "flash", "off"), (64, "flash", "full"),
    (64, "dense", "dots"), (512, "dense", "off"), (512, "flash", "off"),
    (512, "flash", "full"), (512, "flash", "dots"),
])
def test_loss_and_grads_match_jax(jax_params, S, attn, remat):
    """S <= CE_CHUNK runs the one-piece cross entropy, S = 512 the chunked
    one; remat recomputes layers without changing any number."""
    over = dict(attn_impl=attn, remat=remat != "off",
                remat_policy="full" if remat == "off" else remat)
    cfg_j = dataclasses.replace(jl.LlamaConfig.tiny(), **over)
    cfg_t = dataclasses.replace(tl.LlamaConfig.tiny(), **over)
    assert tl.CE_CHUNK == jl.CE_CHUNK
    tokens = tokens_for(S, 2, S + 1)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jl.loss_fn), static_argnums=2)(
        jax_params, jnp.asarray(tokens), cfg_j)
    params = port(jax_params)
    ws = leaves(params)
    for w in ws:
        w.requires_grad_(True)
    loss_t = tl.loss_fn(params, torch.from_numpy(tokens), cfg_t)
    grads_t = torch.autograd.grad(loss_t, ws)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-5)
    flat_j = jax.tree_util.tree_leaves(grads_j)
    assert len(flat_j) == len(grads_t)
    for g_t, g_j in zip(grads_t, flat_j):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=2e-5)


def test_param_count_matches_jax(jax_params):
    assert tl.param_count(port(jax_params)) == jl.param_count(jax_params)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(jax_params, n_steps):
    """AdamW with global-norm clipping, from the same parameters on the
    same batches: nanotpu's jitted step on a one-device mesh against the
    port's eager step."""
    cfg_j, cfg_t = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    start = jax.tree_util.tree_map(np.asarray, jax_params)
    batches = [tokens_for(100 + i, 2, 33) for i in range(n_steps)]

    opt_j = jtrain.make_optimizer()
    mesh = make_mesh(devices=jax.devices()[:1])
    state_j = jtrain.TrainState(jax_params, opt_j.init(jax_params),
                                jnp.zeros((), jnp.int32))
    state_j = jtrain.place_state(state_j, cfg_j, mesh)
    step_j = jtrain.build_train_step(cfg_j, mesh, opt_j)
    losses_j = []
    for b in batches:
        state_j, loss = step_j(state_j, jnp.asarray(b))
        losses_j.append(float(loss))

    opt_t = ttrain.make_optimizer()
    params = params_from_numpy(start, "cpu")
    state_t = ttrain.TrainState(params, opt_t.init(params), 0)
    step_t = ttrain.build_train_step(cfg_t, opt_t)
    losses_t = []
    for b in batches:
        state_t, loss = step_t(state_t, torch.from_numpy(b))
        losses_t.append(loss.item())

    assert state_t.step == n_steps == int(state_j.step)
    np.testing.assert_allclose(losses_t, losses_j, atol=1e-5)
    adam_j = state_j.opt_state[1][0]
    for got, want, atol in ((state_t.params, state_j.params, 3e-5),
                             (state_t.opt_state["mu"], adam_j.mu, 1e-6),
                             (state_t.opt_state["nu"], adam_j.nu, 1e-6)):
        for a, b in zip(leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=atol)
    assert state_t.opt_state["count"] == int(adam_j.count)


def test_clip_only_at_or_above_max_norm():
    """optax's rule: gradients below the max norm pass unchanged, those at
    or above it scale by max_norm / norm (no epsilon)."""
    opt = ttrain.AdamW(lr=1.0, b1=0.0, b2=0.0, eps=0.0, weight_decay=0.0)
    for g, want in ((0.5, 0.5), (3.0, 1.0)):
        p = {"w": torch.zeros(1)}
        state = opt.init(p)
        # b1 = b2 = 0: the update is -lr * g / |g| whatever the scale, so
        # read the clipped gradient off the first moment instead
        opt.update([torch.tensor([g])], state, p)
        assert state["mu"]["w"].item() == pytest.approx(want, abs=1e-7)


def test_bf16_momentum_keeps_mu_in_bf16():
    opt = ttrain.make_optimizer(mu_dtype=torch.bfloat16)
    p = {"w": torch.ones(4)}
    state = opt.init(p)
    opt.update([torch.full((4,), 0.1)], state, p)
    assert state["mu"]["w"].dtype == torch.bfloat16
    assert state["nu"]["w"].dtype == torch.float32


def test_checkpoint_resume_picks_newest(tmp_path):
    cfg = tl.LlamaConfig.tiny()
    opt = ttrain.make_optimizer()
    gen = torch.Generator().manual_seed(0)
    state = ttrain.init_train_state(gen, cfg, opt, device="cpu")
    step = ttrain.build_train_step(cfg, opt)
    tokens = torch.from_numpy(tokens_for(1, 2, 17))
    saved = {}
    for _ in range(3):
        state, _ = step(state, tokens)
        ttrain.save_checkpoint(str(tmp_path), state)
        saved[state.step] = [t.detach().clone() for t in leaves(state.params)]
    (tmp_path / "step_junk").mkdir()
    (tmp_path / "step_99").mkdir()  # no state file: an interrupted save
    like = ttrain.init_train_state(torch.Generator().manual_seed(1), cfg, opt,
                                   device="cpu")
    got = ttrain.restore_checkpoint(str(tmp_path), like)
    assert got.step == 3 and got.opt_state["count"] == 3
    for a, b in zip(leaves(got.params), saved[3]):
        assert torch.equal(a.detach(), b) and a.requires_grad
    assert ttrain.restore_checkpoint(str(tmp_path / "none"), like) is None


def test_markov_table_equals_jax():
    for vocab, seed in ((512, 0), (300, 7)):
        got = tsyn.markov_table(vocab, seed=seed, device="cpu")
        assert got.shape == (vocab, 4)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jsyn.markov_table(vocab, seed=seed)))
    assert tsyn.ideal_ce() == jsyn.ideal_ce()


def test_markov_batch_follows_the_chain():
    """Every successor lies in its token's table row, and the successor
    positions are distributed as softmax(succ_logits): total variation
    under 0.03 over 12,736 transitions (sampling noise is ~0.01)."""
    table = tsyn.markov_table(512, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    toks = tsyn.markov_batch(gen, table, (4, 16, 200))
    assert toks.shape == (4, 16, 200) and toks.dtype == torch.int64
    prev, nxt = toks[..., :-1].reshape(-1), toks[..., 1:].reshape(-1)
    rows = table[prev]
    hits = rows == nxt[:, None]
    assert hits.any(dim=1).all()
    unique = torch.tensor([len(set(r.tolist())) == 4 for r in rows])
    pos = hits[unique].float().argmax(dim=1)
    freq = torch.bincount(pos, minlength=4).double() / len(pos)
    want = torch.softmax(torch.tensor(tsyn.DEFAULT_SUCC_LOGITS,
                                      dtype=torch.float64), 0)
    assert 0.5 * (freq - want).abs().sum().item() < 0.03


@pytest.mark.parametrize("extra", [
    ["--data", "markov", "--attn", "flash"],
    ["--data", "random", "--remat", "--remat-policy", "dots",
     "--bf16-momentum"],
    ["--data", "file"],
])
def test_cli_trains_tiny_on_cpu(tmp_path, extra):
    if "file" in extra:
        path = tmp_path / "toks.bin"
        write_tokens(str(path), np.arange(5000) % 512, vocab_size=512)
        extra = extra + ["--data-path", str(path)]
    argv = ["--device", "cpu", "--steps", "3", "--seq", "33",
            "--checkpoint-dir", str(tmp_path / "ck"), "--save-every", "2"]
    out = ttrain.run(argv + extra)
    assert [s for s, _ in out["losses"]] == [1, 2, 3]
    assert all(np.isfinite(v) for _, v in out["losses"])
    assert out["tok_s"] > 0 and out["state"].step == 3
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_2", "step_3"]
    assert ttrain.main(argv + extra + ["--steps", "1"]) == 0
    resumed = ttrain.run(argv + extra + ["--steps", "1"])
    assert resumed["losses"][0][0] == 5  # after main's step 4


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tl.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.init_train_state(torch.Generator().manual_seed(0), cfg,
                                ttrain.make_optimizer())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsyn.markov_table(64)


def test_cli_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run(["--steps", "1"])


@pytest.mark.parametrize("argv", [
    ["--tp", "2"], ["--dp", "2"], ["--sp", "2"], ["--pp", "2"],
    ["--microbatches", "4"], ["--fuse-steps", "2"], ["--profile-dir", "x"],
    ["--model", "mixtral"], ["--preset", "nope"],
])
def test_cli_refuses_what_is_not_ported(argv, capsys):
    with pytest.raises(SystemExit):
        ttrain.run(["--device", "cpu"] + argv)
    want = "no preset" if argv[-1] == "nope" else "not ported"
    assert want in capsys.readouterr().err


def test_map_tree_keeps_structure():
    tree = {"a": [torch.ones(1), (torch.zeros(2),)], "b": torch.ones(3)}
    doubled = map_tree(lambda t: t * 2, tree)
    assert isinstance(doubled["a"][1], tuple)
    assert [t.sum().item() for t in leaves(doubled)] == [2.0, 0.0, 6.0]
