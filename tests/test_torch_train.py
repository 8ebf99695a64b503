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


@pytest.mark.parametrize("argv,want", [
    (["--tp", "2"], "does not divide 1 devices"),
    (["--dp", "2"], "mesh 2x1x1x1x1x1 needs 2 devices, have 1"),
    (["--sp", "2"], "does not divide 1 devices"),
    (["--pp", "2"], "fsdp*tp*ep*sp*pp=2 does not divide 1 devices"),
    (["--microbatches", "4"], None),
    (["--steps", "10", "--fuse-steps", "4"], "must be a multiple"),
    (["--model", "mixtral", "--remat"],
     "--remat is wired for the dense llama stack only"),
    (["--preset", "nope"], "no preset"),
])
def test_cli_refuses_what_is_not_ported(argv, want, capsys):
    """In one process, nanotpu's errors for a mesh larger than the world
    (``--pp 2`` among them); what nanotpu refuses too: a step count that is
    not a whole number of fused calls, ``--remat`` on Mixtral and a preset
    it lacks. ``--microbatches`` without ``--pp`` is nanotpu's no-op: the
    plain step trains (``want`` None)."""
    if want is None:
        out = ttrain.run(["--device", "cpu", "--steps", "2", "--seq", "33"]
                         + argv)
        assert [s for s, _ in out["losses"]] == [1, 2]
        assert out["mesh"] is None
        return
    with pytest.raises(SystemExit):
        ttrain.run(["--device", "cpu"] + argv)
    assert want in capsys.readouterr().err


@pytest.mark.parametrize("world,argv,want", [
    (1, ["--ep", "2"], "fsdp*tp*ep*sp*pp=2 does not divide 1 devices"),
    (1, ["--attn", "flash", "--sp", "2"], "conflicts with --sp 2"),
    (1, ["--attn", "ring"], "--attn ring runs over the sp axis of a mesh"),
    (2, ["--tp", "3"], "fsdp*tp*ep*sp*pp=3 does not divide 2 devices"),
    (3, ["--model", "mixtral", "--ep", "3"],
     "indivisible sharding: n_experts 4 % ep 3"),
    (2, ["--steps", "3", "--fuse-steps", "2"],
     "--steps 3 must be a multiple of --fuse-steps 2"),
])
def test_cli_refuses_on_a_mesh_what_is_not_ported(monkeypatch, capsys, world,
                                                  argv, want):
    """nanotpu's own checks (an ep that does not divide the world or the
    experts), and fused calls that do not divide the steps, refused before
    a mesh is made (a joined group of ``world`` processes is only pretended
    here). ``--model mixtral --ep 2`` trains: ``tests/test_torch_ep.py``;
    ``--fuse-steps`` on a mesh: ``tests/test_torch_ring.py``."""
    monkeypatch.setattr(ttrain.dist, "is_initialized", lambda: world > 1)
    monkeypatch.setattr(ttrain.dist, "get_world_size", lambda: world)
    with pytest.raises(SystemExit):
        ttrain.run(["--device", "cpu"] + argv)
    assert want in capsys.readouterr().err


def test_mesh_step_refuses_fused_steps_and_other_losses():
    """On a mesh, fewer than one fused step is refused, and a loss that
    does not run on a mesh's shards, fused or not; Mixtral's loss is taken
    (its mesh step: ``tests/test_torch_ep.py``; fused mesh steps:
    ``tests/test_torch_ring.py``)."""
    cfg, opt = tl.LlamaConfig.tiny(), ttrain.make_optimizer()
    with pytest.raises(ValueError, match="n_fused must be at least 1"):
        ttrain.build_train_step(cfg, opt, n_fused=0, mesh=object())
    for n_fused in (1, 2):
        with pytest.raises(ValueError, match="Llama or Mixtral loss, or a "
                                             "pipelined one"):
            ttrain.build_train_step(cfg, opt, loss_fn=lambda *a: None,
                                    n_fused=n_fused, mesh=object())


def test_ring_attention_needs_a_mesh():
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), attn_impl="ring")
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="runs on a mesh"):
        tl.loss_fn(params, torch.zeros((1, 9), dtype=torch.long), cfg)


# -- fused steps, the device step count, the profiler ------------------------

def _fresh_state(cfg, opt):
    return ttrain.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                   device="cpu")


def _state_tensors(state):
    return leaves(state.params) + leaves(state.opt_state)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_fused_steps_equal_unfused(attn):
    """n_fused=4 on a [4, B, S+1] block runs the body of 4 eager steps:
    the last loss, parameters, moments and count are bit-equal."""
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), attn_impl=attn)
    block = torch.from_numpy(np.stack([tokens_for(20 + i, 2, 33)
                                       for i in range(4)]))
    opt = ttrain.make_optimizer()
    eager = _fresh_state(cfg, opt)
    step = ttrain.build_train_step(cfg, opt)
    for row in block:
        eager, want = step(eager, row)
    fused = _fresh_state(cfg, opt)
    fstep = ttrain.build_train_step(cfg, opt, n_fused=4)
    assert isinstance(fstep, ttrain.FusedTrainStep)
    fused, got = fstep(fused, block)
    assert fused.step == eager.step == 4 and fstep.graphed is None
    assert torch.equal(got, want) and not got.requires_grad
    for a, b in zip(_state_tensors(fused), _state_tensors(eager)):
        assert torch.equal(a, b)
    assert fused.opt_state["count"].dtype == torch.int32
    assert int(fused.opt_state["count"]) == 4
    with pytest.raises(ValueError, match="want tokens"):
        fstep(fused, block[:3])


def test_fused_steps_match_jax(jax_params):
    """The port's n_fused=4 step against nanotpu's (lax.scan over the
    block) on a one-device mesh, flash attention in both, from the same
    parameters: the last loss and the state at the train-step
    tolerances."""
    over = dict(attn_impl="flash")
    cfg_j = dataclasses.replace(jl.LlamaConfig.tiny(), **over)
    cfg_t = dataclasses.replace(tl.LlamaConfig.tiny(), **over)
    start = jax.tree_util.tree_map(np.array, jax_params)
    block = np.stack([tokens_for(300 + i, 2, 33) for i in range(4)])

    opt_j = jtrain.make_optimizer()
    mesh = make_mesh(devices=jax.devices()[:1])
    state_j = jtrain.place_state(
        jtrain.TrainState(jax_params, opt_j.init(jax_params),
                          jnp.zeros((), jnp.int32)), cfg_j, mesh)
    state_j, loss_j = jtrain.build_train_step(cfg_j, mesh, opt_j, n_fused=4)(
        state_j, jnp.asarray(block))

    opt_t = ttrain.make_optimizer()
    params = params_from_numpy(start, "cpu")
    state_t = ttrain.TrainState(params, opt_t.init(params), 0)
    state_t, loss_t = ttrain.build_train_step(cfg_t, opt_t, n_fused=4)(
        state_t, torch.from_numpy(block))

    assert state_t.step == 4 == int(state_j.step)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-5)
    adam_j = state_j.opt_state[1][0]
    for got, want, atol in ((state_t.params, state_j.params, 3e-5),
                             (state_t.opt_state["mu"], adam_j.mu, 1e-6),
                             (state_t.opt_state["nu"], adam_j.nu, 1e-6)):
        for a, b in zip(leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=atol)
    assert int(state_t.opt_state["count"]) == int(adam_j.count)


def test_bias_corrections_equal_numpy_f32():
    """1 - b ** count on the device, for counts 1-1000, within one ulp of
    the f32 values the host computed in numpy before the count moved to
    the device (``np.float32(1) - np.float32(b) ** np.int32(count)``)."""
    count = torch.arange(1, 1001, dtype=torch.int32)
    got = ttrain.bias_corrections(count, 0.9, 0.95)
    for g, b in zip(got, (0.9, 0.95)):
        assert g.dtype == torch.float32 and g.shape == count.shape
        want = np.array([np.float32(1) - np.float32(b) ** np.int32(c)
                         for c in range(1, 1001)], dtype=np.float32)
        np.testing.assert_array_max_ulp(g.numpy(), want, maxulp=1)


def test_count_lives_on_the_device_and_advances_in_place():
    opt = ttrain.make_optimizer()
    p = {"w": torch.ones(4)}
    state = opt.init(p)
    count = state["count"]
    assert count.dtype == torch.int32 and count.shape == ()
    for _ in range(3):
        opt.update([torch.full((4,), 0.1)], state, p)
    assert state["count"] is count and int(count) == 3


def test_restore_reads_a_checkpoint_with_an_int_count(tmp_path):
    """A checkpoint whose count is a Python int (the format written before
    the count moved to the device) restores with a tensor count and trains
    on from it."""
    cfg = tl.LlamaConfig.tiny()
    opt = ttrain.make_optimizer()
    state = _fresh_state(cfg, opt)
    step = ttrain.build_train_step(cfg, opt)
    tokens = torch.from_numpy(tokens_for(5, 2, 17))
    for _ in range(2):
        state, _ = step(state, tokens)
    path = tmp_path / "step_2"
    path.mkdir()
    torch.save({"params": map_tree(lambda t: t.detach(), state.params),
                "opt_state": {"count": 2, "mu": state.opt_state["mu"],
                              "nu": state.opt_state["nu"]},
                "step": 2}, path / "state.pt")
    like = ttrain.init_train_state(torch.Generator().manual_seed(1), cfg, opt,
                                   device="cpu")
    got = ttrain.restore_checkpoint(str(tmp_path), like)
    count = got.opt_state["count"]
    assert got.step == 2 and count.dtype == torch.int32 and int(count) == 2
    got, loss = step(got, tokens)
    state, want = step(state, tokens)
    assert int(got.opt_state["count"]) == 3 and torch.equal(loss, want)
    for a, b in zip(_state_tensors(got), _state_tensors(state)):
        assert torch.equal(a, b)


def test_cli_fused_steps_runs_and_steps_count(tmp_path):
    """tests/test_train_cli.py's case: --fuse-steps K trains K optimizer
    steps a call, and the checkpoint's step counts every step."""
    ckpt = tmp_path / "ck"
    out = ttrain.run(["--device", "cpu", "--model", "llama", "--preset",
                      "tiny", "--steps", "8", "--fuse-steps", "4", "--batch",
                      "2", "--seq", "32", "--checkpoint-dir", str(ckpt),
                      "--save-every", "8"])
    assert [s for s, _ in out["losses"]] == [4, 8]
    assert out["state"].step == 8 and out["tok_s"] > 0
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_8"]
    cfg = tl.LlamaConfig(**ttrain._PRESETS[("llama", "tiny")])
    opt = ttrain.make_optimizer()
    restored = ttrain.restore_checkpoint(str(ckpt), _fresh_state(cfg, opt))
    assert restored.step == 8 and int(restored.opt_state["count"]) == 8


def test_cli_fused_losses_equal_unfused(tmp_path):
    """The same data (gen_chunk is a whole number of calls) through
    --fuse-steps 2 and 1: every fused call's loss is the unfused run's at
    that step."""
    argv = ["--device", "cpu", "--steps", "6", "--seq", "33", "--data",
            "markov"]
    one = dict(ttrain.run(argv)["losses"])
    two = ttrain.run(argv + ["--fuse-steps", "2"])["losses"]
    assert [s for s, _ in two] == [2, 4, 6]
    assert all(v == one[s] for s, v in two)


def test_cli_profile_dir_writes_a_trace(tmp_path):
    """--profile-dir traces the steady-state calls into a TensorBoard
    trace with aten:: events."""
    prof = tmp_path / "prof"
    out = ttrain.run(["--device", "cpu", "--steps", "8", "--fuse-steps", "4",
                      "--data", "markov", "--seq", "65", "--attn", "flash",
                      "--profile-dir", str(prof)])
    assert [s for s, _ in out["losses"]] == [4, 8]
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert '"aten::' in traces[0].read_text()


def test_cli_profile_dir_needs_two_calls(tmp_path, caplog):
    """With --steps < 2 x --fuse-steps there is no steady-state call:
    nanotpu's warning, and no trace."""
    prof = tmp_path / "prof"
    with caplog.at_level("WARNING", logger="nanotpu_torch.train"):
        ttrain.run(["--device", "cpu", "--steps", "1", "--profile-dir",
                    str(prof)])
    assert "--profile-dir ignored" in caplog.text
    assert not prof.exists() or not any(prof.iterdir())


def test_map_tree_keeps_structure():
    tree = {"a": [torch.ones(1), (torch.zeros(2),)], "b": torch.ones(3)}
    doubled = map_tree(lambda t: t * 2, tree)
    assert isinstance(doubled["a"][1], tuple)
    assert [t.sum().item() for t in leaves(doubled)] == [2.0, 0.0, 6.0]
