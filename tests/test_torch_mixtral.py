"""nanotpu_torch's Mixtral MoE model on the CPU, against nanotpu's.

The tiny float32 configs of tests/test_mixtral.py, tests/test_generate.py
and tests/test_quant.py, with nanotpu's parameters carried over by
params_from_numpy and inputs drawn from a numpy seed.

Tolerances: routing decisions (expert one-hots, capacity slots, keep
flags, dispatch) exactly equal on the same f32 logits; routing weights
and combine within 1e-6 and the aux loss within 1e-6 of itself (the two
softmaxes' exp differ in the last bits of f32: a few 1e-8 on weights
below 1, 1.7e-6 on an aux of 4.0, measured). moe_block,
forward, prefill and decode at nanotpu's own rtol = atol = 2e-4
(tests/test_generate.py). The loss within 1e-5 and every gradient within
2e-5 (tests/test_torch_train.py's f32 tolerances). int8 values and scales
bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanotpu.models import generate as jg
from nanotpu.models import mixtral as jm
from nanotpu.models import quant as jq
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.models import generate as tg
from nanotpu_torch.models import mixtral as tm
from nanotpu_torch.models import quant as tq
from nanotpu_torch.parallel import train as ttrain
from nanotpu_torch.tree import leaves

torch.set_num_threads(2)
CFG_J, CFG_T = jm.MixtralConfig.tiny(), tm.MixtralConfig.tiny()
TOL = dict(rtol=2e-4, atol=2e-4)


def port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def cfgs(**over):
    return (dataclasses.replace(CFG_J, **over),
            dataclasses.replace(CFG_T, **over))


@pytest.fixture(scope="module")
def models():
    params = jax.jit(jm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), CFG_J)
    return params, port(params)


# -- routing ---------------------------------------------------------------

def _logits(case, T=64, E=4):
    rng = np.random.default_rng(T)
    if case == "all_to_expert_0":  # tests/test_mixtral.py's overflow case
        return np.tile(np.array([[10.0, 0.0, 0.0, 0.0]], np.float32), (T, 1))
    if case == "ties":  # exact ties among experts: the first index wins
        return rng.integers(0, 2, (T, E)).astype(np.float32)
    return rng.standard_normal((T, E)).astype(np.float32) * 2


ROUTING_CASES = [
    ("random", 1.25, None), ("random", 8.0, None), ("random", 0.25, None),
    ("random", 1.25, 128), ("all_to_expert_0", 0.25, None),
    ("ties", 1.25, None),
]


@pytest.mark.parametrize("case,cf,capacity", ROUTING_CASES)
def test_route_decisions_equal_nanotpus(case, cf, capacity):
    cfg_j, cfg_t = cfgs(capacity_factor=cf)
    logits = _logits(case)
    cj, aux_j, C_j = jm.route_decisions(jnp.asarray(logits), cfg_j, capacity)
    ct, aux_t, C_t = tm.route_decisions(torch.from_numpy(logits), cfg_t,
                                        capacity)
    assert C_t == C_j
    for (oh_j, pos_j, keep_j, w_j), (oh_t, pos_t, keep_t, w_t) in zip(cj, ct):
        np.testing.assert_array_equal(oh_t.numpy(), np.asarray(oh_j))
        np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
        np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-6)


@pytest.mark.parametrize("case,cf,capacity", ROUTING_CASES)
def test_route_topk_equals_nanotpus(case, cf, capacity):
    """tests/test_mixtral.py's TestRouting checks on the port's output, and
    dispatch, combine and aux against nanotpu's."""
    cfg_j, cfg_t = cfgs(capacity_factor=cf)
    logits = _logits(case)
    dj, cj, aj = jm.route_topk(jnp.asarray(logits), cfg_j, capacity)
    dt, ct, at = tm.route_topk(torch.from_numpy(logits), cfg_t, capacity)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(at.item(), float(aj), rtol=1e-6)
    C = dt.shape[-1]
    assert dt.shape == ct.shape == (64, 4, C)
    assert dt.sum(dim=0).max().item() <= 1.0  # one token a kept slot
    mass = ct.sum(dim=(1, 2))
    assert mass.max().item() <= 1.0 + 1e-6 and at.item() > 0
    if cf == 8.0:  # generous capacity: nothing dropped
        np.testing.assert_allclose(mass.numpy(), 1.0, atol=1e-5)
    if case == "all_to_expert_0":  # expert 0 full, its overflow dropped
        assert dt[:, 0, :].sum().item() == C < 64


# -- the MoE block ---------------------------------------------------------

@pytest.mark.parametrize("cf,full_capacity", [(1.25, False), (0.25, False),
                                              (0.25, True), (8.0, False)])
def test_moe_block_and_drops_equal_nanotpus(models, cf, full_capacity):
    params, tparams = models
    cfg_j, cfg_t = cfgs(capacity_factor=cf)
    x = np.random.default_rng(3).standard_normal((2, 16, CFG_T.dim),
                                                  np.float32)
    acc_j, acc_t = [], []
    out_j, aux_j = jm.moe_block(params["layers"][0]["moe"], jnp.asarray(x),
                                cfg_j, full_capacity=full_capacity,
                                drop_acc=acc_j)
    out_t, aux_t = tm.moe_block(tparams["layers"][0]["moe"],
                                torch.from_numpy(x), cfg_t,
                                full_capacity=full_capacity, drop_acc=acc_t)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), **TOL)
    np.testing.assert_array_equal(acc_t[0].numpy(), np.asarray(acc_j[0]))
    drops = int(acc_t[0].sum())
    if full_capacity or cf == 8.0:
        assert drops == 0
    elif cf == 0.25:
        assert drops > 0


def test_moe_block_matches_naive_loop(models):
    """tests/test_mixtral.py:58: the dense dispatch and combine equal the
    per-token loop over each token's top-k experts."""
    _, tparams = models
    cfg = dataclasses.replace(CFG_T, capacity_factor=8.0)  # no drops
    moe = tparams["layers"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 16, CFG_T.dim), np.float32))
    out, _ = tm.moe_block(moe, x, cfg)
    flat = x.reshape(-1, CFG_T.dim)
    probs = torch.softmax(flat @ moe["router"], dim=-1)
    want = torch.zeros_like(flat)
    for t in range(flat.shape[0]):
        w, top = torch.topk(probs[t], cfg.top_k)
        for weight, e in zip(w / w.sum(), top):
            h = flat[t] @ moe["w_gate"][e]
            u = flat[t] @ moe["w_up"][e]
            want[t] += weight * ((torch.nn.functional.silu(h) * u)
                                 @ moe["w_down"][e])
    np.testing.assert_allclose(out.reshape(-1, CFG_T.dim).numpy(),
                               want.numpy(), atol=2e-4)


# -- the model -------------------------------------------------------------

jax_forward = jax.jit(jm.forward, static_argnums=2)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_forward_logits_and_aux_equal_nanotpus(models, attn_impl):
    params, tparams = models
    cfg_j, cfg_t = cfgs(attn_impl=attn_impl)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 16))
    lj, aj = jax_forward(params, jnp.asarray(tokens), cfg_j)
    with torch.inference_mode():
        lt, at = tm.forward(tparams, torch.from_numpy(tokens), cfg_t)
    assert lt.shape == (2, 16, 256) and lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(at.item(), float(aj), **TOL)
    assert torch.isfinite(lt).all() and at.item() > 0


@pytest.mark.parametrize("S,attn_impl", [(32, "dense"), (32, "flash"),
                                         (512, "dense")])
def test_loss_and_every_gradient_equal_nanotpus(models, S, attn_impl):
    """S = 32 takes the one-piece cross entropy, S = 512 the chunked one:
    nanotpu's loss (mean NLL + router_aux_weight * aux) either way; the
    router's gradient runs through the combine weights and the aux loss."""
    params, tparams = models
    cfg_j, cfg_t = cfgs(attn_impl=attn_impl)
    tokens = np.random.default_rng(S).integers(0, 256, (2, S + 1))
    loss_j, grads_j = jax.jit(jax.value_and_grad(jm.loss_fn),
                              static_argnums=2)(params, jnp.asarray(tokens),
                                                cfg_j)
    ps = leaves(tparams)
    for p in ps:
        p.requires_grad_(True)
    try:
        loss_t = tm.loss_fn(tparams, torch.from_numpy(tokens), cfg_t)
        grads_t = torch.autograd.grad(loss_t, ps)
    finally:
        for p in ps:
            p.requires_grad_(False)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=0, atol=1e-5)
    want = jax.tree_util.tree_leaves(grads_j)
    assert len(want) == len(grads_t)
    for g_t, g_j in zip(grads_t, want):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                                   atol=2e-5)
    router = grads_t[[i for i, p in enumerate(ps)
                      if p is tparams["layers"][0]["moe"]["router"]][0]]
    assert router.abs().max().item() > 0


# -- decode ----------------------------------------------------------------

def test_prefill_and_decode_match_forward_and_nanotpu():
    """tests/test_generate.py:90: prefill, then greedy decode steps, each
    step's logits equal to the full forward's last position (capacity
    factor 8: no drop, so incremental and teacher-forced routing agree),
    and to nanotpu's prefill and decode_step."""
    over = dict(vocab_size=128, capacity_factor=8.0, max_seq_len=64)
    cfg_j, cfg_t = cfgs(**over)
    params = jm.init_params(jax.random.PRNGKey(0), cfg_j)
    tparams = port(params)
    B, S, N = 2, 5, 4
    prompt = np.random.default_rng(6).integers(0, 128, (B, S))
    jl, jcache = jax.jit(jg.prefill, static_argnums=(2, 3))(
        params, jnp.asarray(prompt), cfg_j, S + N)
    jstep = jax.jit(jg.decode_step, static_argnums=2)
    with torch.inference_mode():
        logits, cache = tg.prefill(tparams, torch.from_numpy(prompt), cfg_t,
                                   max_len=S + N)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        full, _ = tm.forward(tparams, torch.from_numpy(prompt), cfg_t)
        np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), **TOL)
        seq = torch.from_numpy(prompt)
        for _ in range(N):
            nxt = torch.argmax(logits, dim=-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
            full, _ = tm.forward(tparams, seq, cfg_t)
            jl, jcache = jstep(params, jnp.asarray(nxt.numpy()), cfg_j, jcache)
            logits, cache = tg.decode_step(tparams, nxt, cfg_t, cache)
            np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                                       **TOL)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert cache.length == S + N


def test_generate_greedy_equals_nanotpu(models):
    params, tparams = models
    prompt = np.random.default_rng(7).integers(0, 256, (2, 7))
    want = jax.jit(jg.generate, static_argnums=(2, 3))(
        params, jnp.asarray(prompt), CFG_J, 10)
    got = tg.generate(tparams, torch.from_numpy(prompt), CFG_T, 10)
    assert got.tolist() == np.asarray(want).tolist()


def test_prefill_counts_drops_like_nanotpu():
    """A tight capacity factor drops choices in prefill; both packages
    count the same per-token drops, one vector a layer."""
    cfg_j, cfg_t = cfgs(capacity_factor=0.25)
    params = jm.init_params(jax.random.PRNGKey(0), cfg_j)
    prompt = np.random.default_rng(8).integers(0, 256, (1, 12))
    acc_j, acc_t = [], []
    jg._run(params, jnp.asarray(prompt), cfg_j,
            jg.KVCache.create(cfg_j, 1, 16), full_prefill=True,
            drop_acc=acc_j)
    with torch.inference_mode():
        tg._run(port(params), torch.from_numpy(prompt), cfg_t,
                tg.KVCache.create(cfg_t, 1, 16, device="cpu"),
                full_prefill=True, drop_acc=acc_t)
    assert len(acc_t) == len(acc_j) == cfg_t.n_layers
    for a, b in zip(acc_t, acc_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sum(int(a.sum()) for a in acc_t) > 0


# -- int8 ------------------------------------------------------------------

def test_mixtral_quantized_forward_and_decode():
    """tests/test_quant.py:90: per-expert scales on the stacked [E, d, f]
    weights, the router left f32, the same int8 values and scales as
    nanotpu's (and nanotpu's quantized tree converts to the same leaves);
    the quantized forward within TV 0.05 of the full one and
    within 2e-4 of nanotpu's quantized forward; the cache path consumes
    the quantized tree."""
    over = dict(capacity_factor=4.0, max_seq_len=64)
    cfg_j, cfg_t = cfgs(**over)
    params = jm.init_params(jax.random.PRNGKey(0), cfg_j)
    tparams = port(params)
    qj = jq.quantize_params(params)
    qt = tq.quantize_params(tparams)
    wg = qt["layers"][0]["moe"]["w_gate"]
    assert isinstance(wg, tq.QArray)
    assert wg.s.shape == (cfg_t.n_experts, 1, cfg_t.ffn_dim)
    assert not isinstance(qt["layers"][0]["moe"]["router"], tq.QArray)
    for a, b in zip(leaves(qt), jax.tree_util.tree_leaves(qj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # nanotpu's quantized tree carries over as it is
    carried = port(qj)
    assert isinstance(carried["layers"][0]["moe"]["w_down"], tq.QArray)
    for a, b in zip(leaves(carried), leaves(qt)):
        assert a.dtype == b.dtype and torch.equal(a, b)

    tokens = np.random.default_rng(9).integers(0, 256, (2, 12))
    with torch.inference_mode():
        full, _ = tm.forward(tparams, torch.from_numpy(tokens), cfg_t)
        qlog, _ = tm.forward(qt, torch.from_numpy(tokens), cfg_t)
        tv = 0.5 * (torch.softmax(full, -1) - torch.softmax(qlog, -1)
                    ).abs().sum(-1).mean()
        assert tv.item() < 0.05, tv.item()
        qlog_j, _ = jax_forward(qj, jnp.asarray(tokens), cfg_j)
        np.testing.assert_allclose(qlog.numpy(), np.asarray(qlog_j), **TOL)
        pre, cache = tg.prefill(qt, torch.from_numpy(tokens), cfg_t,
                                max_len=16)
        np.testing.assert_allclose(pre.numpy(), qlog[:, -1].numpy(), **TOL)
        step, _ = tg.decode_step(qt, torch.argmax(pre, -1), cfg_t, cache)
        assert step.shape == (2, 256) and torch.isfinite(step).all()


# -- the converter ---------------------------------------------------------

def test_bf16_conversion_keeps_the_router_and_norms_f32():
    """nanotpu's bf16 Mixtral holds its router and norm gains in f32: the
    converter's dtype and chip_smoke's bf16 copy cast only the other
    matrices."""
    import chip_smoke

    cfg_j = dataclasses.replace(CFG_J, dtype="bfloat16")
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0), cfg_j))
    f32 = params_from_numpy(params, "cpu", dtype=torch.float32)
    for tree in (params_from_numpy(params, "cpu", dtype=torch.bfloat16),
                 chip_smoke.bf16_copy(f32)):
        layer = tree["layers"][0]
        assert layer["moe"]["router"].dtype == torch.float32
        np.testing.assert_array_equal(layer["moe"]["router"].numpy(),
                                      params["layers"][0]["moe"]["router"])
        for norm in (layer["attn_norm"], layer["moe_norm"],
                     tree["final_norm"]):
            assert norm.dtype == torch.float32
        for w in (layer["moe"]["w_gate"], layer["attn"]["wq"],
                  tree["embed"], tree["lm_head"]):
            assert w.dtype == torch.bfloat16
    port_init = tm.init_params(dataclasses.replace(CFG_T, dtype="bfloat16"),
                               torch.Generator().manual_seed(0), device="cpu")
    assert {k: str(v.dtype) for k, v in port_init["layers"][0]["moe"].items()
            } == {k: str(v.dtype) for k, v in params_from_numpy(
                params, "cpu")["layers"][0]["moe"].items()}


# -- the trainer -----------------------------------------------------------

def test_cli_trains_mixtral_tiny_on_cpu():
    out = ttrain.run(["--device", "cpu", "--model", "mixtral", "--preset",
                      "tiny", "--steps", "6", "--seq", "65", "--batch", "4",
                      "--data", "markov"])
    losses = [v for _, v in out["losses"]]
    assert [s for s, _ in out["losses"]] == list(range(1, 7))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    cfg = out["cfg"]
    assert isinstance(cfg, tm.MixtralConfig) and cfg.n_experts == 4
    moe = out["state"].params["layers"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].shape == (4, 128, 256)


def test_train_step_equals_nanotpus():
    """One AdamW step of each trainer on the tiny Mixtral from the same
    parameters (fresh ones: both steps update their state in place): the
    loss, and every updated parameter within a tenth of one Adam step
    (tests/test_torch_train.py's bound)."""
    from nanotpu.parallel import train as jtrain
    from nanotpu.parallel.mesh import make_mesh, mixtral_param_specs

    params = jm.init_params(jax.random.PRNGKey(0), CFG_J)
    tparams = port(params)
    tokens = np.random.default_rng(10).integers(0, 256, (2, 33)).astype(
        np.int32)
    mesh = make_mesh(devices=jax.devices()[:1])
    jopt = jtrain.make_optimizer()
    jstate = jtrain.TrainState(params, jopt.init(params),
                               jnp.zeros((), jnp.int32))
    jstep = jtrain.build_train_step(CFG_J, mesh, jopt, loss_fn=jm.loss_fn,
                                    param_specs=mixtral_param_specs(CFG_J))
    jstate, jloss = jstep(jstate, jnp.asarray(tokens))
    topt = ttrain.make_optimizer()
    tstate = ttrain.TrainState(tparams, topt.init(tparams), 0)
    step = ttrain.build_train_step(CFG_T, topt, loss_fn=tm.loss_fn)
    tstate, tloss = step(tstate, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=0, atol=1e-5)
    for a, b in zip(leaves(tstate.params),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=3e-5)


def test_fused_train_steps_equal_unfused_and_nanotpus():
    """build_train_step(n_fused=4) on a [4, B, S+1] block: the state and
    last loss bit-equal to 4 eager port steps, and within the train-step
    tolerances of nanotpu's n_fused=4 step (lax.scan over the block) from
    the same parameters."""
    from nanotpu.parallel import train as jtrain
    from nanotpu.parallel.mesh import make_mesh, mixtral_param_specs

    params = jm.init_params(jax.random.PRNGKey(0), CFG_J)
    start = jax.tree_util.tree_map(np.array, params)  # nanotpu donates its
    block = np.random.default_rng(11).integers(0, 256, (4, 2, 33)).astype(
        np.int32)
    mesh = make_mesh(devices=jax.devices()[:1])
    jopt = jtrain.make_optimizer()
    jstate = jtrain.TrainState(params, jopt.init(params),
                               jnp.zeros((), jnp.int32))
    jstep = jtrain.build_train_step(CFG_J, mesh, jopt, loss_fn=jm.loss_fn,
                                    param_specs=mixtral_param_specs(CFG_J),
                                    n_fused=4)
    jstate, jloss = jstep(jstate, jnp.asarray(block))

    topt = ttrain.make_optimizer()
    states, losses = [], []
    for n_fused in (1, 4):
        tparams = port(start)
        state = ttrain.TrainState(tparams, topt.init(tparams), 0)
        step = ttrain.build_train_step(CFG_T, topt, loss_fn=tm.loss_fn,
                                       n_fused=n_fused)
        rows = torch.from_numpy(block).long()
        for tokens in (rows if n_fused == 1 else [rows]):
            state, loss = step(state, tokens)
        states.append(state)
        losses.append(loss)
    (eager, fused), (want, got) = states, losses
    assert fused.step == eager.step == 4 == int(jstate.step)
    assert torch.equal(got, want)
    for a, b in zip(leaves(fused.params) + leaves(fused.opt_state),
                    leaves(eager.params) + leaves(eager.opt_state)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(got.item(), float(jloss), rtol=0, atol=1e-5)
    adam = jstate.opt_state[1][0]
    for mine, theirs, atol in ((fused.params, jstate.params, 3e-5),
                               (fused.opt_state["mu"], adam.mu, 1e-6),
                               (fused.opt_state["nu"], adam.nu, 1e-6)):
        for a, b in zip(leaves(mine), jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=0, atol=atol)
    assert int(fused.opt_state["count"]) == int(adam.count) == 4
