"""nanotpu_torch's Mixtral over the ep axis on the CPU, in one process
group of gloo, against nanotpu's on its virtual CPU devices.

One group of four processes runs once for the whole file (``spmd``
fixture) and builds every mesh from it in turn: one train step on dp2 x
ep2, fsdp2 x ep2, tp2 x ep2 and sp2 x ep2 (the ring); the pipelined MoE
step on pp2 x ep2 and pp2 x sp2 (nanotpu's dry-run meshes,
``__graft_entry__.py``); ``generate``, ``speculative_generate`` and
``Engine(mesh=)`` on tp2 x ep2 (``tests/test_sharded_decode.py``'s MoE
case); and the trainer's CLI at ``--model mixtral --ep 2``. The children
import torch and the port only; they read their inputs (numpy, made here
from a seed) from a pickle, and every rank writes its results to its own.
This process computes nanotpu's results meanwhile: its routing decisions
and, by its trainer's step (loss, gradients, one clipped AdamW update of
``nanotpu.parallel.train.make_optimizer``), the loss, gradients and
updated parameters of each case, on one device (the plain step: nanotpu's
program has global semantics) or on the case's mesh (the pipeline).

The configs are f32: ``MixtralConfig.tiny()`` and the dry run's (vocab
512, dim 128, 2 layers, 8/4 heads, ffn 256, 4 experts, top 2), both at a
capacity factor of 1.0 in training, so that experts overflow and a rank
that routed only its own tokens would drop others than nanotpu does.
Routing decisions (each token's experts, capacity slots and drops) are
held exactly against nanotpu's forward on the same tokens: the whole batch
for a step, each microbatch for the pipeline. Tolerances are
``tests/test_torch_ring.py``'s: loss 1e-5, gradients 1e-4, parameters
after one step 3e-5; greedy tokens exactly. One step of Adam divides each
gradient element by its magnitude plus eps (1e-8), so an element whose
gradient lies within rounding of zero (under 1e-6 here) moves by what
rounding decides, up to the learning rate: such elements are held to
twice the learning rate, and their gradients to 1e-4 as every other.

Each case also runs three steps in one call (``build_train_step(...,
mesh=, n_fused=3)``) from the same state, against nanotpu's
``n_fused=3`` (on one device, or on the case's mesh for the pipeline):
every step's routing decisions exactly those of nanotpu's forward on its
own parameters before that step, and the last loss, the step count, the
parameters and Adam's moments after the call, each one-step tolerance
widened by the step count, three times: loss 3e-5, parameters 9e-5 (six
times the learning rate where a step's gradient is within rounding of
zero), moments 3e-5 (the gradients' 1e-4 times Adam's (1 - b1), thrice).
The CLI runs ``--fuse-steps 3`` beside the unfused run in the group."""

import dataclasses
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax

from nanotpu.models import generate as jgen
from nanotpu.models import mixtral as jmix
from nanotpu.parallel import infer as jinfer
from nanotpu.parallel import pipeline as jpp
from nanotpu.parallel import train as jtrain
from nanotpu.parallel import mesh as jmesh
from nanotpu.parallel.mesh import make_mesh as jmake_mesh
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.models import mixtral as tmix
from nanotpu_torch.models.speculative import speculative_generate
from nanotpu_torch.parallel import train as ttrain
from nanotpu_torch.serving.engine import Engine

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
WORLD = 4

CONFIGS = {
    "tiny": dataclasses.replace(jmix.MixtralConfig.tiny(),
                                capacity_factor=1.0),
    "dry": jmix.MixtralConfig(
        vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
        ffn_dim=256, n_experts=4, top_k=2, max_seq_len=128,
        capacity_factor=1.0, dtype="float32"),
}
#: mesh -> (factors, config, the port's attention, microbatches (0: the
#: plain step), token rows); 33 tokens a row, so 32 after the shift. Cases
#: of one config and row count share their tokens (and nanotpu's results)
MESHES = {
    "dp2_ep2": (dict(dp=2, ep=2), "dry", "dense", 0, 4),
    "fsdp2_ep2": (dict(fsdp=2, ep=2), "dry", "dense", 0, 4),
    "tp2_ep2": (dict(tp=2, ep=2), "tiny", "flash", 0, 2),
    "sp2_ep2": (dict(sp=2, ep=2), "tiny", "ring", 0, 2),
    "pp2_ep2": (dict(pp=2, ep=2), "dry", "dense", 4, 4),
    "pp2_sp2": (dict(pp=2, sp=2), "dry", "ring", 2, 4),
}
#: the serving mesh, its prompt and requests: each (prompt, new tokens)
SERVE_MESH = dict(tp=2, ep=2)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
N_NEW = 8
REQUESTS = [([5, 6, 7], 8), ([9, 8], 8), ([1, 2, 3, 4, 5, 6], 8)]
ENGINE_KW = dict(slots=3, max_len=64, buckets=(16,), chunk_steps=4,
                 chunk_steps_max=8)
#: the engines' capacity factors: a loose one (no drop: its tokens are
#: nanotpu's generate's) and one so tight that prefill drops
LOOSE_CF, TIGHT_CF = 8.0, 0.05
CLI_ARGV = ["--device", "cpu", "--model", "mixtral", "--preset", "tiny",
            "--steps", "3", "--batch", "4", "--seq", "33", "--data", "markov"]
N_FUSED = 3

CHILD = r"""
import dataclasses, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, where = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{where}/rdv",
                        rank=rank, world_size=world)
from torch.distributed.tensor import DTensor, distribute_tensor
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.models import generate as tg, mixtral as tmix
from nanotpu_torch.models.speculative import speculative_generate
from nanotpu_torch.parallel import infer, mesh as tm, pipeline as tpp
from nanotpu_torch.parallel import train as ttrain
from nanotpu_torch.serving.engine import Engine
from nanotpu_torch.tree import leaves, map_tree

with open(f"{where}/in.pkl", "rb") as f:
    inp = pickle.load(f)
out = {"coords": None}

# every routing decision the model takes, as numpy: per call, per choice,
# (expert, capacity slot, kept)
calls = []
route = tmix.route_decisions

def recording(logits, cfg, capacity=None):
    choices, aux, C = route(logits, cfg, capacity)
    calls.append([(c[0].argmax(-1).numpy(), c[1].numpy(), c[2].numpy())
                  for c in choices])
    return choices, aux, C

tmix.route_decisions = recording

def whole(t):
    return t.full_tensor().detach().numpy()

for name, (factors, cfg_name, attn, n_micro, _) in inp["meshes"].items():
    mesh = tm.make_mesh(**factors)
    cfg = tmix.MixtralConfig(**{**inp["cfgs"][cfg_name], "attn_impl": attn})
    params = params_from_numpy(inp["params"][cfg_name], "cpu")
    tokens = torch.from_numpy(inp["tokens"][name])
    if n_micro:
        params = tpp.stack_layers(params)
        specs = tpp.mixtral_pp_param_specs(cfg)
        loss_fn = tpp.make_pipelined_loss(mesh, n_micro, model="mixtral")
    else:
        specs = tm.mixtral_param_specs(cfg)
        loss_fn = tmix.loss_fn
    placed = map_tree(lambda t, s: distribute_tensor(
        t, mesh, tm.placements_for(mesh, s, t.dim()), src_data_rank=None),
        params, specs)
    shard = tm.Shards(mesh, specs)
    loc = map_tree(lambda t: t.to_local().detach().requires_grad_(), placed)
    rows = distribute_tensor(tokens, mesh, tm.placements_for(
        mesh, tm.BATCH_SPEC, 2), src_data_rank=None).to_local()
    calls.clear()
    loss = loss_fn(loc, rows, cfg, shard=shard)
    res = {"routing": list(calls), "rank": dict(shard.rank)}
    grads = shard.reduce_grads(list(torch.autograd.grad(loss, leaves(loc))),
                               tm.spec_leaves(specs, loc))
    res["norm"] = shard.global_norm(grads, tm.spec_leaves(specs, loc)).item()
    it = iter(grads)
    local_grads = map_tree(lambda _: next(it).numpy(), loc)
    res["local_grads"] = local_grads
    it = iter(grads)
    res["grads"] = map_tree(lambda p: DTensor.from_local(
        next(it), mesh, p.placements, run_check=False, shape=p.shape,
        stride=p.stride()).full_tensor().numpy(), placed)
    res["loss"] = shard.sum_over_data(loss.detach()).item()
    moe = placed["layers"]["moe"] if n_micro else placed["layers"][0]["moe"]
    res["w_gate_local"] = tuple(moe["w_gate"].to_local().shape)

    opt = ttrain.make_optimizer()
    state = ttrain.place_state(
        ttrain.TrainState(params, opt.init(params), 0), cfg, mesh,
        param_specs=specs)
    step = ttrain.build_train_step(cfg, opt, loss_fn=loss_fn, mesh=mesh,
                                   param_specs=specs)
    state, step_loss = step(state, tokens)
    res["step_loss"] = step_loss.item()
    res["step_params"] = map_tree(whole, state.params)

    # n_fused steps in one call from the same state (fresh tensors: a
    # replicated DTensor shares its input's), every step's routing kept
    params = params_from_numpy(inp["params"][cfg_name], "cpu")
    if n_micro:
        params = tpp.stack_layers(params)
    state = ttrain.place_state(
        ttrain.TrainState(params, opt.init(params), 0), cfg, mesh,
        param_specs=specs)
    step = ttrain.build_train_step(cfg, opt, loss_fn=loss_fn, mesh=mesh,
                                   param_specs=specs, n_fused=inp["n_fused"])
    calls.clear()
    state, fused_loss = step(state, torch.from_numpy(inp["fused"][name]))
    res["fused"] = {
        "loss": fused_loss.item(), "step": state.step,
        "kind": type(step).__name__, "routing": list(calls),
        "params": map_tree(whole, state.params),
        "mu": map_tree(whole, state.opt_state["mu"]),
        "nu": map_tree(whole, state.opt_state["nu"])}
    out[name] = res
tmix.route_decisions = route

# serving on tp2 x ep2
mesh = tm.make_mesh(**inp["serve_mesh"])
cfg = tmix.MixtralConfig(**inp["cfgs"]["serve"])
params = params_from_numpy(inp["params"]["serve"], "cpu")
prompt = torch.tensor([inp["prompt"]])
placed = infer.place_params(params, cfg, mesh)
out["w_gate_serve_local"] = tuple(
    placed["layers"][0]["moe"]["w_gate"].to_local().shape)
out["generate"] = tg.generate(placed, prompt, cfg, inp["n_new"],
                              mesh=mesh)[0].tolist()
dcfg = dataclasses.replace(cfg, n_layers=1)
draft = {**params, "layers": [params["layers"][0]]}
out["speculative"] = speculative_generate(
    placed, infer.place_params(draft, dcfg, mesh), prompt, cfg, dcfg,
    inp["n_new"], draft_tokens=3, mesh=mesh)[0].tolist()
for label, cf in inp["engine_cfs"].items():
    ecfg = dataclasses.replace(cfg, capacity_factor=cf)
    eng = Engine(params, ecfg, mesh=mesh, device="cpu", **inp["engine_kw"])
    assert eng.wait_warm(120)
    res = {"w_gate_local": tuple(eng.params["layers"][0]["moe"]["w_gate"]
                                 .shape)}
    if rank == 0:
        reqs = [eng.submit(p, n) for p, n in inp["requests"]]
        for r in reqs:
            assert r.wait(120) and r.error is None, r.error
        eng.stop()
        res["outs"] = [r.out for r in reqs]
    else:
        eng.stop(timeout=120)
        res["outs"] = [r.out for r in eng.followed]
    res["drops"] = eng.moe_prefill_dropped_total
    res["stats_drops"] = eng.stats()["moe_prefill_dropped_total"]
    out[("engine", label)] = res

# the trainer's CLI in this group: dp absorbs what --ep leaves
cli = ttrain.run(inp["cli_argv"] + ["--ep", "2"])
out["cli"] = {"losses": cli["losses"], "mesh": cli["mesh"]}
cli = ttrain.run(inp["cli_argv"] + ["--ep", "2", "--fuse-steps", "3"])
out["cli_fused"] = {"losses": cli["losses"], "mesh": cli["mesh"],
                    "kind": type(cli["step_fn"]).__name__}

with open(f"{where}/out{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
"""


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    """nanotpu's init of each config, as numpy."""
    init = jax.jit(jmix.init_params, static_argnums=1)
    out = {name: _np(init(jax.random.PRNGKey(i), cfg))
           for i, (name, cfg) in enumerate(CONFIGS.items())}
    out["serve"] = _np(init(jax.random.PRNGKey(7), jmix.MixtralConfig.tiny()))
    return out


def _tokens(seed, lead=()):
    rng = np.random.default_rng(seed)
    by_shape = {}
    out = {}
    for name, (_, cfg, _, _, rows) in MESHES.items():
        if (cfg, rows) not in by_shape:
            by_shape[cfg, rows] = rng.integers(
                0, CONFIGS[cfg].vocab_size, (*lead, rows, 33)).astype(np.int32)
        out[name] = by_shape[cfg, rows]
    return out


@pytest.fixture(scope="module")
def tokens():
    return _tokens(3)


@pytest.fixture(scope="module")
def fused_tokens(tokens):
    """Each case's batches of its fused call [N_FUSED, rows, 33], the
    first its one step's (so that one chain of nanotpu's steps gives
    both)."""
    more = _tokens(4, (N_FUSED - 1,))
    return {name: np.concatenate([tokens[name][None], more[name]])
            for name in MESHES}


def _cfg_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _jmesh(factors):
    n = int(np.prod(list(factors.values())))
    return jmake_mesh(devices=jax.devices()[:n], **factors)


def _decisions(choices):
    return [(jnp.argmax(c[0], -1), c[1], c[2]) for c in choices]


@functools.cache
def _decide(cfg):
    """nanotpu's forward under jit, returning the routing decisions that
    ``route_decisions`` took on the way: per layer, per choice, (expert,
    capacity slot, kept)."""
    route = jmix.route_decisions

    def run(p, t):
        seen = []

        def recording(logits, cfg, capacity=None):
            choices, aux, C = route(logits, cfg, capacity)
            seen.append(_decisions(choices))
            return choices, aux, C

        jmix.route_decisions = recording
        try:
            jmix.forward(p, t, cfg)
        finally:
            jmix.route_decisions = route
        return seen

    return jax.jit(run)


def jax_decisions(params, tokens, cfg):
    """nanotpu's routing decisions of its forward on ``tokens``."""
    return jax.tree_util.tree_map(np.asarray, _decide(cfg)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tokens)))


def jax_chain(loss_fn, p, blocks):
    """nanotpu's ``build_train_step`` body carried over ``blocks`` [N, B,
    S+1] from ``p``: each step's loss and gradients, and the parameters
    before each step and after the last, as numpy."""
    opt = jtrain.make_optimizer()

    @jax.jit
    def step(p, o, t):
        loss, grads = jax.value_and_grad(loss_fn)(p, t)
        updates, o = opt.update(grads, o, p)
        return loss, grads, optax.apply_updates(p, updates), o

    losses, grads, params, o = [], [], [_np(p)], opt.init(p)
    for t in blocks:
        loss, g, p, o = step(p, o, jnp.asarray(t))
        losses.append(float(loss))
        grads.append(_np(g))
        params.append(_np(p))
    return losses, grads, params


def jax_fused(loss_fn, p, blocks, mesh, specs):
    """nanotpu's ``build_train_step(..., n_fused=N)`` on ``mesh`` from
    ``p`` (which its step donates): (last loss, step, parameters, mu, nu)
    as numpy."""
    opt = jtrain.make_optimizer()
    state = jtrain.place_state(
        jtrain.TrainState(p, opt.init(p), jnp.zeros((), jnp.int32)), None,
        mesh, param_specs=specs)
    step = jtrain.build_train_step(None, mesh, opt,
                                   loss_fn=lambda p, t, _: loss_fn(p, t),
                                   param_specs=specs, n_fused=len(blocks))
    state, loss = step(state, jnp.asarray(blocks))
    adam = state.opt_state[1][0]
    return _np((float(loss), int(state.step), state.params, adam.mu,
                adam.nu))


def _unstacked(p):
    n = jax.tree_util.tree_leaves(p["layers"])[0].shape[0]
    return {**p, "layers": [jax.tree_util.tree_map(lambda x, i=i: x[i],
                                                   p["layers"])
                            for i in range(n)]}


def _micro_decisions(p, inputs, cfg, n_micro):
    """nanotpu's decisions by (microbatch, layer) of its forward on each
    microbatch of ``inputs`` (all of them as one for ``n_micro`` 0)."""
    if not n_micro:
        return dict(enumerate(jax_decisions(p, inputs, cfg)))
    mb = inputs.shape[0] // n_micro
    out = {}
    for m in range(n_micro):
        for layer, d in enumerate(jax_decisions(
                p, inputs[m * mb:(m + 1) * mb], cfg)):
            out[m, layer] = d
    return out


def nanotpu_results(params, fused_tokens):
    """Each case's routing decisions, step, fused steps and serving tokens,
    by nanotpu; cases of one config, row count and schedule computed
    once."""
    out, done = {}, {}
    for name, (factors, cfg_name, attn, n_micro, rows) in MESHES.items():
        key = (cfg_name, rows, n_micro, attn if n_micro else None)
        if key not in done:
            cfg = CONFIGS[cfg_name]
            blocks = fused_tokens[name]
            p = jax.tree_util.tree_map(jnp.asarray, params[cfg_name])
            if n_micro:
                mesh = _jmesh(factors)
                pcfg = dataclasses.replace(
                    cfg, attn_impl="ring" if attn == "ring" else "dense")
                fn = jpp.make_pipelined_loss(mesh, n_micro=n_micro,
                                             model="mixtral")

                def loss_fn(p, t):
                    return fn(p, t, pcfg)

                p = jpp.stack_layers(p)
                specs = jpp.mixtral_pp_param_specs(cfg)
            else:
                mesh = _jmesh({})

                def loss_fn(p, t):
                    return jmix.loss_fn(p, t, cfg)

                specs = jmesh.mixtral_param_specs(cfg)
            with jax.set_mesh(mesh):
                losses, grads, chain = jax_chain(loss_fn, p, blocks)
            fused = jax_fused(loss_fn, p, blocks, mesh, specs)
            before = chain[:-1]
            if n_micro:
                before = [_unstacked(b) for b in before]
            decisions = [_micro_decisions(b, t[:, :-1], cfg, n_micro)
                         for b, t in zip(before, blocks)]
            # the first block is the one step's batch
            done[key] = {"step": (losses[0], grads[0], chain[1]),
                         "decisions": decisions[0], "fused": fused,
                         "fused_grads": grads, "fused_decisions": decisions}
        out[name] = done[key]

    cfg = jmix.MixtralConfig.tiny()
    p = jax.tree_util.tree_map(jnp.asarray, params["serve"])
    mesh = _jmesh(SERVE_MESH)
    out["generate"] = np.asarray(jax.jit(
        lambda pp, t: jgen.generate(pp, t, cfg, N_NEW, mesh=mesh))(
        jinfer.place_params(p, cfg, mesh),
        jnp.asarray([PROMPT], jnp.int32)))[0].tolist()
    loose = dataclasses.replace(cfg, capacity_factor=LOOSE_CF)
    gen = jax.jit(lambda pp, t: jgen.generate(pp, t, loose, N_NEW))
    out["requests"] = [np.asarray(gen(p, jnp.asarray([q], jnp.int32)))[0]
                       .tolist() for q, _ in REQUESTS]
    return out


@pytest.fixture(scope="module")
def run(params, tokens, fused_tokens, tmp_path_factory):
    """The group of four, started once, and nanotpu's results, computed
    while it runs: (every rank's results by rank, nanotpu's)."""
    where = tmp_path_factory.mktemp("ep")
    cfgs = {name: _cfg_fields(cfg) for name, cfg in CONFIGS.items()}
    cfgs["serve"] = _cfg_fields(jmix.MixtralConfig.tiny())
    inputs = {"params": params, "tokens": tokens, "cfgs": cfgs,
              "meshes": MESHES, "serve_mesh": SERVE_MESH, "prompt": PROMPT,
              "n_new": N_NEW, "requests": REQUESTS, "engine_kw": ENGINE_KW,
              "engine_cfs": {"loose": LOOSE_CF, "tight": TIGHT_CF},
              "cli_argv": CLI_ARGV, "fused": fused_tokens,
              "n_fused": N_FUSED}
    with open(where / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    (where / "child.py").write_text(CHILD)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("NANOTPU_", "JOB_", "GANG_", "COORDINATOR_"))}
    env.update({"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    procs = [subprocess.Popen(
        [sys.executable, str(where / "child.py"), str(r), str(WORLD),
         str(where)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        theirs = nanotpu_results(params, fused_tokens)
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
    ours = []
    for r in range(WORLD):
        with open(where / f"out{r}.pkl", "rb") as f:
            ours.append(pickle.load(f))
    return ours, theirs


@pytest.fixture(scope="module")
def spmd(run):
    return run[0]


@pytest.fixture(scope="module")
def nanotpu(run):
    return run[1]


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _assert_trees_close(got, want, atol):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=atol, rtol=0)


def _port_decisions(res, name, calls=None):
    """The port's decisions on one rank (of one step: ``calls``, or
    ``res["routing"]``): by layer (the plain step), or by (microbatch,
    layer) from the pipeline's ticks, bubbles left out (a stage takes its
    own layers' only)."""
    _, cfg, _, n_micro, _ = MESHES[name]
    calls = res["routing"] if calls is None else calls
    if not n_micro:
        return dict(enumerate(calls))
    stage = res["rank"]["pp"]
    n_local = CONFIGS[cfg].n_layers // 2
    out = {}
    for i, call in enumerate(calls):
        tick, layer = divmod(i, n_local)
        if 0 <= tick - stage < n_micro:
            out[tick - stage, stage * n_local + layer] = call
    return out


def _assert_decisions_equal(by_rank, want):
    """Every rank's decisions (by key) are ``want``'s, exactly, and the
    ranks together cover every key; capacity drops some choice."""
    dropped = sum(int((~keep).sum()) for d in want.values()
                  for _, _, keep in d)
    assert dropped > 0, "capacity never binds: the case tests no contention"
    covered = set()
    for got in by_rank:
        assert got and set(got) <= set(want)
        covered |= set(got)
        for k, decisions in got.items():
            for (ge, gp, gk), (we, wp, wk) in zip(decisions, want[k]):
                np.testing.assert_array_equal(ge, we)
                np.testing.assert_array_equal(gk, wk)
                np.testing.assert_array_equal(gp[wk], wp[wk])
    assert covered == set(want)


@pytest.mark.parametrize("name", list(MESHES))
def test_routing_decisions_equal_nanotpus(spmd, nanotpu, name):
    """Every rank's decisions are nanotpu's, exactly: each token's experts,
    the capacity slots of those it keeps, which it drops; taken on the
    global tokens of the step (of the microbatch under pp)."""
    _assert_decisions_equal([_port_decisions(res[name], name)
                             for res in spmd], nanotpu[name]["decisions"])


@pytest.mark.parametrize("name", list(MESHES))
def test_fused_steps_route_and_train_as_nanotpu(spmd, nanotpu, name):
    """Three steps in one call: each step's routing decisions, on every
    rank, exactly nanotpu's on its parameters before that step; the last
    loss on every rank, the step count, every parameter and Adam's
    moments after the call against nanotpu's ``n_fused=3`` (the module
    docstring's widened tolerances)."""
    want = nanotpu[name]
    loss, step, params, mu, nu = want["fused"]
    for k in range(N_FUSED):
        by_rank = []
        for res in spmd:
            calls = res[name]["fused"]["routing"]
            n = len(calls) // N_FUSED
            assert len(calls) == N_FUSED * n
            by_rank.append(_port_decisions(res[name], name,
                                           calls[k * n:(k + 1) * n]))
        _assert_decisions_equal(by_rank, want["fused_decisions"][k])
    for res in spmd:
        got = res[name]["fused"]
        assert got["kind"] == "FusedTrainStep"
        assert got["step"] == step == N_FUSED
        np.testing.assert_allclose(got["loss"], loss, atol=N_FUSED * 1e-5)
    got = spmd[0][name]["fused"]
    lr = ttrain.make_optimizer().lr
    near_zero = [np.min([np.abs(g) for g in gs], axis=0) < 1e-6 for gs in
                 zip(*(_leaves(g) for g in want["fused_grads"]))]
    for x, y, z in zip(_leaves(got["params"]), _leaves(params), near_zero,
                       strict=True):
        atol = np.where(z, N_FUSED * 2 * lr, N_FUSED * 3e-5)
        assert (np.abs(x - y) <= atol).all(), np.abs(x - y).max()
    for mine, theirs in ((got["mu"], mu), (got["nu"], nu)):
        _assert_trees_close(mine, theirs, N_FUSED * 1e-5)


def _layer0(tree, name):
    return tree["layers"] if MESHES[name][3] else tree["layers"][0]


@pytest.mark.parametrize("name", list(MESHES))
def test_loss_and_gradients_match_nanotpu(spmd, nanotpu, name):
    """The loss on every rank, and every gradient, the router's and the
    experts' among them, summed over the data axes and gathered whole."""
    want_loss, want, _ = nanotpu[name]["step"]
    for res in spmd:
        assert res[name]["loss"] == pytest.approx(want_loss, abs=1e-5)
    got = spmd[0][name]["grads"]
    _assert_trees_close(got, want, 1e-4)
    router = _layer0(got, name)["moe"]["router"]
    np.testing.assert_allclose(router, _layer0(want, name)["moe"]["router"],
                               atol=1e-4, rtol=0)
    assert np.abs(router).max() > 1e-3


@pytest.mark.parametrize("name", list(MESHES))
def test_global_norm_counts_each_element_once(spmd, nanotpu, name):
    """The clip's global norm from each rank's shards (an expert's on its
    ep rank only, a replicated leaf's divided by its copies) is the norm
    of nanotpu's whole gradient tree, on every rank."""
    want = np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                       for g in _leaves(nanotpu[name]["step"][1])))
    for res in spmd:
        assert res[name]["norm"] == pytest.approx(want, rel=1e-5)


EXPERTS = ("w_gate", "w_up", "w_down")


def _split_experts(grads):
    """(the expert leaves, every other leaf) of a gradient tree."""
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    expert = [x for path, x in flat if str(path[-1].key) in EXPERTS]
    other = [x for path, x in flat if str(path[-1].key) not in EXPERTS]
    return expert, other


@pytest.mark.parametrize("name", [n for n, m in MESHES.items()
                                  if "ep" in m[0]])
def test_non_expert_gradients_are_equal_on_every_ep_rank(spmd, name):
    """ep is not a data axis: each rank's local gradient of every leaf but
    the experts' equals its ep partner's (ranks 2k and 2k+1 differ in ep
    alone); the experts' differ, each rank's own."""
    for r in range(0, WORLD, 2):
        assert spmd[r][name]["rank"]["ep"] == 0
        assert spmd[r + 1][name]["rank"]["ep"] == 1
        ea, oa = _split_experts(spmd[r][name]["local_grads"])
        eb, ob = _split_experts(spmd[r + 1][name]["local_grads"])
        assert len(ea) == len(eb) > 0
        for x, y in zip(ea, eb):
            assert not np.array_equal(x, y)
        assert len(oa) == len(ob) > 0
        for x, y in zip(oa, ob):
            np.testing.assert_array_equal(x, y)


def test_each_ep_shard_holds_its_experts(spmd):
    """E/ep experts a rank, each at its fsdp rows and tp columns; under pp
    the stage's layers lead."""
    tiny, dry = CONFIGS["tiny"], CONFIGS["dry"]
    want = {"dp2_ep2": (2, dry.dim, dry.ffn_dim),
            "fsdp2_ep2": (2, dry.dim // 2, dry.ffn_dim),
            "tp2_ep2": (2, tiny.dim, tiny.ffn_dim // 2),
            "sp2_ep2": (2, tiny.dim, tiny.ffn_dim),
            "pp2_ep2": (1, 2, dry.dim, dry.ffn_dim),
            "pp2_sp2": (1, 4, dry.dim, dry.ffn_dim)}
    serve = jmix.MixtralConfig.tiny()
    for res in spmd:
        for name, shape in want.items():
            assert res[name]["w_gate_local"] == shape, name
        assert res["w_gate_serve_local"] == (2, serve.dim, serve.ffn_dim // 2)
        for label in ("loose", "tight"):
            assert res[("engine", label)]["w_gate_local"] == \
                res["w_gate_serve_local"]


@pytest.mark.parametrize("name", list(MESHES))
def test_train_step_matches_nanotpu(spmd, nanotpu, name):
    """One step of the port's trainer on the mesh (clipped AdamW on the
    local shards) against nanotpu's: the loss on every rank and every
    updated parameter (twice the learning rate where the gradient is
    within rounding of zero, see the module docstring)."""
    want_loss, grads, want = nanotpu[name]["step"]
    lr = ttrain.make_optimizer().lr
    for res in spmd:
        np.testing.assert_allclose(res[name]["step_loss"], want_loss,
                                   atol=1e-5)
    got = _leaves(spmd[0][name]["step_params"])
    assert len(got) == len(_leaves(want)) == len(_leaves(grads))
    for x, y, g in zip(got, _leaves(want), _leaves(grads)):
        atol = np.where(np.abs(g) < 1e-6, 2 * lr, 3e-5)
        assert (np.abs(x - y) <= atol).all(), np.abs(x - y).max()


def test_generate_and_speculative_on_tp2_ep2(spmd, nanotpu, params):
    """Greedy ``generate`` on tp2 x ep2 equals nanotpu's on the same mesh;
    ``speculative_generate`` (a truncated MoE draft, its embedding and head
    the target's) equals one process's."""
    cfg = tmix.MixtralConfig.tiny()
    p = params_from_numpy(params["serve"], "cpu")
    dcfg = dataclasses.replace(cfg, n_layers=1)
    want = speculative_generate(
        p, {**p, "layers": [p["layers"][0]]}, torch.tensor([PROMPT]), cfg,
        dcfg, N_NEW, draft_tokens=3)[0].tolist()
    for res in spmd:
        assert res["generate"] == nanotpu["generate"]
        assert res["speculative"] == want


def test_engine_on_tp2_ep2_serves_nanotpus_tokens(spmd, nanotpu):
    """At a loose capacity no token drops: every rank's requests (the
    leader's, each follower's) end with nanotpu's greedy tokens, and the
    drop counter stays 0."""
    for res in spmd:
        got = res[("engine", "loose")]
        assert got["outs"] == nanotpu["requests"]
        assert got["drops"] == got["stats_drops"] == 0


def test_engine_on_tp2_ep2_counts_prefill_drops_like_one_process(spmd,
                                                                 params):
    """At a tight capacity prefill drops: rank 0 counts what the plain
    engine counts on the same requests, and every rank serves the plain
    engine's tokens."""
    cfg = dataclasses.replace(tmix.MixtralConfig.tiny(),
                              capacity_factor=TIGHT_CF)
    eng = Engine(params_from_numpy(params["serve"], "cpu"), cfg,
                 device="cpu", **ENGINE_KW)
    try:
        reqs = [eng.submit(p, n) for p, n in REQUESTS]
        for r in reqs:
            assert r.wait(120) and r.error is None
    finally:
        eng.stop()
    assert eng.moe_prefill_dropped_total > 0
    lead = spmd[0][("engine", "tight")]
    assert lead["drops"] == lead["stats_drops"] == eng.moe_prefill_dropped_total
    for res in spmd:
        assert res[("engine", "tight")]["outs"] == [r.out for r in reqs]


def test_cli_trains_mixtral_over_ep_as_one_process(spmd):
    """``--model mixtral --ep 2`` in the group of four (mesh dp2 x ep2):
    every rank logs the losses of one process's plain run on the same
    batches."""
    one = ttrain.run(CLI_ARGV)["losses"]
    for res in spmd:
        assert res["cli"]["mesh"] == {"dp": 2, "fsdp": 1, "tp": 1, "ep": 2,
                                      "sp": 1, "pp": 1}
        got = res["cli"]["losses"]
        assert [s for s, _ in got] == [s for s, _ in one] == [1, 2, 3]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in one],
                                   atol=1e-5)


def test_cli_fuse_steps_trains_mixtral_over_ep(spmd):
    """``--model mixtral --ep 2 --fuse-steps 3`` in the group of four: one
    call of three steps, whose loss every rank logs at step 3, that of
    the unfused run in the same group."""
    for res in spmd:
        fused, eager = res["cli_fused"], res["cli"]
        assert fused["kind"] == "FusedTrainStep"
        assert fused["mesh"] == eager["mesh"]
        assert [s for s, _ in fused["losses"]] == [3]
        np.testing.assert_allclose(fused["losses"][0][1],
                                   dict(eager["losses"])[3], atol=1e-6)
