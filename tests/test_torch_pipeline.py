"""nanotpu_torch's GPipe pipeline on the CPU, in process groups of gloo,
against nanotpu's on its virtual CPU devices (``tests/test_pipeline.py``'s
dense cases).

Two groups run once for the whole file (``spmd`` fixture): two processes
(mesh pp=2) and four (pp=2 x tp=2, pp=2 x fsdp=2, pp=2 x sp=2 with the ring
inside the stages). The children import torch and the port only; they read
their inputs (numpy, made here from a seed) from a pickle and write rank
0's results to another. This process runs nanotpu's ``pipelined_forward``,
the gradient of its pipelined loss and its sharded train step on meshes of
the same shapes; two trainer processes run ``--pp 2 --microbatches 4``.
The same groups run three pipelined steps in one call
(``build_train_step(..., mesh=, n_fused=3)``, M=4) on every mesh,
against nanotpu's ``n_fused=3`` on the same mesh, computed here while the
groups run.

Tolerances, f32: logits 1e-5 (the stages sum nothing in another order but
the tp split's halves), gradients 1e-4, as nanotpu's own tests hold its
pipeline against its plain model. One train step as
``tests/test_torch_ring.py`` holds it: loss 1e-5, Adam moments 1e-6,
updated parameters 3e-5. The ring's logits 2e-4, as nanotpu holds its
pipelined ring against the dense forward. Three fused steps: the train
step's tolerances widened by the step count, three times (loss 3e-5,
moments 3e-6, parameters 9e-5)."""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanotpu.models import llama as jl
from nanotpu.models import mixtral as jmixtral
from nanotpu.parallel import pipeline as jpp
from nanotpu.parallel import train as jtrain
from nanotpu.parallel.mesh import make_mesh as jmake_mesh
from nanotpu.parallel.mesh import shardings_for
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.models import llama as tl
from nanotpu_torch.models import mixtral as tmixtral
from nanotpu_torch.parallel import pipeline as tpp
from nanotpu_torch.parallel import train as ttrain
from nanotpu_torch.parallel.mesh import AXES
from nanotpu_torch.tree import leaves, map_tree

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

# tests/test_pipeline.py's config
CFG = jl.LlamaConfig(
    vocab_size=128, dim=32, n_layers=4, n_heads=4, n_kv_heads=2,
    ffn_dim=64, max_seq_len=64, dtype="float32",
)
#: mesh -> (factors, the port's attention, microbatch counts of the
#: forward, whether the child takes gradients, whether it trains a step);
#: nanotpu runs the dense attention, or its ring where the port's is
MESHES = {
    "pp2": (dict(pp=2), "dense", (2, 4), True, True),
    "pp2_tp2": (dict(pp=2, tp=2), "flash", (4,), False, True),
    "pp2_fsdp2": (dict(pp=2, fsdp=2), "dense", (4,), True, False),
    "pp2_sp2": (dict(pp=2, sp=2), "ring", (2,), True, False),
}
WORLDS = {2: ["pp2"], 4: ["pp2_tp2", "pp2_fsdp2", "pp2_sp2"]}
GRAD_MICRO = {"pp2": 4, "pp2_fsdp2": 4, "pp2_sp2": 2}
#: fused pipelined steps: steps a call, microbatches
N_FUSED, FUSED_MICRO = 3, 4

CHILD = r"""
import pickle, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, where = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{where}/rdv{world}",
                        rank=rank, world_size=world)
from torch.distributed.tensor import DTensor, distribute_tensor
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.models import llama as tl
from nanotpu_torch.parallel import mesh as tm, pipeline as tpp
from nanotpu_torch.parallel import train as ttrain
from nanotpu_torch.tree import leaves, map_tree

with open(f"{where}/in.pkl", "rb") as f:
    inp = pickle.load(f)
out = {}
whole = lambda t: t.full_tensor().detach().numpy()
for name in inp["worlds"][world]:
    factors, attn, micros, grads, train = inp["meshes"][name]
    mesh = tm.make_mesh(**factors)
    cfg = tl.LlamaConfig(**{**inp["cfg"], "attn_impl": attn})
    specs = tpp.llama_pp_param_specs(cfg)
    stacked = tpp.stack_layers(params_from_numpy(inp["params"], "cpu"))
    placed = map_tree(lambda t, s: distribute_tensor(
        t, mesh, tm.placements_for(mesh, s, t.dim()), src_data_rank=None),
        stacked, specs)
    fwd_tokens = torch.from_numpy(inp["tokens_sp" if attn == "ring"
                                      else "tokens"])
    for m in micros:
        out[("fwd", name, m)] = tpp.pipelined_forward(
            placed, fwd_tokens, cfg, mesh, m).numpy()
    out[("local_wq", name)] = tuple(
        placed["layers"]["attn"]["wq"].to_local().shape)
    train_tokens = torch.from_numpy(inp["train_sp" if attn == "ring"
                                        else "train"])
    if grads:
        shard = tm.Shards(mesh, specs)
        loc = map_tree(lambda t: t.to_local().detach().requires_grad_(),
                       placed)
        rows = distribute_tensor(train_tokens, mesh, tm.placements_for(
            mesh, tm.BATCH_SPEC, 2), src_data_rank=None).to_local()
        loss = tpp.pipelined_loss_fn(loc, rows, cfg, shard=shard,
                                     n_micro=inp["grad_micro"][name])
        g = torch.autograd.grad(loss, leaves(loc))
        g = shard.reduce_grads(list(g), tm.spec_leaves(specs, loc))
        it = iter(g)
        out[("grads", name)] = map_tree(lambda p: DTensor.from_local(
            next(it), mesh, p.placements, run_check=False, shape=p.shape,
            stride=p.stride()).full_tensor().numpy(), placed)
        out[("loss", name)] = shard.sum_over_data(loss.detach()).item()
    if train:
        opt = ttrain.make_optimizer()
        state = ttrain.place_state(
            ttrain.TrainState(stacked, opt.init(stacked), 0), cfg, mesh,
            param_specs=specs)
        step = ttrain.build_train_step(
            cfg, opt, loss_fn=tpp.make_pipelined_loss(mesh, 4), mesh=mesh,
            param_specs=specs)
        state, loss = step(state, train_tokens)
        out[("train", name)] = {
            "loss": loss.item(), "params": map_tree(whole, state.params),
            "mu": map_tree(whole, state.opt_state["mu"]),
            "nu": map_tree(whole, state.opt_state["nu"])}

    # n_fused pipelined steps in one call from the same state (fresh
    # tensors: a replicated DTensor shares its input's, which the train
    # step above updated in place)
    stacked = tpp.stack_layers(params_from_numpy(inp["params"], "cpu"))
    opt = ttrain.make_optimizer()
    state = ttrain.place_state(
        ttrain.TrainState(stacked, opt.init(stacked), 0), cfg, mesh,
        param_specs=specs)
    step = ttrain.build_train_step(
        cfg, opt, loss_fn=tpp.make_pipelined_loss(mesh, inp["fused_micro"]),
        mesh=mesh, param_specs=specs, n_fused=inp["n_fused"])
    state, loss = step(state, torch.from_numpy(
        inp["fused_sp" if attn == "ring" else "fused"]))
    out[("fused", name)] = {
        "loss": loss.item(), "step": state.step, "kind": type(step).__name__,
        "params": map_tree(whole, state.params),
        "mu": map_tree(whole, state.opt_state["mu"]),
        "nu": map_tree(whole, state.opt_state["nu"])}

if rank == 0:
    with open(f"{where}/out{world}.pkl", "wb") as f:
        pickle.dump(out, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def params():
    """A numpy-seeded parameter tree of nanotpu's shapes."""
    jparams = jl.init_params(jax.random.PRNGKey(0), CFG)
    rng = np.random.default_rng(0)
    # nanotpu's tree with every leaf redrawn from numpy, shapes and scales
    # kept (the norm gains stay ones)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) if x.ndim == 1 else
                   (rng.standard_normal(x.shape) * float(jnp.std(x))
                    ).astype(np.float32)), jparams)


@pytest.fixture(scope="module")
def inputs(params):
    rng = np.random.default_rng(1)

    def toks(*shape):
        return rng.integers(0, CFG.vocab_size, shape).astype(np.int32)

    return {"params": params, "tokens": toks(8, 16), "train": toks(8, 17),
            "tokens_sp": toks(4, 32), "train_sp": toks(4, 33),
            "fused": toks(N_FUSED, 8, 17), "fused_sp": toks(N_FUSED, 4, 33),
            "cfg": {f.name: getattr(CFG, f.name)
                    for f in dataclasses.fields(CFG)},
            "meshes": MESHES, "worlds": WORLDS, "grad_micro": GRAD_MICRO,
            "n_fused": N_FUSED, "fused_micro": FUSED_MICRO}


def nanotpu_fused(inputs, params):
    """nanotpu's ``n_fused`` pipelined steps on each mesh from the same
    state: (last loss, step, parameters, mu, nu) as numpy."""
    out = {}
    for name in MESHES:
        placed, mesh = _jplaced(params, name)
        specs = jpp.llama_pp_param_specs(CFG)
        opt = jtrain.make_optimizer()
        state = jtrain.place_state(
            jtrain.TrainState(placed, opt.init(placed),
                              jnp.zeros((), jnp.int32)),
            CFG, mesh, param_specs=specs)
        step = jtrain.build_train_step(
            _jcfg(name), mesh, opt,
            loss_fn=jpp.make_pipelined_loss(mesh, n_micro=FUSED_MICRO),
            param_specs=specs, n_fused=N_FUSED)
        tokens = inputs["fused_sp" if MESHES[name][1] == "ring" else "fused"]
        state, loss = step(state, jnp.asarray(tokens))
        adam = state.opt_state[1][0]
        out[name] = jax.tree_util.tree_map(
            np.asarray, (float(loss), int(state.step), state.params, adam.mu,
                         adam.nu))
    return out


@pytest.fixture(scope="module")
def run(inputs, params, tmp_path_factory):
    """Both process groups, started together, and nanotpu's fused steps,
    computed while they run: (rank 0's results of each group, nanotpu's
    fused steps by mesh)."""
    where = tmp_path_factory.mktemp("pipeline")
    with open(where / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    (where / "child.py").write_text(CHILD)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(where / "child.py"), str(r), str(w), str(where)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for w in WORLDS for r in range(w)]
    try:
        theirs = nanotpu_fused(inputs, params)
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
    out = {}
    for w in WORLDS:
        with open(where / f"out{w}.pkl", "rb") as f:
            out.update(pickle.load(f))
    return out, theirs


@pytest.fixture(scope="module")
def spmd(run):
    return run[0]


def _jmesh(name):
    factors = MESHES[name][0]
    n = int(np.prod(list(factors.values())))
    return jmake_mesh(devices=jax.devices()[:n], **factors)


def _jcfg(name):
    return dataclasses.replace(
        CFG, attn_impl="ring" if MESHES[name][1] == "ring" else "dense")


def _jplaced(params, name):
    mesh = _jmesh(name)
    stacked = jpp.stack_layers(jax.tree_util.tree_map(jnp.asarray, params))
    return jax.device_put(stacked, shardings_for(
        mesh, jpp.llama_pp_param_specs(_jcfg(name)))), mesh


def _tparams(params):
    return params_from_numpy(params, "cpu")


def _tcfg(**kw):
    return tl.LlamaConfig(**{**{f.name: getattr(CFG, f.name)
                                for f in dataclasses.fields(CFG)}, **kw})


FWD_CASES = [(name, m) for name, (_, _, micros, _, _) in MESHES.items()
             for m in micros]


@pytest.mark.parametrize("name,n_micro", FWD_CASES)
def test_pipelined_forward_matches_nanotpu_and_plain(spmd, inputs, params,
                                                     name, n_micro):
    ring = MESHES[name][1] == "ring"
    tokens = inputs["tokens_sp" if ring else "tokens"]
    placed, mesh = _jplaced(params, name)
    with mesh:
        want = np.asarray(jax.jit(
            lambda p, t: jpp.pipelined_forward(p, t, _jcfg(name), mesh,
                                               n_micro))(placed, tokens))
    plain = tl.forward(_tparams(params), torch.from_numpy(tokens),
                       _tcfg()).detach().numpy()
    got = spmd[("fwd", name, n_micro)]
    tol = 2e-4 if ring else 1e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, plain, atol=tol, rtol=tol)


def test_each_stage_holds_its_layer_block(spmd):
    """pp splits the stacked layer axis (2 of 4 layers a rank); tp splits
    wq's columns, fsdp its rows."""
    hd = CFG.n_heads * CFG.head_dim
    assert spmd[("local_wq", "pp2")] == (2, CFG.dim, hd)
    assert spmd[("local_wq", "pp2_tp2")] == (2, CFG.dim, hd // 2)
    assert spmd[("local_wq", "pp2_fsdp2")] == (2, CFG.dim // 2, hd)


@pytest.mark.parametrize("name", list(GRAD_MICRO))
def test_pipelined_gradients_match_plain(spmd, inputs, params, name):
    """Every gradient of the pipelined loss (the stacked tree, whole)
    against the plain loss's in one process, unstacked; at pp2, against
    nanotpu's pipelined loss too."""
    ring = MESHES[name][1] == "ring"
    tokens = inputs["train_sp" if ring else "train"]
    p = _tparams(params)
    for t in leaves(p):
        t.requires_grad_(True)
    loss = tl.loss_fn(p, torch.from_numpy(tokens), _tcfg())
    it = iter(torch.autograd.grad(loss, leaves(p)))
    plain = map_tree(lambda t: t.numpy(),
                     tpp.stack_layers(map_tree(lambda _: next(it), p)))
    # nanotpu's leaf order (dict keys sorted) on both sides
    got = jax.tree_util.tree_leaves(spmd[("grads", name)])
    assert spmd[("loss", name)] == pytest.approx(loss.item(), abs=1e-5)
    want = jax.tree_util.tree_leaves(plain)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
    if name == "pp2":
        mesh = _jmesh(name)
        jloss = jpp.make_pipelined_loss(mesh, n_micro=GRAD_MICRO[name])
        stacked_j = jpp.stack_layers(jax.tree_util.tree_map(jnp.asarray,
                                                            params))
        want = jax.tree_util.tree_leaves(jax.jit(
            lambda p, t: jax.grad(jloss)(p, t, CFG))(stacked_j, tokens))
        assert len(want) == len(got)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("name", ["pp2", "pp2_tp2"])
def test_train_step_matches_nanotpu_on_the_same_mesh(spmd, inputs, params,
                                                     name):
    """One pipelined train step (M=4): loss, updated parameters and Adam's
    moments against nanotpu's on the same mesh."""
    placed, mesh = _jplaced(params, name)
    specs = jpp.llama_pp_param_specs(CFG)
    opt = jtrain.make_optimizer()
    state = jtrain.TrainState(placed, opt.init(placed),
                              jnp.zeros((), jnp.int32))
    state = jtrain.place_state(state, CFG, mesh, param_specs=specs)
    step = jtrain.build_train_step(
        CFG, mesh, opt, loss_fn=jpp.make_pipelined_loss(mesh, n_micro=4),
        param_specs=specs)
    state, loss = step(state, jnp.asarray(inputs["train"]))
    got = spmd[("train", name)]
    np.testing.assert_allclose(got["loss"], float(loss), atol=1e-5)
    adam = state.opt_state[1][0]
    for mine, theirs, atol in ((got["params"], state.params, 3e-5),
                               (got["mu"], adam.mu, 1e-6),
                               (got["nu"], adam.nu, 1e-6)):
        a = jax.tree_util.tree_leaves(mine)
        b = jax.tree_util.tree_leaves(theirs)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, np.asarray(y), atol=atol)


@pytest.mark.parametrize("name", list(MESHES))
def test_fused_pipelined_steps_match_nanotpu_on_the_same_mesh(run, name):
    """Three pipelined steps in one call (M=4): the last loss, the step
    count, the updated parameters and Adam's moments against nanotpu's
    ``n_fused=3`` on the same mesh (each tolerance thrice one step's)."""
    got = run[0][("fused", name)]
    loss, step, params, mu, nu = run[1][name]
    assert got["kind"] == "FusedTrainStep"
    assert got["step"] == step == N_FUSED
    np.testing.assert_allclose(got["loss"], loss, atol=N_FUSED * 1e-5)
    for mine, theirs, atol in ((got["params"], params, N_FUSED * 3e-5),
                               (got["mu"], mu, N_FUSED * 1e-6),
                               (got["nu"], nu, N_FUSED * 1e-6)):
        a = jax.tree_util.tree_leaves(mine)
        b = jax.tree_util.tree_leaves(theirs)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=atol)


def test_stack_unstack_round_trip(params):
    """The port's stacked tree is nanotpu's, leaf for leaf, and unstacks
    back to the list of layers."""
    p = _tparams(params)
    stacked = tpp.stack_layers(p)
    want = jpp.stack_layers(jax.tree_util.tree_map(jnp.asarray, params))
    a, b = leaves(stacked), jax.tree_util.tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for x, y in zip(leaves(tpp.unstack_layers(stacked)), leaves(p)):
        assert torch.equal(x, y)
    specs = tpp.llama_pp_param_specs(_tcfg())
    assert specs["layers"]["attn"]["wq"] == ("pp", "fsdp", "tp")
    assert specs["embed"] == ("tp", "fsdp")


def _fake_mesh(**factors):
    """What check_pp_divisibility reads of a mesh: its axis names and
    sizes."""
    shape = [factors.get(a, 1) for a in AXES]
    return types.SimpleNamespace(mesh_dim_names=AXES,
                                 mesh=np.empty(shape, np.int8))


@pytest.mark.parametrize("cfg_layers,batch,n_micro", [
    (2, 8, 4), (4, 6, 4), (4, 8, 2), (2, 6, 2)])
def test_check_pp_divisibility_messages_are_nanotpus(cfg_layers, batch,
                                                     n_micro):
    mesh = jmake_mesh(pp=4, dp=2)
    jcfg = dataclasses.replace(CFG, n_layers=cfg_layers)
    with pytest.raises(ValueError) as want:
        jpp.check_pp_divisibility(jcfg, mesh, batch=batch, n_micro=n_micro)
    with pytest.raises(ValueError) as got:
        tpp.check_pp_divisibility(_tcfg(n_layers=cfg_layers),
                                  _fake_mesh(pp=4, dp=2), batch, n_micro)
    assert str(got.value) == str(want.value)


def test_mixtral_pipeline_is_not_ported():
    """``make_pipelined_loss(model="mixtral")`` binds the MoE pipelined
    loss, on nanotpu's stacked MoE specs; a model it does not know, or a
    config of the other model, is refused (the pipelined MoE step on pp2 x
    ep2 and pp2 x sp2: ``tests/test_torch_ep.py``)."""
    loss = tpp.make_pipelined_loss(None, 4, model="mixtral")
    assert isinstance(loss, tpp.PipelinedLoss)
    assert (loss.model, loss.n_micro) == ("mixtral", 4)
    jspecs = jpp.mixtral_pp_param_specs(jmixtral.MixtralConfig.tiny())
    tspecs = tpp.mixtral_pp_param_specs(tmixtral.MixtralConfig.tiny())
    assert jax.tree_util.tree_map(
        tuple, jspecs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)) == tpp._map_specs(tuple, tspecs)
    assert tspecs["layers"]["moe"]["w_down"] == ("pp", "ep", "tp", "fsdp")
    assert tpp.pp_param_specs(tmixtral.MixtralConfig.tiny()) == tspecs
    with pytest.raises(ValueError, match="not one of"):
        tpp.make_pipelined_loss(None, 4, model="gpt")
    with pytest.raises(ValueError, match="a mixtral pipelined loss got a "
                                         "LlamaConfig"):
        loss(None, torch.zeros((4, 9), dtype=torch.long), _tcfg(), None)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_trainer_processes_pipeline_as_one():
    """``--pp 2 --microbatches 4`` in two processes: both log the same
    falling losses, those of one process training the plain step on the
    same batches (the log's four decimals, half a unit, plus 1e-5)."""
    argv = ["--device", "cpu", "--steps", "6", "--batch", "8", "--seq", "65",
            "--data", "markov"]
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("NANOTPU_", "JOB_", "GANG_",
                                    "COORDINATOR_"))}
        env.update({"COORDINATOR_SERVICE": f"127.0.0.1:{port}",
                    "GANG_SIZE": "2", "JOB_COMPLETION_INDEX": str(rank),
                    "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nanotpu_torch.parallel.train", *argv,
             "--pp", "2", "--microbatches", "4"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    logs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-4000:]
            logs.append(err)
    finally:
        for p in procs:
            p.kill()
    losses = [[(int(line.split()[1]), float(line.split()[3]))
               for line in err.splitlines() if line.startswith("step ")]
              for err in logs]
    assert losses[0] == losses[1]
    assert [s for s, _ in losses[0]] == list(range(1, 7))
    assert losses[0][-1][1] < losses[0][0][1]
    one = ttrain.run(argv)["losses"]
    np.testing.assert_allclose([v for _, v in losses[0]],
                               [v for _, v in one], atol=5e-5 + 1e-5)
