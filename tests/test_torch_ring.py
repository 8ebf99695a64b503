"""nanotpu_torch's ring attention and sharded train step on the CPU, in
process groups of gloo, against nanotpu's on virtual CPU devices.

Two groups run once for the whole file (``spmd`` fixture): two processes
(meshes sp=2 and dp=2) and four (sp=4, fsdp=2 x tp=2, dp=2 x sp=2,
tp=2 x sp=2). The
children import torch and the port only; they read their inputs (numpy,
made here from a seed) from a pickle and write rank 0's results to
another. This process runs nanotpu's ``ring_attention_sharded`` and
``build_train_step`` on meshes of the same shapes.

The same groups run ``build_train_step(..., mesh=, n_fused=3)`` on the
five meshes from the same state (three steps in one call, nanotpu's
``n_fused=3`` the reference), the trainer's CLI at ``--dp 2
--fuse-steps 2`` beside the unfused run (two processes), and
``make_hybrid_mesh`` (four): ``tests/test_hybrid_mesh.py``'s cases on one
slice (a gloo group with no ``LOCAL_WORLD_SIZE`` is one host), the
layout over two interleaved synthetic slices (rank % 2) and the dry run's
``dcn_dp=2, fsdp=2`` step (``__graft_entry__.py:311-335``, slices the
contiguous halves) against nanotpu's ``make_hybrid_mesh`` step on four
virtual devices. nanotpu's involuntary-remat check of that step is a
warning of XLA's partitioner, which the port does not have: no
counterpart.

Tolerances, f32: ring output 1e-5 and gradients 1e-4, against nanotpu and
against the whole-sequence plain attention (``attention_lse_ref``; the
ring merges per-block softmaxes in another order). One train step as
``tests/test_torch_train.py`` holds it: loss 1e-5, Adam moments 1e-6,
updated parameters 3e-5 (a tenth of one Adam step). Three fused steps:
each of those widened by the step count, three times (loss 3e-5, moments
3e-6, parameters 9e-5); the CLI's fused and unfused losses are the same
computation, to 1e-6."""

import dataclasses
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

from nanotpu.models import llama as jl
from nanotpu.parallel import train as jtrain
from nanotpu.parallel.mesh import make_hybrid_mesh as jmake_hybrid_mesh
from nanotpu.parallel.mesh import make_mesh as jmake_mesh
from nanotpu.parallel.ring_attention import ring_attention_sharded as jring
from nanotpu_torch.ops.attention import attention_lse_ref

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

# the tiny config of tests/test_seq_parallel.py
CFG = jl.LlamaConfig(
    vocab_size=128, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=64, max_seq_len=64, dtype="float32",
)
B, S, H, KV, D = 2, 16, 4, 2, 8
RING_CASES = [(sp, causal, impl) for sp in (2, 4) for causal in (True, False)
              for impl in ("flash", "dense")]
#: mesh -> attention; sp meshes run the ring
MESHES = {"dp2": (dict(dp=2), "dense"),
          "fsdp2_tp2": (dict(fsdp=2, tp=2), "flash"),
          "dp2_sp2": (dict(dp=2, sp=2), "ring"),
          "tp2_sp2": (dict(tp=2, sp=2), "ring"),
          "sp4": (dict(sp=4), "ring")}
WORLDS = {2: ["dp2"], 4: ["fsdp2_tp2", "dp2_sp2", "tp2_sp2", "sp4"]}
N_FUSED = 3
#: the dry run's config (``__graft_entry__.py:95-98``) for its hybrid step
HYBRID_CFG = jl.LlamaConfig(
    vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
    ffn_dim=256, max_seq_len=128, dtype="float32",
)
#: the trainer's CLI in the group of two, unfused and at --fuse-steps 2
CLI_ARGV = ["--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "33",
            "--data", "markov", "--dp", "2"]

CHILD = r"""
import pickle, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, where = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{where}/rdv{world}",
                        rank=rank, world_size=world)
from torch.distributed.tensor import distribute_tensor
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.models import llama as tl
from nanotpu_torch.parallel import mesh as tm, ring_attention as tr
from nanotpu_torch.parallel import train as ttrain
from nanotpu_torch.tree import map_tree

with open(f"{where}/in.pkl", "rb") as f:
    inp = pickle.load(f)
out = {}
sent = []
shift = tr._shift
def recording_shift(tensors, group, step):
    sent.append([tuple(t.shape) for t in tensors])
    return shift(tensors, group, step)
tr._shift = recording_shift

for sp, causal, impl in inp["ring_cases"]:
    if world != sp:
        continue
    mesh = tm.make_mesh(sp=sp)
    split = tm.placements_for(mesh, tm.P(None, "sp"), 4)
    q, k, v = (distribute_tensor(torch.from_numpy(inp[n]), mesh,
                                 split).requires_grad_() for n in ("q", "k", "v"))
    del sent[:]
    o = tr.ring_attention_sharded(q, k, v, mesh, causal=causal, impl=impl)
    dout = distribute_tensor(torch.from_numpy(inp["dout"]), mesh, split)
    (o.to_local() * dout.to_local()).sum().backward()
    out[("ring", sp, causal, impl)] = {
        "out": o.full_tensor().detach().numpy(),
        "grads": [t.grad.full_tensor().numpy() for t in (q, k, v)],
        "sent": list(sent)}

for name in inp["worlds"][world]:
    factors, attn = inp["meshes"][name]
    mesh = tm.make_mesh(**factors)
    cfg = tl.LlamaConfig(**{**inp["cfg"], "attn_impl": attn})
    opt = ttrain.make_optimizer()
    params = params_from_numpy(inp["params"], "cpu")
    state = ttrain.place_state(ttrain.TrainState(params, opt.init(params), 0),
                               cfg, mesh)
    step = ttrain.build_train_step(cfg, opt, mesh=mesh)
    state, loss = step(state, torch.from_numpy(inp["tokens"]))
    whole = lambda t: t.full_tensor().detach().numpy()
    out[("train", name)] = {
        "loss": loss.item(), "params": map_tree(whole, state.params),
        "mu": map_tree(whole, state.opt_state["mu"]),
        "nu": map_tree(whole, state.opt_state["nu"]),
        "count": int(state.opt_state["count"].full_tensor()),
        "placements": str(state.params["layers"][0]["attn"]["wq"].placements)}

    # n_fused steps in one call from the same state
    params = params_from_numpy(inp["params"], "cpu")
    state = ttrain.place_state(ttrain.TrainState(params, opt.init(params), 0),
                               cfg, mesh)
    step = ttrain.build_train_step(cfg, opt, mesh=mesh,
                                   n_fused=inp["n_fused"])
    state, loss = step(state, torch.from_numpy(inp["fused_tokens"]))
    out[("fused", name)] = {
        "loss": loss.item(), "step": state.step,
        "kind": type(step).__name__,
        "params": map_tree(whole, state.params),
        "mu": map_tree(whole, state.opt_state["mu"]),
        "nu": map_tree(whole, state.opt_state["nu"]),
        "count": int(state.opt_state["count"].full_tensor())}

if world == 2:
    out["cli"] = {fuse: ttrain.run(inp["cli_argv"]
                                   + ["--fuse-steps", str(fuse)])["losses"]
                  for fuse in (1, 2)}

if world == 4:
    hybrid = {}
    plain = tm.make_mesh(fsdp=2, tp=2)
    mesh = tm.make_hybrid_mesh(fsdp=2, tp=2)
    hybrid["fallback"] = (mesh.mesh.tolist(), plain.mesh.tolist(),
                          mesh.mesh_dim_names)
    hybrid["dcn_dp_1"] = tm.axis_sizes(tm.make_hybrid_mesh(dcn_dp=1, dp=2,
                                                           ep=2))
    try:
        tm.make_hybrid_mesh(dcn_dp=2, fsdp=2, tp=2)
    except ValueError as e:
        hybrid["mismatch"] = str(e)
    try:
        tm.make_hybrid_mesh(dcn_dp=2, fsdp=2, slice_of=lambda r: int(r >= 3))
    except ValueError as e:
        hybrid["uneven"] = str(e)
    for inner in ("fsdp", "tp"):
        mesh = tm.make_hybrid_mesh(dcn_dp=2, slice_of=lambda r: r % 2,
                                   **{inner: 2})
        mine = {a: dist.get_process_group_ranks(mesh.get_group(a))
                for a in ("dp", inner)}
        groups = [None] * world
        dist.all_gather_object(groups, mine)
        hybrid[("layout", inner)] = {"mesh": mesh.mesh.tolist(),
                                     "sizes": tm.axis_sizes(mesh),
                                     "groups": groups}
    cfg = tl.LlamaConfig(**inp["hybrid_cfg"])
    for label, mesh in (
            ("dcn", tm.make_hybrid_mesh(dcn_dp=2, fsdp=2,
                                        slice_of=lambda r: int(r >= 2))),
            ("fallback", tm.make_hybrid_mesh(dp=2, fsdp=2))):
        opt = ttrain.make_optimizer()
        params = params_from_numpy(inp["hybrid_params"], "cpu")
        state = ttrain.place_state(
            ttrain.TrainState(params, opt.init(params), 0), cfg, mesh)
        state, loss = ttrain.build_train_step(cfg, opt, mesh=mesh)(
            state, torch.from_numpy(inp["hybrid_tokens"]))
        whole = lambda t: t.full_tensor().detach().numpy()
        hybrid[("step", label)] = {
            "loss": loss.item(), "params": map_tree(whole, state.params),
            "sizes": tm.axis_sizes(mesh), "mesh": mesh.mesh.tolist()}
    out["hybrid"] = hybrid

if rank == 0:
    with open(f"{where}/out{world}.pkl", "wb") as f:
        pickle.dump(out, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def jax_params():
    return jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(0), CFG)


@pytest.fixture(scope="module")
def inputs(jax_params):
    rng = np.random.default_rng(0)
    q, dout = (rng.standard_normal((B, S, H, D), np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, KV, D), np.float32) for _ in range(2))
    tokens = rng.integers(0, CFG.vocab_size, (4, 33)).astype(np.int32)
    fused = rng.integers(0, CFG.vocab_size, (N_FUSED, 4, 33)).astype(np.int32)
    hybrid_tokens = rng.integers(0, HYBRID_CFG.vocab_size,
                                 (4, 64)).astype(np.int32)
    hybrid_params = jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(10), HYBRID_CFG)
    return {"q": q, "k": k, "v": v, "dout": dout, "tokens": tokens,
            "params": jax.tree_util.tree_map(np.asarray, jax_params),
            "cfg": _fields(CFG), "ring_cases": RING_CASES, "meshes": MESHES,
            "worlds": WORLDS, "n_fused": N_FUSED, "fused_tokens": fused,
            "cli_argv": CLI_ARGV, "hybrid_cfg": _fields(HYBRID_CFG),
            "hybrid_tokens": hybrid_tokens,
            "hybrid_params": jax.tree_util.tree_map(np.asarray,
                                                    hybrid_params)}


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _jax_state(params, cfg, mesh):
    opt = jtrain.make_optimizer()
    state = jtrain.TrainState(params, opt.init(params),
                              jnp.zeros((), jnp.int32))
    return jtrain.place_state(state, cfg, mesh), opt


def nanotpu_results(inputs, jax_params):
    """nanotpu's ``n_fused`` steps on each mesh and its hybrid dry-run
    step, as numpy."""
    out = {}
    for name, (factors, attn) in MESHES.items():
        cfg = dataclasses.replace(CFG, attn_impl=attn)
        n = int(np.prod(list(factors.values())))
        mesh = jmake_mesh(devices=jax.devices()[:n], **factors)
        state, opt = _jax_state(jax_params, cfg, mesh)
        state, loss = jtrain.build_train_step(cfg, mesh, opt,
                                              n_fused=N_FUSED)(
            state, jnp.asarray(inputs["fused_tokens"]))
        out[("fused", name)] = jax.tree_util.tree_map(
            np.asarray, (float(loss), int(state.step), state.params,
                         state.opt_state[1][0].mu, state.opt_state[1][0].nu))
    devices = jax.devices()[:4]
    mesh = jmake_hybrid_mesh(
        dcn_dp=2, dp=1, fsdp=2, tp=1, devices=devices,
        slice_of=lambda d: 0 if devices.index(d) < 2 else 1)
    state, opt = _jax_state(jax.tree_util.tree_map(
        jnp.asarray, inputs["hybrid_params"]), HYBRID_CFG, mesh)
    state, loss = jtrain.build_train_step(HYBRID_CFG, mesh, opt)(
        state, jnp.asarray(inputs["hybrid_tokens"]))
    out["hybrid"] = {"loss": float(loss), "shape": dict(mesh.shape),
                     "params": jax.tree_util.tree_map(np.asarray,
                                                      state.params)}
    return out


@pytest.fixture(scope="module")
def run(inputs, jax_params, tmp_path_factory):
    """Both process groups, started together, and nanotpu's fused and
    hybrid results, computed while they run: (rank 0's results of each
    group, nanotpu's)."""
    where = tmp_path_factory.mktemp("spmd")
    with open(where / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    (where / "child.py").write_text(CHILD)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("NANOTPU_", "JOB_", "GANG_", "COORDINATOR_",
                                "LOCAL_WORLD_SIZE"))}
    env.update({"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    procs = [subprocess.Popen(
        [sys.executable, str(where / "child.py"), str(r), str(w), str(where)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for w in WORLDS for r in range(w)]
    try:
        theirs = nanotpu_results(inputs, jax_params)
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


@pytest.fixture(scope="module")
def nanotpu(run):
    return run[1]


@pytest.fixture(scope="module")
def jax_ring(inputs):
    """nanotpu's ring output and gradients by (sp, causal), each computed
    once, under one jit."""
    done = {}

    def get(sp, causal):
        if (sp, causal) not in done:
            mesh = jmake_mesh(sp=sp, devices=jax.devices()[:sp])
            q, k, v, dout = (jnp.asarray(inputs[n])
                             for n in ("q", "k", "v", "dout"))

            @jax.jit
            def run(q, k, v):
                out, pull = jax.vjp(
                    lambda q, k, v: jring(q, k, v, mesh, causal=causal),
                    q, k, v)
                return out, pull(dout)

            out, grads = run(q, k, v)
            done[sp, causal] = (np.asarray(out),
                                [np.asarray(g) for g in grads])
        return done[sp, causal]

    return get


def _plain(inputs, causal):
    q, k, v = (torch.from_numpy(inputs[n]).requires_grad_()
               for n in ("q", "k", "v"))
    out, _ = attention_lse_ref(q, k, v, causal)
    grads = torch.autograd.grad(out, (q, k, v),
                                torch.from_numpy(inputs["dout"]))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("sp,causal,impl", RING_CASES)
def test_ring_matches_nanotpu_and_plain(spmd, inputs, jax_ring, sp, causal,
                                       impl):
    got = spmd[("ring", sp, causal, impl)]
    for want_out, want_grads in (jax_ring(sp, causal),
                                 _plain(inputs, causal)):
        np.testing.assert_allclose(got["out"], want_out, atol=1e-5)
        for g, w in zip(got["grads"], want_grads):
            np.testing.assert_allclose(g, w, atol=1e-4)
    # each rank sends k/v n-1 times forward and their gradients n-1 times
    # back, always at KV heads
    blk = (B, S // sp, KV, D)
    assert got["sent"] == [[blk, blk]] * (2 * (sp - 1))


@pytest.mark.parametrize("name", list(MESHES))
def test_train_step_matches_nanotpu_on_the_same_mesh(spmd, inputs, jax_params,
                                                     name):
    factors, attn = MESHES[name]
    cfg = dataclasses.replace(CFG, attn_impl=attn)
    n = int(np.prod(list(factors.values())))
    mesh = jmake_mesh(devices=jax.devices()[:n], **factors)
    opt = jtrain.make_optimizer()
    state = jtrain.TrainState(jax_params, opt.init(jax_params),
                              jnp.zeros((), jnp.int32))
    state = jtrain.place_state(state, cfg, mesh)
    state, loss = jtrain.build_train_step(cfg, mesh, opt)(
        state, jnp.asarray(inputs["tokens"]))
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
    assert got["count"] == 1
    # the placements follow nanotpu's spec: wq is P("fsdp", "tp")
    want = ["Replicate()"] * 6
    for axis, dim in (("fsdp", 0), ("tp", 1)):
        want[("dp", "pp", "fsdp", "tp", "sp", "ep").index(axis)] = \
            f"Shard(dim={dim})"
    assert got["placements"] == "(" + ", ".join(want) + ")"


def _assert_leaves_close(mine, theirs, atol):
    a = jax.tree_util.tree_leaves(mine)
    b = jax.tree_util.tree_leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, np.asarray(y), atol=atol)


@pytest.mark.parametrize("name", list(MESHES))
def test_fused_steps_match_nanotpu_on_the_same_mesh(spmd, nanotpu, name):
    """``build_train_step(..., mesh=, n_fused=3)``: one call of three
    steps, the last loss, the step count and the state against nanotpu's
    ``n_fused=3`` scan on the same mesh (each tolerance thrice one
    step's)."""
    got = spmd[("fused", name)]
    loss, step, params, mu, nu = nanotpu[("fused", name)]
    assert got["kind"] == "FusedTrainStep"
    assert got["step"] == step == got["count"] == N_FUSED
    np.testing.assert_allclose(got["loss"], loss, atol=N_FUSED * 1e-5)
    _assert_leaves_close(got["params"], params, N_FUSED * 3e-5)
    _assert_leaves_close(got["mu"], mu, N_FUSED * 1e-6)
    _assert_leaves_close(got["nu"], nu, N_FUSED * 1e-6)


def test_cli_fuse_steps_on_a_mesh_logs_the_unfused_losses(spmd):
    """``--dp 2 --fuse-steps 2`` in the group of two logs, at each call's
    last step, the losses of the unfused run on the same batches."""
    eager, fused = spmd["cli"][1], spmd["cli"][2]
    assert [s for s, _ in eager] == [1, 2, 3, 4]
    assert [s for s, _ in fused] == [2, 4]
    want = dict(eager)
    np.testing.assert_allclose([v for _, v in fused],
                               [want[s] for s, _ in fused], atol=1e-6)
    assert fused[-1][1] < eager[0][1]


def test_hybrid_mesh_on_one_slice_is_the_plain_mesh(spmd):
    """A gloo group without LOCAL_WORLD_SIZE is one host: ``dcn_dp=0``
    finds one slice and returns ``make_mesh``'s mesh."""
    got, plain, names = spmd["hybrid"]["fallback"]
    assert got == plain and names == ("dp", "pp", "fsdp", "tp", "sp", "ep")


def test_hybrid_mesh_explicit_dcn_dp_1_is_plain(spmd):
    assert spmd["hybrid"]["dcn_dp_1"] == {"dp": 2, "pp": 1, "fsdp": 1,
                                          "tp": 1, "sp": 1, "ep": 2}


def test_hybrid_mesh_refuses_a_dcn_dp_the_slices_contradict(spmd):
    with pytest.raises(ValueError) as want:
        jmake_hybrid_mesh(dcn_dp=2, dp=1, fsdp=2, tp=2,
                          devices=jax.devices()[:4])
    assert spmd["hybrid"]["mismatch"] == str(want.value)
    assert "span 1 slice" in str(want.value)


def test_hybrid_mesh_refuses_slices_of_another_size(spmd):
    """Slices of 3 and 1 ranks cannot each hold a dp=1 x fsdp=2 block:
    nanotpu's message."""
    devices = jax.devices()[:4]
    with pytest.raises(ValueError) as want:
        jmake_hybrid_mesh(dcn_dp=2, fsdp=2, devices=devices,
                          slice_of=lambda d: int(devices.index(d) >= 3))
    assert spmd["hybrid"]["uneven"] == str(want.value)


@pytest.mark.parametrize("inner", ["fsdp", "tp"])
def test_hybrid_mesh_keeps_inner_axes_inside_a_slice(spmd, inner):
    """Two interleaved synthetic slices (rank % 2): dp is dcn_dp and
    crosses them, every ``inner`` group lies inside one, on every rank;
    the rank layout is nanotpu's reshape of the slices in order."""
    got = spmd["hybrid"][("layout", inner)]
    assert got["sizes"]["dp"] == 2 and got["sizes"][inner] == 2
    arr = np.array(got["mesh"])
    assert arr.reshape(2, 2).tolist() == [[0, 2], [1, 3]]
    for groups in got["groups"]:
        assert len({r % 2 for r in groups[inner]}) == 1
        assert {r % 2 for r in groups["dp"]} == {0, 1}
    assert sorted(map(tuple, (g[inner] for g in got["groups"]))) == \
        [(0, 2), (0, 2), (1, 3), (1, 3)]


@pytest.mark.parametrize("label", ["dcn", "fallback"])
def test_hybrid_dry_run_step_matches_nanotpu(spmd, nanotpu, label):
    """The dry run's step on ``dcn_dp=2, fsdp=2`` (slices the contiguous
    halves) and on the one-slice fallback mesh (dp2 x fsdp2): the loss
    and the updated parameters of nanotpu's ``make_hybrid_mesh`` step on
    four virtual devices."""
    got, want = spmd["hybrid"][("step", label)], nanotpu["hybrid"]
    assert got["sizes"] == {**want["shape"], "dp": 2}
    assert np.array(got["mesh"]).reshape(-1).tolist() == [0, 1, 2, 3]
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5)
    _assert_leaves_close(got["params"], want["params"], 3e-5)
