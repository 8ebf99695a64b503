"""nanotpu_torch's ring attention and sharded train step on the CPU, in
process groups of gloo, against nanotpu's on virtual CPU devices.

Two groups run once for the whole file (``spmd`` fixture): two processes
(meshes sp=2 and dp=2) and four (sp=4, fsdp=2 x tp=2, dp=2 x sp=2,
tp=2 x sp=2). The
children import torch and the port only; they read their inputs (numpy,
made here from a seed) from a pickle and write rank 0's results to
another. This process runs nanotpu's ``ring_attention_sharded`` and
``build_train_step`` on meshes of the same shapes.

Tolerances, f32: ring output 1e-5 and gradients 1e-4, against nanotpu and
against the whole-sequence plain attention (``attention_lse_ref``; the
ring merges per-block softmaxes in another order). One train step as
``tests/test_torch_train.py`` holds it: loss 1e-5, Adam moments 1e-6,
updated parameters 3e-5 (a tenth of one Adam step)."""

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
    return {"q": q, "k": k, "v": v, "dout": dout, "tokens": tokens,
            "params": jax.tree_util.tree_map(np.asarray, jax_params),
            "cfg": {f.name: getattr(CFG, f.name)
                    for f in dataclasses.fields(CFG)},
            "ring_cases": RING_CASES, "meshes": MESHES, "worlds": WORLDS}


@pytest.fixture(scope="module")
def spmd(inputs, tmp_path_factory):
    """Both process groups, started together; rank 0's results of each."""
    where = tmp_path_factory.mktemp("spmd")
    with open(where / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    (where / "child.py").write_text(CHILD)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(where / "child.py"), str(r), str(w), str(where)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for w in WORLDS for r in range(w)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
    out = {}
    for w in WORLDS:
        with open(where / f"out{w}.pkl", "rb") as f:
            out.update(pickle.load(f))
    return out


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
