"""nanotpu_torch's sharded inference on the CPU, in process groups of gloo,
against nanotpu's on its virtual CPU devices (``tests/test_sharded_decode.py``'s
Llama cases).

Two groups run once for the whole file (``spmd`` fixture): two processes
(mesh tp=2) and four (tp=2 x fsdp=2). The children import torch and the
port only; they read their inputs (numpy, made here from a seed) from a
pickle, and EVERY rank writes its results to its own pickle. This process
runs nanotpu's ``generate``, ``prefill``, ``speculative_generate`` and
``Engine`` on meshes of the same shapes, over the same parameters.

Tolerances: tokens exactly (f32, greedy); prefill logits 1e-4 (the tp
split sums each row-parallel product in two halves, in another order than
one process and than XLA). Sampled rows (a temperature of 0.8) cannot be
held against nanotpu, whose generator is jax's: they are held equal on
every rank of the mesh, the leader's requests and each follower's."""

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

from nanotpu.models import generate as jgen
from nanotpu.models import llama as jl
from nanotpu.models import mixtral as jmixtral
from nanotpu.models.quant import quantize_params as jquantize
from nanotpu.models.speculative import speculative_generate as jspec
from nanotpu.parallel import infer as jinfer
from nanotpu.parallel.mesh import make_mesh as jmake_mesh
from nanotpu.serving.engine import Engine as JEngine
from nanotpu_torch.models import mixtral as tmixtral
from nanotpu_torch.parallel import infer as tinfer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

CFG = dataclasses.replace(jl.LlamaConfig.tiny(), max_seq_len=128)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
N_NEW = 12
#: the engines' requests: each (prompt, new tokens, temperature); the
#: sampled row is held equal across ranks only
REQUESTS = [([3, 1, 4, 1, 5], 10, 0.0), ([7, 7, 7], 10, 0.8), ([42], 10, 0.0),
            ([9, 8, 7, 6, 5], 10, 0.0)]
ENGINES = {"plain": {}, "kv_int8": {"kv_int8": True}, "int8": {},
           "spec": {"spec_policy": "always", "draft_tokens": 3},
           "reset": {}}
#: world -> mesh factors, and the engines each group serves ("reset": a
#: plain engine whose leader idles past a few heartbeats, then fails its
#: first decode cycle, then serves the requests again)
WORLDS = {2: (dict(tp=2), list(ENGINES)), 4: (dict(tp=2, fsdp=2), ["plain"])}
ENGINE_KW = dict(slots=3, max_len=128, buckets=(16, 32), chunk_steps=4,
                 chunk_steps_max=8)
#: world -> the meshes a whole tree is placed on to count the bytes its
#: shards keep: split over one axis (tp's embed, wo and w_down rows, fsdp's
#: wq/wk/wv and gate/up rows: contiguous blocks) and over two
PLACEMENTS = {2: {"tp2": dict(tp=2), "fsdp2": dict(fsdp=2)},
              4: {"tp2_fsdp2": dict(tp=2, fsdp=2)}}

CHILD = r"""
import dataclasses, gc, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, where = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{where}/rdv{world}",
                        rank=rank, world_size=world)
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.models import generate as tg, llama as tl
from nanotpu_torch.models.quant import quantize_params
from nanotpu_torch.models.speculative import speculative_generate
from nanotpu_torch.parallel import infer, mesh as tm
from nanotpu_torch.serving.engine import Engine
from nanotpu_torch.tree import leaves

with open(f"{where}/in.pkl", "rb") as f:
    inp = pickle.load(f)
factors, engines = inp["worlds"][world]
mesh = tm.make_mesh(**factors)
cfg = tl.LlamaConfig(**inp["cfg"])
dcfg = dataclasses.replace(cfg, n_layers=1)
params = params_from_numpy(inp["params"], "cpu")
# the truncated draft: the target's first layer, its embedding, final norm
# and head tied in (the same tensors)
draft = {**params, "layers": [params["layers"][0]]}
prompt = torch.tensor([inp["prompt"]])
n = inp["n_new"]
out = {}

def gen(p, c, **kw):
    placed = infer.place_params(p, c, mesh)
    g = torch.Generator().manual_seed(7)
    return tg.generate(placed, prompt, c, n, mesh=mesh, generator=g,
                       **kw)[0].tolist()

out["greedy"] = gen(params, cfg)
try:
    tg.generate(params, prompt, cfg, 2, mesh=mesh)
    out["unplaced"] = "decoded"
except ValueError as e:
    out["unplaced"] = str(e)
out["sampled"] = gen(params, cfg, temperature=0.8)
placed = infer.place_params(params, cfg, mesh)
logits, cache = tg.prefill(placed, prompt, cfg, 64, mesh=mesh)
out["prefill_logits"] = logits.numpy()
out["cache_k0"] = tuple(cache.k[0].shape)
from nanotpu_torch.serving.engine import SlotCache8
out["placed_cache_k0"] = tuple(infer.place_cache(
    SlotCache8.create(cfg, 3, 16, device="cpu"), mesh).k_scale[0]
    .to_local().shape)
wq = placed["layers"][0]["attn"]["wq"]
out["wq_local"] = tuple(wq.to_local().shape)
out["wq_placements"] = str(wq.placements)
if world == 2:
    out["int8"] = gen(quantize_params(params), cfg)
    out["flash"] = gen(params, dataclasses.replace(cfg, attn_impl="flash"))
    out["int8_scale_local"] = tuple(
        infer.place_params(quantize_params(params), cfg, mesh)
        ["layers"][0]["attn"]["wq"].s.to_local().shape)
for temp in (0.0, 0.8):
    out[("spec", temp)] = speculative_generate(
        infer.place_params(params, cfg, mesh),
        infer.place_params(draft, dcfg, mesh), prompt, cfg, dcfg, n,
        draft_tokens=3, temperature=temp, mesh=mesh,
        generator=torch.Generator().manual_seed(7))[0].tolist()

# every shard placed from a whole tree, the tree then dropped: the bytes
# each rank keeps alive against its shards' own
def kept_and_own(factors):
    shards = tm.local(infer.place_params(
        params_from_numpy(inp["params"], "cpu"), cfg, tm.make_mesh(**factors)))
    gc.collect()
    return (sum(t.untyped_storage().nbytes() for t in leaves(shards)),
            sum(t.numel() * t.element_size() for t in leaves(shards)))

out["bytes"] = {name: kept_and_own(f)
                for name, f in inp["placements"][world].items()}

import time

for name in engines:
    kw = dict(inp["engines"][name])
    p = quantize_params(params) if name == "int8" else params
    if name == "spec":
        kw.update(draft_params=draft, draft_cfg=dcfg)
    if name == "reset":
        Engine.HEARTBEAT_S = 0.05
    eng = Engine(p, cfg, mesh=mesh, device="cpu", **inp["engine_kw"], **kw)
    Engine.HEARTBEAT_S = 10.0
    assert eng.wait_warm(120)
    res = {"chips": eng.stats()["chips"],
           "cache_k0": tuple(eng._cache.k[0].shape)}
    if eng._d_cache is not None:
        res["draft_cache_k0"] = tuple(eng._d_cache.k[0].shape)
        res["tied"] = (eng.draft_params["embed"].data_ptr()
                       == eng.params["embed"].data_ptr())
    if rank == 0:
        if name == "reset":
            time.sleep(0.5)  # idle: heartbeats go out
            cycle = eng._decode_cycle

            def failing():
                eng._decode_cycle = cycle
                raise RuntimeError("injected")

            eng._decode_cycle = failing
            failed = [eng.submit(t, m, temp)
                      for t, m, temp in inp["requests"][:2]]
            for r in failed:
                assert r.wait(120)
            res["failed"] = [r.error for r in failed]
        reqs = [eng.submit(t, m, temp) for t, m, temp in inp["requests"]]
        for r in reqs:
            assert r.wait(120) and r.error is None, r.error
        eng.stop()
        res["outs"] = [r.out for r in reqs]
    else:
        try:
            eng.submit([1, 2], 2)
            res["submit"] = "accepted"
        except RuntimeError as e:
            res["submit"] = str(e)
        eng.stop(timeout=120)
        assert not eng._thread.is_alive()
        followed = eng.followed
        if name == "reset":
            res["failed"] = [r.error for r in followed[:2]]
            followed = followed[2:]
        res["outs"] = [r.out for r in followed]
    res["descriptors"] = eng._seq
    out[("engine", name)] = res

with open(f"{where}/out{world}_{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
"""


def np_params(cfg, seed: int) -> dict:
    """A Llama parameter tree from numpy (nanotpu's shapes and scales,
    truncated normals)."""
    rng = np.random.default_rng(seed)
    hd = cfg.head_dim

    def dense(shape, scale=None):
        scale = 1.0 / np.sqrt(shape[0]) if scale is None else scale
        w = np.clip(rng.standard_normal(shape), -3, 3) * scale
        return w.astype(np.float32)

    def ones():
        return np.ones((cfg.dim,), np.float32)

    resid = 1.0 / np.sqrt(2 * cfg.n_layers)
    layers = [{
        "attn": {"wq": dense((cfg.dim, cfg.n_heads * hd)),
                 "wk": dense((cfg.dim, cfg.n_kv_heads * hd)),
                 "wv": dense((cfg.dim, cfg.n_kv_heads * hd)),
                 "wo": dense((cfg.n_heads * hd, cfg.dim),
                             resid / np.sqrt(cfg.dim))},
        "mlp": {"w_gate": dense((cfg.dim, cfg.ffn_dim)),
                "w_up": dense((cfg.dim, cfg.ffn_dim)),
                "w_down": dense((cfg.ffn_dim, cfg.dim),
                                resid / np.sqrt(cfg.ffn_dim))},
        "attn_norm": ones(), "mlp_norm": ones(),
    } for _ in range(cfg.n_layers)]
    return {"embed": dense((cfg.vocab_size, cfg.dim), 0.02), "layers": layers,
            "final_norm": ones(), "lm_head": dense((cfg.dim, cfg.vocab_size))}


@pytest.fixture(scope="module")
def params():
    return np_params(CFG, 0)


@pytest.fixture(scope="module")
def spmd(params, tmp_path_factory):
    """Both process groups, started together: every rank's results, by
    (world, rank). nanotpu's results are computed while they run."""
    where = tmp_path_factory.mktemp("infer")
    inputs = {"params": params, "prompt": PROMPT, "n_new": N_NEW,
              "cfg": {f.name: getattr(CFG, f.name)
                      for f in dataclasses.fields(CFG)},
              "worlds": WORLDS, "engines": ENGINES, "engine_kw": ENGINE_KW,
              "requests": REQUESTS, "placements": PLACEMENTS}
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
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
    out = {}
    for w in WORLDS:
        for r in range(w):
            with open(where / f"out{w}_{r}.pkl", "rb") as f:
                out[w, r] = pickle.load(f)
    return out


def _jmesh(world):
    return jmake_mesh(devices=jax.devices()[:world], **WORLDS[world][0])


def _jparams(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _jgenerate(params, cfg, mesh=None, n=N_NEW):
    fn = functools.partial(jgen.generate, cfg=cfg, max_new_tokens=n,
                           mesh=mesh)
    return np.asarray(jax.jit(fn)(params, jnp.asarray([PROMPT], jnp.int32))
                      )[0].tolist()


@pytest.fixture(scope="module")
def jax_generate(params):
    """nanotpu's greedy generate: on one device and on each mesh."""
    p = _jparams(params)
    out = {"single": _jgenerate(p, CFG)}
    for w in WORLDS:
        mesh = _jmesh(w)
        out[w] = _jgenerate(jinfer.place_params(p, CFG, mesh), CFG, mesh)
    mesh = _jmesh(2)
    q = jquantize(p)
    out["int8_single"] = _jgenerate(q, CFG)
    out["int8"] = _jgenerate(jinfer.place_params(q, CFG, mesh), CFG, mesh)
    fcfg = dataclasses.replace(CFG, attn_impl="flash")
    out["flash"] = _jgenerate(jinfer.place_params(p, fcfg, mesh), fcfg, mesh)
    logits, _ = jax.jit(lambda pp, t: jgen.prefill(pp, t, CFG, 64, mesh=mesh))(
        jinfer.place_params(p, CFG, mesh), jnp.asarray([PROMPT], jnp.int32))
    out["prefill_logits"] = np.asarray(logits)
    return out


def _jdraft(p):
    return {**p, "layers": [p["layers"][0]]}


def test_generate_on_the_mesh_equals_nanotpu_and_one_process(
        spmd, params, jax_generate):
    """Greedy tokens at tp2 and tp2 x fsdp2: equal to nanotpu's on the same
    mesh, to nanotpu's on one device and to the port's own one process."""
    from nanotpu_torch.convert import params_from_numpy
    from nanotpu_torch.models import generate as tg

    for w in WORLDS:
        assert spmd[w, 0]["greedy"] == jax_generate[w]
    assert jax_generate[2] == jax_generate["single"]
    one = tg.generate(params_from_numpy(params, "cpu"),
                      torch.tensor([PROMPT]), tl_cfg(), N_NEW)[0].tolist()
    assert spmd[2, 0]["greedy"] == one


def tl_cfg():
    from nanotpu_torch.models.llama import LlamaConfig

    return LlamaConfig(**{f.name: getattr(CFG, f.name)
                          for f in dataclasses.fields(CFG)})


@pytest.mark.parametrize("world", list(WORLDS))
def test_every_rank_returns_the_same_tokens(spmd, world):
    """Greedy and sampled (the same generator seed on every rank) generate
    and speculation: every rank's tokens equal rank 0's."""
    keys = ["greedy", "sampled", ("spec", 0.0), ("spec", 0.8)]
    for r in range(1, world):
        for key in keys:
            assert spmd[world, r][key] == spmd[world, 0][key], (r, key)


def test_prefill_logits_close_to_nanotpu(spmd, jax_generate):
    for r in range(2):
        np.testing.assert_allclose(spmd[2, r]["prefill_logits"],
                                   jax_generate["prefill_logits"], atol=1e-4)


def test_int8_and_flash_prefill_on_the_mesh(spmd, jax_generate):
    """int8 weights at tp2 (QArray scales placed with the contraction axis
    dropped) equal nanotpu's and its one-device int8 run; flash prefill on
    the mesh (the kernel's plain version on each rank's head shard) equals
    nanotpu's and dense."""
    assert spmd[2, 0]["int8"] == jax_generate["int8"]
    assert jax_generate["int8"] == jax_generate["int8_single"]
    assert spmd[2, 0]["flash"] == jax_generate["flash"]
    assert spmd[2, 0]["flash"][:6] == spmd[2, 0]["greedy"][:6]
    # the scale [1, H*hd] splits over tp like its weight's columns
    assert spmd[2, 0]["int8_scale_local"] == (1, CFG.n_heads * CFG.head_dim // 2)


@pytest.mark.parametrize("world", list(WORLDS))
def test_params_and_caches_are_sharded(spmd, world):
    """Not replication in disguise: wq's columns split over tp (its rows
    over fsdp), and every cache holds n_kv_heads / tp heads a rank."""
    got = spmd[world, 1]
    fsdp = WORLDS[world][0].get("fsdp", 1)
    assert got["wq_local"] == (CFG.dim // fsdp,
                               CFG.n_heads * CFG.head_dim // 2)
    assert got["cache_k0"] == (1, 64, CFG.n_kv_heads // 2, CFG.head_dim)
    # place_cache: an int8 cache's scale planes split their kv heads too
    assert got["placed_cache_k0"] == (3, 16, CFG.n_kv_heads // 2)
    for name in WORLDS[world][1]:
        eng = got[("engine", name)]
        assert eng["cache_k0"][2] == CFG.n_kv_heads // 2
        assert eng["chips"] == world
        if name == "spec":
            assert eng["draft_cache_k0"][2] == CFG.n_kv_heads // 2
            assert eng["tied"]


@pytest.mark.parametrize("world", list(WORLDS))
def test_speculative_generate_on_the_mesh(spmd, params, world):
    """Greedy speculation over the mesh (the draft placed on the target's
    mesh) equals nanotpu's on the same mesh and greedy generate."""
    p = _jparams(params)
    dcfg = dataclasses.replace(CFG, n_layers=1)
    mesh = _jmesh(world)
    want = np.asarray(jax.jit(functools.partial(
        jspec, cfg=CFG, draft_cfg=dcfg, max_new_tokens=N_NEW, draft_tokens=3,
        mesh=mesh))(jinfer.place_params(p, CFG, mesh),
                    jinfer.place_params(_jdraft(p), dcfg, mesh),
                    jnp.asarray([PROMPT], jnp.int32)))[0].tolist()
    assert spmd[world, 0][("spec", 0.0)] == want
    assert want == spmd[world, 0]["greedy"]


def _jengine(params, name, world):
    """nanotpu's Engine(mesh=) served the requests, all greedy."""
    p = _jparams(params)
    kw = dict(ENGINES[name])
    if name == "int8":
        p = jquantize(p)
    if name == "spec":
        kw.update(draft_params=_jdraft(p),
                  draft_cfg=dataclasses.replace(CFG, n_layers=1))
    eng = JEngine(p, CFG, mesh=_jmesh(world), **ENGINE_KW, **kw)
    try:
        reqs = [eng.submit(t, m) for t, m, _ in REQUESTS]
        for r in reqs:
            assert r.wait(120) and r.error is None
        return [r.out for r in reqs]
    finally:
        eng.stop()


ENGINE_CASES = [(w, name) for w, (_, names) in WORLDS.items()
                for name in names if name != "reset"]


@pytest.mark.parametrize("world,name", ENGINE_CASES)
def test_engine_on_the_mesh(spmd, params, world, name):
    """Engine(mesh=): the greedy rows equal nanotpu's Engine(mesh=) on the
    same mesh; every follower's requests (rebuilt from rank 0's admission
    descriptors) end with rank 0's tokens, the sampled row included."""
    got = spmd[world, 0][("engine", name)]["outs"]
    want = _jengine(params, name, world)
    for i, (_, _, temp) in enumerate(REQUESTS):
        if temp == 0.0:
            assert got[i] == want[i], (name, i)
        assert len(got[i]) == REQUESTS[i][1]
    for r in range(1, world):
        assert spmd[world, r][("engine", name)]["outs"] == got, r


def test_followers_keep_step_through_idle_and_a_failed_cycle(spmd):
    """An idle leader's heartbeats, and its reset after a failed decode
    cycle, reach every follower: the admitted rows fail alike on both
    ranks, the next requests are served as before (the greedy rows as
    the plain engine's), and both ranks count
    the same descriptors (rank 0's sent, the follower's received)."""
    lead, follow = (spmd[2, r][("engine", "reset")] for r in range(2))
    assert lead["failed"] == ["engine error: injected"] * 2
    assert follow["failed"] == ["engine error: rank 0's cycle failed"] * 2
    assert follow["outs"] == lead["outs"]
    plain = spmd[2, 0][("engine", "plain")]["outs"]
    for i, (_, _, temp) in enumerate(REQUESTS):
        if temp == 0.0:  # the failed rows drew from the generator
            assert lead["outs"][i] == plain[i]
    assert lead["descriptors"] == follow["descriptors"]
    # more than the served units: the heartbeats and the reset
    assert lead["descriptors"] > spmd[2, 0][("engine", "plain")]["descriptors"]
    for name in WORLDS[2][1]:
        assert (spmd[2, 0][("engine", name)]["descriptors"]
                == spmd[2, 1][("engine", name)]["descriptors"])


def test_a_tree_not_placed_is_refused_on_a_mesh(spmd):
    for w in WORLDS:
        assert "place_params" in spmd[w, 0]["unplaced"]


def test_submit_on_a_follower_raises(spmd):
    for (world, rank), out in spmd.items():
        for name in WORLDS[world][1]:
            if rank:
                assert "follows rank 0" in out[("engine", name)]["submit"]


@pytest.mark.parametrize("world,name", [(w, n) for w, meshes in
                                        PLACEMENTS.items() for n in meshes])
def test_placed_shards_keep_only_their_own_bytes(spmd, world, name):
    """After the whole tree is dropped, the storages of every rank's local
    shards hold exactly the shards' bytes: a shard that is a block of its
    tensor's rows is copied, not kept as a view of the whole."""
    for rank in range(world):
        kept, own = spmd[world, rank]["bytes"][name]
        assert kept == own


def _spec_tuples(tree):
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tuples(v) for v in tree]
    return tuple(tree)


def test_mixtral_on_a_mesh_is_not_ported():
    """A MoE config takes nanotpu's expert-sharded inference specs and its
    divisibility checks, messages included: nothing is refused (the
    decode paths on a tp2 x ep2 mesh: ``tests/test_torch_ep.py``)."""
    jcfg, tcfg = jmixtral.MixtralConfig.tiny(), tmixtral.MixtralConfig.tiny()
    assert (_spec_tuples(tinfer.infer_param_specs(tcfg))
            == _spec_tuples(jinfer.infer_param_specs(jcfg)))
    assert tinfer.infer_param_specs(tcfg)["layers"][0]["moe"]["w_gate"] == (
        "ep", "fsdp", "tp")
    with pytest.raises(ValueError) as want:
        jinfer.check_infer_divisibility(jcfg, jmake_mesh(
            ep=3, devices=jax.devices()[:3]))
    with pytest.raises(ValueError) as got:
        tinfer.check_infer_divisibility(tcfg, {"ep": 3})
    assert str(got.value) == str(want.value)
    tinfer.check_infer_divisibility(tcfg, {"tp": 2, "ep": 2})


def test_cache_specs_split_the_kv_heads_over_tp():
    from nanotpu_torch.models.generate import KVCache
    from nanotpu_torch.parallel.mesh import P
    from nanotpu_torch.serving.engine import SlotCache8

    cfg = tl_cfg()
    specs = tinfer.slot_cache_specs(cfg, kv_int8=True)
    assert isinstance(specs, SlotCache8)
    assert specs.k[0] == P(None, None, "tp", None) == tinfer.KV_ENTRY_SPEC
    assert specs.k_scale[1] == P(None, None, "tp")
    kv = tinfer.kv_cache_specs(cfg)
    assert isinstance(kv, KVCache) and len(kv.v) == cfg.n_layers
    assert KVCache.create(cfg, 2, 16, device="cpu", tp=2).k[0].shape == (
        2, 16, cfg.n_kv_heads // 2, cfg.head_dim)
