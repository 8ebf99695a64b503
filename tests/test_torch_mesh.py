"""nanotpu_torch's mesh module against nanotpu's: the spec trees, the
checks and their messages, DTensor placements from specs, and
``make_hybrid_mesh`` over a group of one (its cases over four processes
are in ``tests/test_torch_ring.py``)."""

import contextlib
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from nanotpu.models import mixtral as jmix
from nanotpu.models.llama import LlamaConfig as JCfg
from nanotpu.parallel import mesh as jmesh
from nanotpu_torch.models.llama import LlamaConfig as TCfg
from nanotpu_torch.models.mixtral import MixtralConfig as TMixCfg
from nanotpu_torch.parallel import mesh as tmesh

R = Replicate()


def _as_tuples(tree):
    """A spec tree with every spec as a plain tuple of its entries."""
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tuples(v) for v in tree]
    return tuple(tree)


def _fake_mesh(**sizes):
    """What the checks and placements read of a DeviceMesh: its axis names
    and shape."""
    shape = tuple(sizes.get(a, 1) for a in tmesh.AXES)
    return types.SimpleNamespace(mesh_dim_names=tmesh.AXES,
                                 mesh=np.zeros(shape))


def test_llama_specs_equal_nanotpus():
    for cfg in (JCfg.tiny(), JCfg()):
        want = _as_tuples(jmesh.llama_param_specs(cfg))
        assert _as_tuples(tmesh.llama_param_specs(cfg)) == want


def test_mixtral_specs_equal_nanotpus():
    jcfg, tcfg = jmix.MixtralConfig.tiny(), TMixCfg.tiny()
    assert _as_tuples(tmesh.mixtral_param_specs(tcfg)) == _as_tuples(
        jmesh.mixtral_param_specs(jcfg))


def test_batch_and_qarray_scale_specs_equal_nanotpus():
    assert tuple(tmesh.BATCH_SPEC) == tuple(jmesh.BATCH_SPEC)
    for spec in (("fsdp", "tp"), ("tp", "fsdp"), ("ep", "fsdp", "tp"), ()):
        for ndim in (2, 3):
            if len(spec) > ndim:
                continue
            assert tuple(tmesh.qarray_scale_spec(tmesh.P(*spec), ndim)) == \
                tuple(jmesh.qarray_scale_spec(jax.sharding.PartitionSpec(*spec),
                                              ndim))


@pytest.mark.parametrize("sizes", [dict(dp=3), dict(tp=2, sp=2), dict()])
def test_mesh_size_error_equals_nanotpus(sizes):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(devices=jax.devices()[:5], **sizes)
    assert tmesh.mesh_size_error(world=5, **sizes) == str(want.value)
    n = int(np.prod(list(sizes.values()) or [1]))
    assert tmesh.mesh_size_error(world=n, **sizes) is None


@pytest.mark.parametrize("tp", [3, 5])
def test_check_divisibility_equals_nanotpus(tp):
    cfg = JCfg(vocab_size=128, dim=64, n_layers=1, n_heads=6, n_kv_heads=3,
               ffn_dim=96)
    with pytest.raises(ValueError) as want:
        jmesh.check_divisibility(cfg, jmesh.make_mesh(
            tp=tp, devices=jax.devices()[:tp]))
    with pytest.raises(ValueError) as got:
        tmesh.check_divisibility(cfg, _fake_mesh(tp=tp))
    assert str(got.value) == str(want.value)


def test_check_moe_divisibility_equals_nanotpus():
    cfg = jmix.MixtralConfig.tiny()  # 4 experts
    with pytest.raises(ValueError) as want:
        jmesh.check_moe_divisibility(cfg, jmesh.make_mesh(
            ep=3, devices=jax.devices()[:3]))
    with pytest.raises(ValueError) as got:
        tmesh.check_moe_divisibility(cfg, _fake_mesh(ep=3))
    assert str(got.value) == str(want.value)
    tmesh.check_moe_divisibility(cfg, _fake_mesh(ep=2, tp=2))


@pytest.mark.parametrize("spec,ndim,want", [
    (tmesh.P("fsdp", "tp"), 2, [R, R, Shard(0), Shard(1), R, R]),
    (tmesh.P("tp", "fsdp"), 2, [R, R, Shard(1), Shard(0), R, R]),
    (tmesh.BATCH_SPEC, 2, [Shard(0), R, Shard(0), R, R, R]),
    (tmesh.P(None, "sp"), 4, [R, R, R, R, Shard(1), R]),
    (tmesh.P("ep", "fsdp", "tp"), 3, [R, R, Shard(1), Shard(2), R, Shard(0)]),
    (tmesh.P(), 1, [R] * 6),
])
def test_placements_follow_the_spec(spec, ndim, want):
    assert tmesh.placements_for(_fake_mesh(), spec, ndim) == want


@pytest.mark.parametrize("spec,ndim", [
    (tmesh.P(("fsdp", "dp")), 2),  # out of the mesh's order
    (tmesh.P("tp", "tp"), 2),  # one axis twice
    (tmesh.P("dp", None, "tp"), 2),  # more entries than dims
])
def test_placements_refuse_what_dtensor_cannot_hold(spec, ndim):
    with pytest.raises(ValueError):
        tmesh.placements_for(_fake_mesh(), spec, ndim)


def test_spec_leaves_follow_the_parameter_tree():
    """Specs pair with parameters by key, not by each tree's dict order:
    a tree whose dicts are sorted (as a converted JAX tree is) gets the
    spec of each of its own leaves."""
    cfg = TCfg.tiny()
    specs = tmesh.llama_param_specs(cfg)
    tree = {"embed": 0, "final_norm": 1, "layers": [
        {"attn": {"wk": 2, "wo": 3, "wq": 4, "wv": 5}, "attn_norm": 6,
         "mlp": {"w_down": 7, "w_gate": 8, "w_up": 9}, "mlp_norm": 10}] * 2,
        "lm_head": 11}
    got = tmesh.spec_leaves(specs, tree)
    assert got[:6] == [("tp", "fsdp"), (), ("fsdp", "tp"), ("tp", "fsdp"),
                       ("fsdp", "tp"), ("fsdp", "tp")]
    assert got[-1] == ("fsdp", "tp") and len(got) == 3 + 2 * 9


def test_make_mesh_over_a_group_of_one(tmp_path):
    """make_mesh over a joined group of one process: every axis of size 1,
    nanotpu's error past the world size, and no mesh without a group."""
    with pytest.raises(RuntimeError, match="joined process group"):
        tmesh.make_mesh()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = tmesh.make_mesh()
        assert mesh.mesh_dim_names == tmesh.AXES
        assert tmesh.axis_sizes(mesh) == dict.fromkeys(tmesh.AXES, 1)
        assert mesh.device_type == "cpu"
        with pytest.raises(ValueError, match=r"mesh 1x1x1x2x1x1 needs 2 "
                                             r"devices, have 1"):
            tmesh.make_mesh(tp=2)
        shards = tmesh.Shards(mesh, tmesh.llama_param_specs(TCfg.tiny()))
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(shards.use(x, tmesh.P("fsdp")), x)
        assert torch.equal(shards.tp_out(x), x)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _group_of_one(where):
    dist.init_process_group("gloo", init_method=f"file://{where}/rdv",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_hybrid_mesh_over_one_process_is_the_plain_mesh(tmp_path,
                                                        monkeypatch):
    """One process is one slice: ``dcn_dp`` 0 (found) or 1 (given) gives
    ``make_mesh``'s mesh, as nanotpu's one-slice fallback does."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="joined process group"):
        tmesh.make_hybrid_mesh()
    with _group_of_one(tmp_path):
        plain = tmesh.make_mesh()
        for dcn_dp in (0, 1):
            mesh = tmesh.make_hybrid_mesh(dcn_dp=dcn_dp)
            assert mesh.mesh_dim_names == plain.mesh_dim_names
            assert torch.equal(mesh.mesh, plain.mesh)
            assert mesh.device_type == "cpu"


def test_hybrid_mesh_mismatch_message_is_nanotpus(tmp_path):
    with pytest.raises(ValueError) as want:
        jmesh.make_hybrid_mesh(dcn_dp=2, devices=jax.devices()[:1])
    with _group_of_one(tmp_path), pytest.raises(ValueError) as got:
        tmesh.make_hybrid_mesh(dcn_dp=2)
    assert str(got.value) == str(want.value)


def test_default_slice_is_the_host(tmp_path, monkeypatch):
    """A rank's slice is its host: ``rank // LOCAL_WORLD_SIZE`` when
    torchrun sets it; a gloo group without it is one host."""
    with _group_of_one(tmp_path):
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
        assert [tmesh.host_of_rank()(r) for r in range(4)] == [0, 0, 0, 0]
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        assert [tmesh.host_of_rank()(r) for r in range(4)] == [0, 0, 1, 1]
