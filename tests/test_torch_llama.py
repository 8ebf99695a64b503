"""nanotpu_torch Llama forward against nanotpu's, on LlamaConfig.tiny() in
float32 with the JAX parameters carried over by params_from_numpy.

Tolerance: atol 1e-4 on logits (float32; two frameworks' matmul and
reduction orders across 2 layers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanotpu.models import llama as jl
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.models import llama as tl

torch.set_num_threads(2)
ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    return jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jl.LlamaConfig.tiny()
    )


def port(params):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


def test_config_mirrors_nanotpu():
    j, t = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.head_dim == t.head_dim
    assert [f.name for f in dataclasses.fields(jl.LlamaConfig)] == [
        f.name for f in dataclasses.fields(tl.LlamaConfig)
    ]


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_forward_logits_match_jax(jax_params, attn_impl):
    cfg_j = dataclasses.replace(jl.LlamaConfig.tiny(), attn_impl=attn_impl)
    cfg_t = dataclasses.replace(tl.LlamaConfig.tiny(), attn_impl=attn_impl)
    tokens = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (2, 19))
    want = np.asarray(jax.jit(jl.forward, static_argnums=2)(
        jax_params, jnp.asarray(tokens), cfg_j
    ))
    got = tl.forward(port(jax_params), torch.from_numpy(tokens), cfg_t)
    assert got.dtype == torch.float32 and got.shape == (2, 19, cfg_t.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_rope_with_per_row_positions_matches_jax():
    """The engine feeds [B, S] positions; cos/sin and the rotation agree
    with nanotpu's (atol 1e-5: f32 transcendental rounding)."""
    cfg = tl.LlamaConfig.tiny()
    pos = np.array([[0, 1, 2], [7, 8, 9]], np.int32)
    x = np.random.default_rng(1).standard_normal((2, 3, 4, 16), np.float32)
    jc, js = jl.rope_freqs(jl.LlamaConfig.tiny(), jnp.asarray(pos))
    tc, ts = tl.rope_freqs(cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    want = jl.apply_rope(jnp.asarray(x), jc, js)
    got = tl.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_rms_norm_accumulates_in_f32_and_keeps_dtype():
    x = np.random.default_rng(2).standard_normal((3, 64), np.float32)
    w = np.linspace(0.5, 1.5, 64, dtype=np.float32)
    want = jl.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), 1e-5)
    got = tl.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), 1e-5)
    assert got.dtype == torch.bfloat16
    # both round an f32 result to bf16 once: equal to one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7)


def test_params_from_numpy_carries_bf16_bits(jax_params):
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype="bfloat16")
    p16 = jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(3), cfg)
    tree = port(p16)
    wq = np.asarray(p16["layers"][1]["attn"]["wq"])
    assert wq.dtype.name == "bfloat16"
    got = tree["layers"][1]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), wq.astype(np.float32))
    assert tree["final_norm"].dtype == torch.float32
    cast = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_params), "cpu", torch.bfloat16
    )
    assert cast["embed"].dtype == torch.bfloat16


def test_init_params_same_tree_and_scales(jax_params):
    cfg = tl.LlamaConfig.tiny()
    ours = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    theirs = port(jax_params)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from flat(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    a, b = dict(flat(ours)), dict(flat(theirs))
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].shape == b[name].shape, name
        assert a[name].dtype == b[name].dtype, name
        # same truncated-normal scale (different random streams): the std
        # of ~4k+ draws agrees within 10%
        sa, sb = a[name].std().item(), b[name].std().item()
        assert abs(sa - sb) <= 0.1 * max(sb, 1e-12), (name, sa, sb)
    again = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["embed"], ours["embed"])
