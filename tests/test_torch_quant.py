"""nanotpu_torch.models.quant on the CPU, against nanotpu's quant.

The cases of tests/test_quant.py, each also held against nanotpu where it
has a value to compare: the same weights quantize to the same int8 values
and the same scales bit for bit (both divide in f32 and round half to
even); quantized matmuls and logits agree to 1e-5 / 1e-4 (f32, summation
order); greedy tokens of the quantized model are equal.

Mapping of nanotpu's cases: test_roundtrip_error_bound,
test_matmul_matches_dequant_matmul, test_quantize_params_structure (less
its jit closure, which has no eager counterpart), test_quantized_forward_close,
test_quantized_generation_runs_and_tracks_full,
test_quantized_decode_matches_quantized_forward and
test_quantized_params_checkpoint_roundtrip (torch.save with
weights_only=True in place of orbax) have ports below;
test_mixtral_quantized_forward_and_decode has its port in
tests/test_torch_mixtral.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanotpu.models import generate as jg
from nanotpu.models import llama as jl
from nanotpu.models import quant as jq
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.models import generate as tg
from nanotpu_torch.models import llama as tl
from nanotpu_torch.models import quant as tq
from nanotpu_torch.tree import leaves

torch.set_num_threads(2)
CFG_J = dataclasses.replace(jl.LlamaConfig.tiny(), max_seq_len=128)
CFG_T = dataclasses.replace(tl.LlamaConfig.tiny(), max_seq_len=128)


@pytest.fixture(scope="module")
def models():
    """(jax params, jax quantized params, port params, port quantized
    params): the port's trees carried over from the JAX ones."""
    params = jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                       CFG_J)
    qparams = jq.quantize_params(params)

    def port(tree):
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                 "cpu")

    return params, qparams, port(params), port(qparams)


def tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG_T.vocab_size, shape)


def jax_tokens(seed, shape):
    """tests/test_quant.py's own inputs, drawn as it draws them."""
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                       CFG_J.vocab_size))


@pytest.mark.parametrize("shape,dtype", [
    ((64, 128), "float32"), ((3, 32, 48), "float32"), ((128, 64), "bfloat16"),
])
def test_quantize_matches_jax_bit_for_bit(shape, dtype):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    w[0, 0] = 0.0
    wj = jnp.asarray(w, jnp.dtype(dtype))
    want = jq.quantize(wj)
    got = tq.quantize(params_from_numpy(np.asarray(wj), "cpu"))
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    assert got.s.shape == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))


def test_roundtrip_error_bound():
    w = torch.from_numpy(
        np.random.default_rng(1).standard_normal((64, 128)).astype(np.float32))
    back = tq.dequantize(tq.quantize(w), torch.float32)
    # symmetric int8: error <= scale/2 per element; scale = amax/127
    amax = w.abs().amax(dim=0, keepdim=True)
    assert torch.all((back - w).abs() <= amax / 127.0)


def test_matmul_matches_dequant_matmul_and_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    q = tq.quantize(torch.from_numpy(w))
    got = tq.matmul(torch.from_numpy(x), q)
    want = torch.from_numpy(x) @ tq.dequantize(q, torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    jax_out = jq.matmul(jnp.asarray(x), jq.quantize(jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=1e-5,
                               atol=1e-5)


def test_embedding_lookup_matches_jax(models):
    _, qparams, _, tqparams = models
    ids = tokens(3, (2, 7))
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        want = jq.embedding_lookup(qparams["embed"], jnp.asarray(ids), dt_j)
        got = tq.embedding_lookup(tqparams["embed"], torch.from_numpy(ids),
                                  dt_t)
        assert got.dtype == dt_t
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_quantize_params_structure(models):
    params, qparams, tparams, _ = models
    qp = tq.quantize_params(tparams)
    assert isinstance(qp["layers"][0]["attn"]["wq"], tq.QArray)
    assert isinstance(qp["embed"], tq.QArray)
    assert isinstance(qp["lm_head"], tq.QArray)
    assert qp["layers"][0]["attn_norm"].dtype == torch.float32
    assert not isinstance(qp["final_norm"], tq.QArray)
    assert qp["lm_head"].shape == tparams["lm_head"].shape
    assert qp["lm_head"].dtype == torch.bfloat16
    # ~4x smaller for f32 source weights (int8 + tiny scales + f32 norms)
    assert tq.param_bytes(qp) < 0.3 * tq.param_bytes(tparams)
    assert tq.param_bytes(qp) == jq.param_bytes(qparams)
    assert tq.param_bytes(tparams) == jq.param_bytes(params)
    assert any(leaf.dtype == torch.int8 for leaf in leaves(qp))
    # the router of a MoE tree stays unquantized
    tree = {"router": torch.ones((4, 8)), "w": torch.ones((4, 8))}
    out = tq.quantize_params(tree)
    assert not isinstance(out["router"], tq.QArray)
    assert isinstance(out["w"], tq.QArray)


def test_params_from_numpy_carries_nanotpu_qarrays(models):
    """nanotpu's QArray leaves, recognised by their fields, become the
    port's, equal to the port's own quantization of the same weights."""
    _, _, tparams, tqparams = models
    assert isinstance(tqparams["layers"][1]["mlp"]["w_down"], tq.QArray)
    ours = tq.quantize_params(tparams)
    for a, b in zip(leaves(tqparams), leaves(ours)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_quantized_forward_matches_jax_and_stays_close(models):
    params, qparams, tparams, tqparams = models
    ids = jax_tokens(4, (2, 16))
    want = jl.forward(qparams, jnp.asarray(ids), CFG_J)
    with torch.inference_mode():
        got = tl.forward(tqparams, torch.from_numpy(ids), CFG_T)
        full = tl.forward(tparams, torch.from_numpy(ids), CFG_T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # logits drift a little; the softmax ranking should not
    tv = 0.5 * (torch.softmax(full, -1) - torch.softmax(got, -1)).abs().sum(
        -1).mean()
    assert float(tv) < 0.05, f"total variation {float(tv)}"


def test_quantized_generation_equals_jax_and_tracks_full(models):
    params, qparams, tparams, tqparams = models
    prompt = jax_tokens(5, (2, 8))
    want = jg.generate(qparams, jnp.asarray(prompt), CFG_J, 12)
    got = tg.generate(tqparams, torch.from_numpy(prompt), CFG_T, 12)
    full = tg.generate(tparams, torch.from_numpy(prompt), CFG_T, 12)
    assert got.tolist() == np.asarray(want).tolist()
    agree = float((got == full).float().mean())
    assert agree >= 0.75, f"only {agree:.0%} of greedy tokens agree"


def test_quantized_decode_matches_quantized_forward(models):
    """The cache path and the full forward agree on the same quantized
    params (quantization does not break cache equivalence)."""
    _, _, _, tqparams = models
    prompt = torch.from_numpy(jax_tokens(6, (1, 12)))
    with torch.inference_mode():
        full_logits = tl.forward(tqparams, prompt, CFG_T)
        pre_logits, _ = tg.prefill(tqparams, prompt, CFG_T, max_len=16)
    torch.testing.assert_close(pre_logits, full_logits[:, -1], rtol=2e-4,
                               atol=2e-4)


def test_quantized_params_checkpoint_roundtrip(tmp_path, models):
    """A quantized tree survives torch.save / torch.load(weights_only=True)
    exactly, structure included, and still generates the same tokens."""
    _, _, _, tqparams = models
    path = str(tmp_path / "params.pt")
    tq.save_params(path, tqparams)
    back = tq.load_params(path, "cpu")
    assert isinstance(back["embed"], tq.QArray)
    assert isinstance(back["layers"][0]["mlp"]["w_gate"], tq.QArray)
    a, b = leaves(tqparams), leaves(back)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    prompt = torch.from_numpy(jax_tokens(8, (1, 6)))
    assert torch.equal(tg.generate(back, prompt, CFG_T, 6),
                       tg.generate(tqparams, prompt, CFG_T, 6))
