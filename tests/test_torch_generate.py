"""nanotpu_torch KV-cache decoding against nanotpu's, on LlamaConfig.tiny()
in float32 with the JAX parameters carried over.

Greedy tokens must be exactly equal; logits agree to atol 1e-4 (float32);
the top-k / top-p masks must be equal on shared logits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanotpu.models import generate as jg
from nanotpu.models import llama as jl
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.models import generate as tg
from nanotpu_torch.models import llama as tl

torch.set_num_threads(2)
# jitted: op-by-op JAX on the CPU costs seconds per call at this size
jax_generate = jax.jit(jg.generate, static_argnums=(2, 3),
                       static_argnames=("eos_id",))
jax_prefill = jax.jit(jg.prefill, static_argnums=(2, 3))
jax_decode_step = jax.jit(jg.decode_step, static_argnums=(2,))


@pytest.fixture(scope="module")
def models():
    params = jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jl.LlamaConfig.tiny()
    )
    tparams = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu"
    )
    return params, tparams


def cfgs(attn_impl):
    return (dataclasses.replace(jl.LlamaConfig.tiny(), attn_impl=attn_impl),
            dataclasses.replace(tl.LlamaConfig.tiny(), attn_impl=attn_impl))


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_greedy_generate_equals_jax(models, attn_impl):
    params, tparams = models
    cfg_j, cfg_t = cfgs(attn_impl)
    prompt = np.random.default_rng(0).integers(0, 256, (2, 9))
    want = np.asarray(jax_generate(params, jnp.asarray(prompt), cfg_j, 14))
    got = tg.generate(tparams, torch.from_numpy(prompt), cfg_t, 14)
    assert got.tolist() == want.tolist()


def test_eos_semantics_equal_jax(models):
    params, tparams = models
    cfg_j, cfg_t = cfgs("flash")
    prompt = np.random.default_rng(1).integers(0, 256, (2, 5))
    probe = np.asarray(jax_generate(params, jnp.asarray(prompt), cfg_j, 10))
    eos = int(probe[0, 3])  # row 0 stops at its 4th token
    want = np.asarray(
        jax_generate(params, jnp.asarray(prompt), cfg_j, 10, eos_id=eos)
    )
    got = tg.generate(tparams, torch.from_numpy(prompt), cfg_t, 10,
                      eos_id=eos)
    assert got.tolist() == want.tolist()
    assert (got[0, 3:] == eos).all()


def test_prefill_and_decode_logits_match_jax(models):
    params, tparams = models
    cfg_j, cfg_t = cfgs("flash")
    prompt = np.random.default_rng(2).integers(0, 256, (2, 7))
    jlog, jcache = jax_prefill(params, jnp.asarray(prompt), cfg_j, 12)
    with torch.inference_mode():
        tlog, tcache = tg.prefill(tparams, torch.from_numpy(prompt), cfg_t,
                                  max_len=12)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
        assert tcache.length == int(jcache.length) == 7
        for kt, kj in zip(tcache.k, jcache.k):
            np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-5)
        tok = np.array([3, 200])
        jlog, _ = jax_decode_step(params, jnp.asarray(tok), cfg_j, jcache)
        tlog, tcache = tg.decode_step(tparams, torch.from_numpy(tok), cfg_t,
                                      tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
        assert tcache.length == 8


@pytest.mark.parametrize("k", [1, 5, 37])
def test_top_k_mask_equals_jax(k):
    logits = np.random.default_rng(k).standard_normal((4, 50), np.float32)
    want = np.asarray(jg.apply_top_k(jnp.asarray(logits), k))
    got = tg.apply_top_k(torch.from_numpy(logits), k).numpy()
    np.testing.assert_array_equal(got == tg.NEG_INF, want == jg.NEG_INF)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.0, 0.3, 0.9, 1.5])
def test_top_p_mask_equals_jax_and_keeps_top_token(p):
    logits = np.random.default_rng(7).standard_normal((4, 50), np.float32) * 3
    want = np.asarray(jg.apply_top_p(jnp.asarray(logits), p))
    got = tg.apply_top_p(torch.from_numpy(logits), p).numpy()
    np.testing.assert_array_equal(got == tg.NEG_INF, want == jg.NEG_INF)
    top = logits.argmax(-1)
    assert (got[np.arange(4), top] == logits[np.arange(4), top]).all()


def test_sampled_generate_follows_the_warped_distribution():
    """Gumbel-max draws from a seeded generator follow softmax of the
    warped logits: total variation under 0.03 over 20000 draws."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
    warped = tg.warp_logits(logits.expand(20000, 6), 0.8, top_k=4)
    gen = torch.Generator().manual_seed(0)
    draws = tg.sample_categorical(warped, gen)
    freq = torch.bincount(draws, minlength=6).float() / 20000
    want = torch.softmax(tg.warp_logits(logits, 0.8, top_k=4), -1)[0]
    assert freq[4:].sum() == 0  # masked by top-k
    assert 0.5 * (freq - want).abs().sum() < 0.03


def test_generate_rejects_overlong(models):
    _, tparams = models
    with pytest.raises(ValueError, match="exceeds max_len"):
        tg.generate(tparams, torch.zeros((1, 5), dtype=torch.long),
                    tl.LlamaConfig.tiny(), 10, max_len=12)
