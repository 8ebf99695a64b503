"""nanotpu_torch.models.speculative on the CPU, against nanotpu's.

The cases of tests/test_speculative.py on nanotpu's tiny models (f32),
carried over with params_from_numpy. Greedy output is held exactly: equal to
nanotpu's speculative_generate and to the port's plain greedy generate. The
random streams differ (jax.random against torch.Generator), so sampled
output is held by distribution, with nanotpu's own total-variation bounds
(0.03 for one rejection step over 20000 trials, 0.12 per position for
sampled decoding over ~1.5k rows a side), and against nanotpu's sampled
generate as well as the port's.

Mapping: every nanotpu case has a port below except test_jittable, whose
subject is ``jax.jit`` itself; its inputs (a prompt of ones, K=2) run
eagerly in test_short_prompt_k2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanotpu.models import generate as jg
from nanotpu.models import llama as jl
from nanotpu.models import speculative as js
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.models import generate as tg
from nanotpu_torch.models import llama as tl
from nanotpu_torch.models import speculative as ts

torch.set_num_threads(2)
CFG_J = dataclasses.replace(jl.LlamaConfig.tiny(), max_seq_len=128)
CFG_T = dataclasses.replace(tl.LlamaConfig.tiny(), max_seq_len=128)
DRAFT_J = dataclasses.replace(CFG_J, n_layers=1)
DRAFT_T = dataclasses.replace(CFG_T, n_layers=1)


@pytest.fixture(scope="module")
def models():
    """(jax target, jax draft, port target, port draft)."""
    init = jax.jit(jl.init_params, static_argnums=1)
    target = init(jax.random.PRNGKey(0), CFG_J)
    draft = init(jax.random.PRNGKey(42), DRAFT_J)

    def port(tree):
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                 "cpu")

    return target, draft, port(target), port(draft)


def prompt_of(seed, shape):
    """tests/test_speculative.py's own prompts, drawn as it draws them."""
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                       CFG_J.vocab_size))


def spec(target, draft, prompt, n, cfg=CFG_T, dcfg=DRAFT_T, **kw):
    return ts.speculative_generate(target, draft, torch.as_tensor(prompt), cfg,
                                   dcfg, n, **kw)


@pytest.mark.parametrize("K", [1, 3, 4])
def test_exact_greedy_equivalence_bad_draft(models, K):
    """A random draft still yields the target's exact greedy tokens:
    nanotpu's speculative output and the port's plain greedy output."""
    jt, jd, target, draft = models
    prompt = prompt_of(1, (2, 6))
    want = js.speculative_generate(jt, jd, jnp.asarray(prompt), CFG_J,
                                   DRAFT_J, 12, draft_tokens=K)
    got = spec(target, draft, prompt, 12, draft_tokens=K)
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist() == tg.generate(target, torch.as_tensor(prompt), CFG_T,
                                       12).tolist()


def test_exact_greedy_equivalence_perfect_draft(models):
    _, _, target, _ = models
    prompt = prompt_of(2, (1, 5))
    want = tg.generate(target, torch.as_tensor(prompt), CFG_T, 16)
    got = spec(target, target, prompt, 16, CFG_T, CFG_T, draft_tokens=4)
    assert torch.equal(got, want)


def test_batched_rows_stay_exact(models):
    jt, jd, target, draft = models
    prompt = prompt_of(3, (4, 7))
    want = js.speculative_generate(jt, jd, jnp.asarray(prompt), CFG_J,
                                   DRAFT_J, 10, draft_tokens=3)
    got = spec(target, draft, prompt, 10, draft_tokens=3)
    assert got.tolist() == np.asarray(want).tolist()
    assert torch.equal(got, tg.generate(target, torch.as_tensor(prompt),
                                        CFG_T, 10))


def test_short_prompt_k2(models):
    _, _, target, draft = models
    prompt = torch.ones((1, 4), dtype=torch.long)
    got = spec(target, draft, prompt, 8, draft_tokens=2)
    assert torch.equal(got, tg.generate(target, prompt, CFG_T, 8))


def test_overflow_rejected(models):
    _, _, target, draft = models
    with pytest.raises(ValueError, match="exceeds"):
        spec(target, draft, torch.ones((1, 100), dtype=torch.long), 30,
             draft_tokens=4, max_len=120)


def test_eos_matches_generate(models):
    """Identical tokens before the first eos, eos repeated after: as the
    port's generate and as nanotpu's speculative_generate."""
    jt, jd, target, draft = models
    prompt = prompt_of(5, (2, 6))
    free = tg.generate(target, torch.as_tensor(prompt), CFG_T, 12)
    eos = int(free[0, 4])  # a token greedy actually emits
    want = tg.generate(target, torch.as_tensor(prompt), CFG_T, 12, eos_id=eos)
    got = spec(target, draft, prompt, 12, draft_tokens=3, eos_id=eos)
    assert torch.equal(got, want)
    jax_out = js.speculative_generate(jt, jd, jnp.asarray(prompt), CFG_J,
                                      DRAFT_J, 12, draft_tokens=3, eos_id=eos)
    assert got.tolist() == np.asarray(jax_out).tolist()


def test_full_accept_advances_k_plus_1_per_cycle(models):
    """draft == target accepts everything: each cycle emits K+1 tokens,
    which needs the K-th draft token's cache entry written on full-accept
    cycles (a missing entry would desync the draft and add cycles)."""
    _, _, target, _ = models
    prompt = torch.tensor([[5, 3, 1]])
    _, stats = spec(target, target, prompt, 40, CFG_T, CFG_T, draft_tokens=4,
                    return_stats=True)
    assert stats["cycles"] == 8  # ceil((40 - 1) / (K+1))
    _, stats2 = spec(target, target, prompt, 40, CFG_T, CFG_T, draft_tokens=4,
                     temperature=0.7, return_stats=True,
                     generator=torch.Generator().manual_seed(3))
    assert stats2["accepted"] / stats2["drafted"] > 0.8


class TestRejectionSampling:
    """temperature > 0: the emitted tokens follow the warped target
    distribution."""

    def test_rejection_step_emits_target_distribution(self):
        rng = np.random.default_rng(0)
        V, N = 8, 20000
        p = torch.from_numpy(rng.dirichlet(np.ones(V)).astype(np.float32))
        q = torch.from_numpy(rng.dirichlet(np.ones(V) * 0.5).astype(np.float32))
        gen = torch.Generator().manual_seed(7)
        drafts = torch.multinomial(q, N, replacement=True,
                                   generator=gen)[:, None]
        accepted, resampled = ts.rejection_step(
            p.expand(N, 1, V), q.expand(N, 1, V), drafts, gen)
        emitted = torch.where(accepted[:, 0], drafts[:, 0], resampled[:, 0])
        freq = torch.bincount(emitted, minlength=V).float() / N
        tv = 0.5 * (freq - p).abs().sum().item()
        assert tv < 0.03, (tv, freq, p)

    def test_residual_never_draws_a_zero_probability_token(self):
        """Where p puts no mass the residual has none: across many rows no
        draw lands there (log 0 = -inf, not a clamped tiny value)."""
        p = torch.tensor([0.0, 0.5, 0.5, 0.0])
        q = torch.tensor([0.25, 0.25, 0.25, 0.25])
        gen = torch.Generator().manual_seed(1)
        drafts = torch.zeros((4096, 1), dtype=torch.long)
        accepted, resampled = ts.rejection_step(
            p.expand(4096, 1, 4), q.expand(4096, 1, 4), drafts, gen)
        assert not accepted.any()  # p(0) = 0: token 0 is always rejected
        assert set(resampled.unique().tolist()) <= {1, 2}

    def test_a_zero_uniform_draws_no_zero_probability_token(self,
                                                             monkeypatch):
        """torch.rand may return exactly 0, whose Gumbel noise would be -inf
        and let a probability-0 token (log -inf) win the argmax; the draw
        starts at the smallest normal float, as jax.random's does."""
        monkeypatch.setattr(torch, "rand", lambda shape, **kw: torch.zeros(
            shape))
        logp = torch.log(torch.tensor([[0.0, 0.0, 1.0, 0.0],
                                       [0.0, 0.3, 0.0, 0.7]]))
        assert tg.sample_categorical(logp, None).tolist() == [2, 3]

    def test_sampled_output_matches_generate_distribution(self, models):
        """Per-position marginals of sampled speculative decoding against
        plain sampled generate at T=0.8, the port's and nanotpu's, with
        sharpened heads (a near-uniform 256-way distribution would put the
        empirical TV's noise floor above any useful bound): 64-row batches
        x 24 seeds a side."""
        jt, _, target, draft = models
        target = {**target, "lm_head": target["lm_head"] * 25.0}
        draft = {**draft, "lm_head": draft["lm_head"] * 25.0}
        jt = {**jt, "lm_head": jt["lm_head"] * 25.0}
        B, T, n_seeds = 64, 0.8, 24
        prompt = torch.tensor([[3, 1, 4, 1, 5]]).repeat(B, 1)
        spec_out = torch.cat([
            spec(target, draft, prompt, 3, draft_tokens=3, temperature=T,
                 generator=torch.Generator().manual_seed(i))
            for i in range(n_seeds)])
        plain_out = torch.cat([
            tg.generate(target, prompt, CFG_T, 3, temperature=T,
                        generator=torch.Generator().manual_seed(10_000 + i))
            for i in range(n_seeds)])
        jax_plain = jax.jit(lambda r: jg.generate(
            jt, jnp.asarray(prompt.numpy()), CFG_J, 3, temperature=T, rng=r))
        jax_out = np.concatenate([np.asarray(jax_plain(jax.random.PRNGKey(i)))
                                  for i in range(n_seeds)])
        V = CFG_T.vocab_size
        for pos in range(3):
            f_spec = np.bincount(spec_out[:, pos].numpy(), minlength=V)
            f_spec = f_spec / len(spec_out)
            for other in (plain_out[:, pos].numpy(), jax_out[:, pos]):
                f_other = np.bincount(other, minlength=V) / len(other)
                tv = 0.5 * np.abs(f_spec - f_other).sum()
                assert tv < 0.12, (pos, tv)

    def test_acceptance_stats_and_perfect_draft_accepts_all(self, models):
        _, _, target, _ = models
        out, stats = spec(target, target, torch.tensor([[2, 7, 2]]), 12,
                          CFG_T, CFG_T, draft_tokens=4, temperature=0.8,
                          generator=torch.Generator().manual_seed(5),
                          return_stats=True)
        assert out.shape == (1, 12)
        assert 0 < stats["accepted"] <= stats["drafted"]
        # draft == target: min(1, p/q) = 1, so every proposal is accepted
        assert stats["accepted"] == stats["drafted"], stats

    def test_sampled_respects_top_k_support(self, models):
        """top_k=1 collapses both distributions to greedy: the sampled
        output equals the greedy run exactly."""
        _, _, target, draft = models
        prompt = torch.tensor([[1, 2, 3, 4]])
        want = tg.generate(target, prompt, CFG_T, 10)
        got = spec(target, draft, prompt, 10, draft_tokens=3, temperature=0.7,
                   top_k=1, generator=torch.Generator().manual_seed(9))
        assert torch.equal(got, want)
