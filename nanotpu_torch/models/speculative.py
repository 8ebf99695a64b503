"""Speculative decoding: a small draft model proposes K tokens per cycle and
the target verifies all of them in ONE forward. The port of
``nanotpu/models/speculative.py``.

Greedy (``temperature=0``) is output-equivalent to plain greedy decoding on
the target: a cycle accepts the longest prefix of proposals that match the
target's own greedy choices, then takes the target's token at the first
mismatch, so every emitted token is the target's greedy token. In bf16 the
verify forward runs the same positions at another matmul shape (S=K+1
instead of S=1), so near-tie logits can argmax differently than
step-by-step decoding; exactness is held in f32.

Sampled (``temperature>0``) is Leviathan et al.'s rejection sampling:
accept a proposal x~q with probability min(1, p(x)/q(x)), else draw from
the residual norm(max(p - q, 0)); every emitted token is distributed as the
warped target distribution p, whatever the draft.

The cycle loop is a Python loop. The caches' lengths are host integers, so
each cycle reads the shared acceptance ``a`` (the minimum over rows) from
the device once; everything else stays there. Rollback is free: a cache's
``length`` is the only truth, and stale entries past it are overwritten by
the next cycle's writes.

``mesh=`` speculates over a tp x fsdp mesh: both trees placed by
:func:`nanotpu_torch.parallel.infer.place_params`, the draft on the
target's mesh, whose tied embedding and head are then the target's local
shards, not copies.
"""

from __future__ import annotations

import torch

from nanotpu_torch.models.generate import (
    _run,
    prefill,
    sample_categorical,
    warp_logits,
)


def _warp(logits, temperature: float, top_k: int, top_p: float):
    """generate()'s warp chain as probabilities: the acceptance test compares
    the same warped distributions on both sides, and the emitted
    distribution is the one generate() samples."""
    return torch.softmax(
        warp_logits(logits, temperature, top_k, top_p).float(), dim=-1)


def sample_probs(probs: torch.Tensor, generator) -> torch.Tensor:
    """One draw per row from ``probs`` (last axis); a token of probability
    exactly 0 has log -inf and is never drawn."""
    return sample_categorical(torch.log(probs), generator)


def rejection_step(p_probs, q_probs, drafts, generator):
    """One batched rejection-sampling decision per (row, position).

    p_probs/q_probs: [B, K, V] warped target/draft distributions; drafts:
    [B, K] tokens sampled from q. Returns (accepted [B, K] bool, resampled
    [B, K] tokens from the residual norm(max(p - q, 0))); a numerically
    all-zero residual (p ~= q) falls back to p itself."""
    B, K, _ = p_probs.shape
    idx = drafts[..., None].long()
    p_x = p_probs.gather(-1, idx)[..., 0]
    q_x = q_probs.gather(-1, idx)[..., 0]
    u = torch.rand((B, K), generator=generator, device=p_probs.device)
    accepted = u * q_x < p_x  # u < p/q without the division
    residual = torch.clamp(p_probs - q_probs, min=0.0)
    mass = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(mass > 0, residual / torch.clamp(mass, min=1e-20),
                           p_probs)
    return accepted, sample_probs(residual, generator)


def _accepted_prefix(flags: torch.Tensor) -> torch.Tensor:
    """[B, K] bool -> [B] length of each row's leading run of True."""
    return torch.cumprod(flags.long(), dim=1).sum(dim=1)


@torch.inference_mode()
def speculative_generate(
    params, draft_params, prompt: torch.Tensor, cfg, draft_cfg,
    max_new_tokens: int, draft_tokens: int = 4, max_len: int | None = None,
    eos_id: int = -1, temperature: float = 0.0, top_k: int = 0,
    top_p: float = 1.0, generator: torch.Generator | None = None,
    return_stats: bool = False, mesh=None,
):
    """``max_new_tokens`` tokens from the target ``params``, proposed by
    ``draft_params``: [B, max_new_tokens], or ``(tokens, stats)`` with
    ``return_stats`` (stats = {accepted, drafted, cycles}).

    Rows advance by the MINIMUM acceptance across rows; rows that matched
    further re-verify those tokens next cycle (greedy re-emits them, and a
    sampled row draws fresh valid samples of p). ``draft_tokens`` is K.
    ``mesh`` as for :func:`~nanotpu_torch.models.generate.generate`, with
    both trees placed on it."""
    B, S = prompt.shape
    K, N = draft_tokens, max_new_tokens
    # the last cycle enters at cache length <= S+N-2 and writes K+1
    # entries, so capacity S+N+K-1 suffices
    need = S + N + K - 1
    max_len = max_len or min(cfg.max_seq_len, need)
    if need > max_len:
        raise ValueError(
            f"prompt {S} + new {N} + speculation overshoot {K - 1} exceeds "
            f"max_len {max_len}"
        )
    sampled = temperature > 0.0

    def warp(logits):
        return _warp(logits, temperature, top_k, top_p)

    shard = dshard = None
    if mesh is not None:
        from nanotpu_torch.parallel.infer import on_mesh

        tied: dict = {}
        params, shard = on_mesh(params, cfg, mesh, tied)
        draft_params, dshard = on_mesh(draft_params, draft_cfg, mesh, tied)
    # the draft's prefill only primes its cache (head=False)
    t_logits, t_cache = prefill(params, prompt, cfg, max_len, shard=shard)
    _, d_cache = prefill(draft_params, prompt, draft_cfg, max_len, head=False,
                         shard=dshard)
    if sampled:
        cur = sample_probs(warp(t_logits), generator)
    else:
        cur = torch.argmax(t_logits, dim=-1)  # [B]
    # emit buffer padded by K+1 so the last cycle's full write fits
    out = torch.zeros((B, N + K + 1), dtype=torch.long, device=prompt.device)
    out[:, 0] = cur
    n, acc, cyc = 1, 0, 0
    while n < N:
        t_base, d_base = t_cache.length, d_cache.length
        tok, drafts, qs = cur, [], []
        for _ in range(K):
            logits, d_cache = _run(draft_params, tok[:, None], draft_cfg,
                                   d_cache, shard=dshard)
            if sampled:
                qs.append(warp(logits))
                tok = sample_probs(qs[-1], generator)
            else:
                tok = torch.argmax(logits, dim=-1)
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)  # [B, K]: d1..dK
        v_logits, t_cache = _run(
            params, torch.cat([cur[:, None], drafts], dim=1), cfg, t_cache,
            logits_at=slice(None), shard=shard,
        )  # [B, K+1, V]
        if sampled:
            p_all = warp(v_logits)
            accepted, resampled = rejection_step(
                p_all[:, :K], torch.stack(qs, dim=1), drafts, generator)
            a_rows = _accepted_prefix(accepted)
            # every row accepted all K -> a bonus draw from the target's
            # K+1-th distribution (nothing was rejected there)
            bonus = sample_probs(p_all[:, K], generator)
            a = int(a_rows.min())  # the cycle's one host read
            pad = torch.cat([drafts, drafts[:, -1:]], dim=1)  # [B, K+1]
            fallback = bonus if a == K else resampled[:, a]
            # a row that accepted further emits its draft at position a
            cur = torch.where(a_rows > a, pad[:, a], fallback)
            emit = pad.clone()
            emit[:, a] = cur
        else:
            emit = torch.argmax(v_logits, dim=-1)  # [B, K+1]
            a = int(_accepted_prefix(drafts == emit[:, :K]).min())
            cur = emit[:, a]
        # positions past a are rewritten by later cycles before any read
        out[:, n:n + K + 1] = emit
        n += a + 1
        if a == K and n < N:
            # the next cycle starts from the bonus token, whose draft
            # context includes d_K, which the K steps never fed
            _, d_cache = _run(draft_params, drafts[:, -1:], draft_cfg,
                              d_cache, head=False, shard=dshard)
        t_cache = t_cache._replace(length=t_base + a + 1)
        d_cache = d_cache._replace(length=d_base + a + 1)
        acc += a
        cyc += 1
    out = out[:, :N]
    if eos_id >= 0:
        # the first eos lands where generate() stops; mask what follows it
        is_eos = (out == eos_id).long()
        after_first = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
        out = torch.where(after_first, eos_id, out)
    if return_stats:
        return out, {"accepted": acc, "drafted": cyc * K, "cycles": cyc}
    return out
