"""Continuous-batching serving engine over the KV-cache decode path: the
plain-decode port of ``nanotpu/serving/engine.py``.

* **Slot-based batch.** The cache is [SLOTS, max_len] per layer, allocated
  once. A request is admitted into a free slot at prefill and evicted at
  eos/max-new; the decode step always runs the full slot batch (inactive
  rows compute garbage that is never read).
* **Per-row cache lengths.** Every slot has its own frontier: rope
  positions, cache writes and attention masks are per row, which lets
  requests at different depths share one step.
* **Sampling on the device.** The step samples per row (per-row
  temperature; engine-wide top-k/top-p), and a decode chunk of n steps
  keeps tokens, done flags and budgets on the device, fetching its
  [n_steps, SLOTS] token block with one host sync.
* **Prefill through the flash kernel.** Admission runs
  :func:`nanotpu_torch.models.generate._run` over the prompt padded to a
  bucket length, so a flash config's prefill launches the CUDA kernel once
  per layer; the row is then copied into its slot.

The cache is updated in place (the JAX engine donates its buffers to the
same end). Speculative decoding, the int8 KV cache, MoE and meshes are not
ported yet.
"""

from __future__ import annotations

import itertools
import logging
import math
import threading
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from nanotpu_torch import resolve_device
from nanotpu_torch.metrics.stats import percentile
from nanotpu_torch.models.generate import (
    KVCache,
    NEG_INF,
    _run,
    apply_top_k,
    apply_top_p,
    sample_categorical,
    warp_logits,
)
from nanotpu_torch.models.llama import (
    apply_rope,
    embed_lookup,
    linear,
    mlp,
    rms_norm,
    rope_freqs,
)
from nanotpu_torch.ops import _build

log = logging.getLogger("nanotpu_torch.serving")

#: Prompt lengths are padded up to one of these before prefill, as in the
#: JAX engine (where each bucket is one compiled program).
DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


class SlotCache(NamedTuple):
    """Per-layer k/v [SLOTS, max_len, KV, hd] + per-row valid lengths."""

    k: tuple
    v: tuple
    lengths: torch.Tensor  # [SLOTS] int32, on the device

    @staticmethod
    def create(cfg, slots: int, max_len: int, device=None) -> "SlotCache":
        shape = (slots, max_len, cfg.n_kv_heads, cfg.head_dim)
        device = resolve_device(device)
        return SlotCache(
            k=tuple(torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                    for _ in range(cfg.n_layers)),
            v=tuple(torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                    for _ in range(cfg.n_layers)),
            lengths=torch.zeros((slots,), dtype=torch.int32, device=device),
        )


def _attend_rows(q, k_cache, v_cache, base):
    """q [B,S,H,hd] against cache [B,T,KV,hd]; row b's s-th new token sits
    at position base[b]+s and attends positions <= itself. GQA stays
    unexpanded (q heads grouped onto kv heads). S=1 is the decode step."""
    B, S, H, hd = q.shape
    KV, T = k_cache.shape[2], k_cache.shape[1]
    qg = q.reshape(B, S, KV, H // KV, hd)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, k_cache).float()
    logits = logits * (1.0 / math.sqrt(hd))
    frontier = base[:, None] + torch.arange(S, device=q.device)[None, :] + 1
    mask = torch.arange(T, device=q.device)[None, None, :] < frontier[:, :, None]
    logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v_cache)
    return out.reshape(B, S, H, hd)


def _write_rows(cache_arr, new, offsets):
    """Write new [B, S, ...] into cache_arr [B, T, ...] at per-row offsets,
    in place; returns cache_arr.

    Keeps ``dynamic_update_slice``'s clamp: a row's start is
    ``min(offset, T - S)``. INVARIANT (never-read-after-freeze): an offset
    within S-1 of max_len is only possible for FROZEN rows (active rows are
    admitted with >= S positions of slack); the clamp then writes over the
    row's still-valid prefix, which is safe solely because frozen rows are
    evicted and never attended again. Plain indexing would instead raise
    or write out of range."""
    B, S = new.shape[:2]
    T = cache_arr.shape[1]
    start = torch.clamp(offsets.long(), 0, T - S)
    cols = start[:, None] + torch.arange(S, device=cache_arr.device)[None, :]
    rows = torch.arange(B, device=cache_arr.device)[:, None]
    cache_arr[rows, cols] = new.to(cache_arr.dtype)
    return cache_arr


def _rows_forward(params, cfg, cache: SlotCache, tokens, advance):
    """Forward ``tokens [B, S]`` fed at each row's frontier; returns
    (logits [B, S, V] fp32, cache with per-row lengths advanced by
    ``advance [B]``). k/v for all S positions are written at each row's
    current frontier regardless of ``advance``; frozen rows (advance 0)
    still write, see the invariant on :func:`_write_rows`."""
    B, S = tokens.shape
    positions = cache.lengths[:, None] + torch.arange(
        S, dtype=torch.int32, device=tokens.device
    )[None, :]
    cos, sin = rope_freqs(cfg, positions)
    x = embed_lookup(params["embed"], tokens)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for i, layer in enumerate(params["layers"]):
        attn = layer["attn"]
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = linear(h, attn["wq"]).reshape(B, S, H, hd)
        k = linear(h, attn["wk"]).reshape(B, S, KV, hd)
        v = linear(h, attn["wv"]).reshape(B, S, KV, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_view = _write_rows(cache.k[i], k, cache.lengths)
        v_view = _write_rows(cache.v[i], v, cache.lengths)
        out = _attend_rows(q, k_view, v_view, cache.lengths)
        x = x + linear(out.reshape(B, S, H * hd), attn["wo"])
        x = x + mlp(layer["mlp"], rms_norm(x, layer["mlp_norm"], cfg.norm_eps))
    new_cache = cache._replace(lengths=cache.lengths + advance.to(torch.int32))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return linear(x, params["lm_head"]).float(), new_cache  # [B,S,V]


def _warp_rows(logits, temps, top_k: int, top_p: float):
    """Per-row warped logits: temperature is per row (greedy rows get a
    near-zero temperature floor only to keep the division defined; their
    tokens come from argmax, never from these logits)."""
    sl = logits / torch.clamp(temps, min=1e-6)[:, None]
    if top_k:
        sl = apply_top_k(sl, top_k)
    if top_p < 1.0:
        sl = apply_top_p(sl, top_p)
    return sl


def serving_step(params, cfg, cache: SlotCache, tokens, active, temps,
                 generator, top_k: int = 0, top_p: float = 1.0):
    """One decode step for the whole slot batch.

    tokens/active/temps: [SLOTS]; returns (next_tokens [SLOTS], cache with
    active rows advanced by one). Greedy where temps <= 0, temperature /
    top-k / top-p sampling elsewhere."""
    logits_all, new_cache = _rows_forward(
        params, cfg, cache, tokens[:, None], active.to(torch.int32)
    )
    logits = logits_all[:, -1]  # [B, V]
    greedy = torch.argmax(logits, dim=-1)
    sampled = sample_categorical(_warp_rows(logits, temps, top_k, top_p),
                                 generator)
    return torch.where(temps > 0, sampled, greedy), new_cache


def serving_chunk(params, cfg, cache: SlotCache, tokens, done, temps,
                  remaining, generator, n_steps: int, eos_id: int = -1,
                  top_k: int = 0, top_p: float = 1.0):
    """``n_steps`` decode steps with tokens/done/remaining kept on the
    device (the JAX engine's ``lax.scan`` chunk as a loop): no step waits
    on the host. A row freezes when it emits ``eos_id`` or its
    ``remaining`` budget hits zero; frozen rows re-feed their token and do
    not advance their length.

    Returns (cache, tokens, done, remaining, toks [n_steps, SLOTS]) with
    ``toks`` still on the device; the caller fetches it in one sync."""
    toks = []
    for _ in range(n_steps):
        active = ~done
        nxt, cache = serving_step(
            params, cfg, cache, tokens, active, temps, generator,
            top_k=top_k, top_p=top_p,
        )
        tokens = torch.where(done, tokens, nxt)  # frozen rows hold theirs
        remaining = remaining - active.to(remaining.dtype)
        done = done | (remaining <= 0)
        if eos_id >= 0:
            done = done | (tokens == eos_id)
        toks.append(tokens)
    return cache, tokens, done, remaining, torch.stack(toks)


def prefill_request(params, cfg, prompt_padded, true_len: int, max_len: int,
                    temp: float, generator, top_k: int = 0,
                    top_p: float = 1.0):
    """Prefill one request (B=1, padded prompt) and sample its first token.

    Returns (first_token 0-dim tensor, k rows, v rows) where rows are
    per-layer [1, max_len, KV, hd] ready for :func:`insert_request`. The
    pad region's k/v are garbage but sit at positions >= true_len, beyond
    the row's frontier: never attended."""
    cache = KVCache.create(cfg, 1, max_len, device=prompt_padded.device)
    logits_all, cache = _run(
        params, prompt_padded, cfg, cache, full_prefill=True,
        return_all=True,
    )  # [1, S_pad, V]
    logits = logits_all[:, true_len - 1]  # [1, V]
    if temp > 0:
        first = sample_categorical(warp_logits(logits, temp, top_k, top_p),
                                   generator)
    else:
        first = torch.argmax(logits, dim=-1)
    return first[0], cache.k, cache.v


def insert_request(cache: SlotCache, ks, vs, slot: int,
                   length: int) -> SlotCache:
    """Copy a prefilled row into ``slot`` in place (no copy of the other
    slots) and set its length."""
    for ck, rk in zip(cache.k, ks):
        ck[slot] = rk[0]
    for cv, rv in zip(cache.v, vs):
        cv[slot] = rv[0]
    cache.lengths[slot] = length
    return cache


class Request:
    """One generation request; wait() blocks until completion."""

    _ids = itertools.count()

    def __init__(self, tokens: list[int], max_new_tokens: int,
                 temperature: float = 0.0):
        self.id = next(self._ids)
        self.prompt = list(tokens)
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.out: list[int] = []
        self.submitted_at = time.perf_counter()
        self.first_token_at: float | None = None
        self.done_at: float | None = None
        self.error: str | None = None
        self._done = threading.Event()
        #: signaled by the engine loop whenever new tokens landed in
        #: ``out`` (once per decode chunk per row): stream()'s wakeup
        self._progress = threading.Condition()

    # -- results -----------------------------------------------------------
    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def stream(self, timeout: float | None = None):
        """Yield lists of new tokens as the engine emits them (one batch
        per decode-chunk boundary), returning when the request completes.
        ``timeout`` bounds the wait for EACH batch; no progress within it
        raises TimeoutError. Check ``self.error`` after exhaustion."""
        cursor = 0
        while True:
            with self._progress:
                while cursor >= len(self.out) and not self._done.is_set():
                    if not self._progress.wait(timeout):
                        raise TimeoutError(
                            f"request {self.id}: no progress in {timeout}s"
                        )
                batch = list(self.out[cursor:])
            cursor += len(batch)
            if batch:
                yield batch
            if self._done.is_set() and cursor >= len(self.out):
                return

    def _notify_progress(self) -> None:
        with self._progress:
            self._progress.notify_all()

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def latency_s(self) -> float | None:
        if self.done_at is None:
            return None
        return self.done_at - self.submitted_at

    def _finish(self, error: str | None = None) -> None:
        self.error = error
        self.done_at = time.perf_counter()
        self._done.set()
        self._notify_progress()


class Engine:
    """Continuous-batching engine: one background loop interleaves
    admission prefills with whole-batch decode chunks.

    ``slots`` bounds concurrent requests; extras queue. ``eos_id >= 0``
    stops a row early. ``top_k``/``top_p`` apply engine-wide to sampled
    (temperature > 0) rows; temperature is per request. ``params`` must
    already sit on ``device`` (``cuda`` unless the caller names another).
    """

    #: EWMA weight of one new tokens/s sample
    EWMA_ALPHA = 0.3

    def __init__(self, params, cfg, slots: int = 8, max_len: int | None = None,
                 buckets: tuple = DEFAULT_BUCKETS, eos_id: int = -1,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 chunk_steps: int = 32, chunk_steps_max: int = 96,
                 device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on "
                f"{self.device}"
            )
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len or cfg.max_seq_len
        self.buckets = tuple(b for b in sorted(buckets) if b <= self.max_len)
        if not self.buckets or self.buckets[-1] < self.max_len:
            self.buckets = self.buckets + (self.max_len,)
        self.eos_id = eos_id
        self.top_k = top_k
        self.top_p = top_p
        #: decode steps per host sync: the small chunk keeps admission
        #: latency low while requests queue; the large one amortizes the
        #: per-chunk sync when every row has a long runway
        self.chunk_steps = max(1, chunk_steps)
        self.chunk_steps_max = max(self.chunk_steps, chunk_steps_max)

        self._cache = SlotCache.create(cfg, slots, self.max_len,
                                       device=self.device)
        self._slot_req: list[Request | None] = [None] * slots
        # host mirrors of per-row decode state; re-uploaded when _dirty
        self._tokens = np.zeros((slots,), np.int64)  # last token per slot
        self._temps = np.zeros((slots,), np.float32)
        self._done = np.ones((slots,), np.bool_)  # empty slots are frozen
        self._remaining = np.zeros((slots,), np.int32)
        self._dirty = True
        # device-resident copies, carried across chunks
        self._d_tokens = self._d_temps = None
        self._d_done = self._d_remaining = None
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: deque[Request] = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._warm = threading.Event()
        self._warm_error: BaseException | None = None

        # stats (served by /metrics and /v1/stats)
        self.requests_total = 0
        self.tokens_total = 0
        #: realized decode tokens/s EWMA over decode chunks; None until the
        #: first chunk. Read/written under self._cv.
        self.tok_s_ewma: float | None = None
        self.ttft_samples: deque[float] = deque(maxlen=4096)
        self.latency_samples: deque[float] = deque(maxlen=4096)

        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serving-engine"
        )
        self._thread.start()

    # -- public API --------------------------------------------------------
    def submit(self, tokens: list[int], max_new_tokens: int,
               temperature: float = 0.0) -> Request:
        req = Request(tokens, max_new_tokens, temperature)
        if not tokens or max_new_tokens < 1:
            req._finish("empty prompt or max_new_tokens < 1")
            return req
        if len(tokens) >= self.max_len:
            req._finish(
                f"prompt length {len(tokens)} >= engine max_len {self.max_len}"
            )
            return req
        if not all(0 <= t < self.cfg.vocab_size for t in tokens):
            req._finish(f"token ids must lie in [0, {self.cfg.vocab_size})")
            return req
        with self._cv:
            if self._stop:
                req._finish("engine stopped")
                return req
            self._queue.append(req)
            self.requests_total += 1
            self._cv.notify()
        return req

    def generate(self, tokens: list[int], max_new_tokens: int,
                 temperature: float = 0.0, timeout: float = 600.0) -> list[int]:
        """Blocking convenience wrapper."""
        req = self.submit(tokens, max_new_tokens, temperature)
        if not req.wait(timeout):
            raise TimeoutError(f"request {req.id} timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.out

    def wait_warm(self, timeout: float | None = None) -> bool:
        """Block until the kernel library is built and one warm-up prefill
        and decode step have run, so neither lands inside the first
        request's time to first token."""
        ready = self._warm.wait(timeout)
        if self._warm_error is not None:
            raise RuntimeError("engine warm-up failed") from self._warm_error
        return ready

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=30)

    def metrics(self) -> dict:
        """Cheap feedback snapshot with the JAX engine's key set (the
        serving-provider contract that ``/v1/stats`` consumers read).
        Host-side state only: safe to call from a scrape thread."""
        with self._cv:
            queued = len(self._queue)
            tok_s = self.tok_s_ewma
            ttft_p99 = percentile(list(self.ttft_samples), 0.99)
        active = 0
        kv_used = 0
        for req in self._slot_req:
            if req is None:
                continue
            active += 1
            kv_used += min(self.max_len, len(req.prompt) + len(req.out))
        return {
            "tok_s": round(tok_s, 4) if tok_s is not None else 0.0,
            "queue_depth": float(queued),
            "active": float(active),
            "slots": float(self.slots),
            "kv_occupancy": round(kv_used / (self.slots * self.max_len), 6),
            "chips": 1.0,
            "ttft_p99_ms": (
                round(ttft_p99 * 1e3, 2) if ttft_p99 is not None else 0.0
            ),
        }

    def stats(self) -> dict:
        """The JAX engine's ``/v1/stats`` fields; the speculation and MoE
        fields are fixed (nothing here speculates or routes)."""
        m = self.metrics()
        with self._cv:
            queued = len(self._queue)
            ttft = sorted(self.ttft_samples)
            lat = sorted(self.latency_samples)
        active = sum(1 for r in self._slot_req if r is not None)

        def pct(xs, p):
            return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else None

        return {
            "slots": self.slots,
            "active": active,
            "queued": queued,
            "tok_s": m["tok_s"],
            "kv_occupancy": m["kv_occupancy"],
            "chips": int(m["chips"]),
            "requests_total": self.requests_total,
            "tokens_total": self.tokens_total,
            "moe_prefill_dropped_total": 0,
            "ttft_p50_ms": pct(ttft, 0.5) and round(pct(ttft, 0.5) * 1e3, 2),
            "ttft_p99_ms": pct(ttft, 0.99) and round(pct(ttft, 0.99) * 1e3, 2),
            "latency_p50_ms": pct(lat, 0.5) and round(pct(lat, 0.5) * 1e3, 2),
            "spec_cycles_total": 0,
            "spec_tokens_per_cycle": None,
            "spec_bandit_tok_s": None,
        }

    # -- engine loop -------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _warm_up(self) -> None:
        """Build the kernel library and run one prefill at the smallest
        bucket plus one decode step with every slot frozen (writes land in
        empty rows, which admission overwrites whole)."""
        if self.device.type == "cuda":
            _build.build_all()
        padded = torch.zeros((1, self.buckets[0]), dtype=torch.long,
                             device=self.device)
        prefill_request(self.params, self.cfg, padded, 1, self.max_len, 0.0,
                        self._gen)
        frozen = torch.ones((self.slots,), dtype=torch.bool, device=self.device)
        zeros = torch.zeros((self.slots,), dtype=torch.long, device=self.device)
        self._cache, *_ = serving_chunk(
            self.params, self.cfg, self._cache, zeros, frozen,
            zeros.float(), zeros.int(), self._gen, n_steps=1,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _admit_all(self) -> None:
        """Move queued requests into free slots. Prefills are enqueued per
        request, and their first tokens come back in ONE stacked fetch."""
        admitted: list[tuple[Request, int, torch.Tensor]] = []
        while True:
            slot = next(
                (i for i, r in enumerate(self._slot_req) if r is None
                 and all(a[1] != i for a in admitted)),
                None,
            )
            if slot is None:
                break
            with self._cv:
                if not self._queue:
                    break
                req = self._queue.popleft()
            S = len(req.prompt)
            # cap generation to the cache row; the floor of 1 keeps a
            # near-max_len prompt at one prefill token, no decode steps
            req.max_new_tokens = max(1, min(req.max_new_tokens,
                                            self.max_len - S))
            padded = np.zeros((1, self._bucket(S)), np.int64)
            padded[0, :S] = req.prompt
            first, ks, vs = prefill_request(
                self.params, self.cfg,
                torch.from_numpy(padded).to(self.device), S, self.max_len,
                req.temperature, self._gen, top_k=self.top_k, top_p=self.top_p,
            )
            self._cache = insert_request(self._cache, ks, vs, slot, S)
            admitted.append((req, slot, first))
        if not admitted:
            return
        firsts = torch.stack([f for _, _, f in admitted]).cpu().numpy()
        now = time.perf_counter()
        for (req, slot, _), tok in zip(admitted, firsts):
            tok = int(tok)
            req.first_token_at = now
            with self._cv:  # stats() sorts these concurrently
                self.ttft_samples.append(req.ttft_s)
            req.out.append(tok)
            self.tokens_total += 1
            if len(req.out) >= req.max_new_tokens or (
                self.eos_id >= 0 and tok == self.eos_id
            ):
                req._finish()
                with self._cv:
                    self.latency_samples.append(req.latency_s)
                continue
            req._notify_progress()  # first token is streamable immediately
            self._slot_req[slot] = req
            self._tokens[slot] = tok
            self._temps[slot] = req.temperature
            self._done[slot] = False
            self._remaining[slot] = req.max_new_tokens - 1  # first already out
            self._dirty = True

    def _decode_cycle(self) -> None:
        """One chunk of decode steps, then host-side bookkeeping. The
        device carries tokens/done/remaining between chunks; the host
        mirrors go up only when admission or eviction changed them."""
        if self._dirty:
            def up(a):
                return torch.from_numpy(a).to(self.device)

            self._d_tokens = up(self._tokens)
            self._d_temps = up(self._temps)
            self._d_done = up(self._done)
            self._d_remaining = up(self._remaining)
            self._dirty = False
        # Chunk policy: an oversized chunk is harmless to correctness (rows
        # freeze on device), so the only reason to run a small one is
        # admission latency: a finished row is refilled only at a sync.
        with self._cv:
            queued = bool(self._queue)
        n_steps = self.chunk_steps if queued else self.chunk_steps_max
        # no row owes more than this many tokens, so later steps would only
        # recompute frozen rows (the device still freezes rows at eos)
        n_steps = min(n_steps, int(self._remaining[~self._done].max(initial=1)))
        t_chunk = time.perf_counter()
        (
            self._cache, self._d_tokens, self._d_done, self._d_remaining,
            toks,
        ) = serving_chunk(
            self.params, self.cfg, self._cache, self._d_tokens,
            self._d_done, self._d_temps, self._d_remaining, self._gen,
            n_steps=n_steps, eos_id=self.eos_id, top_k=self.top_k,
            top_p=self.top_p,
        )
        toks = toks.cpu().numpy()  # [n_steps, SLOTS]; the one host sync
        now = time.perf_counter()
        toks_before = self.tokens_total
        # every row's carried token (frozen rows hold theirs)
        self._tokens = toks[-1].astype(np.int64).copy()
        for i, req in enumerate(self._slot_req):
            if req is None:
                continue
            # replay the device's freeze logic to pick the real tokens
            for tok in toks[:, i]:
                if self._done[i]:
                    break
                tok = int(tok)
                req.out.append(tok)
                self.tokens_total += 1
                self._remaining[i] -= 1
                if self._remaining[i] <= 0 or (
                    self.eos_id >= 0 and tok == self.eos_id
                ):
                    self._done[i] = True
            if self._done[i]:
                req.done_at = now
                req._finish()
                with self._cv:  # stats() sorts these concurrently
                    self.latency_samples.append(req.latency_s)
                self._slot_req[i] = None
                self._temps[i] = 0.0
            else:
                req._notify_progress()
        emitted = self.tokens_total - toks_before
        dt = now - t_chunk
        if emitted > 0 and dt > 0:
            rate = emitted / dt
            with self._cv:  # metrics()/stats() read concurrently
                cur = self.tok_s_ewma
                self.tok_s_ewma = (
                    rate if cur is None
                    else (1 - self.EWMA_ALPHA) * cur + self.EWMA_ALPHA * rate
                )

    def _loop(self) -> None:
        with torch.inference_mode():
            try:
                self._warm_up()
            except Exception as e:  # no request can be served: stop
                log.exception("engine warm-up failed")
                self._warm_error = e
                with self._cv:
                    self._stop = True
            finally:
                self._warm.set()
            self._serve()

    def _serve(self) -> None:
        while True:
            with self._cv:
                while (
                    not self._stop
                    and not self._queue
                    and all(r is None for r in self._slot_req)
                ):
                    self._cv.wait()
                if self._stop:
                    for r in self._slot_req:
                        if r is not None:
                            r._finish("engine stopped")
                    for r in self._queue:
                        r._finish("engine stopped")
                    self._queue.clear()
                    return
            try:
                # continuous batching: fill every free slot, then run one
                # decode chunk for the active rows
                self._admit_all()
                if any(r is not None for r in self._slot_req):
                    self._decode_cycle()
            except Exception as e:  # fail requests, keep the engine alive
                log.exception("engine cycle failed")
                for i, r in enumerate(self._slot_req):
                    if r is not None:
                        r._finish(f"engine error: {e}")
                        self._slot_req[i] = None
                        self._done[i] = True
                        self._temps[i] = 0.0
                self._dirty = True
