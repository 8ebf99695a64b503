#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, ``nanotpu_torch``.

Drives the port's serving path on one CUDA card and checks it:

1. reads the card's name and power limit (``nvidia-smi``); no card, no run;
2. builds the kernel library from ``nanotpu_torch/ops/csrc``;
3. kernel phase: the flash-attention kernel against its plain version
   (``attention_lse_ref``) on the card, causal GQA 16/8 at head_dim 64 and
   128, S in {32, 130, 2048}, bf16 and f32, with and without lse; then its
   time, the plain version's, SDPA's (a yardstick the port never calls) and
   the bound, at the flagship's S=2048 bucket and at every bucket the
   serving phase hits;
4. serving phase: the flagship preset (vocab 32768, dim 1024, 12 layers,
   16/8 heads, bf16) at full width with 8 slots and max_len 2048, random
   weights from a seeded generator, behind the port's HTTP server; concurrent
   ``/v1/generate`` requests over several prefill buckets, one of them SSE;
   checks tokens, determinism, ``/v1/stats`` and ``/metrics``, and that every
   admission prefill launched the kernel once per layer;
5. parity phase: in float32 at the flagship width, the engine's greedy
   tokens equal the port's own ``generate``.

The last two lines are the kernel table and the device record, as JSON.
Every phase that fails raises; nothing is caught.

Run:  python3 chip_smoke.py     (one CUDA card and nvcc; builds on first use)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

#: published H100 SXM peaks (dense): bf16 tensor cores, f32 outside them,
#: and HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
#: bf16: the kernel keeps logits and probabilities in f32 and rounds only
#: its output to bf16 (half an ulp is 2^-9 relative, ~0.004 at |out| < 2),
#: so it is held against the plain version in f32 on the same bf16 inputs;
#: 2e-2 leaves room for f32 summation order and a few ulps.
#: f32: the two differ only in summation order and __expf, ~1e-6; 1e-4 is
#: loose against that and tight against any indexing or masking fault.
TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
SLOTS, MAX_LEN, NEW_TOKENS = 8, 2048, 32
PROMPT_LENS = (5, 100, 600, 1500)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events after
    three warm-up calls."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound_ms(B, S, H, KV, D, dtype) -> tuple:
    """(least time in ms, what bounds it) for causal attention without lse:
    q, k, v read once and o written once at the HBM rate, or the work this
    call needs (S(S+1)/2 query-key pairs per head, 2 products of 2*D
    operations each) at the peak rate of the input type."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * B * S * D * (2 * H + 2 * KV)
    flops = 4 * D * (S * (S + 1) // 2) * B * H
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def qkv(gen, B, S, H, KV, D, dtype):
    def mk(heads):
        return torch.randn((B, S, heads, D), generator=gen, device="cuda").to(dtype)

    return mk(H), mk(KV), mk(KV)


def kernel_phase(card: str) -> dict:
    from nanotpu_torch.ops.attention import attention_lse_ref, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, KV = 16, 8
    for D in (64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            cases = [(S, True) for S in (32, 130, 2048)] + [(130, False)]
            for S, causal in cases:
                q, k, v = qkv(gen, 1, S, H, KV, D, dtype)
                ref_out, ref_lse = attention_lse_ref(
                    q.float(), k.float(), v.float(), causal
                )
                for need_lse in (False, True):
                    got = flash_attention(q, k, v, causal, need_lse=need_lse)
                    out, lse = got if need_lse else (got, None)
                    torch.cuda.synchronize()
                    err = (out.float() - ref_out).abs().max().item()
                    if lse is not None:
                        err = max(err, (lse - ref_lse).abs().max().item())
                    tol = TOLERANCE[dtype]
                    print(f"kernel D={D} {str(dtype)[6:]} S={S} causal={causal} "
                          f"lse={need_lse}: max_abs_err {err:.3g} (tol {tol})")
                    if not err <= tol:
                        raise AssertionError(
                            f"flash kernel disagrees with attention_lse_ref: "
                            f"D={D} {dtype} S={S} causal={causal} "
                            f"lse={need_lse} err {err} > {tol}"
                        )

    # times at the flagship's prefill shapes: B=1, H=16, KV=8, D=64, bf16
    print(f"timings on {card}")
    rows = {}
    for S in sorted({bucket(n) for n in PROMPT_LENS} | {2048}):
        q, k, v = qkv(gen, 1, S, H, KV, 64, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = cuda_ms(lambda: flash_attention(q, k, v, True))
        plain_ms = cuda_ms(lambda: attention_lse_ref(q, k, v, True), reps=5)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bound_ms, bound_by = attention_bound_ms(1, S, H, KV, 64, torch.bfloat16)
        ref_out, _ = attention_lse_ref(q.float(), k.float(), v.float(), True)
        err = (flash_attention(q, k, v, True).float() - ref_out).abs().max().item()
        rows[S] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "max_abs_err": err}
        print(f"flash_fwd S={S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
              f"err {err:.3g}")
    flash_attention.launches = 0  # comparisons and timings do not count
    return rows


def bucket(n: int) -> int:
    from nanotpu_torch.serving.engine import DEFAULT_BUCKETS

    return next(b for b in DEFAULT_BUCKETS if n <= b)


def post(url: str, body: dict) -> bytes:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        if resp.status != 200:
            raise AssertionError(f"POST {url} -> {resp.status}")
        return resp.read()


def get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=60) as resp:
        if resp.status != 200:
            raise AssertionError(f"GET {url} -> {resp.status}")
        return resp.read()


def serving_phase(card: str) -> dict:
    from nanotpu_torch.ops.attention import flash_attention
    from nanotpu_torch.serving.http import serve
    from nanotpu_torch.serving.server import ServingAPI, build_engine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine("flagship", slots=SLOTS, max_len=MAX_LEN,
                          seed=0, device="cuda")
    engine.wait_warm()
    cfg = engine.cfg
    print(f"flagship engine ready in {time.perf_counter() - t0:.1f} s "
          f"(dim {cfg.dim}, {cfg.n_layers} layers, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, {cfg.dtype}, attn {cfg.attn_impl})")
    api = ServingAPI(engine)
    server = serve(api, 0, host="127.0.0.1")
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    jobs = [{"tokens": p, "max_new_tokens": NEW_TOKENS} for p in prompts]
    jobs.append(dict(jobs[1]))  # a repeated greedy prompt
    stream_job = {"tokens": rng.integers(0, cfg.vocab_size, 40).tolist(),
                  "max_new_tokens": NEW_TOKENS, "stream": True}
    results: dict = {}

    def client(i, job):
        raw = post(f"{base}/v1/generate", job)
        if job.get("stream"):
            events = [json.loads(e[len("data: "):])
                      for e in raw.decode().split("\n\n") if e]
            results[i] = {
                "tokens": [t for e in events if "tokens" in e for t in e["tokens"]],
                "final": events[-1],
                "n_events": len(events),
            }
        else:
            results[i] = json.loads(raw)

    try:
        flash_attention.launches = 0
        threads = [threading.Thread(target=client, args=(i, job))
                   for i, job in enumerate(jobs + [stream_job])]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t_start
        launches = flash_attention.launches
        if any(t.is_alive() for t in threads) or len(results) != len(threads):
            raise AssertionError(f"only {len(results)} of {len(threads)} "
                                 "requests completed")
        for i, res in results.items():
            toks = res["tokens"]
            if len(toks) != NEW_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in toks
            ):
                raise AssertionError(f"request {i}: bad tokens {toks}")
        if results[1]["tokens"] != results[len(jobs) - 1]["tokens"]:
            raise AssertionError("a repeated greedy prompt changed its tokens")
        sse = results[len(jobs)]
        if not sse["final"].get("done") or sse["final"]["n_tokens"] != NEW_TOKENS:
            raise AssertionError(f"SSE stream did not finish: {sse['final']}")
        stats = json.loads(get(f"{base}/v1/stats"))
        # the metrics() fields under the names a remote stats provider
        # reads from /v1/stats (queue_depth travels as "queued")
        wanted = {"queued" if k == "queue_depth" else k
                  for k in engine.metrics()}
        missing = wanted - set(stats)
        if missing:
            raise AssertionError(f"/v1/stats lacks {sorted(missing)}")
        metrics = get(f"{base}/metrics").decode()
        for series in ("nanotpu_serve_requests_total",
                       "nanotpu_serve_ttft_seconds"):
            if series not in metrics:
                raise AssertionError(f"/metrics lacks {series}")
        admissions = len(threads)
        if launches != cfg.n_layers * admissions:
            raise AssertionError(
                f"flash kernel launched {launches} times for {admissions} "
                f"admissions of {cfg.n_layers} layers"
            )
        ttfts = [r["ttft_ms"] for r in results.values() if "ttft_ms" in r]
        ttfts.append(sse["final"]["ttft_ms"])
        print(f"served {admissions} concurrent requests (prompts "
              f"{[len(j['tokens']) for j in jobs + [stream_job]]}, "
              f"{NEW_TOKENS} new tokens each, SSE events {sse['n_events']}) "
              f"in {wall:.3f} s; flash launches {launches}")

        out = {
            "ttft_p50_ms": float(np.percentile(ttfts, 50)),
            "ttft_ms": ttfts,
            "launches": launches,
        }
        out.update(measure(engine, rng, card))
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"serving on {card}: TTFT p50 {out['ttft_p50_ms']:.2f} ms over "
              f"{len(ttfts)} concurrent requests (all: {ttfts}); decode "
              f"{out['decode_tok_s']:.1f} tok/s at {SLOTS} busy slots; peak "
              f"memory {out['peak_mem_gib']:.3f} GiB")
        return out
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()


def device_profile(fn) -> tuple:
    """(wall ms, device-busy ms, top kernels) of one call of ``fn`` under
    the profiler; busy time is the sum of the kernels' device time (one
    stream, so they do not overlap). None where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    events = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e3
    top = [(e.key[:60], round(dev_us(e) / 1e3, 3), e.count) for e in events[:6]]
    return wall * 1e3, (busy if busy > 0 else None), top


def measure(engine, rng, card: str) -> dict:
    """Bring-up numbers: time to first token of a lone request per prefill
    bucket, the decode rate with every slot busy, and the device's busy
    share in each."""
    cfg = engine.cfg
    out = {"ttft_by_bucket_ms": {}}
    for n in PROMPT_LENS:
        samples = []
        for _ in range(3):
            req = engine.submit(rng.integers(0, cfg.vocab_size, n).tolist(), 1)
            if not req.wait(300) or req.error:
                raise AssertionError(f"prefill request failed: {req.error}")
            samples.append(req.ttft_s * 1e3)
        out["ttft_by_bucket_ms"][bucket(n)] = float(np.median(samples))
    print(f"TTFT of a lone request, median of 3, by prefill bucket on {card}: "
          f"{out['ttft_by_bucket_ms']}")

    def decode(n_new):
        reqs = [engine.submit(rng.integers(0, cfg.vocab_size, 64).tolist(),
                              n_new) for _ in range(SLOTS)]
        for r in reqs:
            if not r.wait(600) or r.error:
                raise AssertionError(f"decode request failed: {r.error}")
        return reqs

    reqs = decode(256)
    window = max(r.done_at for r in reqs) - max(r.first_token_at for r in reqs)
    out["decode_tok_s"] = sum(len(r.out) - 1 for r in reqs) / window
    out["decode_step_ms"] = window * 1e3 / (len(reqs[0].out) - 1)

    wall, busy, top = device_profile(lambda: decode(64))
    out["decode_profile"] = {"wall_ms": wall, "device_busy_ms": busy,
                             "top": top}
    print(f"decode, {SLOTS} requests x 64 tokens under the profiler on "
          f"{card}: wall {wall:.1f} ms, device busy "
          f"{'not measured' if busy is None else f'{busy:.1f} ms'}; "
          f"top kernels {top}")
    prompt = rng.integers(0, cfg.vocab_size, PROMPT_LENS[-1]).tolist()
    wall, busy, top = device_profile(lambda: engine.generate(prompt, 1))
    out["prefill_profile"] = {"wall_ms": wall, "device_busy_ms": busy,
                              "top": top}
    print(f"one {bucket(len(prompt))}-bucket prefill under the profiler on "
          f"{card}: wall {wall:.1f} ms, device busy "
          f"{'not measured' if busy is None else f'{busy:.1f} ms'}; "
          f"top kernels {top}")
    return out


def parity_phase() -> None:
    from nanotpu_torch.models.generate import generate
    from nanotpu_torch.serving.server import build_engine

    engine = build_engine("flagship", slots=2, max_len=MAX_LEN, seed=1,
                          dtype="float32", device="cuda")
    try:
        engine.wait_warm()
        prompt = np.random.default_rng(1).integers(
            0, engine.cfg.vocab_size, 77).tolist()
        got = engine.generate(prompt, 16)
        want = generate(engine.params, torch.tensor([prompt], device="cuda"),
                        engine.cfg, 16)[0].tolist()
    finally:
        engine.stop()
    if got != want:
        raise AssertionError(f"f32 engine {got} != generate {want}")
    print(f"parity: f32 flagship engine greedy tokens equal generate: {got}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nanotpu_torch.ops import _build

    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, r in report.items():
        print(f"{name}: nvcc {r['seconds']:.2f} s\n{r['ptxas']}")

    rows = kernel_phase(card)
    serve = serving_phase(card)
    parity_phase()

    at = rows[2048]
    table = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "nanotpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "nanotpu/ops/attention.py:90",
        "launches": serve["launches"],
        "max_abs_err": at["max_abs_err"],
        "ms": at["ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": at["library_ms"],
    }]}
    print(card)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
