#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, ``nanotpu_torch``.

Drives the port's serving and training paths on one CUDA card and checks
them:

1. reads the card's name and power limit (``nvidia-smi``); no card, no run;
2. builds the kernel libraries from ``nanotpu_torch/ops/csrc`` (one nvcc per
   source, all started together);
3. forward kernel phase: the flash-attention forward against its plain
   version (``attention_lse_ref``) on the card, causal GQA 16/8 at head_dim
   64 and 128, S in {32, 130, 2048}, bf16 and f32, with and without lse,
   and at the training flagship's shape (B=8, S=2048, 16/4 heads, out and
   lse); then its time, the plain version's, SDPA's (a yardstick the port
   never calls) and the bound, at the serving flagship's buckets and at the
   training flagship's shape (SDPA's forward there too);
4. backward kernel phase: the fused, dq and dk/dv kernels against their
   plain version (``attention_bwd_ref``) at the training flagship's shape
   (B=8, S=2048, 16/4 heads, D=64, bf16), at D=128 (8/2 heads), at a
   ragged S=2047 and with one KV head (8/1, D=128), and in f32 at S=130,
   each bf16 gradient element by element (GRAD_RMS_FLOOR), on forward
   outputs that are held against their plain version first; then each
   one's time, its bound, the plain version's and SDPA's backward
   (forward + backward minus forward), and the fused pass against the
   two-pass pair at S=8192 (B=1, 16/4 heads); the assembler's registers
   and spills of the bf16 dk/dv kernels, which must not spill;
5. serving phase: the serving flagship preset (vocab 32768, dim 1024, 12
   layers, 16/8 heads, bf16) at full width with 8 slots and max_len 2048,
   random weights from a seeded generator, behind the port's HTTP server;
   concurrent ``/v1/generate`` requests over several prefill buckets, one of
   them SSE; checks tokens, determinism, ``/v1/stats`` and ``/metrics``, and
   that every admission prefill launched the forward kernel once per layer;
6. serving parity phase: in float32 at the flagship width, the engine's
   greedy tokens equal the port's own ``generate``;
7. training phase: the trainer's CLI entry (``nanotpu_torch.parallel.train``)
   on the training flagship (vocab 32768, dim 1024, 8 layers, 16/4 heads,
   bf16, ``--attn flash --seq 2049 --batch 8 --data markov --steps 10``):
   finite losses, lower at step 10 than at step 1, 8 fused backward
   launches and at least 8 forward launches a step; peak memory, steady
   tokens/s and one step under the profiler, with the fused backward's
   share of its device-busy time;
8. two-pass phase: one such step with ``FUSED_BWD_MAX_S = 0`` (what
   ``NANOTPU_FLASH_FUSED_BWD_MAX_S=0`` sets at import), so the dq and dk/dv
   kernels run on the path, 8 launches each;
9. training parity phase: one f32 train step of the flagship width from the
   same parameters through ``attn_impl="flash"`` and ``"dense"``: close loss,
   gradients and updated parameters.

The last two lines are the kernel table and the device record, as JSON.
Each path (serving, training, two-pass) counts its kernel launches from 0
and reads them just after it ran; the table gives each path's count and
their sum.
Every phase that fails raises; nothing is caught.

Run:  python3 chip_smoke.py     (one CUDA card and nvcc; builds on first use)
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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
#: the backward in bf16 is held element by element, each error over |want|
#: plus the RMS of want's row (the last axis: one query or key row of one
#: head), the RMS at least GRAD_RMS_FLOOR so that rows which are zero in
#: exact arithmetic (query row 0 of a causal dq) do not divide rounding
#: noise by nothing. Rounding the output to bf16 costs at most 2^-8 of
#: |want|, and rounding p and ds for their products some 2^-9 of the row's
#: scale; a dropped or misplaced tile costs most of |want| in every row it
#: touches, however small that row's gradients are.
GRAD_RMS_FLOOR = 1e-3
SLOTS, MAX_LEN, NEW_TOKENS = 8, 2048, 32
#: the training drive: the model sees TRAIN_S tokens after the loss shift
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2048, 10
TRAIN_ARGV = ["--preset", "flagship", "--attn", "flash", "--seq",
              str(TRAIN_S + 1), "--batch", str(TRAIN_B), "--data", "markov",
              "--device", "cuda"]
PROMPT_LENS = (5, 100, 600, 1500)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events after
    three warm-up calls. The card first spins ~200 us per call, so that the
    host has queued every call before the first event fires: a call whose
    host side outlasts its kernels is timed by its kernels, not by the
    host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000 * reps)
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


def check_forward(label: str, out, lse, ref_out, ref_lse, dtype) -> float:
    """Largest absolute error of the forward kernel's out (and lse, where
    given) against the plain version's; raises past the dtype's tolerance,
    and on a NaN, which no comparison passes."""
    torch.cuda.synchronize()
    err = (out.float() - ref_out).abs().max()
    if lse is not None:  # torch.maximum keeps a NaN
        err = torch.maximum(err, (lse - ref_lse).abs().max())
    err = err.item()
    tol = TOLERANCE[dtype]
    print(f"kernel {label}: max_abs_err {err:.3g} (tol {tol})")
    if not err <= tol:
        raise AssertionError(f"flash kernel disagrees with attention_lse_ref: "
                             f"{label} err {err} > {tol}")
    return err


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
                    check_forward(f"D={D} {str(dtype)[6:]} S={S} causal="
                                  f"{causal} lse={need_lse}", out, lse,
                                  ref_out, ref_lse, dtype)

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
    # the training flagship's shape: B=8, S=2048, 16/4 heads, with lse;
    # checked (out and lse) before it is timed
    q, k, v = qkv(gen, TRAIN_B, TRAIN_S, 16, 4, 64, torch.bfloat16)
    out, lse = flash_attention(q, k, v, True, need_lse=True)
    ref_out, ref_lse = attention_lse_ref(q.float(), k.float(), v.float(), True)
    err = check_forward(f"B={TRAIN_B} S={TRAIN_S} 16/4 D=64 bfloat16 causal "
                        f"lse=True (training shape)", out, lse, ref_out,
                        ref_lse, torch.bfloat16)
    del out, lse, ref_out, ref_lse
    ms = cuda_ms(lambda: flash_attention(q, k, v, True, need_lse=True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    bound_ms, bound_by = attention_bound_ms(TRAIN_B, TRAIN_S, 16, 4, 64,
                                            torch.bfloat16)
    print(f"flash_fwd B={TRAIN_B} S={TRAIN_S} 16/4 heads with lse (training "
          f"shape): kernel {ms:.4f} ms, SDPA forward {library_ms:.4f} ms, "
          f"bound {bound_ms:.5f} ms ({bound_by}), err {err:.3g}")
    rows["train"] = {"ms": ms, "library_ms": library_ms, "bound_ms": bound_ms,
                     "max_abs_err": err}
    reset_launches()  # comparisons and timings do not count
    return rows


def bwd_bound_ms(B, S, H, KV, D, products: int, outputs: str) -> tuple:
    """(least time in ms, what bounds it) of a causal bf16 backward kernel:
    q, k, v, dO (bf16) and lse, D (f32) read once and its outputs (``q``
    for dq, ``kv`` for dk and dv) written once at the HBM rate, or
    ``products`` products over the S(S+1)/2 causal pairs per head at the
    bf16 peak."""
    nbytes = 2 * B * S * D * (2 * H + 2 * KV) + 2 * 4 * B * H * S
    nbytes += 2 * B * S * D * (H * ("q" in outputs) + 2 * KV * ("kv" in outputs))
    flops = products * 2 * D * (S * (S + 1) // 2) * B * H
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[torch.bfloat16]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def bwd_inputs(gen, B, S, H, KV, D, dtype, causal=True):
    """Random q, k, v, dO and the forward kernel's out and lse on them,
    which are first held against the plain version, then D."""
    from nanotpu_torch.ops import attention as att

    q, k, v = qkv(gen, B, S, H, KV, D, dtype)
    dout = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
    out, lse = att.flash_attention(q, k, v, causal, need_lse=True)
    ref_out, ref_lse = att.attention_lse_ref(q.float(), k.float(), v.float(),
                                             causal)
    check_forward(f"B={B} S={S} {H}/{KV} D={D} {str(dtype)[6:]} causal="
                  f"{causal} lse=True (backward inputs)", out, lse, ref_out,
                  ref_lse, dtype)
    return q, k, v, out, lse, dout, att._dvec(out, dout)


def run_bwd(kernel: str, q, k, v, dout, lse, dvec, causal=True):
    """(dq, dk, dv) of one backward kernel; None where it writes none."""
    from nanotpu_torch.ops import attention as att

    if kernel == "flash_bwd_fused":
        return att.flash_bwd_fused(q, k, v, dout, lse, dvec, causal)
    if kernel == "flash_bwd_dq":
        return att.flash_bwd_dq(q, k, v, dout, lse, dvec, causal), None, None
    return (None, *att.flash_bwd_dkv(q, k, v, dout, lse, dvec, causal))


def grad_errs(got, want) -> tuple:
    """(largest absolute error, largest absolute error over the reference's
    largest magnitude (at least 1), largest row-scaled error: see
    GRAD_RMS_FLOOR) over the gradients a kernel wrote (None where it writes
    none); NaN when any value is not finite, so that no comparison passes
    it."""
    errs = []
    for g, w in zip(got, want):
        if g is None:
            continue
        diff = (g.float() - w).abs()
        rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(GRAD_RMS_FLOOR)
        errs.append((diff.max(), diff.max() / w.abs().max().clamp_min(1.0),
                     (diff / (w.abs() + rms)).max()))
    return tuple(torch.stack(col).max().item() for col in zip(*errs))


BWD_KERNELS = {  # name -> (products per pair, outputs, the TPU kernel)
    "flash_bwd_fused": (5, "q kv", "nanotpu/ops/attention.py:384"),
    "flash_bwd_dq": (3, "q", "nanotpu/ops/attention.py:300"),
    "flash_bwd_dkv": (4, "kv", "nanotpu/ops/attention.py:339"),
}


def backward_phase(card: str) -> dict:
    """Every backward kernel against its plain version, then timed at the
    training flagship's shape. bf16 is held element by element to 2e-2 of
    |want| plus its row's RMS (p and ds are rounded to bf16 for their
    products, and the fused pass sums dq in no fixed order), f32 to 1e-4
    absolute."""
    from nanotpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(TRAIN_B, TRAIN_S, 16, 4, 64, torch.bfloat16, True),
             (2, TRAIN_S, 8, 2, 128, torch.bfloat16, True),
             (2, TRAIN_S - 1, 16, 4, 64, torch.bfloat16, True),
             (2, TRAIN_S, 8, 1, 128, torch.bfloat16, True),
             (2, 130, 16, 4, 64, torch.float32, True),
             (2, 130, 8, 2, 128, torch.float32, False)]
    errs = {}
    for B, S, H, KV, D, dtype, causal in cases:
        q, k, v, out, lse, dout, dvec = bwd_inputs(gen, B, S, H, KV, D, dtype,
                                                   causal)
        want = att.attention_bwd_ref(q.float(), k.float(), v.float(),
                                     out.float(), lse, dout.float(), causal)
        failed = []  # every kernel of the case is read before one fails it
        for name in BWD_KERNELS:
            got = run_bwd(name, q, k, v, dout, lse, dvec, causal)
            torch.cuda.synchronize()
            abs_err, of_largest, row_err = grad_errs(got, want)
            err = row_err if dtype == torch.bfloat16 else abs_err
            tol = TOLERANCE[dtype]
            print(f"{name} B={B} S={S} {H}/{KV} D={D} {str(dtype)[6:]} "
                  f"causal={causal}: max abs err {abs_err:.3g}, of the "
                  f"largest gradient {of_largest:.3g}, row-scaled "
                  f"{row_err:.3g} (tol {tol} "
                  f"{'row-scaled' if dtype == torch.bfloat16 else 'abs'})")
            if not err <= tol:
                failed.append(f"{name} err {err} > {tol}")
            if (B, S, D, dtype) == (TRAIN_B, TRAIN_S, 64, torch.bfloat16):
                errs[name] = abs_err
        if failed:
            raise AssertionError(f"disagrees with attention_bwd_ref at B={B} "
                                 f"S={S} D={D} {dtype}: {failed}")
        del want

    # times at the training flagship's shape
    q, k, v, out, lse, dout, dvec = bwd_inputs(
        gen, TRAIN_B, TRAIN_S, 16, 4, 64, torch.bfloat16)
    plain_ms = cuda_ms(lambda: att.attention_bwd_ref(
        q, k, v, out, lse, dout, True), reps=3)
    qt, kt, vt, dt = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    qt, kt, vt = (x.requires_grad_(True) for x in (qt, kt, vt))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    sdpa_fwd = cuda_ms(sdpa)
    sdpa_both = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dt))
    library_ms = sdpa_both - sdpa_fwd
    print(f"timings on {card}: B={TRAIN_B} S={TRAIN_S} 16/4 heads D=64 bf16 "
          f"causal; plain backward {plain_ms:.4f} ms; SDPA forward "
          f"{sdpa_fwd:.4f} ms, forward+backward {sdpa_both:.4f} ms, so "
          f"backward {library_ms:.4f} ms")
    rows = {}
    for name, (products, outputs, replaces) in BWD_KERNELS.items():
        ms = cuda_ms(lambda: run_bwd(name, q, k, v, dout, lse, dvec))
        bound_ms, bound_by = bwd_bound_ms(TRAIN_B, TRAIN_S, 16, 4, 64,
                                          products, outputs)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "max_abs_err": errs[name], "replaces": replaces}
        print(f"{name}: kernel {ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}, {products} products), plain {plain_ms:.4f} ms, "
              f"SDPA backward {library_ms:.4f} ms, x SDPA "
              f"{ms / library_ms:.2f}")
    del q, k, v, out, lse, dout, dvec, qt, kt, vt, dt

    # the fused pass against the two-pass pair past FUSED_BWD_MAX_S's
    # default, where the dispatch takes the pair
    q, k, v, out, lse, dout, dvec = bwd_inputs(gen, 1, 4 * TRAIN_S, 16, 4, 64,
                                               torch.bfloat16)
    fused = cuda_ms(lambda: run_bwd("flash_bwd_fused", q, k, v, dout, lse,
                                    dvec), reps=10)
    pair = cuda_ms(lambda: (run_bwd("flash_bwd_dq", q, k, v, dout, lse, dvec),
                            run_bwd("flash_bwd_dkv", q, k, v, dout, lse, dvec)),
                   reps=10)
    print(f"B=1 S={4 * TRAIN_S} 16/4 D=64 bf16 causal on {card}: fused "
          f"{fused:.4f} ms, two-pass pair {pair:.4f} ms")
    reset_launches()  # comparisons and timings do not count
    return rows


def kv_ptxas(report: dict) -> dict:
    """{kernel: (registers, spill bytes)} of the bf16 dk/dv kernels
    (``bwd_kv_bf16<D, kDq>``) from the assembler's report of this build;
    empty where flash_bwd was not built in this process."""
    text = report.get("flash_bwd", {}).get("ptxas", "")
    found = {}
    for part in text.split("Function properties for ")[1:]:
        name = part.split(None, 1)[0]
        m = re.search(r"bwd_kv_bf16ILi(\d+)ELb(\d)E", name)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           part)
        regs = re.search(r"Used (\d+) registers", part)
        if m and spills and regs:
            found[f"bwd_kv_bf16<{m[1]}, {'true' if m[2] == '1' else 'false'}>"] = (
                int(regs[1]), int(spills[1]) + int(spills[2]))
    return found


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
        reset_launches()
        threads = [threading.Thread(target=client, args=(i, job))
                   for i, job in enumerate(jobs + [stream_job])]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t_start
        launches = read_launches()
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
        if launches != {**dict.fromkeys(launches, 0),
                        "flash_fwd": cfg.n_layers * admissions}:
            raise AssertionError(
                f"kernel launches {launches} for {admissions} admissions of "
                f"{cfg.n_layers} layers"
            )
        ttfts = [r["ttft_ms"] for r in results.values() if "ttft_ms" in r]
        ttfts.append(sse["final"]["ttft_ms"])
        print(f"served {admissions} concurrent requests (prompts "
              f"{[len(j['tokens']) for j in jobs + [stream_job]]}, "
              f"{NEW_TOKENS} new tokens each, SSE events {sse['n_events']}) "
              f"in {wall:.3f} s; launches {launches}")

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


def device_profile(fn, named: str = "") -> tuple:
    """(wall ms, device-busy ms, top kernels, device ms of the kernels
    whose name holds ``named``) of one call of ``fn`` under the profiler;
    busy time is the sum of the kernels' device time (one stream, so they
    do not overlap). None where the profiler saw none."""
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
    named_ms = sum(dev_us(e) for e in events if named and named in e.key) / 1e3
    return wall * 1e3, (busy if busy > 0 else None), top, named_ms


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

    wall, busy, top, _ = device_profile(lambda: decode(64))
    out["decode_profile"] = {"wall_ms": wall, "device_busy_ms": busy,
                             "top": top}
    print(f"decode, {SLOTS} requests x 64 tokens under the profiler on "
          f"{card}: wall {wall:.1f} ms, device busy "
          f"{'not measured' if busy is None else f'{busy:.1f} ms'}; "
          f"top kernels {top}")
    prompt = rng.integers(0, cfg.vocab_size, PROMPT_LENS[-1]).tolist()
    wall, busy, top, _ = device_profile(lambda: engine.generate(prompt, 1))
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


def reset_launches() -> None:
    from nanotpu_torch.ops import attention as att

    for fn in (att.flash_attention, att.flash_bwd_fused, att.flash_bwd_dq,
               att.flash_bwd_dkv):
        fn.launches = 0


def read_launches() -> dict:
    from nanotpu_torch.ops import attention as att

    return {"flash_fwd": att.flash_attention.launches,
            "flash_bwd_fused": att.flash_bwd_fused.launches,
            "flash_bwd_dq": att.flash_bwd_dq.launches,
            "flash_bwd_dkv": att.flash_bwd_dkv.launches}


def training_phase(card: str) -> dict:
    """The trainer's CLI entry on the training flagship, 10 steps."""
    from nanotpu_torch.data.synthetic import markov_batch, markov_table
    from nanotpu_torch.parallel import train

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = train.run(TRAIN_ARGV + ["--steps", str(TRAIN_STEPS)])
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [v for _, v in res["losses"]]
    print(f"trained {len(losses)} steps of the training flagship "
          f"(B={TRAIN_B}, S={TRAIN_S}, attn {res['cfg'].attn_impl}): losses "
          f"{[round(x, 4) for x in losses]}; steady {res['tok_s']:.1f} "
          f"tokens/s over {TRAIN_STEPS - 1} steps ({res['steady_s']:.3f} s); "
          f"peak memory {peak:.3f} GiB; launches {launches} ("
          f"{launches['flash_bwd_fused'] / TRAIN_STEPS:g} fused a step)")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"training losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    if launches["flash_bwd_fused"] != res["cfg"].n_layers * TRAIN_STEPS:
        raise AssertionError(f"fused backward launched {launches}")
    if launches["flash_fwd"] < res["cfg"].n_layers * TRAIN_STEPS:
        raise AssertionError(f"forward launched {launches}")
    if launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
        raise AssertionError(f"two-pass kernels ran at S={TRAIN_S}: {launches}")

    # one more step under the profiler: where a step's time goes
    cfg, state = res["cfg"], res["state"]
    step = train.build_train_step(cfg, train.make_optimizer())
    table = markov_table(cfg.vocab_size, device="cuda")
    tokens = markov_batch(torch.Generator(device="cuda").manual_seed(9), table,
                          (TRAIN_B, TRAIN_S + 1))
    wall, busy, top, fused_ms = device_profile(lambda: step(state, tokens),
                                               named="bwd_kv_bf16")
    share = "not measured" if busy is None else f"{100 * fused_ms / busy:.1f}%"
    print(f"one training step under the profiler on {card}: wall "
          f"{wall:.1f} ms, device busy "
          f"{'not measured' if busy is None else f'{busy:.1f} ms'}; the "
          f"fused backward bwd_kv_bf16 {fused_ms:.3f} ms ({share} of busy); "
          f"top kernels {top}")
    return {"losses": losses, "tok_s": res["tok_s"], "peak_mem_gib": peak,
            "launches": launches, "profile": {"wall_ms": wall,
                                              "device_busy_ms": busy,
                                              "fused_bwd_ms": fused_ms,
                                              "top": top}}


def two_pass_phase() -> dict:
    """One flagship step with the fused backward switched off, as
    NANOTPU_FLASH_FUSED_BWD_MAX_S=0 sets it at import."""
    from nanotpu_torch.ops import attention as att
    from nanotpu_torch.parallel import train

    saved = att.FUSED_BWD_MAX_S
    att.FUSED_BWD_MAX_S = 0
    try:
        reset_launches()
        res = train.run(TRAIN_ARGV + ["--steps", "1"])
        launches = read_launches()
    finally:
        att.FUSED_BWD_MAX_S = saved
    n = res["cfg"].n_layers
    loss = res["losses"][0][1]
    print(f"two-pass step: loss {loss:.4f}, launches {launches}")
    if not np.isfinite(loss) or launches["flash_bwd_fused"] or (
            launches["flash_bwd_dq"], launches["flash_bwd_dkv"]) != (n, n):
        raise AssertionError(f"two-pass step: loss {loss}, {launches}")
    return launches


def train_parity_phase() -> None:
    """One f32 train step at the flagship width (8 layers, 16/4 heads,
    B=2, S=512: the chunked loss) from the same parameters, through the f32
    flash kernels and through dense attention. Loss within 1e-4; gradients
    within 1e-4 of each leaf's largest; updated parameters within 3e-5 (a
    tenth of one Adam step of lr 3e-4) except where a near-zero gradient
    lets Adam's m / (sqrt(v) + eps) magnify the summation-order difference:
    at most one element in 10^4 may exceed it, and none exceeds one step."""
    from nanotpu_torch.models import llama
    from nanotpu_torch.parallel import train
    from nanotpu_torch.tree import leaves

    cfg = llama.LlamaConfig(**dict(train._PRESETS[("llama", "flagship")],
                                   dtype="float32"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 513), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4))
    results = {}
    for attn in ("flash", "dense"):
        c = dataclasses.replace(cfg, attn_impl=attn)
        opt = train.make_optimizer()
        state = train.init_train_state(
            torch.Generator(device="cuda").manual_seed(3), c, opt, device="cuda")
        loss = llama.loss_fn(state.params, tokens, c)
        grads = torch.autograd.grad(loss, leaves(state.params))
        opt.update(grads, state.opt_state, state.params)
        results[attn] = (loss.item(), grads, [p.detach() for p in leaves(state.params)])
        del state
    (lf, gf, pf), (ld, gd, pd) = results["flash"], results["dense"]
    g_err = torch.stack([(a - b).abs().max() / b.abs().max().clamp_min(1e-30)
                         for a, b in zip(gf, gd)]).max().item()
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pf, pd)])
    over = (diffs > 3e-5).float().mean().item()
    print(f"train parity (f32 flagship width, flash vs dense): loss {lf:.6f} "
          f"vs {ld:.6f}; gradient err {g_err:.3g} of the leaf's largest; "
          f"updated params max diff {diffs.max().item():.3g}, share over 3e-5 "
          f"{over:.3g}")
    if not (abs(lf - ld) <= 1e-4 and g_err <= 1e-4 and over <= 1e-4
            and diffs.max().item() <= 3e-4):
        raise AssertionError("flash and dense f32 train steps disagree")


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
    regs = kv_ptxas(report)
    print(f"bf16 dk/dv kernels, (registers, spill bytes): {regs}")
    if any(spill for _, spill in regs.values()):
        raise AssertionError(f"a bf16 dk/dv kernel spills: {regs}")

    rows = kernel_phase(card)
    bwd = backward_phase(card)
    serve = serving_phase(card)
    parity_phase()
    trained = training_phase(card)
    two_pass = two_pass_phase()
    train_parity_phase()

    # each path's launches, counted from 0 just before it ran and read just
    # after; "launches" is their sum
    by_path = {"serving": serve["launches"], "train": trained["launches"],
               "two_pass": two_pass}

    def launches(name):
        counts = {path: n[name] for path, n in by_path.items()}
        return {"launches": sum(counts.values()), "launches_by_path": counts}

    at = rows[2048]
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "nanotpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "nanotpu/ops/attention.py:90",
        **launches("flash_fwd"),
        # the serving flagship's S=2048 prefill and the training shape
        "max_abs_err": max(at["max_abs_err"], rows["train"]["max_abs_err"]),
        "ms": at["ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": at["library_ms"],
    }]
    for name, row in bwd.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "nanotpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": row["replaces"],
            **launches(name),
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")},
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
