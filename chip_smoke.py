#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, ``nanotpu_torch``.

Drives the port's serving and training paths on one CUDA card and checks
them:

1. reads the card's name and power limit (``nvidia-smi``); no card, no run;
2. builds the kernel libraries from ``nanotpu_torch/ops/csrc`` (one nvcc per
   source, all started together) and reads the assembler's registers and
   spills of every bf16 kernel (forward, dq, fused and dk/dv): none may
   spill, and no note may say that ptxas serialized its wgmmas or ignored
   a ``setmaxnreg``;
3. forward kernel phase: the flash-attention forward against its plain
   version (``attention_lse_ref``) on the card, causal GQA 16/8 at head_dim
   64 and 128, S in {32, 130, 2048}, bf16 and f32, with and without lse,
   and at the training flagship's shape (B=8, S=2048, 16/4 heads, out and
   lse); then its time, the plain version's, SDPA's (a yardstick the port
   never calls) and the bound, at the serving flagship's prefill lengths
   (each held against its plain version first) and at the training
   flagship's shape (SDPA's forward there too);
4. backward kernel phase: the fused, dq and dk/dv kernels against their
   plain version (``attention_bwd_ref``) at the training flagship's shape
   (B=8, S=2048, 16/4 heads, D=64, bf16), at D=128 (8/2 heads), at a
   ragged S=2047 and with one KV head (8/1, D=128), and in f32 at S=130,
   each bf16 gradient element by element (GRAD_RMS_FLOOR), on forward
   outputs that are held against their plain version first; then each
   one's time, its bound, the plain version's and SDPA's backward
   (forward + backward minus forward), and the fused pass against the
   two-pass pair at S=8192 (B=1, 16/4 heads);
4a. ring phase: ring attention's loop body (``attend_block`` and
   ``merge`` of ``nanotpu_torch.parallel.ring_attention``) for each of 4
   virtual ranks of an sp ring on the card, at the training flagship's
   heads (16/4 of 64, bf16, B=1): S=8192 (blocks of 2048, the fused
   backward) and S=32768 (blocks of 8192, the two-pass backward), each
   rank's queries against the blocks in the order it receives them;
   forward and backward against whole-sequence flash and, at S=8192, the
   plain versions; launches exact (10 forward and 10 backward: the 6
   future blocks launch nothing); timed against whole-sequence flash and
   profiled (wall, device busy, the host's time to issue a call);
4b. decode attend phase (after the Mixtral kernel checks): the decode
   kernel (``ops/csrc/decode_attn.cu``) against its plain version at the
   serving cells' caches (B=32, T=4096 and B=8, T=8192; 32/8 heads of
   128; row lengths drawn from the chat and long-prompt mixes), bf16 and
   f32 (bf16 also row-scaled, to DECODE_ROW_TOL); then its time, the plain einsum's, one masked SDPA call's and the
   bound on the rows' valid bytes;
5. serving phase: the serving flagship preset (vocab 32768, dim 1024, 12
   layers, 16/8 heads, bf16) at full width with 8 slots and max_len 2048,
   random weights from a seeded generator, behind the port's HTTP server;
   concurrent ``/v1/generate`` requests over several prefill lengths, one of
   them SSE; checks tokens, determinism, ``/v1/stats`` and ``/metrics``, and
   that every admission prefill launched the forward kernel once per layer
   and the decode kernel launched in the warm-up's runs and capture alone.
   Every engine on the card (this phase's and all later ones') replays its
   decode step and speculative cycles as CUDA graphs captured at warm-up,
   unless it is built with ``cuda_graphs=False``; each serving path checks
   that its graphs replayed;
6. serving parity phase: in float32 at the flagship width, the (graphed)
   engine's greedy tokens equal the port's own ``generate``;
6a. graphs phase: the serving flagship in bf16 and with int8 weights and
   KV cache, each built eager (``cuda_graphs=False``) and graphed, driven
   in turns (eager, graphed, graphed, eager) with the same 8 prompts of 64
   tokens: decode tokens/s at 8 busy slots, greedy tokens (every round
   must equal every other), 8 x 64 tokens under the profiler (wall,
   device busy, idle share, top kernels), each graph's capture time, peak
   device memory and the graph pool's bytes;
7. int8 serving phase: the serving flagship with int8 weights and an int8
   KV cache (``build_engine(..., quantize=True, kv_int8=True)``) through
   the serving phase's HTTP drive and measurements; the share of greedy
   tokens equal to the bf16 engine's, the quantized logits against bf16,
   parameter and cache bytes, peak memory, ``quant.matmul`` against a bf16
   matmul at the decode shapes and one ``dequantize_kv`` against one
   attend; then ``python -m nanotpu_torch.serving.server --preset flagship
   --int8 --kv-int8`` starts, answers and stops;
8. speculative phase: a 2-layer draft of the serving flagship
   (truncated-teacher init) distilled in f32 on the target's samples at
   T=0.8 (the held-out soft-CE must fall); in f32 the speculative engine's
   greedy tokens must equal the plain engine's; then the same weights in
   bf16 served by the plain engine and the "always" and "measured"
   policies at 1, 2 and 8 active rows (acceptance, decode tokens/s, greedy
   tokens equal to plain's), and by eager twins of the plain and "always"
   engines, whose greedy tokens the graphed ones must equal; then ``python
   -m nanotpu_torch.models.distill`` runs briefly and its JSON line must
   parse;
9. training phase: the trainer's CLI entry (``nanotpu_torch.parallel.train``)
   on the training flagship (vocab 32768, dim 1024, 8 layers, 16/4 heads,
   bf16, ``--attn flash --seq 2049 --batch 8 --data markov --steps 10``):
   finite losses, lower at step 10 than at step 1, 8 fused backward
   launches and at least 8 forward launches a step; peak memory, steady
   tokens/s and one step under the profiler, with the fused backward's
   share of its device-busy time;
10. two-pass phase: one such step with ``FUSED_BWD_MAX_S = 0`` (what
    ``NANOTPU_FLASH_FUSED_BWD_MAX_S=0`` sets at import), so the dq and dk/dv
    kernels run on the path, 8 launches each;
10a. fused training phase: the same CLI entry at ``--fuse-steps 1`` and
    ``--fuse-steps 8`` in turns (1, 8, 8, 1), 24 steps each on the same
    batches: steady tokens/s, peak memory, capture time; every step after
    the two eager warm-up steps replays one captured CUDA graph of the
    whole step (flash forward, fused backward, clipped AdamW with its
    count on the card), launches exact; losses of the graphed runs beside
    the eager ones; one replayed step against one eager step from the
    same state; one call of 8 steps graphed and eager under the profiler
    (wall, device busy, idle share);
10b. one graphed step with ``FUSED_BWD_MAX_S = 0``: the dq and dk/dv
    kernels launched from the graph, launches exact;
10c. ``--profile-dir``: a trace of the steady-state call that names the
    fused backward kernel;
11. training parity phase: one f32 train step of the flagship width from
    the same parameters through ``attn_impl="flash"`` and ``"dense"``: close
    loss, gradients and updated parameters;
11b. mesh phase: a real NCCL process group of one process, ``make_mesh()``
    over it (six axes of size 1) and the sharded step
    (``build_train_step(..., mesh=mesh)`` on a state placed as DTensors by
    nanotpu's specs) on the training flagship, 10 steps with flash and 10
    with ring attention over sp: losses against the plain step's from the
    same state and batches, launches exact, tokens/s of each;
11c. pipeline phase: the GPipe pipeline (``parallel/pipeline.py``) at
    pp=1 on a one-process NCCL mesh, the training flagship as nanotpu's
    stacked tree, 4 microbatches, 10 steps with flash and 10 with the ring
    in the stages (``ring_manual``): losses within 0.02 nats of the mesh
    phase's plain step, tokens/s, peak memory, launches exact (one forward
    and one fused backward a layer a microbatch);
11d. mesh serving phase: ``Engine(mesh=)`` (``parallel/infer.py``) on a
    one-process NCCL mesh against the plain engine on the same weights,
    both graphed (the mesh engine's graphs hold NCCL collectives): the
    serving flagship (greedy tokens equal, decode tokens/s in turns),
    Llama-3-8B's widths at full depth (8.03 B parameters, bf16, 8 slots,
    max_len 2048: greedy tokens equal on prompts of 64-1500 tokens, decode
    tokens/s, the idle share, the TTFT of a lone 1024-token prompt, peak
    memory) and the speculative engine in f32 (greedy tokens equal);
11a. trained-target phase: the training flagship trained 480 steps on
    the Markov corpus at ``--fuse-steps 8`` (its loss must fall; beside the
    Markov floor), ``python -m nanotpu_torch.models.distill --target-ckpt
    ... --prompt-data markov`` against it (acceptance, tokens/s), then the
    plain engine and the "always" policy serving it with that draft at 1,
    2 and 8 rows (decode tokens/s, tokens a row-cycle);
12. Mixtral kernel phase (run after phase 4): the forward and the fused
    backward at Mixtral 8x7B's heads (32/8, head_dim 128, bf16) against
    their plain versions and timed: the forward at the serving prefill
    lengths (B=1) and with lse at B=4, S=2048, the fused backward at B=4, S=2048;
13. Mixtral training phase: Mixtral 8x7B's widths (vocab 32000, dim 4096,
    32/8 heads, ffn 14336, 8 experts, top-2, capacity factor 1.25, bf16,
    flash) cut to 2 layers, 10 steps of ``build_train_step`` with
    ``mixtral.loss_fn`` at B=4, S=2048 on the Markov corpus: finite,
    falling losses, the fused backward 2 launches a step; peak memory,
    steady tokens/s and one step under the profiler, with the shares of
    routing, dispatch and combine, experts, flash kernels and AdamW; then
    the trainer's CLI with ``--model mixtral --preset tiny``;
13a. Mixtral fused training: the same model, weights and batches at
    ``--fuse-steps 5`` (``build_train_step(n_fused=5)``), two calls: losses
    below the first step's, one replayed step against one eager step from the same state,
    launches exact, peak memory, tokens/s and the idle share of one call;
14. Mixtral serving phase: the same widths cut to 4 layers on an
    ``Engine(params, MixtralConfig)`` (8 slots, max_len 2048) through the
    serving phase's HTTP drive (the MoE drop counter on ``/v1/stats`` and
    ``/metrics``) and measurements; co-batched equal to one at a time,
    graphed equal to an eager twin (decode tokens/s and idle share of
    each); then int8 weights and KV cache: tokens/s, parameter bytes and
    the share of greedy tokens equal to bf16's;
15. MoE mesh step: the Mixtral training phase's model and batches (2
    layers at 8x7B's widths, B=4, S=2048, flash) through
    ``build_train_step(loss_fn=mixtral.loss_fn, mesh=mesh)`` on a
    one-process NCCL mesh, the state placed by nanotpu's Mixtral specs
    (experts over ep): routing decisions on the first batch equal to the
    plain forward's; 10 steps, each step's loss within 0.02 nats of the
    plain loss of the same state on the same batch, and the first two
    within 0.02 of the plain step's from the same initial state (its
    state freed before the mesh state is drawn; later steps part by bf16
    routing chaos and are printed, not held); launches exact, tokens/s
    and peak memory of each;
16. MoE pipeline: the same model as nanotpu's stacked tree at pp=1, 4
    microbatches, 10 steps, against the plain step on the mean of
    ``mixtral.loss_fn`` over the same microbatches (capacity and the aux
    loss are per microbatch), held as the mesh step is, launches exact,
    tokens/s and peak memory;
17. MoE mesh serving: ``Engine(mesh=)`` serving Mixtral's 4 layers at
    8x7B's widths (8 slots, graphed), its weights placed from a tree on
    the CPU after the plain engine's copy on the card is freed: greedy
    tokens and prefill drops equal to the plain engine's, decode tokens/s
    of each, and peak memory under 1.5x the weights' bytes;
18. graphed mesh step: the training flagship's mesh step on a
    one-process NCCL mesh at ``--fuse-steps 8`` (``build_train_step(...,
    mesh=mesh, n_fused=8)``: each step one replay of a CUDA graph holding
    the step's NCCL collectives), with flash and with the ring at sp=1,
    runs of 16 steps in turns with the eager mesh step (and, flash, the
    graphed plain step): tokens/s, idle share, capture seconds, peak
    memory and the graph pool's bytes of each, launches exact, a replayed
    step against an eager one from the same state, the first call's loss
    against the eager run's;
19. graphed pipeline: the same at pp=1, 4 microbatches (flash);
20. graphed MoE mesh step and MoE pipeline: the Mixtral phases' model
    and batches at ``n_fused=5``, in turns with the eager steps, each
    replayed step held against an eager one from the same state, beside
    the graphed plain Mixtral step's tokens/s (phase 13a);
21. ``make_hybrid_mesh()`` on a one-process NCCL group is the plain mesh
    and trains a flagship step; ``discover()`` with the runtime gate open
    finds this card, and the device-file probe ``/dev/nvidia0``.

Each phase's wall seconds are printed after the last phase. The last two
lines are the kernel table and the device record, as JSON.
Each path (serving, int8 serving, graphs, distill, speculative, training,
two-pass, fused training, graphed two-pass, Mixtral's training, fused
training, serving drive and serving rounds, the ring's two cases, the
mesh step with flash and with the ring, the pipeline with each, the
mesh engines: flagship, 8B and speculative, the MoE mesh step,
pipeline and mesh engine, and the graphed mesh step with flash and with
the ring, pipeline, MoE mesh step and MoE pipeline) counts its kernel
launches
from 0 and reads them just after it ran; the table gives each path's count
and their sum. A decode graph captures no flash launch, so each serving
path's count stays exact: the forward kernel once a layer for each
prefill, and the decode kernel once a layer of each ``_rows_forward`` a
unit runs on the host: an eager engine's warm-up and every unit it runs
(``Engine.units_run``), a graphed engine's warm-up runs and capture of
each unit, and nothing in a replay (``decode_launches``); the serving
paths count from the engine's construction. A training graph captures a step's forward and backward
launches: the wrappers count on the host, so the graphed step takes
capture's counts back and adds one step's at each replay
(``GraphedTrainStep``), and the counts stay exact.
Every phase that fails raises; nothing is caught.

Run:  python3 chip_smoke.py     (one CUDA card and nvcc; builds on first use)
"""

from __future__ import annotations

import dataclasses
import gc
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
#: the decode kernel in bf16 is held besides element by element, each
#: error over |want| plus the RMS of want's row (one query row of one head,
#: the last axis): at a serving cache's lengths the output's values are
#: ~0.02-0.07, and TOLERANCE's 2e-2 would pass a 64-position tile left out.
#: The kernel rounds its probabilities and its output to bf16 (2^-9 each):
#: it read 0.0051-0.0066 at chat's and long prompts' caches (H100), the
#: einsum, which rounds its logits too, 0.0159-0.0220; a tile left out
#: reads 0.65-3.4 there.
DECODE_ROW_TOL = 0.02
SLOTS, MAX_LEN, NEW_TOKENS = 8, 2048, 32
#: the training drive: the model sees TRAIN_S tokens after the loss shift
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2048, 10
TRAIN_ARGV = ["--preset", "flagship", "--attn", "flash", "--seq",
              str(TRAIN_S + 1), "--batch", str(TRAIN_B), "--data", "markov",
              "--device", "cuda"]
PROMPT_LENS = (5, 100, 600, 1500)
#: the graphs phase's decode drive: SLOTS prompts of 64 tokens, this many
#: new tokens each (the profiled round takes 64)
GRAPH_NEW = 256


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

    # the flagship's prefill lengths (the engine's rule over PROMPT_LENS,
    # and its longest, S = max_len = 2048): B=1, H=16, KV=8, D=64, bf16;
    # each checked before it is timed
    from nanotpu_torch.serving.engine import prefill_len

    print(f"timings on {card}")
    rows = {}
    for S in sorted({prefill_len(n) for n in PROMPT_LENS} | {2048}):
        q, k, v = qkv(gen, 1, S, H, KV, 64, torch.bfloat16)
        ref_out, _ = attention_lse_ref(q.float(), k.float(), v.float(), True)
        err = check_forward(f"B=1 S={S} 16/8 D=64 bfloat16 causal (serving "
                            f"prefill)", flash_attention(q, k, v, True), None,
                            ref_out, None, torch.bfloat16)
        del ref_out
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = cuda_ms(lambda: flash_attention(q, k, v, True))
        plain_ms = cuda_ms(lambda: attention_lse_ref(q, k, v, True), reps=5)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bound_ms, bound_by = attention_bound_ms(1, S, H, KV, 64, torch.bfloat16)
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
                     "bound_by": bound_by, "max_abs_err": err}
    reset_launches()  # comparisons and timings do not count
    return rows


#: the decode attend's timed shapes: the serving cells' caches at Mistral
#: 7B's heads (32/8 of 128, bf16), a row's length drawn as the cells' mixes
#: make it, a prompt plus a decode step somewhere inside its answer
DECODE_SHAPES = {
    "chat": dict(B=32, T=4096, prompt=("lognormal", 512, 0.9, 32, 3072),
                 answer=("lognormal", 128, 0.8, 16, 1024)),
    "long": dict(B=8, T=8192, prompt=("uniform", 3072, 7168),
                 answer=("uniform", 16, 64)),
}


def decode_lengths(rng, B: int, prompt: tuple, answer: tuple) -> np.ndarray:
    """B cache lengths: a prompt plus a uniform share of an answer, each
    drawn from its distribution (lognormal: median, sigma, min, max;
    uniform: min, max)."""
    def draw(dist):
        if dist[0] == "lognormal":
            _, median, sigma, lo, hi = dist
            x = rng.lognormal(np.log(median), sigma, B)
        else:
            _, lo, hi = dist
            x = rng.uniform(lo, hi + 1, B)
        return np.clip(x.astype(np.int64), lo, hi)

    return draw(prompt) + (rng.uniform(0, 1, B) * draw(answer)).astype(np.int64)


def row_scaled_err(got, want) -> float:
    """Largest error over |want| plus the RMS of want's row (the last
    axis); NaN where any value is not finite."""
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    return ((got.float() - want).abs() / (want.abs() + rms)).max().item()


def decode_attn_phase(card: str) -> dict:
    """The decode attend (``ops/csrc/decode_attn.cu``) against its plain
    version at the serving cells' shapes, bf16 and f32 (launches exact;
    bf16 to TOLERANCE and row-scaled to DECODE_ROW_TOL, and beside the
    kernel's errors the plain einsum's in bf16 against the same f32), then
    at each shape: the kernel's time, the plain einsum's,
    one masked SDPA call's on a [B, KV, T, hd] copy of the cache (a
    yardstick the port never calls), and the bound: the rows' valid K and
    V bytes, q and out at the HBM rate."""
    from nanotpu_torch.ops.decode_attention import (attend_rows_ref,
                                                    decode_attention)

    rng = np.random.default_rng(16)
    gen = torch.Generator(device="cuda").manual_seed(16)
    H, KV, D = 32, 8, 128
    rows = {}
    for name, shape in DECODE_SHAPES.items():
        B, T = shape["B"], shape["T"]
        lens = decode_lengths(rng, B, shape["prompt"], shape["answer"])
        base = torch.tensor(np.minimum(lens, T - 1), dtype=torch.int32,
                            device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dtype)
            k = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dtype)
            v = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dtype)
            before = decode_attention.launches
            out = decode_attention(q, k, v, base)
            if decode_attention.launches != before + 1:
                raise AssertionError("decode_attention launched "
                                     f"{decode_attention.launches - before}")
            want = attend_rows_ref(q.float(), k.float(), v.float(), base)
            err = check_forward(f"decode_attn {name} {str(dtype)[6:]}", out,
                                None, want, None, dtype)
            row_err = row_scaled_err(out, want)
            # the plain version in the working type, against the same f32
            plain = attend_rows_ref(q, k, v, base)
            plain_err = (plain.float() - want).abs().max().item()
            plain_row_err = row_scaled_err(plain, want)
            if dtype == torch.bfloat16 and not row_err <= DECODE_ROW_TOL:
                raise AssertionError(
                    f"decode_attn {name}: row-scaled error {row_err} > "
                    f"{DECODE_ROW_TOL}")
            del out, want, plain
        mask = (torch.arange(T, device="cuda")[None, :]
                <= base[:, None])[:, None, None, :]
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        qt = q.transpose(1, 2)
        valid = int((base.long() + 1).sum())
        nbytes = 2 * (2 * valid * KV * D + 2 * B * H * D)
        row = {
            "ms": cuda_ms(lambda: decode_attention(q, k, v, base)),
            "plain_ms": cuda_ms(lambda: attend_rows_ref(q, k, v, base), reps=5),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)),
            "bound_ms": 1e3 * nbytes / PEAK_BYTES,
            "bound_by": "bytes",
            "mean_len": valid / B,
            "max_abs_err": err,  # bf16, against the plain version in f32
            "row_scaled_err": row_err,
            "plain_max_abs_err": plain_err,
            "plain_row_scaled_err": plain_row_err,
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[name] = row
        print(f"decode_attn {name} (B={B}, T={T}, 32/8 heads of 128, bf16, "
              f"mean length {row['mean_len']:.1f}): kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} "
              f"ms, bound {row['bound_ms']:.4f} ms on valid bytes "
              f"({100 * row['bound_share']:.1f}% of it); bf16 error against "
              f"f32 {err:.3g} (row-scaled {row_err:.3g}, tol "
              f"{DECODE_ROW_TOL}), the plain einsum's {plain_err:.3g} "
              f"({plain_row_err:.3g})")
        del q, k, v, kt, vt, qt, mask
    torch.cuda.empty_cache()
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


#: the ring phase: virtual ranks, and (S, whether S / RING_SP is past
#: FUSED_BWD_MAX_S, so that the ring's backward runs the two-pass kernels)
RING_SP = 4
RING_CASES = ((4 * TRAIN_S, False), (16 * TRAIN_S, True))
#: the ring's bf16 gradients against the plain versions: the kernels'
#: TOLERANCE plus bf16's unit roundoff (2^-8) for each rounding the ring
#: adds to a gradient, as nanotpu's ring does: each of the RING_SP blocks'
#: gradients rounded to bf16, and RING_SP - 1 sums in bf16
RING_GRAD_TOL = TOLERANCE[torch.bfloat16] + (2 * RING_SP - 1) * 2**-8


def ring_all_ranks(q, k, v, sp: int):
    """The ring's loop body for each of ``sp`` virtual ranks on one card, in
    the order a rank meets its blocks: at step s, rank r's queries against
    the block of rank (r - s) % sp (``attend_block``), merged into its
    running (out, lse) (``merge``). Returns the whole out (q's dtype) and
    lse, differentiable in q, k and v."""
    from nanotpu_torch.ops.attention import NEG_INF
    from nanotpu_torch.parallel.ring_attention import attend_block, merge

    B, S, H, _ = q.shape
    blk = S // sp
    outs, lses = [], []
    for r in range(sp):
        q_r = q[:, r * blk:(r + 1) * blk]
        o = torch.zeros(q_r.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((B, H, blk), NEG_INF, dtype=torch.float32,
                         device=q.device)
        for s in range(sp):
            src = (r - s) % sp
            o, lse = merge(o, lse, *attend_block(
                q_r, k[:, src * blk:(src + 1) * blk],
                v[:, src * blk:(src + 1) * blk], src, r, causal=True))
        outs.append(o.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, 1), torch.cat(lses, 2)


def ring_phase(card: str) -> dict:
    """Ring attention's loop body at the training flagship's heads (16/4 of
    64, bf16, B=1) for RING_SP virtual ranks: S=8192 (blocks of 2048, the
    fused backward) and S=32768 (blocks of 8192, the two-pass backward).
    Forward and backward (a random dO) of every rank. At S=8192 both are
    held against the plain versions in f32: out and lse to TOLERANCE, the
    gradients row-scaled as in ``backward_phase``, whose plain backward
    takes the kernels' own out and lse (D = rowsum(dO * O) moves the
    gradients of short rows by more than the kernels' rounding does): here
    the ring's merged out and lse, to RING_GRAD_TOL. At both lengths they
    are held against whole-sequence ``flash_attention_lse``: out and lse to
    TOLERANCE, the gradients row-scaled (on flash's) to TOLERANCE +
    RING_GRAD_TOL, each of the two being that far from the exact gradient
    at most. Launches exact: the 10 visible blocks of 4 ranks (6 past, 4
    self) once each forward and backward; the 6 future blocks launch
    nothing. Then the ring's forward and backward timed against
    whole-sequence flash (CUDA events), and one call of each under the
    profiler (wall, device busy, idle share) with the host's time to
    issue it. Each case is a path of its own."""
    from nanotpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(5)
    launches, rows = {}, {}
    for S, two_pass in RING_CASES:
        q, k, v = (t.requires_grad_() for t in qkv(gen, 1, S, 16, 4, 64,
                                                     torch.bfloat16))
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        reset_launches()
        out, lse = ring_all_ranks(q, k, v, RING_SP)
        grads = torch.autograd.grad(out, (q, k, v), dout)
        torch.cuda.synchronize()
        got = read_launches()
        n = RING_SP * (RING_SP + 1) // 2
        want = {"flash_fwd": n, "flash_bwd_fused": 0 if two_pass else n,
                "flash_bwd_dq": n if two_pass else 0,
                "flash_bwd_dkv": n if two_pass else 0, "decode_attn": 0}
        label = f"ring S={S} sp={RING_SP} (blocks of {S // RING_SP})"
        if got != want:
            raise AssertionError(f"{label}: launches {got}, want {want}")
        launches["ring_two_pass" if two_pass else "ring"] = got
        ref_out, ref_lse = att.flash_attention_lse(q, k, v, True)
        ref_grads = torch.autograd.grad(ref_out, (q, k, v), dout)
        errs = {"flash_fwd": check_forward(
            f"{label} against whole-sequence flash", out, lse,
            ref_out.float(), ref_lse, torch.bfloat16)}
        _, _, errs["bwd_vs_flash"] = grad_errs(grads, [g.float()
                                                      for g in ref_grads])
        tol = {"flash_fwd": TOLERANCE[torch.bfloat16],
               "fwd_vs_plain": TOLERANCE[torch.bfloat16],
               "bwd_vs_plain": RING_GRAD_TOL,
               "bwd_vs_flash": TOLERANCE[torch.bfloat16] + RING_GRAD_TOL}
        if not two_pass:  # the plain versions fit at S=8192 (~30 GiB)
            del ref_grads
            with torch.no_grad():
                p_out, p_lse = att.attention_lse_ref(q.float(), k.float(),
                                                     v.float(), True)
                errs["fwd_vs_plain"] = check_forward(
                    f"{label} against attention_lse_ref", out, lse, p_out,
                    p_lse, torch.bfloat16)
                del p_out, p_lse
                p_grads = att.attention_bwd_ref(
                    q.float(), k.float(), v.float(), out.float(), lse,
                    dout.float(), True)
                _, _, errs["bwd_vs_plain"] = grad_errs(grads, p_grads)
                del p_grads
        print(f"{label}: errors {errs} (backward row-scaled), tolerances "
              f"{tol}; launches {got}")
        bad = [k_ for k_, e in errs.items() if not e <= tol[k_]]
        if bad:
            raise AssertionError(f"{label} disagrees: {bad} in {errs}")
        del out, lse, grads, ref_out, ref_lse
        reps = 5 if two_pass else 10
        ring_ms = cuda_ms(lambda: torch.autograd.grad(
            ring_all_ranks(q, k, v, RING_SP)[0], (q, k, v), dout), reps=reps)
        flash_ms = cuda_ms(lambda: torch.autograd.grad(
            att.flash_attention_lse(q, k, v, True)[0], (q, k, v), dout),
            reps=reps)
        profiles = {}
        for name, fn in (
                ("ring", lambda: torch.autograd.grad(
                    ring_all_ranks(q, k, v, RING_SP)[0], (q, k, v), dout)),
                ("whole_flash", lambda: torch.autograd.grad(
                    att.flash_attention_lse(q, k, v, True)[0], (q, k, v),
                    dout))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            profiles[name] = {**idle_profile(fn), "host_issue_ms": host_ms}
        rows[S] = {"blocks": S // RING_SP, "ring_ms": ring_ms,
                   "whole_flash_ms": flash_ms, "errors": errs,
                   "profiles": profiles}
        print(f"{label} on {card}: forward+backward of all {RING_SP} ranks "
              f"{ring_ms:.4f} ms, whole-sequence flash {flash_ms:.4f} ms "
              f"(x{ring_ms / flash_ms:.3f}); one call each under the "
              f"profiler {profiles}")
        del q, k, v, dout
    reset_launches()  # comparisons and timings do not count
    return {"launches": launches, "rows": rows}


#: the bf16 kernels in the assembler's report, by mangled name: the
#: forward's template arguments are D and its consumer warpgroups, the
#: dk/dv kernel's D and whether it computes dq (the fused pass)
BF16_KERNELS = (
    (re.compile(r"flash_fwd_bf16ILi(\d+)ELi(\d+)E"),
     lambda d, w: f"flash_fwd_bf16<{d}, {w}>"),
    (re.compile(r"bwd_dq_bf16ILi(\d+)E"), lambda d: f"bwd_dq_bf16<{d}>"),
    (re.compile(r"bwd_kv_bf16ILi(\d+)ELb(\d)E"),
     lambda d, dq: f"bwd_kv_bf16<{d}, {'true' if dq == '1' else 'false'}>"),
    (re.compile(r"decode_split_bf16ILi(\d+)ELi(\d+)E"),
     lambda d, nw: f"decode_split_bf16<{d}, {nw}>"),
)
#: ptxas notes that a wgmma pipeline lost its overlap (C7510-C7519: wgmma
#: serialized) or that a setmaxnreg was ignored (C7507); only the bf16
#: kernels use either
PTXAS_NOTE = re.compile(r"\(C75(07|1\d)\)")


def bf16_ptxas(report: dict) -> tuple:
    """({kernel: (registers, spill bytes)}, [notes]) of the bf16 kernels
    (``flash_fwd_bf16<D, kWgs>``, ``bwd_dq_bf16<D>``,
    ``bwd_kv_bf16<D, kDq>``) from the assembler's report of this build,
    spill stores and loads summed, and every wgmma-serialization or
    ignored-setmaxnreg note in it; empty where no library was built in
    this process."""
    found, notes = {}, []
    for lib in report.values():
        text = lib.get("ptxas", "")
        notes += [line.strip() for line in text.splitlines()
                  if PTXAS_NOTE.search(line)]
        for part in text.split("Function properties for ")[1:]:
            name = part.split(None, 1)[0]
            spills = re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
            regs = re.search(r"Used (\d+) registers", part)
            for pattern, label in BF16_KERNELS:
                m = pattern.search(name)
                if m and spills and regs:
                    found[label(*m.groups())] = (
                        int(regs[1]), int(spills[1]) + int(spills[2]))
    return found, notes


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


def drive_http(engine, label: str) -> dict:
    """The serving drive of one engine behind the port's HTTP server:
    concurrent ``/v1/generate`` requests at the four prompt lengths (one of
    them repeated) and one SSE request, checked (tokens, determinism,
    ``/v1/stats``, ``/metrics``, one forward-kernel launch per layer an
    admission and the decode kernel's launches of the units run eagerly:
    none in a graphed engine). Launches are counted from 0 just before and
    read just after. Returns the greedy tokens of the four prompts, the TTFTs, the
    launches and the generator the prompts came from (``measure`` goes on
    drawing from it)."""
    from nanotpu_torch.serving.http import serve
    from nanotpu_torch.serving.server import ServingAPI

    cfg = engine.cfg
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
        units_before = dict(engine.units_run)
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
            raise AssertionError(f"{label}: only {len(results)} of "
                                 f"{len(threads)} requests completed")
        for i, res in results.items():
            toks = res["tokens"]
            if len(toks) != NEW_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in toks
            ):
                raise AssertionError(f"{label} request {i}: bad tokens {toks}")
        if results[1]["tokens"] != results[len(jobs) - 1]["tokens"]:
            raise AssertionError(f"{label}: a repeated greedy prompt changed "
                                 "its tokens")
        sse = results[len(jobs)]
        if not sse["final"].get("done") or sse["final"]["n_tokens"] != NEW_TOKENS:
            raise AssertionError(f"{label}: SSE stream did not finish: "
                                 f"{sse['final']}")
        stats = json.loads(get(f"{base}/v1/stats"))
        # the metrics() fields under the names a remote stats provider
        # reads from /v1/stats (queue_depth travels as "queued")
        wanted = {"queued" if k == "queue_depth" else k
                  for k in engine.metrics()}
        missing = wanted - set(stats)
        if missing:
            raise AssertionError(f"{label}: /v1/stats lacks {sorted(missing)}")
        metrics = get(f"{base}/metrics").decode()
        for series in ("nanotpu_serve_requests_total",
                       "nanotpu_serve_ttft_seconds"):
            if series not in metrics:
                raise AssertionError(f"{label}: /metrics lacks {series}")
        # the MoE prefill drop counter (0 for a dense model), the same on
        # both routes as on the engine
        dropped = [line.split()[1] for line in metrics.splitlines()
                   if line.startswith(
                       "nanotpu_serve_moe_prefill_dropped_tokens_total ")]
        want = engine.moe_prefill_dropped_total
        if (stats["moe_prefill_dropped_total"] != want
                or [float(x) for x in dropped] != [want]):
            raise AssertionError(
                f"{label}: MoE drop counter {want}, /v1/stats "
                f"{stats['moe_prefill_dropped_total']}, /metrics {dropped}")
    finally:
        server.shutdown()
        server.server_close()
    admissions = len(threads)
    check_serving_launches(label, launches, cfg.n_layers, admissions,
                           decode_launches(engine, units_before))
    ttfts = [r["ttft_ms"] for r in results.values() if "ttft_ms" in r]
    ttfts.append(sse["final"]["ttft_ms"])
    print(f"{label}: served {admissions} concurrent requests (prompts "
          f"{[len(j['tokens']) for j in jobs + [stream_job]]}, {NEW_TOKENS} "
          f"new tokens each, SSE events {sse['n_events']}) in {wall:.3f} s; "
          f"launches {launches}")
    return {"greedy": [results[i]["tokens"] for i in range(len(PROMPT_LENS))],
            "ttft_ms": ttfts, "ttft_p50_ms": float(np.percentile(ttfts, 50)),
            "launches": launches, "rng": rng,
            "moe_prefill_dropped_total": engine.moe_prefill_dropped_total}


def warm_launches(engine, label: str) -> dict:
    """Waits for ``engine``, built just after ``reset_launches()``, to warm
    up; returns its launches so far, held exact: its warm-up's prefill and
    decode units."""
    engine.wait_warm()
    warm = read_launches()
    print(f"{label} warm-up launches {warm}")
    check_serving_launches(f"{label} warm-up", warm, engine.cfg.n_layers, 1,
                           decode_launches(engine))
    return warm


def drive_from_build(engine, label: str, warm: dict) -> dict:
    """``drive_http(engine, label)``, its launches counted from the
    engine's construction: ``warm``'s added."""
    out = drive_http(engine, label)
    out["launches"] = {name: n + warm[name]
                       for name, n in out["launches"].items()}
    return out


def serving_phase(card: str) -> dict:
    from nanotpu_torch.serving.server import build_engine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launches()
    engine = build_engine("flagship", slots=SLOTS, max_len=MAX_LEN,
                          seed=0, device="cuda")
    try:
        warm = warm_launches(engine, "serving")
        cfg = engine.cfg
        print(f"flagship engine ready in {time.perf_counter() - t0:.1f} s "
              f"(dim {cfg.dim}, {cfg.n_layers} layers, {cfg.n_heads}/"
              f"{cfg.n_kv_heads} heads, {cfg.dtype}, attn {cfg.attn_impl})")
        out = drive_from_build(engine, "serving", warm)
        out.update(measure(engine, out.pop("rng"), card))
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["graphs"] = graph_record(engine, "serving")
        print(f"serving on {card}: TTFT p50 {out['ttft_p50_ms']:.2f} ms over "
              f"{len(out['ttft_ms'])} concurrent requests (all: "
              f"{out['ttft_ms']}); decode {out['decode_tok_s']:.1f} tok/s at "
              f"{SLOTS} busy slots; peak memory {out['peak_mem_gib']:.3f} GiB")
        return out
    finally:
        engine.stop()


def graph_record(engine, label: str) -> dict:
    """{K: capture seconds and replays} of an engine's decode graphs (K 0:
    the plain step); raises unless the engine captured one graph for each
    K its policy can pick and replayed every one of them."""
    graphs = {k: {"capture_s": g.capture_s, "replays": g.replays}
              for k, g in engine.graphs.items()}
    if (not engine.cuda_graphs or set(graphs) != set(engine._variant_ks)
            or not all(g["replays"] for g in graphs.values())):
        raise AssertionError(f"{label}: decode did not run as replayed CUDA "
                             f"graphs: {graphs}")
    print(f"{label}: decode graphs (K: capture s, replays) "
          f"{ {k: (round(g['capture_s'], 3), g['replays']) for k, g in graphs.items()} }")
    return graphs


def graph_pool_bytes():
    """Bytes the caching allocator holds in private pools (the CUDA
    graphs' pools) after releasing its idle cache; None where the memory
    snapshot does not say which pool a segment is in."""
    torch.cuda.empty_cache()
    segments = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segments):
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) != (0, 0))


def graphs_phase(card: str) -> dict:
    """Eager against graphed decode at the serving flagship, bf16 and int8
    weights with an int8 KV cache: per flavour one eager engine
    (``cuda_graphs=False``) and one graphed, built in that order (peak
    memory over each one's construction, warm-up and first round, above
    what was allocated before it), then driven in turns, eager, graphed,
    graphed, eager, each round SLOTS requests of the same 64-token prompts
    x GRAPH_NEW tokens: decode tokens/s over the window from the last first
    token to the last token, and greedy tokens, which must be the same in
    every round. Then 8 x 64 tokens of each under the profiler. The
    engines' prefills count as this path's launches, exactly."""
    from nanotpu_torch.serving.server import build_engine

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 32768, 64).tolist() for _ in range(SLOTS)]
    out = {}
    admissions = decode = 0
    reset_launches()
    for label, kw in (("bf16", {}),
                      ("int8", dict(quantize=True, kv_int8=True))):
        engines, res = {}, {}
        try:
            for graphs in (False, True):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                eng = engines[graphs] = build_engine(
                    "flagship", SLOTS, MAX_LEN, seed=0, device="cuda",
                    cuda_graphs=graphs, **kw)
                eng.wait_warm()
                ready_s = time.perf_counter() - t0
                n_layers = eng.cfg.n_layers
                outs, tok_s = decode_round(eng, prompts, GRAPH_NEW)
                res[graphs] = {
                    "ready_s": ready_s, "tok_s": [tok_s], "outs": [outs],
                    "peak_mem_gib": (torch.cuda.max_memory_allocated()
                                     - base) / 2**30}
                admissions += 1 + SLOTS
            for graphs in (True, False):
                outs, tok_s = decode_round(engines[graphs], prompts,
                                           GRAPH_NEW)
                res[graphs]["tok_s"].append(tok_s)
                res[graphs]["outs"].append(outs)
                admissions += SLOTS
            rounds = res[False]["outs"] + res[True]["outs"]
            if any(r != rounds[0] for r in rounds):
                raise AssertionError(f"graphs {label}: greedy tokens differ "
                                     f"between eager and graphed rounds")
            for graphs, eng in engines.items():
                wall, busy, top, _ = device_profile(
                    lambda: decode_round(eng, prompts, 64))
                admissions += SLOTS
                res[graphs]["profile"] = {
                    "wall_ms": wall, "device_busy_ms": busy,
                    "idle_share": None if busy is None else 1 - busy / wall,
                    "top": top}
            res[True]["graphs"] = graph_record(engines[True], f"graphs {label}")
            res[True]["pool_bytes"] = graph_pool_bytes()
        finally:
            for eng in engines.values():
                eng.stop()
                decode += decode_launches(eng)
        for graphs, r in res.items():
            del r["outs"]
            name = "graphed" if graphs else "eager"
            prof = r["profile"]
            idle = ("not measured" if prof["idle_share"] is None
                    else f"{100 * prof['idle_share']:.1f}%")
            print(f"graphs {label} {name} on {card}: ready in "
                  f"{r['ready_s']:.1f} s; decode {r['tok_s']} tok/s at {SLOTS} "
                  f"busy slots (rounds in turn order); {SLOTS} x 64 tokens: "
                  f"wall {prof['wall_ms']:.1f} ms, device busy "
                  f"{prof['device_busy_ms']} ms, idle {idle}; peak memory "
                  f"{r['peak_mem_gib']:.3f} GiB"
                  + (f"; graph pool {r['pool_bytes']} B" if graphs else "")
                  + f"; top kernels {prof['top']}")
        out[label] = {"graphed" if g else "eager": r for g, r in res.items()}
    launches = read_launches()
    print(f"graphs path launches {launches} ({admissions} prefills, "
          f"{decode} decode launches: the eager engines' units and "
          f"warm-ups, the graphed ones' warm-ups and captures); greedy "
          f"tokens equal in every eager and graphed round")
    check_serving_launches("graphs path", launches, n_layers, admissions,
                           decode)
    out["launches"] = launches
    return out


def device_profile(fn, named: tuple = ()) -> tuple:
    """(wall ms, device-busy ms, top kernels, device ms of the kernels
    whose name holds one of ``named``) of one call of ``fn`` under the
    profiler; busy time is the sum of the kernels' device time (one stream,
    so they do not overlap). None where the profiler saw none."""
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
    named_ms = sum(dev_us(e) for e in events
                   if any(n in e.key for n in named)) / 1e3
    return wall * 1e3, (busy if busy > 0 else None), top, named_ms


def decode_only_profile(engine, prompts, n_new: int) -> dict:
    """Decode alone, on the device's own clock: one round of ``prompts``
    (``n_new`` tokens each) under the profiler, started with the engine
    idle; its kernel timeline (the Chrome trace) is cut where the last
    prefill's last flash kernel ends, and the window runs to the last
    kernel's end. Busy is the union of the kernels' intervals in it (an
    NCCL kernel's stream may overlap the compute stream's)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_round(engine, prompts, n_new)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in events if e.get("cat") == "kernel")
    start = max(end for _, end, name in kernels if "flash_fwd" in name)
    stop = max(end for _, end, _ in kernels)
    busy, run, by_name = 0.0, None, {}
    for lo, hi, name in kernels:
        lo, hi = max(lo, start), min(hi, stop)
        if hi <= lo:
            continue
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (hi - lo) / 1e3
        if run is None or lo > run[1]:
            busy += 0.0 if run is None else run[1] - run[0]
            run = [lo, hi]
        else:
            run[1] = max(run[1], hi)
    busy += 0.0 if run is None else run[1] - run[0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"window_ms": (stop - start) / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / (stop - start),
            "top": [(k, round(v, 3)) for k, v in top]}


def measure(engine, rng, card: str) -> dict:
    """Bring-up numbers: time to first token of a lone request per prefill
    length (the engine's), the decode rate with every slot busy, and the
    device's busy share in each."""
    cfg = engine.cfg
    out = {"ttft_by_prefill_len_ms": {}}
    for n in PROMPT_LENS:
        samples = []
        for _ in range(3):
            req = engine.submit(rng.integers(0, cfg.vocab_size, n).tolist(), 1)
            if not req.wait(300) or req.error:
                raise AssertionError(f"prefill request failed: {req.error}")
            samples.append(req.ttft_s * 1e3)
        out["ttft_by_prefill_len_ms"][engine._prefill_len(n)] = float(
            np.median(samples))
    print(f"TTFT of a lone request, median of 3, by prefill length on "
          f"{card}: {out['ttft_by_prefill_len_ms']}")

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
    print(f"one {engine._prefill_len(len(prompt))}-token prefill (a "
          f"{len(prompt)}-token prompt) under the profiler on "
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


#: the decode shapes of the serving flagship's products at B=8: q and o
#: projections, gate and up, down, lm_head
DECODE_MATMULS = (("attn.wq", 1024, 1024), ("mlp.w_up", 1024, 2816),
                  ("mlp.w_down", 2816, 1024), ("lm_head", 1024, 32768))


def tree_bytes(tree) -> int:
    from nanotpu_torch.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree))


def int8_serving_phase(card: str, bf16_greedy: list) -> dict:
    """The serving flagship with int8 weights and an int8 KV cache
    (``build_engine(..., quantize=True, kv_int8=True)``, the weights the
    bf16 serving phase served, quantized) behind the HTTP server: the drive
    and the bring-up numbers of the serving phase, the share of greedy
    tokens equal to the bf16 engine's, the quantized forward's logits
    against bf16 (max |diff| over the logits' RMS), parameter and cache
    bytes, and the eager costs that int8 adds: ``quant.matmul`` against
    ``x @ w`` at the decode shapes, and one ``dequantize_kv`` of a layer's
    cache against one decode step's attend."""
    from nanotpu_torch.models import quant
    from nanotpu_torch.models.llama import forward, init_params
    from nanotpu_torch.ops.decode_attention import decode_attention
    from nanotpu_torch.serving.engine import dequantize_kv
    from nanotpu_torch.serving.server import build_engine

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    engine = build_engine("flagship", slots=SLOTS, max_len=MAX_LEN, seed=0,
                          device="cuda", quantize=True, kv_int8=True)
    try:
        warm = warm_launches(engine, "int8 serving")
        cfg = engine.cfg
        out = drive_from_build(engine, "int8 serving", warm)
        pairs = [(a, b) for x, y in zip(out.pop("greedy"), bf16_greedy)
                 for a, b in zip(x, y)]
        out["greedy_equal_share"] = sum(a == b for a, b in pairs) / len(pairs)
        out.update(measure(engine, out.pop("rng"), card))
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["graphs"] = graph_record(engine, "int8 serving")
        qparams, cache = engine.params, engine._cache
    finally:
        engine.stop()
    kv = SLOTS * MAX_LEN * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers * 2
    out["cache_bytes"] = {"bfloat16": 2 * kv,
                          "int8": tree_bytes(list(cache[:-1]))}

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    if not torch.equal(quant.quantize(params["lm_head"]).q,
                       qparams["lm_head"].q):
        raise AssertionError("the int8 engine's weights are not the bf16 "
                             "engine's, quantized")
    out["param_bytes"] = {"bfloat16": quant.param_bytes(params),
                          "int8": quant.param_bytes(qparams)}
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(7))
    with torch.inference_mode():
        ref = forward(params, tokens, cfg)
        got = forward(qparams, tokens, cfg)
    rms = ref.pow(2).mean().sqrt()
    out["logit_err_over_rms"] = ((got - ref).abs().max() / rms).item()
    out["logit_top1_equal_share"] = (
        got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    if not torch.isfinite(got).all():
        raise AssertionError("the quantized forward's logits are not finite")
    del ref, got

    x = torch.randn((SLOTS, 1, 2816), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(8))
    x = x.bfloat16()
    out["matmul_ms"] = {}
    with torch.inference_mode():
        for name, n_in, n_out in DECODE_MATMULS:
            w, qw = params, qparams
            for part in (["layers", 0] if name != "lm_head" else []) + \
                    name.split("."):
                w, qw = w[part], qw[part]
            xs = x[..., :n_in].contiguous()
            int8_ms = cuda_ms(lambda: quant.matmul(xs, qw))
            bf16_ms = cuda_ms(lambda: xs @ w)
            cast_ms = cuda_ms(lambda: qw.q.to(torch.bfloat16))
            nbytes = n_in * n_out + 4 * n_out + 2 * SLOTS * (n_in + n_out)
            out["matmul_ms"][f"{n_in}x{n_out}"] = {
                "int8": int8_ms, "bf16": bf16_ms, "int8_cast_only": cast_ms,
                "int8_bound_ms": 1e3 * nbytes / PEAK_BYTES}
        c = cache
        q = torch.randn((SLOTS, 1, cfg.n_heads, cfg.head_dim), device="cuda",
                        dtype=torch.bfloat16)
        base = torch.full((SLOTS,), MAX_LEN - 1, dtype=torch.int32,
                          device="cuda")
        k_bf16 = dequantize_kv(c.k[0], c.k_scale[0], torch.bfloat16)
        v_bf16 = dequantize_kv(c.v[0], c.v_scale[0], torch.bfloat16)
        out["dequantize_kv_ms"] = cuda_ms(
            lambda: dequantize_kv(c.k[0], c.k_scale[0], torch.bfloat16))
        out["attend_ms"] = cuda_ms(lambda: decode_attention(q, k_bf16, v_bf16,
                                                             base))
    print(f"int8 serving on {card}: greedy tokens equal to bf16's "
          f"{out['greedy_equal_share']:.4f}; logits max|diff|/RMS "
          f"{out['logit_err_over_rms']:.4f}, top-1 equal "
          f"{out['logit_top1_equal_share']:.4f}; TTFT by prefill length "
          f"{out['ttft_by_prefill_len_ms']}; decode {out['decode_tok_s']:.1f} "
          f"tok/s at {SLOTS} busy slots; params {out['param_bytes']} B, "
          f"cache {out['cache_bytes']} B, peak memory "
          f"{out['peak_mem_gib']:.3f} GiB")
    print(f"int8 costs on {card}: matmul at B={SLOTS} (ms) "
          f"{out['matmul_ms']}; dequantize_kv of one layer's "
          f"[{SLOTS}, {MAX_LEN}, {cfg.n_kv_heads}, {cfg.head_dim}] cache "
          f"{out['dequantize_kv_ms']:.4f} ms against one decode step's "
          f"attend {out['attend_ms']:.4f} ms")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def server_cli_phase(card: str) -> dict:
    """``python -m nanotpu_torch.serving.server --preset flagship --int8
    --kv-int8`` starts, answers one request, and stops on SIGTERM."""
    import signal
    import tempfile

    port = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    log = tempfile.TemporaryFile(mode="w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "nanotpu_torch.serving.server", "--preset",
         "flagship", "--int8", "--kv-int8", "--port", str(port)],
        cwd=here, stdout=log, stderr=subprocess.STDOUT, text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        while True:
            if proc.poll() is not None:
                log.seek(0)
                raise AssertionError(f"the int8 server exited: "
                                     f"{log.read()[-2000:]}")
            try:
                get(f"{base}/healthz")
                break
            except OSError:
                if time.perf_counter() - t0 > 300:
                    raise
                time.sleep(0.5)
        ready_s = time.perf_counter() - t0
        res = json.loads(post(f"{base}/v1/generate",
                              {"tokens": [1, 2, 3], "max_new_tokens": 8}))
        if len(res["tokens"]) != 8:
            raise AssertionError(f"the int8 server answered {res}")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    print(f"server CLI --int8 --kv-int8 on {card}: ready in {ready_s:.1f} s, "
          f"answered {res['tokens']}, exit code {code} after SIGTERM")
    if code != 0:
        raise AssertionError(f"the int8 server exited with {code}")
    return {"ready_s": ready_s}


#: the speculative phase's depth and drive: prompts of 64 tokens, 128 new
#: tokens each, at these occupancies; the draft is distilled at the
#: serving temperature SPEC_T
SPEC_K, SPEC_NEW, SPEC_ROWS, SPEC_T = 4, 128, (1, 2, 8), 0.8
#: distillation: steps, batch, sequence, fresh samples every N steps, and
#: the learning rate
DISTILL_STEPS, DISTILL_B, DISTILL_S, DISTILL_FRESH = 48, 8, 128, 4
DISTILL_LR = 1e-5
#: the targets distilled: the first is the one the drive serves
DISTILL_SEEDS = (0, 3)


def decode_round(engine, prompts, n_new) -> tuple:
    """(tokens of each request, decode tokens/s): the requests run together,
    the rate over the window from the last first token to the last one."""
    reqs = [engine.submit(p, n_new) for p in prompts]
    for r in reqs:
        if not r.wait(600) or r.error:
            raise AssertionError(f"decode round: {r.error}")
    window = max(r.done_at for r in reqs) - max(r.first_token_at for r in reqs)
    return [r.out for r in reqs], sum(len(r.out) - 1 for r in reqs) / window


def bf16_copy(tree):
    """The tree as a bf16 preset holds it: matrices in bf16, the norm gains
    and a MoE router in f32 (``convert.cast_params``)."""
    from nanotpu_torch.convert import cast_params

    return cast_params(tree, torch.bfloat16)


def distill_draft(params, cfg, dcfg, lr: float, steps: int, seed: int):
    """A draft of ``dcfg`` (truncated-teacher init) distilled for ``steps``
    steps on the target's own samples at T=0.8: (draft, held-out soft-CE
    before, after, the step losses, seconds). Each batch the target
    samples (one flash prefill) and labels (one flash forward)."""
    from nanotpu_torch.models import distill
    from nanotpu_torch.models.generate import generate
    from nanotpu_torch.models.llama import forward

    draft = distill.init_draft(
        torch.Generator(device="cuda").manual_seed(seed + 1), params, cfg,
        dcfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)

    def target_batch():
        with torch.no_grad():
            prompts = torch.randint(0, cfg.vocab_size, (DISTILL_B, 1),
                                    device="cuda", generator=gen)
            sampled = generate(params, prompts, cfg, DISTILL_S,
                               temperature=SPEC_T, generator=gen,
                               max_len=DISTILL_S + 1)
            tokens = torch.cat([prompts, sampled], dim=1)
            return tokens, forward(params, tokens[:, :-1], cfg)

    def held_out_ce():
        with torch.no_grad():
            return distill.distill_loss(draft, *held_out, dcfg, SPEC_T).item()

    held_out = target_batch()
    ce_before = held_out_ce()
    init_opt, step = distill.make_distill_step(dcfg, lr=lr,
                                               label_temperature=SPEC_T)
    opt_state = init_opt(draft)
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        if i % DISTILL_FRESH == 0:
            batch = target_batch()
        draft, opt_state, loss = step(draft, opt_state, *batch)
        losses.append(loss)
    losses = [x.item() for x in losses]
    return draft, ce_before, held_out_ce(), losses, time.perf_counter() - t0


def speculative_phase(card: str) -> dict:
    """examples/speculative_serving.py at the serving flagship's width: a
    2-layer draft (truncated-teacher init) distilled on the target's own
    samples at T=0.8 (in f32: the held-out soft-CE must fall, on the
    target of seed 0 that the drive below serves and on a second target of
    seed 3); in f32, greedy requests through the speculative engine must
    equal the plain engine's, token for token, and speculative_generate
    generate's; then the same weights in bf16 (the serving phase's target)
    served by the plain engine and the "always" and "measured" policies at
    1, 2 and 8 active rows: acceptance, decode tokens/s and the share of
    greedy tokens equal to plain's, with no bound on it; and by eager twins
    (``cuda_graphs=False``) of the plain and "always" engines, whose greedy
    tokens the graphed ones must equal, token for token. Each bf16 engine's
    peak memory, and for plain and "always", graphed and eager, 8 rows x 64
    tokens under the profiler (wall, device busy, idle share).

    Two paths' launches: "distill", counted from 0 before the first
    distillation and read after the second, and "speculative", each
    speculative engine's, counted from 0 at its construction and read after
    it stopped (the plain engines and speculative_generate are references
    and do not count). Each must be exact: the target's flash prefill once
    a layer for each prefill, and no backward kernel."""
    from nanotpu_torch.models import distill
    from nanotpu_torch.models.generate import generate
    from nanotpu_torch.models.llama import init_params
    from nanotpu_torch.models.speculative import speculative_generate
    from nanotpu_torch.serving.engine import Engine
    from nanotpu_torch.serving.server import serving_config

    cfg = dataclasses.replace(serving_config("flagship", MAX_LEN),
                              dtype="float32")
    dcfg = distill.draft_config(cfg, ffn_dim=cfg.ffn_dim)
    distilled = {}
    reset_launches()
    for seed in DISTILL_SEEDS:
        target = init_params(
            cfg, torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")
        draft, ce_before, ce_after, losses, distill_s = distill_draft(
            target, cfg, dcfg, DISTILL_LR, DISTILL_STEPS, seed)
        print(f"distilled a {dcfg.n_layers}-layer f32 draft of the target of "
              f"seed {seed} for {DISTILL_STEPS} steps (B={DISTILL_B}, S="
              f"{DISTILL_S}, T={SPEC_T}, lr {DISTILL_LR}) in {distill_s:.1f} "
              f"s: held-out soft-CE {ce_before:.4f} -> {ce_after:.4f}; step "
              f"losses {[round(x, 4) for x in losses[::8]]}")
        if not ce_after < ce_before:
            raise AssertionError(f"distillation did not lower the soft-CE "
                                 f"(seed {seed}): {ce_before} -> {ce_after}")
        distilled[seed] = {"ce_before": ce_before, "ce_after": ce_after,
                           "distill_s": distill_s}
        if seed == DISTILL_SEEDS[0]:
            params, keep = target, draft
        del target, draft
    draft = keep
    distill_launches = read_launches()
    batches = 1 + -(-DISTILL_STEPS // DISTILL_FRESH)  # and the held-out one
    want_fwd = 2 * cfg.n_layers * batches * len(DISTILL_SEEDS)
    print(f"distill path launches {distill_launches} ({batches} batches a "
          f"target, each sampled and labelled)")
    if distill_launches != {**dict.fromkeys(distill_launches, 0),
                            "flash_fwd": want_fwd}:
        raise AssertionError(f"distill path launches {distill_launches}, "
                             f"want {want_fwd} forward")

    launches = dict.fromkeys(distill_launches, 0)
    admissions = decode = 0

    def engine_run(params, cfg, kw, drive):
        """An engine over ``params``, warmed up, driven by ``drive(engine)``
        -> (result, requests), stopped; a speculative engine's launches and
        prefills (one a request and the warm-up's) go into the path's. A
        result that is a dict gains the engine's peak memory (above what
        was allocated before it) and, graphed, its graph pool's bytes."""
        nonlocal admissions, decode
        speculative = "draft_params" in kw
        if speculative:
            reset_launches()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(params, cfg, slots=SLOTS, max_len=MAX_LEN,
                     device="cuda", **kw)
        try:
            eng.wait_warm()
            res, n = drive(eng)
            if isinstance(res, dict):
                res["peak_mem_gib"] = (torch.cuda.max_memory_allocated()
                                       - base) / 2**30
            if kw.get("cuda_graphs", True):
                graph_record(eng, f"speculative phase, {cfg.dtype} "
                                  f"{kw.get('spec_policy', 'plain')} engine")
                if isinstance(res, dict):
                    res["pool_bytes"] = graph_pool_bytes()
        finally:
            eng.stop()
        if speculative:
            for name, n_launched in read_launches().items():
                launches[name] += n_launched
            admissions += n + 1
            decode += decode_launches(eng)
        return res

    # f32: speculation changes no greedy token
    rng = np.random.default_rng(4)
    f32_prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in PROMPT_LENS]

    def f32_drive(name):
        def drive(eng):
            reqs = [eng.submit(p, NEW_TOKENS) for p in f32_prompts]
            for r in reqs:
                if not r.wait(600) or r.error:
                    raise AssertionError(f"f32 {name} engine: {r.error}")
            return ([r.out for r in reqs],
                    eng.stats()["spec_tokens_per_cycle"]), len(reqs)
        return drive

    spec_kw = dict(draft_params=draft, draft_cfg=dcfg, draft_tokens=SPEC_K,
                   spec_policy="always")
    plain_out, _ = engine_run(params, cfg, {}, f32_drive("plain"))
    always, f32_tpc = engine_run(params, cfg, spec_kw, f32_drive("always"))
    if always != plain_out:
        raise AssertionError(f"f32 speculative engine {always} != plain "
                             f"engine {plain_out}")
    # the target as its own draft accepts every proposal: the bonus token
    # and the draft's cache extension are on the path (the draft attends
    # densely, as draft_config's drafts do, so its prefills launch nothing)
    self_kw = dict(spec_kw, draft_params=params,
                   draft_cfg=dataclasses.replace(cfg, attn_impl="dense"))
    self_out, self_tpc = engine_run(params, cfg, self_kw,
                                    f32_drive("self-draft"))
    if self_out != plain_out:
        raise AssertionError("f32 self-draft engine != plain engine")
    prompt = torch.tensor([f32_prompts[1]] * 2, device="cuda")
    want = generate(params, prompt, cfg, NEW_TOKENS)
    for d, dc in ((draft, dcfg), (params, cfg)):
        got = speculative_generate(params, d, prompt, cfg, dc, NEW_TOKENS,
                                   draft_tokens=SPEC_K)
        if not torch.equal(got, want):
            raise AssertionError("f32 speculative_generate != generate")
    print(f"f32 at the flagship width on {card}: the speculative engine (K="
          f"{SPEC_K}) equals the plain engine on {len(f32_prompts)} requests "
          f"x {NEW_TOKENS} tokens with the distilled draft ({f32_tpc} tokens "
          f"a row-cycle) and with the target as its own draft ({self_tpc}); "
          f"speculative_generate equals generate with both")
    if not self_tpc > SPEC_K:
        raise AssertionError(f"the target as its own draft emitted {self_tpc} "
                             f"tokens a cycle")

    # bf16: the serving phase's target and the distilled draft, rounded
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    dcfg = dataclasses.replace(dcfg, dtype="bfloat16")
    params, draft = bf16_copy(params), bf16_copy(draft)
    for name in distill.FROZEN:
        draft[name] = params[name]
    rng = np.random.default_rng(3)
    prompts = {n: [rng.integers(0, cfg.vocab_size, 64).tolist()
                   for _ in range(n)] for n in SPEC_ROWS}

    def bf16_drive(policy):
        def drive(eng):
            rows, submitted = {}, 0
            for n in SPEC_ROWS:
                # one untimed round; the measured policy until each arm of
                # this occupancy's large-chunk cell has its samples
                for _ in range(8):
                    decode_round(eng, prompts[n], SPEC_NEW)
                    submitted += n
                    cell = eng._bandit_n.get((eng._bandit_bucket(n), "large"))
                    if policy != "measured" or (cell and min(cell.values())
                                                >= eng.BANDIT_MIN_SAMPLES):
                        break
                cycles = eng.spec_cycles_total
                emitted = eng.spec_cycle_tokens_total
                outs, tok_s = decode_round(eng, prompts[n], SPEC_NEW)
                submitted += n
                cycles = eng.spec_cycles_total - cycles
                rows[n] = {"tok_s": tok_s, "outs": outs,
                           "tokens_per_cycle": (
                               (eng.spec_cycle_tokens_total - emitted) / cycles
                               if cycles else None)}
            stats = eng.stats()
            res = {"rows": rows, "stats": {
                k: stats[k] for k in ("spec_cycles_total",
                                      "spec_tokens_per_cycle",
                                      "spec_bandit_tok_s")}}
            if policy != "measured":
                # the busiest occupancy, 64 tokens a row, under the profiler
                n = SPEC_ROWS[-1]
                wall, busy, top, _ = device_profile(
                    lambda: decode_round(eng, prompts[n], 64))
                submitted += n
                res["profile"] = {
                    "rows": n, "wall_ms": wall, "device_busy_ms": busy,
                    "idle_share": None if busy is None else 1 - busy / wall,
                    "top": top}
            return res, submitted
        return drive

    policies = {}
    for policy in ("plain", "always", "measured", "plain eager",
                   "always eager"):
        name, _, eager = policy.partition(" ")
        kw = {} if name == "plain" else dict(
            draft_params=draft, draft_cfg=dcfg, draft_tokens=SPEC_K,
            spec_policy=name)
        if eager:
            kw["cuda_graphs"] = False
        policies[policy] = engine_run(params, cfg, kw, bf16_drive(name))
    for policy in ("plain", "always"):
        for n, row in policies[policy]["rows"].items():
            if row["outs"] != policies[f"{policy} eager"]["rows"][n]["outs"]:
                raise AssertionError(f"bf16 {policy} at {n} rows: graphed "
                                     f"greedy tokens differ from eager")
    for policy in ("always", "measured"):
        for n, row in policies[policy]["rows"].items():
            plain = policies["plain"]["rows"][n]["outs"]
            pairs = [(a, b) for x, y in zip(row["outs"], plain)
                     for a, b in zip(x, y)]
            row["greedy_equal_share"] = sum(a == b for a, b in pairs) / len(pairs)
    for policy, res in policies.items():
        for n, row in res["rows"].items():
            del row["outs"]
        print(f"speculative drive on {card}, bf16, {policy}: " + "; ".join(
            f"{n} rows {row['tok_s']:.1f} tok/s"
            + (f", {row['tokens_per_cycle']:.3f} tokens a row-cycle"
               if row.get("tokens_per_cycle") else "")
            + (f", greedy equal to plain {row['greedy_equal_share']:.4f}"
               if "greedy_equal_share" in row else "")
            for n, row in res["rows"].items()) + f"; stats {res['stats']}"
              + f"; peak memory {res['peak_mem_gib']:.3f} GiB"
              + (f", graph pool {res['pool_bytes']} B" if "pool_bytes" in res
                 else "")
              + (f"; {SPEC_ROWS[-1]} rows x 64 tokens under the profiler: "
                 f"{res['profile']}" if "profile" in res else ""))
    print(f"speculative phase: graphed greedy tokens equal eager ones for "
          f"plain and always at {SPEC_ROWS} rows; speculative path launches "
          f"{launches} ({admissions} prefills, {decode} decode launches)")
    check_serving_launches("speculative path", launches, cfg.n_layers,
                           admissions, decode)
    return {"distilled": distilled, "policies": policies,
            "launches": launches, "distill_launches": distill_launches,
            "f32_tokens_per_cycle": f32_tpc,
            "f32_self_draft_tokens_per_cycle": self_tpc}


def distill_cli_phase(card: str) -> dict:
    """``python -m nanotpu_torch.models.distill`` once, briefly: its last
    line must be its JSON result."""
    here = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "nanotpu_torch.models.distill", "--steps",
            "4", "--batch", "4", "--seq", "64", "--eval-new-tokens", "32",
            "--eval-batch", "4", "--eval-pairs", "1", "--full-ffn"]
    t0 = time.perf_counter()
    res = subprocess.run(argv, cwd=here, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"distill CLI failed: {res.stderr[-2000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"distill CLI on {card} in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(out)}")
    return out


def reset_launches() -> None:
    from nanotpu_torch.ops import attention as att
    from nanotpu_torch.ops.decode_attention import decode_attention

    for fn in (att.flash_attention, att.flash_bwd_fused, att.flash_bwd_dq,
               att.flash_bwd_dkv, decode_attention):
        fn.launches = 0


def read_launches() -> dict:
    from nanotpu_torch.ops import attention as att
    from nanotpu_torch.ops.decode_attention import decode_attention

    return {"flash_fwd": att.flash_attention.launches,
            "flash_bwd_fused": att.flash_bwd_fused.launches,
            "flash_bwd_dq": att.flash_bwd_dq.launches,
            "flash_bwd_dkv": att.flash_bwd_dkv.launches,
            "decode_attn": decode_attention.launches}


def decode_launches(engine, units_before: dict | None = None) -> int:
    """The decode kernel's launches by ``engine``, exactly: one a layer of
    each ``_rows_forward`` (a unit runs the target's once, a speculative
    cycle of K the draft's K + 1 times besides) in every unit run eagerly;
    a graph's replay launches none. Since ``units_before`` (the engine's
    ``units_run`` at a window's start): the units its chunks ran eagerly
    since. Without it, from the engine's construction: its warm-up's too,
    one eager run of each unit, or in graph mode StepGraph.WARMUP_RUNS and
    the capture."""
    from nanotpu_torch.serving.graphs import StepGraph

    n = 0
    for k, units in engine.units_run.items():
        per_unit = engine.cfg.n_layers + (
            (k + 1) * engine.draft_cfg.n_layers if k else 0)
        runs = 0 if engine.cuda_graphs else units
        if units_before is None:
            runs += StepGraph.WARMUP_RUNS + 1 if engine.cuda_graphs else 1
        elif not engine.cuda_graphs:
            runs -= units_before.get(k, 0)
        n += per_unit * runs
    return n


def check_serving_launches(label: str, launches: dict, n_layers: int,
                           prefills: int, decode: int) -> None:
    """Raises unless ``launches`` are exactly the forward kernel once a
    layer for each of ``prefills`` prefills and ``decode`` decode kernel
    launches (``decode_launches``), and nothing else."""
    want = {**dict.fromkeys(launches, 0), "flash_fwd": n_layers * prefills,
            "decode_attn": decode}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")


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
                                               named=("bwd_kv_bf16",))
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


#: the fused training drive: steps a call, steps a run, runs in turns
FUSE_STEPS, FUSED_RUN_STEPS, FUSED_ORDER = 8, 24, (1, 8, 8, 1)


def check_graphed(step_fn, steps: int, label: str) -> dict:
    """A fused step function's graph record (capture seconds, eager warm-up
    steps, replays); raises unless ``steps`` steps ran as the warm-up and
    replays of one captured graph."""
    g = step_fn.graphed
    rec = {"capture_s": g.capture_s, "warmup_steps": g.warmup_steps,
           "replays": g.replays}
    if g.graph is None or g.warmup_steps + g.replays != steps or (
            g.warmup_steps != g.WARMUP_STEPS):
        raise AssertionError(f"{label}: steps did not replay a captured "
                             f"graph: {rec}")
    return rec


def check_train_launches(launches: dict, n_layers: int, steps: int,
                         two_pass: bool, label: str) -> None:
    """Exactly one forward and one backward (fused, or dq and dk/dv) a
    layer a step, and no decode kernel."""
    n = n_layers * steps
    want = ({"flash_fwd": n, "flash_bwd_fused": 0, "flash_bwd_dq": n,
             "flash_bwd_dkv": n} if two_pass else
            {"flash_fwd": n, "flash_bwd_fused": n, "flash_bwd_dq": 0,
             "flash_bwd_dkv": 0})
    want["decode_attn"] = 0
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")


def idle_profile(fn) -> dict:
    wall, busy, top, fused_ms = device_profile(fn, named=("bwd_kv_bf16",))
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / wall,
            "fused_bwd_ms": fused_ms, "top": top}


#: steps of the one-step comparison of a replay with an eager step
PARITY_STEPS = 3


def one_step_parity(step_fn, state, batches) -> dict:
    """A replay of ``step_fn``'s captured step against an eager run of the
    same step body from the same state on the same batch, for each batch:
    the state is copied, the graph replays one step, the copy and the
    replayed state trade places, and the body runs eagerly on the state's
    tensors (one copy of the state at a time, and one leaf). The largest
    loss and state difference (each held to TOLERANCE in bf16: the orders
    of the fused backward's dq sums and of cuBLAS's products are the only
    differences) and whether every loss and state tensor is bit-equal."""
    from nanotpu_torch.parallel.mesh import local
    from nanotpu_torch.tree import leaves

    g = step_fn.graphed
    # a mesh state's local shards (a DTensor op would search its sharding)
    tensors = leaves(local(state.params)) + leaves(local(state.opt_state))
    loss_diff = state_diff = 0.0
    bit_equal = True
    for tokens in batches:
        other = [t.detach().clone() for t in tensors]
        g.step(tokens)
        replayed_loss = g.loss.clone()
        with torch.no_grad():
            for t, o in zip(tensors, other):
                replayed = t.clone()
                t.copy_(o)
                o.copy_(replayed)
                del replayed
        eager_loss = step_fn.body(state.params, state.opt_state, tokens)
        loss_diff = max(loss_diff, (eager_loss - replayed_loss).abs().item())
        state_diff = max(state_diff, max(
            (t.float() - o.float()).abs().max().item()
            for t, o in zip(tensors, other)))
        bit_equal = (bit_equal and torch.equal(eager_loss, replayed_loss)
                     and all(torch.equal(t, o) for t, o in zip(tensors, other)))
        del other
    out = {"steps": len(batches), "loss_max_diff": loss_diff,
           "state_max_diff": state_diff, "bit_equal": bit_equal}
    print(f"one replayed step against one eager step from the same state: "
          f"{out}")
    if not (loss_diff <= TOLERANCE[torch.bfloat16]
            and state_diff <= TOLERANCE[torch.bfloat16]):
        raise AssertionError(f"a replayed step differs from an eager one: "
                             f"{out}")
    return out


def fused_training_phase(card: str) -> dict:
    """The trainer's CLI entry on the training flagship, FUSED_RUN_STEPS
    steps a run, at ``--fuse-steps 1`` and ``--fuse-steps FUSE_STEPS`` in
    turns (FUSED_ORDER) on the same batches from the same weights: each
    run's steady tokens/s and peak memory, each fused run's capture time,
    warm-up steps and replays (all its steps after the warm-up replay one
    captured graph) and its launches, exact; the first fused run's losses
    at the end of each call against the first eager run's at those steps
    (the first call's to TOLERANCE in bf16), and whether the losses and
    final parameters are bit-equal. Then on a fresh flagship state, one
    call of FUSE_STEPS steps graphed, ``one_step_parity``, and one such
    call graphed and FUSE_STEPS eager steps under the profiler (wall,
    device busy, idle share). The fused runs are the path "fused_train",
    each counted from 0 just before it ran."""
    from nanotpu_torch.data.synthetic import markov_batch, markov_table
    from nanotpu_torch.models.llama import LlamaConfig
    from nanotpu_torch.parallel import train
    from nanotpu_torch.tree import leaves

    runs, launches, finals = [], None, {}
    for fuse in FUSED_ORDER:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = train.run(TRAIN_ARGV + ["--steps", str(FUSED_RUN_STEPS),
                                      "--fuse-steps", str(fuse)])
        run = {"fuse_steps": fuse, "tok_s": res["tok_s"],
               "steady_s": res["steady_s"],
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "losses": dict(res["losses"])}
        n_layers = res["cfg"].n_layers
        if fuse > 1:
            counted = read_launches()
            check_train_launches(counted, n_layers, FUSED_RUN_STEPS, False,
                                 "fused training")
            launches = counted if launches is None else {
                k: launches[k] + counted[k] for k in counted}
            run["graph"] = check_graphed(res["step_fn"], FUSED_RUN_STEPS,
                                         "fused training")
        if fuse not in finals:
            finals[fuse] = [t.detach().clone()
                            for t in leaves(res["state"].params)]
        if not all(np.isfinite(list(run["losses"].values()))):
            raise AssertionError(f"fused training losses {run['losses']}")
        runs.append(run)
        print(f"training flagship, --fuse-steps {fuse}, {FUSED_RUN_STEPS} "
              f"steps on {card}: {run}")
        del res
    # bf16 training from a random init amplifies the fused backward's
    # unordered dq sums: two eager runs part by up to ~0.1 nats within 24
    # steps. So only the first call's loss is held to TOLERANCE here; later
    # calls are reported beside the two eager runs' spread, and
    # one_step_parity below holds each replay to an eager step.
    (e1, g1, g2, e2) = (r["losses"] for r in runs)
    diffs = {s: abs(g1[s] - e1[s]) for s in g1}
    spread = {s: abs(e1[s] - e2[s]) for s in g1}
    param_diff = max((a.float() - b.float()).abs().max().item()
                     for a, b in zip(finals[1], finals[FUSE_STEPS]))
    bit_equal = all(g1[s] == e1[s] for s in g1) and all(
        torch.equal(a, b) for a, b in zip(finals[1], finals[FUSE_STEPS]))
    del finals
    print(f"graphed against eager training: loss differences {diffs} (tol "
          f"{TOLERANCE[torch.bfloat16]} at step {FUSE_STEPS}); the two eager "
          f"runs' {spread}; final parameters max diff {param_diff:.3g}; "
          f"bit-equal {bit_equal}")
    if not diffs[FUSE_STEPS] <= TOLERANCE[torch.bfloat16]:
        raise AssertionError(f"graphed losses leave eager ones: {diffs}")

    # one call of FUSE_STEPS steps, graphed and eager, under the profiler
    cfg = LlamaConfig(**train._PRESETS[("llama", "flagship")],
                      attn_impl="flash")
    table = markov_table(cfg.vocab_size, device="cuda")
    block = markov_batch(torch.Generator(device="cuda").manual_seed(9), table,
                         (FUSE_STEPS, TRAIN_B, TRAIN_S + 1))
    profiles = {}
    for fuse in (FUSE_STEPS, 1):
        opt = train.make_optimizer()
        state = train.init_train_state(
            torch.Generator(device="cuda").manual_seed(0), cfg, opt,
            device="cuda")
        step = train.build_train_step(cfg, opt, n_fused=fuse)

        def call():
            nonlocal state
            if fuse > 1:
                state, loss = step(state, block)
            else:
                for row in block:
                    state, loss = step(state, row)
            return loss

        call()  # warm-up, capture and first replays
        torch.cuda.synchronize()
        if fuse > 1:
            parity = one_step_parity(step, state, block[:PARITY_STEPS])
        profiles["graphed" if fuse > 1 else "eager"] = idle_profile(call)
        del state, step
    print(f"one call of {FUSE_STEPS} flagship steps under the profiler on "
          f"{card}: {profiles}")
    return {"runs": runs, "launches": launches, "loss_diffs": diffs,
            "loss_spread": spread, "param_max_diff": param_diff,
            "bit_equal": bit_equal, "one_step_parity": parity,
            "profiles": profiles}


#: --fuse-steps 3: two eager warm-up steps, then one replay
GRAPHED_TWO_PASS_STEPS = 3


def fused_two_pass_phase() -> dict:
    """One graphed flagship step with the fused backward switched off
    (``FUSED_BWD_MAX_S = 0``): ``--steps 3 --fuse-steps 3`` runs the two
    eager warm-up steps, captures, and replays once, the dq and dk/dv
    kernels inside the graph; launches exact over the three steps."""
    from nanotpu_torch.ops import attention as att
    from nanotpu_torch.parallel import train

    steps = GRAPHED_TWO_PASS_STEPS
    saved = att.FUSED_BWD_MAX_S
    att.FUSED_BWD_MAX_S = 0
    try:
        reset_launches()
        res = train.run(TRAIN_ARGV + ["--steps", str(steps), "--fuse-steps",
                                      str(steps)])
        launches = read_launches()
    finally:
        att.FUSED_BWD_MAX_S = saved
    graph = check_graphed(res["step_fn"], steps, "graphed two-pass step")
    check_train_launches(launches, res["cfg"].n_layers, steps, True,
                         "graphed two-pass step")
    loss = res["losses"][-1][1]
    print(f"graphed two-pass step: loss {loss:.4f}, {graph}, launches "
          f"{launches}")
    if not np.isfinite(loss):
        raise AssertionError(f"graphed two-pass step: loss {loss}")
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


#: the mesh phase: steps a run, and how far a mesh step's loss may part
#: from the plain step's on the same state and batches: bf16's TOLERANCE
#: (two eager runs of the plain step part by ~2e-3 over 9 steps)
MESH_STEPS = 10


def mesh_training_phase(card: str) -> dict:
    """The sharded train step on a real NCCL process group of one process:
    ``make_mesh()`` (six axes of size 1) and ``build_train_step(cfg, opt,
    mesh=mesh)`` on the training flagship (8 layers, B=8, S=2048, flash),
    the state placed as DTensors by nanotpu's specs (``place_state``: wq
    P(fsdp, tp) and so on), MESH_STEPS steps; then the same with
    ``attn_impl="ring"`` (ring attention over sp of size 1). The step's
    NCCL collectives run on groups of one: the tp all-reduces and the
    vocab-parallel cross entropy's, the gradient and loss all-reduces over
    the data axes and the global norm's; the ring's exchange between ranks
    does not (one rank sends nothing), nor do the fsdp gather at use and
    its reduce-scatter (the identity over an fsdp group of one, skipped
    rather than copying every weight a step). Each run's losses must stay
    within TOLERANCE of the plain step's from the same state on the same
    batches, and its launches
    exact (one forward and one fused backward a layer a step); steady
    tokens/s of the plain step and of each mesh run."""
    import torch.distributed as dist

    from nanotpu_torch.data.synthetic import markov_batch, markov_table
    from nanotpu_torch.models import llama
    from nanotpu_torch.parallel import mesh as tmesh
    from nanotpu_torch.parallel import train
    from nanotpu_torch.tree import leaves, map_tree

    cfg = llama.LlamaConfig(**dict(train._PRESETS[("llama", "flagship")],
                                   attn_impl="flash"))
    opt = train.make_optimizer()
    base = train.init_train_state(torch.Generator(device="cuda").manual_seed(6),
                                  cfg, opt, device="cuda")
    table = markov_table(cfg.vocab_size, device="cuda")
    batches = markov_batch(torch.Generator(device="cuda").manual_seed(7),
                           table, (MESH_STEPS, TRAIN_B, TRAIN_S + 1))

    def fresh():
        return train.TrainState(map_tree(lambda t: t.detach().clone(),
                                         base.params),
                                map_tree(lambda t: t.clone(), base.opt_state),
                                0)

    def drive(step, state) -> tuple:
        losses = []
        for i, tokens in enumerate(batches):
            state, loss = step(state, tokens)
            losses.append(loss)
            if i == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        tok_s = (MESH_STEPS - 1) * TRAIN_B * TRAIN_S / (time.perf_counter() - t0)
        return [x.item() for x in losses], tok_s

    plain_losses, plain_tok_s = drive(train.build_train_step(cfg, opt), fresh())
    print(f"plain step, {MESH_STEPS} steps of the training flagship on {card}: "
          f"losses {[round(x, 4) for x in plain_losses]}; {plain_tok_s:.1f} "
          f"tokens/s")
    out = {"plain": {"losses": plain_losses, "tok_s": plain_tok_s},
           "launches": {}}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = tmesh.make_mesh()
        for attn in ("flash", "ring"):
            c = dataclasses.replace(cfg, attn_impl=attn)
            state = train.place_state(fresh(), c, mesh)
            wq = state.params["layers"][0]["attn"]["wq"]
            step = train.build_train_step(c, opt, mesh=mesh)
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            losses, tok_s = drive(step, state)
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            diff = max(abs(a - b) for a, b in zip(losses, plain_losses))
            label = f"mesh step ({dist.get_backend()}, world 1, attn {attn})"
            print(f"{label} on {card}: wq {type(wq).__name__} "
                  f"{list(wq.placements)} on {mesh.mesh_dim_names}; losses "
                  f"{[round(x, 4) for x in losses]}, largest difference from "
                  f"the plain step's {diff:.3g} (tol "
                  f"{TOLERANCE[torch.bfloat16]}); {tok_s:.1f} tokens/s "
                  f"(plain {plain_tok_s:.1f}); peak memory {peak:.3f} GiB; "
                  f"launches {launches}")
            check_train_launches(launches, cfg.n_layers, MESH_STEPS, False,
                                 label)
            if not (all(np.isfinite(losses))
                    and diff <= TOLERANCE[torch.bfloat16]):
                raise AssertionError(f"{label}: losses {losses} against "
                                     f"{plain_losses}")
            if not all(type(t).__name__ == "DTensor"
                       for t in leaves(state.params)):
                raise AssertionError(f"{label}: parameters left their mesh")
            out[attn] = {"losses": losses, "tok_s": tok_s,
                         "max_loss_diff": diff, "peak_mem_gib": peak}
            out["launches"]["mesh_" + attn] = launches
            del state, step
    finally:
        dist.destroy_process_group()
    return out


class nccl_world:
    """A real NCCL process group of this one process (``tcp://`` on a free
    local port) and ``make_mesh()`` over it, six axes of size 1; the group
    is destroyed on exit."""

    def __enter__(self):
        import torch.distributed as dist

        from nanotpu_torch.parallel import mesh as tmesh

        dist.init_process_group("nccl",
                                init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
        return tmesh.make_mesh()

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()


#: the serving mesh phase: rounds of SLOTS prompts of 64 tokens, this many
#: new tokens each; the 8B widths' prompts that greedy tokens are compared
#: on, and its lone prompt for the time to first token
MESH_NEW, EIGHTB_PROMPT_LENS, EIGHTB_TTFT_LEN = 128, (64, 300, 900, 1500), 1024
#: the 8B's decode-only profile: a round of this many new tokens a row
EIGHTB_PROFILE_NEW = 64


def mesh_engine_window(launches: dict, fn):
    """``fn()``'s result, its flash launches counted from 0 just before and
    read just after, added into ``launches``. ``fn`` waits for what it
    starts, and no other engine runs meanwhile: the counts are the
    host's."""
    reset_launches()
    try:
        return fn()
    finally:
        for name, n in read_launches().items():
            launches[name] = launches.get(name, 0) + n


def mesh_serving_phase(card: str) -> dict:
    """``Engine(mesh=)`` on a one-process NCCL mesh, each against the plain
    engine on the same parameters, both graphed (the mesh engine's decode
    graphs hold the NCCL collectives: the tp all-reduces and the logits'
    all-gather, on groups of one):

    * the serving flagship (bf16): greedy tokens of SLOTS x 64-token
      prompts x MESH_NEW equal, rounds in turns (plain, mesh, mesh, plain):
      decode tokens/s at SLOTS busy slots of each;
    * Llama-3-8B's widths at full depth (vocab 128256, dim 4096, 32 layers,
      32/8 heads of 128, ffn 14336, bf16, flash prefill; 8.03 B parameters
      from a seeded generator), SLOTS slots, max_len MAX_LEN: greedy tokens
      of prompts of EIGHTB_PROMPT_LENS tokens equal; decode tokens/s at
      SLOTS busy slots of each, the mesh engine's device idle share over
      decode alone (``decode_only_profile``: a profiled round's device
      timeline after its last prefill), its time to first token of a lone
      EIGHTB_TTFT_LEN-token prompt (median of 3), and the peak memory of
      the phase;
    * the speculative engine (the flagship in f32, a 2-layer truncated
      draft, "always", K=4) on the mesh: greedy tokens equal to the plain
      f32 engine's.

    Launches: each mesh engine's, from its construction (warm-up prefill
    included) to its last round, exact: the forward kernel once a target
    layer for each prefill (the draft is dense), the decode kernel in the
    warm-up's runs and capture of each unit, nothing else."""
    from nanotpu_torch.models import distill
    from nanotpu_torch.models.llama import LlamaConfig, init_params
    from nanotpu_torch.parallel import train
    from nanotpu_torch.serving.engine import Engine
    from nanotpu_torch.serving.server import serving_config
    from nanotpu_torch.tree import leaves

    out = {"launches": {}}
    rng = np.random.default_rng(11)

    def prompts_of(cfg, lens):
        return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]

    def serve(label, params, cfg, mesh, greedy_prompts, rounds, **kw):
        """The plain and the mesh engine over ``params``: greedy tokens of
        ``greedy_prompts`` (MESH_NEW // 4 new) and ``rounds`` decode rounds
        in turns; the mesh engine's launches go into out["launches"]."""
        launches = {}
        res = {}
        plain = warm(Engine(params, cfg, slots=SLOTS, max_len=MAX_LEN,
                            device="cuda", **kw))
        try:
            meshed = mesh_engine_window(launches, lambda: warm(Engine(
                params, cfg, slots=SLOTS, max_len=MAX_LEN, device="cuda",
                mesh=mesh, **kw)))
        except BaseException:
            plain.stop()
            raise
        n_prefills = 1  # the warm-up's
        try:
            t0 = time.perf_counter()
            want, _ = decode_round(plain, greedy_prompts, MESH_NEW // 4)
            got, _ = mesh_engine_window(launches, lambda: decode_round(
                meshed, greedy_prompts, MESH_NEW // 4))
            n_prefills += len(greedy_prompts)
            if got != want:
                raise AssertionError(f"{label}: Engine(mesh=) greedy tokens "
                                     f"differ from the plain engine's")
            tok_s = {"plain": [], "mesh": []}
            for turn in rounds:
                eng = meshed if turn == "mesh" else plain
                prompts = prompts_of(cfg, [64] * SLOTS)
                if turn == "mesh":
                    _, rate = mesh_engine_window(
                        launches, lambda: decode_round(eng, prompts, MESH_NEW))
                    n_prefills += SLOTS
                else:
                    _, rate = decode_round(eng, prompts, MESH_NEW)
                tok_s[turn].append(rate)
            res.update(greedy_equal=len(got), tok_s=tok_s,
                       drive_s=time.perf_counter() - t0,
                       graphs=graph_record(meshed, f"{label} mesh engine"),
                       chips=meshed.stats()["chips"])
            graph_record(plain, f"{label} plain engine")
            return res, meshed, plain, launches, n_prefills
        except BaseException:
            meshed.stop()
            plain.stop()
            raise

    def warm(engine):
        try:
            engine.wait_warm()
        except BaseException:
            engine.stop()
            raise
        return engine

    with nccl_world() as mesh:
        # the serving flagship, bf16
        cfg = serving_config("flagship", MAX_LEN)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
        res, meshed, plain, launches, n = serve(
            "mesh serving (flagship)", params, cfg, mesh,
            prompts_of(cfg, PROMPT_LENS), ("plain", "mesh", "mesh", "plain"))
        meshed.stop()
        plain.stop()
        check_serving_launches("mesh serving (flagship)", launches,
                               cfg.n_layers, n, decode_launches(meshed))
        out["flagship"], out["launches"]["mesh_serving"] = res, launches
        print(f"mesh serving (flagship, bf16, NCCL world 1) on {card}: greedy "
              f"tokens of {res['greedy_equal']} prompts equal the plain "
              f"engine's; decode tok/s at {SLOTS} busy slots, turns plain "
              f"{res['tok_s']['plain']}, mesh {res['tok_s']['mesh']}; chips "
              f"{res['chips']}; launches {launches}")
        del params, meshed, plain

        # Llama-3-8B's widths at full depth
        cfg = LlamaConfig(**dict(train._PRESETS[("llama", "8b")],
                                 attn_impl="flash"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(8),
                             device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in leaves(params))

        def lone(prompt):
            req = meshed.submit(prompt, 1)
            if not req.wait(300) or req.error:
                raise AssertionError(f"8B TTFT request: {req.error}")
            return req

        res, meshed, plain, launches, n = serve(
            "mesh serving (8B)", params, cfg, mesh,
            prompts_of(cfg, EIGHTB_PROMPT_LENS), ("mesh", "plain"))
        try:
            prompts = prompts_of(cfg, [64] * SLOTS)
            prof = mesh_engine_window(
                launches, lambda: decode_only_profile(
                    meshed, prompts, EIGHTB_PROFILE_NEW))
            n += SLOTS
            ttft = []
            for _ in range(3):
                prompt = prompts_of(cfg, [EIGHTB_TTFT_LEN])[0]
                req = mesh_engine_window(launches, lambda: lone(prompt))
                ttft.append(req.ttft_s * 1e3)
                n += 1
            peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            meshed.stop()
            plain.stop()
        check_serving_launches("mesh serving (8B)", launches, cfg.n_layers,
                               n, decode_launches(meshed))
        res.update(n_params=n_params, init_s=init_s, peak_mem_gib=peak,
                   ttft_1024_ms=float(np.median(ttft)), ttft_samples_ms=ttft,
                   decode_profile=prof)
        print(f"mesh serving (Llama-3-8B widths, {cfg.n_layers} layers, "
              f"{n_params / 1e9:.3f} B parameters, bf16, NCCL world 1) on "
              f"{card}: weights drawn in {init_s:.1f} s; greedy tokens of "
              f"prompts of {EIGHTB_PROMPT_LENS} tokens equal the plain "
              f"engine's; decode tok/s at {SLOTS} busy slots, turns mesh "
              f"{res['tok_s']['mesh']}, plain {res['tok_s']['plain']}; "
              f"decode alone ({SLOTS} x {EIGHTB_PROFILE_NEW} tokens under the "
              f"profiler, after the last prefill): device window "
              f"{prof['window_ms']:.1f} ms, busy {prof['device_busy_ms']:.1f} "
              f"ms, idle {100 * prof['idle_share']:.1f}%; TTFT of a "
              f"lone "
              f"{EIGHTB_TTFT_LEN}-token prompt {res['ttft_1024_ms']:.2f} ms "
              f"(samples {[round(x, 2) for x in ttft]}); peak memory "
              f"{peak:.3f} GiB (both engines, one copy of the weights); top "
              f"kernels of the decode window {prof['top']}; launches "
              f"{launches}")
        out["8b"], out["launches"]["mesh_serving_8b"] = res, launches
        del params

        # the speculative engine on the mesh, f32
        cfg = dataclasses.replace(serving_config("flagship", MAX_LEN),
                                  dtype="float32")
        dcfg = distill.draft_config(cfg, ffn_dim=cfg.ffn_dim)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
        draft = distill.init_draft(
            torch.Generator(device="cuda").manual_seed(1), params, cfg, dcfg)
        prompts = prompts_of(cfg, PROMPT_LENS)
        plain = warm(Engine(params, cfg, slots=SLOTS, max_len=MAX_LEN,
                            device="cuda"))
        try:
            want, _ = decode_round(plain, prompts, NEW_TOKENS)
        finally:
            plain.stop()
        launches = {}
        spec = mesh_engine_window(launches, lambda: warm(Engine(
            params, cfg, slots=SLOTS, max_len=MAX_LEN, device="cuda",
            mesh=mesh, draft_params=draft, draft_cfg=dcfg,
            spec_policy="always")))
        try:
            got, _ = mesh_engine_window(
                launches, lambda: decode_round(spec, prompts, NEW_TOKENS))
            per_cycle = spec.stats()["spec_tokens_per_cycle"]
            graph_record(spec, "mesh speculative engine")
        finally:
            spec.stop()
        check_serving_launches("mesh speculative", launches, cfg.n_layers,
                               1 + len(prompts), decode_launches(spec))
        if got != want:
            raise AssertionError("mesh speculative: f32 greedy tokens differ "
                                 "from the plain engine's")
        print(f"mesh speculative (flagship f32, {dcfg.n_layers}-layer "
              f"truncated draft, always, K=4, NCCL world 1) on {card}: greedy "
              f"tokens of {len(prompts)} prompts equal the plain engine's; "
              f"{per_cycle} tokens a row-cycle; launches {launches}")
        out["speculative"] = {"tokens_per_cycle": per_cycle}
        out["launches"]["mesh_speculative"] = launches
    return out


#: the pipeline phase: microbatches of the training flagship's batch, and
#: how far its losses may part from the plain step's from the same state
#: on the same batches
PIPE_MICRO, PIPE_LOSS_TOL = 4, 0.02


def pipeline_phase(card: str, plain: dict) -> dict:
    """The GPipe pipeline at pp=1 on a one-process NCCL mesh: the training
    flagship (8 layers, B=8, S=2048, bf16) as nanotpu's stacked tree, placed
    by ``llama_pp_param_specs``, trained MESH_STEPS steps through
    ``make_pipelined_loss(mesh, PIPE_MICRO)`` with flash attention and then
    with the ring (``ring_manual`` in the stages, sp=1), from the mesh
    phase's state on its batches: losses within PIPE_LOSS_TOL of that
    phase's plain step (``plain``), tokens/s against it, peak memory (the
    pipelined loss's [B, S, V] f32 logits, 2.1 GB, among it), launches
    exact: one forward and one fused backward a layer a microbatch a
    step."""
    from nanotpu_torch.data.synthetic import markov_batch, markov_table
    from nanotpu_torch.models import llama
    from nanotpu_torch.parallel import pipeline as tpp
    from nanotpu_torch.parallel import train

    cfg = llama.LlamaConfig(**dict(train._PRESETS[("llama", "flagship")],
                                   attn_impl="flash"))
    opt = train.make_optimizer()
    table = markov_table(cfg.vocab_size, device="cuda")
    batches = markov_batch(torch.Generator(device="cuda").manual_seed(7),
                           table, (MESH_STEPS, TRAIN_B, TRAIN_S + 1))
    out = {"launches": {}}
    with nccl_world() as mesh:
        for attn in ("flash", "ring"):
            c = dataclasses.replace(cfg, attn_impl=attn)
            base = train.init_train_state(
                torch.Generator(device="cuda").manual_seed(6), cfg, opt,
                device="cuda")
            stacked = tpp.stack_layers(base.params)
            del base
            specs = tpp.llama_pp_param_specs(c)
            state = train.place_state(
                train.TrainState(stacked, opt.init(stacked), 0), c, mesh,
                param_specs=specs)
            del stacked
            step = train.build_train_step(
                c, opt, loss_fn=tpp.make_pipelined_loss(mesh, PIPE_MICRO),
                mesh=mesh, param_specs=specs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            losses = []
            for i, tokens in enumerate(batches):
                state, loss = step(state, tokens)
                losses.append(loss)
                if i == 0:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
            torch.cuda.synchronize()
            tok_s = ((MESH_STEPS - 1) * TRAIN_B * TRAIN_S
                     / (time.perf_counter() - t0))
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            losses = [x.item() for x in losses]
            diff = max(abs(a - b) for a, b in zip(losses, plain["losses"]))
            label = f"pipeline (pp=1, M={PIPE_MICRO}, attn {attn})"
            print(f"{label} on {card}: losses "
                  f"{[round(x, 4) for x in losses]}, largest difference from "
                  f"the plain step's {diff:.3g} (tol {PIPE_LOSS_TOL}); "
                  f"{tok_s:.1f} tokens/s (plain {plain['tok_s']:.1f}); peak "
                  f"memory {peak:.3f} GiB; launches {launches}")
            check_train_launches(launches, cfg.n_layers * PIPE_MICRO,
                                 MESH_STEPS, False, label)
            if not (all(np.isfinite(losses)) and diff <= PIPE_LOSS_TOL):
                raise AssertionError(f"{label}: losses {losses} against "
                                     f"{plain['losses']}")
            out[attn] = {"losses": losses, "tok_s": tok_s,
                         "max_loss_diff": diff, "peak_mem_gib": peak}
            out["launches"]["pipeline" if attn == "flash"
                            else "pipeline_ring"] = launches
            del state, step
    return out


#: Mixtral 8x7B's widths (nanotpu/parallel/train.py:219-222: vocab 32000,
#: dim 4096, 32/8 heads of 128, ffn 14336, 8 experts, top-2, capacity factor
#: 1.25, rope theta 1e6, bf16), cut in depth: the 32 layers (46.7 B
#: parameters) fit no single card. Training keeps parameters, gradients and
#: both moments (~8 B a parameter): 2 layers are 3.16 B parameters, ~25 GB.
#: Serving at 4 layers holds 6.07 B parameters, 12.1 GB in bf16.
MOE_TRAIN_LAYERS, MOE_SERVE_LAYERS = 2, 4
#: the Mixtral training batch: T = 4 x 2048 = 8192 tokens a step, so
#: C = 2560 slots an expert and [T, E, C] f32 routing tensors of 671 MB
MOE_TRAIN_B = 4
#: the Mixtral serving rounds: SLOTS prompts of 64 tokens, this many new
MOE_NEW = 128


def mixtral_config(n_layers: int):
    """Mixtral 8x7B's preset of the port's trainer at ``n_layers`` layers,
    with flash attention."""
    from nanotpu_torch.models.mixtral import MixtralConfig
    from nanotpu_torch.parallel.train import _PRESETS

    return MixtralConfig(**dict(_PRESETS[("mixtral", "8x7b")],
                                n_layers=n_layers, attn_impl="flash"))


def mixtral_kernel_phase(card: str) -> dict:
    """The forward and the fused backward at Mixtral 8x7B's heads (32 over
    8 at head_dim 128, bf16, causal): the forward at the serving prefill
    lengths of PROMPT_LENS (B=1; rounded, as a dropless MoE prefills, and
    bucketed, as this preset's capacity-bound one does) and, with lse, at
    the training shape (B=4, S=2048), the fused backward at the training
    shape; each held against its plain version (the forward's out and lse to TOLERANCE, the gradients row by
    row as in the backward phase), then timed against its bound, the plain
    version and SDPA."""
    from nanotpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(2)
    H, KV, D, bf16 = 32, 8, 128, torch.bfloat16

    def sdpa_ms(q, k, v):
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))

    from nanotpu_torch.serving.engine import prefill_len

    rows = {"serve": {}}
    for S in sorted({prefill_len(n, capacity_bound=bound)
                     for n in PROMPT_LENS for bound in (False, True)}):
        q, k, v = qkv(gen, 1, S, H, KV, D, bf16)
        ref_out, ref_lse = att.attention_lse_ref(q.float(), k.float(),
                                                 v.float(), True)
        err = check_forward(f"Mixtral B=1 S={S} 32/8 D=128 bfloat16 causal",
                            att.flash_attention(q, k, v, True), None,
                            ref_out, ref_lse, bf16)
        bound_ms, bound_by = attention_bound_ms(1, S, H, KV, D, bf16)
        rows["serve"][S] = {
            "ms": cuda_ms(lambda: att.flash_attention(q, k, v, True)),
            "plain_ms": cuda_ms(lambda: att.attention_lse_ref(q, k, v, True),
                                reps=5),
            "library_ms": sdpa_ms(q, k, v), "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}
        print(f"Mixtral flash_fwd B=1 S={S} 32/8 D=128 on {card}: "
              f"{rows['serve'][S]}")

    B, S = MOE_TRAIN_B, TRAIN_S
    q, k, v = qkv(gen, B, S, H, KV, D, bf16)
    out, lse = att.flash_attention(q, k, v, True, need_lse=True)
    ref_out, ref_lse = att.attention_lse_ref(q.float(), k.float(), v.float(),
                                             True)
    fwd_err = check_forward(f"Mixtral B={B} S={S} 32/8 D=128 bfloat16 causal "
                            f"lse=True (training shape)", out, lse, ref_out,
                            ref_lse, bf16)
    del ref_out, ref_lse
    dout = torch.randn((B, S, H, D), generator=gen, device="cuda").to(bf16)
    dvec = att._dvec(out, dout)
    want = att.attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                 lse, dout.float(), True)
    got = run_bwd("flash_bwd_fused", q, k, v, dout, lse, dvec)
    torch.cuda.synchronize()
    bwd_err, of_largest, row_err = grad_errs(got, want)
    print(f"Mixtral flash_bwd_fused B={B} S={S} 32/8 D=128 bf16 causal: max "
          f"abs err {bwd_err:.3g}, of the largest gradient {of_largest:.3g}, "
          f"row-scaled {row_err:.3g} (tol {TOLERANCE[bf16]} row-scaled)")
    if not row_err <= TOLERANCE[bf16]:
        raise AssertionError(f"Mixtral fused backward disagrees with "
                             f"attention_bwd_ref: {row_err}")
    del want, got

    bound_ms, bound_by = attention_bound_ms(B, S, H, KV, D, bf16)
    rows["train"] = {
        "ms": cuda_ms(lambda: att.flash_attention(q, k, v, True,
                                                  need_lse=True)),
        "plain_ms": cuda_ms(lambda: att.attention_lse_ref(q, k, v, True),
                            reps=3),
        "library_ms": sdpa_ms(q, k, v), "bound_ms": bound_ms,
        "bound_by": bound_by, "max_abs_err": fwd_err}
    qt, kt, vt, dt = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    qt, kt, vt = (x.requires_grad_(True) for x in (qt, kt, vt))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    sdpa_bwd = (cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dt))
                - cuda_ms(sdpa))
    bound_ms, bound_by = bwd_bound_ms(B, S, H, KV, D, 5, "q kv")
    rows["bwd"] = {
        "ms": cuda_ms(lambda: run_bwd("flash_bwd_fused", q, k, v, dout, lse,
                                      dvec)),
        "plain_ms": cuda_ms(lambda: att.attention_bwd_ref(
            q, k, v, out, lse, dout, True), reps=3),
        "library_ms": sdpa_bwd, "bound_ms": bound_ms, "bound_by": bound_by,
        "max_abs_err": bwd_err}
    print(f"Mixtral training shape B={B} S={S} 32/8 D=128 bf16 causal on "
          f"{card}: flash_fwd with lse {rows['train']}; flash_bwd_fused "
          f"{rows['bwd']}")
    reset_launches()  # comparisons and timings do not count
    return rows


def moe_component_ms(cfg, params: dict, T: int) -> dict:
    """CUDA-event milliseconds of one layer's forward and backward parts at
    T tokens, the autograd graph as the training step builds it: the
    routing (``route_topk`` from f32 logits), the dispatch and combine
    einsums (the [T, E, C] products), and the experts' SwiGLU products."""
    from nanotpu_torch.models import mixtral

    E, dt = cfg.n_experts, cfg.torch_dtype
    C = max(1, int(np.ceil(cfg.capacity_factor * T * cfg.top_k / E)))
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, grad=True):
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        return x.requires_grad_(grad)

    logits = torch.randn((T, E), generator=gen, device="cuda",
                         requires_grad=True)

    def routing():
        _, combine, aux = mixtral.route_topk(logits, cfg)
        torch.autograd.grad((combine.sum() + aux), logits)

    dispatch = (torch.rand((T, E, C), generator=gen, device="cuda")
                < 1 / C).to(dt)
    combine, flat, expert_out = randn(T, E, C), randn(T, cfg.dim), randn(
        E, C, cfg.dim)
    g_in, g_out = randn(E, C, cfg.dim, grad=False), randn(T, cfg.dim,
                                                          grad=False)

    def dispatch_combine():
        expert_in = torch.einsum("tec,td->ecd", dispatch, flat)
        out = torch.einsum("tec,ecd->td", combine, expert_out)
        torch.autograd.grad((expert_in, out), (flat, combine, expert_out),
                            (g_in, g_out))

    moe = params["layers"][0]["moe"]
    expert_in = randn(E, C, cfg.dim)

    def experts():
        gate = F.silu(torch.einsum("ecd,edf->ecf", expert_in, moe["w_gate"]))
        up = torch.einsum("ecd,edf->ecf", expert_in, moe["w_up"])
        y = torch.einsum("ecf,efd->ecd", gate * up, moe["w_down"])
        torch.autograd.grad(y, (expert_in, moe["w_gate"], moe["w_up"],
                                moe["w_down"]), g_in)

    return {"routing": cuda_ms(routing, reps=5),
            "dispatch_combine": cuda_ms(dispatch_combine, reps=5),
            "experts": cuda_ms(experts, reps=5)}


def mixtral_training_phase(card: str) -> dict:
    """Mixtral 8x7B's widths at MOE_TRAIN_LAYERS layers through the
    trainer's functions (``init_train_state(init_fn=mixtral.init_params)``,
    ``build_train_step(loss_fn=mixtral.loss_fn)``), on the Markov corpus at
    B=4, S=2048 for TRAIN_STEPS steps: finite losses, lower at the last step
    than at the first, the fused backward launched once a layer a step and
    the forward at least once; peak memory, steady tokens/s, and one step
    under the profiler with the shares of its device time that the routing,
    the dispatch and combine einsums, the expert products (each timed by
    CUDA events at the step's shapes, once a layer), the flash kernels (from
    the profile) and AdamW (timed on the step's gradients) take. Then the
    CLI, ``--model mixtral --preset tiny``, trains a few steps (dense
    attention: the tiny preset's head_dim 16 has no kernel)."""
    from nanotpu_torch.data.synthetic import markov_batch, markov_table
    from nanotpu_torch.models import llama, mixtral
    from nanotpu_torch.parallel import train
    from nanotpu_torch.tree import leaves

    cfg = mixtral_config(MOE_TRAIN_LAYERS)
    B, S, n = MOE_TRAIN_B, TRAIN_S, TRAIN_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opt = train.make_optimizer()
    state = train.init_train_state(
        torch.Generator(device="cuda").manual_seed(0), cfg, opt,
        device="cuda", init_fn=mixtral.init_params)
    n_params = llama.param_count(state.params)
    step = train.build_train_step(cfg, opt, loss_fn=mixtral.loss_fn)
    table = markov_table(cfg.vocab_size, device="cuda")
    batches = markov_batch(torch.Generator(device="cuda").manual_seed(1),
                           table, (n, B, S + 1))
    reset_launches()
    losses = []
    for i in range(n):
        state, loss = step(state, batches[i])
        losses.append(loss)
        if i == 0:  # the first step (allocation, kernel loads) is left out
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    launches = read_launches()
    losses = [x.item() for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2**30
    tok_s = (n - 1) * B * S / steady_s
    print(f"Mixtral training ({cfg.n_layers} layers at 8x7B width, "
          f"{n_params} parameters, B={B} S={S}, attn {cfg.attn_impl}) on "
          f"{card}: losses {[round(x, 4) for x in losses]}; steady "
          f"{tok_s:.1f} tokens/s over {n - 1} steps ({steady_s:.3f} s, "
          f"{1e3 * steady_s / (n - 1):.1f} ms a step); peak memory "
          f"{peak:.3f} GiB; launches {launches}")
    if len(losses) != n or not all(np.isfinite(losses)):
        raise AssertionError(f"Mixtral training losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"Mixtral loss did not fall: {losses}")
    if (launches["flash_bwd_fused"] != cfg.n_layers * n
            or launches["flash_fwd"] < cfg.n_layers * n
            or launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]):
        raise AssertionError(f"Mixtral training launches {launches}")

    wall, busy, top, flash_ms = device_profile(
        lambda: step(state, batches[0]),
        named=("flash_fwd_bf16", "bwd_kv_bf16"))
    loss = mixtral.loss_fn(state.params, batches[1], cfg)
    grads = torch.autograd.grad(loss, leaves(state.params))
    adamw_ms = cuda_ms(lambda: opt.update(grads, state.opt_state,
                                          state.params), reps=3)
    del grads, loss
    parts = {name: cfg.n_layers * ms for name, ms in moe_component_ms(
        cfg, state.params, B * S).items()}
    parts.update(flash=flash_ms, adamw=adamw_ms)
    shares = ({k: v / busy for k, v in parts.items()} if busy else None)
    print(f"one Mixtral training step under the profiler on {card}: wall "
          f"{wall:.1f} ms, device busy "
          f"{'not measured' if busy is None else f'{busy:.1f} ms'}; device "
          f"ms a step by part {parts}; share of busy "
          f"{'not measured' if shares is None else {k: round(v, 4) for k, v in shares.items()}}; "
          f"top kernels {top}")
    del state, batches, step
    torch.cuda.empty_cache()

    res = train.run(["--model", "mixtral", "--preset", "tiny", "--device",
                     "cuda", "--steps", "10", "--seq", "129", "--batch", "16",
                     "--data", "markov"])
    cli = [v for _, v in res["losses"]]
    print(f"Mixtral CLI (--preset tiny, dense attention) on {card}: losses "
          f"{[round(x, 4) for x in cli]}, {res['tok_s']:.1f} tokens/s")
    if not (all(np.isfinite(cli)) and cli[-1] < cli[0]):
        raise AssertionError(f"Mixtral CLI losses {cli}")
    return {"losses": losses, "tok_s": tok_s, "peak_mem_gib": peak,
            "launches": launches, "n_params": n_params,
            "profile": {"wall_ms": wall, "device_busy_ms": busy,
                        "parts_ms": parts, "shares": shares, "top": top},
            "cli_losses": cli}


#: the trained target: flagship steps on the Markov corpus (a whole number
#: of fused calls, about 45 s at ~188k tokens/s), then the distill CLI. Its
#: speculative_generate advances a batch by its rows' shortest accepted
#: prefix, so it evaluates one row: its acceptance is a row's
TARGET_STEPS = 480
TARGET_DISTILL_ARGV = ["--steps", "160", "--batch", "16", "--seq", "128",
                       "--full-ffn", "--eval-ks", str(SPEC_K),
                       "--eval-new-tokens", "128", "--eval-batch", "1",
                       "--eval-pairs", "2", "--prompt-data", "markov"]


def draft_agreement(params, cfg, draft, dcfg, tokens) -> dict:
    """How a draft's next-token distributions q meet the target's p on
    ``tokens``, both at SPEC_T: the share of positions where their argmax
    agree (what greedy speculation accepts), the mean of sum_x min(p, q)
    (the chance that a sampled draft token is accepted) and the mean
    entropies in nats."""
    from nanotpu_torch.models.llama import forward

    with torch.no_grad():
        logp = torch.log_softmax(forward(params, tokens, cfg) / SPEC_T, -1)
        logq = torch.log_softmax(forward(draft, tokens, dcfg) / SPEC_T, -1)
    p, q = logp.exp(), logq.exp()
    return {"argmax_agree": (logp.argmax(-1) == logq.argmax(-1)).float()
            .mean().item(),
            "sampled_accept": torch.minimum(p, q).sum(-1).mean().item(),
            "target_entropy": -(p * logp).sum(-1).mean().item(),
            "draft_entropy": -(q * logq).sum(-1).mean().item()}


def trained_target_phase(card: str) -> dict:
    """Speculation's worth on a trained target. The training flagship
    trains TARGET_STEPS steps on the Markov corpus at ``--fuse-steps
    FUSE_STEPS`` and checkpoints (its loss must fall; the Markov floor is
    ``ideal_ce()``); ``python -m nanotpu_torch.models.distill --target-ckpt
    ... --prompt-data markov`` distills a 2-layer draft of it and evaluates
    ``speculative_generate`` (its JSON line: acceptance, tokens/s); then
    the plain engine and the "always" policy (K = SPEC_K, graphed) serve
    the trained target with that draft at SPEC_ROWS rows of 64-token
    Markov prompts: decode tokens/s and tokens a row-cycle. There is no
    bound on acceptance: it is a measurement."""
    import tempfile

    from nanotpu_torch.data.synthetic import ideal_ce, markov_batch, \
        markov_table
    from nanotpu_torch.models import distill
    from nanotpu_torch.models.llama import LlamaConfig
    from nanotpu_torch.models.quant import load_params
    from nanotpu_torch.parallel import train
    from nanotpu_torch.serving.engine import Engine
    from nanotpu_torch.tree import leaves

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, draft_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "draft")
        t0 = time.perf_counter()
        res = train.run(TRAIN_ARGV + [
            "--steps", str(TARGET_STEPS), "--fuse-steps", str(FUSE_STEPS),
            "--checkpoint-dir", ckpt, "--save-every", str(10 * TARGET_STEPS)])
        train_s = time.perf_counter() - t0
        losses = res["losses"]
        trained = {"steps": TARGET_STEPS, "seconds": train_s,
                   "tok_s": res["tok_s"], "first_loss": losses[0],
                   "last_loss": losses[-1], "markov_floor": ideal_ce()}
        del res
        torch.cuda.empty_cache()
        print(f"trained the training flagship {TARGET_STEPS} steps on the "
              f"Markov corpus (--fuse-steps {FUSE_STEPS}) on {card}: {trained}")
        if not losses[-1][1] < losses[0][1]:
            raise AssertionError(f"the target's loss did not fall: {losses}")

        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "nanotpu_torch.models.distill",
             "--target-ckpt", ckpt, "--save-draft", draft_dir]
            + TARGET_DISTILL_ARGV, cwd=here, capture_output=True, text=True,
            timeout=600)
        if cli.returncode != 0:
            raise AssertionError(f"distill CLI failed: {cli.stderr[-2000:]}")
        distilled = json.loads(cli.stdout.strip().splitlines()[-1])
        distilled["seconds"] = time.perf_counter() - t0
        # the CLI logs its training soft-CE every 25 steps
        distilled["soft_ce"] = [float(line.split()[-1]) for line in
                                cli.stderr.splitlines()
                                if line.startswith("distill step ")]
        print(f"distill CLI against the trained target on {card}: "
              f"{json.dumps(distilled)}")

        cfg = LlamaConfig(**train._PRESETS[("llama", "flagship")],
                          attn_impl="flash")
        opt = train.make_optimizer()
        state = train.restore_checkpoint(ckpt, train.init_train_state(
            torch.Generator(device="cuda").manual_seed(0), cfg, opt,
            device="cuda"))
        draft = load_params(os.path.join(draft_dir, "draft.pt"), "cuda")
    params = state.params
    for p in leaves(params):
        p.requires_grad_(False)
    del state
    torch.cuda.empty_cache()
    dcfg = distill.draft_config(distill.target_config(), ffn_dim=cfg.ffn_dim)
    table = markov_table(cfg.vocab_size, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    agreement = draft_agreement(params, cfg, draft, dcfg,
                                markov_batch(gen, table, (8, 128)))
    print(f"the distilled draft against the trained target on 8 x 128 "
          f"Markov tokens: {agreement}")
    prompts = {n: markov_batch(gen, table, (n, 64)).tolist()
               for n in SPEC_ROWS}
    rows = {}
    for policy in ("plain", "always"):
        kw = {} if policy == "plain" else dict(
            draft_params=draft, draft_cfg=dcfg, draft_tokens=SPEC_K,
            spec_policy="always")
        eng = Engine(params, cfg, slots=SLOTS, max_len=MAX_LEN,
                     device="cuda", **kw)
        try:
            eng.wait_warm()
            rows[policy] = {}
            for n in SPEC_ROWS:
                decode_round(eng, prompts[n], SPEC_NEW)  # untimed
                cycles = eng.spec_cycles_total
                emitted = eng.spec_cycle_tokens_total
                _, tok_s = decode_round(eng, prompts[n], SPEC_NEW)
                cycles = eng.spec_cycles_total - cycles
                rows[policy][n] = {"tok_s": tok_s, "tokens_per_cycle": (
                    (eng.spec_cycle_tokens_total - emitted) / cycles
                    if cycles else None)}
            if policy == "always":
                graph_record(eng, "trained-target speculative engine")
                rows[policy]["spec_tokens_per_cycle"] = eng.stats()[
                    "spec_tokens_per_cycle"]
        finally:
            eng.stop()
    print(f"the trained target served on {card}, K={SPEC_K}, {SPEC_NEW} new "
          f"tokens a row: {rows}")
    return {"trained": trained, "distill_cli": distilled,
            "agreement": agreement, "engines": rows}


#: the fused Mixtral drive: steps a call (two calls)
MOE_FUSE_STEPS = 5


def mixtral_fused_training_phase(card: str, eager_losses: list) -> dict:
    """The Mixtral training phase's model, weights and batches (8x7B
    widths at MOE_TRAIN_LAYERS layers, B=4, S=2048, 10 steps) through
    ``build_train_step(n_fused=MOE_FUSE_STEPS)``: two calls, the steps
    after the warm-up replaying one captured graph; each call's loss beside
    the eager phase's at its step (below its first step's), one replayed
    step against an eager one from the same state
    (``one_step_parity``); launches
    exact, peak memory, the second call's tokens/s and one more call under
    the profiler (wall, device busy, idle share)."""
    from nanotpu_torch.data.synthetic import markov_batch, markov_table
    from nanotpu_torch.models import mixtral
    from nanotpu_torch.parallel import train

    cfg = mixtral_config(MOE_TRAIN_LAYERS)
    B, S, n, fuse = MOE_TRAIN_B, TRAIN_S, TRAIN_STEPS, MOE_FUSE_STEPS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = train.make_optimizer()
    state = train.init_train_state(
        torch.Generator(device="cuda").manual_seed(0), cfg, opt,
        device="cuda", init_fn=mixtral.init_params)
    step = train.build_train_step(cfg, opt, loss_fn=mixtral.loss_fn,
                                  n_fused=fuse)
    table = markov_table(cfg.vocab_size, device="cuda")
    batches = markov_batch(torch.Generator(device="cuda").manual_seed(1),
                           table, (n, B, S + 1))
    reset_launches()
    losses = []
    for c in range(n // fuse):
        state, loss = step(state, batches[c * fuse:(c + 1) * fuse])
        losses.append(loss)
        if c == 0:  # the first call (warm-up steps and capture) is left out
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    graph = check_graphed(step, n, "Mixtral fused training")
    check_train_launches(launches, cfg.n_layers, n, False,
                         "Mixtral fused training")
    losses = [x.item() for x in losses]
    want = [eager_losses[(c + 1) * fuse - 1] for c in range(n // fuse)]
    diffs = [abs(a - b) for a, b in zip(losses, want)]
    tok_s = (n - fuse) * B * S / steady_s
    profile = idle_profile(lambda: step(state, batches[:fuse]))
    print(f"Mixtral fused training ({cfg.n_layers} layers at 8x7B width, "
          f"B={B} S={S}, --fuse-steps {fuse}) on {card}: losses {losses} "
          f"against eager {want} (diff {diffs}, bit-equal {losses == want}); "
          f"steady {tok_s:.1f} tokens/s over {n - fuse} steps ({steady_s:.3f}"
          f" s); peak memory {peak:.3f} GiB; {graph}; launches {launches}; "
          f"one call under the profiler {profile}")
    # routing flips on the last bits of a logit, so trajectories part
    # within a call (two eager runs by ~0.5 nats at step 10): the losses
    # must be finite and below the first step's, and a replay is held to
    # an eager step from the same state
    if not (all(np.isfinite(losses)) and max(losses) < eager_losses[0]):
        raise AssertionError(f"Mixtral graphed losses {losses}, the first "
                             f"eager step's {eager_losses[0]}")
    parity = one_step_parity(step, state, batches[:1])
    del state, step, batches
    torch.cuda.empty_cache()
    return {"losses": losses, "loss_diffs": diffs, "tok_s": tok_s,
            "peak_mem_gib": peak, "graph": graph, "launches": launches,
            "profile": profile, "one_step_parity": parity}


def profile_dir_phase(card: str) -> dict:
    """``--profile-dir`` on the training flagship at ``--fuse-steps 8``, 16
    steps: the second call is traced, and the trace must exist and name
    the fused backward kernel."""
    import tempfile

    from nanotpu_torch.parallel import train

    with tempfile.TemporaryDirectory() as prof:
        train.run(TRAIN_ARGV + ["--steps", str(2 * FUSE_STEPS),
                                "--fuse-steps", str(FUSE_STEPS),
                                "--profile-dir", prof])
        traces = [os.path.join(prof, f) for f in os.listdir(prof)
                  if f.endswith(".pt.trace.json")]
        if len(traces) != 1:
            raise AssertionError(f"--profile-dir wrote {os.listdir(prof)}")
        with open(traces[0]) as f:
            text = f.read()
    out = {"trace_bytes": len(text),
           "bwd_kv_bf16_events": text.count("bwd_kv_bf16"),
           "flash_fwd_bf16_events": text.count("flash_fwd_bf16")}
    print(f"--profile-dir trace of one fused call on {card}: {out}")
    if not out["bwd_kv_bf16_events"]:
        raise AssertionError("the --profile-dir trace names no fused "
                             "backward kernel")
    return out


def mixtral_serving_phase(card: str) -> dict:
    """Mixtral 8x7B's widths at MOE_SERVE_LAYERS layers (random weights
    from a seed, bf16, flash prefill) on an ``Engine(params,
    MixtralConfig)`` with SLOTS slots and max_len MAX_LEN: the serving
    phase's HTTP drive (its launches exact: the forward kernel once a layer
    an admission; the drop counter on ``/v1/stats`` and ``/metrics``) and
    measurements; then SLOTS prompts of 64 tokens x MOE_NEW new tokens,
    co-batched and one at a time (exactly equal: decode routes at full
    capacity), and through an eager twin (``cuda_graphs=False``), whose
    greedy tokens must equal the graphed ones: decode tokens/s and, under
    the profiler, the idle share of each; then one round with int8
    weights and an int8 KV cache: tokens/s, parameter bytes and the share
    of greedy tokens equal to bf16's. Every prefill after the HTTP drive is
    counted too, exactly: one a request and one an engine's warm-up; and
    the decode kernel's launches: the eager twin's units, each new
    engine's warm-up and capture."""
    from nanotpu_torch.models import mixtral
    from nanotpu_torch.models.quant import param_bytes, quantize_params
    from nanotpu_torch.serving.engine import Engine

    cfg = mixtral_config(MOE_SERVE_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, 64).tolist()
               for _ in range(SLOTS)]
    engines = []

    def engine(tree, **kw):
        eng = Engine(tree, cfg, slots=SLOTS, max_len=MAX_LEN, seed=0,
                     device="cuda", **kw)
        engines.append(eng)
        t0 = time.perf_counter()
        eng.wait_warm()
        return eng, time.perf_counter() - t0

    def profiled_round(eng):
        wall, busy, top, _ = device_profile(
            lambda: decode_round(eng, prompts, 64))
        return {"wall_ms": wall, "device_busy_ms": busy,
                "idle_share": None if busy is None else 1 - busy / wall,
                "top": top}

    try:
        reset_launches()
        graphed, ready_s = engine(params)
        out = drive_from_build(graphed, "Mixtral serving",
                               warm_launches(graphed, "Mixtral serving"))
        out.update(measure(graphed, out.pop("rng"), card))
        reset_launches()
        units_before = dict(graphed.units_run)
        requests_before = graphed.requests_total
        co, tok_s = decode_round(graphed, prompts, MOE_NEW)
        solo = [graphed.generate(p, MOE_NEW) for p in prompts]
        if co != solo:
            raise AssertionError("Mixtral serving: co-batched greedy tokens "
                                 "differ from one at a time")
        out["graphed"] = {"ready_s": ready_s, "tok_s": tok_s,
                          "profile": profiled_round(graphed)}
        eager, ready_s = engine(params, cuda_graphs=False)
        eager_outs, eager_tok_s = decode_round(eager, prompts, MOE_NEW)
        if eager_outs != co:
            raise AssertionError("Mixtral serving: graphed greedy tokens "
                                 "differ from eager ones")
        out["eager"] = {"ready_s": ready_s, "tok_s": eager_tok_s,
                        "profile": profiled_round(eager)}
        out["graphs"] = graph_record(graphed, "Mixtral serving")
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        eager.stop()

        qparams = quantize_params(params)
        int8, ready_s = engine(qparams, kv_int8=True)
        int8_outs, int8_tok_s = decode_round(int8, prompts, MOE_NEW)
        pairs = [(a, b) for x, y in zip(int8_outs, co) for a, b in zip(x, y)]
        out["int8"] = {
            "ready_s": ready_s, "tok_s": int8_tok_s,
            "greedy_equal_share": sum(a == b for a, b in pairs) / len(pairs),
            "param_bytes": {"bfloat16": param_bytes(params),
                            "int8": param_bytes(qparams)},
            "graphs": graph_record(int8, "Mixtral int8 serving")}
        prefills = sum(e.requests_total + 1 for e in engines[1:]) + (
            graphed.requests_total - requests_before)
        launches = read_launches()
        out["graph_launches"] = launches
        check_serving_launches(
            "Mixtral serving after the drive", launches, cfg.n_layers,
            prefills, decode_launches(graphed, units_before)
            + sum(decode_launches(e) for e in engines[1:]))
    finally:
        for eng in engines:
            eng.stop()
    print(f"Mixtral serving ({cfg.n_layers} layers at 8x7B width, "
          f"{param_bytes(params)} B of bf16 parameters) on {card}: TTFT by "
          f"prefill length {out['ttft_by_prefill_len_ms']} ms; decode at "
          f"{SLOTS} busy slots graphed {out['graphed']['tok_s']:.1f} tok/s (ready in "
          f"{out['graphed']['ready_s']:.1f} s), eager "
          f"{out['eager']['tok_s']:.1f} (ready in "
          f"{out['eager']['ready_s']:.1f} s); {SLOTS} x 64 tokens: graphed "
          f"{out['graphed']['profile']}, eager {out['eager']['profile']}; "
          f"peak memory {out['peak_mem_gib']:.3f} GiB; prefill drops "
          f"{out['moe_prefill_dropped_total']}; co-batched equal to one at a "
          f"time and graphed equal to eager; launches after the drive "
          f"{out['graph_launches']} ({prefills} prefills)")
    print(f"Mixtral int8 weights and KV cache on {card}: {out['int8']}")
    return out


#: the MoE mesh phases: steps of the mesh step and of the pipeline, and
#: the pipeline's microbatches (B=4 splits into microbatches of one row).
#: bf16 MoE training from a random init is chaotic: a last-bit difference
#: in a weight (the fused backward's dq sums in no fixed order) flips a
#: token's expert a few steps later, and two runs of the same step part
#: by ~0.1 nats within 10 steps. So each step's loss is held against the
#: plain loss of the same state on the same batch, and the trajectory
#: against the plain step's for its first MOE_SAME_STEPS steps only (the
#: first update); the rest of the trajectory is printed, not held.
MOE_MESH_STEPS, MOE_PIPE_MICRO, MOE_SAME_STEPS = 10, 4, 2


def routing_of(fn) -> tuple:
    """``fn()``'s result and the routing decisions it took: per call of
    ``mixtral.route_decisions``, per choice, (expert, capacity slot,
    kept)."""
    from nanotpu_torch.models import mixtral

    route, seen = mixtral.route_decisions, []

    def recording(logits, cfg, capacity=None):
        choices, aux, C = route(logits, cfg, capacity)
        seen.append([(c[0].argmax(-1), c[1], c[2]) for c in choices])
        return choices, aux, C

    mixtral.route_decisions = recording
    try:
        return fn(), seen
    finally:
        mixtral.route_decisions = route


def same_routing(got: list, want: list) -> dict:
    """Raises unless two runs took the same decisions: each token's
    experts, which choices kept a slot and the slots they kept; returns
    the count of choices compared and of those dropped."""
    if len(got) != len(want) or not want:
        raise AssertionError(f"routing: {len(got)} calls against "
                             f"{len(want)}")
    n = dropped = 0
    for a, b in zip(got, want):
        for (ge, gp, gk), (we, wp, wk) in zip(a, b):
            if not (torch.equal(ge, we) and torch.equal(gk, wk)
                    and torch.equal(gp[wk], wp[wk])):
                raise AssertionError("routing decisions differ")
            n += wk.numel()
            dropped += int((~wk).sum())
    return {"choices": n, "dropped": dropped}


def moe_train_drive(step, state, batches, probe=None) -> dict:
    """``step`` over ``batches`` from ``state``: its losses, steady tokens/s
    (the steps' own time, each between two synchronizations, the first
    step left out), launches counted from 0 over every step, and peak
    memory; with ``probe``, ``probe(state, tokens)`` (the plain loss of
    the state about to step) before each step, outside the timed
    windows and the launch counts."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, probes, steady = [], [], 0.0
    probed = dict.fromkeys(read_launches(), 0)  # the probes' own launches
    for i, tokens in enumerate(batches):
        if probe is not None:
            before = read_launches()
            with torch.no_grad():
                probes.append(probe(state, tokens).item())
            for name, n in read_launches().items():
                probed[name] += n - before[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        torch.cuda.synchronize()
        if i:
            steady += time.perf_counter() - t0
        losses.append(loss.item())
    B, S = batches.shape[1], batches.shape[2] - 1
    return {"losses": losses, "probes": probes,
            "tok_s": (len(batches) - 1) * B * S / steady,
            "launches": {name: n - probed[name]
                         for name, n in read_launches().items()},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def hold_moe_run(label: str, run: dict, plain: dict, card: str) -> None:
    """Prints ``run`` beside ``plain`` and raises unless every loss is
    finite, each within PIPE_LOSS_TOL of the plain loss of the same state
    (``run["probes"]``) and the first MOE_SAME_STEPS within PIPE_LOSS_TOL
    of the plain step's."""
    losses, probes = run["losses"], run["probes"]
    same_state = max(abs(a - b) for a, b in zip(losses, probes))
    first = max(abs(a - b) for a, b in zip(losses[:MOE_SAME_STEPS],
                                           plain["losses"]))
    drift = max(abs(a - b) for a, b in zip(losses, plain["losses"]))
    run.update(same_state_diff=same_state, first_steps_diff=first,
               trajectory_diff=drift)
    print(f"{label} on {card}: losses {[round(x, 4) for x in losses]}; "
          f"largest difference from the plain loss of the same state "
          f"{same_state:.3g}, from the plain step's over the first "
          f"{MOE_SAME_STEPS} steps {first:.3g} (tol {PIPE_LOSS_TOL} each); "
          f"over all {len(losses)} steps {drift:.3g} (not held: bf16 "
          f"routing chaos); {run['tok_s']:.1f} tokens/s (plain "
          f"{plain['tok_s']:.1f}); peak memory {run['peak_mem_gib']:.3f} "
          f"GiB (plain {plain['peak_mem_gib']:.3f}); launches "
          f"{run['launches']}")
    if not (all(np.isfinite(losses)) and len(probes) == len(losses)
            and same_state <= PIPE_LOSS_TOL and first <= PIPE_LOSS_TOL):
        raise AssertionError(f"{label}: losses {losses}, plain losses of "
                             f"the same states {probes}, plain step's "
                             f"{plain['losses']}")


def moe_mesh_training_phase(card: str) -> dict:
    """Mixtral's mesh step on a one-process NCCL mesh at 8x7B's widths,
    MOE_TRAIN_LAYERS layers, B=4, S=2048, flash: the plain step
    (``build_train_step(loss_fn=mixtral.loss_fn)``) MOE_MESH_STEPS steps,
    its state then freed; the same state drawn again and placed as
    DTensors by nanotpu's Mixtral specs (the experts' stacked axis over
    ep), and ``build_train_step(loss_fn=mixtral.loss_fn, mesh=mesh)`` on
    the same batches. The mesh step issues the ep collectives on groups of
    one (the copy into and the all-reduce out of a rank's experts), the
    gather of the router logits over the data axes and the sum of the
    expert inputs over them. Held: routing decisions on the first batch
    equal to the plain forward's; each step's loss against the plain loss
    of the same state and the first steps' against the plain step's
    (``hold_moe_run``); launches exact (one forward and one fused backward
    a layer a step); tokens/s and peak memory of each."""
    import torch.distributed as dist

    from nanotpu_torch.data.synthetic import markov_batch, markov_table
    from nanotpu_torch.models import mixtral
    from nanotpu_torch.parallel import mesh as tmesh
    from nanotpu_torch.parallel import train
    from nanotpu_torch.tree import leaves

    cfg = mixtral_config(MOE_TRAIN_LAYERS)
    opt = train.make_optimizer()
    table = markov_table(cfg.vocab_size, device="cuda")
    batches = markov_batch(torch.Generator(device="cuda").manual_seed(1),
                           table, (MOE_MESH_STEPS, MOE_TRAIN_B, TRAIN_S + 1))

    def fresh():
        return train.init_train_state(
            torch.Generator(device="cuda").manual_seed(0), cfg, opt,
            device="cuda", init_fn=mixtral.init_params)

    state = fresh()
    with torch.no_grad():
        _, want_routing = routing_of(
            lambda: mixtral.loss_fn(state.params, batches[0], cfg))
    plain = moe_train_drive(train.build_train_step(
        cfg, opt, loss_fn=mixtral.loss_fn), state, batches)
    check_train_launches(plain["launches"], cfg.n_layers, MOE_MESH_STEPS,
                         False, "plain Mixtral step")
    del state
    torch.cuda.empty_cache()
    out = {"plain": plain}
    with nccl_world() as mesh:
        state = train.place_state(fresh(), cfg, mesh)
        shard = tmesh.Shards(mesh, tmesh.mixtral_param_specs(cfg))
        with torch.no_grad():
            _, got_routing = routing_of(lambda: mixtral.loss_fn(
                tmesh.local(state.params), batches[0], cfg, shard=shard))
        routing = same_routing(got_routing, want_routing)
        w_gate = state.params["layers"][0]["moe"]["w_gate"]
        step = train.build_train_step(cfg, opt, loss_fn=mixtral.loss_fn,
                                      mesh=mesh)
        run = moe_train_drive(step, state, batches, probe=lambda st, t: (
            mixtral.loss_fn(tmesh.local(st.params), t, cfg)))
        label = (f"MoE mesh step ({dist.get_backend()}, world 1, "
                 f"{cfg.n_layers} layers at 8x7B width)")
        print(f"{label}: w_gate {type(w_gate).__name__} "
              f"{list(w_gate.placements)} on {mesh.mesh_dim_names}; routing "
              f"of the first batch equal to the plain forward's "
              f"({routing['choices']} choices, {routing['dropped']} dropped "
              f"by capacity); a step {run['launches']['flash_fwd'] // MOE_MESH_STEPS} "
              f"forward and {run['launches']['flash_bwd_fused'] // MOE_MESH_STEPS} "
              f"fused backward launches")
        hold_moe_run(label, run, plain, card)
        check_train_launches(run["launches"], cfg.n_layers, MOE_MESH_STEPS,
                             False, label)
        if not all(type(t).__name__ == "DTensor"
                   for t in leaves(state.params)):
            raise AssertionError(f"{label}: parameters left their mesh")
        out["mesh"] = {**run, "routing": routing}
        del state, step
    torch.cuda.empty_cache()
    return out


def moe_pipeline_phase(card: str) -> dict:
    """The pipelined Mixtral step at pp=1 on a one-process NCCL mesh, 8x7B's
    widths at MOE_TRAIN_LAYERS layers as nanotpu's stacked tree (placed by
    ``mixtral_pp_param_specs``), B=4, S=2048, MOE_PIPE_MICRO microbatches,
    MOE_MESH_STEPS steps through ``make_pipelined_loss(mesh, M,
    "mixtral")``; against the plain step on the mean of ``mixtral.loss_fn``
    over the same microbatches (capacity and the aux loss are per
    microbatch, so the whole batch's loss is not the target), its state
    freed first. Held as ``hold_moe_run`` holds the mesh step (the plain
    loss of each state: the microbatch mean on the unstacked tree);
    launches exact (one forward and one fused backward a layer a
    microbatch a step); tokens/s and peak memory of each."""
    from nanotpu_torch.data.synthetic import markov_batch, markov_table
    from nanotpu_torch.models import mixtral
    from nanotpu_torch.parallel import mesh as tmesh
    from nanotpu_torch.parallel import pipeline as tpp
    from nanotpu_torch.parallel import train

    cfg = mixtral_config(MOE_TRAIN_LAYERS)
    M = MOE_PIPE_MICRO
    opt = train.make_optimizer()
    table = markov_table(cfg.vocab_size, device="cuda")
    batches = markov_batch(torch.Generator(device="cuda").manual_seed(1),
                           table, (MOE_MESH_STEPS, MOE_TRAIN_B, TRAIN_S + 1))

    def averaged(params, tokens, cfg):
        mb = tokens.shape[0] // M
        return sum(mixtral.loss_fn(params, tokens[i * mb:(i + 1) * mb], cfg)
                   for i in range(M)) / M

    def fresh(init):
        return train.init_train_state(
            torch.Generator(device="cuda").manual_seed(0), cfg, opt,
            device="cuda", init_fn=init)

    plain = moe_train_drive(train.build_train_step(cfg, opt,
                                                   loss_fn=averaged),
                            fresh(mixtral.init_params), batches)
    torch.cuda.empty_cache()
    check_train_launches(plain["launches"], cfg.n_layers * M, MOE_MESH_STEPS,
                         False, "microbatch-averaged plain step")
    with nccl_world() as mesh:
        specs = tpp.mixtral_pp_param_specs(cfg)
        state = train.place_state(fresh(lambda c, g, device=None: (
            tpp.stack_layers(mixtral.init_params(c, g, device=device)))),
            cfg, mesh, param_specs=specs)
        step = train.build_train_step(
            cfg, opt, loss_fn=tpp.make_pipelined_loss(mesh, M, "mixtral"),
            mesh=mesh, param_specs=specs)
        run = moe_train_drive(step, state, batches, probe=lambda st, t: (
            averaged(tpp.unstack_layers(tmesh.local(st.params)), t, cfg)))
        del state, step
    torch.cuda.empty_cache()
    label = (f"MoE pipeline (pp=1, M={M}, {cfg.n_layers} layers at 8x7B "
             f"width)")
    hold_moe_run(label, run, plain, card)
    check_train_launches(run["launches"], cfg.n_layers * M, MOE_MESH_STEPS,
                         False, label)
    return {"plain": plain, "pipeline": run}


def moe_mesh_serving_phase(card: str) -> dict:
    """``Engine(mesh=)`` on a one-process NCCL mesh serving Mixtral 8x7B's
    widths at MOE_SERVE_LAYERS layers (bf16, flash prefill, SLOTS slots,
    max_len MAX_LEN, graphed) against the plain engine on the same weights:
    the plain engine runs first, from the tree on the card; the tree is
    then copied to the CPU and every copy on the card freed, and the mesh
    engine places it from the CPU shard by shard, so that its peak memory
    shows one copy of the weights. Held: greedy tokens of prompts of
    PROMPT_LENS tokens and of SLOTS x 64-token prompts x MOE_NEW equal to
    the plain engine's, the same ``moe_prefill_dropped_total``, the decode
    graphs replayed, launches exact (the forward kernel once a layer a
    prefill, warm-up included; the decode kernel in the warm-up's runs and
    capture); decode tokens/s of each, peak memory of the mesh engine
    against the weights' bytes."""
    from nanotpu_torch.models import mixtral
    from nanotpu_torch.models.quant import param_bytes
    from nanotpu_torch.serving.engine import Engine
    from nanotpu_torch.tree import leaves, map_tree

    cfg = mixtral_config(MOE_SERVE_LAYERS)
    rng = np.random.default_rng(12)
    greedy = [rng.integers(0, cfg.vocab_size, n).tolist()
              for n in PROMPT_LENS]
    rounds = [rng.integers(0, cfg.vocab_size, 64).tolist()
              for _ in range(SLOTS)]

    def serve(params, **kw):
        t0 = time.perf_counter()  # placement, warm-up and capture
        eng = Engine(params, cfg, slots=SLOTS, max_len=MAX_LEN, seed=0,
                     device="cuda", **kw)
        try:
            eng.wait_warm()
            ready_s = time.perf_counter() - t0
            outs, _ = decode_round(eng, greedy, MOE_NEW // 4)
            round_outs, tok_s = decode_round(eng, rounds, MOE_NEW)
            graphs = graph_record(eng, "MoE mesh serving" if kw else
                                  "MoE plain serving")
        finally:
            eng.stop()
        return {"outs": outs, "round_outs": round_outs, "tok_s": tok_s,
                "ready_s": ready_s, "graphs": graphs,
                "drops": eng.moe_prefill_dropped_total,
                "requests": eng.requests_total,
                "decode_launches": decode_launches(eng)}

    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    weight_bytes = param_bytes(params)
    plain = serve(params)
    on_cpu = map_tree(lambda t: t.cpu(), params)
    del params
    gc.collect()  # the stopped plain engine, which holds the card's tree
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with nccl_world() as mesh:
        reset_launches()
        meshed = serve(on_cpu, mesh=mesh)
        launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del on_cpu
    label = (f"MoE mesh serving ({cfg.n_layers} layers at 8x7B width, "
             f"NCCL world 1)")
    prefills = meshed["requests"] + 1  # and the warm-up's
    print(f"{label} on {card}: greedy tokens of prompts of {PROMPT_LENS} "
          f"tokens and of {SLOTS} x 64 x {MOE_NEW} equal the plain engine's: "
          f"{meshed['outs'] == plain['outs'] and meshed['round_outs'] == plain['round_outs']}; "
          f"decode tok/s at {SLOTS} busy slots mesh {meshed['tok_s']:.1f}, "
          f"plain {plain['tok_s']:.1f}; moe_prefill_dropped_total mesh "
          f"{meshed['drops']}, plain {plain['drops']}; ready in "
          f"{meshed['ready_s']:.1f} s (placed from the CPU; plain "
          f"{plain['ready_s']:.1f} s); peak memory {peak:.3f} GiB against "
          f"{weight_bytes / 2**30:.3f} GiB of weights; launches {launches}")
    if (meshed["outs"] != plain["outs"]
            or meshed["round_outs"] != plain["round_outs"]):
        raise AssertionError(f"{label}: greedy tokens differ from the plain "
                             f"engine's")
    if meshed["drops"] != plain["drops"]:
        raise AssertionError(f"{label}: prefill drops {meshed['drops']} "
                             f"against {plain['drops']}")
    check_serving_launches(label, launches, cfg.n_layers, prefills,
                           meshed["decode_launches"])
    if not peak * 2**30 < 1.5 * weight_bytes:
        raise AssertionError(f"{label}: peak memory {peak:.3f} GiB holds the "
                             f"weights ({weight_bytes / 2**30:.3f} GiB) twice")
    return {"plain": {k: plain[k] for k in ("tok_s", "drops", "ready_s")},
            "mesh": {k: meshed[k] for k in ("tok_s", "drops", "ready_s")},
            "peak_mem_gib": peak, "weight_gib": weight_bytes / 2**30,
            "launches": launches}


#: the graphed mesh phases' runs: the training flagship's steps a run (two
#: calls of FUSE_STEPS), and the order of the runs of each path: the eager
#: mesh step, the graphed mesh step and (flash) the graphed plain step
GRAPHED_MESH_STEPS = 2 * FUSE_STEPS
GRAPHED_FLASH_ORDER = ("eager", "graphed", "plain", "graphed", "eager")
GRAPHED_ORDER = ("eager", "graphed", "graphed", "eager")
GRAPHED_PAIR_ORDER = ("eager", "graphed")


def train_call(step, state, block):
    """One call of ``step`` on ``block`` [n, B, S+1]: the block, fused; its
    steps one by one, eager. The state and the last step's loss."""
    from nanotpu_torch.parallel.train import FusedTrainStep

    if isinstance(step, FusedTrainStep):
        return step(state, block)
    for row in block:
        state, loss = step(state, row)
    return state, loss


def replay_loss_parity(step_fn, state, tokens, loss_of) -> dict:
    """The loss of one replayed step of ``step_fn`` on ``tokens`` against
    ``loss_of(state, tokens)``, the eager mesh step's loss from the same
    state (its forward, without gradients), held to TOLERANCE in bf16: a
    state too large to copy beside its graph's pool and an eager step's
    temporaries (Mixtral's) is held by its loss alone."""
    with torch.no_grad():
        want = loss_of(state, tokens).item()
    step_fn.graphed.step(tokens)
    got = step_fn.graphed.loss.item()
    out = {"replayed_loss": got, "eager_loss": want,
           "loss_diff": abs(got - want)}
    print(f"one replayed step's loss against the eager step's from the "
          f"same state: {out}")
    if not out["loss_diff"] <= TOLERANCE[torch.bfloat16]:
        raise AssertionError(f"a replayed step's loss differs from an eager "
                             f"one's: {out}")
    return out


def train_turns(label: str, card: str, make, batches, fuse: int,
                order: tuple, launches_per_step: int,
                parity=None) -> dict:
    """Runs of ``make(kind)``'s (step function, fresh state) over
    ``batches`` in calls of ``fuse`` steps, for each kind of ``order`` in
    turn ("eager": the eager mesh step; "graphed": it fused, one replayed
    CUDA graph a step; "plain": the plain step fused): each run's losses
    at each call's end, steady tokens/s over every call but the first,
    peak memory, launches (counted from 0 just before the run, read just
    after, exact), and, graphed, the capture's seconds, the replays and
    the graph pool's bytes. The first run of a kind is then profiled for
    one call (wall, device busy, idle share), and the first graphed run
    holds a replayed step against an eager one from the same state
    (``parity(step, state, batches)``, ``one_step_parity`` on the first
    batch unless given). Runs by kind, in turn order."""
    from nanotpu_torch.parallel.train import FusedTrainStep

    n = len(batches)
    B, S = batches.shape[1], batches.shape[2] - 1
    runs: dict = {}
    for kind in order:
        # the last run's graph and state sit in a reference cycle (the
        # graphed body holds its step and state): free them first
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        step, state = make(kind)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses = []
        for c in range(n // fuse):
            block = batches[c * fuse:(c + 1) * fuse]
            state, loss = train_call(step, state, block)
            losses.append(loss)
            if c == 0:  # the first call (warm-up and capture) is left out
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        steady_s = time.perf_counter() - t0
        run = {"losses": [x.item() for x in losses],
               "tok_s": (n - fuse) * B * S / steady_s,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": read_launches()}
        what = f"{label}, {kind}"
        check_train_launches(run["launches"], launches_per_step, n, False,
                             what)
        if not all(np.isfinite(run["losses"])):
            raise AssertionError(f"{what}: losses {run['losses']}")
        if isinstance(step, FusedTrainStep):
            run["graph"] = check_graphed(step, n, what)
            run["pool_bytes"] = graph_pool_bytes()
        if kind not in runs:
            if kind == "graphed":
                run["one_step_parity"] = (parity or (
                    lambda st, s, b: one_step_parity(st, s, b[:1])))(
                        step, state, batches)
            run["profile"] = idle_profile(
                lambda: train_call(step, state, batches[:fuse]))
        print(f"{what} ({n} steps, B={B} S={S}, {fuse} a call) on {card}: "
              f"{run}")
        runs.setdefault(kind, []).append(run)
        del step, state
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def summarize_turns(label: str, card: str, runs: dict,
                    plain_tok_s: float | None = None) -> dict:
    """Prints the runs' tokens/s by kind in turn order, the graphed mesh
    step's against the eager one's and the graphed plain step's, and the
    idle shares, capture seconds and peak memory; returns them."""
    tok = {kind: [r["tok_s"] for r in rs] for kind, rs in runs.items()}
    if plain_tok_s is None:
        plain_tok_s = float(np.mean(tok["plain"]))
    graphed = float(np.mean(tok["graphed"]))
    out = {"tok_s": tok, "plain_graphed_tok_s": plain_tok_s,
           "graphed_over_eager": graphed / float(np.mean(tok["eager"])),
           "graphed_over_plain_graphed": graphed / plain_tok_s,
           "idle_share": {k: rs[0]["profile"]["idle_share"]
                          for k, rs in runs.items()},
           "capture_s": [r["graph"]["capture_s"] for r in runs["graphed"]],
           "peak_mem_gib": {k: [r["peak_mem_gib"] for r in rs]
                            for k, rs in runs.items()},
           "pool_bytes": [r["pool_bytes"] for r in runs["graphed"]]}
    print(f"{label} on {card}: tokens/s {tok}; graphed mesh over eager mesh "
          f"{out['graphed_over_eager']:.3f}x, over the graphed plain step "
          f"({plain_tok_s:.1f}) {out['graphed_over_plain_graphed']:.3f}x; "
          f"idle share {out['idle_share']}; capture s {out['capture_s']}; "
          f"peak memory GiB {out['peak_mem_gib']}; graph pool bytes "
          f"{out['pool_bytes']}")
    return out


def hold_first_call(label: str, runs: dict) -> float:
    """The graphed runs' loss at the end of the first call against the
    first eager run's at that step, held to TOLERANCE in bf16 (the dense
    trajectories stay within ~3e-3 of each other over 10 steps)."""
    want = runs["eager"][0]["losses"][0]
    diff = max(abs(r["losses"][0] - want) for r in runs["graphed"])
    if not diff <= TOLERANCE[torch.bfloat16]:
        raise AssertionError(f"{label}: graphed losses "
                             f"{[r['losses'] for r in runs['graphed']]} "
                             f"against eager {runs['eager'][0]['losses']}")
    return diff


def graphed_sum(runs: dict) -> dict:
    """The graphed runs' launches, summed: the path's count."""
    out: dict = {}
    for r in runs["graphed"]:
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def graphed_mesh_phase(card: str) -> dict:
    """The sharded train step fused (``build_train_step(..., mesh=mesh,
    n_fused=FUSE_STEPS)``) on a one-process NCCL mesh: the training
    flagship (8 layers, B=8, S=2048, bf16) with flash attention, then the
    ring at sp=1, each step one replay of a CUDA graph that holds the
    step's NCCL collectives. Runs of GRAPHED_MESH_STEPS steps from one
    state on the same batches, in turns: for flash GRAPHED_FLASH_ORDER
    (the eager mesh step, the graphed one, the graphed plain step), for
    the ring GRAPHED_PAIR_ORDER (``train_turns``); each graphed run's loss at
    its first call's end against the eager run's (``hold_first_call``),
    launches exact."""
    from nanotpu_torch.data.synthetic import markov_batch, markov_table
    from nanotpu_torch.models import llama
    from nanotpu_torch.parallel import train
    from nanotpu_torch.tree import map_tree

    cfg = llama.LlamaConfig(**dict(train._PRESETS[("llama", "flagship")],
                                   attn_impl="flash"))
    opt = train.make_optimizer()
    base = train.init_train_state(
        torch.Generator(device="cuda").manual_seed(6), cfg, opt,
        device="cuda")
    table = markov_table(cfg.vocab_size, device="cuda")
    batches = markov_batch(torch.Generator(device="cuda").manual_seed(7),
                           table, (GRAPHED_MESH_STEPS, TRAIN_B, TRAIN_S + 1))

    def fresh():
        return train.TrainState(map_tree(lambda t: t.detach().clone(),
                                         base.params),
                                map_tree(lambda t: t.clone(), base.opt_state),
                                0)

    out = {"launches": {}}
    with nccl_world() as mesh:
        for attn, order in (("flash", GRAPHED_FLASH_ORDER),
                            ("ring", GRAPHED_PAIR_ORDER)):
            c = dataclasses.replace(cfg, attn_impl=attn)

            def make(kind):
                if kind == "plain":
                    return (train.build_train_step(c, opt, n_fused=FUSE_STEPS),
                            fresh())
                return (train.build_train_step(
                    c, opt, mesh=mesh,
                    n_fused=FUSE_STEPS if kind == "graphed" else 1),
                    train.place_state(fresh(), c, mesh))

            label = f"graphed mesh step (nccl, world 1, attn {attn})"
            runs = train_turns(label, card, make, batches, FUSE_STEPS, order,
                               cfg.n_layers)
            plain = (None if attn == "flash"
                     else out["flash"]["plain_graphed_tok_s"])
            out[attn] = summarize_turns(label, card, runs, plain)
            out[attn]["first_call_diff"] = hold_first_call(label, runs)
            out[attn]["one_step_parity"] = \
                runs["graphed"][0]["one_step_parity"]
            out["launches"]["mesh_fused" if attn == "flash"
                            else "mesh_ring_fused"] = graphed_sum(runs)
    del base
    return out


def graphed_pipeline_phase(card: str, plain_graphed_tok_s: float) -> dict:
    """The GPipe pipeline fused (pp=1, PIPE_MICRO microbatches, the
    training flagship as nanotpu's stacked tree, flash) on a one-process
    NCCL mesh: the eager pipelined step and the graphed one in turns
    (GRAPHED_ORDER), GRAPHED_MESH_STEPS steps a run from one state on the
    same batches: as ``graphed_mesh_phase``, launches one forward and one
    fused backward a layer a microbatch a step. The graph captures the
    stage masks' fills (a copy from the host would synchronize, which
    capture refuses). Beside them the graphed plain step's tokens/s
    (``plain_graphed_tok_s``: the graphed mesh phase's, this call)."""
    from nanotpu_torch.data.synthetic import markov_batch, markov_table
    from nanotpu_torch.models import llama
    from nanotpu_torch.parallel import pipeline as tpp
    from nanotpu_torch.parallel import train

    cfg = llama.LlamaConfig(**dict(train._PRESETS[("llama", "flagship")],
                                   attn_impl="flash"))
    opt = train.make_optimizer()
    table = markov_table(cfg.vocab_size, device="cuda")
    batches = markov_batch(torch.Generator(device="cuda").manual_seed(7),
                           table, (GRAPHED_MESH_STEPS, TRAIN_B, TRAIN_S + 1))
    specs = tpp.llama_pp_param_specs(cfg)
    with nccl_world() as mesh:
        def make(kind):
            stacked = tpp.stack_layers(train.init_train_state(
                torch.Generator(device="cuda").manual_seed(6), cfg, opt,
                device="cuda").params)
            state = train.place_state(
                train.TrainState(stacked, opt.init(stacked), 0), cfg, mesh,
                param_specs=specs)
            return train.build_train_step(
                cfg, opt, loss_fn=tpp.make_pipelined_loss(mesh, PIPE_MICRO),
                mesh=mesh, param_specs=specs,
                n_fused=FUSE_STEPS if kind == "graphed" else 1), state

        label = f"graphed pipeline (nccl, world 1, pp=1, M={PIPE_MICRO})"
        runs = train_turns(label, card, make, batches, FUSE_STEPS,
                           GRAPHED_ORDER, cfg.n_layers * PIPE_MICRO)
    out = summarize_turns(label, card, runs, plain_graphed_tok_s)
    out["first_call_diff"] = hold_first_call(label, runs)
    out["one_step_parity"] = runs["graphed"][0]["one_step_parity"]
    out["launches"] = graphed_sum(runs)
    return out


def moe_graphed_phase(card: str, plain_graphed_tok_s: float) -> dict:
    """Mixtral's mesh step and its pipeline (pp=1, MOE_PIPE_MICRO
    microbatches) fused (``n_fused=MOE_FUSE_STEPS``) on a one-process NCCL
    mesh: 8x7B's widths at MOE_TRAIN_LAYERS layers, B=4, S=2048, flash,
    MOE_MESH_STEPS steps a run from one state on the same batches, the
    eager step and the graphed one in turns (GRAPHED_ORDER, each state
    drawn anew from one seed and freed after its run); the graphs hold
    the ep and tp collectives, the router logits' gathers and the expert
    inputs' sums. The runs are a pair (GRAPHED_PAIR_ORDER). MoE
    trajectories part within a few steps (bf16 routing chaos), so a
    graphed run is held a step at a time, its first replayed step's loss
    against the eager step's from the same state (``replay_loss_parity``:
    the state, its graph's pool and an eager step's temporaries do not fit
    the card beside a copy of the state), and its losses printed beside
    the eager ones; launches exact. Beside them the graphed plain step's
    tokens/s (``plain_graphed_tok_s``: the Mixtral fused phase's, this
    call)."""
    from nanotpu_torch.data.synthetic import markov_batch, markov_table
    from nanotpu_torch.models import mixtral
    from nanotpu_torch.parallel import mesh as tmesh
    from nanotpu_torch.parallel import pipeline as tpp
    from nanotpu_torch.parallel import train

    cfg = mixtral_config(MOE_TRAIN_LAYERS)
    opt = train.make_optimizer()
    table = markov_table(cfg.vocab_size, device="cuda")
    batches = markov_batch(torch.Generator(device="cuda").manual_seed(1),
                           table, (MOE_MESH_STEPS, MOE_TRAIN_B, TRAIN_S + 1))

    def stacked_init(c, g, device=None):
        return tpp.stack_layers(mixtral.init_params(c, g, device=device))

    out = {"launches": {}}
    with nccl_world() as mesh:
        for path in ("mesh", "pipeline"):
            piped = path == "pipeline"
            specs = (tpp.mixtral_pp_param_specs(cfg) if piped
                     else tmesh.mixtral_param_specs(cfg))
            loss_fn = (tpp.make_pipelined_loss(mesh, MOE_PIPE_MICRO, "mixtral")
                       if piped else mixtral.loss_fn)

            def make(kind):
                state = train.place_state(train.init_train_state(
                    torch.Generator(device="cuda").manual_seed(0), cfg, opt,
                    device="cuda",
                    init_fn=stacked_init if piped else mixtral.init_params),
                    cfg, mesh, param_specs=specs)
                return train.build_train_step(
                    cfg, opt, loss_fn=loss_fn, mesh=mesh, param_specs=specs,
                    n_fused=MOE_FUSE_STEPS if kind == "graphed" else 1), state

            shard = tmesh.Shards(mesh, specs)

            def loss_of(st, tokens):
                return shard.sum_over_data(loss_fn(
                    tmesh.local(st.params), shard.rows(tokens), cfg,
                    shard=shard))

            label = (f"graphed MoE {path} (nccl, world 1, {cfg.n_layers} "
                     f"layers at 8x7B width"
                     + (f", pp=1, M={MOE_PIPE_MICRO})" if piped else ")"))
            runs = train_turns(
                label, card, make, batches, MOE_FUSE_STEPS,
                GRAPHED_PAIR_ORDER,
                cfg.n_layers * (MOE_PIPE_MICRO if piped else 1),
                parity=lambda step, state, b: replay_loss_parity(
                    step, state, b[0], loss_of))
            out[path] = summarize_turns(label, card, runs,
                                        plain_graphed_tok_s)
            out[path]["losses"] = {k: [r["losses"] for r in rs]
                                   for k, rs in runs.items()}
            out[path]["one_step_parity"] = \
                runs["graphed"][0]["one_step_parity"]
            out["launches"][f"moe_{path}_fused"] = graphed_sum(runs)
    return out


def hybrid_discovery_phase(card: str) -> dict:
    """``make_hybrid_mesh()`` on a one-process NCCL group (one host, one
    slice) gives the plain mesh, and one eager training flagship step
    trains on it; ``discover()`` with the runtime gate open finds this
    card (its count and name), and the device-file probe finds
    ``/dev/nvidia0``."""
    from nanotpu_torch.agent import discovery
    from nanotpu_torch.models import llama
    from nanotpu_torch.parallel import mesh as tmesh
    from nanotpu_torch.parallel import train

    with nccl_world() as mesh:
        hybrid = tmesh.make_hybrid_mesh()
        same = (hybrid.mesh_dim_names == mesh.mesh_dim_names
                and torch.equal(hybrid.mesh, mesh.mesh)
                and hybrid.device_type == "cuda")
        cfg = llama.LlamaConfig(**dict(train._PRESETS[("llama", "flagship")],
                                       attn_impl="flash"))
        opt = train.make_optimizer()
        state = train.place_state(train.init_train_state(
            torch.Generator(device="cuda").manual_seed(6), cfg, opt,
            device="cuda"), cfg, hybrid)
        tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1),
                               device="cuda", generator=torch.Generator(
                                   device="cuda").manual_seed(8))
        state, loss = train.build_train_step(cfg, opt, mesh=hybrid)(state,
                                                                    tokens)
        loss = loss.item()
        del state
    saved = os.environ.get("NANOTPU_AGENT_USE_TORCH")
    os.environ["NANOTPU_AGENT_USE_TORCH"] = "1"
    try:
        found = discovery.discover()
    finally:
        if saved is None:
            del os.environ["NANOTPU_AGENT_USE_TORCH"]
        else:
            os.environ["NANOTPU_AGENT_USE_TORCH"] = saved
    files = discovery._from_devfiles()
    env = discovery._from_env(dict(os.environ))
    out = {"hybrid_is_plain": same, "loss": loss,
           "discovered": dataclasses.asdict(found),
           "devfiles": files and dataclasses.asdict(files),
           "env": env and dataclasses.asdict(env),
           "NVIDIA_VISIBLE_DEVICES": os.environ.get("NVIDIA_VISIBLE_DEVICES")}
    print(f"hybrid mesh and discovery on {card}: {out}")
    if not (same and np.isfinite(loss)):
        raise AssertionError(f"make_hybrid_mesh at world 1: {out}")
    if (found.n_chips, found.kind) != (torch.cuda.device_count(),
                                       torch.cuda.get_device_name(0)):
        raise AssertionError(f"discover() found {found}")
    if files is None or "/dev/nvidia0" not in files.device_paths:
        raise AssertionError(f"the device-file probe found {files}")
    return out


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
    regs, notes = bf16_ptxas(report)
    print(f"bf16 kernels, (registers, spill bytes): {regs}")
    if any(spill for _, spill in regs.values()):
        raise AssertionError(f"a bf16 kernel spills: {regs}")
    if notes:
        raise AssertionError(f"ptxas serialized wgmma or ignored setmaxnreg: "
                             f"{notes}")

    phase_s = {}

    def timed(phase, *args):
        """``phase(*args)``, its wall seconds kept under its name."""
        t0 = time.perf_counter()
        out = phase(*args)
        phase_s[phase.__name__] = round(time.perf_counter() - t0, 1)
        return out

    rows = timed(kernel_phase, card)
    bwd = timed(backward_phase, card)
    ring = timed(ring_phase, card)
    moe_kernels = timed(mixtral_kernel_phase, card)
    decode = timed(decode_attn_phase, card)
    serve = timed(serving_phase, card)
    timed(parity_phase)
    graphed = timed(graphs_phase, card)
    int8 = timed(int8_serving_phase, card, serve["greedy"])
    timed(server_cli_phase, card)
    spec = timed(speculative_phase, card)
    timed(distill_cli_phase, card)
    trained = timed(training_phase, card)
    two_pass = timed(two_pass_phase)
    fused = timed(fused_training_phase, card)
    fused_two_pass = timed(fused_two_pass_phase)
    timed(profile_dir_phase, card)
    timed(train_parity_phase)
    meshed = timed(mesh_training_phase, card)
    piped = timed(pipeline_phase, card, meshed["plain"])
    mesh_served = timed(mesh_serving_phase, card)
    timed(trained_target_phase, card)
    moe_train = timed(mixtral_training_phase, card)
    moe_fused = timed(mixtral_fused_training_phase, card, moe_train["losses"])
    moe_serve = timed(mixtral_serving_phase, card)
    moe_meshed = timed(moe_mesh_training_phase, card)
    moe_piped = timed(moe_pipeline_phase, card)
    moe_mesh_served = timed(moe_mesh_serving_phase, card)
    graphed_meshed = timed(graphed_mesh_phase, card)
    graphed_piped = timed(graphed_pipeline_phase, card,
                          graphed_meshed["flash"]["plain_graphed_tok_s"])
    moe_graphed = timed(moe_graphed_phase, card, moe_fused["tok_s"])
    timed(hybrid_discovery_phase, card)
    print(f"phase wall seconds on {card}: {phase_s}; all phases "
          f"{sum(phase_s.values()):.1f} s")

    # each path's launches, counted from 0 just before it ran and read just
    # after; "launches" is their sum
    by_path = {"serving": serve["launches"], "int8_serving": int8["launches"],
               "graphs": graphed["launches"],
               "distill": spec["distill_launches"],
               "speculative": spec["launches"], "train": trained["launches"],
               "two_pass": two_pass, "fused_train": fused["launches"],
               "fused_two_pass": fused_two_pass,
               "mixtral_train": moe_train["launches"],
               "mixtral_fused_train": moe_fused["launches"],
               "mixtral_serving": moe_serve["launches"],
               "mixtral_rounds": moe_serve["graph_launches"],
               "moe_mesh_train": moe_meshed["mesh"]["launches"],
               "moe_pipeline": moe_piped["pipeline"]["launches"],
               "moe_mesh_serving": moe_mesh_served["launches"],
               "pipeline_fused": graphed_piped["launches"],
               **graphed_meshed["launches"], **moe_graphed["launches"],
               **ring["launches"], **meshed["launches"],
               **piped["launches"], **mesh_served["launches"]}

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
        # the serving flagship's longest prefill (S = max_len = 2048) and
        # the training shape
        "max_abs_err": max(at["max_abs_err"], rows["train"]["max_abs_err"]),
        "ms": at["ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": at["library_ms"],
        # every prefill length of the serving flagship (B=1, 16/8, D=64)
        "serve": {S: row for S, row in rows.items() if S != "train"},
        # the training flagship's shape (B=8, 16/4 heads, with lse)
        **{f"train_{k}": v for k, v in rows["train"].items()},
        # Mixtral's heads (32/8, D=128): the training shape (B=4, S=2048,
        # with lse) and the serving prefill lengths (B=1)
        **{f"mixtral_train_{k}": v for k, v in moe_kernels["train"].items()},
        "mixtral_serve": moe_kernels["serve"],
        # ring attention's body, 4 virtual ranks, forward and backward,
        # against whole-sequence flash (blocks of 2048 and 8192)
        "ring": ring["rows"],
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
        if name == "flash_bwd_fused":  # Mixtral's training shape
            kernels[-1].update({f"mixtral_{k}": v
                                for k, v in moe_kernels["bwd"].items()})
    kernels.append({
        "name": "decode_attn",
        "route": "cuda",
        "source": "nanotpu_torch/ops/csrc/decode_attn.cu",
        "replaces": None,  # nanotpu's decode attend is a jnp einsum
        **launches("decode_attn"),
        # chat's cache (B=32, T=4096) and long prompts' (B=8, T=8192)
        **{f"{shape}_{k}": v for shape, row in decode.items()
           for k, v in row.items()},
    })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
