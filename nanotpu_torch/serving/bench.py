"""Serving-engine benchmark: mixed-length request replay, the port of
``nanotpu/serving/bench.py``.

Prints ONE JSON line with engine throughput and TTFT/latency percentiles,
with nanotpu's keys. The workload: a burst of mixed-length prompts plus a
trailing arrival stream, so the engine exercises both the full-batch steady
state and continuous admission mid-decode. On a card the engine replays its
decode step as a CUDA graph (:mod:`nanotpu_torch.serving.graphs`).

  python -m nanotpu_torch.serving.bench                  # bf16 flagship
  python -m nanotpu_torch.serving.bench --int8 --kv-int8 # int8 weights + KV
  python -m nanotpu_torch.serving.bench --preset tiny --device cpu  # smoke
"""

from __future__ import annotations

import argparse
import json
import random
import time

from nanotpu_torch.metrics.stats import percentile
from nanotpu_torch.serving.server import build_engine


def run(preset: str, slots: int, max_len: int, int8: bool, requests: int,
        max_new: int, seed: int = 0, kv_int8: bool = False,
        device=None) -> dict:
    rng = random.Random(seed)
    engine = build_engine(preset, slots, max_len, quantize=int8,
                          kv_int8=kv_int8, device=device)
    try:
        cfg = engine.cfg
        lengths = [64, 128, 256, 512, 1024]
        lengths = [n for n in lengths if n < max_len - max_new] or [8]

        def mk_prompt(n):
            return [rng.randrange(1, cfg.vocab_size) for _ in range(n)]

        # warm-up, untimed: one prefill per bucket, and the decode graphs
        for n in lengths:
            engine.generate(mk_prompt(n), 2)
        engine.wait_warm(600)

        t0 = time.perf_counter()
        reqs = []
        # half the requests burst at t=0 (queue > slots: tests admission
        # under load), the rest trickle in while earlier ones decode
        burst = requests // 2
        for _ in range(burst):
            reqs.append(engine.submit(mk_prompt(rng.choice(lengths)), max_new))
        for _ in range(requests - burst):
            time.sleep(0.02)
            reqs.append(engine.submit(mk_prompt(rng.choice(lengths)), max_new))
        for r in reqs:
            if not r.wait(1200):
                raise TimeoutError(f"request {r.id} timed out")
            if r.error is not None:
                raise RuntimeError(f"request {r.id}: {r.error}")
        wall = time.perf_counter() - t0
    finally:
        engine.stop()

    gen_tokens = sum(len(r.out) for r in reqs)
    ttfts = [r.ttft_s for r in reqs if r.ttft_s is not None]
    lats = [r.latency_s for r in reqs if r.latency_s is not None]
    return {
        "preset": preset,
        "int8": int8,
        "kv_int8": kv_int8,
        "slots": slots,
        "requests": requests,
        "max_new_tokens": max_new,
        "prompt_lengths": lengths,
        "wall_s": round(wall, 3),
        "decode_tokens_per_s": round(gen_tokens / wall, 1),
        "ttft_p50_ms": round(percentile(ttfts, 0.5) * 1e3, 1),
        "ttft_p99_ms": round(percentile(ttfts, 0.99) * 1e3, 1),
        "latency_p50_ms": round(percentile(lats, 0.5) * 1e3, 1),
        "latency_p99_ms": round(percentile(lats, 0.99) * 1e3, 1),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser("nanotpu-torch-serve-bench")
    p.add_argument("--preset", default="flagship")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--kv-int8", action="store_true")
    p.add_argument("--requests", type=int, default=48)
    p.add_argument("--max-new", type=int, default=128)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    out = run(args.preset, args.slots, args.max_len, args.int8,
              args.requests, args.max_new, kv_int8=args.kv_int8,
              device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
