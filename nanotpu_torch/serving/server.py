"""HTTP front end for the serving engine (POST /v1/generate): the port of
``nanotpu/serving/server.py``, same routes and the same series names.

Per-request handler threads block on the engine's request future; the
engine batches across them.

Run:  python -m nanotpu_torch.serving.server --preset flagship --port 8100
      curl -d '{"tokens": [1,2,3], "max_new_tokens": 8}' localhost:8100/v1/generate
      curl -N -d '{"tokens": [1,2,3], "max_new_tokens": 64, "stream": true}' \\
           localhost:8100/v1/generate     # SSE token streaming
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import signal
import threading
import traceback

import torch

from nanotpu_torch import resolve_device
from nanotpu_torch.metrics.registry import Registry
from nanotpu_torch.models.llama import LlamaConfig, init_params
from nanotpu_torch.models.quant import quantize_params
from nanotpu_torch.serving.engine import Engine
from nanotpu_torch.serving.http import serve

log = logging.getLogger("nanotpu_torch.serving.http")

#: TTFT/latency buckets (seconds) tuned for decode: 5ms to 60s.
SERVE_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0
)


class ServingAPI:
    """``dispatch(method, path, body) -> (code, content_type, payload)``,
    served by :func:`nanotpu_torch.serving.http.serve` or called directly."""

    def __init__(self, engine: Engine, registry: Registry | None = None,
                 request_timeout_s: float = 600.0):
        self.engine = engine
        self.registry = registry or Registry()
        self.request_timeout_s = request_timeout_s
        r = self.registry
        self.req_total = r.counter(
            "nanotpu_serve_requests_total", "Generation requests"
        )
        self.tok_total = r.counter(
            "nanotpu_serve_tokens_total", "Generated tokens"
        )
        self.ttft = r.histogram(
            "nanotpu_serve_ttft_seconds", "Time to first token",
            buckets=SERVE_BUCKETS,
        )
        self.latency = r.histogram(
            "nanotpu_serve_latency_seconds", "Whole-request latency",
            buckets=SERVE_BUCKETS,
        )
        self.active = r.gauge(
            "nanotpu_serve_active_slots", "Requests currently decoding"
        )
        self.active.set_function(
            lambda: sum(1 for x in engine._slot_req if x is not None)
        )
        self.moe_dropped = r.gauge(
            "nanotpu_serve_moe_prefill_dropped_tokens_total",
            "MoE tokens dropped by expert capacity during admission "
            "prefills (monotone; decode routes at full capacity and "
            "cannot drop)",
        )
        self.moe_dropped.set_function(
            lambda: engine.moe_prefill_dropped_total
        )

    def dispatch(self, method: str, path: str,
                 body: bytes) -> tuple[int, str, object]:
        try:
            if method == "POST" and path == "/v1/generate":
                return self._generate(body)
            if method == "GET" and path == "/v1/stats":
                return 200, "application/json", json.dumps(self.engine.stats())
            if method == "GET" and path == "/healthz":
                return 200, "text/plain", "ok"
            if method == "GET" and path == "/metrics":
                return 200, "text/plain; version=0.0.4", self.registry.render()
            return 404, "application/json", json.dumps(
                {"error": f"no route {path}"}
            )
        except Exception:
            log.exception("unhandled error on %s %s", method, path)
            return 500, "application/json", json.dumps(
                {"error": traceback.format_exc(limit=3)}
            )

    def _generate(self, body: bytes) -> tuple[int, str, object]:
        try:
            args = json.loads(body or b"{}")
        except json.JSONDecodeError as e:
            return 400, "application/json", json.dumps(
                {"error": f"malformed JSON: {e}"}
            )
        tokens = args.get("tokens")
        if not isinstance(tokens, list) or not all(
            isinstance(t, int) for t in tokens
        ):
            return 400, "application/json", json.dumps(
                {"error": "'tokens' must be a list of ints"}
            )
        max_new = args.get("max_new_tokens", 16)
        temperature = float(args.get("temperature", 0.0))
        if not isinstance(max_new, int) or max_new < 1:
            return 400, "application/json", json.dumps(
                {"error": "'max_new_tokens' must be a positive int"}
            )
        req = self.engine.submit(tokens, max_new, temperature)
        self.req_total.inc()
        if args.get("stream"):
            return 200, "text/event-stream", self._sse_events(req)
        if not req.wait(self.request_timeout_s):
            return 500, "application/json", json.dumps(
                {"error": "request timed out"}
            )
        if req.error:
            return 400, "application/json", json.dumps({"error": req.error})
        self.tok_total.inc(len(req.out))
        stats = self._completion_stats(req)
        stats["tokens"] = req.out
        return 200, "application/json", json.dumps(stats)

    def _completion_stats(self, req) -> dict:
        """Observe the latency histograms and build the shared completion
        fields (the JSON and SSE paths must not drift)."""
        if req.ttft_s is not None:
            self.ttft.observe(req.ttft_s)
        if req.latency_s is not None:
            self.latency.observe(req.latency_s)
        return {
            "id": req.id,
            "ttft_ms": (
                round(req.ttft_s * 1e3, 2) if req.ttft_s is not None else None
            ),
            "latency_ms": (
                round(req.latency_s * 1e3, 2)
                if req.latency_s is not None else None
            ),
        }

    def _sse_events(self, req):
        """SSE generator: one ``data:`` event per decode-chunk batch of
        tokens, then a final event carrying completion stats."""
        try:
            for batch in req.stream(self.request_timeout_s):
                self.tok_total.inc(len(batch))
                yield f"data: {json.dumps({'id': req.id, 'tokens': batch})}\n\n"
        except TimeoutError:
            yield f"data: {json.dumps({'id': req.id, 'error': 'request timed out'})}\n\n"
            return
        if req.error:
            yield f"data: {json.dumps({'id': req.id, 'error': req.error})}\n\n"
            return
        stats = self._completion_stats(req)
        stats.update(done=True, n_tokens=len(req.out))
        yield f"data: {json.dumps(stats)}\n\n"


def serving_config(preset: str, max_len: int) -> LlamaConfig:
    """The model of one of nanotpu's serving presets: ``flagship`` (vocab
    32768, dim 1024, 12 layers, 16/8 heads, bf16, flash prefill) or
    ``tiny``."""
    if preset == "flagship":
        return LlamaConfig(
            vocab_size=32768, dim=1024, n_layers=12, n_heads=16,
            n_kv_heads=8, ffn_dim=2816, max_seq_len=max_len,
            attn_impl="flash",
        )
    if preset == "tiny":
        return dataclasses.replace(LlamaConfig.tiny(), max_seq_len=max_len)
    raise ValueError(f"unknown preset {preset}")


def build_engine(preset: str, slots: int, max_len: int, eos_id: int = -1,
                 seed: int = 0, dtype: str | None = None, device=None,
                 quantize: bool = False, kv_int8: bool = False,
                 **engine_kw) -> Engine:
    """An engine over random weights drawn from a seeded generator on
    ``device`` (``cuda`` unless named), for nanotpu's serving presets;
    ``dtype`` overrides the preset's. ``quantize`` serves the weights
    weight-only int8 (:func:`~nanotpu_torch.models.quant.quantize_params`),
    ``kv_int8`` keeps the KV cache in int8."""
    device = resolve_device(device)
    cfg = serving_config(preset, max_len)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    generator = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, generator, device=device)
    if quantize:
        params = quantize_params(params)
    return Engine(params, cfg, slots=slots, max_len=max_len, eos_id=eos_id,
                  kv_int8=kv_int8, device=device, **engine_kw)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("nanotpu-torch-serve")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument("--preset", default="flagship")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--int8", action="store_true", help="weight-only int8")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache (halves decode HBM reads)")
    p.add_argument("--eos-id", type=int, default=-1)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    return p


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    engine = build_engine(args.preset, args.slots, args.max_len,
                          eos_id=args.eos_id, device=args.device,
                          quantize=args.int8, kv_int8=args.kv_int8)
    engine.wait_warm()
    api = ServingAPI(engine)
    server = serve(api, args.port)
    log.info("serving on :%d (%d slots, max_len %d, %s)", args.port,
             args.slots, args.max_len, engine.device)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    server.shutdown()
    server.server_close()
    engine.stop()


if __name__ == "__main__":
    main()
