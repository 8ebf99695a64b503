"""Driver kind ``serve_closed``: a closed loop of clients against the port's
continuous-batching ``Engine``.

Set-up builds the engine over the harness's weights, waits for its warm-up
(the kernels built or loaded, its decode graph captured), prefills once at
every bucket the mix's prompts fall into, then starts the loop: every
client sends a request, and sends its next one as soon as it sees its last
one end. ``ramp_seconds`` after the first sends, in the loop's steady
state, the window opens; it lasts ``--seconds`` (a traced run:
``trace_seconds``, under the profiler, which started while the engine was
idle, before the loop). One thread polls every request every
``poll_seconds`` and records when it sees each request's first token, each
change of its token count and its end, on the harness's own clock.

At the close the engine is stopped (what is still in flight ends there),
the peak memory read and the engine freed; then a sample of the requests
that finished, drawn from the seed with the longest among them, is run
through the float32 reference over prompt and served tokens, and the
gaps of the served tokens' logits below the reference's best decide
(:func:`gpubench.yardstick.compare.serve_numbers`).

``control`` (:mod:`gpubench.control`): ``"int8"`` serves with the port's own
int8 path (weights and cache).
"""

from __future__ import annotations

import gc
import time

import torch

from gpubench.yardstick import compare, traffic as traffic_gen, weights
from gpubench.yardstick.stats import Served


def _engine(run, params, cfg):
    from nanotpu_torch.serving.engine import Engine

    eng = run.traffic["engine"]
    return Engine(params, cfg, slots=eng["slots"], max_len=eng["max_len"],
                  device=run.device, kv_int8=run.control == "int8")


def _warm_buckets(engine, traffic: dict, vocab: int) -> None:
    """One request at the longest prompt of each bucket the mix uses."""
    lengths = traffic_gen.quantile_lengths(traffic["prompt"], int(traffic["block"]))
    longest = {}
    for n in lengths.tolist():
        b = next((b for b in engine.buckets if n <= b), engine.buckets[-1])
        longest[b] = max(longest.get(b, 0), n)
    for n in longest.values():
        req = engine.submit([i % vocab for i in range(n)], 2)
        if not req.wait(600) or req.error:
            raise RuntimeError(f"warm-up prefill of {n} tokens failed: {req.error}")


def run(run, tracer) -> dict:
    traffic, conf = run.traffic, run.config
    cfg, _ = run.family.port(conf)
    tree = weights.tree(run.shape, run.seed, cfg.torch_dtype, run.device)
    params = tree
    if run.control == "int8":  # the port's own int8 path
        from nanotpu_torch.models.quant import quantize_params

        params = quantize_params(tree)
    engine = _engine(run, params, cfg)
    try:
        engine.wait_warm()
        _warm_buckets(engine, traffic, cfg.vocab_size)
        out = _loop(run, engine, tracer)
    finally:
        engine.stop()
    if tracer is not None:
        out["timeline"] = tracer.stop()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(run.device)
    del engine, params
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    # prefills the engine ran: a request with a token was prefilled
    out["prefilled"] = sum(1 for _, req, _ in out["sent"] if req.out)
    out["compared"] = compare.serve_numbers(_check(run, tree, out["sent"]))
    return out


def _loop(run, engine, tracer) -> dict:
    traffic = run.traffic
    stream = traffic_gen.Requests(traffic, run.seed, run.config["vocab_size"])
    slots = traffic["engine"]["slots"]
    poll = traffic["poll_seconds"]
    every = traffic["occupancy_every_seconds"]
    sent: list[tuple[Served, object, list[int]]] = []
    live: dict[int, tuple[Served, object]] = {}

    def send(client: int) -> None:
        ids, n_new = stream.next()
        served = Served(sent=time.perf_counter(), prompt_len=len(ids))
        req = engine.submit(ids, n_new, temperature=traffic["temperature"])
        live[client] = (served, req)
        sent.append((served, req, ids))

    def observe(now: float) -> None:
        for client, (served, req) in list(live.items()):
            finished = req.wait(0)  # then its count is final
            n = len(req.out)
            if n != served.n_out:
                served.seen.append((now, n))
                if served.first is None and n:
                    served.first = now
            if finished:
                served.done, served.error = now, req.error
                send(client)

    if tracer is not None:
        tracer.start()  # the engine is idle: nothing submitted yet
    t_ramp = time.perf_counter()
    for client in range(traffic["clients"]):
        send(client)
    length = traffic["trace_seconds"] if tracer is not None else run.seconds
    t_open = t_ramp + traffic["ramp_seconds"]
    t0 = t1 = None
    occupancy, next_sample = [], t_open
    while True:
        now = time.perf_counter()
        observe(now)
        if t0 is None and now >= t_open:
            t0 = now
            if tracer is not None:
                tracer.mark()
        if t0 is not None and now >= next_sample:
            occupancy.append(engine.metrics()["active"] / slots)
            next_sample += every
        if t0 is not None and now >= t0 + length:
            t1 = now
            if tracer is not None:
                tracer.mark()
            break
        time.sleep(poll)
    reqs = [s for s, _, _ in sent]
    in_window = [s for s in reqs if t0 <= s.sent < t1]
    return {
        "t_open": t0, "t_close": t1, "requests": reqs, "sent": sent,
        "occupancy": occupancy,
        "attempted": len(in_window),
        "failed": sum(1 for s in in_window if s.error is not None),
    }


def _check(run, tree: dict, sent: list) -> list[float]:
    """The gaps of the served tokens over a sample of finished requests:
    the longest first, then others in an order drawn from the seed, until
    ``sample_tokens`` served tokens are covered."""
    done = [(s, list(req.out), ids) for s, req, ids in sent
            if s.done is not None and s.error is None]
    if not done:
        return []  # nothing finished: nothing can be shown right
    longest = max(range(len(done)), key=lambda i: len(done[i][1]))
    order = [longest] + [int(i) for i in
                         traffic_gen.rng(run.seed, 3).permutation(len(done))
                         if i != longest]
    gaps: list[float] = []
    for i in order:
        if len(gaps) >= run.traffic["sample_tokens"]:
            break
        _, out, ids = done[i]
        seq, at = ids + out[:-1], range(len(ids) - 1, len(ids) - 1 + len(out))
        ref = run.family.reference_logits(tree, run.config, seq, at)
        gaps += compare.logit_gaps(ref, out)
    return gaps
