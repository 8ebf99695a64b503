"""nanotpu_torch serving engine on the CPU, against nanotpu's.

First group: the engine's building blocks against the JAX engine's on the
same cache state, with the JAX tiny parameters carried over (float32; logits
atol 1e-4, cache contents atol 1e-5, greedy tokens exactly equal).
Second group: the engine and its HTTP front end, mirroring
tests/test_serving.py's TestEngineCorrectness and TestServingHTTP (greedy
outputs exactly equal to a solo generate)."""

import dataclasses
import json
import socket
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanotpu.models import generate as jg
from nanotpu.models import llama as jl
from nanotpu.serving import engine as je
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.models import generate as tg
from nanotpu_torch.models import llama as tl
from nanotpu_torch.serving import engine as te
from nanotpu_torch.serving.http import serve
from nanotpu_torch.serving.server import ServingAPI, build_engine

torch.set_num_threads(2)
CFG_J, CFG_T = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def models():
    params = jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), CFG_J
    )
    tparams = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu"
    )
    return params, tparams


def slot_caches(lengths, T=32, seed=0):
    """The same random slot-cache contents as a JAX and a torch SlotCache."""
    rng = np.random.default_rng(seed)
    shape = (len(lengths), T, CFG_T.n_kv_heads, CFG_T.head_dim)
    ks = [rng.standard_normal(shape, np.float32) * 0.5
          for _ in range(CFG_T.n_layers)]
    vs = [rng.standard_normal(shape, np.float32)
          for _ in range(CFG_T.n_layers)]
    jc = je.SlotCache(tuple(map(jnp.asarray, ks)), tuple(map(jnp.asarray, vs)),
                      jnp.asarray(lengths, jnp.int32))
    tc = te.SlotCache(tuple(torch.from_numpy(k.copy()) for k in ks),
                      tuple(torch.from_numpy(v.copy()) for v in vs),
                      torch.tensor(lengths, dtype=torch.int32))
    return jc, tc


def assert_caches_close(tc, jc):
    for a, b in zip(tc.k + tc.v, jc.k + jc.v):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()


# -- first group: building blocks vs the JAX engine ------------------------

@pytest.mark.parametrize("S", [1, 3])
def test_rows_forward_matches_jax(models, S):
    params, tparams = models
    lengths, advance = [3, 7, 0, 12], [S, S, 0, 1]
    jc, tc = slot_caches(lengths)
    tokens = np.random.default_rng(S).integers(0, 256, (4, S))
    jlog, jc2 = jax.jit(je._rows_forward, static_argnums=1)(
        params, CFG_J, jc, jnp.asarray(tokens), jnp.asarray(advance, jnp.int32)
    )
    with torch.inference_mode():
        tlog, tc2 = te._rows_forward(tparams, CFG_T, tc,
                                     torch.from_numpy(tokens),
                                     torch.tensor(advance))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    assert_caches_close(tc2, jc2)


def test_serving_step_greedy_matches_jax(models):
    params, tparams = models
    jc, tc = slot_caches([5, 1, 9, 20], seed=1)
    tokens = np.array([17, 3, 250, 64])
    active = np.array([True, True, False, True])
    temps = np.zeros(4, np.float32)
    jnxt, _ = jax.jit(je.serving_step, static_argnums=1)(
        params, CFG_J, jc, jnp.asarray(tokens), jnp.asarray(active),
        jnp.asarray(temps), jax.random.PRNGKey(0),
    )
    with torch.inference_mode():
        tnxt, tc2 = te.serving_step(
            tparams, CFG_T, tc, torch.from_numpy(tokens),
            torch.from_numpy(active), torch.from_numpy(temps),
            torch.Generator().manual_seed(0),
        )
    assert tnxt.tolist() == np.asarray(jnxt).tolist()
    assert tc2.lengths.tolist() == [6, 2, 9, 21]


def test_serving_chunk_greedy_matches_jax(models):
    """n steps on the device with per-row budgets, a frozen row and eos:
    the [n_steps, SLOTS] token block equals the JAX chunk's."""
    params, tparams = models
    jc, tc = slot_caches([4, 6, 2, 8], seed=2)
    tokens = np.array([5, 6, 7, 8])
    done = np.array([False, False, True, False])
    temps = np.zeros(4, np.float32)
    remaining = np.array([6, 2, 0, 5], np.int32)
    chunk = jax.jit(je.serving_chunk, static_argnums=1,
                    static_argnames=("n_steps", "eos_id"))
    probe = chunk(
        params, CFG_J, jc, jnp.asarray(tokens), jnp.asarray(done),
        jnp.asarray(temps), jnp.asarray(remaining), jax.random.PRNGKey(0),
        n_steps=6,
    )[-1]
    eos = int(np.asarray(probe)[2, 3])  # row 3 stops at its 3rd token
    jc, tc = slot_caches([4, 6, 2, 8], seed=2)
    jout = chunk(
        params, CFG_J, jc, jnp.asarray(tokens), jnp.asarray(done),
        jnp.asarray(temps), jnp.asarray(remaining), jax.random.PRNGKey(0),
        n_steps=6, eos_id=eos,
    )
    with torch.inference_mode():
        tout = te.serving_chunk(
            tparams, CFG_T, tc, torch.from_numpy(tokens),
            torch.from_numpy(done), torch.from_numpy(temps),
            torch.from_numpy(remaining), torch.Generator().manual_seed(0),
            n_steps=6, eos_id=eos,
        )
    assert tout[4].tolist() == np.asarray(jout[-1]).tolist()
    assert tout[2].tolist() == np.asarray(jout[2]).tolist()  # done
    assert tout[3].tolist() == np.asarray(jout[3]).tolist()  # remaining
    assert_caches_close(tout[0], jout[0])


def test_write_rows_clamps_like_dynamic_update_slice():
    rng = np.random.default_rng(3)
    cache = rng.standard_normal((3, 8, 2, 4), np.float32)
    new = rng.standard_normal((3, 2, 2, 4), np.float32)
    offsets = np.array([0, 7, 6], np.int32)  # row 1 runs past T=8
    want = je._write_rows(jnp.asarray(cache), jnp.asarray(new),
                          jnp.asarray(offsets))
    got = te._write_rows(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                         torch.from_numpy(offsets))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1, 6:8].numpy(), new[1])  # clamped


def test_prefill_request_first_token_and_rows(models):
    _, tparams = models
    prompt = [9, 8, 7, 6, 5]
    padded = torch.zeros((1, 16), dtype=torch.long)
    padded[0, :5] = torch.tensor(prompt)
    with torch.inference_mode():
        first, ks, vs = te.prefill_request(tparams, CFG_T, padded, 5, 32, 0.0,
                                           None)
        _, cache = tg.prefill(tparams, torch.tensor([prompt]), CFG_T, 32)
    assert int(first) == tg.generate(tparams, torch.tensor([prompt]), CFG_T,
                                     1)[0, 0].item()
    assert len(ks) == CFG_T.n_layers and ks[0].shape == (1, 32, 2, 16)
    for a, b in zip(ks + vs, cache.k + cache.v):
        torch.testing.assert_close(a[:, :5], b[:, :5], atol=1e-5, rtol=0)


# -- second group: the engine and its HTTP front end -----------------------

@pytest.fixture()
def engine(models):
    _, tparams = models
    eng = te.Engine(tparams, CFG_T, slots=4, max_len=128, buckets=(16, 32, 64),
                    device="cpu")
    assert eng.wait_warm(60)
    yield eng
    eng.stop()


def ref_greedy(tparams, prompt, n):
    return tg.generate(tparams, torch.tensor([prompt]), CFG_T, n)[0].tolist()


class TestEngineCorrectness:
    def test_single_request_matches_generate(self, models, engine):
        params, tparams = models
        prompt = [3, 1, 4, 1, 5, 9, 2, 6]
        got = engine.generate(prompt, 12)
        assert got == ref_greedy(tparams, prompt, 12)
        jax_ref = jax.jit(jg.generate, static_argnums=(2, 3))(
            params, jnp.asarray([prompt], jnp.int32), CFG_J, 12
        )
        assert got == np.asarray(jax_ref)[0].tolist()

    def test_concurrent_mixed_length_requests_independent(self, models,
                                                          engine):
        _, tparams = models
        prompts = [
            [1, 2, 3],
            [7] * 13,
            [42],
            [5, 4, 3, 2, 1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
            [9, 9],  # 5 requests > 4 slots: one queues
        ]
        reqs = [engine.submit(p, 10) for p in prompts]
        for r in reqs:
            assert r.wait(60) and r.error is None
        for p, r in zip(prompts, reqs):
            assert r.out == ref_greedy(tparams, p, 10), p

    def test_staggered_admission_mid_decode(self, models, engine):
        _, tparams = models
        r1 = engine.submit([11, 12, 13], 40)
        time.sleep(0.05)  # r1 is decoding now
        r2 = engine.submit([21, 22], 8)
        assert r1.wait(60) and r2.wait(60)
        assert r1.out == ref_greedy(tparams, [11, 12, 13], 40)
        assert r2.out == ref_greedy(tparams, [21, 22], 8)

    def test_eos_evicts_early(self, models):
        _, tparams = models
        probe = ref_greedy(tparams, [1, 2, 3], 5)
        eos = probe[2]
        eng = te.Engine(tparams, CFG_T, slots=2, max_len=64, buckets=(16,),
                        eos_id=eos, device="cpu")
        try:
            req = eng.submit([1, 2, 3], 40)
            assert req.wait(60)
            assert req.out[-1] == eos and len(req.out) <= 40
            assert req.out == probe[: len(req.out)]
            assert all(r is None for r in eng._slot_req)
        finally:
            eng.stop()

    def test_slot_reuse_many_requests_few_slots(self, models):
        _, tparams = models
        eng = te.Engine(tparams, CFG_T, slots=2, max_len=64, buckets=(16,),
                        device="cpu")
        try:
            reqs = [eng.submit([i + 1, i + 2], 6) for i in range(7)]
            for r in reqs:
                assert r.wait(60) and r.error is None
            for i, r in enumerate(reqs):
                assert r.out == ref_greedy(tparams, [i + 1, i + 2], 6)
        finally:
            eng.stop()

    def test_sampled_rows_in_range_and_greedy_unaffected(self, models,
                                                         engine):
        _, tparams = models
        rs = engine.submit([2, 4, 6], 10, temperature=0.9)
        rg = engine.submit([1, 2, 3], 10, temperature=0.0)
        assert rs.wait(60) and rg.wait(60)
        assert rg.out == ref_greedy(tparams, [1, 2, 3], 10)
        assert len(rs.out) == 10
        assert all(0 <= t < CFG_T.vocab_size for t in rs.out)

    def test_validation_errors(self, engine):
        assert "empty" in engine.submit([], 5).error
        assert "max_len" in engine.submit([1] * 200, 5).error
        assert "token ids" in engine.submit([1, 256], 5).error

    def test_ttft_and_stats_recorded(self, engine):
        req = engine.submit([1, 2, 3, 4], 5)
        assert req.wait(60)
        assert req.ttft_s is not None and req.latency_s >= req.ttft_s
        st = engine.stats()
        assert st["requests_total"] >= 1 and st["tokens_total"] >= 5
        assert st["ttft_p50_ms"] is not None

    def test_submit_after_stop_fails_fast(self, models):
        _, tparams = models
        eng = te.Engine(tparams, CFG_T, slots=1, max_len=32, buckets=(16,),
                        device="cpu")
        eng.stop()
        req = eng.submit([1, 2], 3)
        assert req.wait(1) and req.error == "engine stopped"


def test_metrics_and_stats_keys_equal_the_jax_engines(models, engine):
    params, _ = models
    jeng = je.Engine(params, CFG_J, slots=1, max_len=32, buckets=(16,),
                     chunk_steps=1, chunk_steps_max=1)
    try:
        assert jeng.wait_warm(120)
        assert set(engine.metrics()) == set(jeng.metrics())
        assert set(engine.stats()) == set(jeng.stats())
    finally:
        jeng.stop()


class TestServingHTTP:
    def test_generate_roundtrip_and_metrics(self, models, engine):
        _, tparams = models
        api = ServingAPI(engine)
        body = json.dumps({"tokens": [1, 2, 3], "max_new_tokens": 6}).encode()
        code, ctype, payload = api.dispatch("POST", "/v1/generate", body)
        assert code == 200, payload
        out = json.loads(payload)
        assert out["tokens"] == ref_greedy(tparams, [1, 2, 3], 6)
        assert out["ttft_ms"] is not None
        code, _, metrics = api.dispatch("GET", "/metrics", b"")
        assert code == 200
        for series in ("nanotpu_serve_requests_total",
                       "nanotpu_serve_tokens_total",
                       "nanotpu_serve_ttft_seconds_bucket",
                       "nanotpu_serve_active_slots"):
            assert series in metrics
        code, _, stats = api.dispatch("GET", "/v1/stats", b"")
        assert code == 200 and json.loads(stats)["requests_total"] >= 1
        assert api.dispatch("GET", "/healthz", b"")[:2] == (200, "text/plain")
        assert api.dispatch("GET", "/nope", b"")[0] == 404

    def test_bad_inputs_rejected(self, engine):
        api = ServingAPI(engine)
        for bad in (
            b"not json",
            json.dumps({"tokens": "abc"}).encode(),
            json.dumps({"tokens": [1], "max_new_tokens": 0}).encode(),
            json.dumps({"tokens": [1, "x"]}).encode(),
            json.dumps({"tokens": [1, 999]}).encode(),
        ):
            code, _, payload = api.dispatch("POST", "/v1/generate", bad)
            assert code == 400, (bad, payload)

    def test_over_live_socket(self, models, engine):
        _, tparams = models
        server = serve(ServingAPI(engine), 0, host="127.0.0.1")
        host, port = server.server_address
        results = {}

        def client(i):
            req = urllib.request.Request(
                f"http://{host}:{port}/v1/generate",
                data=json.dumps({"tokens": [i + 1, i + 2, i + 3],
                                 "max_new_tokens": 5}).encode(),
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=60) as resp:
                results[i] = json.loads(resp.read())

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=90)
            with urllib.request.urlopen(
                f"http://{host}:{port}/v1/stats", timeout=30
            ) as resp:
                stats = json.loads(resp.read())
        finally:
            server.shutdown()
            server.server_close()
        assert not any(t.is_alive() for t in threads) and len(results) == 6
        for i, out in results.items():
            assert out["tokens"] == ref_greedy(tparams, [i + 1, i + 2, i + 3], 5)
        assert stats["requests_total"] >= 6

    def test_sse_streaming_first_chunk_before_completion(self, models):
        """{"stream": true}: the first SSE event arrives over the live socket
        while the generation is still running, events are plural, and the
        streamed tokens equal the non-streamed run."""
        _, tparams = models
        eng = te.Engine(tparams, CFG_T, slots=2, max_len=256, buckets=(16,),
                        chunk_steps=2, chunk_steps_max=4, device="cpu")
        server = serve(ServingAPI(eng), 0, host="127.0.0.1")
        host, port = server.server_address
        try:
            n_new = 64
            body = json.dumps({"tokens": [3, 1, 4], "max_new_tokens": n_new,
                               "stream": True}).encode()
            sock = socket.create_connection((host, port), timeout=60)
            sock.sendall(
                (f"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n").encode() + body
            )
            buf = b""
            while b"\r\n\r\n" not in buf:
                buf += sock.recv(65536)
            head, buf = buf.split(b"\r\n\r\n", 1)
            assert b"200" in head.split(b"\r\n")[0]
            assert b"text/event-stream" in head and b"chunked" in head.lower()
            while b"\n\n" not in buf:
                buf += sock.recv(65536)
            assert any(r is not None for r in eng._slot_req), (
                "first SSE event arrived only after generation completed"
            )
            while not buf.endswith(b"0\r\n\r\n"):
                chunk = sock.recv(65536)
                if not chunk:
                    break
                buf += chunk
            sock.close()
            payload, rest = b"", buf
            while rest:
                line, _, rest = rest.partition(b"\r\n")
                size = int(line, 16)
                if size == 0:
                    break
                payload += rest[:size]
                rest = rest[size + 2:]
            events = [json.loads(e[len("data: "):])
                      for e in payload.decode().split("\n\n") if e]
            token_events = [e for e in events if "tokens" in e]
            assert len(token_events) >= 3, events
            streamed = [t for e in token_events for t in e["tokens"]]
            assert events[-1].get("done") is True
            assert events[-1]["n_tokens"] == n_new
            assert streamed == ref_greedy(tparams, [3, 1, 4], n_new)
        finally:
            server.shutdown()
            server.server_close()
            eng.stop()


def test_build_engine_tiny_preset_serves_on_cpu():
    eng = build_engine("tiny", slots=2, max_len=64, device="cpu",
                       buckets=(16,))
    try:
        assert eng.cfg == dataclasses.replace(tl.LlamaConfig.tiny(),
                                              max_seq_len=64)
        out = eng.generate([1, 2, 3], 4)
        assert out == ref_greedy(eng.params, [1, 2, 3], 4)
    finally:
        eng.stop()
