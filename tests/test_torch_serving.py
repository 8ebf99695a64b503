"""nanotpu_torch serving engine on the CPU, against nanotpu's.

First group: the engine's building blocks against the JAX engine's on the
same cache state, with the JAX tiny parameters carried over (float32; logits
atol 1e-4, cache contents atol 1e-5, greedy tokens exactly equal).
Second group: the engine and its HTTP front end, mirroring
tests/test_serving.py's TestEngineCorrectness and TestServingHTTP (greedy
outputs exactly equal to a solo generate).
Third group: the int8 KV cache and per-row speculative decoding, mirroring
tests/test_serving.py's TestKvInt8, TestSpeculativeServing,
test_speculative_composes_with_kv_int8, TestAdaptiveSpeculation,
TestMeasuredPolicy and TestSpecPolicyMisconfigWarning: building blocks
against the JAX engine's (int8 values equal, scales and logits within
1e-5 / 1e-4), the int8-KV engine's greedy tokens equal to the JAX int8-KV
engine's, and the speculative engine's greedy tokens equal to the plain
engine's. nanotpu's checks of which chunks were compiled become checks of
the policy's arms (``_variant_ks``): the port compiles nothing.
Fourth group: the decode units on fixed tensors (the CUDA graphs' bodies).
Fifth group: Mixtral MoE serving, mirroring TestMoEServing,
TestMoEDropCounter and TestSpeculativeMoEServing.
Sixth group: the prefill length, which differs from the JAX engine's on
purpose (the port pads a prompt to its length rounded up to the flash
forward's 128-row block, nanotpu to its bucket): greedy tokens and MoE
drop counts equal to the JAX engine's all the same."""

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

from nanotpu.models import distill as jd
from nanotpu.models import generate as jg
from nanotpu.models import llama as jl
from nanotpu.models import mixtral as jm
from nanotpu.serving import engine as je
from nanotpu_torch.convert import params_from_numpy
from nanotpu_torch.metrics import spans
from nanotpu_torch.models import distill as td
from nanotpu_torch.models import generate as tg
from nanotpu_torch.models import llama as tl
from nanotpu_torch.models import mixtral as tm
from nanotpu_torch.models import quant as tq
from nanotpu_torch.serving import engine as te
from nanotpu_torch.serving import server as tsrv
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
        first, ks, vs = te.prefill_request(tparams, CFG_T, padded, 5, 0.0,
                                           None)
        _, cache = tg.prefill(tparams, torch.tensor([prompt]), CFG_T, 32)
    assert int(first) == tg.generate(tparams, torch.tensor([prompt]), CFG_T,
                                     1)[0, 0].item()
    # the rows are the prefilled length's, not max_len's
    assert len(ks) == CFG_T.n_layers and ks[0].shape == (1, 16, 2, 16)
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


# -- third group: int8 KV cache and speculative decoding --------------------

DCFG_J = dataclasses.replace(CFG_J, n_layers=1)
DCFG_T = dataclasses.replace(CFG_T, n_layers=1)


@pytest.fixture(scope="module")
def drafts(models):
    """nanotpu's test draft (one layer, tied to the target, truncated
    init) as (jax draft, port draft, port draft config)."""
    params, tparams = models
    jdraft = jd.init_draft(jax.random.PRNGKey(9), params, CFG_J, DCFG_J)
    tdraft = td.init_draft(torch.Generator().manual_seed(9), tparams, CFG_T,
                           DCFG_T)
    return jdraft, tdraft, DCFG_T


def slot_caches8(lengths, T=32, seed=0):
    """The same int8 slot-cache contents (quantized by nanotpu) as a JAX and
    a torch SlotCache8."""
    jc, _ = slot_caches(lengths, T, seed)
    parts = [[je.quantize_kv(x) for x in planes] for planes in (jc.k, jc.v)]
    arrays = [[np.asarray(q) for q, _ in parts[0]],
              [np.asarray(q) for q, _ in parts[1]],
              [np.asarray(s) for _, s in parts[0]],
              [np.asarray(s) for _, s in parts[1]]]
    jc8 = je.SlotCache8(*(tuple(map(jnp.asarray, a)) for a in arrays),
                        jnp.asarray(lengths, jnp.int32))
    tc8 = te.SlotCache8(*(tuple(torch.from_numpy(x.copy()) for x in a)
                          for a in arrays),
                        torch.tensor(lengths, dtype=torch.int32))
    return jc8, tc8


def cache_pair(int8, lengths, seed):
    return slot_caches8(lengths, seed=seed) if int8 else slot_caches(
        lengths, seed=seed)


def assert_any_caches_close(tc, jc):
    """Values within 1e-5 (int8 values exactly), scales within 1e-6 of
    their size, lengths equal."""
    for a, b in zip(tc[:-1], jc[:-1]):
        for x, y in zip(a, b):
            if x.dtype == torch.int8:
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            else:
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           atol=1e-5, rtol=1e-6)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(0).standard_normal((4, 7, 2, 64)).astype(
        np.float32)
    q, s = te.quantize_kv(torch.from_numpy(x))
    jq_, js_ = je.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.shape == (4, 7, 2)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js_))
    back = te.dequantize_kv(q, s, torch.float32)
    # symmetric absmax int8: error <= scale/2 = absmax/254 per element
    absmax = np.abs(x).max(axis=-1, keepdims=True)
    assert (np.abs(back.numpy() - x) <= absmax / 254 + 1e-6).all()


@pytest.mark.parametrize("S", [1, 3])
def test_rows_forward_int8_cache_matches_jax(models, S):
    params, tparams = models
    lengths, advance = [3, 7, 0, 12], [S, S, 0, 1]
    jc, tc = slot_caches8(lengths)
    tokens = np.random.default_rng(S).integers(0, 256, (4, S))
    jlog, jc2 = jax.jit(je._rows_forward, static_argnums=1)(
        params, CFG_J, jc, jnp.asarray(tokens), jnp.asarray(advance, jnp.int32)
    )
    with torch.inference_mode():
        tlog, tc2 = te._rows_forward(tparams, CFG_T, tc,
                                     torch.from_numpy(tokens),
                                     torch.tensor(advance))
    assert isinstance(tc2, te.SlotCache8)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    assert_any_caches_close(tc2, jc2)


@pytest.mark.parametrize("int8", [False, True])
def test_insert_rows_drops_out_of_range_rows_like_jax(int8):
    """A row aimed at slot index == SLOTS (the JAX engine's padding row) is
    dropped, never written: the rest lands as nanotpu's scatter puts it."""
    jc, tc = cache_pair(int8, [5, 1, 9, 20], seed=4)
    rng = np.random.default_rng(5)
    shape = (3, 32, CFG_T.n_kv_heads, CFG_T.head_dim)
    ks = [rng.standard_normal(shape, np.float32) for _ in range(CFG_T.n_layers)]
    vs = [rng.standard_normal(shape, np.float32) for _ in range(CFG_T.n_layers)]
    slots, lengths = [2, 4, 0], [6, 30, 3]  # row 1 is padding
    want = je.insert_rows(jc, [jnp.asarray(k) for k in ks],
                          [jnp.asarray(v) for v in vs],
                          jnp.asarray(slots, jnp.int32),
                          jnp.asarray(lengths, jnp.int32))
    got = te.insert_rows(tc, [torch.from_numpy(k) for k in ks],
                         [torch.from_numpy(v) for v in vs], slots, lengths)
    assert_any_caches_close(got, want)
    assert got.lengths.tolist() == [3, 1, 6, 20]


@pytest.mark.parametrize("int8", [False, True])
def test_speculative_serving_cycle_greedy_matches_jax(models, drafts, int8):
    """One greedy cycle at per-row frontiers with an inactive row: emits,
    counts, next tokens and both caches as the JAX cycle's."""
    params, tparams = models
    jdraft, tdraft, dcfg = drafts
    lengths = [3, 9, 0, 14]
    jc, tc = cache_pair(int8, lengths, seed=6)
    jdc, tdc = slot_caches([l + 1 for l in lengths], seed=7)
    jdc = jdc._replace(k=jdc.k[:1], v=jdc.v[:1])
    tdc = tdc._replace(k=tdc.k[:1], v=tdc.v[:1])
    tokens = np.array([17, 3, 250, 64])
    active = np.array([True, True, False, True])
    temps = np.zeros(4, np.float32)
    cycle = jax.jit(je.speculative_serving_cycle, static_argnums=(2, 3, 10))
    jout = cycle(params, jdraft, CFG_J, DCFG_J, jc, jdc, jnp.asarray(tokens),
                 jnp.asarray(active), jnp.asarray(temps),
                 jax.random.PRNGKey(0), 3)
    with torch.inference_mode():
        tout = te.speculative_serving_cycle(
            tparams, tdraft, CFG_T, dcfg, tc, tdc, torch.from_numpy(tokens),
            torch.from_numpy(active), torch.from_numpy(temps),
            torch.Generator().manual_seed(0), 3)
    for got, want in zip(tout[2:], jout[2:]):  # next tokens, emit, counts
        assert got.tolist() == np.asarray(want).tolist()
    assert_any_caches_close(tout[0], jout[0])
    assert_any_caches_close(tout[1], jout[1])
    assert tout[4].tolist()[2] == 0  # the inactive row emits nothing


@pytest.mark.parametrize("int8", [False, True])
def test_speculative_serving_chunk_greedy_matches_jax(models, drafts, int8):
    """Several cycles with budgets, a frozen row and an eos: the same
    emits, counts, done flags and budgets as the JAX chunk."""
    params, tparams = models
    jdraft, tdraft, dcfg = drafts
    lengths = [4, 6, 2, 8]
    tokens = np.array([5, 6, 7, 8])
    done = np.array([False, False, True, False])
    temps = np.zeros(4, np.float32)
    remaining = np.array([9, 2, 0, 7], np.int32)
    chunk = jax.jit(je.speculative_serving_chunk, static_argnums=(2, 3),
                    static_argnames=("n_cycles", "draft_tokens", "eos_id"))

    def run_jax(eos):
        jc, _ = cache_pair(int8, lengths, seed=8)
        jdc, _ = slot_caches(lengths, seed=9)
        jdc = jdc._replace(k=jdc.k[:1], v=jdc.v[:1])
        return chunk(params, jdraft, CFG_J, DCFG_J, jc, jdc,
                     jnp.asarray(tokens), jnp.asarray(done),
                     jnp.asarray(temps), jnp.asarray(remaining),
                     jax.random.PRNGKey(0), n_cycles=4, draft_tokens=3,
                     eos_id=eos)

    probe = run_jax(-1)
    eos = int(np.asarray(probe[6])[1, 3, 0])  # row 3's first token of cycle 2
    jout = run_jax(eos)
    _, tc = cache_pair(int8, lengths, seed=8)
    _, tdc = slot_caches(lengths, seed=9)
    tdc = tdc._replace(k=tdc.k[:1], v=tdc.v[:1])
    with torch.inference_mode():
        tout = te.speculative_serving_chunk(
            tparams, tdraft, CFG_T, dcfg, tc, tdc, torch.from_numpy(tokens),
            torch.from_numpy(done), torch.from_numpy(temps),
            torch.from_numpy(remaining), torch.Generator().manual_seed(0),
            n_cycles=4, draft_tokens=3, eos_id=eos)
    # tokens, done, remaining, emits, counts
    for got, want in zip(tout[2:], jout[2:4] + jout[4:5] + jout[6:]):
        assert got.tolist() == np.asarray(want).tolist()
    assert_any_caches_close(tout[0], jout[0])


def test_prefill_cache_only_matches_prefill_rows(models):
    _, tparams = models
    prompt = torch.tensor([[9, 8, 7, 6, 5, 0, 0, 0]])
    with torch.inference_mode():
        ks, vs = te.prefill_cache_only(tparams, CFG_T, prompt)
        _, ks2, vs2 = te.prefill_request(tparams, CFG_T, prompt, 5, 0.0,
                                         None)
    assert ks[0].shape == (1, 8, 2, 16)
    for a, b in zip(ks + vs, ks2 + vs2):
        assert torch.equal(a, b)


def sharp(tree):
    return {**tree, "lm_head": tree["lm_head"] * 25.0}


def run_engine(eng, prompts, n, timeout=120):
    try:
        reqs = [eng.submit(p, n) for p in prompts]
        for r in reqs:
            assert r.wait(timeout) and r.error is None, r.error
        return [r.out for r in reqs]
    finally:
        eng.stop()


class TestKvInt8:
    PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9]]

    def test_engine_kv_int8_equals_jax_and_tracks_plain(self, models):
        """The int8-KV engine's greedy tokens equal nanotpu's int8-KV
        engine's; with a sharpened head they agree with the exact engine at
        >= 70% of positions (nanotpu's bound), with the same shapes."""
        params, tparams = models
        jeng = je.Engine(sharp(params), CFG_J, slots=2, max_len=64,
                         buckets=(16,), kv_int8=True, chunk_steps=4,
                         chunk_steps_max=4)
        want = run_engine(jeng, self.PROMPTS, 12)
        outs = {}
        for flag in (False, True):
            eng = te.Engine(sharp(tparams), CFG_T, slots=2, max_len=64,
                            buckets=(16,), kv_int8=flag, device="cpu")
            outs[flag] = run_engine(eng, self.PROMPTS, 12)
        assert outs[True] == want
        agree = total = 0
        for a, b in zip(outs[False], outs[True]):
            assert len(a) == len(b) == 12
            agree += sum(x == y for x, y in zip(a, b))
            total += len(a)
        assert agree / total >= 0.7, (agree / total, outs)

    def test_kv_int8_cache_is_actually_int8(self, models):
        _, tparams = models
        eng = te.Engine(tparams, CFG_T, slots=2, max_len=32, buckets=(16,),
                        kv_int8=True, device="cpu")
        try:
            eng.generate([1, 2, 3], 4)
            assert isinstance(eng._cache, te.SlotCache8)
            assert eng._cache.k[0].dtype == torch.int8
            assert eng._cache.k_scale[0].dtype == torch.float32
        finally:
            eng.stop()

    @pytest.mark.parametrize("kv_int8", [False, True])
    def test_build_engine_int8_weights(self, kv_int8):
        """build_engine(quantize=True) serves QArray weights; its greedy
        tokens are generate()'s on the same quantized tree (the int8 cache
        rounds k/v, so there the engine is held to its own plain twin)."""
        kw = dict(slots=2, max_len=64, device="cpu", buckets=(16,))
        eng = build_engine("tiny", quantize=True, kv_int8=kv_int8, **kw)
        assert isinstance(eng.params["lm_head"], tq.QArray)
        qparams = eng.params
        got = run_engine(eng, [[1, 2, 3], [7, 7, 7, 7]], 6)
        if kv_int8:
            want = run_engine(build_engine("tiny", quantize=True, **kw),
                              [[1, 2, 3], [7, 7, 7, 7]], 6)
            assert sum(a == b for x, y in zip(got, want)
                       for a, b in zip(x, y)) >= 10
        else:
            assert got == [tg.generate(qparams, torch.tensor([p]),
                                       eng.cfg, 6)[0].tolist()
                           for p in ([1, 2, 3], [7, 7, 7, 7])]


def spec_engine(tparams, tdraft, dcfg, **kw):
    kw.setdefault("draft_tokens", 3)
    kw.setdefault("spec_policy", "always")
    return te.Engine(tparams, CFG_T, draft_params=tdraft, draft_cfg=dcfg,
                     device="cpu", **kw)


class TestSpeculativeServing:
    def test_greedy_rows_match_plain_engine_per_slot(self, models, drafts):
        """Every request's tokens equal its solo generate() run under
        staggered mixed-length admission."""
        params, tparams = models
        _, tdraft, dcfg = drafts
        prompts = [[1, 2, 3], [7] * 13, [42], [5, 4, 3, 2, 1, 0, 1, 2, 3, 4],
                   [11, 13, 17, 19]]
        lengths = [12, 5, 17, 9, 14]
        eng = spec_engine(tparams, tdraft, dcfg, slots=4, max_len=128,
                          buckets=(16, 32, 64))
        try:
            reqs = [eng.submit(p, n) for p, n in zip(prompts, lengths)]
            for r, p, n in zip(reqs, prompts, lengths):
                assert r.wait(120) and r.error is None
                assert r.out == ref_greedy(tparams, p, n), (p, n)
            st = eng.stats()
            assert st["spec_cycles_total"] > 0
            assert 1.0 <= st["spec_tokens_per_cycle"] <= 4.0
            assert st["spec_bandit_tok_s"] is None
        finally:
            eng.stop()
        jax_ref = jax.jit(jg.generate, static_argnums=(2, 3))(
            params, jnp.asarray([prompts[3]], jnp.int32), CFG_J, lengths[3])
        assert reqs[3].out == np.asarray(jax_ref)[0].tolist()

    def test_perfect_draft_rows_advance_independently(self, models):
        _, tparams = models
        eng = spec_engine(tparams, tparams, CFG_T, slots=3, max_len=128,
                          buckets=(16, 32), draft_tokens=4)
        prompts = [[3, 1, 4], [2, 7, 1, 8, 2, 8], [9]]
        outs = run_engine(eng, prompts, 11)
        assert outs == [ref_greedy(tparams, p, 11) for p in prompts]
        # every cycle accepted all 4 proposals: 5 tokens a row-cycle
        assert eng.spec_cycle_tokens_total >= 4 * eng.spec_cycles_total

    def test_sampled_rows_finish_and_stay_in_range(self, models, drafts):
        _, tparams = models
        _, tdraft, dcfg = drafts
        eng = spec_engine(tparams, tdraft, dcfg, slots=3, max_len=128,
                          buckets=(16, 32), seed=5)
        try:
            sampled = [eng.submit([4, 2], 13, temperature=0.9)
                       for _ in range(2)]
            greedy = eng.submit([3, 1, 4, 1, 5], 10)
            for r in sampled:
                assert r.wait(120) and r.error is None
                assert len(r.out) == 13
                assert all(0 <= t < CFG_T.vocab_size for t in r.out)
            assert greedy.wait(120) and greedy.error is None
            assert greedy.out == ref_greedy(tparams, [3, 1, 4, 1, 5], 10)
        finally:
            eng.stop()

    def test_eos_mid_acceptance_stops_row(self, models, drafts):
        _, tparams = models
        _, tdraft, dcfg = drafts
        ref = ref_greedy(tparams, [6, 6, 6], 24)
        eos = ref[7]
        eng = spec_engine(tparams, tdraft, dcfg, slots=2, max_len=128,
                          buckets=(16,), eos_id=eos)
        try:
            stopped = eng.submit([6, 6, 6], 24)
            other = eng.submit([1, 2, 3, 4], 12)
            assert stopped.wait(120) and stopped.error is None
            assert stopped.out == ref[: ref.index(eos) + 1]
            assert other.wait(120) and other.error is None
            ref_other = ref_greedy(tparams, [1, 2, 3, 4], 12)
            cut = (ref_other.index(eos) + 1 if eos in ref_other
                   else len(ref_other))
            assert other.out == ref_other[:cut]
        finally:
            eng.stop()


def test_speculative_composes_with_kv_int8(models, drafts):
    """An int8-KV target with a draft: greedy rows equal the plain int8-KV
    engine's and track generate() (nanotpu's slack: >= 6 of 8); the
    draft's cache stays plain."""
    _, tparams = models
    _, tdraft, dcfg = drafts
    prompt = [1, 2, 3, 4]
    plain = run_engine(te.Engine(tparams, CFG_T, slots=2, max_len=64,
                                 buckets=(16,), kv_int8=True, device="cpu"),
                       [prompt], 8)[0]
    eng = spec_engine(tparams, tdraft, dcfg, slots=2, max_len=64,
                      buckets=(16,), kv_int8=True)
    try:
        r = eng.submit(prompt, 8)
        assert r.wait(120) and r.error is None
        assert r.out == plain
        exp = ref_greedy(tparams, prompt, 8)
        assert sum(a == b for a, b in zip(r.out, exp)) >= 6, (r.out, exp)
        assert eng._cache.k[0].dtype == torch.int8
        assert eng._d_cache.k[0].dtype == torch.float32
        assert eng.spec_cycles_total > 0
    finally:
        eng.stop()


class TestAdaptiveSpeculation:
    def test_policy_k_selection(self, models, drafts):
        _, tparams = models
        _, tdraft, dcfg = drafts
        eng = spec_engine(tparams, tdraft, dcfg, slots=8, max_len=128,
                          buckets=(16,), draft_tokens=4,
                          spec_policy=[(2, 4), (6, 2)])
        try:
            assert [eng._policy_k(n) for n in (1, 2, 3, 6, 7, 8)] == \
                [4, 4, 2, 2, 0, 0]
            assert eng._variant_ks == [0, 2, 4]
        finally:
            eng.stop()

    def test_auto_default_speculates_only_at_small_batch(self, models,
                                                         drafts):
        _, tparams = models
        _, tdraft, dcfg = drafts
        eng = te.Engine(tparams, CFG_T, slots=4, max_len=128, buckets=(16,),
                        draft_params=tdraft, draft_cfg=dcfg, draft_tokens=3,
                        device="cpu")
        try:
            assert eng.spec_rules == [(2, 3)]
            assert [eng._policy_k(n) for n in (1, 2, 3)] == [3, 3, 0]
            assert eng._variant_ks == [0, 3]
        finally:
            eng.stop()

    def test_bad_policy_k_rejected(self, models, drafts):
        _, tparams = models
        _, tdraft, dcfg = drafts
        with pytest.raises(ValueError, match="draft_tokens"):
            spec_engine(tparams, tdraft, dcfg, slots=2, max_len=128,
                        buckets=(16,), draft_tokens=2, spec_policy=[(2, 5)])
        with pytest.raises(ValueError, match="draft_cfg"):
            te.Engine(tparams, CFG_T, slots=2, max_len=64,
                      draft_params=tdraft, device="cpu")

    def test_greedy_invariant_across_policy_switch(self, models, drafts):
        """A request that starts under plain chunks (2 active > 1), loses
        its neighbour and finishes under speculative chunks, crossing the
        re-prime path, emits exactly its solo greedy sequence."""
        _, tparams = models
        _, tdraft, dcfg = drafts
        eng = spec_engine(tparams, tdraft, dcfg, slots=2, max_len=128,
                          buckets=(16, 32), chunk_steps=4, chunk_steps_max=8,
                          spec_policy=[(1, 3)])
        reprimes = []
        orig = eng._reprime_draft

        def spy():
            reprimes.append(sorted(eng._draft_stale))
            orig()

        eng._reprime_draft = spy
        try:
            long_req = eng.submit([5, 3, 1], 40)
            short_req = eng.submit([2, 7, 1, 8], 6)
            assert short_req.wait(120) and short_req.error is None
            assert long_req.wait(120) and long_req.error is None
            assert short_req.out == ref_greedy(tparams, [2, 7, 1, 8], 6)
            assert long_req.out == ref_greedy(tparams, [5, 3, 1], 40)
            assert eng.spec_cycles_total > 0, "speculative regime never ran"
            assert reprimes, "re-prime path never exercised"
        finally:
            eng.stop()

    def test_switch_with_kv_int8_target(self, models, drafts):
        _, tparams = models
        _, tdraft, dcfg = drafts
        eng = spec_engine(tparams, tdraft, dcfg, slots=2, max_len=64,
                          buckets=(16,), chunk_steps=4, chunk_steps_max=4,
                          kv_int8=True, spec_policy=[(1, 3)])
        try:
            a = eng.submit([1, 2, 3, 4], 24)
            b = eng.submit([9, 8], 5)
            assert b.wait(120) and b.error is None
            assert a.wait(120) and a.error is None
            assert len(a.out) == 24
            assert all(0 <= t < CFG_T.vocab_size for t in a.out)
            assert eng.spec_cycles_total > 0
        finally:
            eng.stop()


def test_reprime_draft_primes_only_stale_rows(models, drafts):
    """The re-prime writes each stale row's draft cache from its prompt and
    emitted tokens and its length, touches no other slot, and sends no row
    at an index outside the cache (a padding row in the JAX engine)."""
    _, tparams = models
    _, tdraft, dcfg = drafts
    eng = spec_engine(tparams, tdraft, dcfg, slots=4, max_len=64,
                      buckets=(16, 32), spec_policy=[(1, 3)])
    eng.stop()
    reqs = {0: ([1, 2, 3], [4, 5]), 2: ([7] * 20, [9]), 3: ([8, 8], [1, 2])}
    for slot, (prompt, out) in reqs.items():
        r = te.Request(prompt, 10)
        r.out = list(out)
        eng._slot_req[slot] = r
        eng._done[slot] = False
    eng._done[3] = True  # finished: nothing to re-prime
    eng._draft_stale = {0, 2, 3}
    before = [t.clone() for t in eng._d_cache.k + eng._d_cache.v]
    calls = []
    orig = te.insert_rows

    def spy(cache, ks, vs, slots, lengths):
        calls.append((list(slots), list(lengths), ks[0].shape[0]))
        return orig(cache, ks, vs, slots, lengths)

    try:
        te.insert_rows = spy
        with torch.inference_mode():
            eng._reprime_draft()
    finally:
        te.insert_rows = orig
    assert sorted(calls) == [([0], [4], 1), ([2], [20], 1)]
    assert eng._draft_stale == set()
    assert eng._d_cache.lengths.tolist()[0] == 4
    assert eng._d_cache.lengths.tolist()[2] == 20
    after = eng._d_cache.k + eng._d_cache.v
    for slot in (1, 3):  # not stale, or finished: untouched
        for a, b in zip(before, after):
            assert torch.equal(a[slot], b[slot])
    with torch.inference_mode():
        ks, _ = te.prefill_cache_only(
            tdraft, dcfg, torch.tensor([[7] * 20 + [0] * 12]))
    torch.testing.assert_close(eng._d_cache.k[0][2, :20], ks[0][0, :20],
                               rtol=0, atol=0)


class TestMeasuredPolicy:
    def measured(self, models, drafts, **kw):
        _, tparams = models
        _, tdraft, dcfg = drafts
        kw.setdefault("slots", 4)
        kw.setdefault("max_len", 128)
        kw.setdefault("buckets", (16,))
        return spec_engine(tparams, tdraft, dcfg, spec_policy="measured",
                           **kw)

    def test_has_plain_and_spec_arms(self, models, drafts):
        eng = self.measured(models, drafts)
        try:
            assert eng._measured
            assert eng._variant_ks == [0, 3]
            assert eng.stats()["spec_bandit_tok_s"] == {}
        finally:
            eng.stop()

    def test_bandit_explores_then_exploits_and_reprobes(self, models, drafts):
        """Selection logic on a fake clock: both arms explored MIN_SAMPLES
        times, the faster then exploited, the loser re-probed every
        PROBE_EVERY syncs, and a drifted rate flips the arms."""
        eng = self.measured(models, drafts)
        try:
            m = eng.BANDIT_MIN_SAMPLES
            seen = []
            for _ in range(2 * m):
                k = eng._bandit_pick(2)
                seen.append(k)
                eng._bandit_update(2, k, tokens=8, dt=0.1 if k == 3 else 0.2)
            assert seen.count(0) == m and seen.count(3) == m
            picks = [eng._bandit_pick(2)
                     for _ in range(eng.BANDIT_PROBE_EVERY - 1)]
            assert set(picks) == {3}
            assert eng._bandit_pick(2) == 0  # the periodic loser probe
            for _ in range(12):
                eng._bandit_update(2, 0, tokens=64, dt=0.1)
            assert eng._bandit_pick(2) == 0
            assert eng._bandit_pick(4) == 0 and eng._bandit_bucket(3) == 4
            tab = eng.stats()["spec_bandit_tok_s"]
            assert "2/large" in tab and set(tab["2/large"]) == {"0", "3"}
        finally:
            eng.stop()

    def test_bandit_arm_tables_are_keyed_by_chunk_flavor(self, models,
                                                         drafts):
        eng = self.measured(models, drafts)
        try:
            m = eng.BANDIT_MIN_SAMPLES
            for flavor, fast in (("large", 3), ("small", 0)):
                for _ in range(2 * m):
                    k = eng._bandit_pick(2, flavor)
                    eng._bandit_update(2, k, tokens=8,
                                       dt=0.1 if k == fast else 0.2,
                                       flavor=flavor)
            assert eng._bandit_pick(2, "large") == 3
            assert eng._bandit_pick(2, "small") == 0
            assert set(eng.stats()["spec_bandit_tok_s"]) == {"2/large",
                                                             "2/small"}
        finally:
            eng.stop()

    def test_cold_sample_cannot_flip_the_argmax(self, models, drafts):
        eng = self.measured(models, drafts)
        try:
            m = eng.BANDIT_MIN_SAMPLES
            for _ in range(2 * m):
                k = eng._bandit_pick(2, "large")
                eng._bandit_update(2, k, tokens=8, dt=0.1 if k == 3 else 0.2,
                                   flavor="large")
            before = {b: dict(a) for b, a in eng._bandit_rate.items()}
            eng._bandit_update(2, 3, tokens=8, dt=30.0, flavor="large",
                               cold=True)
            assert eng._bandit_rate == before
            assert eng._bandit_pick(2, "large") == 3
        finally:
            eng.stop()

    def test_measured_greedy_invariant(self, models, drafts):
        """Arm switches driven by live timings change no greedy token; both
        arms run."""
        _, tparams = models
        eng = self.measured(models, drafts, slots=2, buckets=(16, 32),
                            chunk_steps=2, chunk_steps_max=4)
        try:
            a = eng.submit([5, 3, 1], 40)
            b = eng.submit([2, 7, 1, 8], 6)
            assert b.wait(120) and b.error is None
            assert a.wait(120) and a.error is None
            assert b.out == ref_greedy(tparams, [2, 7, 1, 8], 6)
            assert a.out == ref_greedy(tparams, [5, 3, 1], 40)
            assert eng.spec_cycles_total > 0, "spec arm never ran"
            assert any(n for b_ in eng._bandit_n.values()
                       for n in b_.values())
        finally:
            eng.stop()


class TestSpecPolicyMisconfigWarning:
    @pytest.mark.parametrize("policy,level", [
        ("measured", "WARNING"), ("always", "WARNING"), ("auto", "INFO"),
    ])
    def test_policy_without_draft_warns(self, models, caplog, policy, level):
        _, tparams = models
        with caplog.at_level("INFO", logger="nanotpu_torch.serving"):
            eng = te.Engine(tparams, CFG_T, slots=2, max_len=64,
                            buckets=(16,), spec_policy=policy, device="cpu")
        try:
            assert not eng._measured and eng.spec_rules == []
            logged = [r for r in caplog.records
                      if "draft_params is None" in r.getMessage()]
            assert logged, f"no fallback log for spec_policy={policy!r}"
            assert logged[0].levelname == level
            assert repr(policy) in logged[0].getMessage()
        finally:
            eng.stop()

    def test_off_without_draft_is_silent(self, models, caplog):
        _, tparams = models
        with caplog.at_level("WARNING", logger="nanotpu_torch.serving"):
            eng = te.Engine(tparams, CFG_T, slots=2, max_len=64,
                            buckets=(16,), spec_policy="off", device="cpu")
        try:
            assert eng.spec_rules == []
            assert not [r for r in caplog.records
                        if "draft_params" in r.getMessage()]
        finally:
            eng.stop()


def test_server_flags_reach_the_engine(monkeypatch):
    """--int8 and --kv-int8 parse with nanotpu's help strings and reach
    build_engine as quantize and kv_int8."""
    help_text = tsrv._parser().format_help()
    assert "weight-only int8" in help_text
    assert "int8 KV cache (halves decode HBM reads)" in help_text
    args = tsrv._parser().parse_args(["--int8", "--kv-int8"])
    assert args.int8 and args.kv_int8
    assert not tsrv._parser().parse_args([]).int8
    seen = {}

    class Stop(Exception):
        pass

    def fake_build(preset, slots, max_len, **kw):
        seen.update(kw, preset=preset)
        raise Stop

    monkeypatch.setattr(tsrv, "build_engine", fake_build)
    with pytest.raises(Stop):
        tsrv.main(["--preset", "tiny", "--int8", "--kv-int8", "--device",
                   "cpu"])
    assert seen["quantize"] and seen["kv_int8"] and seen["preset"] == "tiny"


# -- fourth group: the chunk bodies, and the engine's units on fixed tensors

def unrefactored_serving_chunk(params, cfg, cache, tokens, done, temps,
                               remaining, generator, n_steps, eos_id=-1,
                               top_k=0, top_p=1.0):
    """serving_chunk as it was before its body became serving_chunk_step."""
    toks = []
    for _ in range(n_steps):
        active = ~done
        nxt, cache = te.serving_step(
            params, cfg, cache, tokens, active, temps, generator,
            top_k=top_k, top_p=top_p,
        )
        tokens = torch.where(done, tokens, nxt)
        remaining = remaining - active.to(remaining.dtype)
        done = done | (remaining <= 0)
        if eos_id >= 0:
            done = done | (tokens == eos_id)
        toks.append(tokens)
    return cache, tokens, done, remaining, torch.stack(toks)


def unrefactored_speculative_chunk(params, draft_params, cfg, dcfg, cache,
                                   d_cache, tokens, done, temps, remaining,
                                   generator, n_cycles, draft_tokens,
                                   eos_id=-1, top_k=0, top_p=1.0):
    """speculative_serving_chunk as it was before its body became
    speculative_chunk_cycle."""
    K = draft_tokens
    emits, counts = [], []
    for _ in range(n_cycles):
        cache, d_cache, tokens, emit, count = te.speculative_serving_cycle(
            params, draft_params, cfg, dcfg, cache, d_cache, tokens, ~done,
            temps, generator, K, top_k=top_k, top_p=top_p,
        )
        remaining = remaining - count
        done = done | (remaining <= 0)
        if eos_id >= 0:
            valid = torch.arange(K + 1)[None, :] < count[:, None]
            done = done | (valid & (emit == eos_id)).any(dim=1)
        emits.append(emit)
        counts.append(count)
    return (cache, d_cache, tokens, done, remaining, torch.stack(emits),
            torch.stack(counts))


#: the carry of the fourth group's chunks: a frozen row, per-row budgets,
#: two greedy and two sampled rows (the bodies draw the same uniforms in the
#: same order as the loops they came from, so sampled rows match exactly)
CARRY = dict(tokens=[5, 6, 7, 8], done=[False, False, True, False],
             temps=[0.0, 0.9, 0.0, 1.3], remaining=[9, 2, 0, 7])


def carry():
    return (torch.tensor(CARRY["tokens"]), torch.tensor(CARRY["done"]),
            torch.tensor(CARRY["temps"]),
            torch.tensor(CARRY["remaining"], dtype=torch.int32))


def chunk_inputs(int8, spec):
    """(target cache, draft cache or None) of the fourth group."""
    lengths = [4, 6, 2, 8]
    _, tc = cache_pair(int8, lengths, seed=8)
    if not spec:
        return tc, None
    _, tdc = slot_caches(lengths, seed=9)
    return tc, tdc._replace(k=tdc.k[:1], v=tdc.v[:1])


def assert_same(a, b):
    if isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert torch.equal(a, b), (a, b)


@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("eos", [-1, 7])
def test_chunk_bodies_looped_equal_the_unrefactored_chunks(models, drafts,
                                                           spec, int8, eos):
    """serving_chunk (a loop of serving_chunk_step) and
    speculative_serving_chunk (a loop of speculative_chunk_cycle) give the
    outputs of the loops they were split out of, bit for bit: caches,
    tokens, done flags, budgets and the token blocks."""
    _, tparams = models
    _, tdraft, dcfg = drafts
    outs = []
    for fns in ((te.serving_chunk, te.speculative_serving_chunk),
                (unrefactored_serving_chunk, unrefactored_speculative_chunk)):
        tc, tdc = chunk_inputs(int8, spec)
        gen = torch.Generator().manual_seed(3)
        with torch.inference_mode():
            if spec:
                outs.append(fns[1](tparams, tdraft, CFG_T, dcfg, tc, tdc,
                                   *carry(), gen, n_cycles=4, draft_tokens=3,
                                   eos_id=eos, top_k=50))
            else:
                outs.append(fns[0](tparams, CFG_T, tc, *carry(), gen,
                                   n_steps=6, eos_id=eos, top_p=0.9))
    assert_same(outs[0], outs[1])


@pytest.mark.parametrize("k", [0, 3])
@pytest.mark.parametrize("int8", [False, True])
def test_engine_units_on_fixed_tensors_equal_the_chunk(models, drafts, k,
                                                       int8):
    """The engine's unit bodies (what it captures as CUDA graphs on a card,
    and runs eagerly here) replayed n times over its fixed tensors equal
    one n-step chunk: the carry and the cache lengths are written back in
    place, each unit's output lands in the next row of the chunk's block,
    and no tensor the units read is replaced."""
    _, tparams = models
    _, tdraft, dcfg = drafts
    policy = [(4, k)] if k else "off"
    eng = te.Engine(tparams, CFG_T, slots=4, max_len=32, buckets=(16,),
                    kv_int8=int8, draft_params=tdraft, draft_cfg=dcfg,
                    draft_tokens=3, spec_policy=policy, eos_id=7,
                    top_k=50, device="cpu")
    assert eng.wait_warm(60)
    eng.stop()
    assert not eng.cuda_graphs and eng.graphs == {}
    tc, tdc = chunk_inputs(int8, spec=k > 0)
    for mine, theirs in ((eng._cache, tc), (eng._d_cache, tdc)):
        for a, b in zip(mine, theirs or ()):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                x.copy_(y)
    tc, tdc = chunk_inputs(int8, spec=k > 0)
    b = eng._bufs
    tokens, done, temps, remaining = carry()
    b.upload(tokens.numpy(), temps.numpy(), done.numpy(), remaining.numpy())
    fixed = [t.data_ptr() for t in (b.tokens, b.done, b.remaining,
                                    eng._cache.lengths, *eng._cache.k)]
    n = 4
    eng._gen = torch.Generator().manual_seed(5)
    gen = torch.Generator().manual_seed(5)
    with torch.inference_mode():
        b.start()
        for _ in range(n):
            eng._spec_unit(k) if k else eng._plain_unit()
        if k:
            want = te.speculative_serving_chunk(
                tparams, tdraft, CFG_T, dcfg, tc, tdc, tokens, done, temps,
                remaining, gen, n_cycles=n, draft_tokens=k, eos_id=7,
                top_k=50)
            assert torch.equal(b.emits[k][:n], want[5])
            assert torch.equal(b.counts[k][:n], want[6])
            assert torch.equal(eng._d_cache.lengths, want[1].lengths)
            carried = want[2:5]
        else:
            want = te.serving_chunk(tparams, CFG_T, tc, tokens, done, temps,
                                    remaining, gen, n_steps=n, eos_id=7,
                                    top_k=50)
            assert torch.equal(b.toks[:n], want[4])
            carried = want[1:4]
    assert_same(eng._cache, want[0])
    for got, w in zip((b.tokens, b.done, b.remaining), carried):
        assert torch.equal(got, w)
    assert int(b.step) == n
    assert fixed == [t.data_ptr() for t in (b.tokens, b.done, b.remaining,
                                            eng._cache.lengths,
                                            *eng._cache.k)]


def test_cuda_graphs_need_a_card(models):
    """cuda_graphs=True refuses the CPU; the default there is eager."""
    _, tparams = models
    with pytest.raises(ValueError, match="cuda_graphs=True needs a cuda"):
        te.Engine(tparams, CFG_T, slots=1, max_len=32, device="cpu",
                  cuda_graphs=True)
    eng = te.Engine(tparams, CFG_T, slots=1, max_len=32, buckets=(16,),
                    device="cpu")
    try:
        assert eng.wait_warm(60)
        assert eng.cuda_graphs is False and eng.graphs == {}
        assert eng._units[0] == eng._plain_unit
    finally:
        eng.stop()


# -- fifth group: Mixtral MoE serving ---------------------------------------
# tests/test_serving.py's TestMoEServing, TestMoEDropCounter and
# TestSpeculativeMoEServing on the port, nanotpu's MixtralConfig.tiny()
# parameters carried over; the MoE building blocks against the JAX
# engine's (logits atol 1e-4, drop counts exactly equal).

MCFG_J, MCFG_T = jm.MixtralConfig.tiny(), tm.MixtralConfig.tiny()
MOE_PROMPTS = [[5, 6, 7], [9, 8], [1, 2, 3, 4, 5, 6]]


def moe_params(cfg_j=MCFG_J):
    params = jax.jit(jm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg_j)
    return params, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")


@pytest.fixture(scope="module")
def moe_models():
    return moe_params()


@pytest.mark.parametrize("S", [1, 3])
def test_rows_forward_moe_matches_jax(moe_models, S):
    """Full-capacity routing of every (row, position) at per-row
    frontiers: the decode step (S=1) and a speculative verify (S=3)."""
    params, tparams = moe_models
    lengths, advance = [3, 7, 0, 12], [S, S, 0, 1]
    jc, tc = slot_caches(lengths)
    tokens = np.random.default_rng(S).integers(0, 256, (4, S))
    jlog, jc2 = jax.jit(je._rows_forward, static_argnums=1)(
        params, MCFG_J, jc, jnp.asarray(tokens),
        jnp.asarray(advance, jnp.int32))
    with torch.inference_mode():
        tlog, tc2 = te._rows_forward(tparams, MCFG_T, tc,
                                     torch.from_numpy(tokens),
                                     torch.tensor(advance))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    assert_caches_close(tc2, jc2)


@pytest.mark.parametrize("cf", [0.05, 8.0])
def test_prefill_request_counts_drops_like_jax(cf):
    """The first token and the drop count of one padded admission prefill
    (10 real tokens in a 16-token bucket: the pads are left out)."""
    cfg_j = dataclasses.replace(MCFG_J, capacity_factor=cf)
    cfg_t = dataclasses.replace(MCFG_T, capacity_factor=cf)
    params, tparams = moe_params(cfg_j)
    padded = np.zeros((1, 16), np.int64)
    padded[0, :10] = np.arange(1, 11)
    prefill = jax.jit(je.prefill_request, static_argnums=(1, 3, 4),
                      static_argnames=("count_drops",))
    jfirst, _, _, jdrops = prefill(params, cfg_j, jnp.asarray(padded), 10, 32,
                                   jnp.float32(0.0), jax.random.PRNGKey(0),
                                   count_drops=True)
    with torch.inference_mode():
        first, ks, _, drops = te.prefill_request(
            tparams, cfg_t, torch.from_numpy(padded), 10, 0.0, None,
            count_drops=True)
    assert int(first) == int(jfirst)
    assert drops.dtype == torch.int32 and int(drops) == int(jdrops)
    assert (int(drops) > 0) == (cf == 0.05)
    assert len(ks) == cfg_t.n_layers


class TestMoEServing:
    def test_mixtral_rows_independent_of_batch_mates(self, moe_models):
        """Decode routes at full capacity (C = SLOTS * top_k), so each
        request's tokens are the same alone and co-batched, exactly, at the
        default capacity factor."""
        _, tparams = moe_models

        def run(co_batched: bool) -> list[list[int]]:
            eng = te.Engine(tparams, MCFG_T, slots=3, max_len=64,
                            buckets=(16,), device="cpu")
            try:
                if co_batched:
                    reqs = [eng.submit(p, 8) for p in MOE_PROMPTS]
                    for r in reqs:
                        assert r.wait(60) and r.error is None
                    return [r.out for r in reqs]
                return [eng.generate(p, 8) for p in MOE_PROMPTS]
            finally:
                eng.stop()

        assert run(co_batched=True) == run(co_batched=False)

    def test_mixtral_engine_consistent_with_model(self, moe_models):
        """tests/test_serving.py's criterion: every emitted token is the
        teacher-forced argmax of nanotpu's drop-free forward (capacity
        factor 64) or within a logit gap of 2.0 of it. The engine's
        prefill routes at capacity over the padded bucket and its decode at
        full capacity, so a close call may go either way; a wrong rope
        position or a corrupt cache lands far from any argmax."""
        params, tparams = moe_models
        teacher_cfg = dataclasses.replace(MCFG_J, capacity_factor=64.0)
        eng = te.Engine(tparams, MCFG_T, slots=3, max_len=64, buckets=(16,),
                        device="cpu")
        try:
            reqs = [eng.submit(p, 8) for p in MOE_PROMPTS]
            for r in reqs:
                assert r.wait(60) and r.error is None
        finally:
            eng.stop()
        forward = jax.jit(jm.forward, static_argnums=2)
        for p, r in zip(MOE_PROMPTS, reqs):
            seq = p + r.out
            logits, _ = forward(params, jnp.asarray([seq[:-1]], jnp.int32),
                                teacher_cfg)
            rows = np.asarray(logits[0])
            for i in range(len(p) - 1, len(seq) - 1):
                top, tok = int(rows[i].argmax()), seq[i + 1]
                gap = float(rows[i][top] - rows[i][tok])
                assert gap < 2.0, (p, i, tok, top, gap)


class TestMoEDropCounter:
    """Prefill capacity drops are counted over real tokens, reported by
    ``stats()`` and on ``/metrics``."""

    def _engine(self, capacity_factor):
        cfg_j = dataclasses.replace(MCFG_J, capacity_factor=capacity_factor)
        _, tparams = moe_params(cfg_j)
        cfg_t = dataclasses.replace(MCFG_T, capacity_factor=capacity_factor)
        return te.Engine(tparams, cfg_t, slots=2, max_len=64, buckets=(16,),
                         device="cpu")

    def test_tight_capacity_counts_drops_and_serves(self):
        # capacity factor ~0: one slot an expert over the 16-token bucket,
        # so prefill drops; decode (full capacity) still completes
        eng = self._engine(0.05)
        try:
            req = eng.submit([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 6)
            assert req.wait(60) and req.error is None
            assert len(req.out) == 6
            assert eng.moe_prefill_dropped_total > 0
            assert (eng.stats()["moe_prefill_dropped_total"]
                    == eng.moe_prefill_dropped_total)
            text = ServingAPI(eng).registry.render()
            line = [ln for ln in text.splitlines() if ln.startswith(
                "nanotpu_serve_moe_prefill_dropped_tokens_total ")]
            assert line and float(line[0].split()[1]) == \
                eng.moe_prefill_dropped_total, text
        finally:
            eng.stop()

    def test_loose_capacity_drops_zero(self):
        eng = self._engine(8.0)
        try:
            req = eng.submit([1, 2, 3], 6)
            assert req.wait(60) and req.error is None
            assert eng.moe_prefill_dropped_total == 0
            assert eng.stats()["moe_prefill_dropped_total"] == 0
        finally:
            eng.stop()

    def test_dense_engine_counts_nothing(self, models):
        _, tparams = models
        eng = te.Engine(tparams, CFG_T, slots=1, max_len=32, buckets=(16,),
                        device="cpu")
        try:
            assert eng._count_drops is False
            assert eng.generate([1, 2, 3], 2)
            assert eng.stats()["moe_prefill_dropped_total"] == 0
        finally:
            eng.stop()


class TestSpeculativeMoEServing:
    def test_moe_target_dense_draft_greedy_exact(self, moe_models):
        """A dense draft tied to the Mixtral target's embed and head
        (``truncate=False``) proposes, the MoE target verifies at full
        expert capacity: greedy rows equal the plain engine's."""
        _, tparams = moe_models
        dcfg = tl.LlamaConfig(
            vocab_size=MCFG_T.vocab_size, dim=MCFG_T.dim, n_layers=1,
            n_heads=MCFG_T.n_heads, n_kv_heads=MCFG_T.n_kv_heads,
            ffn_dim=MCFG_T.ffn_dim, max_seq_len=MCFG_T.max_seq_len,
            dtype=MCFG_T.dtype,
        )
        draft = td.init_draft(torch.Generator().manual_seed(1), tparams,
                              MCFG_T, dcfg, truncate=False)
        assert draft["lm_head"] is tparams["lm_head"]

        def run(with_draft):
            kw = dict(slots=3, max_len=64, buckets=(16,), device="cpu")
            if with_draft:
                kw.update(draft_params=draft, draft_cfg=dcfg,
                          draft_tokens=3, spec_policy="always")
            eng = te.Engine(tparams, MCFG_T, **kw)
            try:
                reqs = [eng.submit(p, 8) for p in MOE_PROMPTS]
                for r in reqs:
                    assert r.wait(120) and r.error is None, r.error
                if with_draft:
                    assert eng.spec_cycles_total > 0
                return [r.out for r in reqs]
            finally:
                eng.stop()

        assert run(True) == run(False)


# -- sixth group: the prefill length ----------------------------------------

#: prompts of 130-400 tokens: one bucket of (16, 512), four prefill lengths
LONG_PROMPTS = [np.random.default_rng(n).integers(0, 256, n).tolist()
                for n in (130, 200, 300, 400)]


@pytest.fixture(scope="module")
def wide_engines(models, moe_models):
    """Engines at max_len 8192 over the default buckets: dense, and MoE
    at a Switch capacity that can drop (1.25 x top-2 of 4 experts) and at
    the dropless one (2.0 x top-2 = 4)."""
    kw = dict(slots=1, max_len=8192, device="cpu")
    engines = {"dense": te.Engine(models[1], CFG_T, **kw)}
    for cf in (1.25, 2.0):
        engines[cf] = te.Engine(
            moe_models[1], dataclasses.replace(MCFG_T, capacity_factor=cf),
            **kw)
    yield engines
    for eng in engines.values():
        eng.stop()


@pytest.mark.parametrize("n, want", [(20, 32), (128, 128), (129, 256),
                                     (3072, 3072), (3073, 3200),
                                     (7168, 7168), (8191, 8192)])
def test_prefill_len_rounds_up_to_the_flash_block(wide_engines, n, want):
    eng = wide_engines["dense"]
    assert eng.buckets == te.DEFAULT_BUCKETS + (8192,)
    assert eng._prefill_len(n) == want
    assert te.prefill_len(n, eng.buckets) == want


def test_prefill_len_is_within_a_block_and_never_above_its_bucket(
        wide_engines):
    eng = wide_engines["dense"]
    for n in range(1, 8193):
        got = eng._prefill_len(n)
        bucket = next(b for b in eng.buckets if n <= b)
        assert n <= got <= bucket, n
        if n <= te.PREFILL_BLOCK:
            assert got == bucket, n
        else:
            assert got % te.PREFILL_BLOCK == 0, n
            assert got - n < te.PREFILL_BLOCK, n


@pytest.mark.parametrize("cf, n, want", [(1.25, 1100, 2048),
                                         (1.25, 3073, 8192),
                                         (2.0, 1100, 1152),
                                         (2.0, 3073, 3200)])
def test_moe_prefill_len_keeps_the_bucket_where_capacity_can_drop(
        wide_engines, cf, n, want):
    """A capacity-bound MoE's C is a share of the padded length, so it
    keeps the bucket; the dropless one (C = T) takes the rounded length."""
    assert wide_engines[cf]._prefill_len(n) == want


def variant_engines(models, drafts, variant, slots):
    """(a JAX engine, a maker of port engines) at max_len 512 over buckets
    (16, 512): plain, with an int8 KV cache (a sharpened head, as in
    TestKvInt8), or with a draft speculating at every occupancy."""
    params, tparams = models
    jdraft, tdraft, dcfg = drafts
    jkw = dict(slots=slots, max_len=512, buckets=(16, 512))
    tkw = dict(jkw, device="cpu")
    if variant == "kv_int8":
        params, tparams = sharp(params), sharp(tparams)
        jkw["kv_int8"] = tkw["kv_int8"] = True
    if variant == "draft":
        spec = dict(draft_tokens=3, spec_policy="always")
        jkw.update(spec, draft_params=jdraft, draft_cfg=DCFG_J)
        tkw.update(spec, draft_params=tdraft, draft_cfg=dcfg)
    return (je.Engine(params, CFG_J, chunk_steps=4, chunk_steps_max=4,
                      **jkw),
            lambda: te.Engine(tparams, CFG_T, **tkw))


@pytest.mark.parametrize("variant", ["plain", "kv_int8", "draft"])
def test_rounded_prefill_serves_the_jax_engines_greedy_tokens(models, drafts,
                                                              variant):
    """The JAX engine pads every prompt of 130-400 tokens to 512, the
    port to 256, 256, 384 and 512: the same greedy tokens, from a plain
    engine, an int8-KV one and one with a draft, whose prime runs at the
    port's prefill length."""
    jeng, port = variant_engines(models, drafts, variant, slots=2)
    want = run_engine(jeng, LONG_PROMPTS, 8)
    eng = port()
    assert [eng._prefill_len(len(p)) for p in LONG_PROMPTS] == [256, 256,
                                                                384, 512]
    assert run_engine(eng, LONG_PROMPTS, 8) == want
    if variant == "draft":
        assert eng.spec_cycles_total > 0


@pytest.mark.parametrize("variant", ["plain", "kv_int8", "draft"])
def test_a_slots_stale_rows_past_its_frontier_change_no_token(models, drafts,
                                                              variant):
    """Admission writes only the prefilled positions, so one slot that
    served a 400-token prompt keeps those rows past a 5-token prompt's 16:
    the short prompt's greedy tokens equal a fresh engine's and the JAX
    engine's all the same, plain, with an int8 KV cache and with a
    draft (whose row is stale too)."""
    short = [3, 1, 4, 1, 5]
    jeng, port = variant_engines(models, drafts, variant, slots=1)
    want = run_engine(jeng, [short], 8)
    assert run_engine(port(), [short], 8) == want
    eng = port()
    try:
        assert len(eng.generate(LONG_PROMPTS[-1], 8)) == 8
        assert eng.generate(short, 8) == want[0]
    finally:
        eng.stop()
    caches = [eng._cache] + ([eng._d_cache] if variant == "draft" else [])
    for cache in caches:  # the long prompt's rows are still there
        assert cache.k[0][0, 16:400].any()


def test_capacity_bound_moe_admission_drops_like_the_jax_engine():
    """At capacity factor 0.5 a prompt of 300 or 400 tokens in the 512
    bucket overflows its experts (C = 128): the port keeps the bucket,
    so it drops exactly the JAX engine's real tokens."""
    cfg_j = dataclasses.replace(MCFG_J, capacity_factor=0.5)
    cfg_t = dataclasses.replace(MCFG_T, capacity_factor=0.5)
    params, tparams = moe_params(cfg_j)
    prompts = LONG_PROMPTS[2:]
    jeng = je.Engine(params, cfg_j, slots=2, max_len=512, buckets=(16, 512),
                     chunk_steps=2, chunk_steps_max=2)
    run_engine(jeng, prompts, 2)
    eng = te.Engine(tparams, cfg_t, slots=2, max_len=512, buckets=(16, 512),
                    device="cpu")
    assert [eng._prefill_len(len(p)) for p in prompts] == [512, 512]
    run_engine(eng, prompts, 2)
    assert eng.moe_prefill_dropped_total > 0
    assert eng.moe_prefill_dropped_total == jeng.moe_prefill_dropped_total


def test_prefill_spans_carry_the_length_prefilled(models):
    """Each ``engine.prefill`` span's ``bucket`` count is the length its
    prompt was prefilled at, which ``prefill_true_share.serve`` reads."""
    _, tparams = models
    prompts = [[1, 2, 3]] + LONG_PROMPTS
    eng = te.Engine(tparams, CFG_T, slots=2, max_len=512, buckets=(16, 512),
                    device="cpu")
    spans.clear()
    try:
        assert eng.wait_warm(60)
        spans.enable(True)
        run_engine(eng, prompts, 2)
    finally:
        eng.stop()
        spans.enable(False)
    found = [s for s in spans.recorded() if s.name == "engine.prefill"]
    spans.clear()
    assert sorted(s.counts["tokens"] for s in found) == sorted(
        map(len, prompts))
    for s in found:
        assert s.counts["bucket"] == eng._prefill_len(s.counts["tokens"])
    assert sorted(s.counts["bucket"] for s in found) == [16, 256, 256, 384,
                                                         512]
