"""The port's serving bench (``nanotpu_torch/serving/bench.py``) against
nanotpu's (``nanotpu/serving/bench.py``): the same flags (and ``--device``)
and the same JSON keys. nanotpu's ``run`` is driven here over the port's
engine on the CPU (its ``build_engine`` swapped for the port's): that gives
nanotpu's key set without compiling a JAX engine."""

import ast
import json
from pathlib import Path

import pytest
import torch

import nanotpu.serving.bench as jbench
from nanotpu_torch.serving import bench as tbench
from nanotpu_torch.serving.server import build_engine

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
#: a few requests through the tiny preset on the CPU (prompts of 8 tokens:
#: every bench length is filtered out at this max_len)
TINY = dict(slots=2, max_len=64, requests=4, max_new=4)


def nanotpu_keys(monkeypatch, int8, kv_int8):
    """The keys of nanotpu's run, driven over the port's CPU engine."""
    def port_engine(preset, slots, max_len, quantize, kv_int8=False):
        return build_engine(preset, slots, max_len, quantize=quantize,
                            kv_int8=kv_int8, device="cpu")

    monkeypatch.setattr(jbench, "build_engine", port_engine)
    return set(jbench.run("tiny", TINY["slots"], TINY["max_len"], int8,
                          TINY["requests"], TINY["max_new"],
                          kv_int8=kv_int8))


@pytest.mark.parametrize("int8,kv_int8", [(False, False), (True, True)])
def test_run_gives_nanotpus_keys_and_ordered_percentiles(monkeypatch, int8,
                                                         kv_int8):
    out = tbench.run("tiny", TINY["slots"], TINY["max_len"], int8,
                     TINY["requests"], TINY["max_new"], kv_int8=kv_int8,
                     device="cpu")
    assert set(out) == nanotpu_keys(monkeypatch, int8, kv_int8)
    assert (out["preset"], out["int8"], out["kv_int8"]) == ("tiny", int8,
                                                            kv_int8)
    assert out["prompt_lengths"] == [8]
    assert out["wall_s"] > 0 and out["decode_tokens_per_s"] > 0
    # each request's TTFT is within its latency, so every order statistic
    # of the TTFTs is at most the same one of the latencies
    assert 0 < out["ttft_p50_ms"] <= out["ttft_p99_ms"]
    assert out["latency_p50_ms"] <= out["latency_p99_ms"]
    assert out["ttft_p50_ms"] <= out["latency_p50_ms"]
    assert out["ttft_p99_ms"] <= out["latency_p99_ms"]


def _flags(path: Path) -> set:
    """The option strings of every ``add_argument`` call in a file."""
    return {arg.value for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", "") == "add_argument"
            for arg in node.args if isinstance(arg, ast.Constant)}


def test_flags_are_nanotpus_and_device():
    assert _flags(REPO / "nanotpu_torch/serving/bench.py") == _flags(
        REPO / "nanotpu/serving/bench.py") | {"--device"}


def test_main_prints_one_json_line(capsys):
    tbench.main(["--preset", "tiny", "--device", "cpu", "--slots", "2",
                 "--max-len", "64", "--requests", "3", "--max-new", "3",
                 "--int8"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["int8"] is True and out["kv_int8"] is False
    assert out["requests"] == 3 and out["max_new_tokens"] == 3


def test_main_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is real")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbench.main(["--preset", "tiny", "--max-len", "64"])
