"""The benchmark at a size the CPU holds: the cells of BENCHMARK.json with
tiny float32 configurations and short traffic, for the harness's tests."""

from __future__ import annotations

import torch

from gpubench.run import run_cell
from gpubench.spec import Bench

#: the served vocabulary is wide enough that int8's errors reorder its top
#: logits within a second's tokens (at 256 they seldom do)
DENSE = {
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 128, "num_hidden_layers": 2, "vocab_size": 4096,
    "max_position_embeddings": 512, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5, "torch_dtype": "float32", "hidden_act": "silu",
    "model_type": "mistral", "sliding_window": None,
    "tie_word_embeddings": False,
}
#: a served Mixtral states no capacity: the published, dropless model
MOE_SERVED = dict(DENSE, model_type="mixtral", num_local_experts=4,
                  num_experts_per_tok=2, router_aux_loss_coef=0.02)
MOE = dict(MOE_SERVED, vocab_size=256, assumed={"capacity_factor": 1.25})
#: float32 on both sides: the program and the reference agree to ~1e-6
LIMIT = 1e-3



class TinyBench(Bench):
    """Every cell of the real benchmark, at a tiny size."""

    def config(self, cell):
        if super().config(cell)["model_type"] != "mixtral":
            return DENSE
        return MOE if self.traffic(cell)["driver"] == "train" else MOE_SERVED

    def traffic(self, cell):
        t = super().traffic(cell)
        if t["driver"] == "serve_closed":
            t.update(
                engine={"slots": 4, "max_len": 256}, clients=4,
                ramp_seconds=0.3,
                prompt={"dist": "lognormal", "median": 40, "sigma": 0.9,
                        "min": 8, "max": 150},
                output={"dist": "lognormal", "median": 8, "sigma": 0.8,
                        "min": 2, "max": 20},
                block=16, sample_tokens=400)
        else:
            t.update(batch=2, seq=64, pool_steps=8)
        return t

    def limits(self, cell):
        return {k: {"limit": LIMIT} for k in super().limits(cell)}


def run(cell: str, seed: int = 2**31 + 11, seconds: float = 1.0,
        control: str | None = None, bench: TinyBench | None = None) -> dict:
    return run_cell(bench or TinyBench(), cell, seed, seconds, False,
                    torch.device("cpu"), control=control)


def serving_cells() -> list[str]:
    b = Bench()
    return [c["name"] for c in b.spec["workloads"]
            if b.traffic(c)["driver"] == "serve_closed"]


def training_cells() -> list[str]:
    b = Bench()
    return [c["name"] for c in b.spec["workloads"]
            if b.traffic(c)["driver"] == "train"]
