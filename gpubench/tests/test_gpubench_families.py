"""Every model family under every driver kind. The references each driver
calls equal the port at tiny float32 sizes on the CPU: the Mixtral
serving forward (dropless, as published) and the Mistral training loss.
Then every pair of a configuration and a driver kind that no cell of
``BENCHMARK.json`` runs is added to a copy of the benchmark as new files
and entries alone, run at the tiny size, found correct, and failed by its
controls."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from gpubench.families import mistral, mixtral
from gpubench.reference import dense, moe
from gpubench.spec import ROOT, Bench
from gpubench.tests import tiny
from gpubench.tests.tiny import DENSE, MOE, MOE_SERVED
from gpubench.yardstick import weights
from gpubench.yardstick.flops import Shape

SEED = 2**32 + 5


def _tree(conf):
    return weights.tree(Shape.of(conf), SEED, torch.float32, "cpu")


def _tokens(conf, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, conf["vocab_size"], shape, generator=g)


def test_a_config_without_capacity_is_dropless_in_the_port():
    cfg, _ = mixtral.port(MOE_SERVED)
    E, k = MOE_SERVED["num_local_experts"], MOE_SERVED["num_experts_per_tok"]
    assert cfg.capacity_factor == E / k
    assert mixtral.port(MOE)[0].capacity_factor == 1.25


def test_moe_logits_equal_the_port_forward_at_full_capacity():
    from nanotpu_torch.models import mixtral as port_mixtral

    cfg, _ = mixtral.port(MOE_SERVED)
    tree = _tree(MOE_SERVED)
    toks = _tokens(MOE_SERVED, (37,))
    want = port_mixtral.forward(tree, toks[None], cfg)[0][0]
    got = moe.logits(tree, MOE_SERVED, toks.tolist(), range(0, 37))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    part = moe.logits(tree, MOE_SERVED, toks.tolist(), range(20, 30))
    torch.testing.assert_close(part, want[20:30], rtol=1e-4, atol=1e-4)
    assert mixtral.reference_logits is moe.logits


def test_the_serving_reference_sees_the_ports_drops():
    # a router of zeros ties every expert: each token's first choice is
    # expert 0 and its second expert 1, so at Switch capacity 1.25 (C =
    # ceil(1.25 T 2 / 4) < T) the later tokens' choices are dropped
    from nanotpu_torch.models import mixtral as port_mixtral

    tree = _tree(MOE_SERVED)
    for layer in tree["layers"]:
        layer["moe"]["router"].zero_()
    toks = _tokens(MOE_SERVED, (37,), seed=1)
    ref = moe.logits(tree, MOE_SERVED, toks.tolist(), range(0, 37))
    stated = dict(MOE_SERVED, assumed={"capacity_factor": 1.25})
    switch = port_mixtral.forward(tree, toks[None], mixtral.port(stated)[0])[0][0]
    assert (ref - switch).abs().max() > tiny.LIMIT
    dropless = port_mixtral.forward(tree, toks[None],
                                    mixtral.port(MOE_SERVED)[0])[0][0]
    torch.testing.assert_close(ref, dropless, rtol=1e-4, atol=1e-4)


def test_dense_loss_and_gradients_equal_the_port():
    cfg, loss_fn = mistral.port(DENSE)
    tree = _tree(DENSE)
    leaves = weights.leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    toks = _tokens(DENSE, (3, 41))
    want = loss_fn(tree, toks, cfg)
    want_g = torch.autograd.grad(want, leaves)
    got = mistral.reference_loss(tree, DENSE, toks)
    got_g = torch.autograd.grad(got, leaves)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert mistral.reference_loss is dense.loss


#: the controls and faults that each driver kind's cells must fail
CONTROLS = {"serve_closed": ("int8",),
            "train": ("fp8", "half_batch", "unchanged")}


def _crossed(bench: Bench) -> list[tuple[str, dict]]:
    """(configuration, donor cell) of every configuration under each driver
    kind that no cell runs it with: the donor is the first cell of that
    kind, whose traffic mix and limits the new cell takes."""
    first, have = {}, set()
    for cell in bench.spec["workloads"]:
        kind = bench.traffic(cell)["driver"]
        first.setdefault(kind, cell)
        have.add((cell["config"], kind))
    return [(conf["name"], donor) for conf in bench.spec["configs"]
            for kind, donor in first.items() if (conf["name"], kind) not in have]


def _name(config: str, donor: dict) -> str:
    return f"{config}.{donor['traffic']}"


#: crossed cell -> its driver kind
KIND = {_name(c, d): Bench().traffic(d)["driver"] for c, d in _crossed(Bench())}
CROSSED = sorted(KIND)


def test_every_configuration_meets_every_driver_kind():
    bench = Bench()
    cells = bench.spec["workloads"]
    kinds = {bench.traffic(c)["driver"] for c in cells}
    met = {(c["config"], bench.traffic(c)["driver"]) for c in cells}
    met |= {(config, bench.traffic(donor)["driver"])
            for config, donor in _crossed(bench)}
    assert met == {(conf["name"], kind) for conf in bench.spec["configs"]
                   for kind in kinds}


@pytest.fixture(scope="module")
def crossed_bench(tmp_path_factory):
    """A copy of the benchmark with every crossed pair added as a cell: a
    new entry in ``workloads``, its name in the metrics its donor reports,
    and a limits file of its own; no file that was there is edited."""
    root = tmp_path_factory.mktemp("crossed")
    shutil.copytree(ROOT / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = Bench()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for config, donor in _crossed(bench):
        name = _name(config, donor)
        spec["workloads"].append(dict(donor, name=name, config=config))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if donor["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
        shutil.copy(root / "gpubench" / "cells" / f"{donor['name']}.json",
                    root / "gpubench" / "cells" / f"{name}.json")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny.TinyBench(root)


@pytest.mark.parametrize("cell", CROSSED)
def test_a_crossed_cell_is_correct(cell, crossed_bench):
    line = tiny.run(cell, bench=crossed_bench)
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    # the donor's end-to-end metrics, read for the new pair
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2


@pytest.mark.parametrize("cell,control", [
    (cell, control) for cell in CROSSED
    for control in CONTROLS.get(KIND[cell], ())])
def test_a_crossed_cells_controls_fail(cell, control, crossed_bench):
    # int8 serves two seconds: some hundreds of tokens, which it reorders
    line = tiny.run(cell, control=control, bench=crossed_bench,
                    seconds=2.0 if control == "int8" else 1.0)
    assert not line["correct"], line["compared"]
