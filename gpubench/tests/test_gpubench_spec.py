"""BENCHMARK.json and every file its names lead to: they parse, keep to the
contract's names and shapes, and a new cell or metric is taken from new
files alone."""

from __future__ import annotations

import json
import shutil

import pytest

from gpubench.spec import NAME, ROOT, UNIT, Bench

BENCH = Bench()
SPEC = BENCH.spec
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
WIDTHS = ("hidden_size", "intermediate_size", "head_dim",
          "num_experts_per_tok")


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP_KEYS
    assert SPEC["command"] == ["python3", "-m", "gpubench.run"]
    assert SPEC["paths"] == ["gpubench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    # the driver's full check must fit its 43200 s at 24 cells
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n


def test_metric_fields():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in SPEC["end_to_end"])
    names = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in names
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_every_cell_resolves(cell):
    entry = BENCH.cell(cell)
    assert entry["chips"] in (1, 4)
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    conf = BENCH.config(entry)
    BENCH.family(conf["model_type"])
    traffic = BENCH.traffic(entry)
    BENCH.driver(traffic["driver"])
    limits = BENCH.limits(entry)
    assert limits and all(v["limit"] > 0 for v in limits.values())
    e2e = [m["name"] for m in BENCH.end_to_end(cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = BENCH.per_layer(cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e  # the cell reports what its metric moves
    for m in BENCH.end_to_end(cell) + layer:
        assert callable(BENCH.reader(m["name"]).read)


def test_configs_name_their_cuts_and_keep_widths():
    for conf in SPEC["configs"]:
        assert conf["file"].startswith("gpubench/configs/")
        data = json.loads((ROOT / conf["file"]).read_text())
        assert len(conf["reduced"]) <= 16
        for key in conf["reduced"]:
            assert key in data and NAME.fullmatch(key)
            assert key not in WIDTHS and not key.endswith(("_dim", "_rank"))
        assert conf["source"].startswith("https://")
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    assert {c["config"] for c in SPEC["workloads"]} == {
        c["name"] for c in SPEC["configs"]}


def test_four_chip_cells_within_a_quarter():
    four = sum(c["chips"] == 4 for c in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_a_new_cell_and_metric_come_from_new_files_alone(tmp_path):
    """Copy the benchmark, add a traffic mix, a limits file, a metric
    reader and their entries, and find all of them with no edit to any
    file that was there."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = spec["workloads"][0]
    new = dict(base, name=base["config"].split("-")[0] + ".extra",
               traffic="extra-mix")
    spec["workloads"].append(new)
    spec["per_layer"].append({
        "name": "extra_share.serve", "unit": "%", "better": "higher",
        "source": "host_clock", "layer": "engine", "moves": "setup_s",
        "workloads": [new["name"]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads(
        (ROOT / "gpubench" / "workloads" / f"{base['traffic']}.json").read_text())
    traffic["clients"] = 3
    (tmp_path / "gpubench" / "workloads" / "extra-mix.json").write_text(
        json.dumps(traffic))
    (tmp_path / "gpubench" / "cells" / f"{new['name']}.json").write_text(
        json.dumps({"compare": {"extra_gap": {"limit": 0.5}}}))
    (tmp_path / "gpubench" / "metrics" / "extra_share.serve.py").write_text(
        "def read(run, out):\n    return 42.0\n")
    bench = Bench(tmp_path)
    cell = bench.cell(new["name"])
    assert bench.traffic(cell)["clients"] == 3
    assert bench.limits(cell) == {"extra_gap": {"limit": 0.5}}
    assert [m["name"] for m in bench.per_layer(new["name"])] == ["extra_share.serve"]
    assert bench.reader("extra_share.serve").read(None, None) == 42.0
    assert "extra_share.serve" not in [
        m["name"] for m in bench.per_layer(base["name"])]


def test_a_name_cannot_leave_its_directory():
    with pytest.raises(ValueError):
        BENCH.reader("../run")
