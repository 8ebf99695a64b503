"""``BENCHMARK.json`` and the files its names lead to.

A :class:`Bench` reads the benchmark at a checkout's root and finds, by
name, each cell's configuration, traffic mix, limits, driver kind and
metric readers. Nothing here names a particular cell or metric: a new one
is new files and a new entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

#: the checkout's root: BENCHMARK.json beside this package
ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


class Bench:
    """The benchmark rooted at ``root`` (the checkout: ``BENCHMARK.json``
    and ``gpubench/``)."""

    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        self.dir = self.root / "gpubench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    # -- by name -----------------------------------------------------------
    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[c['name'] for c in self.spec['workloads']]}")

    def config_entry(self, cell: dict) -> dict:
        for conf in self.spec["configs"]:
            if conf["name"] == cell["config"]:
                return conf
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        """The configuration file's keys, as the cell runs them."""
        return _json(self.root / self.config_entry(cell)["file"])

    def traffic(self, cell: dict) -> dict:
        return _json(self.dir / "workloads" / f"{_name(cell['traffic'])}.json")

    def limits(self, cell: dict) -> dict:
        """``{number: {"limit": x, ...}}``: the numbers that decide
        ``correct`` and their limits."""
        return _json(self.dir / "cells" / f"{_name(cell['name'])}.json")["compare"]

    def driver(self, kind: str):
        return _module(self.dir / "drivers" / f"{_name(kind)}.py")

    def family(self, model_type: str):
        return _module(self.dir / "families" / f"{_name(model_type)}.py")

    def reader(self, metric: str):
        return _module(self.dir / "metrics" / f"{_name(metric)}.py")

    # -- which metrics a cell reports ---------------------------------------
    def end_to_end(self, cell_name: str) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell_name in m["workloads"]]

    def per_layer(self, cell_name: str) -> list[dict]:
        """A per-layer metric is reported where its ``workloads`` name the
        cell; without that key, in every cell that reports the end-to-end
        metric it moves."""
        moved = {m["name"] for m in self.end_to_end(cell_name)}
        return [m for m in self.spec["per_layer"]
                if (cell_name in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


def _name(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


_modules: dict[Path, object] = {}


def _module(path: Path):
    """The module in ``path``, loaded once: readers' names hold dots, so
    they are loaded from their files rather than imported by name."""
    if path not in _modules:
        if not path.exists():
            raise FileNotFoundError(f"{path} does not exist")
        spec = importlib.util.spec_from_file_location(
            f"gpubench_{path.parent.name}_{path.stem.replace('.', '_').replace('-', '_')}",
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _modules[path] = module
    return _modules[path]
