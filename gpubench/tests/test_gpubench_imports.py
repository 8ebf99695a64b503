"""What the benchmark's processes import, and how its command fails.

A run of every cell (at a tiny size on the CPU, in a fresh interpreter)
loads no module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``nanotpu``, compared whole (``nanotpu_torch`` begins with ``nanotpu``).
The reference alone loads nothing of the port either. The command exits
non-zero, printing no result, without a card, and in a checkout that
holds only the benchmark."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from gpubench.run import FORBIDDEN
from gpubench.spec import ROOT

ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def _python(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV,
                          capture_output=True, text=True, timeout=600)


def test_a_run_of_every_cell_loads_no_jax_and_no_nanotpu():
    code = (
        "import json, sys\n"
        "from gpubench.spec import Bench\n"
        "from gpubench.tests import tiny\n"
        "for cell in Bench().spec['workloads']:\n"
        "    tiny.run(cell['name'], seconds=0.5)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "nanotpu_torch" in tops and "torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    code = (
        "import json, sys\n"
        "import gpubench.reference.dense, gpubench.reference.moe\n"
        "import gpubench.reference.adamw, gpubench.reference.common\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not tops & (FORBIDDEN | {"nanotpu_torch"})


def test_no_source_of_the_reference_names_the_port():
    for path in (ROOT / "gpubench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in FORBIDDEN | {"nanotpu_torch"}, (path, name)


def _command(cwd, *extra) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         "mistral7b.chat-c40", "--seed", str(2**31 + 7), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, env=ENV, capture_output=True,
        text=True, timeout=300)


def test_the_command_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _command(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_the_command_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
