"""The port stands alone: nanotpu_torch and chip_smoke.py import neither jax
nor nanotpu, its entry points refuse to run without a card unless told to
use the CPU, and its kernel module imports without nvcc."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import nanotpu_torch
from nanotpu_torch.models.llama import LlamaConfig, init_params
from nanotpu_torch.ops import _build
from nanotpu_torch.ops.attention import flash_attention
from nanotpu_torch.serving import engine as te
from nanotpu_torch.serving import server as ts

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "nanotpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "nanotpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_nanotpu_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_every_module_loads_no_jax_or_nanotpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nanotpu_torch\n"
        "for m in pkgutil.walk_packages(nanotpu_torch.__path__, 'nanotpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'nanotpu'))\n"
        "print('LOADED', len([k for k in sys.modules if k.startswith('nanotpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split("LOADED")[1]) >= 10


def test_entry_points_raise_without_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is real")
    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nanotpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.Engine(params, cfg, slots=1, max_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.build_engine("tiny", slots=1, max_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.main(["--preset", "tiny", "--port", "0", "--max-len", "32"])
    assert nanotpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_engine_refuses_params_on_another_device():
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        te.Engine(params, cfg, slots=1, max_len=32, device="meta")


def test_kernel_module_imports_and_runs_on_cpu_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()

    def no_build(name):
        raise AssertionError("a CPU tensor must not reach the kernel library")

    monkeypatch.setattr(_build, "library", no_build)
    q = torch.zeros((1, 4, 2, 16))
    assert flash_attention(q, q[:, :, :1], q[:, :, :1]).shape == q.shape


def test_library_names_carry_the_source_hash():
    a = _build._target("flash_fwd")
    assert a.parent == _build.BUILD_DIR and a.name.startswith("libflash_fwd-")
    assert all(src.exists() for src in _build.SOURCES.values())


def test_library_names_carry_the_included_headers(monkeypatch, tmp_path):
    """Editing a header that a source includes from csrc/ renames the
    library, so a stale build is never loaded."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "SOURCES", {
        name: tmp_path / path.name for name, path in _build.SOURCES.items()})
    assert {p.name for p in _build._inputs(_build.SOURCES["flash_bwd"])} == {
        "flash_bwd.cu", "flash_common.cuh", "hopper.cuh"}
    before = {name: _build._target(name) for name in _build.SOURCES}
    header = tmp_path / "flash_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: _build._target(name) for name in _build.SOURCES}
    assert all(before[n] != after[n] for n in ("flash_fwd", "flash_bwd"))
    # a header only flash_bwd.cu includes renames only its library
    header = tmp_path / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    again = {name: _build._target(name) for name in _build.SOURCES}
    assert again["flash_bwd"] != after["flash_bwd"]
    assert again["flash_fwd"] == after["flash_fwd"]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(
            (REPO / "chip_smoke.py").read_text()
        )
        cwd, script = tmp_path, tmp_path / "chip_smoke.py"
    else:
        cwd, script = REPO, REPO / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_reads_registers_and_spills_of_the_dkv_kernels():
    """chip_smoke fails a build whose bf16 dk/dv kernels spill: its parser
    reads ptxas's report per kernel, spill stores and loads summed."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    name = "_ZN45_GLOBAL__N__0_12_flash_bwd_cu_0a11bwd_kv_bf16ILi{}ELb{}EEEvNS_5KvTmaE"
    report = "\n".join(
        f"ptxas info    : Function properties for {name.format(d, q)}\n"
        f"    0 bytes stack frame, {sp} bytes spill stores, {sp} bytes spill "
        f"loads\nptxas info    : Used {regs} registers, used 3 barriers"
        for d, q, sp, regs in ((64, 1, 0, 128), (128, 0, 8, 168)))
    report += ("\nptxas info    : Function properties for _ZN_bwd_dq_bf16ILi64EE"
               "\n    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
               "loads\nptxas info    : Used 90 registers")
    assert smoke.kv_ptxas({"flash_bwd": {"ptxas": report}}) == {
        "bwd_kv_bf16<64, true>": (128, 0), "bwd_kv_bf16<128, false>": (168, 16)}
    assert smoke.kv_ptxas({}) == {}
