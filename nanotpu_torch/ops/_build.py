"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` into a shared library
with a plain C interface, which :func:`library` loads with ``ctypes``. The
build runs at first use, into ``nanotpu_torch/_build/``; a library's file
name carries a hash of its source, of every header the source includes
from ``csrc/``, and of the flags, so an edited source or header builds anew
and an unchanged one is reused. Nothing here runs at import time: a
machine without ``nvcc`` imports the package and uses the kernels' plain
versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
#: one library per source; the key is the library's name
SOURCES = {
    "flash_fwd": CSRC / "flash_fwd.cu",
    "flash_bwd": CSRC / "flash_bwd.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _inputs(src: Path) -> list[Path]:
    """``src`` and every file it includes from ``csrc/`` with ``#include
    "..."``, transitively, each once."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / name.decode()).resolve()
            if dep.is_relative_to(CSRC) and dep.exists():
                todo.append(dep)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _inputs(SOURCES[name]):
        h.update(path.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> dict[str, dict]:
    """Compile every source whose library is missing: one ``nvcc`` per
    source, all started together. Returns, per source built, its wall
    seconds and the assembler's register/shared-memory report."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        started = {}
        for name, src in SOURCES.items():
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )
            started[name] = (proc, tmp, out, time.perf_counter())
        report = {}
        for name, (proc, tmp, out, t0) in started.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                for other, *_ in started.values():
                    if other.poll() is None:
                        other.kill()
                        other.wait()
                raise RuntimeError(
                    f"nvcc failed for {SOURCES[name].name} "
                    f"(exit {proc.returncode}):\n{stdout}{stderr}"
                )
            os.replace(tmp, out)
            report[name] = {
                "seconds": time.perf_counter() - t0,
                "ptxas": stderr.strip(),
            }
        return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if need be."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
