"""Run one cell of the benchmark once and print its result line.

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from a profiled slice, with
the device's busy and window seconds and a breakdown of the slice. Each
number that decides ``correct`` is printed beside its limit as the last
lines on standard error and under ``compared``, the line's last key. The
run fails, printing no result, without a CUDA card (or with fewer than the
cell asks for), without the port, or if ``jax``, ``jaxlib``, ``flax`` or
``nanotpu`` was imported by the time the window closed.
"""

from __future__ import annotations

import time

#: the harness's clock when this module was imported, for set-up time
_IMPORTED = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

#: top-level module names that no process of the benchmark may hold
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "nanotpu"})


def process_started() -> float:
    """The ``time.perf_counter()`` reading at which this process started,
    from its start time in ``/proc`` (``_IMPORTED`` where there is none)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return _IMPORTED
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - max(age, 0.0)


@dataclasses.dataclass
class Run:
    """What a driver and a metric reader know of the run."""

    config: dict
    traffic: dict
    family: object
    shape: object
    seed: int
    seconds: float
    device: object
    started: float
    control: str | None = None


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def run_cell(bench, name: str, seed: int, seconds: float, trace: bool,
             device, control: str | None = None,
             started: float | None = None) -> dict:
    """One run of cell ``name``: the result line's dict."""
    from gpubench.yardstick.flops import Shape

    cell = bench.cell(name)
    config = bench.config(cell)
    traffic = bench.traffic(cell)
    limits = bench.limits(cell)
    run = Run(config, traffic, bench.family(config["model_type"]),
              Shape.of(config), seed, seconds, device,
              _IMPORTED if started is None else started, control)
    tracer = None
    if trace:
        from gpubench.yardstick.trace import Tracer

        tracer = Tracer(device)
    out = bench.driver(traffic["driver"]).run(run, tracer)

    metrics = {}
    for m in (bench.per_layer(name) if trace else bench.end_to_end(name)):
        value = bench.reader(m["name"]).read(run, out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared, correct = {}, True
    for number, value in out["compared"].items():
        limit = limits[number]["limit"]
        compared[number] = {"value": value, "limit": limit}
        correct = correct and math.isfinite(value) and value <= limit
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_kind(device), "count": 1,
           "memory_peak_bytes": out.get("memory_peak_bytes", 0)}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    timeline = out.get("timeline")
    if timeline is not None:
        dev["busy_s"] = timeline.busy_s()
        dev["window_s"] = timeline.window_s
        line["breakdown"] = {"device_ops": timeline.top_ops(),
                             "idle_gaps": timeline.idle_gaps()}
    line["compared"] = compared
    return line


def _device_kind(device) -> str:
    import torch

    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = process_started()

    from gpubench.spec import Bench

    bench = Bench()
    chips = bench.cell(args.workload)["chips"]
    try:
        import nanotpu_torch  # noqa: F401
    except ImportError as e:
        print(f"gpubench: the program under test is missing: {e}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: {args.workload} needs {chips} CUDA card(s); this "
              f"process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"gpubench: {args.workload} seed {args.seed} on {card_line()}",
          file=sys.stderr)
    line = run_cell(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda", 0),
                    started=started)
    found = forbidden_modules()
    if found:
        print(f"gpubench: the process imported {found}: the benchmark runs "
              "the port alone", file=sys.stderr)
        return 3
    for number, c in line["compared"].items():
        print(f"compared {number} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
