"""Run a cell with its control, or a fault, in the program's place, on
several seeds in one process, and print each run's compared numbers.

    python3 -m gpubench.control --workload <name> --control <kind> --seeds 1,2,3 [--seconds 15]

``int8``: a serving cell's program with its own int8 path (weights and
cache) switched on, served at the cell's load for ``--seconds``. ``fp8``:
a training cell's float32 reference computed in float8 e4m3 (every
product's operands, forward and backward) in the program's place.
``half_batch``: a training cell's reference with half of each batch left
out, a fault; ``unchanged``: a training step that returns its state
unchanged, a fault. The benchmark's own runs never run these; the limits of
``cells/<name>.json`` are set between the program's readings and these.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from gpubench.run import process_started, run_cell
from gpubench.spec import Bench


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control", required=True,
                   choices=("int8", "fp8", "half_batch", "unchanged"))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    args = p.parse_args(argv)
    started = process_started()
    if not torch.cuda.is_available():
        print("gpubench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = Bench()
    for seed in (int(s) for s in args.seeds.split(",")):
        line = run_cell(bench, args.workload, seed, args.seconds, False,
                        torch.device("cuda", 0), control=args.control,
                        started=started)
        print(json.dumps({"workload": args.workload, "control": args.control,
                          "seed": seed, "compared": line["compared"]}),
              flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
