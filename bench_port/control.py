"""Readings that set a cell's check limits, on the chip, in one process:

    python3 -m bench_port.control --workload <cell> --seeds 1,2,... \
        [--control float8|bfloat16|fault:half|fault:unchanged \
        --control-seeds 7,8,9]

For each seed of ``--seeds``, the numbers the cell's check compares, from
the program's timed path at the cell's own sizes (its lower readings); for
each of ``--control-seeds``, the same numbers with the plain reference
computed in ``--control``'s precision put in the program's place, or, in
a training cell, with ``fault:<name>`` planted in the program (its upper
readings).  Without a card it fails, as a run does.  One JSON line a
reading, on standard output; the runs of the benchmark itself never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import spec
from .run import ROOT, Context, _env, log


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default=None)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    _env()
    cell = spec.load(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s): no readings")
        return 2
    traffic = cell.traffic()
    plan = [(int(s), None) for s in args.seeds.split(",") if s]
    plan += [(int(s), args.control) for s in args.control_seeds.split(",")
             if s]
    for seed, control in plan:
        t = time.perf_counter()
        ctx = Context(cell, seed, 0.0, False, "cuda")
        numbers = traffic.readings(ctx, control)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "side": control or "program", **numbers,
                          "seconds": time.perf_counter() - t}), flush=True)
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
