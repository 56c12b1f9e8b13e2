"""The port's benchmark: one run of one cell.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Each run is its own process: it builds or loads the kernels, makes the
weights and inputs from ``--seed``, warms up the cell's shapes (set-up),
measures for ``--seconds``, checks what the timed path produced against
the plain reference, and prints one JSON object as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared beside its limit, also the last lines of standard
error).  With ``--trace 0`` the metrics are the cell's end-to-end metrics
of ``BENCHMARK.json``; with ``--trace 1`` its per-layer metrics, read from
a profiled window.  A run that finds no card, or fewer cards than the cell
asks for, exits with 2 and prints no result; so does one that finds JAX or
the JAX package loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vae_tagger_tpu")
ROOT = Path(__file__).resolve().parent.parent


def _env() -> None:
    """Caches inside the checkout, at fixed paths; no library loads JAX."""
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(ROOT / "build" / "bench_port" / "cuda_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "bench_port" / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "bench_port" / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Context:
    """What a traffic driver is handed, and what it hands back."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str):
        from .trace import Tracer

        self.cell, self.config, self.params = cell, cell.config, cell.params
        self.limits = cell.workload["limits"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = device
        self.tracer = Tracer(trace)
        self.setup_s = None
        self.memory_peak_bytes = 0
        self.log = log

    @property
    def window_seconds(self) -> float:
        """The measured window; a traced run profiles a window of the
        cell's ``trace_seconds`` at most."""
        if self.trace:
            return min(self.seconds, float(self.params["trace_seconds"]))
        return self.seconds

    def mark(self, phase: str) -> None:
        """Logs the seconds since the process started at the end of a
        set-up phase, so that a run's ``setup_s`` can be taken apart."""
        log(f"set-up: {phase} done at {time.perf_counter() - T0:.3f} s")

    def setup_done(self) -> None:
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - T0
        log(f"set-up {self.setup_s:.3f} s")

    def read_peak(self) -> None:
        """The device's peak allocation, read once the window has closed
        and before the reference runs."""
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())


def device_info(device: str, count: int) -> dict:
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=20)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        info["power_limit"] = f"not read ({e})"
    return info


def execute(cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda") -> dict:
    """One run of ``cell`` on ``device``; returns the result object."""
    ctx = Context(cell, seed, seconds, trace, device)
    readers = cell.readers if trace else {}
    for reader in readers.values():
        for w in getattr(reader, "wraps", lambda c: [])(ctx):
            ctx.tracer.wrap(*w)
    try:
        res = cell.traffic().run(ctx)
    finally:
        ctx.tracer.unwrap()
    metrics = {}
    if trace:
        data = ctx.tracer.data()
        for m in cell.per_layer:
            value = readers[m["name"]].read(data, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            name = m["name"]
            value = (ctx.setup_s if name == "setup_s"
                     else res["end_to_end"][cell.quantity(name)])
            metrics[name] = {"value": value, "unit": m["unit"]}
    dev = device_info(device, cell.chips)
    dev["memory_peak_bytes"] = ctx.memory_peak_bytes
    checks = res["checks"]
    correct = (res["attempted"] > 0 and res["failed"] == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    if trace:
        out["device"]["busy_s"] = data.busy_s
        out["device"]["window_s"] = data.window_s
        out["breakdown"] = data.breakdown()
    out["checks"] = checks
    return out


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _env()
    from . import spec

    cell = spec.load(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            ": no result")
        return 2
    log(f"cell {cell.name}, seed {args.seed}, {args.seconds} s, "
        f"trace {args.trace}; {torch.cuda.device_count()} CUDA device(s) "
        f"found, {cell.chips} used")
    out = execute(cell, args.seed, args.seconds, bool(args.trace))
    found = loaded_forbidden()
    if found:
        log(f"modules loaded that the port may not load: {found}: no result")
        return 2
    for name, c in out["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
