"""Finding a cell's files by name.

- ``BENCHMARK.json`` at the checkout's root: the cells, their end-to-end
  and per-layer metrics;
- ``bench_port/workloads/<cell>.json``: the cell's configuration, traffic
  kind, parameters, the limits of its output check, and under
  ``end_to_end`` the quantity of its traffic that each of its end-to-end
  metrics reports (``setup_s`` is the harness's own);
- ``bench_port/configs/<config>.json``: the configuration as it is run;
- ``bench_port/traffic/<kind>.py``: the driver of a traffic kind;
- ``bench_port/metrics/<metric>.py``: the reader of a per-layer metric,
  found by the metric's whole name.

A cell, a configuration or a metric is added by adding files and entries;
no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    workload: dict          # bench_port/workloads/<name>.json
    config: dict            # bench_port/configs/<config>.json
    end_to_end: list        # BENCHMARK.json's entries this cell reports
    per_layer: list
    readers: dict           # per-layer metric name -> its reader module

    @property
    def params(self) -> dict:
        return self.workload["params"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def traffic(self):
        """The module of this cell's traffic kind."""
        return load_module(self.root / "bench_port" / "traffic"
                           / f"{self.workload['kind']}.py")

    def quantity(self, metric: str) -> str:
        """The traffic's quantity that the end-to-end ``metric`` reports."""
        return self.workload["end_to_end"][metric]


def load_module(path: Path):
    """A module of the harness loaded from its file (metric names hold dots,
    so they are not import paths)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(
        "bench_port_file_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reports(entry: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return e2e_names is None or entry.get("moves") in e2e_names


def load(cell: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {cell!r}")
    workload = json.loads(
        (root / "bench_port" / "workloads" / f"{cell}.json").read_text())
    config = json.loads(
        (root / "bench_port" / "configs" / f"{entry['config']}.json")
        .read_text())
    for key in ("config", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{cell}: {key} {workload[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell)]
    names = {m["name"] for m in e2e}
    unmapped = names - {"setup_s"} - set(workload["end_to_end"])
    if unmapped:
        raise ValueError(f"{cell}: its file maps no traffic quantity to "
                         f"{sorted(unmapped)}")
    per_layer = [m for m in bench["per_layer"] if _reports(m, cell, names)]
    readers = {m["name"]: load_module(root / "bench_port" / "metrics"
                                      / f"{m['name']}.py")
               for m in per_layer}
    return Cell(cell, root, workload, config, e2e, per_layer, readers)
