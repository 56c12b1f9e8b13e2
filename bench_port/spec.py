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
  found by the metric's whole name;
- ``bench_port/families/<_class_name>.py``: the VAE family of a
  configuration, found by its ``vae._class_name`` (as in a diffusers
  ``vae/config.json``).

A cell, a configuration, a metric or a VAE family is added by adding files
and entries; no file here names one.

A family module holds everything that depends on the VAE's architecture,
so that nothing else in the harness reads a key of ``config["vae"]``
other than ``_class_name``.  It provides:

1. ``reference_vae(config, with_decoder=True)``: the plain reference VAE
   (plain ``torch``, fp32, importing nothing of the program), an
   ``nn.Module`` whose ``encode_moments(x)`` maps NCHW pixels in [-1, 1]
   to the posterior's moments, (N, 2 x latent channels, h, w): the mean,
   then the log-variance.  Its ``state_dict`` names and shapes are the
   ones the seeded weights are drawn for and the program loads.
2. ``head_latents(config, mean)``: the tagger head's input from the
   posterior mean (the family's scale and shift of the latents).
3. ``latent_channels(config)`` and ``latent_side(config, n)``: the
   latents' channels, and the latent side of an image side ``n``.
4. ``encoder_layers(config, height, width)``: [(operations of one image's
   forward, whether the input needs a gradient)] of every conv, linear
   and attention product of the encoder, which ``arith`` sums.
5. Optional ``weight_kind(name, shape)`` and ``weight_fan_in(name,
   shape)``, given every leaf's whole name (``vae.`` or ``head.``), where
   the family's leaves differ from ``weights.leaf_kind`` and
   ``weights.fan_in`` (a norm scale not named ``weight``, a conv kernel
   with taps that touch no data); they return those defaults for the
   other leaves.
6. ``PROGRAM``: (the port's config-from-dict function, its VAE class) as
   dotted import paths.  ``program.py`` builds
   ``vae_class(make_config(config["vae"]), with_decoder=...)``.
7. ``TRAIN_REFERENCE``: whether ``reference/train.py`` can follow this
   family's training step; a cell whose traffic needs it
   (``NEEDS_TRAIN_REFERENCE`` in its traffic module) is refused at load
   where the family says no.
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

    def family(self):
        """The module of this cell's VAE family."""
        return family(self.config, self.root)

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


def family(config: dict, root: Path = ROOT):
    """The module of ``config``'s VAE family:
    ``bench_port/families/<config["vae"]["_class_name"]>.py`` under
    ``root`` (by default the checkout this harness runs from)."""
    name = config["vae"]["_class_name"]
    path = root / "bench_port" / "families" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"configuration {config.get('name')!r} names the VAE family "
            f"{name!r}, and there is no such file: {path}")
    return load_module(path)


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
    c = Cell(cell, root, workload, config, e2e, per_layer, readers)
    fam = c.family()
    if getattr(c.traffic(), "NEEDS_TRAIN_REFERENCE", False) \
            and not fam.TRAIN_REFERENCE:
        raise ValueError(
            f"{cell}: its traffic {workload['kind']!r} needs the training "
            f"reference, which cannot follow the VAE family "
            f"{config['vae']['_class_name']!r}")
    return c
