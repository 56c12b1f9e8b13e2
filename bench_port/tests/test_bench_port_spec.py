"""BENCHMARK.json against the benchmark's contract, and every cell found by
name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from bench_port import spec

from .conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"][:3] == ["python3", "-m", "bench_port.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_port/") and not c["reduced"]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files(cell):
    c = spec.load(cell, REPO)
    assert c.config["name"] == c.workload["config"]
    assert c.traffic().run and c.traffic().readings
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(c.readers[m["name"]].read)
    for name in e2e - {"setup_s"}:
        assert c.quantity(name)
    assert set(c.workload["limits"])


def test_a_workload_dropped_into_a_copy_is_found(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = "flux1-dev.bf16.infer-b8"
    w = json.loads((tmp_path / f"bench_port/workloads/{base}.json")
                   .read_text())
    w.update(name="flux1-dev.bf16.infer-b4", params=dict(w["params"],
                                                         batch=4))
    (tmp_path / "bench_port/workloads/flux1-dev.bf16.infer-b4.json") \
        .write_text(json.dumps(w))
    (tmp_path / "bench_port/metrics/extra.infer.py").write_text(
        "def read(data, ctx):\n    return 1.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "flux1-dev.bf16.infer-b4",
                               "config": "flux1-dev.bf16",
                               "traffic": "infer-b4", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "extra.infer", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device",
                               "moves": "infer_images_per_s",
                               "workloads": ["flux1-dev.bf16.infer-b4"]})
    for m in bench["end_to_end"]:
        if base in m.get("workloads", ()):
            m["workloads"].append("flux1-dev.bf16.infer-b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load("flux1-dev.bf16.infer-b4", tmp_path)
    assert c.params["batch"] == 4
    assert "extra.infer" in [m["name"] for m in c.per_layer]
    assert {m["name"] for m in c.end_to_end} == {"infer_images_per_s.bf16",
                                                 "setup_s"}
    assert c.quantity("infer_images_per_s.bf16") == "infer_images_per_s"
    assert c.readers["extra.infer"].read(None, None) == 1.0


def _copy(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_a_metric_without_its_own_reader_is_refused_at_load(tmp_path):
    """A reader is found by the metric's whole name, never by a prefix."""
    bench = _copy(tmp_path)
    bench["per_layer"].append({"name": "mfu.infer.extra", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device",
                               "moves": "infer_images_per_s",
                               "workloads": ["flux1-dev.fp32.infer-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(FileNotFoundError, match="mfu.infer.extra.py"):
        spec.load("flux1-dev.fp32.infer-b8", tmp_path)


def test_an_end_to_end_metric_its_cell_does_not_map_is_refused(tmp_path):
    bench = _copy(tmp_path)
    bench["end_to_end"].append({"name": "infer_images_per_s.extra",
                                "unit": "images/s", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["flux1-dev.fp32.infer-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="infer_images_per_s.extra"):
        spec.load("flux1-dev.fp32.infer-b8", tmp_path)
