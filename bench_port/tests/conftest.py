"""Shared fixtures of the benchmark's CPU tests: a temporary checkout
holding ``BENCHMARK.json``, a copy of ``bench_port/`` and tiny cells (a
FLUX-shaped VAE at widths 8-16, 20 tags, 64px) for each traffic kind."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "tiny.fp32.infer": ("flux1-dev.fp32.infer-b8", dict(
        resolution=64, batch=4, bank_images=8, check_images=4,
        trace_seconds=1)),
    "tiny.fp32.train": ("flux1-dev.bf16.train_full-1024", dict(
        resolution=64, triplets=4, host_batches=4, setup_steps=2,
        trace_seconds=1)),
}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A checkout with the tiny cells added as files and entries."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((REPO / "bench_port/configs/flux1-dev.fp32.json")
                     .read_text())
    cfg["name"] = "tiny.fp32"
    cfg["vae"].update(block_out_channels=[8, 16, 16, 16], norm_num_groups=4)
    cfg["num_tags"] = 20
    (root / "bench_port/configs/tiny.fp32.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, (model, params) in TINY.items():
        w = json.loads((REPO / f"bench_port/workloads/{model}.json")
                       .read_text())
        w.update(name=name, config="tiny.fp32")
        w["params"].update(params)
        if w["kind"] == "train":  # fp32 on the CPU: the reference's precision
            w["limits"] = {"loss_rel_gap": 1e-4, "grad1_leaf_gap": 1e-3,
                           "change_leaf_gap": 1e-3}
        else:
            w["limits"] = {"prob_max_abs": 5e-3}
        (root / f"bench_port/workloads/{name}.json").write_text(json.dumps(w))
        entry = next(e for e in bench["workloads"] if e["name"] == model)
        bench["workloads"].append(dict(entry, name=name, config="tiny.fp32"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if model in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided here, never
    at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the chip)")
    return "cuda"
