"""The Wan 2.1 VAE's family, added as files: its cell loads through
``spec.load``, its seeded weights draw ``gamma`` as scales and a causal
kernel by the fan-in of its one live tap, its operation count equals a
count taken from the frozen reference's modules on one frame, a tiny Wan
cell runs through the program on the CPU and reads ``correct`` against
the reference (its per-layer metrics read without error), and a program
without the Wan VAE is refused at load."""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys

import pytest
import torch

from bench_port import arith, run, spec, weights
from bench_port.reference import model as reference
from bench_port.reference.wan_vae import AttentionBlock, CausalConv3d

from .conftest import REPO, card  # noqa: F401  (a fixture)

CELL = "wan2.1-vae.bf16.infer-b8"
# the RMS branch's roofline, and the FLUX bf16 cell's metrics of the same
# engine, attention and device
METRICS = ("roofline_pct.rms_silu_conv3x3.infer.wan",
           "roofline_pct.flash_attn_fwd.infer.bf16", "mfu.infer.bf16",
           "device_idle_pct.infer.bf16", "engine.enqueue_ms.infer.bf16",
           "engine.place_ms.infer.bf16", "engine.place_idle_pct.infer.bf16",
           "ops.glue_pct.infer.bf16")


def _config(**vae):
    cfg = json.loads((REPO / "bench_port/configs/wan2.1-vae.bf16.json")
                     .read_text())
    cfg["vae"].update(vae)
    return cfg


def test_the_cell_loads_with_its_metrics():
    c = spec.load(CELL)
    assert c.family().__file__ == str(
        REPO / "bench_port/families/AutoencoderKLWan.py")
    assert c.family().TRAIN_REFERENCE is False
    assert {m["name"] for m in c.end_to_end} == {"infer_images_per_s.bf16",
                                                 "setup_s"}
    assert sorted(c.readers) == sorted(METRICS)
    assert c.config["reduced"] == [] and c.chips == 1
    assert c.config["precision"] == _config()["precision"]
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(e for e in bench["configs"] if e["name"] == c.config["name"])
    assert entry["reduced"] == [] and entry["file"].endswith(
        "wan2.1-vae.bf16.json")


def test_the_weights_of_the_family():
    cfg = _config(base_dim=8)
    fam = spec.family(cfg)
    w = weights.make(reference.shapes(cfg), 3, "cpu", family=fam)
    gammas = torch.cat([t.flatten() for k, t in w.items()
                        if k.endswith(".gamma")])
    assert abs(float(gammas.mean()) - 1.0) < 0.02
    conv = w["vae.encoder.down_blocks.0.conv1.weight"]   # (8, 8, 3, 3, 3)
    assert conv.shape == (8, 8, 3, 3, 3)
    assert abs(float(conv.std()) * math.sqrt(8 * 9) - 1.0) < 0.1
    assert any(".time_conv." in k for k in w)   # present, as published


def hook_count(cfg, height, width):
    """Operations of one frame's encoder and quant_conv, from the frozen
    reference's modules on the meta device: a causal conv counts its last
    tap alone, the one that meets data."""
    with torch.device("meta"):
        vae = reference.build_vae(cfg, False)
    total = [0]

    def count(m, args, out):
        if isinstance(m, CausalConv3d):
            kh, kw = m.kernel_size[1:]
            total[0] += 2 * out.numel() * m.in_channels * kh * kw
        elif isinstance(m, torch.nn.Conv2d):
            k = m.kernel_size[0] * m.kernel_size[1]
            total[0] += 2 * out.numel() * m.in_channels * k
        else:  # attention's two products over one frame's tokens
            b, c, t, h, w = args[0].shape
            total[0] += 4 * b * t * (h * w) ** 2 * c

    for m in vae.modules():
        if isinstance(m, (CausalConv3d, torch.nn.Conv2d, AttentionBlock)):
            m.register_forward_hook(count)
    vae.encode_moments(torch.empty(1, 3, height, width, device="meta"))
    return total[0]


@pytest.mark.parametrize("size,vae", [
    ((64, 96), {}), ((1024, 1024), {}),
    ((64, 64), {"base_dim": 8, "attn_scales": [0.5]})])
def test_encoder_layers_equal_the_modules_count(size, vae):
    cfg = _config(**vae)
    fam = spec.family(cfg)
    assert sum(op for op, _ in fam.encoder_layers(cfg, *size)) == \
        hook_count(cfg, *size)
    if not vae and size == (1024, 1024):  # about 2.85 TFLOP an image
        assert 2.7e12 < arith.encode_tag_flops(cfg, *size) < 3.0e12


@pytest.fixture(scope="module")
def wan_root(tmp_path_factory):
    """A checkout holding a tiny Wan cell (widths 8-32, 20 tags, 32px,
    fp32: the reference's precision on the CPU) beside the real one."""
    root = tmp_path_factory.mktemp("wan")
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = _config(base_dim=8)
    cfg.update(name="tiny.wan", num_tags=20)
    cfg["precision"]["compute"] = "float32"
    (root / "bench_port/configs/tiny.wan.json").write_text(json.dumps(cfg))
    w = json.loads((REPO / f"bench_port/workloads/{CELL}.json").read_text())
    w.update(name="tiny.wan.infer", config="tiny.wan",
             limits={"prob_max_abs": 1e-4})
    w["params"].update(resolution=32, batch=2, bank_images=4,
                       check_images=2, trace_seconds=1)
    (root / "bench_port/workloads/tiny.wan.infer.json").write_text(
        json.dumps(w))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(e for e in bench["workloads"] if e["name"] == CELL)
    bench["workloads"].append(dict(entry, name="tiny.wan.infer",
                                   config="tiny.wan"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny.wan.infer")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_wan_cell_is_correct_on_the_cpu(wan_root, two_threads, trace):
    out = run.execute(spec.load("tiny.wan.infer", wan_root), 2**31 + 11,
                      0.3, trace, "cpu")
    assert out["correct"], out["checks"]
    assert out["checks"]["prob_max_abs"]["value"] < 1e-5
    if trace:  # no device work on the CPU: what reads, reads in range
        for name, m in out["metrics"].items():
            assert name in METRICS and m["value"] >= 0.0
            assert m["unit"] != "%" or m["value"] <= 100.0
    else:
        assert out["metrics"]["infer_images_per_s.bf16"]["value"] > 0


def test_a_program_without_the_wan_vae_is_refused_at_load(tmp_path):
    root = tmp_path
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "vae_tagger_tpu_torch/models").mkdir(parents=True)
    (root / "vae_tagger_tpu_torch/__init__.py").write_text("")
    (root / "vae_tagger_tpu_torch/models/__init__.py").write_text("")
    code = ("from bench_port import spec\n"
            f"spec.load({CELL!r})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(root)})
    assert out.returncode != 0
    assert "has no vae_tagger_tpu_torch.models.autoencoder_kl_wan" \
        in out.stderr


@pytest.mark.cuda
def test_the_check_fails_in_float8_on_the_card(card):  # noqa: F811
    """The float8 control at a size a test run holds (256px, 16 images):
    the reference with its 2-D convs and linear layers in float8 e4m3, in
    the program's place, does not pass the cell's limit; the program does
    (the full-size readings are in PERF.md)."""
    c = spec.load(CELL, REPO)
    c.workload["params"].update(resolution=256, bank_images=16)
    limit = c.workload["limits"]["prob_max_abs"]
    traffic = c.traffic()
    for seed in (11, 2 ** 31 + 12, 13):
        sound = traffic.readings(run.Context(c, seed, 0, False, card))
        low = traffic.readings(run.Context(c, seed, 0, False, card),
                               "float8")
        assert sound["prob_max_abs"] <= limit < low["prob_max_abs"], (
            seed, sound, low)
