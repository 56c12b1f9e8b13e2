"""Whole runs on the CPU at a tiny size, the look for a chip skipped: each
traffic kind gives a result of the contract's shape with ``correct`` true,
and ``correct`` comes out false when the timed path is broken underneath
(an answer altered where it is produced; a step that leaves the state
unchanged; half of the batch left out, the mean taken over the rest).
Without a card the command itself fails and prints no result."""

from __future__ import annotations

import math
import shutil
import subprocess
import sys

import pytest

from bench_port import run, spec

from .conftest import REPO


def _run(root, cell, trace=False, seconds=1.5, seed=2 ** 33 + 5):
    return run.execute(spec.load(cell, root), seed, seconds, trace, "cpu")


def _shape(out):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", ["tiny.fp32.infer", "tiny.fp32.train"])
def test_a_sound_run_is_correct(tiny_root, two_threads, cell):
    out = _run(tiny_root, cell)
    _shape(out)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    e2e = {m["name"] for m in spec.load(cell, tiny_root).end_to_end}
    assert set(out["metrics"]) == e2e
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in out["metrics"].values())


def test_a_traced_run_reports_its_window(tiny_root, two_threads):
    out = _run(tiny_root, "tiny.fp32.infer", trace=True)
    _shape(out)
    assert out["correct"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    # on the CPU no device work is traced, so the readers of device work
    # report nothing; the host's own reading is there
    assert "engine.enqueue_ms.infer" in out["metrics"]


def test_an_altered_answer_is_not_correct(tiny_root, two_threads,
                                          monkeypatch):
    from vae_tagger_tpu_torch.infer.engine import TaggerEngine

    inner = TaggerEngine._encode_classify

    def altered(self, px):
        latents, probs = inner(self, px)
        probs = probs.clone()
        probs[0, 0] = 1.0 - probs[0, 0]
        return latents, probs

    monkeypatch.setattr(TaggerEngine, "_encode_classify", altered)
    out = _run(tiny_root, "tiny.fp32.infer")
    assert not out["correct"]


def test_an_unchanged_state_is_not_correct(tiny_root, two_threads,
                                           monkeypatch):
    from vae_tagger_tpu_torch.train import state

    def no_update(self):
        self.adamw.zero_grad(set_to_none=True)
        return False

    monkeypatch.setattr(state.Optimizer, "step", no_update)
    out = _run(tiny_root, "tiny.fp32.train")
    assert not out["correct"]
    assert out["checks"]["change_leaf_gap"]["value"] >= 0.99


def test_half_the_batch_is_not_correct(tiny_root, two_threads, monkeypatch):
    from vae_tagger_tpu_torch.train import steps

    inner = steps.batch_to_device

    def half(batch, device, keys=steps._BATCH_KEYS):
        out = inner(batch, device, keys)
        return {k: v[: len(v) // 2] for k, v in out.items()}

    monkeypatch.setattr(steps, "batch_to_device", half)
    out = _run(tiny_root, "tiny.fp32.train")
    assert not out["correct"]


def test_half_the_batch_in_the_window_alone_is_not_correct(
        tiny_root, two_threads, monkeypatch):
    """A fault that starts after set-up shows in the window's first step,
    which the reference follows too."""
    from vae_tagger_tpu_torch.train import steps

    inner = steps.batch_to_device
    setup_steps = spec.load("tiny.fp32.train", tiny_root).params[
        "setup_steps"]
    calls = []

    def half_later(batch, device, keys=steps._BATCH_KEYS):
        out = inner(batch, device, keys)
        calls.append(1)
        if len(calls) <= setup_steps:
            return out
        return {k: v[: len(v) // 2] for k, v in out.items()}

    monkeypatch.setattr(steps, "batch_to_device", half_later)
    out = _run(tiny_root, "tiny.fp32.train")
    assert len(calls) > setup_steps + 1
    assert not out["correct"]
    assert out["checks"]["loss_rel_gap"]["value"] > 1e-4


def _command(cwd, *extra_env):
    return subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload",
         "flux1-dev.fp32.infer-b8", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(cwd),
                          "CUDA_VISIBLE_DEVICES": "", **dict(extra_env)})


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = _command(REPO)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA device" in out.stderr


def test_with_only_the_benchmark_the_command_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control,size", [
    ("flux1-dev.fp32.infer-b8", "bfloat16", dict(resolution=256,
                                                 bank_images=16)),
    ("flux1-dev.bf16.infer-b8", "float8", dict(resolution=256,
                                               bank_images=16)),
])
def test_the_check_fails_in_a_lower_precision_on_the_card(card, cell,
                                                           control, size):
    """The control at a size a test run holds: the reference one precision
    below the configuration's, put in the program's place, does not pass
    the cell's limit; the program does (the cells' full-size readings are
    in PERF.md)."""
    c = spec.load(cell, REPO)
    c.workload["params"].update(size)
    limit = c.workload["limits"]["prob_max_abs"]
    traffic = c.traffic()
    for seed in (11, 2 ** 31 + 12, 13):
        sound = traffic.readings(run.Context(c, seed, 0, False, card))
        low = traffic.readings(run.Context(c, seed, 0, False, card), control)
        assert sound["prob_max_abs"] <= limit < low["prob_max_abs"], (
            seed, sound, low)
