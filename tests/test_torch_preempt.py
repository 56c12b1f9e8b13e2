"""Preemption, background checkpoints and the profiler capture of the
port's epoch loop (``vae_tagger_tpu_torch/train/loop.py``), on the CPU;
the counterpart of tests/test_preempt.py.

- the drill hook (``VAE_TAGGER_PREEMPT_AFTER_STEPS``) writes
  ``interrupt_checkpoint`` after N steps, skips the final phase, and
  ``--resume_from`` continues it, mid-epoch, skipping the trained batches;
  in all three trainers;
- a real SIGTERM mid-training, during validation and during the
  checkpoint callbacks saves at once; the previous SIGTERM disposition is
  restored, after an interrupted and after a normal run;
- an fp32 run interrupted and resumed ends with the same head, bit for
  bit, as the same run uninterrupted (a constant learning rate: a resumed
  run extends the schedule's horizon);
- the background writer's checkpoint is the state at submission while
  training went on, and a whole run's checkpoints equal those of
  ``--sync_checkpoints``;
- ``--profile_steps`` writes a chrome trace, also when the run is shorter;
  ``utils.profiling.trace`` writes one.
"""

import json
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from vae_tagger_tpu_torch.core.config import (
    AttentionDecoderConfig,
    default_flux_vae_config,
)
from vae_tagger_tpu_torch.io.checkpoints import (
    save_decoder_bin,
    save_train_state,
    save_vae_pretrained,
)
from vae_tagger_tpu_torch.models.autoencoder_kl import AutoencoderKL
from vae_tagger_tpu_torch.models.taggers import AttentionClassificationDecoder
from vae_tagger_tpu_torch.nn.blocks import seeded_init_
from vae_tagger_tpu_torch.train import train_decoder, train_full, train_vae
from vae_tagger_tpu_torch.train.loop import EpochLoop, HostSnapshot
from vae_tagger_tpu_torch.train.schedule import build_lr_schedule
from vae_tagger_tpu_torch.train.state import TrainState, build_optimizer
from vae_tagger_tpu_torch.train.steps import DecoderSteps
from vae_tagger_tpu_torch.utils.profiling import trace

RES = 32


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tiny whole VAE, a head, 12 images (11 train: 3 batches of 4, and
    1 validation image)."""
    root = tmp_path_factory.mktemp("torch_preempt")
    cfg = default_flux_vae_config(block_out_channels=(8, 16, 16, 16),
                                  norm_num_groups=4, latent_channels=4)
    vae = seeded_init_(AutoencoderKL(cfg, with_decoder=True), 0)
    save_vae_pretrained(vae, cfg, str(root / "vae"))
    head = seeded_init_(AttentionClassificationDecoder(
        4, 6, AttentionDecoderConfig(attention_heads=1)), 1)
    save_decoder_bin(head, str(root / "head.bin"))
    rng = np.random.default_rng(8)
    tags = [f"t{i}" for i in range(6)]
    (root / "tags.csv").write_text(
        "name,count\n" + "".join(f"{t},1\n" for t in tags))
    (root / "images").mkdir()
    data = {}
    for i in range(12):
        p = root / "images" / f"{i}.png"
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
                        ).save(p)
        data[str(p)] = ", ".join(f"{t}:0.9" for t in
                                 rng.choice(tags, 2, replace=False))
    (root / "data.json").write_text(json.dumps(data))
    base = ["--device", "cpu", "--json_path", str(root / "data.json"),
            "--tags_csv_path", str(root / "tags.csv"),
            "--vae_checkpoint",
            str(root / "vae" / "diffusion_pytorch_model.safetensors"),
            "--vae_config_path", str(root / "vae" / "config.json"),
            "--resolution", str(RES), "--train_batch_size", "4",
            "--save_steps", "1", "--logging_steps", "1",
            "--lr_scheduler_type", "constant", "--lr_warmup_steps", "0",
            "--mixed_precision", "no", "--num_workers", "2",
            "--attention_heads", "1", "--seed", "0"]
    return dict(root=root, base=base)


def _decoder(run_dir, out, *flags, epochs=1):
    return train_decoder.main([*run_dir["base"], "--output_dir", str(out),
                               "--num_epochs", str(epochs), *flags])


def _head_state(state):
    return {k: v.clone() for k, v in state.decoder.state_dict().items()}


def test_drill_saves_and_a_mid_epoch_resume_ends_as_the_full_run(
        run_dir, tmp_path, monkeypatch, capsys):
    """After 2 of epoch 0's 3 steps the drill saves and skips the final
    phase; the resume trains the 1 remaining batch, and its head equals an
    uninterrupted epoch's, bit for bit."""
    out = tmp_path / "cut"
    monkeypatch.setenv("VAE_TAGGER_PREEMPT_AFTER_STEPS", "2")
    state = _decoder(run_dir, out, epochs=5)
    monkeypatch.delenv("VAE_TAGGER_PREEMPT_AFTER_STEPS")
    text = capsys.readouterr().out
    assert state.step == 2
    assert (out / "interrupt_checkpoint" / "train_state.pt").exists()
    assert not (out / "optimal_thresholds.json").exists()
    assert "interrupt checkpoint saved at step 2" in text
    assert f"resume with --resume_from {out / 'interrupt_checkpoint'}" \
        in text
    assert "skipping final evaluation" in text
    assert (out / "training_history.json").exists()

    resumed = _decoder(run_dir, tmp_path / "resumed", "--resume_from",
                       str(out / "interrupt_checkpoint"))
    text = capsys.readouterr().out
    assert "mid-epoch resume: skipping 2 already-trained batches" in text
    assert resumed.step == 3
    assert (tmp_path / "resumed" / "best_pytorch_model.bin").exists()

    whole = _decoder(run_dir, tmp_path / "whole")
    assert whole.step == 3
    got, want = _head_state(resumed), _head_state(whole)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_real_sigterm_mid_training_restores_the_handler(run_dir, tmp_path,
                                                        monkeypatch):
    fired = []
    orig = DecoderSteps.train_step_from_latents

    def step_then_sigterm(self, *a, **k):
        out = orig(self, *a, **k)
        if not fired:
            fired.append(1)
            signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(DecoderSteps, "train_step_from_latents",
                        step_then_sigterm)
    before = signal.getsignal(signal.SIGTERM)
    state = _decoder(run_dir, tmp_path / "out", epochs=5)
    assert fired and state.step == 1
    assert (tmp_path / "out" / "interrupt_checkpoint").exists()
    assert signal.getsignal(signal.SIGTERM) == before


def test_no_handler_leak_after_a_normal_run(run_dir, tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    _decoder(run_dir, tmp_path / "out")
    assert signal.getsignal(signal.SIGTERM) == before
    assert not (tmp_path / "out" / "interrupt_checkpoint").exists()


@pytest.mark.parametrize("where", ["validation", "callbacks"])
def test_sigterm_during_validation_or_callbacks_saves_at_once(
        run_dir, tmp_path, monkeypatch, capsys, where):
    """A signal during epoch 0's validation or its checkpoint callbacks
    saves right after them: epoch 0's 3 steps, not a second epoch's."""
    fired = []
    if where == "validation":
        cls, name = DecoderSteps, "eval_step_from_latents"
    else:
        cls, name = EpochLoop, "_checkpoint"
    orig = getattr(cls, name)

    def then_sigterm(*a, **k):
        out = orig(*a, **k)
        if not fired:
            fired.append(1)
            signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(cls, name, then_sigterm)
    out = tmp_path / "out"
    state = _decoder(run_dir, out, epochs=5)
    assert fired and state.step == 3
    assert (out / "interrupt_checkpoint").exists()
    assert "skipping final evaluation" in capsys.readouterr().out
    hist = json.loads((out / "training_history.json").read_text())
    assert len(hist["train_loss"]) == (0 if where == "validation" else 1)


@pytest.mark.parametrize("trainer", ["train_full", "train_vae"])
def test_the_other_trainers_exit_on_the_drill(run_dir, tmp_path,
                                              monkeypatch, capsys, trainer):
    monkeypatch.setenv("VAE_TAGGER_PREEMPT_AFTER_STEPS", "1")
    argv = [a for a in run_dir["base"]]
    if trainer == "train_full":
        argv += ["--decoder_checkpoint", str(run_dir["root"] / "head.bin")]
        state = train_full.main([*argv, "--output_dir",
                                 str(tmp_path / "out"), "--num_epochs",
                                 "3"])
        message = "training interrupted; skipping final evaluation"
    else:
        argv = [a for i, a in enumerate(argv) if a != "--attention_heads"
                and argv[i - 1] != "--attention_heads"]
        state = train_vae.main([*argv, "--output_dir",
                                str(tmp_path / "out"), "--num_epochs", "3"])
        message = "training interrupted; history saved"
    text = capsys.readouterr().out
    assert state.step == 1
    assert message in text and "training complete" not in text
    assert (tmp_path / "out" / "interrupt_checkpoint").exists()
    assert (tmp_path / "out" / "training_history.json").exists()
    assert not (tmp_path / "out" / "optimal_thresholds.json").exists()


def _tiny_state():
    head = seeded_init_(AttentionClassificationDecoder(
        4, 6, AttentionDecoderConfig(attention_heads=1)), 2)
    opt = build_optimizer(head.parameters(),
                          build_lr_schedule("constant", 1e-2, 0, 10))
    return TrainState(vae=None, decoder=head, optimizer=opt)


def _step(state, seed):
    g = torch.Generator().manual_seed(seed)
    state.decoder.train()
    loss = state.decoder(torch.randn(2, 8, 8, 4, generator=g)).square(
        ).mean()
    loss.backward()
    state.optimizer.step()
    state.step += 1


def _flat(tree, prefix=""):
    """Every tensor of a nested state dict, by path."""
    out = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
    return out


def test_background_checkpoint_is_the_state_at_submission(tmp_path):
    """The writer writes the state as it was when the epoch's checkpoint
    was taken, although AdamW changed the live tensors in place before
    the write ran."""
    import threading
    from types import SimpleNamespace

    state = _tiny_state()
    for i in range(2):
        _step(state, i)
    expected = _flat(HostSnapshot(state).state_dict())
    release = threading.Event()

    def on_best(snapshot, epoch):
        release.wait(timeout=60)
        save_train_state(snapshot, str(tmp_path / "ckpt"))

    loop = EpochLoop(SimpleNamespace(output_dir=str(tmp_path)), None, None,
                     None, None, on_best)
    loop._checkpoint([on_best], state, 0)
    for i in range(2, 5):  # training goes on while the write waits
        _step(state, i)
    release.set()
    loop._ckpt_writer.wait()
    saved = _flat(torch.load(tmp_path / "ckpt" / "train_state.pt",
                             weights_only=True))
    live = _flat(state.state_dict())
    assert saved.keys() == expected.keys()
    for k, v in expected.items():
        assert torch.equal(saved[k], v), k
    moved = [k for k, v in expected.items() if not torch.equal(live[k], v)]
    assert any("exp_avg" in k for k in moved), moved


def test_background_checkpoints_equal_sync_checkpoints(run_dir, tmp_path):
    """Two epochs with the background writer and with --sync_checkpoints
    write the same train states and head exports."""
    _decoder(run_dir, tmp_path / "bg", epochs=2)
    _decoder(run_dir, tmp_path / "sync", "--sync_checkpoints", epochs=2)
    for rel in ["best_checkpoint/train_state.pt",
                "checkpoint-0/train_state.pt", "checkpoint-1/train_state.pt",
                "pytorch_model.bin", "best_pytorch_model.bin"]:
        a = _flat(torch.load(tmp_path / "bg" / rel, weights_only=True))
        b = _flat(torch.load(tmp_path / "sync" / rel, weights_only=True))
        assert a.keys() == b.keys() and a, rel
        for k in a:
            assert torch.equal(a[k], b[k]), (rel, k)


@pytest.mark.parametrize("steps", [1, 50])
def test_profile_steps_writes_a_chrome_trace(run_dir, tmp_path, capsys,
                                             steps):
    """Steps 3 and 4 of a 6-step run are captured; a capture longer than
    the run is written when it ends."""
    out = tmp_path / "out"
    _decoder(run_dir, out, "--profile_steps", str(steps), epochs=2)
    text = capsys.readouterr().out
    trace_file = out / "profile" / "trace.json"
    events = json.loads(trace_file.read_text())["traceEvents"]
    assert any("addmm" in e.get("name", "") or "conv" in e.get("name", "")
               for e in events)
    assert ("run shorter than --profile_steps" in text) == (steps == 50)


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "p")):
        torch.ones(4, 4) @ torch.ones(4, 4)
    events = json.loads((tmp_path / "p" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
