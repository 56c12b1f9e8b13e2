"""The port's train_full path as a whole, on the CPU: one step's loss and
gradients against ``jax.value_and_grad`` of the JAX package's modules on a
small VAE, ``--remat`` against no remat, the posterior's draw and KL, and
``python -m vae_tagger_tpu_torch.train.train_full --device cpu`` end to end
with exports, checkpoints and ``--resume_from``.

Randomness cannot match across frameworks, so the posterior noise comes
from numpy on both sides and the head runs deterministic (flax
``deterministic=True``, torch ``eval()``); train-mode BatchNorm is covered
in test_torch_train_ops.py.  Tolerances: fp32, atol 1e-5 unless stated.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_tagger_tpu.core.config import AttentionDecoderConfig as JaxAttnCfg
from vae_tagger_tpu.core.config import default_flux_vae_config as jax_vae_cfg
from vae_tagger_tpu.losses.combined import LossConfig as JaxLossConfig
from vae_tagger_tpu.losses.combined import (
    simplified_combined_loss as jax_simplified_loss,
)
from vae_tagger_tpu.models.autoencoder_kl import AutoencoderKL as JaxVAE
from vae_tagger_tpu.models.autoencoder_kl import (
    DiagonalGaussian as JaxPosterior,
)
from vae_tagger_tpu.models.autoencoder_kl import encode_scaled as jax_scaled
from vae_tagger_tpu.models.taggers import (
    AttentionClassificationDecoder as JaxAttnHead,
)
from vae_tagger_tpu.ops.image import normalize_uint8 as jax_normalize
from vae_tagger_tpu_torch.core.config import (
    AttentionDecoderConfig,
    default_flux_vae_config,
)
from vae_tagger_tpu_torch.io.checkpoints import (
    load_state_file,
    save_decoder_bin,
    save_vae_pretrained,
    torch_state_from_jax_params,
)
from vae_tagger_tpu_torch.losses.combined import LossConfig
from vae_tagger_tpu_torch.models.autoencoder_kl import (
    AutoencoderKL,
    DiagonalGaussian,
)
from vae_tagger_tpu_torch.models.taggers import AttentionClassificationDecoder
from vae_tagger_tpu_torch.nn.blocks import seeded_init_
from vae_tagger_tpu_torch.ops import backend
from vae_tagger_tpu_torch.train import train_full
from vae_tagger_tpu_torch.train.state import TrainState
from vae_tagger_tpu_torch.train.steps import FullSteps, batch_to_device

SMALL = dict(block_out_channels=(32, 32, 32, 32), norm_num_groups=4,
             latent_channels=4)
RES, B, TAGS = 32, 2, 10
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu_only():
    backend.reset_launch_counts()
    yield
    assert sum(backend.launch_counts().values()) == 0


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(a, np.float32)
        + (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32)
        for a in leaves])


@functools.lru_cache(maxsize=None)
def _jax_models():
    """The JAX VAE and head with perturbed weights, and the head's running
    statistics, as numpy trees."""
    vae = JaxVAE(jax_vae_cfg(**SMALL))
    vparams = jax.jit(vae.init)({"params": jax.random.key(0)},
                                jnp.zeros((1, RES, RES, 3)),
                                jax.random.key(1))["params"]
    head = JaxAttnHead(latent_channels=4, num_classes=TAGS,
                       attention=JaxAttnCfg(attention_heads=2))
    hvars = jax.jit(head.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(2)}, jnp.zeros((1, 4, 4, 4)),
        deterministic=True)
    rng = np.random.default_rng(3)
    stats = {"feature_compress_1": {
        "mean": (rng.normal(size=(2,)) * 0.1).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, size=(2,)).astype(np.float32)}}
    return (vae, _perturb(jax.device_get(vparams), 4), head,
            _perturb(jax.device_get(hvars["params"]), 5), stats)


def _port_state(remat=False):
    _, vparams, _, hparams, stats = _jax_models()
    vae = AutoencoderKL(default_flux_vae_config(**SMALL), remat=remat)
    vae.load_state_dict({k: v for k, v in torch_state_from_jax_params(
        vparams).items() if k.startswith("encoder.")}, strict=True)
    head = AttentionClassificationDecoder(
        4, TAGS, AttentionDecoderConfig(attention_heads=2))
    head.load_state_dict(torch_state_from_jax_params(hparams, stats),
                         strict=False)
    return TrainState(vae=vae, decoder=head, optimizer=None)


def _batch():
    rng = np.random.default_rng(6)
    batch = {k: rng.integers(0, 256, size=(B, RES, RES, 3), dtype=np.uint8)
             for k in ("anchor", "positive", "negative")}
    for k in ("labels", "positive_labels"):
        batch[k] = (rng.uniform(size=(B, TAGS)) < 0.4).astype(np.float32)
    noise = rng.normal(size=(3 * B, RES // 8, RES // 8, 4)).astype(np.float32)
    return batch, noise


def _port_loss_and_grads(state, batch, noise, monkeypatch, **steps_kw):
    eps = torch.from_numpy(noise)
    monkeypatch.setattr(DiagonalGaussian, "sample",
                        lambda self, generator: self.mean
                        + torch.exp(0.5 * self.logvar) * eps)
    steps = FullSteps(LossConfig(triplet_weight=1.0, use_focal_loss=True),
                      **steps_kw)
    total, metrics, probs = steps.forward_losses(
        state, batch_to_device(batch, torch.device("cpu")), None,
        train=False)
    total.backward()
    assert probs.shape == (B, TAGS)
    named = ([("vae." + n, p) for n, p in state.vae.named_parameters()]
             + [("head." + n, p) for n, p in state.decoder.named_parameters()])
    return total.item(), metrics, {n: p.grad.clone() for n, p in named}


def test_one_step_loss_and_gradients_match_jax(monkeypatch):
    """The stacked triplet encode, the posterior draw, the detached scaled
    anchor latents into the head and the simplified loss (triplet + focal):
    the loss and the gradient of every encoder and head parameter.
    rtol 1e-4: sums over a 32px triplet batch taken in another order."""
    vae, vparams, head, hparams, stats = _jax_models()
    batch, noise = _batch()
    cfg = JaxLossConfig(triplet_weight=1.0, use_focal_loss=True)

    def loss_fn(params):
        images = jnp.concatenate([jnp.asarray(batch[k]) for k in
                                  ("anchor", "positive", "negative")])
        post = vae.apply({"params": params["vae"]},
                         jax_normalize(images, jnp.float32),
                         method=JaxVAE.encode)
        z = post.mean + post.std * jnp.asarray(noise)
        latents = jax.lax.stop_gradient(jax_scaled(post.mean[:B],
                                                   vae.config))
        logits = head.apply({"params": params["head"], "batch_stats": stats},
                            latents, deterministic=True)
        labels = jnp.asarray(batch["labels"])
        total, _ = jax_simplified_loss(
            cfg, z[:B], z[B:2 * B], z[2 * B:], logits, labels, labels,
            jnp.asarray(batch["positive_labels"]))
        return total

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        {"vae": vparams, "head": hparams})
    loss, metrics, grads = _port_loss_and_grads(_port_state(), batch, noise,
                                                monkeypatch)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    assert set(metrics) == {"loss", "triplet_loss", "classification_loss"}
    want = {"vae." + k: v for k, v in torch_state_from_jax_params(
        jax.device_get(jgrads["vae"])).items() if k.startswith("encoder.")}
    want.update({"head." + k: v for k, v in torch_state_from_jax_params(
        jax.device_get(jgrads["head"])).items()})
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_remat_gives_the_same_gradients(monkeypatch):
    """Block remat plus the checkpointed whole encode against neither:
    the same arithmetic, replayed (atol 1e-6)."""
    batch, noise = _batch()
    plain = _port_loss_and_grads(_port_state(), batch, noise, monkeypatch)
    remat = _port_loss_and_grads(_port_state(remat=True), batch, noise,
                                 monkeypatch, checkpoint_encode=True)
    assert plain[0] == pytest.approx(remat[0], abs=1e-6)
    for name, g in plain[2].items():
        np.testing.assert_allclose(remat[2][name].numpy(), g.numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_posterior_sample_and_kl_match_jax():
    rng = np.random.default_rng(7)
    mean = rng.normal(size=(3, 4, 4, 2)).astype(np.float32)
    logvar = (rng.normal(size=(3, 4, 4, 2)) - 1).astype(np.float32)
    post = DiagonalGaussian.from_moments(torch.from_numpy(
        np.concatenate([mean, logvar], -1)))
    jpost = JaxPosterior(mean=jnp.asarray(mean), logvar=jnp.asarray(logvar))
    np.testing.assert_allclose(post.kl().numpy(), np.asarray(jpost.kl()),
                               rtol=1e-5)
    draw = post.sample(torch.Generator().manual_seed(0))
    again = post.sample(torch.Generator().manual_seed(0))
    assert torch.equal(draw, again) and draw.shape == post.mean.shape
    eps = torch.randn(post.mean.shape, generator=torch.Generator()
                      .manual_seed(0))
    np.testing.assert_allclose(
        draw.numpy(), (post.mean + torch.exp(0.5 * post.logvar) * eps)
        .numpy(), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# the CLI end to end
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A tiny VAE checkpoint (with two decoder tensors), a 12-image tagged
    dataset at 32px, and a 2-epoch run of the entry point on the CPU."""
    from PIL import Image

    root = tmp_path_factory.mktemp("train_full")
    cfg = default_flux_vae_config(block_out_channels=(8, 16, 16, 16),
                                  norm_num_groups=4, latent_channels=4)
    g = torch.Generator().manual_seed(0)
    extra = {"decoder.conv_in.weight": torch.randn(16, 4, 3, 3, generator=g),
             "decoder.conv_in.bias": torch.randn(16, generator=g)}
    vae = seeded_init_(AutoencoderKL(cfg, with_decoder=True), 0)
    vae.load_state_dict(extra, strict=False)
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
            "--decoder_checkpoint", str(root / "head.bin"),
            "--resolution", str(RES), "--train_batch_size", "2",
            "--save_steps", "1", "--logging_steps", "2",
            "--lr_warmup_steps", "1", "--mixed_precision", "no",
            "--num_workers", "2", "--attention_heads", "1",
            "--gradient_accumulation_steps", "2", "--val_draws", "2"]
    out = root / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "vae_tagger_tpu_torch.train.train_full",
         *base, "--output_dir", str(out), "--num_epochs", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(root=root, base=base, out=out, extra=extra,
                stdout=proc.stdout)


def test_cli_writes_history_checkpoints_and_exports(tiny_run):
    out = tiny_run["out"]
    history = json.loads((out / "training_history.json").read_text())
    assert len(history["train_loss"]) == len(history["val_loss"]) == 2
    assert set(history["train_metrics"]) == {"loss", "triplet_loss",
                                             "classification_loss"}
    assert all(np.isfinite(v) for v in history["train_loss"]
               + history["val_loss"] + history["learning_rates"])
    for d in ("best_checkpoint", "checkpoint-0", "checkpoint-1"):
        assert (out / d / "train_state.pt").exists(), d
    for d in ("vae", "best_vae"):
        state = load_state_file(
            str(out / d / "diffusion_pytorch_model.safetensors"))
        for k, v in tiny_run["extra"].items():
            assert torch.equal(state[k], v), (d, k)
        assert any(k.startswith("encoder.") for k in state)
    for d in ("decoder", "best_decoder"):
        assert (out / d / "pytorch_model.bin").exists()
    # 11 training images at batch 2: 6 micro-steps an epoch, 3 updates
    saved = torch.load(out / "checkpoint-1" / "train_state.pt",
                       weights_only=True)
    assert saved["step"] == 12 and saved["optimizer"]["count"] == 6


def test_exports_load_in_the_inference_cli(tiny_run):
    from vae_tagger_tpu_torch.infer.__main__ import main as infer_main

    out, root = tiny_run["out"], tiny_run["root"]
    res = infer_main([
        "--device", "cpu", "--vae_checkpoint",
        str(out / "vae" / "diffusion_pytorch_model.safetensors"),
        "--vae_config_path", str(out / "vae" / "config.json"),
        "--decoder_checkpoint", str(out / "decoder" / "pytorch_model.bin"),
        "--image_path", str(root / "images"), "--tags_csv_path",
        str(root / "tags.csv"), "--output_dir", str(root / "infer"),
        "--resolution", str(RES), "--batch_size", "4",
        "--attention_heads", "1"])
    assert len(res) == 12
    assert (root / "infer" / "classification_results.json").exists()


def test_resume_continues_the_step_count(tiny_run):
    """--resume_from restores the step, the optimizer and the schedule
    position, and runs num_epochs more epochs."""
    out2 = tiny_run["root"] / "resumed"
    train_full.main([*tiny_run["base"], "--output_dir", str(out2),
                     "--num_epochs", "1", "--resume_from",
                     str(tiny_run["out"] / "checkpoint-1")])
    saved = torch.load(out2 / "checkpoint-0" / "train_state.pt",
                       weights_only=True)
    assert saved["step"] == 18 and saved["optimizer"]["count"] == 9


# the flags that were refused until bucketing, the YUV wire format, the
# profiler capture and data parallelism were ported (--spatial_parallel is
# a no-op in one process)
LIFTED = ("--use_bucketing", "--transfer_format", "--profile_steps",
          "--spatial_parallel")


@pytest.mark.parametrize("flag", [
    ["train_full", "--use_bucketing"],
    ["train_full", "--transfer_format", "yuv420"],
    ["train_vae", "--use_bucketing"],
    ["train_vae", "--transfer_format", "yuv420"],
    ["train_full", "--spatial_parallel"],
    ["train_full", "--profile_steps", "3"]])
def test_unported_flags_are_refused(tiny_run, tmp_path, flag):
    """Both trainers refuse the flags whose path the port does not run;
    --use_bucketing, --transfer_format yuv420, --profile_steps and
    --spatial_parallel now run one epoch on the CPU, with finite losses,
    --profile_steps writing its trace and --spatial_parallel, a no-op in
    one process, the same history as the run without it
    (--no_simplified_loss and --use_adaptive_weights run since the full
    loss was ported: test_torch_train_vae.py)."""
    from vae_tagger_tpu_torch.train import train_vae

    main = {"train_full": train_full.main, "train_vae": train_vae.main}
    if flag[1] not in LIFTED:
        with pytest.raises(SystemExit, match="not ported"):
            main[flag[0]](["--json_path", "x.json", "--tags_csv_path",
                           "x.csv", "--output_dir", str(tmp_path),
                           *flag[1:]])
        return
    drop = {"--gradient_accumulation_steps", "--val_draws"}
    if flag[0] == "train_vae":  # train_vae has no head
        drop |= {"--decoder_checkpoint", "--attention_heads"}
    argv = tiny_run["base"]
    base = [a for i, a in enumerate(argv)
            if a not in drop and (i == 0 or argv[i - 1] not in drop)]
    extra = (["--base_resolution", "32", "--max_resolution", "48",
              "--bucket_step", "16"] if flag[1] == "--use_bucketing" else [])
    main[flag[0]]([*base, "--output_dir", str(tmp_path), "--num_epochs",
                   "1", *flag[1:], *extra])
    history = json.loads((tmp_path / "training_history.json").read_text())
    assert np.isfinite(history["train_loss"] + history["val_loss"]).all()
    if flag[1] == "--profile_steps":
        assert (tmp_path / "profile" / "trace.json").stat().st_size > 0
    if flag[1] == "--spatial_parallel":
        plain = tmp_path / "plain"
        main[flag[0]]([*base, "--output_dir", str(plain), "--num_epochs",
                       "1"])
        assert json.loads((plain / "training_history.json").read_text()
                          ) == history


def test_trainer_needs_a_gpu_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_full.main(["--json_path", "x.json", "--tags_csv_path",
                         "x.csv", "--output_dir", str(tmp_path)])
