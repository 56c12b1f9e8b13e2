"""The port's frozen-VAE head training (``train/steps.py::DecoderSteps``,
``python -m vae_tagger_tpu_torch.train.train_decoder``) on the CPU.

- One ``DecoderSteps`` train step against the JAX package's
  ``make_decoder_steps`` on the same weights and batch: the loss, every
  head parameter after the step and the BatchNorm running statistics
  (rtol 1e-4, atol 1e-5, the tolerance of test_torch_train.py's step
  test).  Both sides take a plain SGD step of rate 1, so the parameters
  after it carry the gradient itself (AdamW's first step would keep only
  its sign).  Dropout masks cannot match across frameworks, so the
  head's dropout layers pass their input through on both sides (the
  train-mode BatchNorm stays); ``attention_dropout=0``, as
  test_torch_train_vae.py does.  flax's BatchNorm takes the batch
  variance as E[x^2] - E[x]^2 by default, whose fp32 cancellation moves
  the head's first conv's gradient by ~1e-4 relative on these weights; the
  JAX side runs ``use_fast_variance=False`` here, the two-pass form that
  torch's ``F.batch_norm`` takes.
  The eval step's loss and probabilities, and the latents of
  ``encode_batch``, against the JAX package's.
- The CLI: two epochs with and without ``--cache_latents`` give the same
  head, bit for bit; the cache counts its hits (every batch after the
  first epoch, and the whole final phase), the encoder runs in the first
  epoch only, ``--cache_latents_max_gb`` caps it with one message, and a
  non-deterministic crop turns it off with a message; the exports classify
  through the infer CLI; ``--resume_from``; the YUV wire format.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from vae_tagger_tpu.core.config import AttentionDecoderConfig as JaxAttnCfg
from vae_tagger_tpu.core.config import default_flux_vae_config as jax_vae_cfg
from vae_tagger_tpu.losses.combined import LossConfig as JaxLossConfig
from vae_tagger_tpu.models.autoencoder_kl import AutoencoderKL as JaxVAE
from vae_tagger_tpu.models.taggers import (
    AttentionClassificationDecoder as JaxAttnHead,
)
from vae_tagger_tpu.train.state import TrainState as JaxTrainState
from vae_tagger_tpu.train.steps import make_decoder_steps
from vae_tagger_tpu_torch.core.config import (
    AttentionDecoderConfig,
    default_flux_vae_config,
)
from vae_tagger_tpu_torch.io.checkpoints import (
    save_decoder_bin,
    save_vae_pretrained,
    torch_state_from_jax_params,
)
from vae_tagger_tpu_torch.losses.classification import (
    class_balanced_weights,
)
from vae_tagger_tpu_torch.losses.combined import LossConfig
from vae_tagger_tpu_torch.models.autoencoder_kl import AutoencoderKL
from vae_tagger_tpu_torch.models.taggers import AttentionClassificationDecoder
from vae_tagger_tpu_torch.nn.blocks import seeded_init_
from vae_tagger_tpu_torch.ops import backend
from vae_tagger_tpu_torch.ops.image import rgb_to_yuv420_reference
from vae_tagger_tpu_torch.train import train_decoder
from vae_tagger_tpu_torch.train.state import TrainState
from vae_tagger_tpu_torch.train.steps import DecoderSteps

SMALL = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
             latent_channels=4)
RES, B, TAGS = 32, 3, 7


@pytest.fixture(autouse=True)
def _cpu_only():
    torch.backends.cudnn.allow_tf32 = False
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
    vae = JaxVAE(jax_vae_cfg(**SMALL))
    vparams = jax.jit(vae.init)({"params": jax.random.key(0)},
                                jnp.zeros((1, RES, RES, 3)),
                                jax.random.key(1))["params"]
    head = JaxAttnHead(latent_channels=4, num_classes=TAGS,
                       attention=JaxAttnCfg(attention_heads=2,
                                            attention_dropout=0.0))
    hvars = jax.jit(head.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(2)}, jnp.zeros((1, 4, 4, 4)),
        deterministic=True)
    rng = np.random.default_rng(3)
    stats = {"feature_compress_1": {
        "mean": (rng.normal(size=(2,)) * 0.1).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, size=(2,)).astype(np.float32)}}
    return (vae, _perturb(jax.device_get(vparams), 4), head,
            _perturb(jax.device_get(hvars["params"]), 5), stats)


class _SGD:
    """A plain SGD step of rate 1, the optimizer interface of
    DecoderSteps (``step()`` after every backward)."""

    def __init__(self, params):
        self.params = list(params)

    def step(self):
        with torch.no_grad():
            for p in self.params:
                p -= p.grad
                p.grad = None


def _port(cfg, cb_weights=None):
    _, vparams, _, hparams, stats = _jax_models()
    vae = AutoencoderKL(default_flux_vae_config(**SMALL))
    vae.load_state_dict({k: v for k, v in torch_state_from_jax_params(
        vparams).items() if not k.startswith("decoder.")}, strict=True)
    vae.eval().requires_grad_(False)
    head = AttentionClassificationDecoder(
        4, TAGS, AttentionDecoderConfig(attention_heads=2,
                                        attention_dropout=0.0))
    head.load_state_dict(torch_state_from_jax_params(hparams, stats),
                         strict=False)
    state = TrainState(vae=None, decoder=head,
                       optimizer=_SGD(head.parameters()))
    return state, DecoderSteps(vae, cfg, cb_weights=cb_weights)


def _batch(seed=6):
    rng = np.random.default_rng(seed)
    return {"pixel_values": rng.integers(0, 256, size=(B, RES, RES, 3),
                                         dtype=np.uint8),
            "labels": (rng.uniform(size=(B, TAGS)) < 0.4).astype(np.float32),
            "index": np.arange(B)}


LOSSES = {
    "bce": dict(),
    "focal": dict(use_focal_loss=True, focal_alpha=0.5, focal_gamma=1.5),
    "class_balanced": dict(use_class_balanced=True),
}


@pytest.mark.parametrize("loss", list(LOSSES))
def test_one_train_step_matches_make_decoder_steps(loss, monkeypatch):
    import flax.linen as fnn

    from vae_tagger_tpu_torch.models import taggers

    class TwoPassBatchNorm(fnn.BatchNorm):
        use_fast_variance: bool = False

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(fnn, "BatchNorm", TwoPassBatchNorm)
    monkeypatch.setattr(taggers, "dropout",
                        lambda x, p, training, generator=None: x)
    vae, vparams, head, hparams, stats = _jax_models()
    batch = _batch()
    counts = np.arange(1, TAGS + 1, dtype=np.float32) * 3
    cb = class_balanced_weights(counts) if loss == "class_balanced" else None
    jtrain, jeval = make_decoder_steps(
        vae, head, JaxLossConfig(**LOSSES[loss]),
        cb_weights=None if cb is None else jnp.asarray(cb))
    jstate = JaxTrainState.create(hparams, optax.sgd(1.0),
                                  batch_stats=stats)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()
              if k != "index"}
    want_eval = jeval(jstate, vparams, jbatch)
    # the train steps donate their state: a fresh one for each
    _, want_full = jtrain(JaxTrainState.create(hparams, optax.sgd(1.0),
                                               batch_stats=stats),
                          vparams, jbatch, jax.random.key(0))
    # the step proper on the JAX package's latents: the encoders' ~1e-6
    # differences would reach the head's first conv through train-mode
    # BatchNorm over 48 values a channel, 1e-4 relative
    latents = np.array(jtrain.encode_batch(vparams, jbatch))
    jstate, jmetrics = jtrain.from_latents(
        jstate, jnp.asarray(latents), jbatch["labels"], jax.random.key(0))

    state, steps = _port(LossConfig(**LOSSES[loss]),
                         None if cb is None else torch.from_numpy(cb))
    got_eval = steps.eval_step(state, batch)
    np.testing.assert_allclose(got_eval["loss"].item(),
                               float(want_eval["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got_eval["probs"].numpy(),
                               np.asarray(want_eval["probs"]), rtol=1e-4,
                               atol=1e-6)
    copy, _ = _port(LossConfig(**LOSSES[loss]),
                    None if cb is None else torch.from_numpy(cb))
    full = steps.train_step(copy, batch, 0)
    np.testing.assert_allclose(full["loss"].item(),
                               float(want_full["loss"]), rtol=1e-5)
    metrics = steps.train_step_from_latents(
        state, torch.from_numpy(latents), torch.from_numpy(batch["labels"]),
        0)
    assert set(metrics) == {"loss"} and state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(),
                               float(jmetrics["loss"]), rtol=1e-5)
    want = torch_state_from_jax_params(jax.device_get(jstate.params),
                                       jax.device_get(jstate.batch_stats))
    got = state.decoder.state_dict()
    assert {n for n, _ in state.decoder.named_parameters()} <= set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_encode_batch_matches_the_jax_encode_and_takes_yuv():
    vae, vparams, head, _, _ = _jax_models()
    batch = _batch(8)
    jtrain, _ = make_decoder_steps(vae, head, JaxLossConfig())
    want = np.asarray(jtrain.encode_batch(
        vparams, {"pixel_values": jnp.asarray(batch["pixel_values"])}))
    _, steps = _port(LossConfig())
    got = steps.encode_batch(steps.to_device(batch))
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    planes = [rgb_to_yuv420_reference(im) for im in batch["pixel_values"]]
    yuv = {"pixel_values_y": np.stack([p[0] for p in planes]),
           "pixel_values_cbcr": np.stack([p[1] for p in planes]),
           "labels": batch["labels"]}
    from vae_tagger_tpu_torch.ops.image import yuv420_to_rgb_uint8

    rgb = yuv420_to_rgb_uint8(torch.from_numpy(yuv["pixel_values_y"]),
                              torch.from_numpy(yuv["pixel_values_cbcr"]))
    torch.testing.assert_close(
        steps.encode_batch(steps.to_device(yuv)),
        steps.encode_batch({"pixel_values": rgb}), rtol=0, atol=0)


def test_bf16_encode_casts_the_latents():
    _, steps = _port(LossConfig())
    steps.compute_dtype = torch.bfloat16
    got = steps.encode_batch(steps.to_device(_batch()))
    assert got.dtype == torch.bfloat16 and got.shape == (B, 4, 4, 4)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_decoder")
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
            "--lr_warmup_steps", "1", "--mixed_precision", "no",
            "--num_workers", "2", "--attention_heads", "1",
            "--num_epochs", "2", "--seed", "0"]
    return dict(root=root, base=base)


_ENCODE_BATCH = DecoderSteps.encode_batch


def _run(run_dir, name, *flags, monkeypatch=None):
    """train_decoder's CLI, counting the encodes it runs per phase."""
    encodes = []

    def counted(self, batch):
        encodes.append(len(batch["labels"]))
        return _ENCODE_BATCH(self, batch)

    if monkeypatch is not None:
        monkeypatch.setattr(DecoderSteps, "encode_batch", counted)
    out = run_dir["root"] / name
    state = train_decoder.main([*run_dir["base"], "--output_dir", str(out),
                                *flags])
    return state, out, encodes


def _cache_line(text, prefix):
    line = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    assert line, (prefix, text)
    hits, misses = (int(w) for w in line[0].split(":")[1].split()[0:4:3])
    return hits, misses


def test_cli_cache_gives_the_same_head_and_skips_the_encoder(
        run_dir, monkeypatch, capsys):
    """11 training images at batch 4: 3 batches an epoch, 1 validation
    batch.  Epoch 1 encodes 4 batches; epoch 2 and the final phase read
    the cache alone."""
    plain, out0, enc0 = _run(run_dir, "nocache", monkeypatch=monkeypatch)
    capsys.readouterr()
    cached, out1, enc1 = _run(run_dir, "cache", "--cache_latents",
                              monkeypatch=monkeypatch)
    text = capsys.readouterr().out
    assert len(enc0) == 2 * (3 + 1) + 1 and len(enc1) == 3 + 1
    assert _cache_line(text, "training latent cache:") == (4, 4)
    assert _cache_line(text, "final eval latent cache:") == (1, 0)
    for (n, a), b in zip(plain.decoder.state_dict().items(),
                         cached.decoder.state_dict().values()):
        assert torch.equal(a, b), n
    h0 = json.loads((out0 / "training_history.json").read_text())
    h1 = json.loads((out1 / "training_history.json").read_text())
    assert h0 == h1 and len(h0["train_loss"]) == 2
    for f in ("best_pytorch_model.bin", "pytorch_model.bin",
              "optimal_thresholds.json", "evaluation_results.csv",
              "evaluation_results_overall.json"):
        assert (out1 / f).exists(), f


def test_cli_cache_cap_and_nondeterministic_crop(run_dir, monkeypatch,
                                                 capsys):
    _, _, enc = _run(run_dir, "capped", "--cache_latents",
                     "--cache_latents_max_gb", "1e-9",
                     monkeypatch=monkeypatch)
    text = capsys.readouterr().out
    assert text.count("latent cache reached --cache_latents_max_gb") == 1
    assert len(enc) == 2 * (3 + 1) + 1
    assert _cache_line(text, "final eval latent cache:") == (0, 1)

    real = train_decoder.build_dataset_and_loaders

    def random_crop(args, return_triplets=True):
        dataset, tl, vl = real(args, return_triplets)
        dataset.crop_mode = "random"
        return dataset, tl, vl

    monkeypatch.setattr(train_decoder, "build_dataset_and_loaders",
                        random_crop)
    _, _, enc = _run(run_dir, "random_crop", "--cache_latents",
                     monkeypatch=monkeypatch)
    text = capsys.readouterr().out
    assert "--cache_latents ignored: non-deterministic image transform" \
        in text and "final eval latent cache" not in text
    assert len(enc) == 2 * (3 + 1) + 1


def test_cli_exports_classify_resume_and_yuv(run_dir):
    from vae_tagger_tpu_torch.infer.__main__ import main as infer_main

    root = run_dir["root"]
    state, out, _ = _run(run_dir, "exports", "--decoder_checkpoint",
                         str(root / "head.bin"), "--use_focal_loss")
    # warm-started from head.bin, every head parameter trained
    before = torch.load(root / "head.bin", weights_only=True)
    saved = torch.load(out / "pytorch_model.bin", weights_only=True)
    assert all(not torch.equal(saved[k], before[k])
               for k, _ in state.decoder.named_parameters())
    res = infer_main([
        "--device", "cpu", "--vae_checkpoint",
        str(root / "vae" / "diffusion_pytorch_model.safetensors"),
        "--vae_config_path", str(root / "vae" / "config.json"),
        "--decoder_checkpoint", str(out / "best_pytorch_model.bin"),
        "--image_path", str(root / "images"), "--tags_csv_path",
        str(root / "tags.csv"), "--output_dir", str(root / "infer"),
        "--resolution", str(RES), "--batch_size", "4",
        "--attention_heads", "1"])
    assert len(res) == 12
    resumed, _, _ = _run(run_dir, "resumed", "--num_epochs", "1",
                         "--resume_from", str(out / "checkpoint-1"))
    assert resumed.step == 9 and resumed.optimizer.count == 9
    state, out, _ = _run(run_dir, "yuv", "--transfer_format", "yuv420",
                         "--cache_latents")
    history = json.loads((out / "training_history.json").read_text())
    assert np.isfinite(history["train_loss"] + history["val_loss"]).all()


def test_cli_needs_a_gpu_unless_told_cpu(run_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    argv = [a for a in run_dir["base"] if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_decoder.main([*argv, "--output_dir", str(tmp_path)])
