"""The port's train_vae and full-loss train_full paths on the CPU, against
the JAX package: ``log_damped_kl``, ``combined_loss`` and
``AdaptiveLossWeights``; one VAE step (``VaeSteps``, simplified and with
the KL optimized) and one full-loss ``FullSteps`` step (fixed and adaptive
weights), loss and the gradient of every parameter, encoder, decoder, head
and adaptive weights, against the JAX package's own ``make_vae_steps`` and
``make_full_steps`` steps (their gradients captured by an optax
transformation that keeps them) with the same posterior noise; the two
independent posterior draws; the KL envelope of a short non-simplified run
of each trainer; and the two entry points end to end.

Randomness cannot match across frameworks, so the posterior noise comes
from numpy on both sides (each draw told apart by its batch size), and the
head runs deterministic (flax ``deterministic=True``, torch ``eval()``) in
the full-loss step; train-mode BatchNorm is covered in
test_torch_train_ops.py.  Tolerances: fp32; loss rtol 1e-5, every
gradient within 1e-4 of the JAX one relative to its norm.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_tagger_tpu.core.config import AttentionDecoderConfig as JaxAttnCfg
from vae_tagger_tpu.core.config import default_flux_vae_config as jax_vae_cfg
from vae_tagger_tpu.losses import combined as jax_combined
from vae_tagger_tpu.models import autoencoder_kl as jax_ak
from vae_tagger_tpu.models.taggers import (
    AttentionClassificationDecoder as JaxAttnHead,
)
from vae_tagger_tpu.train import steps as jax_steps
from vae_tagger_tpu.train.state import TrainState as JaxTrainState
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
from vae_tagger_tpu_torch.losses import combined
from vae_tagger_tpu_torch.models.autoencoder_kl import (
    AutoencoderKL,
    DiagonalGaussian,
)
from vae_tagger_tpu_torch.models.taggers import AttentionClassificationDecoder
from vae_tagger_tpu_torch.nn.blocks import seeded_init_
from vae_tagger_tpu_torch.ops import backend
from vae_tagger_tpu_torch.train import steps as port_steps
from vae_tagger_tpu_torch.train import train_full, train_vae
from vae_tagger_tpu_torch.train.state import TrainState

TINY = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
            latent_channels=4)
RES, B, TAGS = 32, 2, 6
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu_only():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backend.reset_launch_counts()
    yield
    assert sum(backend.launch_counts().values()) == 0


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(a, np.float32)
        + (rng.normal(size=np.shape(a)) * scale).astype(np.float32)
        for a in leaves])


# --------------------------------------------------------------------------
# the loss functions
# --------------------------------------------------------------------------

def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    labels = (rng.uniform(size=(B, TAGS)) < 0.5).astype(np.float32)
    return dict(reconstruction=f(B, 8, 8, 3), target_images=f(B, 8, 8, 3),
                kl_a=np.abs(f(B)) * 300, kl_p=np.abs(f(B)) * 300,
                kl_n=np.abs(f(B)) * 300, z_a=f(B, 2, 2, 4), z_p=f(B, 2, 2, 4),
                z_n=f(B, 2, 2, 4), classification_logits=f(B, TAGS),
                classification_targets=labels, anchor_labels=labels,
                positive_labels=labels[::-1].copy())


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("similarity", ["cosine", "euclidean"])
def test_combined_loss_matches_jax(adaptive, similarity):
    kw = _loss_inputs(1)
    log_w = np.array([0.3, -0.2, 0.1, 0.5], np.float32)
    cfg_kw = dict(use_adaptive_weights=adaptive, similarity_type=similarity,
                  kl_weight=1e-2, use_focal_loss=True)
    jfn = None
    if adaptive:
        mod = jax_combined.AdaptiveLossWeights(num_losses=4, temperature=2.0)
        jfn = lambda losses: mod.apply(  # noqa: E731
            {"params": {"log_weights": jnp.asarray(log_w)}}, losses)
    want_total, want = jax_combined.combined_loss(
        jax_combined.LossConfig(**cfg_kw),
        *[jnp.asarray(kw[k]) for k in list(kw)[:10]],
        anchor_labels=jnp.asarray(kw["anchor_labels"]),
        positive_labels=jnp.asarray(kw["positive_labels"]),
        adaptive_weights_fn=jfn)
    port_w = None
    if adaptive:
        port_w = combined.AdaptiveLossWeights(4, temperature=2.0)
        port_w.log_weights.data = torch.from_numpy(log_w)
    t = {k: torch.from_numpy(v) for k, v in kw.items()}
    got_total, got = combined.combined_loss(
        combined.LossConfig(**cfg_kw),
        *[t[k] for k in list(kw)[:10]], anchor_labels=t["anchor_labels"],
        positive_labels=t["positive_labels"], adaptive_weights=port_w)
    assert got_total.item() == pytest.approx(float(want_total), rel=1e-5)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_log_damped_kl_and_adaptive_weights_match_jax():
    rng = np.random.default_rng(2)
    kls = [np.abs(rng.normal(size=(3,))).astype(np.float32) * 5e3
           for _ in range(3)]
    np.testing.assert_allclose(
        combined.log_damped_kl(*map(torch.from_numpy, kls)).item(),
        float(jax_combined.log_damped_kl(*map(jnp.asarray, kls))),
        rtol=1e-6)
    losses = [0.7, 0.02, 1.3, 0.4]
    mod = jax_combined.AdaptiveLossWeights(num_losses=4, temperature=0.5)
    params = mod.init(jax.random.key(0), losses)["params"]
    assert not np.any(np.asarray(params["log_weights"]))  # zero init
    port = combined.AdaptiveLossWeights(4, temperature=0.5)
    assert not port.log_weights.detach().any()
    log_w = np.array([0.1, 0.4, -0.3, 0.0], np.float32)
    want_t, want_w = mod.apply({"params": {"log_weights": log_w}}, losses)
    port.log_weights.data = torch.from_numpy(log_w)
    total, weights = port([torch.tensor(v) for v in losses])
    total.backward()
    np.testing.assert_allclose(weights.detach().numpy(), np.asarray(want_w),
                               rtol=1e-6)
    assert total.item() == pytest.approx(float(want_t), rel=1e-6)
    jgrad = jax.grad(lambda lw: mod.apply({"params": {"log_weights": lw}},
                                          losses)[0])(jnp.asarray(log_w))
    np.testing.assert_allclose(port.log_weights.grad.numpy(),
                               np.asarray(jgrad), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# one step against the JAX package's steps
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_models():
    vae = jax_ak.AutoencoderKL(jax_vae_cfg(**TINY))
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


def _batch():
    rng = np.random.default_rng(6)
    batch = {k: rng.integers(0, 256, size=(B, RES, RES, 3), dtype=np.uint8)
             for k in ("anchor", "positive", "negative")}
    for k in ("labels", "positive_labels"):
        batch[k] = (rng.uniform(size=(B, TAGS)) < 0.4).astype(np.float32)
    shape = (RES // 8, RES // 8, 4)
    noise = {3 * B: rng.normal(size=(3 * B, *shape)).astype(np.float32),
             B: rng.normal(size=(B, *shape)).astype(np.float32)}
    return batch, noise


def _keep_grads():
    """An optax transformation whose state is the last gradient: the JAX
    step's own gradients, read from the state it returns."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def _patch_noise(monkeypatch, noise):
    """Both packages' posterior draws take the numpy noise of their batch
    size: 3B for the triplet draw, B for the reconstruction's."""
    monkeypatch.setattr(jax_ak.DiagonalGaussian, "sample",
                        lambda self, rng: self.mean + self.std * jnp.asarray(
                            noise[self.mean.shape[0]]))
    monkeypatch.setattr(DiagonalGaussian, "sample",
                        lambda self, generator: self.mean
                        + torch.exp(0.5 * self.logvar)
                        * torch.from_numpy(noise[self.mean.shape[0]]))


def _port_models(with_head=True, adaptive=None):
    _, vparams, _, hparams, stats = _jax_models()
    vae = AutoencoderKL(default_flux_vae_config(**TINY), with_decoder=True)
    vae.load_state_dict(torch_state_from_jax_params(vparams), strict=True)
    head = None
    if with_head:
        head = AttentionClassificationDecoder(
            4, TAGS, AttentionDecoderConfig(attention_heads=2,
                                            attention_dropout=0.0))
        head.load_state_dict(torch_state_from_jax_params(hparams, stats),
                             strict=False)
    ada = None
    if adaptive is not None:
        ada = combined.AdaptiveLossWeights(4)
        ada.log_weights.data = torch.from_numpy(adaptive)
    return TrainState(vae=vae, decoder=head, optimizer=None, adaptive=ada)


def _grads_of(state):
    named = [("vae." + n, p) for n, p in state.vae.named_parameters()]
    if state.decoder is not None:
        named += [("head." + n, p) for n, p in
                  state.decoder.named_parameters()]
    if state.adaptive is not None:
        named += [("adaptive.log_weights", state.adaptive.log_weights)]
    return {n: p.grad for n, p in named}


# JAX-side gradient norms below this are structurally zero (a key
# projection's bias: softmax ignores a shift shared by all keys) and hold
# only fp32 rounding noise, on both sides: the port's must be noise too
ZERO_GRAD_NORM = 1e-6


def _assert_grads_match(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g is not None, name
        diff = float(np.linalg.norm(g.numpy() - w))
        norm = float(np.linalg.norm(w))
        if norm < ZERO_GRAD_NORM:
            assert np.linalg.norm(g.numpy()) < ZERO_GRAD_NORM, (name, diff)
        else:
            assert diff / norm <= 1e-4, (name, diff / norm)


@pytest.mark.parametrize("use_simplified", [True, False])
def test_vae_step_loss_and_gradients_match_jax(use_simplified, monkeypatch):
    """The stacked triplet encode, the triplet draw, the anchor decoded
    from its own draw, recon MSE + triplet (+ the log-damped KL when not
    simplified): loss, every metric, and the gradient of every encoder and
    decoder parameter against ``make_vae_steps``' step."""
    vae, vparams, _, _, _ = _jax_models()
    batch, noise = _batch()
    _patch_noise(monkeypatch, noise)
    cfg_kw = dict(reconstruction_weight=0.5, kl_weight=0.3,
                  triplet_weight=1.0)
    train_step, eval_step = jax_steps.make_vae_steps(
        vae, jax_combined.LossConfig(**cfg_kw),
        use_simplified=use_simplified)
    jstate = JaxTrainState.create(jax.tree.map(jnp.array, vparams),
                                  _keep_grads())
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, jmetrics = train_step(jstate, jbatch, jax.random.key(0))

    state = _port_models(with_head=False)
    steps = port_steps.VaeSteps(combined.LossConfig(**cfg_kw),
                                use_simplified=use_simplified)
    total, metrics, probs = steps.forward_losses(
        state, port_steps.batch_to_device(batch, torch.device("cpu")), None,
        train=True)
    total.backward()
    assert probs is None
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        assert metrics[k].item() == pytest.approx(float(v), rel=1e-5), k
    want = {"vae." + k: v.numpy() for k, v in torch_state_from_jax_params(
        jax.device_get(jstate.opt_state)).items()}
    _assert_grads_match({k: v for k, v in _grads_of(state).items()}, want)


@pytest.mark.parametrize("adaptive", [False, True])
def test_full_loss_step_gradients_match_jax(adaptive, monkeypatch):
    """``FullSteps`` with the full loss (recon of its own draw + log-damped
    KL + triplet + focal classification, fixed or adaptive weights): loss
    and every gradient (encoder, decoder, head, adaptive weights) against
    ``make_full_steps``' step, the head deterministic on both sides."""
    vae, vparams, head, hparams, stats = _jax_models()
    batch, noise = _batch()
    _patch_noise(monkeypatch, noise)
    log_w = np.array([0.2, -0.1, 0.3, 0.05], np.float32)
    cfg_kw = dict(use_adaptive_weights=adaptive, use_focal_loss=True,
                  reconstruction_weight=0.5, kl_weight=0.2)
    module = jax_combined.AdaptiveLossWeights(num_losses=4) if adaptive \
        else None
    params = {"vae": jax.tree.map(jnp.array, vparams),
              "decoder": jax.tree.map(jnp.array, hparams)}
    if adaptive:
        params["adaptive"] = {"log_weights": jnp.asarray(log_w)}
    monkeypatch.setattr(
        jax_steps, "_decoder_forward",
        lambda decoder, params, stats, latents, *, train, rng: (
            decoder.apply({"params": params, "batch_stats": stats}, latents,
                          deterministic=True), stats))
    train_step, _ = jax_steps.make_full_steps(
        vae, head, jax_combined.LossConfig(**cfg_kw), use_simplified=False,
        adaptive_module=module)
    jstate = JaxTrainState.create(params, _keep_grads(),
                                  batch_stats=jax.tree.map(jnp.array, stats))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, jmetrics = train_step(jstate, jbatch, jax.random.key(0))

    state = _port_models(adaptive=log_w if adaptive else None)
    steps = port_steps.FullSteps(combined.LossConfig(**cfg_kw),
                                 use_simplified=False)
    total, metrics, _ = steps.forward_losses(
        state, port_steps.batch_to_device(batch, torch.device("cpu")), None,
        train=False)
    total.backward()
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(v),
                                   rtol=1e-5, err_msg=k)
    jg = jax.device_get(jstate.opt_state)
    want = {"vae." + k: v.numpy()
            for k, v in torch_state_from_jax_params(jg["vae"]).items()}
    want.update({"head." + k: v.numpy() for k, v in
                 torch_state_from_jax_params(jg["decoder"]).items()})
    if adaptive:
        want["adaptive.log_weights"] = np.asarray(
            jg["adaptive"]["log_weights"])
    _assert_grads_match(_grads_of(state), want)


@pytest.mark.parametrize("which", ["vae", "full"])
def test_recon_draw_independent_of_triplet_draw(which, monkeypatch):
    """The reconstruction decodes its OWN posterior draw: one (3B, ...)
    triplet draw and one (B, ...) anchor draw per step, from two distinct
    generators of the step (streams 0 and 1), whose numbers differ.  A
    shared draw measurably destabilizes training (the JAX package's
    test_recon_draw_independent_of_triplet_draw)."""
    calls = []
    orig = DiagonalGaussian.sample

    def counting_sample(self, generator):
        calls.append((self.mean.shape[0], generator))
        return orig(self, generator)

    monkeypatch.setattr(DiagonalGaussian, "sample", counting_sample)
    batch, _ = _batch()
    cfg = combined.LossConfig(use_focal_loss=True)
    if which == "vae":
        state = _port_models(with_head=False)
        steps = port_steps.VaeSteps(cfg)
    else:
        state = _port_models()
        steps = port_steps.FullSteps(cfg, use_simplified=False)
    state.optimizer = type("NoOp", (), {"step": lambda self: None})()
    steps.train_step(state, batch, 7)
    assert sorted(n for n, _ in calls) == [B, 3 * B], calls
    gens = {n: g for n, g in calls}
    assert gens[B] is not gens[3 * B]
    a, b = port_steps.step_generators(torch.device("cpu"), 0, 7)
    assert not torch.equal(torch.randn(8, generator=a),
                           torch.randn(8, generator=b))


# --------------------------------------------------------------------------
# the entry points, end to end on the CPU
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A tiny full VAE checkpoint (decoder included), a head, and 16 tagged
    PNGs at 32px."""
    from PIL import Image

    root = tmp_path_factory.mktemp("train_vae")
    cfg = default_flux_vae_config(**TINY)
    vae = seeded_init_(AutoencoderKL(cfg, with_decoder=True), 0)
    save_vae_pretrained(vae, cfg, str(root / "vae"))
    head = seeded_init_(AttentionClassificationDecoder(
        4, TAGS, AttentionDecoderConfig(attention_heads=1)), 1)
    save_decoder_bin(head, str(root / "head.bin"))
    rng = np.random.default_rng(8)
    tags = [f"t{i}" for i in range(TAGS)]
    (root / "tags.csv").write_text(
        "name,count\n" + "".join(f"{t},1\n" for t in tags))
    (root / "images").mkdir()
    data = {}
    for i in range(16):
        p = root / "images" / f"{i}.png"
        base = rng.integers(0, 256, (1, 1, 3))
        img = np.clip(base + rng.normal(0, 30, (36, 36, 3)), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(p)
        data[str(p)] = ", ".join(f"{t}:0.9" for t in
                                 rng.choice(tags, 2, replace=False))
    (root / "data.json").write_text(json.dumps(data))
    base = ["--device", "cpu", "--json_path", str(root / "data.json"),
            "--tags_csv_path", str(root / "tags.csv"),
            "--vae_checkpoint",
            str(root / "vae" / "diffusion_pytorch_model.safetensors"),
            "--vae_config_path", str(root / "vae" / "config.json"),
            "--resolution", str(RES), "--save_steps", "1",
            "--logging_steps", "4", "--lr_warmup_steps", "1",
            "--mixed_precision", "no", "--num_workers", "2", "--seed", "0"]
    return dict(root=root, base=base, vae=vae)


def test_train_vae_cli_epoch_exports_and_resume(data):
    root = data["root"]
    out = root / "vae_out"
    proc = subprocess.run(
        [sys.executable, "-m", "vae_tagger_tpu_torch.train.train_vae",
         *data["base"], "--output_dir", str(out), "--num_epochs", "2",
         "--train_batch_size", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    history = json.loads((out / "training_history.json").read_text())
    assert set(history["train_metrics"]) == {
        "loss", "reconstruction_loss", "kl_loss", "triplet_loss"}
    assert all(np.isfinite(v) for vs in history["train_metrics"].values()
               for v in vs)
    before = data["vae"].state_dict()
    for d in ("vae", "best_vae"):
        after = load_state_file(
            str(out / d / "diffusion_pytorch_model.safetensors"))
        assert set(after) == set(before)
        changed = [k for k in before if not torch.equal(after[k],
                                                        before[k])]
        # every trained tensor moved, the decoder's as well
        assert any(k.startswith("decoder.") for k in changed)
        assert any(k.startswith("encoder.") for k in changed)
    # 15 training images at batch 2: 8 steps an epoch
    saved = torch.load(out / "checkpoint-1" / "train_state.pt",
                       weights_only=True)
    assert saved["step"] == 16 and "decoder" not in saved
    out2 = root / "vae_resumed"
    train_vae.main([*data["base"], "--output_dir", str(out2),
                    "--num_epochs", "1", "--train_batch_size", "2",
                    "--resume_from", str(out / "checkpoint-1")])
    saved = torch.load(out2 / "checkpoint-0" / "train_state.pt",
                       weights_only=True)
    assert saved["step"] == 24 and saved["optimizer"]["count"] == 24


def test_train_full_full_loss_adaptive_cli_and_final_evaluation(data):
    root = data["root"]
    out = root / "full_out"
    state = train_full.main([
        *data["base"], "--output_dir", str(out), "--num_epochs", "1",
        "--train_batch_size", "2", "--decoder_checkpoint",
        str(root / "head.bin"), "--attention_heads", "1",
        "--no_simplified_loss", "--use_adaptive_weights"])
    history = json.loads((out / "training_history.json").read_text())
    assert set(history["train_metrics"]) == {
        "loss", "reconstruction_loss", "kl_loss", "triplet_loss",
        "classification_loss"}
    assert all(np.isfinite(v) for vs in history["train_metrics"].values()
               for v in vs)
    assert state.adaptive is not None and state.adaptive.log_weights.abs() \
        .max().item() > 0  # the adaptive weights moved from zero
    saved = torch.load(out / "checkpoint-0" / "train_state.pt",
                       weights_only=True)
    assert "adaptive" in saved
    thresholds = json.loads((out / "optimal_thresholds.json").read_text())
    assert set(thresholds) == {"global_threshold", "global_f1",
                               "per_class_thresholds"}
    assert len(thresholds["per_class_thresholds"]) == TAGS
    overall = json.loads((out / "evaluation_results_overall.json")
                         .read_text())
    assert "f1_macro" in overall and "mAP" in overall
    assert (out / "evaluation_results.csv").exists()
    after = load_state_file(str(out / "vae" /
                                "diffusion_pytorch_model.safetensors"))
    before = data["vae"].state_dict()
    assert any(not torch.equal(after[k], before[k]) for k in before
               if k.startswith("decoder."))  # the recon term trains it


def test_simplified_loss_exports_the_decoder_unchanged(data):
    """Under the simplified loss the decoder gets no gradient (.grad stays
    None, not zeros), AdamW skips it, and the export writes every decoder
    tensor back as loaded while the encoder moves."""
    root = data["root"]
    out = root / "simplified_out"
    state = train_full.main([
        *data["base"], "--output_dir", str(out), "--num_epochs", "1",
        "--train_batch_size", "2", "--decoder_checkpoint",
        str(root / "head.bin"), "--attention_heads", "1",
        "--weight_decay", "0.1"])
    assert all(p.grad is None for p in state.vae.decoder.parameters())
    assert state.adaptive is None
    after = load_state_file(str(out / "vae" /
                                "diffusion_pytorch_model.safetensors"))
    before = data["vae"].state_dict()
    dec = [k for k in before if k.startswith("decoder.")]
    assert dec and all(torch.equal(after[k], before[k]) for k in dec)
    assert any(not torch.equal(after[k], before[k]) for k in before
               if k.startswith("encoder."))
    assert (out / "optimal_thresholds.json").exists()


def _assert_kl_envelope(hist):
    """The JAX package's guard against the shared-draw bug class
    (tests/test_convergence.py): the log-damped KL stays inside the
    reference's envelope (0.02-0.86; the bug saturated near 12), the
    reconstruction descends, and the paired validation objective does not
    rise every epoch."""
    kl = hist["train_metrics"]["kl_loss"]
    assert max(kl) < 2.0, kl
    recon = hist["train_metrics"]["reconstruction_loss"]
    assert np.mean(recon[-2:]) < recon[0], recon
    val = hist["val_loss"]
    assert not all(b > a for a, b in zip(val, val[1:])), (val, recon)


@pytest.mark.parametrize("trainer", ["train_vae", "train_full"])
def test_kl_envelope_of_a_non_simplified_run(data, trainer):
    """Four epochs at batch 1 with the KL optimized (weight 1e-2, the
    reference CLI's train_vae default) and lr 1e-3."""
    out = data["root"] / f"kl_{trainer}"
    argv = [*data["base"], "--output_dir", str(out), "--num_epochs", "4",
            "--train_batch_size", "1", "--learning_rate", "1e-3",
            "--kl_weight", "1e-2", "--save_steps", "100"]
    if trainer == "train_vae":
        args = train_vae.build_parser().parse_args(argv)
        args.use_simplified_vae_loss = False  # the CLI has no off switch
        train_vae.train_vae(args)
    else:
        train_full.main([*argv, "--no_simplified_loss", "--attention_heads",
                         "1", "--decoder_checkpoint",
                         str(data["root"] / "head.bin")])
    _assert_kl_envelope(json.loads((out / "training_history.json")
                                   .read_text()))


def test_train_vae_needs_a_gpu_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_vae.main(["--json_path", "x.json", "--tags_csv_path",
                        "x.csv", "--output_dir", str(tmp_path)])
