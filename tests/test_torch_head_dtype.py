"""The tagger head in the compute dtype, against the JAX package's head at
``dtype=bfloat16``, on the CPU, on the same weights
(``torch_state_from_jax_params``) and the same bf16 latents.

The JAX engine and trainers build the head with ``dtype=compute_dtype``
and feed it ``latents.astype(compute_dtype)``: under mixed precision every
conv and Dense of the head runs in bf16, the softmaxes in fp32 cast back,
LayerNorm and BatchNorm with fp32 statistics and bf16 output.  The port's
head does the same (models/taggers.py), fed by ``TaggerEngine`` and
``DecoderSteps`` in the policy's compute dtype.

The reference is the flax module applied op by op (``apply`` and
``jax.value_and_grad`` outside ``jax.jit``), each op rounding to bf16 where
its definition says.  Under ``jax.jit`` XLA fuses the elementwise bf16 ops
and runs them in fp32, which moves these heads' logits by up to 0.023
(measured on these weights), as far as an fp32 head is from either; so the
jitted engine and step are no bf16 reference.

- eval: ``TaggerEngine.classify`` under the bf16 policy against the JAX
  head on the engine's own latents cast to bf16: probabilities within
  ``EVAL_ATOL``;
- one train step: ``DecoderSteps(compute_dtype=bfloat16)`` against the
  gradient of the JAX head's classification term, the port's step a plain
  SGD step of rate 1 (the parameters after it carry the gradient), dropout
  passed through on both sides and flax's BatchNorm on its two-pass
  variance (as tests/test_torch_train_decoder.py does): the loss within
  ``LOSS_RTOL`` relative, every gradient within ``GRAD_TOL`` of the
  largest gradient magnitude of the head; parameters and gradients stay
  fp32;
- the fp32 head is unchanged: the same engine under the fp32 policy
  against the JAX fp32 head within 1e-6.

Measured on these weights: the attention and plain heads' probabilities
are equal to the reference's (up to the final fp32 sigmoid, 6e-8); the
cross-attention head's differ by 1.4e-3 (its 512-wide Dense sums in
another order, flipping a few bf16 roundings).  Gradients: 1.6e-2,
8.6e-2 and 2.6e-3 of the largest (attention, cross, plain); the loss
within 3.2e-3 relative (train-mode BatchNorm's fp32 statistics, summed in
another order, flip a few bf16 roundings).  The fp32 head fed the same
bf16 latents, as the port ran it before, differs in probability by
3.5e-3, 2.6e-3 and 2.5e-3, and in gradient by 2.5e-1, 2.3e-1 and
2.2e-2: every eval case and the two attention heads' train steps fail.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_tagger_tpu.core.config import AttentionDecoderConfig as JaxAttnCfg
from vae_tagger_tpu.losses.combined import LossConfig as JaxLossConfig
from vae_tagger_tpu.models.taggers import (
    AttentionClassificationDecoder as JaxAttnHead,
)
from vae_tagger_tpu.models.taggers import ClassificationDecoder as JaxPlain
from vae_tagger_tpu_torch.core.config import default_flux_vae_config
from vae_tagger_tpu_torch.core.precision import BF16, FP32
from vae_tagger_tpu_torch.infer.engine import TaggerEngine, build_decoder
from vae_tagger_tpu_torch.io.checkpoints import torch_state_from_jax_params
from vae_tagger_tpu_torch.losses.combined import LossConfig
from vae_tagger_tpu_torch.models.autoencoder_kl import AutoencoderKL
from vae_tagger_tpu_torch.nn.blocks import seeded_init_
from vae_tagger_tpu_torch.train.state import TrainState
from vae_tagger_tpu_torch.train.steps import DecoderSteps

LATENT, TAGS, RES, B = 16, 12, 64, 3
EVAL_ATOL, LOSS_RTOL, GRAD_TOL = 2e-3, 5e-3, 1e-1

HEADS = {
    "attention": dict(attention_heads=2, attention_dropout=0.0),
    "cross": dict(attention_heads=2, attention_dropout=0.0,
                  use_cross_attention=True),
    "plain": None,
}


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(a, np.float32)
        + (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32)
        for a in leaves])


def _jax_head(kind, dtype):
    cfg = HEADS[kind]
    if cfg is None:
        return JaxPlain(num_classes=TAGS, dtype=dtype)
    return JaxAttnHead(latent_channels=LATENT, num_classes=TAGS,
                       attention=JaxAttnCfg(**cfg), dtype=dtype)


@functools.lru_cache(maxsize=None)
def _jax_weights(kind):
    head = _jax_head(kind, jnp.float32)
    variables = jax.jit(head.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(2)}, jnp.zeros((1, 8, 8, LATENT)),
        deterministic=True)
    stats = None
    if HEADS[kind] is not None:
        rng = np.random.default_rng(3)
        c2 = LATENT // 2
        stats = {"feature_compress_1": {
            "mean": (rng.normal(size=(c2,)) * 0.1).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, size=(c2,)).astype(np.float32)}}
    return _perturb(variables["params"], 4), stats


def _port_head(kind):
    params, stats = _jax_weights(kind)
    cfg = HEADS[kind]
    head = build_decoder(TAGS, cfg is not None, cfg, LATENT, seed=0)
    head.load_state_dict(torch_state_from_jax_params(params, stats),
                         strict=False)
    return head


def _jax_logits(kind, dtype, latents):
    params, stats = _jax_weights(kind)
    variables = {"params": params}
    if stats is not None:
        variables["batch_stats"] = stats
    return np.asarray(_jax_head(kind, dtype).apply(
        variables, jnp.asarray(latents, dtype), deterministic=True),
        np.float32)


def _engine(kind, policy):
    cfg = default_flux_vae_config(block_out_channels=(8, 16, 16, 16),
                                  norm_num_groups=4, latent_channels=LATENT,
                                  sample_size=RES)
    vae = seeded_init_(AutoencoderKL(cfg), 1)
    tags = [f"tag_{i}" for i in range(TAGS)]
    return TaggerEngine(vae, _port_head(kind), tags, policy, device="cpu")


def _pixels():
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, size=(B, RES, RES, 3), dtype=np.uint8)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def test_build_decoder_takes_the_compute_dtype():
    for cfg in HEADS.values():
        head = build_decoder(TAGS, cfg is not None, cfg, LATENT, seed=0,
                             dtype=torch.bfloat16)
        assert head.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in head.parameters())


@pytest.mark.parametrize("kind", list(HEADS))
def test_engine_bf16_head_matches_the_jax_bf16_head(kind):
    engine = _engine(kind, BF16)
    px = _pixels()
    latents = engine.encode(px)
    got = engine.classify(px)
    want = _sigmoid(_jax_logits(kind, jnp.bfloat16, latents))
    err = float(np.abs(got - want).max())
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert err <= EVAL_ATOL, err
    assert engine.decoder.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32
               for p in engine.decoder.parameters())


@pytest.mark.parametrize("kind", list(HEADS))
def test_engine_fp32_head_is_unchanged(kind):
    engine = _engine(kind, FP32)
    px = _pixels()
    got = engine.classify(px)
    want = _sigmoid(_jax_logits(kind, jnp.float32, engine.encode(px)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


class _SGD:
    """A plain SGD step of rate 1 (DecoderSteps' optimizer interface)."""

    def __init__(self, params):
        self.params = list(params)

    def step(self):
        with torch.no_grad():
            for p in self.params:
                p -= p.grad
                p.grad = None


@pytest.mark.parametrize("kind", list(HEADS))
def test_one_bf16_train_step_matches_the_jax_gradient(kind, monkeypatch):
    import flax.linen as fnn

    from vae_tagger_tpu.losses.combined import classification_term
    from vae_tagger_tpu_torch.models import taggers

    class TwoPassBatchNorm(fnn.BatchNorm):
        use_fast_variance: bool = False

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(fnn, "BatchNorm", TwoPassBatchNorm)
    monkeypatch.setattr(taggers, "dropout",
                        lambda x, p, training, generator=None: x)
    rng = np.random.default_rng(8)
    latents = torch.randn(B, 8, 8, LATENT,
                          generator=torch.Generator().manual_seed(9)
                          ).to(torch.bfloat16)
    labels = (rng.uniform(size=(B, TAGS)) < 0.4).astype(np.float32)

    params, stats = _jax_weights(kind)
    jhead = _jax_head(kind, jnp.bfloat16)
    jlat = jnp.asarray(latents.float().numpy(), jnp.bfloat16)

    def loss_fn(p):
        if stats is None:
            logits = jhead.apply({"params": p}, jlat, deterministic=False)
        else:
            logits, _ = jhead.apply({"params": p, "batch_stats": stats},
                                    jlat, deterministic=False,
                                    mutable=["batch_stats"])
        return classification_term(JaxLossConfig(), logits,
                                   jnp.asarray(labels), None)

    want_loss, grads = jax.value_and_grad(loss_fn)(params)
    want = torch_state_from_jax_params(jax.device_get(grads))

    head = _port_head(kind)
    head.dtype = torch.bfloat16
    before = {n: p.detach().clone() for n, p in head.named_parameters()}
    state = TrainState(vae=None, decoder=head,
                       optimizer=_SGD(head.parameters()))
    steps = DecoderSteps(None, LossConfig(), compute_dtype=torch.bfloat16)
    loss = steps.train_step_from_latents(state, latents,
                                         torch.from_numpy(labels),
                                         0)["loss"].item()
    assert abs(loss - float(want_loss)) <= LOSS_RTOL * abs(loss)
    scale = max(float(v.abs().max()) for v in want.values())
    for name, p in head.named_parameters():
        assert p.dtype == torch.float32, name
        got = before[name] - p.detach()
        err = float((got - want[name]).abs().max()) / scale
        assert err <= GRAD_TOL, (name, err)
