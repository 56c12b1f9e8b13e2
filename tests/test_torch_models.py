"""The port's encoder and tagger heads against the JAX package's, on the
same weights (carried over with torch_state_from_jax_params) and the same
numpy inputs, in fp32 on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_tagger_tpu.core.config import AttentionDecoderConfig as JaxAttnCfg
from vae_tagger_tpu.core.config import default_flux_vae_config as jax_vae_cfg
from vae_tagger_tpu.models.autoencoder_kl import AutoencoderKL as JaxVAE
from vae_tagger_tpu.models.taggers import (
    AttentionClassificationDecoder as JaxAttnHead,
)
from vae_tagger_tpu.models.taggers import ClassificationDecoder as JaxMLPHead
from vae_tagger_tpu.ops import normalization as jax_norm
from vae_tagger_tpu.ops import pooling as jax_pool
from vae_tagger_tpu_torch.core.config import (
    AttentionDecoderConfig,
    default_flux_vae_config,
)
from vae_tagger_tpu_torch.io.checkpoints import torch_state_from_jax_params
from vae_tagger_tpu_torch.models.autoencoder_kl import (
    AutoencoderKL,
    encode_scaled,
)
from vae_tagger_tpu_torch.models.taggers import (
    AttentionClassificationDecoder,
    ClassificationDecoder,
    create_attention_decoder,
)
from vae_tagger_tpu_torch.ops import normalization as norm
from vae_tagger_tpu_torch.ops import pooling as pool

TINY = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
            latent_channels=4)


@pytest.fixture(autouse=True)
def _fp32_exact():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _perturb(tree, seed):
    """Seeded noise on every leaf, so biases and norm affines are not the
    zeros/ones of a fresh init."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = [np.asarray(a, np.float32)
           + (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32)
           for a in leaves]
    return jax.tree_util.tree_unflatten(treedef, out)


@functools.lru_cache(maxsize=None)
def _vae_pair(use_quant_conv: bool):
    cfg = jax_vae_cfg(use_quant_conv=use_quant_conv, **TINY)
    model = JaxVAE(cfg)
    params = jax.jit(model.init)({"params": jax.random.key(0)},
                                 jnp.zeros((1, 32, 32, 3)),
                                 jax.random.key(1))["params"]
    params = _perturb(jax.device_get(params), 1)
    state = {k: v for k, v in torch_state_from_jax_params(params).items()
             if k.startswith(("encoder.", "quant_conv."))}
    port = AutoencoderKL(default_flux_vae_config(
        use_quant_conv=use_quant_conv, **TINY))
    port.load_state_dict(state, strict=True)
    return model, params, port.eval()


@pytest.mark.parametrize("use_quant_conv", [False, True])
def test_encoder_latents_match_jax(use_quant_conv):
    model, params, port = _vae_pair(use_quant_conv)
    x = np.random.default_rng(0).uniform(
        -1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    post = jax.jit(lambda p, x: model.apply({"params": p}, x,
                                            method=JaxVAE.encode))(
        params, jnp.asarray(x))
    with torch.inference_mode():
        tpost = port.encode(torch.from_numpy(x))
    mean = tpost.mean.numpy()
    mse = float(np.mean((mean - np.asarray(post.mean)) ** 2))
    assert mse < 1e-10, mse
    np.testing.assert_allclose(mean, np.asarray(post.mean), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tpost.logvar.numpy(), np.asarray(post.logvar),
                               rtol=1e-4, atol=1e-5)
    scaled = encode_scaled(tpost.mode(), port.config).numpy()
    np.testing.assert_allclose(scaled, np.asarray(post.mean) * 0.3611 + 0.1159,
                               rtol=1e-4, atol=1e-5)


def _head_inputs(latent_channels=16, hw=16):
    z = np.random.default_rng(5).normal(
        size=(2, hw, hw, latent_channels)).astype(np.float32)
    return z


def test_attention_head_logits_match_jax():
    """Default attention head, eval mode, BatchNorm reading running stats."""
    z = _head_inputs()
    jhead = JaxAttnHead(latent_channels=16, num_classes=10,
                        attention=JaxAttnCfg())
    variables = jax.jit(jhead.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 16, 16)),
        deterministic=True)
    params = _perturb(jax.device_get(variables["params"]), 2)
    rng = np.random.default_rng(3)
    stats = {"feature_compress_1": {
        "mean": rng.normal(size=(8,)).astype(np.float32) * 0.1,
        "var": rng.uniform(0.5, 1.5, size=(8,)).astype(np.float32)}}
    ref = jax.jit(lambda v, z: jhead.apply(v, z, deterministic=True))(
        {"params": params, "batch_stats": stats}, jnp.asarray(z))

    head = AttentionClassificationDecoder(16, 10, AttentionDecoderConfig())
    missing, unexpected = head.load_state_dict(
        torch_state_from_jax_params(params, stats), strict=False)
    assert unexpected == []
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    with torch.inference_mode():
        out = head.eval()(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_cross_attention_head_logits_match_jax():
    z = _head_inputs()
    cfg = dict(use_spatial_attention=True, use_self_attention=True,
               use_cross_attention=True, attention_heads=4)
    jhead = JaxAttnHead(latent_channels=16, num_classes=6,
                        attention=JaxAttnCfg(**cfg))
    variables = jax.jit(jhead.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 16, 16)),
        deterministic=True)
    params = _perturb(jax.device_get(variables["params"]), 4)
    stats = jax.device_get(variables["batch_stats"])
    ref = jhead.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(z), deterministic=True)
    head = create_attention_decoder(16, 6, cfg)
    head.load_state_dict(torch_state_from_jax_params(params, stats),
                         strict=False)
    with torch.inference_mode():
        out = head.eval()(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_classification_head_logits_match_jax():
    z = _head_inputs()
    jhead = JaxMLPHead(num_classes=7)
    params = jax.jit(jhead.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(0)}, jnp.zeros((1, 16, 16, 16)),
        deterministic=True)["params"]
    params = _perturb(jax.device_get(params), 6)
    ref = jhead.apply({"params": params}, jnp.asarray(z), deterministic=True)
    head = create_attention_decoder(16, 7, None)
    assert isinstance(head, ClassificationDecoder)
    head.load_state_dict(torch_state_from_jax_params(params), strict=True)
    with torch.inference_mode():
        out = head.eval()(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["group_norm", "layer_norm"])
def test_norms_match_jax(name):
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, 6, 5, 32)) * 2 + 0.5).astype(np.float32)
    sc = (rng.normal(size=(32,)) * 0.2 + 1).astype(np.float32)
    bi = (rng.normal(size=(32,)) * 0.1).astype(np.float32)
    kw = {"num_groups": 8} if name == "group_norm" else {}
    want = getattr(jax_norm, name)(jnp.asarray(x), jnp.asarray(sc),
                                   jnp.asarray(bi), **kw)
    got = getattr(norm, name)(torch.from_numpy(x), torch.from_numpy(sc),
                              torch.from_numpy(bi), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind,hw,out", [("avg", 16, (4, 4)),
                                         ("avg", 10, (4, 3)),
                                         ("avg", 8, 8),
                                         ("max", 12, 1),
                                         ("max", 12, (4, 6))])
def test_pooling_matches_jax(kind, hw, out):
    x = np.random.default_rng(9).normal(size=(2, hw, hw, 5)).astype(
        np.float32)
    fn = f"adaptive_{kind}_pool_nhwc"
    want = getattr(jax_pool, fn)(jnp.asarray(x), out)
    got = getattr(pool, fn)(torch.from_numpy(x), out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
