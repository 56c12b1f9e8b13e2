"""The tagger head's attention maps in the port against the JAX package's
``get_attention_maps``, on the CPU, in fp32: the keys, the NHWC shapes and
the values (within 1e-5) of the CBAM channel and spatial gates and the
MHSA and cross-attention softmax weights, for heads with every branch and
with branches off; ``TaggerEngine.get_attention_maps`` from pixels against
the JAX engine's; and ``python -m vae_tagger_tpu_torch.infer.attention_viz
--device cpu`` against the JAX package's ``dump_attention_maps``: the same
files, the same index, the npz maps within fp16 rounding.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vae_tagger_tpu.core.config import AttentionDecoderConfig as JaxAttnCfg
from vae_tagger_tpu.core.config import default_flux_vae_config
from vae_tagger_tpu.infer import TaggerEngine as JaxEngine
from vae_tagger_tpu.infer.attention_viz import (
    dump_attention_maps as jax_dump,
)
from vae_tagger_tpu.io import save_decoder_bin, save_vae_pretrained
from vae_tagger_tpu.models.autoencoder_kl import AutoencoderKL as JaxVAE
from vae_tagger_tpu.models.taggers import (
    AttentionClassificationDecoder as JaxHead,
)
from vae_tagger_tpu.models.taggers import (
    get_attention_maps as jax_get_attention_maps,
)
from vae_tagger_tpu_torch.core.config import AttentionDecoderConfig
from vae_tagger_tpu_torch.infer import TaggerEngine
from vae_tagger_tpu_torch.infer.attention_viz import main as viz_main
from vae_tagger_tpu_torch.io.checkpoints import torch_state_from_jax_params
from vae_tagger_tpu_torch.models.taggers import (
    AttentionClassificationDecoder,
    get_attention_maps,
)

RES, TAGS, LATENT = 64, 12, 16
CONFIGS = {
    "default": dict(attention_heads=2),
    "cross": dict(attention_heads=2, use_cross_attention=True),
    "no_spatial": dict(attention_heads=2, use_spatial_attention=False),
    "no_self": dict(attention_heads=2, use_self_attention=False,
                    use_cross_attention=True),
}
KEYS = {
    "default": {"channel_attention", "spatial_attention", "self_attention"},
    "cross": {"channel_attention", "spatial_attention", "self_attention",
              "cross_attention"},
    "no_spatial": {"self_attention"},
    "no_self": {"channel_attention", "spatial_attention", "cross_attention"},
}


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(a, np.float32)
        + (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32)
        for a in leaves])


def _stats(seed=3):
    rng = np.random.default_rng(seed)
    return {"feature_compress_1": {
        "mean": (rng.normal(size=(LATENT // 2,)) * 0.1).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, size=(LATENT // 2,)).astype(
            np.float32)}}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_head_maps_match_jax(name):
    cfg = CONFIGS[name]
    jhead = JaxHead(latent_channels=LATENT, num_classes=TAGS,
                    attention=JaxAttnCfg(**cfg))
    variables = jax.jit(jhead.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(2)}, jnp.zeros((1, 16, 16, LATENT)),
        deterministic=True)
    params, stats = _perturb(variables["params"], 4), _stats()
    latents = np.random.default_rng(5).normal(
        size=(2, 16, 16, LATENT)).astype(np.float32)
    want = jax_get_attention_maps(
        jhead, {"params": params, "batch_stats": stats},
        jnp.asarray(latents))
    head = AttentionClassificationDecoder(LATENT, TAGS,
                                          AttentionDecoderConfig(**cfg))
    head.load_state_dict(torch_state_from_jax_params(params, stats),
                         strict=False)
    head.eval()
    got = get_attention_maps(head, torch.from_numpy(latents))
    assert set(got) == set(want) == KEYS[name]
    shapes = {"channel_attention": (2, 1, 1, LATENT),
              "spatial_attention": (2, 16, 16, 1),
              "self_attention": (2, 2, 64, 64),
              "cross_attention": (2, 2, 1, 64)}
    for key, value in got.items():
        assert tuple(value.shape) == shapes[key] == want[key].shape, key
        np.testing.assert_allclose(value.numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)
        if key in ("self_attention", "cross_attention"):
            np.testing.assert_allclose(value.sum(-1).numpy(), 1.0,
                                       atol=1e-5)
    assert not head.training


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("attn_maps"))
    cfg = default_flux_vae_config(block_out_channels=(8, 16, 16, 16),
                                  norm_num_groups=4, latent_channels=LATENT,
                                  sample_size=RES)
    vae = JaxVAE(cfg)
    params = jax.jit(vae.init)({"params": jax.random.key(0)},
                               jnp.zeros((1, RES, RES, 3)),
                               jax.random.key(1))["params"]
    save_vae_pretrained(_perturb(params, 1), cfg, f"{root}/vae")
    head = JaxHead(latent_channels=LATENT, num_classes=TAGS)
    variables = jax.jit(head.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(2)}, jnp.zeros((1, 8, 8, LATENT)),
        deterministic=True)
    save_decoder_bin(_perturb(variables["params"], 4), _stats(),
                     f"{root}/decoder.bin")
    with open(f"{root}/tags.csv", "w") as f:
        f.write("name,count\n")
        f.writelines(f"tag_{i},{i}\n" for i in range(TAGS))
    os.makedirs(f"{root}/images/sub", exist_ok=True)
    rng = np.random.default_rng(6)
    for i, where in enumerate(["a.png", "b.png", "sub/a.png"]):
        Image.fromarray(rng.integers(0, 256, (RES, RES, 3), np.uint8)).save(
            f"{root}/images/{where}")
    return dict(vae_checkpoint=f"{root}/vae/"
                "diffusion_pytorch_model.safetensors",
                vae_config_path=f"{root}/vae/config.json",
                decoder_checkpoint=f"{root}/decoder.bin",
                tags_csv_path=f"{root}/tags.csv", root=root)


def _load_kw(art):
    return {k: v for k, v in art.items() if k != "root"}


def test_engine_maps_match_the_jax_engine(art):
    px = np.random.default_rng(7).integers(0, 256, (2, RES, RES, 3),
                                           np.uint8)
    want = JaxEngine.load(**_load_kw(art)).get_attention_maps(px)
    got = TaggerEngine.load(device="cpu", **_load_kw(art)
                            ).get_attention_maps(px)
    assert set(got) == set(want) == KEYS["default"]
    for key in got:
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5,
                                   err_msg=key)
    maps16 = TaggerEngine.load(device="cpu", mixed_precision="bf16",
                               **_load_kw(art)).get_attention_maps(px)
    assert all(np.isfinite(v).all() and v.dtype == np.float32
               for v in maps16.values())
    np.testing.assert_allclose(maps16["self_attention"].sum(-1), 1.0,
                               atol=2e-2)


def test_viz_cli_writes_the_jax_packages_files(art, tmp_path):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    index = viz_main([*[x for k, v in _load_kw(art).items()
                        for x in (f"--{k}", v)],
                      "--image_path", f"{art['root']}/images",
                      "--output_dir", str(ours), "--resolution", str(RES),
                      "--batch_size", "2", "--attention_heads", "8",
                      "--device", "cpu"])
    want = jax_dump(JaxEngine.load(**_load_kw(art)),
                    f"{art['root']}/images", str(theirs), resolution=RES,
                    batch_size=2)
    assert index == want
    assert json.loads((ours / "attention_maps_index.json").read_text()) \
        == want
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    assert any(n.endswith("__1_attention.npz") for n in os.listdir(ours))
    for name in os.listdir(ours):
        if name.endswith(".npz"):
            a, b = np.load(ours / name), np.load(theirs / name)
            for key in b.files:
                np.testing.assert_allclose(
                    a[key].astype(np.float32), b[key].astype(np.float32),
                    rtol=2e-3, atol=1e-4, err_msg=f"{name}:{key}")
        elif name.endswith(".png"):
            assert Image.open(ours / name).size == (RES, RES)
