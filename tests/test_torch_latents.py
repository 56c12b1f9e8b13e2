"""The port's latent extraction (``vae_tagger_tpu_torch/infer/latents.py``)
against the JAX package's on the same checkpoint and images, on the CPU:
``flatten_latent_torch_order``, and the json and npz files of
``infer_and_save_latents`` (same keys; values within 1e-5, the fp32
encoders' difference at latent scale); the CLI ``python -m
vae_tagger_tpu_torch.infer.latents`` with ``--tiled`` and
``--transfer_format yuv420``; and that ``VAEOnlyEngine`` holds no VAE
decoder."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_tagger_tpu.core.config import default_flux_vae_config as jax_vae_cfg
from vae_tagger_tpu.infer import latents as jax_latents
from vae_tagger_tpu.io.safetensors_io import (
    save_vae_pretrained as jax_save_vae,
)
from vae_tagger_tpu.models.autoencoder_kl import AutoencoderKL as JaxVAE
from vae_tagger_tpu_torch.infer import latents
from vae_tagger_tpu_torch.infer.engine import VAEOnlyEngine

TINY = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
            latent_channels=4)


@pytest.fixture(autouse=True)
def _fp32_exact():
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("shape", [(4, 4, 16), (2, 3, 4), (1, 1, 5)])
def test_flatten_latent_torch_order_matches_jax(shape):
    z = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = latents.flatten_latent_torch_order(z)
    np.testing.assert_array_equal(got,
                                  jax_latents.flatten_latent_torch_order(z))
    # channel-major: the NCHW flatten of the same tensor
    np.testing.assert_array_equal(
        got, torch.from_numpy(z).permute(2, 0, 1).reshape(-1).numpy())


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A tiny VAE exported by the JAX package (decoder included) and 5
    PNGs at 32px, the resolution of the runs: the packages' image loaders
    resize with different filters, which is not what is compared here."""
    from PIL import Image

    root = tmp_path_factory.mktemp("latents")
    cfg = jax_vae_cfg(**TINY)
    params = jax.jit(JaxVAE(cfg).init)({"params": jax.random.key(0)},
                                       jnp.zeros((1, 32, 32, 3)),
                                       jax.random.key(1))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=np.shape(a)).astype(
            np.float32) * 0.05, jax.device_get(params))
    jax_save_vae(params, cfg, str(root / "vae"))
    (root / "images").mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
                        ).save(root / "images" / f"{i}.png")
    return dict(root=root,
                ckpt=str(root / "vae" / "diffusion_pytorch_model.safetensors"),
                config=str(root / "vae" / "config.json"))


@pytest.mark.parametrize("fmt", ["json", "npz"])
def test_outputs_match_the_jax_package(workdir, fmt):
    root = workdir["root"]
    port_out, jax_out = root / f"port_{fmt}", root / f"jax_{fmt}"
    eng = VAEOnlyEngine.load(workdir["ckpt"], workdir["config"],
                             device="cpu")
    got = latents.infer_and_save_latents(
        eng, str(root / "images"), output_dir=str(port_out), resolution=32,
        batch_size=2, num_workers=2, output_format=fmt)
    jeng = jax_latents.VAEOnlyEngine(vae_checkpoint=workdir["ckpt"],
                                     vae_config_path=workdir["config"])
    want = jax_latents.infer_and_save_latents(
        jeng, str(root / "images"), output_dir=str(jax_out), resolution=32,
        batch_size=2, num_workers=2, output_format=fmt)
    assert list(got) == list(want) and len(got) == 5
    name = f"latent_vectors.{fmt}"
    if fmt == "json":
        got_f = json.loads((port_out / name).read_text())
        want_f = json.loads((jax_out / name).read_text())
    else:
        got_f = dict(np.load(port_out / name))
        want_f = dict(np.load(jax_out / name))
    assert list(got_f) == list(want_f)
    for k in want_f:
        a, b = np.asarray(got_f[k]), np.asarray(want_f[k])
        assert a.shape == b.shape == (4 * 4 * 4,)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=k)


def test_cli_latents_equal_the_engine_and_refusals(workdir, tmp_path):
    from vae_tagger_tpu_torch.data.bucketing import load_and_transform_image
    from vae_tagger_tpu_torch.data.paths import get_image_paths

    root = workdir["root"]
    argv = ["--device", "cpu", "--vae_checkpoint", workdir["ckpt"],
            "--vae_config_path", workdir["config"], "--image_path",
            str(root / "images"), "--resolution", "32", "--batch_size", "4",
            "--num_workers", "2"]
    out = latents.main([*argv, "--output_dir", str(tmp_path / "out"),
                        "--output_format", "npz"])
    eng = VAEOnlyEngine.load(workdir["ckpt"], workdir["config"],
                             device="cpu")
    paths = [str(p) for p in get_image_paths(str(root / "images"))]
    z = eng.encode(np.stack([load_and_transform_image(p, 32)
                             for p in paths]))
    for p, zi in zip(paths, z):
        np.testing.assert_array_equal(
            out[p], latents.flatten_latent_torch_order(zi))
    assert eng.vae.decoder is None
    # --tiled and yuv420 run on the CPU: the tiled encode at the images'
    # native 32x32 (tile 24, overlap 8: four tiles -> 4x4 latents), the
    # YUV wire format through the engine's encode_yuv
    from vae_tagger_tpu_torch.data.bucketing import (
        load_and_transform_image_yuv,
    )

    tiled = latents.main([*argv, "--output_dir", str(tmp_path / "tiled"),
                          "--tiled", "--tile_size", "24", "--tile_overlap",
                          "8", "--output_format", "npz"])
    assert sorted(tiled) == sorted(paths)
    assert all(np.asarray(v).shape == (4 * 4 * 4,) and np.isfinite(v).all()
               for v in tiled.values())
    yuv = latents.main([*argv, "--output_dir", str(tmp_path / "yuv"),
                        "--transfer_format", "yuv420", "--output_format",
                        "npz"])
    planes = [load_and_transform_image_yuv(p, 32) for p in paths]
    zy = eng.encode_yuv(np.stack([y for y, _ in planes]),
                        np.stack([c for _, c in planes]))
    for p, zi in zip(paths, zy):
        np.testing.assert_array_equal(
            yuv[p], latents.flatten_latent_torch_order(zi))
    if not torch.cuda.is_available():
        cpu_free = [a for a in argv if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="--device cpu"):
            latents.main([*cpu_free, "--output_dir", str(tmp_path)])
