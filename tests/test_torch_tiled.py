"""The port's tiled VAE and the reconstruction round trip against the JAX
package, on the CPU in fp32.

- ``tile_starts``, ``_axis_weights`` and ``tiled_apply`` against the JAX
  package's on the same ``apply_chunk``: exact for the shift-invariant
  stand-ins (an 8x8 average pool for the encoder, a nearest 8x upsample
  for the decoder), and the same ``ValueError``s;
- ``TiledVAE.encode``/``decode`` against the JAX package's ``TiledVAE`` on
  the same weights (carried over with ``torch_state_from_jax_params``) and
  images: one tile (64x64), several tiles (96x128, overlap 32), padded and
  smaller than a tile (70x50).  Gate: MSE < 1e-10, the encoder's gate;
- ``python -m vae_tagger_tpu_torch.infer.reconstruct`` (the posterior-mode
  path) against the JAX package's encode -> mode -> decode: the MSE to
  1e-10 relative and the PSNR to 1e-6 dB; its files; the sampled direct
  path; and the latents CLI's ``--tiled`` against ``TiledVAE.encode``.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vae_tagger_tpu.core.config import default_flux_vae_config as jax_vae_cfg
from vae_tagger_tpu.infer.tiled import TiledVAE as JaxTiledVAE
from vae_tagger_tpu.infer.tiled import _axis_weights as jax_axis_weights
from vae_tagger_tpu.infer.tiled import tile_starts as jax_tile_starts
from vae_tagger_tpu.infer.tiled import tiled_apply as jax_tiled_apply
from vae_tagger_tpu.models.autoencoder_kl import AutoencoderKL as JaxVAE
from vae_tagger_tpu.ops.image import normalize_uint8 as jax_normalize
from vae_tagger_tpu_torch.core.config import default_flux_vae_config
from vae_tagger_tpu_torch.infer.tiled import (
    TiledVAE,
    _axis_weights,
    tile_starts,
    tiled_apply,
)
from vae_tagger_tpu_torch.io.checkpoints import (
    save_vae_pretrained,
    torch_state_from_jax_params,
)
from vae_tagger_tpu_torch.models.autoencoder_kl import AutoencoderKL
from vae_tagger_tpu_torch.ops import backend

TINY = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
            latent_channels=4)


@pytest.fixture(autouse=True)
def _cpu_fp32():
    torch.backends.cudnn.allow_tf32 = False
    backend.reset_launch_counts()
    yield
    assert sum(backend.launch_counts().values()) == 0


def _pool8(t):
    b, h, w, c = t.shape
    return np.asarray(t, np.float32).reshape(
        b, h // 8, 8, w // 8, 8, c).mean((2, 4))


def _up8(t):
    return np.repeat(np.repeat(np.asarray(t, np.float32), 8, 1), 8, 2)


def _smooth(h, w, seed=0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, size=3)
    img = np.stack([128 + 90 * np.sin(xx / 7.0 + ph[0]) * np.cos(yy / 5.0),
                    128 + 70 * np.cos(xx / 9.0 + ph[1]),
                    128 + 60 * np.sin((xx + yy) / 6.0 + ph[2])], axis=-1)
    img += rng.normal(0, 8, size=img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _mse(a, b):
    return float(np.mean((np.asarray(a, np.float64)
                          - np.asarray(b, np.float64)) ** 2))


@pytest.mark.parametrize("size,tile,stride", [
    (80, 48, 32), (120, 48, 32), (48, 48, 32), (40, 48, 32),
    (1000, 128, 96), (2048, 1024, 768), (1536, 1024, 768), (7, 4, 1)])
def test_tile_starts_and_axis_weights_match_jax(size, tile, stride):
    starts = tile_starts(size, tile, stride)
    assert starts == jax_tile_starts(size, tile, stride)
    ramp = tile - stride
    for s in starts:
        np.testing.assert_array_equal(
            _axis_weights(s, tile, size, ramp),
            jax_axis_weights(s, tile, size, ramp))


@pytest.mark.parametrize("batch_tiles", [1, 4, 8])
def test_tiled_apply_equals_jax_and_direct_for_shift_invariant_ops(
        batch_tiles):
    """The same apply_chunk through both packages' tiled_apply gives the
    same array, and equals the direct op (its receptive field fits in the
    overlap), the clamped last column of tiles included."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (80, 120, 3)).astype(np.float32)
    got = tiled_apply(x, 48, 16, 1 / 8, 3, _pool8, batch_tiles)
    want = jax_tiled_apply(x, 48, 16, 1 / 8, 3, _pool8, batch_tiles)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, _pool8(x[None])[0], rtol=0, atol=1e-3)
    z = _pool8(x[None])[0]
    got = tiled_apply(z, 6, 2, 8, 3, _up8, batch_tiles)
    want = jax_tiled_apply(z, 6, 2, 8, 3, _up8, batch_tiles)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, _up8(z[None])[0], rtol=0, atol=1e-3)


@pytest.mark.parametrize("kwargs", [
    dict(tile=16, overlap=16, out_scale=1, apply_chunk=lambda t: t),
    dict(tile=16, overlap=-1, out_scale=1, apply_chunk=lambda t: t),
    dict(tile=64, overlap=8, out_scale=1, apply_chunk=lambda t: t),
    dict(tile=16, overlap=8, out_scale=1, apply_chunk=lambda t: t[:, :8]),
])
def test_tiled_apply_refuses_what_jax_refuses(kwargs):
    x = np.zeros((32, 32, 3), np.float32)
    with pytest.raises(ValueError) as want:
        jax_tiled_apply(x, out_channels=3, **kwargs)
    with pytest.raises(ValueError) as got:
        tiled_apply(x, out_channels=3, **kwargs)
    assert str(got.value) == str(want.value)


@functools.lru_cache(maxsize=None)
def _vae_pair():
    """The JAX VAE (encoder and decoder) with perturbed weights, and the
    port's on the same weights."""
    cfg = jax_vae_cfg(sample_size=64, **TINY)
    model = JaxVAE(cfg)
    params = jax.jit(model.init)({"params": jax.random.key(0)},
                                 jnp.zeros((1, 64, 64, 3)),
                                 jax.random.key(1))["params"]
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32),
        jax.device_get(params))
    port = AutoencoderKL(default_flux_vae_config(**TINY), with_decoder=True)
    port.load_state_dict(torch_state_from_jax_params(params), strict=True)
    return model, params, port.eval()


@pytest.mark.parametrize("shape,tile,overlap", [
    ((64, 64), 64, 16),    # one tile
    ((96, 128), 64, 32),   # several tiles, the last clamped
    ((70, 50), 64, 16),    # padded, smaller than a tile
])
def test_tiled_encode_and_decode_match_jax(shape, tile, overlap):
    model, params, port = _vae_pair()
    img = _smooth(*shape, seed=sum(shape))
    jt = JaxTiledVAE(model, params, tile=tile, overlap=overlap)
    pt = TiledVAE(port, tile=tile, overlap=overlap)
    z_want, z = jt.encode(img), pt.encode(img)
    h, w = -(-shape[0] // 8), -(-shape[1] // 8)
    assert z.shape == z_want.shape == (h, w, 4) and z.dtype == np.float32
    assert _mse(z, z_want) < 1e-10
    px_want, px = jt.decode(z_want), pt.decode(z_want)
    assert px.shape == px_want.shape == (8 * h, 8 * w, 3)
    assert _mse(px, px_want) < 1e-10


def test_tiled_vae_refuses_tiles_off_the_latent_grid():
    _, params, port = _vae_pair()
    with pytest.raises(ValueError, match="multiples of the downsample"):
        TiledVAE(port, tile=60, overlap=16)
    with pytest.raises(ValueError, match="multiples of the downsample"):
        TiledVAE(port, tile=64, overlap=12)


@pytest.fixture(scope="module")
def vae_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("reconstruct")
    _, _, port = _vae_pair()
    save_vae_pretrained(port, port.config, str(root / "vae"))
    Image.fromarray(_smooth(64, 64, seed=5)).save(root / "img.png")
    return root


def _cli(vae_dir, out, *flags):
    from vae_tagger_tpu_torch.infer.reconstruct import main

    return main(["--vae_checkpoint",
                 str(vae_dir / "vae" / "diffusion_pytorch_model.safetensors"),
                 "--vae_config_path", str(vae_dir / "vae" / "config.json"),
                 "--output_dir", str(out), "--device", "cpu", *flags])


def test_reconstruction_cli_mode_path_matches_jax(vae_dir, capsys):
    """--tiled with one tile is the posterior-mode round trip: its MSE and
    PSNR equal those of the JAX package's encode -> mode -> decode."""
    model, params, _ = _vae_pair()
    img = np.asarray(Image.open(vae_dir / "img.png").convert("RGB"))
    out = vae_dir / "tiled_out"
    got = _cli(vae_dir, out, "--image_path", str(vae_dir / "img.png"),
               "--tiled", "--tile_size", "64", "--tile_overlap", "16")

    def roundtrip(p, px):
        x = jax_normalize(px[None])
        post = model.apply({"params": p}, x, method=JaxVAE.encode)
        rec = model.apply({"params": p}, post.mode(), method=JaxVAE.decode)
        return x, post.mode(), rec

    x, latent, rec = map(np.asarray, jax.jit(roundtrip)(params,
                                                        jnp.asarray(img)))
    mse = float(np.mean((x - rec) ** 2))
    psnr = 20 * np.log10(2.0) - 10 * np.log10(mse)
    assert got["mse"] == pytest.approx(mse, rel=1e-10, abs=0)
    assert got["psnr"] == pytest.approx(psnr, abs=1e-6)
    assert got["compression"] == pytest.approx(x.size / latent.size)
    assert got["latent_shape"] == (1, 8, 8, 4)
    saved = np.load(out / "latent_vector.npy")
    assert _mse(saved, latent) < 1e-10
    pt = torch.load(out / "latent_vector.pt", weights_only=True)
    assert tuple(pt.shape) == (1, 4, 8, 8)
    np.testing.assert_array_equal(pt.numpy(), saved.transpose(0, 3, 1, 2))
    for f in ("original.png", "reconstructed.png"):
        assert (out / f).exists()
    text = capsys.readouterr().out
    assert "PSNR:" in text and "(native, tiled)" in text
    assert ("comparison saved to" in text
            or "matplotlib comparison skipped" in text)


def test_reconstruction_cli_direct_path_samples_from_the_seed(vae_dir):
    """The direct path resizes the procedural image to --resolution and
    decodes a posterior sample: the same seed gives the same numbers, and
    another seed another sample."""
    a = _cli(vae_dir, vae_dir / "d0", "--resolution", "32", "--seed", "3")
    b = _cli(vae_dir, vae_dir / "d1", "--resolution", "32", "--seed", "3")
    c = _cli(vae_dir, vae_dir / "d2", "--resolution", "32", "--seed", "4")
    assert a["latent_shape"] == (1, 4, 4, 4) and np.isfinite(a["psnr"])
    assert a == b and a["mse"] != c["mse"]
    assert a["compression"] == pytest.approx(32 * 32 * 3 / (4 * 4 * 4))


def test_reconstruction_cli_needs_a_gpu_unless_told_cpu(tmp_path):
    from vae_tagger_tpu_torch.infer.reconstruct import main

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--output_dir", str(tmp_path)])


@pytest.mark.parametrize("fmt", ["json", "npz"])
def test_latents_cli_tiled_equals_tiled_encode(vae_dir, tmp_path, fmt):
    """``python -m vae_tagger_tpu_torch.infer.latents --tiled`` writes each
    image's native-size latents, flattened channel-major, as
    TiledVAE.encode gives them."""
    from vae_tagger_tpu_torch.infer.latents import (
        flatten_latent_torch_order,
    )
    from vae_tagger_tpu_torch.infer.latents import main as latents_main

    images = tmp_path / "images"
    images.mkdir()
    for i, shape in enumerate(((64, 64), (96, 128), (70, 50))):
        Image.fromarray(_smooth(*shape, seed=i)).save(images / f"{i}.png")
    out = tmp_path / "out"
    got = latents_main([
        "--vae_checkpoint",
        str(vae_dir / "vae" / "diffusion_pytorch_model.safetensors"),
        "--vae_config_path", str(vae_dir / "vae" / "config.json"),
        "--image_path", str(images), "--output_dir", str(out), "--tiled",
        "--tile_size", "64", "--tile_overlap", "16", "--output_format", fmt,
        "--device", "cpu"])
    _, _, port = _vae_pair()
    tiler = TiledVAE(port, tile=64, overlap=16)
    assert len(got) == 3
    on_disk = (dict(np.load(out / "latent_vectors.npz")) if fmt == "npz"
               else json.loads((out / "latent_vectors.json").read_text()))
    for path, flat in on_disk.items():
        img = np.asarray(Image.open(path).convert("RGB"))
        want = flatten_latent_torch_order(tiler.encode(img))
        assert np.asarray(flat).shape == want.shape
        assert _mse(flat, want) < 1e-10
