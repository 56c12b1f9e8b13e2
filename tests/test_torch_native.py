"""The port's native decode and resize (``vae_tagger_tpu_torch/native``)
against the JAX package's (``vae_tagger_tpu/native``) on the same bytes,
on the CPU: every output byte-equal.

Both libraries build here with JPEG, PNG and WebP.  Covered: the fused
decode + resize of JPEG (the DCT-scaled decode and, with
``VAE_TAGGER_DECODE_EXACT=1``, the full one), PNG (RGB, alpha, palette,
gray; 16-bit goes to PIL in both) and WebP (lossless and lossy); the
bilinear distort (the square transform) and the Lanczos bucket crops
(center, and random from the same ``random`` state); the ``_yuv420``
forms; ``decode_bytes_square``, ``decode_bytes_square_yuv`` and
``load_and_transform_image`` of both packages, among them a 4096x3072
JPEG to 512, where the port's former PIL-only decode gave other pixels;
and the switches that turn the native paths off.
"""

import io
import random

import numpy as np
import pytest
from PIL import Image

import vae_tagger_tpu.native as jax_native
import vae_tagger_tpu_torch.native as torch_native
from vae_tagger_tpu.data import bucketing as jax_bucketing
from vae_tagger_tpu_torch.data import bucketing


def _photo(h, w, seed=0):
    """Smooth content with mild noise, like a photograph."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(xx / 37.0) * np.cos(yy / 53.0),
                     128 + 90 * np.cos(xx / 71.0 + 1.0),
                     128 + 80 * np.sin((xx + yy) / 45.0)], axis=-1)
    noise = rng.normal(0, 6, size=(h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _encode(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def images():
    """name -> encoded bytes."""
    px = _photo(480, 640)
    rgb = Image.fromarray(px)
    alpha = Image.fromarray(np.concatenate(
        [px, _photo(480, 640, 1)[..., :1]], axis=-1), "RGBA")
    gray16 = Image.fromarray(px[..., 0].astype(np.uint16) * 257)
    return {
        "jpeg": _encode(rgb, "JPEG", quality=90),
        "png": _encode(rgb, "PNG"),
        "png_alpha": _encode(alpha, "PNG"),
        "png_palette": _encode(rgb.convert("P", palette=Image.ADAPTIVE),
                               "PNG"),
        "png_gray": _encode(rgb.convert("L"), "PNG"),
        "png_16bit": _encode(gray16, "PNG"),
        "webp_lossless": _encode(rgb, "WEBP", lossless=True),
        "webp_lossy": _encode(rgb, "WEBP", quality=80),
    }


def test_both_libraries_build_every_format():
    assert torch_native.available() and jax_native.available()
    assert torch_native.decode_formats() == jax_native.decode_formats() \
        == {"jpeg", "png", "webp"}
    assert torch_native.library_path().parent.name == "native"
    assert torch_native.library_path().parent.parent.name == "build"


@pytest.mark.parametrize("name", ["jpeg", "png", "png_alpha", "png_palette",
                                  "png_gray", "png_16bit", "webp_lossless",
                                  "webp_lossy"])
@pytest.mark.parametrize("exact", [False, True])
def test_decode_resize_forms_equal_jax(images, name, exact, monkeypatch):
    """The fused decode in every crop and filter, its header read, and
    both packages' square transform, RGB and YUV 4:2:0."""
    if exact:
        monkeypatch.setenv("VAE_TAGGER_DECODE_EXACT", "1")
    data = images[name]
    qf = bucketing._jpeg_quality_factor()
    assert qf == jax_bucketing._jpeg_quality_factor() == (0 if exact else 2)
    assert torch_native.sniff_format(data) == jax_native.sniff_format(data)
    assert torch_native.image_info(data) == jax_native.image_info(data)
    for w, h, mode, offset, resample in [
            (256, 256, "distort", (0, 0), "bilinear"),
            (192, 128, "center", (0, 0), "lanczos"),
            (96, 160, "random", (0, 37), "lanczos"),
            (128, 96, "top", (0, 0), "lanczos")]:
        args = (data, w, h, mode, offset, qf, False, resample)
        got = torch_native.decode_image_resize(*args)
        want = jax_native.decode_image_resize(*args)
        assert (got is None) == (want is None), (mode, name)
        if got is not None:
            assert np.array_equal(got, want), (mode, name)
        got = torch_native.decode_image_resize_yuv420(
            data, w, h, mode, offset, qf, resample)
        want = jax_native.decode_image_resize_yuv420(
            data, w, h, mode, offset, qf, resample)
        assert (got is None) == (want is None), (mode, name)
        if got is not None:
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(bucketing.decode_bytes_square(data, 64),
                          jax_bucketing.decode_bytes_square(data, 64))
    got_y, got_c = bucketing.decode_bytes_square_yuv(data, 64)
    want_y, want_c = jax_bucketing.decode_bytes_square_yuv(data, 64)
    assert np.array_equal(got_y, want_y) and np.array_equal(got_c, want_c)


def test_16bit_png_goes_to_pil_in_both(images):
    data = images["png_16bit"]
    assert torch_native.decode_png_resize(data, 64, 64) is None
    assert jax_native.decode_png_resize(data, 64, 64) is None


def test_smart_resize_and_conversion_equal_jax():
    src = _photo(300, 400, 2)
    for w, h, mode, offset, resample in [
            (128, 64, "center", (0, 0), "lanczos"),
            (64, 128, "random", (150, 0), "lanczos"),
            (100, 100, "distort", (0, 0), "bilinear"),
            (512, 384, "center", (0, 0), "lanczos")]:
        assert np.array_equal(
            torch_native.smart_resize(src, w, h, mode, offset, resample),
            jax_native.smart_resize(src, w, h, mode, offset, resample))
    got = torch_native.rgb_to_yuv420(src)
    want = jax_native.rgb_to_yuv420(src)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", ["jpeg", "png_alpha", "webp_lossless",
                                  "png_16bit"])
@pytest.mark.parametrize("crop_mode", ["center", "random"])
def test_load_and_transform_image_equals_jax(images, tmp_path, name,
                                             crop_mode):
    """Files through both loaders: the square transform, and the bucket
    crop with the random offsets drawn from the same ``random`` state."""
    path = tmp_path / f"img.{name.split('_')[0]}"
    path.write_bytes(images[name])
    assert np.array_equal(
        bucketing.load_and_transform_image(str(path), resolution=96),
        jax_bucketing.load_and_transform_image(str(path), resolution=96))
    for bucket in [(192, 128), (96, 160), (160, 160)]:
        random.seed(11)
        got = bucketing.load_and_transform_image(str(path), bucket=bucket,
                                                 crop_mode=crop_mode)
        random.seed(11)
        want = jax_bucketing.load_and_transform_image(
            str(path), bucket=bucket, crop_mode=crop_mode)
        assert np.array_equal(got, want), bucket


@pytest.mark.parametrize("src_hw,res", [((1536, 2048), 1024),
                                        ((3072, 4096), 512)])
@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
def test_large_photos_decode_as_the_jax_package_does(src_hw, res, fmt,
                                                     monkeypatch):
    """A 2048x1536 and a 4096x3072 photo (JPEG at q90, PNG) to the square
    transform: byte-equal to the JAX package's; the PIL-only decode that
    the port had before gives other pixels for the 4096x3072 JPEG."""
    data = _encode(Image.fromarray(_photo(*src_hw, 3)), fmt, quality=90)
    got = bucketing.decode_bytes_square(data, res)
    assert np.array_equal(got, jax_bucketing.decode_bytes_square(data, res))
    if fmt == "JPEG" and res == 512:
        monkeypatch.setattr(torch_native, "_load", lambda: None)
        pil = bucketing.decode_bytes_square(data, res)
        assert not np.array_equal(pil, got)


@pytest.mark.parametrize("switch", ["VAE_TAGGER_NATIVE_RESIZE",
                                    "VAE_TAGGER_NATIVE_DECODE"])
def test_switches_turn_the_native_paths_off(images, switch, monkeypatch):
    """``VAE_TAGGER_NATIVE_RESIZE=0`` loads no library (PIL everywhere);
    ``VAE_TAGGER_NATIVE_DECODE=0`` keeps the native resize and decodes
    with PIL: the square transform is then PIL's, as in the JAX package."""
    monkeypatch.setenv(switch, "0")
    if switch == "VAE_TAGGER_NATIVE_RESIZE":
        monkeypatch.setattr(torch_native, "_tried", False)
        monkeypatch.setattr(torch_native, "_lib", None)
        assert not torch_native.available()
    assert torch_native.decode_formats() == frozenset()
    data = images["jpeg"]
    img = Image.open(io.BytesIO(data)).convert("RGB")
    pil = np.asarray(img.resize((64, 64), Image.BILINEAR))
    assert np.array_equal(bucketing.decode_bytes_square(data, 64), pil)
