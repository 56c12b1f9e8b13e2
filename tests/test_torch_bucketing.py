"""Aspect-ratio bucketing and the YUV 4:2:0 wire format of the port against
the JAX package, on the CPU.

Both packages' native C++ decoders are switched off in these tests (their
``native._load`` returns None, as under ``VAE_TAGGER_NATIVE_RESIZE=0``), so
both take their PIL branch; tests/test_torch_native.py holds the native
branches to each other.

- ``AspectRatioBucketing``: bucket lists equal over several grids, and
  assignments equal over a grid of sizes and hypothesis-drawn (w, h);
- ``ImageSizeManifest``: a round trip, and the JAX package's file read;
- ``load_and_transform_image`` bytes equal (buckets, center crop; square);
- ``BucketBatchSampler`` batches and masks equal for a seed and epoch
  (the JAX sampler with ``pad_multiple=None``);
- the dataset's items in both wire formats equal, the triplet members in
  the anchor's bucket, and odd dimensions refused;
- ``to_yuv420`` and ``rgb_to_yuv420_reference`` bytes equal;
  ``yuv420_to_rgb_uint8`` within 1 uint8 step of the JAX op and equal on
  >= 99.9% of values; ``F.interpolate(bilinear, align_corners=False)``
  against ``jax.image.resize(linear)`` at 2x;
- ``resolve_transfer_format`` on a triplet batch; ``encode_yuv`` and
  ``classify_yuv`` equal ``encode``/``classify`` of the converted RGB; the
  infer CLI's ``--transfer_format yuv420`` within the JAX package's chroma
  bound of its RGB run (0.05 in probability, tests/test_yuv.py); and the
  infer CLI's refusals.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

import vae_tagger_tpu.native as jax_native
import vae_tagger_tpu_torch.native as torch_native
from vae_tagger_tpu.data import bucketing as jax_bucketing
from vae_tagger_tpu.data.dataset import TaggedImageDataset as JaxDataset
from vae_tagger_tpu.data.loader import BucketBatchSampler as JaxSampler
from vae_tagger_tpu.ops import image as jax_image
from vae_tagger_tpu.train.steps import (
    resolve_transfer_format as jax_resolve,
)
from vae_tagger_tpu_torch.core.config import default_flux_vae_config
from vae_tagger_tpu_torch.data.bucketing import (
    AspectRatioBucketing,
    ImageSizeManifest,
    load_and_transform_image,
    load_and_transform_image_yuv,
    to_yuv420,
)
from vae_tagger_tpu_torch.data.dataset import TaggedImageDataset
from vae_tagger_tpu_torch.data.loader import BucketBatchSampler, DataLoader
from vae_tagger_tpu_torch.infer.engine import TaggerEngine
from vae_tagger_tpu_torch.io.checkpoints import (
    save_decoder_bin,
    save_vae_pretrained,
)
from vae_tagger_tpu_torch.models.autoencoder_kl import AutoencoderKL
from vae_tagger_tpu_torch.ops import backend
from vae_tagger_tpu_torch.ops.image import (
    rgb_to_yuv420_reference,
    yuv420_to_normalized_rgb,
    yuv420_to_rgb_uint8,
)
from vae_tagger_tpu_torch.train.steps import (
    batch_to_device,
    resolve_transfer_format,
)

GRIDS = [(512, 1024, 64), (256, 768, 128), (32, 48, 16), (64, 64, 8)]
# (w, h) of the dataset's images: three aspect ratios at 1/32 of the
# 1408x1152, 1024x768 and 1024x1024 sizes, on the 32..64 grid of step 16
SIZES = [(44, 36), (64, 48), (32, 32), (44, 36), (64, 48), (32, 32),
         (64, 48), (32, 32), (50, 40), (40, 50)]
SMALL_GRID = dict(base_resolution=32, max_resolution=64, bucket_step=16)


@pytest.fixture(autouse=True)
def _pil_only(monkeypatch):
    """Both packages on their PIL branch; no kernel launched."""
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    monkeypatch.setattr(torch_native, "_load", lambda: None)
    backend.reset_launch_counts()
    yield
    assert sum(backend.launch_counts().values()) == 0


def _photo(h, w, seed=0):
    """Smooth content with mild noise: chroma subsampling is a faithful
    representation of band-limited chroma, as in real photos."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(xx / 9.0) * np.cos(yy / 13.0),
                     128 + 90 * np.cos(xx / 17.0 + 1.0),
                     128 + 80 * np.sin((xx + yy) / 11.0)], axis=-1)
    noise = rng.normal(0, 3, size=(h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# buckets
# --------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
def test_bucket_lists_and_assignments_match_jax(grid):
    ours = AspectRatioBucketing(*grid)
    theirs = jax_bucketing.AspectRatioBucketing(*grid)
    assert ours.buckets == theirs.buckets
    for w in range(16, 2049, 48):
        for h in range(16, 2049, 80):
            assert (ours.assign_bucket_for_size(w, h)
                    == theirs.assign_bucket_for_size(w, h)), (w, h)


def test_first_exact_ratio_among_sorted_buckets():
    """The JAX package pins the first of equally near buckets in sorted
    order: a 4:3 image goes to (768, 576), not (1024, 768)."""
    b = AspectRatioBucketing(512, 1024, 64)
    assert b.assign_bucket_for_size(1408, 1152) == (704, 576)
    assert b.assign_bucket_for_size(1024, 768) == (768, 576)
    assert b.assign_bucket_for_size(1024, 1024) == (512, 512)


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(w=st.integers(1, 20000), h=st.integers(1, 20000),
       grid=st.sampled_from(GRIDS))
def test_drawn_sizes_go_to_the_jax_bucket(w, h, grid):
    assert (AspectRatioBucketing(*grid).assign_bucket_for_size(w, h)
            == jax_bucketing.AspectRatioBucketing(*grid)
            .assign_bucket_for_size(w, h))


def test_size_manifest_round_trip_and_jax_file(tmp_path):
    paths = []
    for i, (w, h) in enumerate(SIZES[:4]):
        p = tmp_path / f"{i}.png"
        Image.fromarray(_photo(h, w, i)).save(p)
        paths.append(str(p))
    m = ImageSizeManifest.for_dataset(tmp_path / "data.json")
    assert m.path.endswith("data.json.bucket_manifest.json")
    b = AspectRatioBucketing(**SMALL_GRID)
    first = [b.assign_bucket(p, manifest=m) for p in paths]
    m.save()
    again = ImageSizeManifest.for_dataset(tmp_path / "data.json")
    assert [again.lookup(p) for p in paths] == [s for s in SIZES[:4]]
    assert [AspectRatioBucketing(**SMALL_GRID).assign_bucket(
        p, manifest=again) for p in paths] == first
    # a changed file is read again
    Image.fromarray(_photo(48, 64, 9)).save(paths[0])
    assert again.lookup(paths[0]) in (None, (64, 48))
    # the JAX package's manifest reads here, and ours there
    jm = jax_bucketing.ImageSizeManifest(m.path)
    assert [jm.lookup(p) for p in paths[1:]] == [s for s in SIZES[1:4]]
    jm2 = jax_bucketing.ImageSizeManifest(str(tmp_path / "j.json"))
    for p in paths:
        jm2.record(p, Image.open(p).size)
    jm2.save()
    ours = ImageSizeManifest(str(tmp_path / "j.json"))
    assert [ours.lookup(p) for p in paths] == [Image.open(p).size
                                               for p in paths]


@pytest.mark.parametrize("bucket", [None, (48, 32), (32, 48), (64, 48)])
@pytest.mark.parametrize("size", [(44, 36), (36, 44), (64, 48)])
def test_transform_bytes_match_jax_pil_path(tmp_path, bucket, size):
    p = tmp_path / "img.png"
    Image.fromarray(_photo(size[1], size[0], 3)).save(p)
    got = load_and_transform_image(str(p), resolution=32, bucket=bucket)
    want = jax_bucketing.load_and_transform_image(str(p), resolution=32,
                                                  bucket=bucket)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the dataset and the sampler
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tagged(tmp_path_factory):
    root = tmp_path_factory.mktemp("bucketed")
    tags = [f"t{i}" for i in range(6)]
    (root / "tags.csv").write_text(
        "name,count\n" + "".join(f"{t},1\n" for t in tags))
    (root / "images").mkdir()
    rng = np.random.default_rng(0)
    data = {}
    for i, (w, h) in enumerate(SIZES):
        p = root / "images" / f"{i}.png"
        Image.fromarray(_photo(h, w, i)).save(p)
        data[str(p)] = ", ".join(f"{t}:0.9" for t in
                                 rng.choice(tags, 2, replace=False))
    (root / "data.json").write_text(json.dumps(data))
    return str(root / "data.json"), str(root / "tags.csv")


def _pair(tagged, **kw):
    return (TaggedImageDataset(*tagged, resolution=32, seed=3, **kw),
            JaxDataset(*tagged, resolution=32, seed=3, **kw))


def test_datasets_assign_the_same_buckets(tagged):
    ds, jds = _pair(tagged, use_bucketing=True, **SMALL_GRID)
    assert [ds.bucket_of(i) for i in range(len(ds))] == \
        [jds.bucket_of(i) for i in range(len(jds))]
    assert len({ds.bucket_of(i) for i in range(len(ds))}) >= 3


@pytest.mark.parametrize("batch_size", [1, 2, 3, 4])
@pytest.mark.parametrize("shuffle", [True, False])
def test_sampler_batches_equal_jax(tagged, batch_size, shuffle):
    ds, jds = _pair(tagged, use_bucketing=True, **SMALL_GRID)
    idx = [0, 1, 2, 3, 4, 5, 6, 8, 9]
    for epoch in (0, 1, 5):
        ours = BucketBatchSampler(ds, batch_size, shuffle, seed=7,
                                  indices=idx)
        theirs = JaxSampler(jds, batch_size, shuffle, seed=7, indices=idx,
                            pad_multiple=None)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = list(ours)
        assert got == [(list(c), list(m)) for c, m in theirs]
        assert len(ours) == len(theirs) == len(got)
        for chunk, mask in got:
            assert len(chunk) == batch_size and mask[0]
            assert len({ds.bucket_of(i) for i in chunk}) == 1


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
@pytest.mark.parametrize("bucketing", [False, True])
def test_dataset_items_equal_jax(tagged, fmt, bucketing):
    """Triplet and classification items in both wire formats: the same
    keys and bytes; triplet members share the anchor's bucket."""
    kw = dict(use_bucketing=bucketing, transfer_format=fmt,
              **(SMALL_GRID if bucketing else {}))
    for triplets in (True, False):
        ds, jds = _pair(tagged, return_triplets=triplets, **kw)
        for i in (0, 1, 8):
            got, want = ds[i], jds[i]
            assert set(got) == set(want), (set(got), set(want))
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(want[k]), k)
            if fmt == "yuv420":
                key = "anchor" if triplets else "pixel_values"
                y, c = got[key + "_y"], got[key + "_cbcr"]
                assert c.shape == (2, y.shape[0] // 2, y.shape[1] // 2)
            if bucketing and triplets and fmt == "rgb":
                w, h = ds.bucket_of(i)
                assert all(got[k].shape == (h, w, 3)
                           for k in ("anchor", "positive", "negative"))


def test_loader_batches_carry_the_mask_and_yuv_planes(tagged):
    ds = TaggedImageDataset(*tagged, resolution=32, seed=3,
                            return_triplets=False, use_bucketing=True,
                            transfer_format="yuv420", **SMALL_GRID)
    loader = DataLoader(ds, 3, shuffle=True, num_workers=2, seed=1)
    seen = []
    for batch in loader:
        y, c, mask = (batch["pixel_values_y"], batch["pixel_values_cbcr"],
                      batch["batch_mask"])
        assert y.shape[0] == c.shape[0] == mask.shape[0] == 3
        assert c.shape[1:] == (2, y.shape[1] // 2, y.shape[2] // 2)
        seen += batch["index"][mask].tolist()
        assert batch["load_ok"].all()
    assert sorted(seen) == list(range(len(ds)))


def test_odd_dims_are_refused(tagged, tmp_path):
    with pytest.raises(ValueError, match="even"):
        TaggedImageDataset(*tagged, resolution=33, transfer_format="yuv420")
    with pytest.raises(ValueError, match="even"):
        TaggedImageDataset(*tagged, use_bucketing=True,
                           transfer_format="yuv420", base_resolution=33,
                           max_resolution=65, bucket_step=16)
    with pytest.raises(ValueError, match="transfer_format"):
        TaggedImageDataset(*tagged, transfer_format="yuv444")
    with pytest.raises(ValueError, match="even"):
        to_yuv420(np.zeros((6, 5, 3), np.uint8))
    p = tmp_path / "x.png"
    Image.fromarray(_photo(8, 8)).save(p)
    with pytest.raises(ValueError, match="even"):
        load_and_transform_image_yuv(str(p), 7)


# --------------------------------------------------------------------------
# YUV 4:2:0
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 64), (48, 96), (2, 2), (36, 44)])
def test_host_conversion_bytes_equal_jax(shape):
    rgb = _photo(*shape, seed=sum(shape))
    for got, want in zip(rgb_to_yuv420_reference(rgb),
                         jax_image.rgb_to_yuv420_reference(rgb)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(to_yuv420(rgb), jax_bucketing.to_yuv420(rgb)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(64, 64), (48, 96), (2, 4)])
def test_bilinear_2x_matches_jax_linear_resize(shape):
    rng = np.random.default_rng(1)
    c = rng.uniform(-128, 128, size=(2, 2, *shape)).astype(np.float32)
    got = F.interpolate(torch.from_numpy(c), scale_factor=2,
                        mode="bilinear", align_corners=False).numpy()
    want = np.asarray(jax.image.resize(
        jnp.asarray(c), (2, 2, 2 * shape[0], 2 * shape[1]), "linear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_conversion_within_one_step_of_jax(seed):
    rng = np.random.default_rng(seed)
    rgb = np.stack([_photo(64, 96, seed), rng.integers(
        0, 256, (64, 96, 3), dtype=np.uint8)])
    planes = [rgb_to_yuv420_reference(im) for im in rgb]
    y = np.stack([p[0] for p in planes])
    c = np.stack([p[1] for p in planes])
    got = yuv420_to_rgb_uint8(torch.from_numpy(y), torch.from_numpy(c))
    want = np.asarray(jax_image.yuv420_to_rgb_uint8(jnp.asarray(y),
                                                    jnp.asarray(c)))
    assert got.dtype == torch.uint8 and got.shape == (2, 64, 96, 3)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    norm = yuv420_to_normalized_rgb(torch.from_numpy(y), torch.from_numpy(c))
    np.testing.assert_array_equal(norm.numpy(),
                                  got.numpy().astype(np.float32) / 127.5 - 1)


def test_resolve_transfer_format_on_a_triplet_batch():
    rng = np.random.default_rng(4)
    batch = {"labels": rng.uniform(size=(2, 5)).astype(np.float32),
             "positive_labels": rng.uniform(size=(2, 5)).astype(np.float32)}
    for k in ("anchor", "positive", "negative"):
        planes = [to_yuv420(_photo(32, 48, seed=i + len(k)))
                  for i in range(2)]
        batch[k + "_y"] = np.stack([p[0] for p in planes])
        batch[k + "_cbcr"] = np.stack([p[1] for p in planes])
    dev = batch_to_device(batch, torch.device("cpu"))
    got = resolve_transfer_format(dev)
    want = jax_resolve({k: jnp.asarray(v) for k, v in batch.items()})
    assert set(got) == set(want) == {"anchor", "positive", "negative",
                                     "labels", "positive_labels"}
    for k in ("anchor", "positive", "negative"):
        assert got[k].shape == (2, 32, 48, 3) and got[k].dtype == torch.uint8
        diff = np.abs(got[k].numpy().astype(int)
                      - np.asarray(want[k]).astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    rgb = {"anchor": torch.zeros(1, 2, 2, 3, dtype=torch.uint8)}
    assert resolve_transfer_format(rgb) is rgb


@pytest.fixture(scope="module")
def engine_dir(tmp_path_factory):
    """The JAX package's tiny engine of tests/test_yuv.py (its weights,
    carried over), saved as the port's checkpoints, and its images."""
    from vae_tagger_tpu.core.config import default_flux_vae_config as jcfg
    from vae_tagger_tpu.infer.engine import build_decoder as jax_head
    from vae_tagger_tpu.models.autoencoder_kl import AutoencoderKL as JaxVAE
    from vae_tagger_tpu_torch.infer.engine import build_decoder
    from vae_tagger_tpu_torch.io.checkpoints import (
        torch_state_from_jax_params,
    )

    root = tmp_path_factory.mktemp("yuv_engine")
    shape = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
                 latent_channels=16)
    vae = JaxVAE(jcfg(sample_size=64, **shape))
    params = jax.jit(vae.init)({"params": jax.random.key(0)},
                               jnp.zeros((1, 64, 64, 3)),
                               jax.random.key(1))["params"]
    head = jax_head(5, use_attention=True, latent_channels=16)
    hvars = jax.jit(head.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(2)}, jnp.zeros((1, 8, 8, 16)),
        deterministic=True)
    port = AutoencoderKL(default_flux_vae_config(**shape))
    port.load_state_dict({k: v for k, v in torch_state_from_jax_params(
        jax.device_get(params)).items() if not k.startswith("decoder.")})
    save_vae_pretrained(port, port.config, str(root / "vae"))
    phead = build_decoder(5, True, None, latent_channels=16)
    phead.load_state_dict(torch_state_from_jax_params(
        jax.device_get(hvars["params"]),
        jax.device_get(hvars.get("batch_stats"))), strict=False)
    save_decoder_bin(phead, str(root / "head.bin"))
    (root / "tags.csv").write_text(
        "name\n" + "".join(f"t{i}\n" for i in range(5)))
    (root / "images").mkdir()
    for i in range(3):
        Image.fromarray(_photo(96, 128, seed=10 + i)).save(
            root / "images" / f"im{i}.jpg", quality=95)
    Image.fromarray(_photo(80, 80, seed=20)).save(root / "images" / "im3.png")
    return root


def _engine(root):
    return TaggerEngine.load(
        str(root / "vae" / "diffusion_pytorch_model.safetensors"),
        str(root / "head.bin"), str(root / "tags.csv"),
        vae_config_path=str(root / "vae" / "config.json"),
        device="cpu")


def test_engine_yuv_equals_the_converted_rgb(engine_dir):
    eng = _engine(engine_dir)
    planes = [rgb_to_yuv420_reference(_photo(64, 64, seed=40 + i))
              for i in range(2)]
    y = np.stack([p[0] for p in planes])
    c = np.stack([p[1] for p in planes])
    rgb = yuv420_to_rgb_uint8(torch.from_numpy(y),
                              torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(eng.encode_yuv(y, c), eng.encode(rgb))
    np.testing.assert_array_equal(eng.classify_yuv(y, c), eng.classify(rgb))


def _infer(root, out, *flags):
    from vae_tagger_tpu_torch.infer.__main__ import main

    return main(["--device", "cpu", "--vae_checkpoint",
                 str(root / "vae" / "diffusion_pytorch_model.safetensors"),
                 "--vae_config_path", str(root / "vae" / "config.json"),
                 "--decoder_checkpoint", str(root / "head.bin"),
                 "--image_path", str(root / "images"), "--tags_csv_path",
                 str(root / "tags.csv"), "--output_dir", str(out),
                 "--resolution", "64", "--batch_size", "3",
                 "--confidence_threshold", "0", *flags])


def test_infer_cli_yuv_tags_like_rgb(engine_dir):
    """The JAX package's chroma bound (tests/test_yuv.py): every tag's
    probability within 0.05 of the RGB run's."""
    rgb = _infer(engine_dir, engine_dir / "o_rgb")
    yuv = _infer(engine_dir, engine_dir / "o_yuv", "--transfer_format",
                 "yuv420")
    assert set(rgb) == set(yuv) and len(rgb) == 4
    for k in rgb:
        a = {t["tag"]: t["confidence"] for t in rgb[k]["predicted_tags"]}
        b = {t["tag"]: t["confidence"] for t in yuv[k]["predicted_tags"]}
        assert set(a) == set(b)
        assert all(abs(a[t] - b[t]) < 0.05 for t in a)
    on_disk = json.loads((engine_dir / "o_yuv" /
                          "classification_results.json").read_text())
    assert set(on_disk) == set(yuv)


@pytest.mark.parametrize("flag", [["--no_data_parallel"],
                                  ["--spatial_parallel"],
                                  ["--model_checkpoint", "ckpt"]])
def test_infer_cli_refuses_the_multi_gpu_and_legacy_flags(engine_dir,
                                                          tmp_path, flag):
    """No longer refused: on one device --no_data_parallel and
    --spatial_parallel change nothing, and --model_checkpoint stands in
    for a missing --decoder_checkpoint; each run's JSON equals the run
    without the flag."""
    from vae_tagger_tpu_torch.infer.__main__ import main

    plain = _infer(engine_dir, tmp_path / "plain")
    if flag[0] == "--model_checkpoint":
        vae = engine_dir / "vae"
        argv = ["--device", "cpu", "--vae_checkpoint",
                str(vae / "diffusion_pytorch_model.safetensors"),
                "--vae_config_path", str(vae / "config.json"),
                "--model_checkpoint", str(engine_dir / "head.bin"),
                "--image_path", str(engine_dir / "images"), "--tags_csv_path",
                str(engine_dir / "tags.csv"), "--output_dir",
                str(tmp_path / "flag"), "--resolution", "64", "--batch_size",
                "3", "--confidence_threshold", "0"]
        got = main(argv)
        with pytest.raises(SystemExit):  # neither path nor a stand-in
            main([a for a in argv if a != str(engine_dir / "head.bin")
                  and a != "--model_checkpoint"])
    else:
        got = _infer(engine_dir, tmp_path / "flag", *flag)
    assert got == plain
