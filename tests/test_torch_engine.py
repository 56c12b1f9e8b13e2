"""The encode+tag slice as a whole: the port's engine, classify loop and
CLI against the JAX package's, on checkpoints the JAX package wrote."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vae_tagger_tpu.core.config import default_flux_vae_config
from vae_tagger_tpu.infer import TaggerEngine as JaxEngine
from vae_tagger_tpu.infer import infer_and_classify as jax_infer
from vae_tagger_tpu.io import save_decoder_bin, save_vae_pretrained
from vae_tagger_tpu.models.autoencoder_kl import AutoencoderKL as JaxVAE
from vae_tagger_tpu.models.taggers import AttentionClassificationDecoder
from vae_tagger_tpu_torch.infer import TaggerEngine, infer_and_classify
from vae_tagger_tpu_torch.infer.__main__ import main as cli_main
from vae_tagger_tpu_torch.ops import backend

RES = 64
NUM_TAGS = 12


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(a, np.float32)
        + (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32)
        for a in leaves])


@functools.lru_cache(maxsize=None)
def _artifacts(root):
    """A tiny VAE (diffusers layout) and an attention head (.bin with
    BatchNorm stats), both written by the JAX package, plus tags and PNGs."""
    cfg = default_flux_vae_config(block_out_channels=(8, 16, 16, 16),
                                  norm_num_groups=4, latent_channels=16,
                                  sample_size=RES)
    vae = JaxVAE(cfg)
    params = jax.jit(vae.init)({"params": jax.random.key(0)},
                               jnp.zeros((1, RES, RES, 3)),
                               jax.random.key(1))["params"]
    save_vae_pretrained(_noisy(params, 1), cfg, f"{root}/vae")

    head = AttentionClassificationDecoder(latent_channels=16,
                                          num_classes=NUM_TAGS)
    variables = jax.jit(head.init, static_argnames=("deterministic",))(
        {"params": jax.random.key(2)}, jnp.zeros((1, 8, 8, 16)),
        deterministic=True)
    rng = np.random.default_rng(3)
    stats = {"feature_compress_1": {
        "mean": (rng.normal(size=(8,)) * 0.1).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, size=(8,)).astype(np.float32)}}
    save_decoder_bin(_noisy(variables["params"], 4), stats,
                     f"{root}/decoder.bin")

    with open(f"{root}/tags.csv", "w") as f:
        f.write("name,count\n")
        f.writelines(f"tag_{i},{i}\n" for i in range(NUM_TAGS))
    os.makedirs(f"{root}/images", exist_ok=True)
    pixels = rng.integers(0, 256, size=(5, RES, RES, 3), dtype=np.uint8)
    for i, px in enumerate(pixels):
        # written at the model resolution, so the square resize is exact
        Image.fromarray(px).save(f"{root}/images/img_{i}.png")
    return dict(vae=f"{root}/vae/diffusion_pytorch_model.safetensors",
                config=f"{root}/vae/config.json",
                decoder=f"{root}/decoder.bin", tags=f"{root}/tags.csv",
                images=f"{root}/images", pixels=pixels)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    return _artifacts(str(tmp_path_factory.mktemp("torch_engine")))


@pytest.fixture(scope="module")
def engines(art):
    kw = dict(vae_checkpoint=art["vae"], decoder_checkpoint=art["decoder"],
              tags_csv_path=art["tags"], vae_config_path=art["config"])
    return JaxEngine.load(**kw), TaggerEngine.load(device="cpu", **kw)


def test_engine_probabilities_match_jax(art, engines):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    jax_engine, port = engines
    want = jax_engine.classify(art["pixels"])
    got = port.classify(art["pixels"])
    assert got.shape == (5, NUM_TAGS) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    latents, probs = port.encode_and_classify(art["pixels"][:2])
    np.testing.assert_allclose(latents, jax_engine.encode(art["pixels"][:2]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(probs, want[:2], rtol=0, atol=1e-5)
    conf, idx = port.get_confidence(art["pixels"][:1])
    assert (np.diff(conf[0]) <= 0).all() and sorted(idx[0]) == list(
        range(NUM_TAGS))


def _threshold(probs):
    """A threshold in the widest gap between the probabilities, so a tag
    lies clearly on one side of it in both packages."""
    p = np.sort(probs.ravel())
    i = int(np.argmax(np.diff(p)[len(p) // 4: 3 * len(p) // 4])) + len(p) // 4
    return float((p[i] + p[i + 1]) / 2)


def test_infer_and_classify_matches_jax(art, engines, tmp_path):
    jax_engine, port = engines
    thr = _threshold(jax_engine.classify(art["pixels"]))
    kw = dict(resolution=RES, confidence_threshold=thr, batch_size=2,
              num_workers=2, verbose=False)
    want = jax_infer(jax_engine, art["images"], output_dir=str(tmp_path / "j"),
                     **kw)
    got = infer_and_classify(port, art["images"],
                             output_dir=str(tmp_path / "t"), **kw)
    assert set(got) == set(want) and len(got) == 5
    for path, res in want.items():
        assert [t["tag"] for t in got[path]["predicted_tags"]] == [
            t["tag"] for t in res["predicted_tags"]]
        assert got[path]["total_tags_above_threshold"] == res[
            "total_tags_above_threshold"]
        assert abs(got[path]["max_confidence"]
                   - res["max_confidence"]) <= 2e-4
    on_disk = json.loads(
        (tmp_path / "t" / "classification_results.json").read_text())
    assert on_disk == got


def test_cli_on_cpu(art, tmp_path):
    backend.reset_launch_counts()
    results = cli_main([
        "--vae_checkpoint", art["vae"], "--vae_config_path", art["config"],
        "--decoder_checkpoint", art["decoder"], "--image_path",
        art["images"], "--tags_csv_path", art["tags"], "--output_dir",
        str(tmp_path), "--resolution", str(RES), "--batch_size", "4",
        "--num_workers", "1", "--device", "cpu"])
    assert len(results) == 5
    assert (tmp_path / "classification_results.json").exists()
    assert sum(backend.launch_counts().values()) == 0  # plain path on CPU


def test_load_without_device_raises_without_cuda(art, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TaggerEngine.load(vae_checkpoint=art["vae"],
                          decoder_checkpoint=art["decoder"],
                          tags_csv_path=art["tags"],
                          vae_config_path=art["config"])
