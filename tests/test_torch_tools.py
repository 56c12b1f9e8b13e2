"""The port's tools against the JAX package's, on the CPU: the synthetic
dataset from a seed (the same images, data.json and tags.csv), the
dataset linter and the resolution analyzer (the same reports and
results, through their CLIs too), and the batch inference check
(``python -m vae_tagger_tpu_torch.infer.batch_test``: the same metrics as
``scripts/batch_inference_test.py``'s functions on the same predictions,
and its results file from a run on the CPU).
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from vae_tagger_tpu.utils import synthetic as jax_synthetic
from vae_tagger_tpu.utils import validation as jax_validation
from vae_tagger_tpu_torch.infer import batch_test
from vae_tagger_tpu_torch.utils import synthetic, validation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same seed through both generators, each in a directory of the
    same name (data.json keys carry the output directory)."""
    out = {}
    for name, make in (("ours", synthetic.main), ("theirs", None)):
        root = tmp_path_factory.mktemp(name)
        cwd = os.getcwd()
        os.chdir(root)
        try:
            if make is None:
                out[name] = jax_synthetic.create_synthetic_dataset(
                    "ds", num_images=24, img_size=64, seed=5)
            else:
                out[name] = make(["--output_dir", "ds", "--num_images", "24",
                                  "--img_size", "64", "--seed", "5"])
        finally:
            os.chdir(cwd)
        out[name] = {k: (str(root / v) if isinstance(v, str) else v)
                     for k, v in out[name].items()}
        out[name]["root"] = root
    return out


def test_synthetic_dataset_equals_jax(datasets):
    ours, theirs = datasets["ours"], datasets["theirs"]
    assert ours["num_tags"] == theirs["num_tags"]
    assert ours["num_images"] == theirs["num_images"] == 24
    for key in ("data_json", "tags_csv"):
        with open(ours[key], "rb") as a, open(theirs[key], "rb") as b:
            assert a.read() == b.read(), key
    names = sorted(os.listdir(theirs["images_dir"]))
    assert sorted(os.listdir(ours["images_dir"])) == names
    for n in names:
        with open(os.path.join(ours["images_dir"], n), "rb") as a, \
                open(os.path.join(theirs["images_dir"], n), "rb") as b:
            assert a.read() == b.read(), n
    rendered = synthetic.render_shape("triangle", "purple", "large",
                                      "gradient", 96)
    assert np.array_equal(rendered, jax_synthetic.render_shape(
        "triangle", "purple", "large", "gradient", 96))


@pytest.mark.parametrize("fix", [False, True])
def test_validate_dataset_reports_equal_jax(datasets, tmp_path, fix):
    ds = datasets["theirs"]
    data = json.loads(open(ds["data_json"]).read())
    first = next(iter(data))
    data["missing/image.jpg"] = "circle:1.0"   # a missing image
    data[first] = "circle:1.0, unknown_tag:0.5"  # an unknown tag
    second = list(data)[1]
    data[second] = " , "                       # empty labels
    path = tmp_path / "data.json"
    path.write_text(json.dumps(data))
    cwd = os.getcwd()
    os.chdir(ds["root"])  # the image paths are relative to it
    try:
        got = validation.main(["validate_data", "--json_path", str(path),
                               "--tags_csv_path", ds["tags_csv"],
                               "--output_dir", str(tmp_path / "ours"),
                               *(["--fix"] if fix else [])])
        want = jax_validation.validate_dataset(
            str(path), ds["tags_csv"], str(tmp_path / "theirs"), fix)
    finally:
        os.chdir(cwd)
    assert got == want
    assert got["missing_images"] == 1 and got["empty_label_images"] == 1
    assert got["images_with_unknown_tags"] == 1
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "ours")) == names
    assert ("data.cleaned.json" in names) == fix
    for n in names:
        assert (tmp_path / "ours" / n).read_bytes() == \
            (tmp_path / "theirs" / n).read_bytes(), n


def test_analyze_resolutions_equals_jax(datasets, tmp_path, capsys):
    ds = datasets["theirs"]
    from PIL import Image

    extra = tmp_path / "wide.png"
    Image.new("RGB", (128, 64)).save(extra)
    data = json.loads(open(ds["data_json"]).read())
    data[str(extra)] = "circle:1.0"
    path = tmp_path / "data.json"
    path.write_text(json.dumps(data))
    cwd = os.getcwd()
    os.chdir(ds["root"])
    try:
        got = validation.main(["analyze_resolutions", "--json_path",
                               str(path)])
        ours_text = capsys.readouterr().out
        want = jax_validation.analyze_image_resolutions(str(path))
        theirs_text = capsys.readouterr().out
    finally:
        os.chdir(cwd)
    assert got == want
    assert got["suggested_resolution"] == 64
    assert ours_text.replace("\nanalysis complete!\n", "") == theirs_text


def test_batch_metrics_equal_the_jax_scripts(datasets):
    jax_bt = _jax_script("batch_inference_test")
    gt_path = datasets["theirs"]["data_json"]
    assert batch_test.load_ground_truth(gt_path) == \
        jax_bt.load_ground_truth(gt_path)
    gt = batch_test.load_ground_truth(gt_path)
    rng = np.random.default_rng(0)
    tags = ["circle", "red", "small", "square", "blue", "solid"]
    preds = {p: {"predicted_tags": [{"tag": t, "confidence": 0.9}
                                    for t in rng.choice(tags, 3,
                                                        replace=False)]}
             for p in list(gt)[:10]}
    preds["elsewhere/none.jpg"] = {"predicted_tags": []}
    assert batch_test.calculate_metrics(preds, gt) == \
        jax_bt.calculate_metrics(preds, gt)


def test_batch_test_cli_on_the_cpu(datasets, tmp_path):
    from vae_tagger_tpu_torch.core.config import default_flux_vae_config
    from vae_tagger_tpu_torch.infer.engine import build_decoder
    from vae_tagger_tpu_torch.io.checkpoints import (
        save_decoder_bin,
        save_vae_pretrained,
    )
    from vae_tagger_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from vae_tagger_tpu_torch.nn.blocks import seeded_init_

    ds = datasets["ours"]
    cfg = default_flux_vae_config(block_out_channels=(8, 16, 16, 16),
                                  norm_num_groups=4, latent_channels=16)
    save_vae_pretrained(seeded_init_(AutoencoderKL(cfg), 0), cfg,
                        str(tmp_path / "vae"))
    head = build_decoder(ds["num_tags"], True, {"attention_heads": 2}, 16,
                         seed=1)
    save_decoder_bin(head, str(tmp_path / "head.bin"))
    cwd = os.getcwd()
    os.chdir(ds["root"])
    try:
        metrics = batch_test.main([
            "--vae_checkpoint",
            str(tmp_path / "vae" / "diffusion_pytorch_model.safetensors"),
            "--vae_config_path", str(tmp_path / "vae" / "config.json"),
            "--decoder_checkpoint", str(tmp_path / "head.bin"),
            "--tags_csv_path", ds["tags_csv"], "--image_dir",
            ds["images_dir"], "--data_json_path", ds["data_json"],
            "--output_dir", str(tmp_path / "out"), "--max_images", "5",
            "--resolution", "32", "--batch_size", "2", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert metrics["total_images"] == 5
    saved = json.loads((tmp_path / "out" / "batch_test_results.json")
                       .read_text())
    assert saved == json.loads(json.dumps(metrics))
