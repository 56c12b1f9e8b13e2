"""The Wan 2.1 VAE's encoder in the port (models/autoencoder_kl_wan.py)
against the plain 3-D oracle (torch_oracle/wan_vae_torch.py), on the CPU at
a small width (``base_dim`` 8, the published ``dim_mult``,
``num_res_blocks`` and ``z_dim``) and 32x48 images: the moments and the
head's probabilities in fp32 and bf16; the collapse of a causal conv on one
frame to its last tap; a diffusers-layout folder through ``load_vae``, the
engine and the infer CLI; each family's latent transform; the trainers'
refusal; and the op ranges of an encode."""

import importlib
import json
import math
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from safetensors.torch import save_file

from torch_oracle.wan_vae_torch import CausalConv3d, WanVAEOracle
from vae_tagger_tpu_torch.core.config import (
    AttentionDecoderConfig,
    default_flux_vae_config,
    default_wan_vae_config,
)
from vae_tagger_tpu_torch.infer.engine import TaggerEngine
from vae_tagger_tpu_torch.io.checkpoints import load_vae, save_decoder_bin
from vae_tagger_tpu_torch.models.autoencoder_kl import (
    AutoencoderKL,
    encode_scaled,
)
from vae_tagger_tpu_torch.models.autoencoder_kl_wan import (
    AutoencoderKLWan,
    wan_state_from_diffusers,
)
from vae_tagger_tpu_torch.models.taggers import AttentionClassificationDecoder
from vae_tagger_tpu_torch.nn.blocks import Conv2D, seeded_init_

CFG = default_wan_vae_config(base_dim=8)
H, W, TAGS = 32, 48, 6
# bf16 against the fp32 oracle: every activation and conv operand of the
# port is rounded to 8 significant bits (2^-9 relative), through 28 convs
# and the attention.  Over seeds 0-3 of this file's weights and pixels the
# moments drifted by 1.1e-2 to 1.5e-2 of their largest magnitude and the
# probabilities by 2.0e-3 to 3.0e-3; the limits leave about three times
# that
BF16_MOMENTS, BF16_PROBS = 4e-2, 1e-2


def _oracle_state(seed=0):
    """The oracle with seeded weights under diffusers' names and shapes
    (5-D kernels, gamma (C, 1, 1[, 1]), time_conv), and that state."""
    oracle = WanVAEOracle(base_dim=8, latents_mean=list(CFG.latents_mean),
                          latents_std=list(CFG.latents_std))
    g = torch.Generator().manual_seed(seed)
    state = {}
    for k, v in oracle.state_dict().items():
        t = torch.randn(v.shape, generator=g)
        if k.endswith("gamma"):
            t = 1.0 + 0.1 * t
        elif v.dim() >= 2:
            t = t / math.sqrt(v.shape[1] * math.prod(v.shape[-2:]))
        else:
            t = 0.05 * t
        state[k] = t
    oracle.load_state_dict(state)
    return oracle.eval(), state


def _head():
    return seeded_init_(AttentionClassificationDecoder(
        16, TAGS, AttentionDecoderConfig(attention_heads=2)), 4).eval()


def _pixels(n=2, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, H, W, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def models():
    """(oracle, port, diffusers state, head, pixels, the oracle's fp32
    moments and probabilities)."""
    oracle, state = _oracle_state()
    port = AutoencoderKLWan(CFG)
    port.load_state_dict(state)
    port.eval()
    head = _head()
    px = _pixels()
    x = torch.from_numpy(px).permute(0, 3, 1, 2).float() / 127.5 - 1.0
    with torch.no_grad():
        moments = oracle.encode_moments(x)
        latents = oracle.latent_normalize(moments[:, :16])
        probs = torch.sigmoid(head(latents.permute(0, 2, 3, 1)))
    return oracle, port, state, head, px, moments, probs


@pytest.mark.parametrize("dtype,tol_moments,tol_probs", [
    (torch.float32, 1e-5, 1e-5), (torch.bfloat16, BF16_MOMENTS, BF16_PROBS)])
def test_the_port_agrees_with_the_3d_oracle(models, dtype, tol_moments,
                                            tol_probs):
    _, port, _, head, px, moments, probs = models
    x = torch.from_numpy(px).to(dtype) / 127.5 - 1.0
    head.dtype = dtype  # the engine's compute dtype; parameters stay fp32
    with torch.no_grad():
        post = port.encode(x)
        got = torch.cat([post.mean, post.logvar], -1).permute(0, 3, 1, 2)
        p = torch.sigmoid(head(
            port.scale_latents(post.mode()).to(dtype)).float())
    head.dtype = torch.float32
    scale = moments.abs().max()
    assert (got - moments).abs().max() <= tol_moments * scale
    assert (p - probs).abs().max() <= tol_probs


@pytest.mark.parametrize("k", [3, 1])
def test_a_causal_conv_on_one_frame_is_its_last_tap(k):
    g = torch.Generator().manual_seed(k)
    published = CausalConv3d(5, 4, k, padding=k // 2)
    with torch.no_grad():
        for p in published.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    port = Conv2D(5, 4, k, padding=k // 2)
    port.load_state_dict(wan_state_from_diffusers(published.state_dict()))
    x = torch.randn(2, 5, 9, 7, generator=g)
    with torch.no_grad():
        ref = published(x[:, :, None])[:, :, 0]   # F.conv3d, zeros in front
        got = port(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        two_d = F.conv2d(x, published.weight[:, :, -1], published.bias,
                         padding=k // 2)
    assert torch.allclose(got, ref, rtol=0, atol=1e-5)
    assert torch.equal(got, two_d)


def _folder(tmp_path, state):
    """A diffusers-layout Wan VAE folder: config.json and the weights."""
    folder = tmp_path / "vae"
    folder.mkdir()
    cfg = dict(CFG.to_json_dict(), _diffusers_version="0.33.0.dev0")
    (folder / "config.json").write_text(json.dumps(cfg))
    save_file({k: v.contiguous() for k, v in state.items()},
              str(folder / "diffusion_pytorch_model.safetensors"))
    return folder


def test_a_diffusers_folder_loads_through_load_vae(models, tmp_path):
    _, port, state, *_ = models
    assert any(".time_conv." in k for k in state)
    assert state["encoder.norm_out.gamma"].shape == (32, 1, 1, 1)
    assert state["encoder.mid_block.attentions.0.norm.gamma"].shape == \
        (32, 1, 1)
    folder = _folder(tmp_path, state)
    vae = load_vae(str(folder / "diffusion_pytorch_model.safetensors"),
                   str(folder / "config.json"))
    assert isinstance(vae, AutoencoderKLWan) and vae.config == CFG
    mine, theirs = vae.state_dict(), port.state_dict()
    assert mine.keys() == theirs.keys()
    assert all(torch.equal(mine[k], theirs[k]) for k in mine)
    with pytest.raises(NotImplementedError, match="encoder only"):
        load_vae(None, str(folder / "config.json"), require_checkpoint=False,
                 with_decoder=True)


@pytest.mark.parametrize("precision", ["no", "bf16"])
def test_a_wan_folder_tags_through_the_engine_and_the_cli(models, tmp_path,
                                                         precision):
    from PIL import Image

    from vae_tagger_tpu_torch.infer.__main__ import main as infer_main

    *_, state, head, px, _, _ = models
    folder = _folder(tmp_path, state)
    save_decoder_bin(head, str(tmp_path / "head.bin"))
    tags = [f"t{i}" for i in range(TAGS)]
    (tmp_path / "tags.csv").write_text(
        "name,count\n" + "".join(f"{t},1\n" for t in tags))
    common = dict(vae_checkpoint=str(folder / "diffusion_pytorch_model"
                                              ".safetensors"),
                  decoder_checkpoint=str(tmp_path / "head.bin"),
                  tags_csv_path=str(tmp_path / "tags.csv"),
                  vae_config_path=str(folder / "config.json"))
    engine = TaggerEngine.load(**common, attention_config=dict(
        attention_heads=2), mixed_precision=precision, device="cpu")
    assert isinstance(engine.vae, AutoencoderKLWan)
    probs = engine.classify(px)
    assert probs.shape == (2, TAGS) and np.isfinite(probs).all()
    images = tmp_path / "images"
    images.mkdir()
    for i, img in enumerate(_pixels(2, 9)):
        Image.fromarray(img).save(images / f"{i}.png")
    out = tmp_path / "out"
    infer_main(["--device", "cpu", "--image_path", str(images),
                "--output_dir", str(out), "--resolution", "32",
                "--batch_size", "2", "--num_workers", "1",
                "--attention_heads", "2", "--mixed_precision", precision,
                *(f"--{k}={v}" for k, v in common.items())])
    results = json.loads((out / "classification_results.json").read_text())
    assert len(results) == 2


def test_each_family_scales_its_own_latents():
    m = torch.randn(2, 3, 5, 16)
    flux = AutoencoderKL(default_flux_vae_config(
        block_out_channels=(8, 8),
        down_block_types=("DownEncoderBlock2D",) * 2,
        up_block_types=("UpDecoderBlock2D",) * 2, norm_num_groups=4))
    assert torch.equal(flux.scale_latents(m), encode_scaled(m, flux.config))
    expect = ((m - torch.tensor(CFG.latents_mean))
              / torch.tensor(CFG.latents_std))
    assert torch.allclose(AutoencoderKLWan(CFG).scale_latents(m), expect)


@pytest.mark.parametrize("trainer", ["train_full", "train_vae"])
def test_the_trainers_through_the_vae_refuse_it(models, tmp_path, trainer):
    folder = _folder(tmp_path, models[2])
    mod = importlib.import_module(f"vae_tagger_tpu_torch.train.{trainer}")
    argv = ["--device", "cpu", "--json_path", str(tmp_path / "data.json"),
            "--tags_csv_path", str(tmp_path / "tags.csv"),
            "--output_dir", str(tmp_path / "out"),
            "--vae_checkpoint",
            str(folder / "diffusion_pytorch_model.safetensors"),
            "--vae_config_path", str(folder / "config.json")]
    with pytest.raises(NotImplementedError,
                       match=r"RMS norm's backward.*D', D'', E', E''.*384"):
        mod.main(argv)
    assert not (tmp_path / "out").exists()


def test_an_encode_opens_the_rms_op_ranges(models):
    """Under a profiler: every residual branch in ``op.rms_silu_conv3x3``,
    the attention's norm and the head's in ``op.rms_norm_stats`` and
    ``op.rms_norm_silu``; without one the output is the same."""
    from torch.profiler import ProfilerActivity, profile

    _, port, *_ = models
    x = torch.from_numpy(_pixels(1)).float() / 127.5 - 1.0
    with torch.no_grad():
        plain = port.encode(x).mean
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = port.encode(x).mean
    names = Counter(e.name for e in prof.events()
                    if e.name.startswith("vt:op.rms"))
    # 4 stages x 2 blocks + the mid block's 2, two branches each
    assert names == {"vt:op.rms_silu_conv3x3": 20, "vt:op.rms_norm_stats": 2,
                     "vt:op.rms_norm_silu": 2}
    assert torch.equal(plain, traced)
