"""The port's VAE decoder against the JAX package's, on the same weights
(carried over with ``torch_state_from_jax_params``) and the same numpy
inputs, in fp32 on the CPU: ``AutoencoderKL.decode`` and the training
forward with injected posterior noise (MSE < 1e-10, the encoder's gate),
``decode_scaled``, the blocks ``Upsample`` and ``UpDecoderBlock``, and the
diffusers-layout checkpoint: the JAX package's export loads into the port
with no key missing or left over, and the port's save and load round trip
keeps every decoder tensor."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_tagger_tpu.core.config import default_flux_vae_config as jax_vae_cfg
from vae_tagger_tpu.io.safetensors_io import (
    save_vae_pretrained as jax_save_vae,
)
from vae_tagger_tpu.models.autoencoder_kl import AutoencoderKL as JaxVAE
from vae_tagger_tpu.models.autoencoder_kl import decode_scaled as jax_dscaled
from vae_tagger_tpu.nn.blocks import UpDecoderBlock as JaxUpBlock
from vae_tagger_tpu.nn.blocks import Upsample as JaxUpsample
from vae_tagger_tpu_torch.core.config import default_flux_vae_config
from vae_tagger_tpu_torch.io.checkpoints import (
    load_state_file,
    load_vae,
    save_vae_pretrained,
    torch_state_from_jax_params,
)
from vae_tagger_tpu_torch.models.autoencoder_kl import (
    AutoencoderKL,
    DiagonalGaussian,
    decode_scaled,
)
from vae_tagger_tpu_torch.nn.blocks import UpDecoderBlock, Upsample
from vae_tagger_tpu_torch.ops import backend

TINY = dict(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
            latent_channels=4)
RES = 32


@pytest.fixture(autouse=True)
def _cpu_fp32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backend.reset_launch_counts()
    yield
    assert sum(backend.launch_counts().values()) == 0


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(a, np.float32)
        + (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32)
        for a in leaves])


@functools.lru_cache(maxsize=None)
def _vae_pair(quant: bool):
    cfg = jax_vae_cfg(use_quant_conv=quant, use_post_quant_conv=quant,
                      **TINY)
    model = JaxVAE(cfg)
    params = jax.jit(model.init)({"params": jax.random.key(0)},
                                 jnp.zeros((1, RES, RES, 3)),
                                 jax.random.key(1))["params"]
    params = _perturb(jax.device_get(params), 2)
    port = AutoencoderKL(default_flux_vae_config(
        use_quant_conv=quant, use_post_quant_conv=quant, **TINY),
        with_decoder=True)
    port.load_state_dict(torch_state_from_jax_params(params), strict=True)
    return model, params, port.eval()


def _mse(a, b):
    return float(np.mean((np.asarray(a, np.float64)
                          - np.asarray(b, np.float64)) ** 2))


@pytest.mark.parametrize("quant", [False, True])
def test_decode_matches_jax(quant):
    model, params, port = _vae_pair(quant)
    z = np.random.default_rng(3).normal(
        size=(2, RES // 8, RES // 8, 4)).astype(np.float32)
    want = jax.jit(lambda p, z: model.apply({"params": p}, z,
                                            method=JaxVAE.decode))(params, z)
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == (2, RES, RES, 3)
    assert _mse(got.numpy(), want) < 1e-10


@pytest.mark.parametrize("quant", [False, True])
def test_training_forward_with_injected_noise_matches_jax(quant,
                                                          monkeypatch):
    """encode -> mean + std * eps -> decode, eps from numpy on both sides."""
    model, params, port = _vae_pair(quant)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, size=(2, RES, RES, 3)).astype(np.float32)
    eps = rng.normal(size=(2, RES // 8, RES // 8, 4)).astype(np.float32)

    def jax_forward(p, x):
        post = model.apply({"params": p}, x, method=JaxVAE.encode)
        z = post.mean + post.std * eps
        return model.apply({"params": p}, z, method=JaxVAE.decode), post.mean

    want, want_mean = jax.jit(jax_forward)(params, x)
    monkeypatch.setattr(DiagonalGaussian, "sample",
                        lambda self, generator: self.mean
                        + torch.exp(0.5 * self.logvar)
                        * torch.from_numpy(eps))
    with torch.no_grad():
        recon, post = port(torch.from_numpy(x), torch.Generator())
    assert _mse(post.mean.numpy(), want_mean) < 1e-10
    assert _mse(recon.numpy(), want) < 1e-10


def test_forward_draws_from_its_generator():
    _, _, port = _vae_pair(False)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, size=(1, RES, RES, 3)).astype(np.float32))
    with torch.no_grad():
        a, _ = port(x, torch.Generator().manual_seed(1))
        b, _ = port(x, torch.Generator().manual_seed(1))
        c, _ = port(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_decode_scaled_inverts_encode_scaled():
    cfg = default_flux_vae_config()
    z = np.random.default_rng(6).normal(size=(1, 2, 2, 16)).astype(
        np.float32)
    np.testing.assert_allclose(decode_scaled(torch.from_numpy(z), cfg)
                               .numpy(), np.asarray(jax_dscaled(z, cfg)),
                               rtol=1e-6)


@pytest.mark.parametrize("cin,cout,up", [(16, 8, True), (8, 8, False)])
def test_up_decoder_block_and_upsample_match_jax(cin, cout, up):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 4, 6, cin)).astype(np.float32)
    block = JaxUpBlock(out_channels=cout, num_layers=3, add_upsample=up,
                       num_groups=4)
    params = _perturb(jax.device_get(jax.jit(block.init)(
        jax.random.key(0), x)["params"]), 8)
    want = jax.jit(block.apply)({"params": params}, x)
    port = UpDecoderBlock(cin, cout, 3, up, num_groups=4)
    port.load_state_dict(torch_state_from_jax_params(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape
    assert _mse(got.numpy(), want) < 1e-10
    us = JaxUpsample(out_channels=cout)
    uparams = _perturb(jax.device_get(jax.jit(us.init)(
        jax.random.key(1), x[..., :cout])["params"]), 9)
    uport = Upsample(cout)
    uport.load_state_dict(torch_state_from_jax_params(uparams), strict=True)
    with torch.no_grad():
        ugot = uport(torch.from_numpy(x[..., :cout]))
    np.testing.assert_allclose(
        ugot.numpy(), np.asarray(jax.jit(us.apply)({"params": uparams},
                                                   x[..., :cout])),
        rtol=1e-5, atol=1e-5)


def test_jax_export_loads_with_its_decoder(tmp_path, capsys):
    """The JAX package's diffusers export: every key lands in the port's
    full VAE (no key reported missing or unexpected), and the decode
    agrees; an encode-only load skips the decoder's keys."""
    model, params, _ = _vae_pair(True)
    jax_save_vae(params, model.config, str(tmp_path / "jax_vae"))
    path = str(tmp_path / "jax_vae" / "diffusion_pytorch_model.safetensors")
    cfg_path = str(tmp_path / "jax_vae" / "config.json")
    capsys.readouterr()
    full = load_vae(path, cfg_path, with_decoder=True).eval()
    said = capsys.readouterr().out
    assert "missing keys" not in said and "unexpected keys" not in said
    saved = load_state_file(path)
    assert set(saved) == set(full.state_dict())
    z = np.random.default_rng(10).normal(size=(1, 4, 4, 4)).astype(
        np.float32)
    want = jax.jit(lambda p, z: model.apply({"params": p}, z,
                                            method=JaxVAE.decode))(params, z)
    with torch.no_grad():
        assert _mse(full.decode(torch.from_numpy(z)).numpy(), want) < 1e-10
    enc = load_vae(path, cfg_path)
    said = capsys.readouterr().out
    assert enc.decoder is None and enc.post_quant_conv is None
    assert "unexpected keys" not in said
    assert not any(k.startswith(("decoder.", "post_quant_conv."))
                   for k in enc.state_dict())
    with pytest.raises(RuntimeError, match="without its decoder"):
        enc.decode(torch.zeros(1, 4, 4, 4))


def test_save_and_load_round_trip_keeps_the_decoder(tmp_path):
    _, _, port = _vae_pair(True)
    save_vae_pretrained(port, port.config, str(tmp_path / "vae"))
    back = load_vae(str(tmp_path / "vae" /
                        "diffusion_pytorch_model.safetensors"),
                    str(tmp_path / "vae" / "config.json"), with_decoder=True)
    want = port.state_dict()
    got = back.state_dict()
    assert set(got) == set(want)
    dec = [k for k in want if k.startswith(("decoder.", "post_quant_conv."))]
    assert len(dec) > 50
    for k in want:
        assert torch.equal(got[k], want[k]), k
