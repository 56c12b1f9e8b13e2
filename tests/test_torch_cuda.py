"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips on a host without a CUDA device (decided
inside the fixture, never at import).  Run on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Shapes here are small and deliberately ragged (channel counts that are not
multiples of the kernels' tiles, sequences that are not multiples of the
key tile); chip_smoke.py covers the encode path's full shapes.  Tolerances:
fp32 max relative error 1e-4; bf16 error against the plain fp32 result
within 4x the plain version's own bf16 error, floored at 1e-4.
"""

import numpy as np
import pytest
import torch

from vae_tagger_tpu_torch.core.config import default_flux_vae_config
from vae_tagger_tpu_torch.models.autoencoder_kl import AutoencoderKL
from vae_tagger_tpu_torch.nn.blocks import seeded_init_
from vae_tagger_tpu_torch.ops import backend
from vae_tagger_tpu_torch.ops.attention import flash_attention_fwd
from vae_tagger_tpu_torch.ops.conv import gn_silu_conv3x3
from vae_tagger_tpu_torch.ops.normalization import (
    group_norm_affine,
    group_norm_silu,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _rnd(g, *shape, scale=1.0, shift=0.0):
    """bf16-representable fp32 values on the card."""
    t = torch.randn(*shape, generator=g) * scale + shift
    return t.bfloat16().float().cuda()


def _rel(a, ref):
    ref = ref.float()
    return ((a.float() - ref).abs().max() / ref.abs().max()).item()


def _check(op):
    """op(dtype) under both backends; kernel vs plain in fp32 and bf16."""
    def run(dt, name):
        with backend.backend(name):
            out = op(dt)
        torch.cuda.synchronize()
        return out if isinstance(out, tuple) else (out,)

    backend.reset_launch_counts()
    p32, k32 = run(torch.float32, "torch"), run(torch.float32, "kernel")
    p16, k16 = run(torch.bfloat16, "torch"), run(torch.bfloat16, "kernel")
    assert sum(backend.launch_counts().values()) > 0
    for i, ref in enumerate(p32):
        assert _rel(k32[i], ref) <= 1e-4
        assert _rel(k16[i], ref) <= max(4 * _rel(p16[i], ref), 1e-4)


@pytest.mark.parametrize("shape", [(2, 33, 17, 96), (1, 64, 64, 512)])
@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_silu_kernel(gen, shape, silu):
    x = _rnd(gen, *shape, shift=0.5)
    sc = _rnd(gen, shape[-1], scale=0.2, shift=1.0)
    bi = _rnd(gen, shape[-1], scale=0.1)
    _check(lambda dt: group_norm_silu(x.to(dt), sc, bi, num_groups=32,
                                      apply_silu=silu))
    _check(lambda dt: group_norm_affine(x.to(dt), sc, bi, num_groups=32))


@pytest.mark.parametrize("n,h,w,cin,cout,variant", [
    (2, 8, 8, 128, 128, "plain"),
    (1, 9, 13, 64, 64, "residual"),
    (2, 7, 11, 64, 96, "shortcut"),
    (1, 16, 16, 40, 136, "shortcut"),
])
def test_gn_silu_conv3x3_kernel(gen, n, h, w, cin, cout, variant):
    groups = 8
    x = _rnd(gen, n, h, w, cin)
    gs = _rnd(gen, cin, scale=0.2, shift=1.0)
    gb = _rnd(gen, cin, scale=0.1)
    k = _rnd(gen, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    b = _rnd(gen, cout, scale=0.1)
    res = sck = scb = None
    if variant == "residual":
        res = _rnd(gen, n, h, w, cout)
    if variant == "shortcut":
        res = _rnd(gen, n, h, w, cin)
        sck = _rnd(gen, cin, cout, scale=cin ** -0.5)
        scb = _rnd(gen, cout, scale=0.1)
    _check(lambda dt: gn_silu_conv3x3(
        x.to(dt), gs, gb, k, b, None if res is None else res.to(dt), sck,
        scb, num_groups=groups))


@pytest.mark.parametrize("b,sq,skv,d", [(2, 300, 300, 128),
                                        (1, 100, 260, 64),
                                        (1, 1024, 1024, 512)])
def test_flash_attention_fwd_kernel(gen, b, sq, skv, d):
    q, k, v = _rnd(gen, b, sq, d), _rnd(gen, b, skv, d), _rnd(gen, b, skv, d)
    _check(lambda dt: flash_attention_fwd(q.to(dt), k.to(dt), v.to(dt)))


def test_encoder_kernel_path_matches_plain_path(gen):
    """A narrow VAE through every kernel on the card: fp32 latents of the
    kernel path against the plain path."""
    cfg = default_flux_vae_config(block_out_channels=(32, 32, 64, 64),
                                  norm_num_groups=8, latent_channels=16)
    vae = seeded_init_(AutoencoderKL(cfg), 3).cuda().eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, size=(2, 64, 64, 3)).astype(np.float32)).cuda()
    backend.reset_launch_counts()
    with torch.inference_mode():
        lat_k = vae.encode(x).mean
        counts = backend.launch_counts()
        with backend.backend("torch"):
            lat_t = vae.encode(x).mean
    assert counts["gn_silu_conv3x3"] == 20 and counts[
        "flash_attention_fwd"] == 1 and counts["group_norm_silu"] == 2
    assert float(((lat_k - lat_t) ** 2).mean()) < 1e-10
