"""Each kernel module of the PyTorch port against the JAX Pallas kernel it
replaces.

The Pallas kernels run in TPU interpret mode on the CPU, as the JAX
package's own tests run them; the port's wrappers get CPU tensors, so they
take their plain PyTorch versions (the CUDA kernels are checked against the
same plain versions on the card by chip_smoke.py).  Inputs come from numpy
with a seed; everything is fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vae_tagger_tpu.ops.conv import effective_affine as jax_effective_affine
from vae_tagger_tpu.ops.conv import group_stats as jax_group_stats
from vae_tagger_tpu.ops.pallas.conv_fused import gn_silu_conv3x3_pallas
from vae_tagger_tpu.ops.pallas.flash_attention import _flash_attention_fwd_impl
from vae_tagger_tpu.ops.pallas.groupnorm_silu import (
    group_norm_silu_chunked_pallas,
    group_norm_silu_pallas,
)
from vae_tagger_tpu_torch.ops import backend
from vae_tagger_tpu_torch.ops.attention import flash_attention_fwd
from vae_tagger_tpu_torch.ops.conv import gn_silu_conv3x3
from vae_tagger_tpu_torch.ops.normalization import (
    group_norm_affine,
    group_norm_silu,
    group_stats,
)

GROUPS = 32


@pytest.fixture(autouse=True)
def _fp32_exact():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backend.reset_launch_counts()
    yield
    # CPU tensors never reach a kernel
    assert sum(backend.launch_counts().values()) == 0


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("form", ["whole", "chunked"])
@pytest.mark.parametrize("hw", [8, 16])
@pytest.mark.parametrize("apply_silu", [True, False])
def test_group_norm_silu_matches_pallas(form, hw, apply_silu):
    rng = np.random.default_rng(hw)
    x = rng.normal(size=(2, hw, hw, 128)).astype(np.float32) + 0.3
    scale = (rng.normal(size=(128,)) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(128,)) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        if form == "whole":
            ref = group_norm_silu_pallas(
                jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                num_groups=GROUPS, apply_silu=apply_silu)
        else:
            ref = group_norm_silu_chunked_pallas(
                jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                num_groups=GROUPS, tile=64, apply_silu=apply_silu)
    out = group_norm_silu(_t(x), _t(scale), _t(bias), num_groups=GROUPS,
                          apply_silu=apply_silu)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_group_stats_and_affine_match_jax():
    """The stats pass the fused conv uses (group_stats + effective_affine)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 128)).astype(np.float32)
    gs = (rng.normal(size=(128,)) * 0.2 + 1.0).astype(np.float32)
    gb = (rng.normal(size=(128,)) * 0.1).astype(np.float32)
    mean, meansq = jax_group_stats(jnp.asarray(x), GROUPS)
    es, eb = jax_effective_affine(mean, meansq, jnp.asarray(gs),
                                  jnp.asarray(gb), 128, 1e-6)
    tm, tq = group_stats(_t(x), GROUPS)
    tes, teb = group_norm_affine(_t(x), _t(gs), _t(gb), num_groups=GROUPS)
    for got, want in [(tm, mean), (tq, meansq), (tes, es), (teb, eb)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("variant", ["plain", "residual", "shortcut"])
def test_gn_silu_conv3x3_matches_pallas(variant):
    rng = np.random.default_rng(7)
    c_in = 128
    c_out = 256 if variant == "shortcut" else 128
    x = rng.normal(size=(2, 8, 8, c_in)).astype(np.float32)
    gs = (rng.normal(size=(c_in,)) * 0.2 + 1.0).astype(np.float32)
    gb = (rng.normal(size=(c_in,)) * 0.1).astype(np.float32)
    k = (rng.normal(size=(3, 3, c_in, c_out)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(c_out,)) * 0.1).astype(np.float32)
    res = sck = scb = None
    if variant == "residual":
        res = rng.normal(size=(2, 8, 8, c_out)).astype(np.float32)
    if variant == "shortcut":
        res = rng.normal(size=(2, 8, 8, c_in)).astype(np.float32)
        sck = (rng.normal(size=(1, 1, c_in, c_out)) * 0.1).astype(np.float32)
        scb = (rng.normal(size=(c_out,)) * 0.1).astype(np.float32)

    def j(a):
        return None if a is None else jnp.asarray(a)

    mean, meansq = jax_group_stats(j(x), GROUPS)
    es, eb = jax_effective_affine(mean, meansq, j(gs), j(gb), c_in, 1e-6)
    with pltpu.force_tpu_interpret_mode():
        ref = gn_silu_conv3x3_pallas(j(x), es, eb, j(k), j(b), j(res),
                                     j(sck), j(scb), tile_h=4, tile_cout=128,
                                     interpret=True)

    def t(a):
        return None if a is None else _t(a)

    out = gn_silu_conv3x3(t(x), t(gs), t(gb), t(k), t(b), t(res), t(sck),
                          t(scb), num_groups=GROUPS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("sq,skv", [(300, 300), (192, 448)])
def test_flash_attention_fwd_matches_pallas(sq, skv):
    """O and the logsumexp; 300 pads to the block, 192 vs 448 is the
    rectangular (Sq != Skv) form."""
    rng = np.random.default_rng(sq + skv)
    q = rng.normal(size=(2, sq, 128)).astype(np.float32)
    k = rng.normal(size=(2, skv, 128)).astype(np.float32)
    v = rng.normal(size=(2, skv, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref_o, ref_lse = _flash_attention_fwd_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
            block_k=128)
    out, lse = flash_attention_fwd(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_o), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=2e-4,
                               atol=2e-4)


def test_cuda_tensor_policy(monkeypatch):
    """Backend 'kernel' launches for CUDA tensors only; 'torch' never."""

    class FakeCuda:
        is_cuda = True

    class FakeCpu:
        is_cuda = False

    assert backend.use_kernel(FakeCuda())
    assert not backend.use_kernel(FakeCpu())
    with backend.backend("torch"):
        assert not backend.use_kernel(FakeCuda())
    with pytest.raises(ValueError):
        backend.set_backend("pallas")
    assert backend.get_backend() == "kernel"
