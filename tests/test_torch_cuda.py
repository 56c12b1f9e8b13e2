"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips on a host without a CUDA device (decided
inside the fixture, never at import).  Run on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Shapes here are small and deliberately ragged (channel counts that are not
multiples of the kernels' tiles, sequences that are not multiples of the
key tile, images narrower or wider than one pixel tile); chip_smoke.py
covers the encode path's full shapes.  Each check runs both dtypes (the
attention forward takes head widths 512 and 384, the backward 512 alone,
other widths raise): bf16
goes to the tensor-core kernels B', C', D' and E', fp32 to the 3xTF32
tensor-core kernels B'', C'', D'' and E''.
Tolerances: fp32 max relative error 1e-4 (1e-5 for B'' and C''); bf16
error against the plain fp32 result within 4x the plain version's own bf16
error, floored at 1e-4.
"""

import numpy as np
import pytest
import torch

from vae_tagger_tpu_torch.core.config import default_flux_vae_config
from vae_tagger_tpu_torch.models.autoencoder_kl import AutoencoderKL
from vae_tagger_tpu_torch.nn.blocks import seeded_init_
from vae_tagger_tpu_torch.ops import backend
from vae_tagger_tpu_torch.ops.attention import (
    bwd_delta,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
)
from vae_tagger_tpu_torch.ops.conv import (
    gn_silu_conv3x3,
    gn_silu_conv3x3_plain,
    gn_silu_conv3x3_vjp,
    rms_silu_conv3x3,
    tc_kernel_attrs,
)
from vae_tagger_tpu_torch.ops.normalization import (
    effective_affine,
    group_norm_affine,
    EXACT_SILU,
    group_norm_silu,
    group_norm_silu_apply,
    group_norm_silu_backward,
    group_stats,
    group_stats_plain,
    rms_norm_silu,
    rms_norm_silu_apply,
    rms_norm_stats,
    rms_stats_plain,
    vjp_of_plain,
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


def _check(op, dtypes=(torch.float32, torch.bfloat16), tol32=1e-4):
    """op(dtype) under both backends; kernel vs plain in each of dtypes
    (fp32 to rel tol32)."""
    def run(dt, name):
        with backend.backend(name):
            out = op(dt)
        torch.cuda.synchronize()
        return out if isinstance(out, tuple) else (out,)

    backend.reset_launch_counts()
    p32 = run(torch.float32, "torch")
    k32 = run(torch.float32, "kernel") if torch.float32 in dtypes else None
    if torch.bfloat16 in dtypes:
        p16, k16 = run(torch.bfloat16, "torch"), run(torch.bfloat16, "kernel")
    assert sum(backend.launch_counts().values()) > 0
    for i, ref in enumerate(p32):
        if k32 is not None:
            assert _rel(k32[i], ref) <= tol32
        if torch.bfloat16 in dtypes:
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


@pytest.mark.parametrize("shape", [(2, 33, 17, 96), (2, 9, 13, 30)])
def test_apply_pass_exact_silu(gen, shape):
    """A's apply pass with the exact SiLU (kernel B'''s input), 16-byte
    vectors and one element a thread (C = 30): within 4 ulp of the fp64
    SiLU of the same fp32 affine, another instance than the SFU's SiLU,
    repeating bit for bit; bf16 refuses it."""
    x = _rnd(gen, *shape, shift=0.5)
    es = _rnd(gen, shape[0], shape[-1], scale=0.5, shift=1.0)
    eb = _rnd(gen, shape[0], shape[-1], scale=2.0)
    y = (x.double() * es[:, None, None].double()
         + eb[:, None, None].double()).float().double()
    want = y * torch.sigmoid(y)
    backend.reset_launch_counts()
    exact = group_norm_silu_apply(x, es, eb, apply_silu=EXACT_SILU)
    fast = group_norm_silu_apply(x, es, eb)
    assert torch.equal(exact, group_norm_silu_apply(x, es, eb,
                                                    apply_silu=EXACT_SILU))
    torch.cuda.synchronize()
    assert backend.launch_counts()["group_norm_silu"] == 3
    ulp = 2.0 ** -23 * want.abs().clamp_min(2.0 ** -126)
    # the affine's fma rounds once where the reference rounds it once too
    assert ((exact.double() - want).abs() <= 4 * ulp + 1e-7).all()
    assert not torch.equal(exact, fast)
    with pytest.raises(RuntimeError):
        group_norm_silu_apply(x.bfloat16(), es, eb, apply_silu=EXACT_SILU)


@pytest.mark.parametrize("shape,groups", [
    # S = 533,027: not a multiple of any row span of the plan
    ((3, 517, 1031, 64), 32),
    # more samples than the arrival counters first allocated (64)
    ((70, 3, 5, 32), 8),
    # C = 4,096: 512 bf16 vectors a row (two strips of 256), 1,024 fp32
    # ones (four strips)
    ((2, 5, 7, 4096), 32),
    # C = 300 in bf16: one element a thread, two strips, a group of 100
    # channels across them
    ((2, 9, 11, 300), 3),
])
def test_group_norm_kernel_ragged(gen, shape, groups):
    """Kernel A at shapes the plan cuts unevenly: ragged spans, many
    samples, rows wider than one strip of 256 vectors, C not a multiple of
    the vector (one element a thread)."""
    x = _rnd(gen, *shape, shift=0.5)
    sc = _rnd(gen, shape[-1], scale=0.2, shift=1.0)
    bi = _rnd(gen, shape[-1], scale=0.1)
    _check(lambda dt: group_norm_silu(x.to(dt), sc, bi, num_groups=groups))
    _check(lambda dt: group_norm_affine(x.to(dt), sc, bi,
                                        num_groups=groups))
    _check(lambda dt: group_stats(x.to(dt), groups))


def test_group_norm_kernel_misaligned(gen):
    """A contiguous view whose data pointer is 2 (bf16) or 4 (fp32) bytes
    off a 16-byte boundary takes the kernel's one-element path, not the
    plain version, and agrees with the plain version."""
    shape = (2, 19, 23, 128)
    x = _rnd(gen, *shape, shift=0.5)
    sc = _rnd(gen, 128, scale=0.2, shift=1.0)
    bi = _rnd(gen, 128, scale=0.1)

    def off(dt):
        flat = torch.empty(1 + x.numel(), dtype=dt, device="cuda")
        view = flat[1:].view(shape)
        view.copy_(x)
        assert view.data_ptr() % 16 and view.is_contiguous()
        return view

    _check(lambda dt: group_norm_silu(off(dt), sc, bi, num_groups=32))
    assert backend.launch_counts()["group_norm_silu"] == 2
    _check(lambda dt: group_norm_affine(off(dt), sc, bi, num_groups=32))
    assert backend.launch_counts()["group_stats"] == 2


def test_group_norm_kernel_repeats_bit_for_bit(gen):
    """No float atomics, and the arrival counters are left at zero: two
    launches of the stats pass and of GroupNorm+SiLU on the same inputs,
    in bf16 and fp32, give bit-identical outputs."""
    x = _rnd(gen, 2, 67, 45, 512, shift=0.5)
    sc = _rnd(gen, 512, scale=0.2, shift=1.0)
    bi = _rnd(gen, 512, scale=0.1)
    backend.reset_launch_counts()
    for dt in (torch.bfloat16, torch.float32):
        xd = x.to(dt)
        calls = (lambda: group_stats(xd, 32),
                 lambda: group_norm_affine(xd, sc, bi, num_groups=32),
                 lambda: group_norm_silu(xd, sc, bi, num_groups=32))
        for call in calls:
            first, second = call(), call()
            first = first if isinstance(first, tuple) else (first,)
            second = second if isinstance(second, tuple) else (second,)
            for a, b in zip(first, second):
                assert torch.equal(a, b)
    counts = backend.launch_counts()
    assert counts["group_stats"] == 8 and counts["group_norm_silu"] == 4


def _gn_bwd_inputs(gen, shape, groups):
    """x, dAct, scale, x's fp32 statistics and their effective affine."""
    x = _rnd(gen, *shape, shift=0.3)
    d = _rnd(gen, *shape)
    sc = _rnd(gen, shape[-1], scale=0.2, shift=1.0)
    bi = _rnd(gen, shape[-1], scale=0.1)
    mean, meansq = group_stats_plain(x, groups)
    return x, d, sc, mean, meansq, *effective_affine(mean, meansq, sc, bi,
                                                     shape[-1], 1e-6)


@pytest.mark.parametrize("shape,groups", [
    # ragged spans, C a multiple of both vectors
    ((2, 33, 17, 96), 8),
    # C = 36: one element a thread in bf16, 4-wide vectors in fp32
    ((2, 9, 13, 36), 4),
    # C = 300 in bf16: one element a thread, two strips
    ((2, 9, 11, 300), 3),
    # C = 4,096: two strips of 256 bf16 vectors, four of fp32 ones
    ((2, 5, 7, 4096), 32),
    # N = 5: the fold over samples sums more than two rows
    ((5, 9, 13, 96), 8),
    # S below one span, C = 36 and C = 300 (one element a thread in bf16)
    ((2, 3, 5, 36), 4),
    ((2, 1, 3, 300), 3),
    # 17 (bf16) and 34 (fp32) spans a sample: the fold's groups of 16
    # spans, the last one ragged
    ((2, 64, 67, 32), 8),
])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("stats_term", [True, False])
def test_group_norm_silu_backward_kernel(gen, shape, groups, silu,
                                         stats_term):
    """Kernel F against its plain version at small ragged shapes, every
    output (dx, dscale, dbias, and dmean, dmeansq without the statistics'
    term), fp32 within 1e-5; one launch counted a call."""
    x, d, sc, mean, meansq, es, eb = _gn_bwd_inputs(gen, shape, groups)

    def op(dt):
        out = group_norm_silu_backward(x.to(dt), d.to(dt), mean, meansq, sc,
                                       es, eb, apply_silu=silu,
                                       stats_term=stats_term)
        return tuple(t for t in out if t is not None)

    _check(op, tol32=1e-5)
    assert backend.launch_counts()["group_norm_silu_bwd"] == 2


def test_group_norm_silu_backward_kernel_misaligned_and_repeats(gen):
    """Kernel F on a view 2 (bf16) or 4 (fp32) bytes off a 16-byte
    boundary (one element a thread, C = 512: two strips) agrees with its
    plain version; two launches on the same inputs are bit-identical."""
    shape = (2, 19, 23, 512)
    x, d, sc, mean, meansq, es, eb = _gn_bwd_inputs(gen, shape, 32)

    def off(t, dt):
        flat = torch.empty(1 + t.numel(), dtype=dt, device="cuda")
        view = flat[1:].view(shape)
        view.copy_(t)
        assert view.data_ptr() % 16 and view.is_contiguous()
        return view

    def op(dt):
        return group_norm_silu_backward(off(x, dt), d.to(dt), mean, meansq,
                                        sc, es, eb)[:3]

    _check(op, tol32=1e-5)
    for dt in (torch.bfloat16, torch.float32):
        first, second = op(dt), op(dt)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stats_term", [True, False])
def test_group_norm_silu_backward_is_two_kernels_bit_for_bit(gen, dtype,
                                                             stats_term):
    """One call of kernel F at N = 5 (16-byte vectors) launches exactly its
    two kernels, the reduce pass with its fold and the apply pass, and no
    other kernel (torch.profiler); two calls on the same inputs are
    bit-identical."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, d, sc, mean, meansq, es, eb = _gn_bwd_inputs(gen, (5, 17, 19, 128),
                                                    32)

    def op():
        return tuple(t for t in group_norm_silu_backward(
            x.to(dtype), d.to(dtype), mean, meansq, sc, es, eb,
            stats_term=stats_term) if t is not None)

    xs, ds = x.to(dtype), d.to(dtype)
    first = op()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        second = group_norm_silu_backward(xs, ds, mean, meansq, sc, es, eb,
                                          stats_term=stats_term)
        torch.cuda.synchronize()
    kernels = [e.name for e in sorted(prof.events(),
                                      key=lambda e: e.time_range.start)
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 2, kernels
    assert "gn_bwd_reduce_kernel" in kernels[0], kernels
    assert "gn_bwd_apply_kernel" in kernels[1], kernels
    second = tuple(t for t in second if t is not None)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("variant", ["plain", "residual", "shortcut"])
def test_fused_site_backward_matches_vjp_of_plain(gen, variant):
    """One fused site's whole backward on the card (A's apply pass, cuDNN's
    conv backward, kernel F) against the VJP of the plain version
    recomputed (vjp_of_plain), fp32 with cuDNN's TF32 off, every input's
    gradient within 1e-4 relative to its norm; no forward conv runs."""
    n, h, w, cin = 2, 9, 13, 64
    cout = 96 if variant == "shortcut" else cin
    x = _rnd(gen, n, h, w, cin, shift=0.3)
    ins = [x, _rnd(gen, cin, scale=0.2, shift=1.0), _rnd(gen, cin, scale=0.1),
           _rnd(gen, 3, 3, cin, cout, scale=(9 * cin) ** -0.5),
           _rnd(gen, cout, scale=0.1)]
    if variant == "residual":
        ins.append(_rnd(gen, n, h, w, cout))
    if variant == "shortcut":
        ins += [_rnd(gen, n, h, w, cin), _rnd(gen, cin, cout, scale=0.125),
                _rnd(gen, cout, scale=0.1)]
    g = _rnd(gen, n, h, w, cout)
    mean, meansq = group_stats_plain(x, 8)
    backend.reset_launch_counts()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        got = gn_silu_conv3x3_vjp(g, *ins, mean=mean, meansq=meansq)
    torch.cuda.synchronize()
    assert not [e for e in prof.key_averages()
                if e.key == "aten::cudnn_convolution"]
    counts = {k: c for k, c in backend.launch_counts().items() if c}
    assert counts == {"group_norm_silu": 1, "group_norm_silu_bwd": 1}
    got = (got[0],) + got[3:3 + len(ins) - 1]
    want = vjp_of_plain(
        lambda *t: gn_silu_conv3x3_plain(*t, num_groups=8), ins, g)
    for a, b in zip(got, want):
        assert ((a - b).norm() / b.norm()).item() <= 1e-4


def _residual_operands(gen, n, h, w, cin, cout, variant):
    """(residual, shortcut kernel, shortcut bias) of a fused conv test:
    ``variant`` is "plain", "residual" or "shortcut[:Cres]" (the shortcut's
    input channels, Cin unless given)."""
    kind, _, c_res = variant.partition(":")
    c_res = int(c_res) if c_res else cin
    if kind == "residual":
        return _rnd(gen, n, h, w, cout), None, None
    if kind == "shortcut":
        return (_rnd(gen, n, h, w, c_res),
                _rnd(gen, c_res, cout, scale=c_res ** -0.5),
                _rnd(gen, cout, scale=0.1))
    return None, None, None


# B''s hand-offs between the halo stream, its activator warps and the
# consumers, at both output-channel tiles (BN = 128 up to 128 channels):
# one 64-channel chunk; more chunks than halo buffers over three or more
# pixel tiles of height; a shortcut whose residual chunks (136 channels,
# the last partial) follow an odd count of conv chunks.
B_PRIME_HANDOFFS = [
    (2, 6, 70, 64, 128, "plain"),
    (2, 6, 70, 64, 256, "plain"),
    (1, 13, 70, 512, 128, "plain"),
    (1, 9, 70, 512, 256, "residual"),
    (1, 6, 70, 192, 128, "shortcut:136"),
    (1, 6, 70, 192, 256, "shortcut:136"),
]


@pytest.mark.parametrize("n,h,w,cin,cout,variant", [
    (2, 8, 8, 128, 128, "plain"),
    (1, 9, 13, 64, 64, "residual"),
    (2, 7, 11, 64, 96, "shortcut"),
    (1, 16, 16, 40, 136, "shortcut"),
    # H = 1; W past one 64-pixel tile and not a multiple of it
    (1, 1, 70, 64, 64, "residual"),
    (2, 3, 130, 96, 256, "plain"),
    # three channel chunks (the last partial), two output-channel tiles
    (1, 4, 66, 136, 512, "shortcut"),
    # the decoder's: Cin > Cout (conv1 512->256, 256->128), and the 1x1
    # shortcut from more residual channels than output channels
    (1, 5, 70, 512, 256, "plain"),
    (1, 6, 66, 256, 128, "plain"),
    (1, 4, 70, 512, 256, "shortcut"),
    (1, 6, 66, 256, 128, "shortcut"),
    # an odd count of pixel tiles with two output-channel tiles; three
    # one-row images; one pixel tile alone
    (1, 5, 64, 64, 256, "residual"),
    (3, 1, 64, 64, 256, "shortcut"),
    (1, 2, 64, 32, 128, "plain"),
] + B_PRIME_HANDOFFS)
def test_gn_silu_conv3x3_kernel(gen, n, h, w, cin, cout, variant):
    groups = 8
    x = _rnd(gen, n, h, w, cin)
    gs = _rnd(gen, cin, scale=0.2, shift=1.0)
    gb = _rnd(gen, cin, scale=0.1)
    k = _rnd(gen, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    b = _rnd(gen, cout, scale=0.1)
    res, sck, scb = _residual_operands(gen, n, h, w, cin, cout, variant)
    _check(lambda dt: gn_silu_conv3x3(
        x.to(dt), gs, gb, k, b, None if res is None else res.to(dt), sck,
        scb, num_groups=groups), tol32=1e-5)
    counts = backend.launch_counts()
    assert counts["gn_silu_conv3x3_tc"] == 1
    assert counts["gn_silu_conv3x3_tf32x3"] == 1
    assert counts["gn_silu_conv3x3"] == 0


@pytest.mark.parametrize("b,sq,skv,d", [(2, 300, 300, 128),
                                        (1, 100, 260, 64),
                                        # the Wan VAE's width
                                        (2, 300, 300, 384),
                                        (1, 100, 260, 384),
                                        (2, 64, 33, 384),
                                        (1, 1024, 1024, 384),
                                        (2, 300, 300, 512),
                                        (1, 100, 260, 512),
                                        (1, 1024, 1024, 512),
                                        (2, 64, 33, 512),
                                        (1, 70, 20, 512),  # one key tile
                                        # the full sequence at 512px
                                        (1, 4096, 4096, 512)])
def test_flash_attention_fwd_kernel(gen, b, sq, skv, d):
    """Ragged Sq != Skv and sequences that are not multiples of the 64-row
    or 32-key tiles.  At the models' widths D = 512 (FLUX) and 384 (Wan)
    both dtypes (bf16 runs kernel C', fp32 kernel C'', to 1e-5); both take
    those two alone, and other widths raise in either dtype."""
    q, k, v = _rnd(gen, b, sq, d), _rnd(gen, b, skv, d), _rnd(gen, b, skv, d)
    if d not in (384, 512):
        for dt in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match="head width"):
                flash_attention_fwd(q.to(dt), k.to(dt), v.to(dt))
        return
    _check(lambda dt: flash_attention_fwd(q.to(dt), k.to(dt), v.to(dt)),
           tol32=1e-5)
    counts = backend.launch_counts()
    assert counts["flash_attention_fwd_tc"] == 1
    assert counts["flash_attention_fwd_tf32x3"] == 1
    assert counts["flash_attention_fwd"] == 0


def test_dtype_picks_the_kernel(gen):
    """Through the launch counters: bf16 runs the tensor-core kernels B'
    and C', fp32 the 3xTF32 kernels B'' and C'', and nothing else."""
    x = _rnd(gen, 1, 5, 9, 64)
    gs, gb = _rnd(gen, 64, shift=1.0), _rnd(gen, 64, scale=0.1)
    k, b = _rnd(gen, 3, 3, 64, 64, scale=0.04), _rnd(gen, 64)
    q = _rnd(gen, 1, 70, 512)
    for dt, conv_k, attn_k in ((torch.bfloat16, "gn_silu_conv3x3_tc",
                                "flash_attention_fwd_tc"),
                               (torch.float32, "gn_silu_conv3x3_tf32x3",
                                "flash_attention_fwd_tf32x3")):
        backend.reset_launch_counts()
        gn_silu_conv3x3(x.to(dt), gs, gb, k, b, num_groups=8)
        flash_attention_fwd(q.to(dt), q.to(dt), q.to(dt))
        torch.cuda.synchronize()
        launched = {n: c for n, c in backend.launch_counts().items() if c}
        assert launched == {conv_k: 1, attn_k: 1, "group_stats": 1}, launched


def test_tc_kernels_refuse_what_they_do_not_take(gen):
    """A shape that B' or C' (bf16), or B'' or C'' (fp32), refuses raises
    (no fallback to another kernel or to the plain version), and so does
    an operand off the 16-byte alignment a TMA tensor map needs."""
    backend.reset_launch_counts()
    for dt, channels, multiple in ((torch.bfloat16, 36, 8),
                                   (torch.float32, 38, 4)):
        q = _rnd(gen, 1, 40, 128).to(dt)
        with pytest.raises(ValueError, match="head width"):
            flash_attention_fwd(q, q, q)
        x = _rnd(gen, 1, 4, 4, channels).to(dt)
        with pytest.raises(ValueError, match=f"multiples of {multiple}"):
            gn_silu_conv3x3(x, _rnd(gen, channels), _rnd(gen, channels),
                            _rnd(gen, 3, 3, channels, 64), _rnd(gen, 64),
                            num_groups=2)
        flat = torch.zeros(1 + 40 * 512, dtype=dt, device="cuda")
        q = flat[1:].view(1, 40, 512)  # contiguous, 2 or 4 bytes off
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_attention_fwd(q, q, q)
    assert not any(backend.launch_counts().values())


@pytest.mark.parametrize("b,sq,skv,d", [(2, 200, 200, 128),
                                        (1, 100, 260, 64),
                                        (1, 77, 45, 512),
                                        # D' and E': Sq != Skv, neither a
                                        # multiple of the 64-row block or
                                        # the 32-row tile
                                        (3, 130, 200, 512),
                                        (2, 64, 33, 512),
                                        (1, 200, 97, 512),
                                        (1, 70, 20, 512),  # one key tile
                                        (2, 1, 45, 512),   # one query row
                                        # the full sequence at 512px
                                        (1, 4096, 4096, 512)])
def test_flash_attention_bwd_kernels(gen, b, sq, skv, d):
    """The backward kernels at ragged shapes, from the plain forward's O
    and logsumexp: fp32 runs D'' and E'', bf16 D' and E' (rows past the
    64-row block and the 32-row tile, on both sides; Sq and Skv that are
    not multiples of 8, the padding of the transposes of D'' and E'').
    Both take D = 512 alone: other widths raise in either dtype."""
    q, k, v = _rnd(gen, b, sq, d), _rnd(gen, b, skv, d), _rnd(gen, b, skv, d)
    do = _rnd(gen, b, sq, d)

    def op(dt):
        with backend.backend("torch"):
            o, lse = flash_attention_fwd(q, k, v)
        return flash_attention_bwd(q.to(dt), k.to(dt), v.to(dt), o.to(dt),
                                   lse, do.to(dt))

    if d != 512:
        for dt in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match="head width"):
                op(dt)
        return
    _check(op)
    counts = backend.launch_counts()
    assert counts["flash_attention_bwd_dq_tf32x3"] == 1
    assert counts["flash_attention_bwd_dkv_tf32x3"] == 2  # two passes
    assert counts["flash_attention_bwd_dq_tc"] == 1
    assert counts["flash_attention_bwd_dkv_tc"] == 2
    assert counts["flash_attention_bwd_dq"] == 0
    assert counts["flash_attention_bwd_dkv"] == 0


def test_dtype_picks_the_backward_kernel(gen):
    """Through the launch counters: bf16 runs D' once and E''s two passes,
    fp32 runs D'' once and the two passes of E'', and nothing else."""
    q, do = _rnd(gen, 2, 70, 512), _rnd(gen, 2, 70, 512)
    k, v = _rnd(gen, 2, 45, 512), _rnd(gen, 2, 45, 512)
    with backend.backend("torch"):
        o, lse = flash_attention_fwd(q, k, v)
    for dt, want in ((torch.bfloat16, {"flash_attention_bwd_dq_tc": 1,
                                       "flash_attention_bwd_dkv_tc": 2}),
                     (torch.float32, {"flash_attention_bwd_dq_tf32x3": 1,
                                      "flash_attention_bwd_dkv_tf32x3": 2})):
        backend.reset_launch_counts()
        flash_attention_bwd(q.to(dt), k.to(dt), v.to(dt), o.to(dt), lse,
                            do.to(dt))
        torch.cuda.synchronize()
        launched = {n: c for n, c in backend.launch_counts().items() if c}
        assert launched == want, launched


def test_tc_backward_refuses_what_it_does_not_take(gen):
    """A backward at a head width other than 512 raises, in bf16 and in
    fp32, and so does an operand off the 16-byte alignment a TMA tensor
    map needs; none falls back to the SIMT kernels or the plain version.
    D'' reads q and do as they stand and E'' k and v (the operands the
    wrapper lays out are its own, aligned); D' and E' read all four."""
    backend.reset_launch_counts()
    lse = torch.zeros(1, 40, device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        q = _rnd(gen, 1, 40, 128).to(dt)
        for fn in (flash_attention_bwd_dq, flash_attention_bwd_dkv):
            with pytest.raises(ValueError, match="head width"):
                fn(q, q, q, q, lse, lse)
        flat = torch.zeros(1 + 40 * 512, dtype=dt, device="cuda")
        bad = flat[1:].view(1, 40, 512)  # contiguous, 2 or 4 bytes off
        good = torch.zeros(1, 40, 512, dtype=dt, device="cuda")
        for args, fn in (((bad, good, good, good), flash_attention_bwd_dq),
                         ((good, good, good, bad), flash_attention_bwd_dq),
                         ((good, bad, good, good), flash_attention_bwd_dkv),
                         ((good, good, bad, good), flash_attention_bwd_dkv)):
            with pytest.raises(ValueError, match="16-byte aligned"):
                fn(*args, lse, lse)
    assert not any(backend.launch_counts().values())


def test_tc_backward_repeats_bit_for_bit(gen):
    """No float atomics: two launches of D' and of E' (bf16), and of D''
    and E'' (fp32), on the same inputs give bit-identical outputs."""
    q, do = _rnd(gen, 2, 300, 512), _rnd(gen, 2, 300, 512)
    k, v = _rnd(gen, 2, 260, 512), _rnd(gen, 2, 260, 512)
    with backend.backend("torch"):
        o, lse = flash_attention_fwd(q, k, v)
    delta = bwd_delta(o, do)
    backend.reset_launch_counts()
    for dt in (torch.bfloat16, torch.float32):
        args = tuple(t.to(dt) for t in (q, k, v, do))
        first = (flash_attention_bwd_dq(*args, lse, delta),
                 *flash_attention_bwd_dkv(*args, lse, delta))
        second = (flash_attention_bwd_dq(*args, lse, delta),
                  *flash_attention_bwd_dkv(*args, lse, delta))
        for a, b in zip(first, second):
            assert torch.equal(a, b)
    counts = backend.launch_counts()
    assert counts["flash_attention_bwd_dq_tc"] == 2
    assert counts["flash_attention_bwd_dq_tf32x3"] == 2


def test_bf16_attention_gradients(gen):
    """The bf16 autograd path (C' forward, D' and E' backward): gradients
    against the plain fp32 path within 4x the plain bf16 path's own error."""
    q, k, v = (_rnd(gen, 2, 200, 512) for _ in range(3))
    g = _rnd(gen, 2, 200, 512)

    def grads(dt, name):
        ins = [t.to(dt).requires_grad_() for t in (q, k, v)]
        with backend.backend(name):
            out = flash_attention(*ins)
            return torch.autograd.grad(out, ins, g.to(dt))

    backend.reset_launch_counts()
    got = grads(torch.bfloat16, "kernel")
    assert backend.launch_counts()["flash_attention_bwd_dkv_tc"] == 2
    ref, plain = grads(torch.float32, "torch"), grads(torch.bfloat16, "torch")
    for a, r, p in zip(got, ref, plain):
        err, own = _rel(a, r), _rel(p, r)
        assert err <= 4 * own, (err, own)


def test_kernel_gradients_match_torch_backend(gen):
    """Outputs of kernels A, B and C carry a grad_fn, and the gradients of
    each op through the kernel path match the torch backend in fp32."""
    from vae_tagger_tpu_torch.ops.normalization import group_norm_silu

    def leaf(*shape, **kw):
        return _rnd(gen, *shape, **kw).requires_grad_()

    x = leaf(2, 9, 13, 64, shift=0.3)
    gs, gb = leaf(64, scale=0.2, shift=1.0), leaf(64, scale=0.1)
    k, b = leaf(3, 3, 64, 96, scale=(9 * 64) ** -0.5), leaf(96, scale=0.1)
    sck, scb = leaf(64, 96, scale=0.125), leaf(96, scale=0.1)
    q, kk, v = leaf(2, 100, 512), leaf(2, 130, 512), leaf(2, 130, 512)
    cases = [
        (lambda: group_norm_silu(x, gs, gb, num_groups=8), (x, gs, gb)),
        (lambda: gn_silu_conv3x3(x, gs, gb, k, b, x, sck, scb, num_groups=8),
         (x, gs, gb, k, b, sck, scb)),
        (lambda: flash_attention(q, kk, v), (q, kk, v)),
    ]
    for fn, inputs in cases:
        backend.reset_launch_counts()
        out = fn()
        assert out.grad_fn is not None
        g = torch.randn(out.shape, generator=gen).cuda()
        got = torch.autograd.grad(out, inputs, g)
        assert sum(backend.launch_counts().values()) > 0
        with backend.backend("torch"):
            want = torch.autograd.grad(fn(), inputs, g)
        for a, w in zip(got, want):
            rel = ((a - w).norm() / w.norm()).item()
            assert rel <= 1e-4, rel


def test_encoder_kernel_path_matches_plain_path(gen):
    """A narrow VAE through every kernel on the card: fp32 latents of the
    kernel path (B'' and C'') against the plain path.  The last block is
    512 wide, the mid-block attention's head width, the one C'' takes."""
    cfg = default_flux_vae_config(block_out_channels=(32, 32, 64, 512),
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
    assert counts["gn_silu_conv3x3_tf32x3"] == 20 and counts[
        "flash_attention_fwd_tf32x3"] == 1 and counts["group_norm_silu"] == 2
    assert counts["gn_silu_conv3x3"] == 0 and counts["flash_attention_fwd"] == 0
    assert float(((lat_k - lat_t) ** 2).mean()) < 1e-10


def _narrow_vae(seed):
    """A narrow VAE with its decoder: the last block 512 wide (the
    attention's head width), 8 groups."""
    cfg = default_flux_vae_config(block_out_channels=(32, 32, 64, 512),
                                  norm_num_groups=8, latent_channels=16)
    return seeded_init_(AutoencoderKL(cfg, with_decoder=True), seed).cuda()


def test_decoder_kernel_path_matches_plain_path(gen):
    """The decoder through every kernel on the card: 14 ResnetBlocks (28
    fused convs, each with its stats pass), the mid-block attention and
    two GroupNorms; fp32 reconstruction of the kernel path against the
    plain path (MSE < 1e-10, the encoder's gate), bf16 within 4x the plain
    bf16 path's own MSE."""
    vae = _narrow_vae(4).eval()
    z = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 8, 8, 16)).astype(np.float32)).cuda()
    backend.reset_launch_counts()
    with torch.inference_mode():
        rec_k = vae.decode(z)
        counts = backend.launch_counts()
        rec_k16 = vae.decode(z, torch.bfloat16)
        with backend.backend("torch"):
            rec_t = vae.decode(z)
            rec_t16 = vae.decode(z, torch.bfloat16)
    assert counts["gn_silu_conv3x3_tf32x3"] == 28
    assert counts["group_stats"] == 28 and counts["group_norm_silu"] == 2
    assert counts["flash_attention_fwd_tf32x3"] == 1
    assert rec_k.shape == (1, 64, 64, 3)
    assert float(((rec_k - rec_t) ** 2).mean()) < 1e-10
    mse16 = float(((rec_k16 - rec_t) ** 2).mean())
    assert mse16 <= 4 * float(((rec_t16 - rec_t) ** 2).mean())


def test_vae_step_gradients_match_torch_backend(gen):
    """One fp32 train_vae step's loss and gradients, every encoder and
    decoder parameter, kernel path against the torch backend (relative
    1e-3, as chip_smoke.py's gate; absolute where the torch path's norm is
    below 1e-8, the structurally zero key-projection bias)."""
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.train.state import TrainState
    from vae_tagger_tpu_torch.train.steps import (
        VaeSteps,
        batch_to_device,
        step_generators,
    )

    vae = _narrow_vae(5).train()
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
             for k in ("anchor", "positive", "negative")}
    batch["labels"] = batch["positive_labels"] = np.ones((1, 4), np.float32)
    batch = batch_to_device(batch, torch.device("cuda"))
    steps = VaeSteps(LossConfig(reconstruction_weight=1.0),
                     use_simplified=False)
    state = TrainState(vae=vae, decoder=None, optimizer=None)
    grads = {}
    for be in ("kernel", "torch"):
        vae.zero_grad(set_to_none=True)
        g, g_recon = step_generators(torch.device("cuda"), 0, 3)
        with backend.backend(be):
            total, _, _ = steps.forward_losses(state, batch, g, train=True,
                                               recon_generator=g_recon)
            total.backward()
        grads[be] = {n: p.grad.clone() for n, p in vae.named_parameters()}
    assert any(n.startswith("decoder.") for n in grads["kernel"])
    for n, gt in grads["torch"].items():
        diff, norm = (grads["kernel"][n] - gt).norm().item(), gt.norm().item()
        assert (diff / norm if norm >= 1e-8 else diff) <= 1e-3, n


def test_tf32x3_repeats_bit_for_bit(gen):
    """No float atomics: two launches of B'' and of C'' on the same fp32
    inputs give bit-identical outputs."""
    x = _rnd(gen, 2, 7, 70, 64)
    gs, gb = _rnd(gen, 64, shift=1.0), _rnd(gen, 64, scale=0.1)
    k, b = _rnd(gen, 3, 3, 64, 136, scale=0.04), _rnd(gen, 136)
    res, sck = _rnd(gen, 2, 7, 70, 64), _rnd(gen, 64, 136, scale=0.1)
    q, kv = _rnd(gen, 2, 300, 512), _rnd(gen, 2, 260, 512)
    calls = (lambda: gn_silu_conv3x3(x, gs, gb, k, b, res, sck, b,
                                     num_groups=8),
             lambda: flash_attention_fwd(q, kv, kv))
    backend.reset_launch_counts()
    for call in calls:
        first, second = call(), call()
        first = first if isinstance(first, tuple) else (first,)
        second = second if isinstance(second, tuple) else (second,)
        for a, b_ in zip(first, second):
            assert torch.equal(a, b_)
    counts = backend.launch_counts()
    assert counts["gn_silu_conv3x3_tf32x3"] == 2
    assert counts["flash_attention_fwd_tf32x3"] == 2


@pytest.mark.parametrize("norm", ["gn", "rms"])
@pytest.mark.parametrize("cout", [128, 256])
def test_b_prime_repeats_bit_for_bit(gen, norm, cout):
    """Ten launches of B' on one input give bit-identical outputs, in each
    prologue mode and at each output-channel tile: its activator warps and
    its wgmma hand tiles over without a race.  Three conv chunks and three
    shortcut chunks, three pixel tiles of height, two of width."""
    n, h, w, cin, c_res = 2, 9, 70, 192, 136
    x = _rnd(gen, n, h, w, cin).bfloat16()
    k = _rnd(gen, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    b = _rnd(gen, cout, scale=0.1)
    res, sck, scb = _residual_operands(gen, n, h, w, cin, cout,
                                       f"shortcut:{c_res}")
    res = res.bfloat16()
    if norm == "gn":
        gs, gb = _rnd(gen, cin, scale=0.2, shift=1.0), _rnd(gen, cin)

        def call():
            return gn_silu_conv3x3(x, gs, gb, k, b, res, sck, scb,
                                   num_groups=8)
    else:
        gamma = _rnd(gen, cin, scale=0.2, shift=1.0)

        def call():
            return rms_silu_conv3x3(x, gamma, k, b, res, sck, scb)
    backend.reset_launch_counts()
    first = call()
    for _ in range(9):
        assert torch.equal(call(), first)
    counter = {"gn": "gn_silu_conv3x3_tc", "rms": "rms_silu_conv3x3_tc"}
    assert backend.launch_counts()[counter[norm]] == 10


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrappers_launch_on_their_tensors_device(gen, dtype):
    """Every wrapper launches on its input's device, not the current one:
    A, the stats pass, B'/B'', C'/C'' and D'/D'', E'/E'' on cuda:1 while
    cuda:0 is current, held to the same kernels on cuda:0 (the same
    kernels on the same card model: bit-equal).  Needs two GPUs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    x = _rnd(gen, 2, 24, 20, 64).to(dtype)
    scale, bias = _rnd(gen, 64) + 1, _rnd(gen, 64)
    kern, kb = _rnd(gen, 3, 3, 64, 64) * 0.05, _rnd(gen, 64)
    q, k, v = (_rnd(gen, 1, 200, 512).to(dtype) for _ in range(3))
    do = _rnd(gen, 1, 200, 512).to(dtype)

    def run(dev):
        t = [a.to(dev) for a in (x, scale, bias, kern, kb, q, k, v, do)]
        o, lse = flash_attention_fwd(t[5], t[6], t[7])
        delta = bwd_delta(o, t[8])
        outs = [group_norm_silu(t[0], t[1], t[2], num_groups=8),
                *group_stats(t[0], 8),
                gn_silu_conv3x3(t[0], t[1], t[2], t[3], t[4], num_groups=8),
                o, lse, flash_attention_bwd_dq(t[5], t[6], t[7], t[8], lse,
                                               delta),
                *flash_attention_bwd_dkv(t[5], t[6], t[7], t[8], lse, delta)]
        torch.cuda.synchronize(dev)
        return [a.float().cpu() for a in outs]

    with torch.cuda.device(0):
        want = run(torch.device("cuda", 0))
        backend.reset_launch_counts()
        got = run(torch.device("cuda", 1))
    assert sum(backend.launch_counts().values()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _two_slabs(devices=None):
    from vae_tagger_tpu_torch.parallel.spatial import SpatialMesh

    return SpatialMesh(devices or [torch.device("cuda", 0)] * 2)


def _mse(a, b):
    return float(((a.float() - b.float()) ** 2).mean())


def test_spatial_encode_and_decode_over_two_slabs_of_one_card(gen):
    """The narrow VAE's encode of a ragged 80x72 batch and its decode,
    height-sharded over two slabs of cuda:0: every kernel once a slab and
    each slab's stats pass at the A sites, B'' and B' on slabs of 40+1
    rows, C'' and C' at Sq = S/2; the fp32 kernel path against the
    unsharded one (MSE < 1e-10), bf16 within 4x the plain bf16 path's own
    MSE against the plain fp32 path."""
    vae = _narrow_vae(6).eval()
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, size=(2, 80, 72, 3)).astype(np.float32)).cuda()
    z = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 10, 9, 16)).astype(np.float32)).cuda()
    mesh = _two_slabs()
    with torch.inference_mode():
        backend.reset_launch_counts()
        lat_s = vae.encode(x, mesh).mean
        enc = backend.launch_counts()
        backend.reset_launch_counts()
        rec_s = vae.decode(z, spatial=mesh)
        dec = backend.launch_counts()
        lat, rec = vae.encode(x).mean, vae.decode(z)
        lat16_s = vae.encode(x.bfloat16(), mesh).mean
        rec16_s = vae.decode(z, torch.bfloat16, mesh)
        with backend.backend("torch"):
            lat_t, rec_t = vae.encode(x).mean, vae.decode(z)
            lat_t16 = vae.encode(x.bfloat16()).mean
            rec_t16 = vae.decode(z, torch.bfloat16)
    assert enc["gn_silu_conv3x3_tf32x3"] == 40 and enc["group_stats"] == 44
    assert enc["group_norm_silu"] == 4
    assert enc["flash_attention_fwd_tf32x3"] == 2
    assert dec["gn_silu_conv3x3_tf32x3"] == 56 and dec["group_stats"] == 60
    assert dec["group_norm_silu"] == 4
    assert dec["flash_attention_fwd_tf32x3"] == 2
    assert _mse(lat_s, lat) < 1e-10 and _mse(rec_s, rec) < 1e-10
    assert _mse(lat16_s, lat_t) <= 4 * _mse(lat_t16, lat_t)
    assert _mse(rec16_s, rec_t) <= 4 * _mse(rec_t16, rec_t)


def test_spatial_vae_step_over_two_slabs_of_one_card(gen):
    """One fp32 train_vae step with the encode and the anchor's decode on
    two slabs of cuda:0: the loss (rel 1e-5) and every gradient (rel 1e-3;
    absolute below a norm of 1e-8 and for the key projections' biases)
    against the unsharded kernel path; D'' and E'' once a slab and
    attention."""
    from vae_tagger_tpu_torch.losses.combined import LossConfig
    from vae_tagger_tpu_torch.train.state import TrainState
    from vae_tagger_tpu_torch.train.steps import (
        VaeSteps,
        batch_to_device,
        step_generators,
    )

    vae = _narrow_vae(7).train()
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, 256, (1, 48, 64, 3), dtype=np.uint8)
             for k in ("anchor", "positive", "negative")}
    batch["labels"] = batch["positive_labels"] = np.ones((1, 4), np.float32)
    batch = batch_to_device(batch, torch.device("cuda"))
    state = TrainState(vae=vae, decoder=None, optimizer=None)
    grads, losses = {}, {}
    for mode in ("plain", "spatial"):
        steps = VaeSteps(LossConfig(reconstruction_weight=1.0),
                         use_simplified=False,
                         spatial=_two_slabs() if mode == "spatial" else None)
        vae.zero_grad(set_to_none=True)
        g, g_recon = step_generators(torch.device("cuda"), 0, 3)
        backend.reset_launch_counts()
        total, _, _ = steps.forward_losses(state, batch, g, train=True,
                                           recon_generator=g_recon)
        total.backward()
        counts = backend.launch_counts()
        losses[mode] = total.item()
        grads[mode] = {n: p.grad.clone() for n, p in vae.named_parameters()}
    assert counts["flash_attention_bwd_dq_tf32x3"] == 4
    assert counts["flash_attention_bwd_dkv_tf32x3"] == 8
    assert abs(losses["spatial"] - losses["plain"]) <= 1e-5 * abs(
        losses["plain"])
    for n, gt in grads["plain"].items():
        diff, norm = (grads["spatial"][n] - gt).norm().item(), gt.norm().item()
        # a key projection's bias: zero in exact arithmetic
        absolute = norm < 1e-8 or n.endswith("to_k.bias")
        assert (diff if absolute else diff / norm) <= 1e-3, n


def test_spatial_encode_over_two_gpus(gen):
    """The encode over cuda:0 and cuda:1 (the slabs' halo rows, statistics
    and keys crossing devices) against two slabs of cuda:0.  Needs two
    GPUs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    vae = _narrow_vae(8).eval()
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, size=(2, 64, 48, 3)).astype(np.float32)).cuda()
    with torch.inference_mode():
        one = vae.encode(x, _two_slabs()).mean
        backend.reset_launch_counts()
        two = vae.encode(x, _two_slabs([torch.device("cuda", 0),
                                        torch.device("cuda", 1)])).mean
    assert backend.launch_counts()["gn_silu_conv3x3_tf32x3"] == 40
    assert two.device == x.device and _mse(two, one) < 1e-12


# ---------------------------------------------------------------- Wan VAE

@pytest.mark.parametrize("shape", [(2, 33, 17, 96), (1, 9, 70, 384),
                                   (2, 5, 7, 30), (1, 3, 5, 4)])
def test_rms_stats_pass(gen, shape):
    """r = sqrt(C) / max(||x||, 1e-12) a pixel, in both dtypes; 16-byte
    vectors where C allows (96, 384), single elements otherwise (30, 4);
    a zero pixel reads sqrt(C) / 1e-12, as F.normalize floors it."""
    x = _rnd(gen, *shape)
    x[0, 0, 0] = 0.0
    for dt in (torch.float32, torch.bfloat16):
        got = rms_norm_stats(x.to(dt))
        want = rms_stats_plain(x.to(dt))
        torch.cuda.synchronize()
        assert got.shape == shape[:3] and got.dtype == torch.float32
        assert torch.allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("shape", [(2, 33, 17, 96), (1, 9, 70, 384),
                                   (2, 5, 7, 30)])
@pytest.mark.parametrize("silu", [True, False])
def test_rms_norm_silu_kernel(gen, shape, silu):
    """The stats and apply passes (fp32 with the exact SiLU) against the
    plain RMS norm."""
    x = _rnd(gen, *shape)
    gamma = _rnd(gen, shape[-1], scale=0.2, shift=1.0)
    _check(lambda dt: rms_norm_silu(x.to(dt), gamma, apply_silu=silu),
           tol32=1e-5)
    counts = {k: c for k, c in backend.launch_counts().items() if c}
    assert counts == {"rms_norm_stats": 2, "rms_norm_silu": 2}


def test_rms_apply_pass_misaligned(gen):
    """An input off the 16-byte boundary takes the one-element path."""
    x = _rnd(gen, 2, 7, 9, 96)
    gamma = _rnd(gen, 96, shift=1.0)
    for dt in (torch.float32, torch.bfloat16):
        flat = torch.empty(1 + x.numel(), dtype=dt, device="cuda")
        xm = flat[1:].view(x.shape)
        xm.copy_(x)
        r = rms_norm_stats(xm)
        got = rms_norm_silu_apply(xm, r, gamma, apply_silu=True)
        with backend.backend("torch"):
            want = rms_norm_silu_apply(x.to(dt), rms_norm_stats(x.to(dt)),
                                       gamma, apply_silu=True)
        torch.cuda.synchronize()
        assert _rel(got, want) <= (1e-5 if dt == torch.float32 else 1e-2)


@pytest.mark.parametrize("n,h,w,cin,cout,variant", [
    (2, 8, 8, 96, 96, "plain"),
    (1, 9, 13, 96, 96, "residual"),
    (2, 7, 11, 96, 192, "shortcut"),
    (1, 6, 70, 192, 384, "shortcut"),
    (1, 5, 66, 384, 384, "residual"),
    (2, 3, 130, 384, 32, "plain"),
    (1, 1, 70, 40, 136, "shortcut"),
] + B_PRIME_HANDOFFS)
def test_rms_silu_conv3x3_kernel(gen, n, h, w, cin, cout, variant):
    """The Wan residual branch: B' in its RMS mode (bf16), the RMS apply
    pass and B'' (fp32, to 1e-5), each after the stats pass, against the
    plain version; ragged images and channel counts."""
    x = _rnd(gen, n, h, w, cin)
    gamma = _rnd(gen, cin, scale=0.2, shift=1.0)
    k = _rnd(gen, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    b = _rnd(gen, cout, scale=0.1)
    res, sck, scb = _residual_operands(gen, n, h, w, cin, cout, variant)
    _check(lambda dt: rms_silu_conv3x3(
        x.to(dt), gamma, k, b, None if res is None else res.to(dt), sck,
        scb), tol32=1e-5)
    counts = {k: c for k, c in backend.launch_counts().items() if c}
    assert counts == {"rms_norm_stats": 2, "rms_silu_conv3x3_tc": 1,
                      "rms_norm_silu": 1, "gn_silu_conv3x3_tf32x3": 1}


def test_the_rms_kernels_run_forward_only(gen):
    x = _rnd(gen, 1, 4, 4, 96).requires_grad_()
    gamma = _rnd(gen, 96, shift=1.0)
    with pytest.raises(NotImplementedError, match="forward only"):
        rms_norm_silu(x, gamma)
    with pytest.raises(NotImplementedError, match="forward only"):
        rms_silu_conv3x3(x, gamma, _rnd(gen, 3, 3, 96, 96), _rnd(gen, 96))


def test_a_wan_encoder_on_the_card(gen):
    """A Wan encoder at the published widths (96-384) on 64x80 images:
    the kernel path against the plain one in both dtypes, and the
    launches of one encode."""
    from vae_tagger_tpu_torch.core.config import default_wan_vae_config
    from vae_tagger_tpu_torch.models.autoencoder_kl_wan import (
        AutoencoderKLWan,
    )

    torch.manual_seed(0)
    vae = seeded_init_(AutoencoderKLWan(default_wan_vae_config()), 3)
    with torch.no_grad():
        for name, p in vae.named_parameters():
            if name.endswith("gamma") or name.endswith("bias"):
                p.add_(0.05 * torch.randn(p.shape))
    vae = vae.cuda().eval()
    x = _rnd(gen, 2, 64, 80, 3)

    def encode(dt):
        with torch.inference_mode():
            post = vae.encode(x.to(dt))
        return torch.cat([post.mean, post.logvar], -1)

    _check(encode, tol32=1e-4)
    expect = {torch.bfloat16: {"rms_norm_stats": 22, "rms_norm_silu": 2,
                               "rms_silu_conv3x3_tc": 20,
                               "flash_attention_fwd_tc": 1},
              torch.float32: {"rms_norm_stats": 22, "rms_norm_silu": 22,
                              "gn_silu_conv3x3_tf32x3": 20,
                              "flash_attention_fwd_tf32x3": 1}}
    for dt, want in expect.items():
        backend.reset_launch_counts()
        encode(dt)
        torch.cuda.synchronize()
        assert {k: c for k, c in backend.launch_counts().items() if c} == want


# What cudaFuncGetAttributes reports for the instances the FLUX cells run
# (NVIDIA H100 80GB HBM3): {(Cout tile, residual mode): (registers, shared
# memory bytes)} of B' in its GroupNorm mode, three halo buffers and four
# weight stages at BN = 128, three of each at BN = 256; (registers, shared
# memory bytes) of C' and C'' at D = 512, as before the RMS mode and the head
# width 384 existed.
GN_B_PRIME = {(c_out, mode): (168, smem)
              for c_out, smem in ((128, 220296), (256, 200824))
              for mode in ("plain", "residual", "shortcut")}
C_AT_512 = {"bfloat16": (168, 230528), "float32": (255, 230528)}


def test_the_flux_instances_are_unchanged(gen):
    """The GroupNorm-mode B' reports the registers and shared memory of its
    layout, and the D = 512 C' and C'' those they had before the RMS mode
    and head width 384 were added; the new instances report theirs."""
    from vae_tagger_tpu_torch.ops.attention import fwd_tc_kernel_attrs

    for (c_out, mode), (regs, smem) in GN_B_PRIME.items():
        a = tc_kernel_attrs(c_out, mode)
        assert (a["registers"], a["smem_bytes"]) == (regs, smem), (c_out, mode)
    for dt, (regs, smem) in C_AT_512.items():
        a = fwd_tc_kernel_attrs(getattr(torch, dt), 512)
        assert (a["registers"], a["smem_bytes"]) == (regs, smem), dt
    for c_out in (128, 384):
        for mode in ("plain", "residual", "shortcut"):
            a = tc_kernel_attrs(c_out, mode, norm="rms")
            assert a["registers"] > 0 and a["smem_bytes"] > 0
    for dt in (torch.bfloat16, torch.float32):
        a = fwd_tc_kernel_attrs(dt, 384)
        assert a["registers"] > 0
