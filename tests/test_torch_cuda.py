"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips on a host without a CUDA device (decided
inside the fixture, never at import).  Run on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Shapes here are small and deliberately ragged (channel counts that are not
multiples of the kernels' tiles, sequences that are not multiples of the
key tile, images narrower or wider than one pixel tile); chip_smoke.py
covers the encode path's full shapes.  Each check runs both dtypes (the
attention kernels take head width 512 alone, other widths raise): bf16
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
from vae_tagger_tpu_torch.ops.conv import gn_silu_conv3x3
from vae_tagger_tpu_torch.ops.normalization import (
    group_norm_affine,
    group_norm_silu,
    group_stats,
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
        scb, num_groups=groups), tol32=1e-5)
    counts = backend.launch_counts()
    assert counts["gn_silu_conv3x3_tc"] == 1
    assert counts["gn_silu_conv3x3_tf32x3"] == 1
    assert counts["gn_silu_conv3x3"] == 0


@pytest.mark.parametrize("b,sq,skv,d", [(2, 300, 300, 128),
                                        (1, 100, 260, 64),
                                        (2, 300, 300, 512),
                                        (1, 100, 260, 512),
                                        (1, 1024, 1024, 512),
                                        (2, 64, 33, 512),
                                        (1, 70, 20, 512),  # one key tile
                                        # the full sequence at 512px
                                        (1, 4096, 4096, 512)])
def test_flash_attention_fwd_kernel(gen, b, sq, skv, d):
    """Ragged Sq != Skv and sequences that are not multiples of the 64-row
    or 32-key tiles.  At the model's width D = 512 both dtypes (bf16 runs
    kernel C', fp32 kernel C'', to 1e-5); both take D = 512 alone, and
    other widths raise in either dtype."""
    q, k, v = _rnd(gen, b, sq, d), _rnd(gen, b, skv, d), _rnd(gen, b, skv, d)
    if d != 512:
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
