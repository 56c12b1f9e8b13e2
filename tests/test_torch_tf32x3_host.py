"""The 3xTF32 arithmetic of kernels B'' and C'' and their host code, on the
CPU.

The kernels run only on the card (tests/test_torch_cuda.py).  What they
compute is held here with a torch model of their products: each fp32
operand split by the port's ``split_tf32`` (the wrapper's own preparation
pass, and a bit-level emulation of the ``cvt.rna.tf32.f32`` the kernels
apply in registers) and multiplied as lo*hi + hi*lo + hi*hi.  The model
runs on the operands exactly as the wrappers lay them out -- B'''s packed
K-major weights, C'''s key-permuted V^T -- and is compared with the JAX
package's Pallas kernels in fp32, in interpret mode, to rel 1e-6 (max
absolute error over the largest reference value; the attention output to
4e-6 of the Pallas forward, whose own fp32 error is 2.3e-6, and to 2e-6
of fp64); a single TF32 product misses the 1e-4 fp32 gate.  Besides: the dispatch of fp32 to B'' and C'',
the shapes they refuse, and the fused conv's wrappers run through the C
entries' contract by stand-ins that read and write the tensors at the
addresses they are passed.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from vae_tagger_tpu.ops.conv import effective_affine as jax_effective_affine
from vae_tagger_tpu.ops.conv import group_stats as jax_group_stats
from vae_tagger_tpu.ops.pallas.conv_fused import gn_silu_conv3x3_pallas
from vae_tagger_tpu.ops.pallas.flash_attention import _flash_attention_fwd_impl
from vae_tagger_tpu_torch.io.checkpoints import torch_state_from_jax_params
from vae_tagger_tpu_torch.ops import attention, backend, conv, normalization
from vae_tagger_tpu_torch.ops.normalization import (
    EXACT_SILU,
    group_norm_affine,
    group_norm_silu_apply_plain,
    group_stats_plain,
)
from vae_tagger_tpu_torch.ops.tf32x3 import split_tf32, to_tf32

GROUPS = 8
GATE_FP32 = 1e-4   # chip_smoke.py's fp32 gate
TOL_3X = 1e-6      # the three-product model against the JAX package


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _mm(a, b_hi, b_lo, products=3):
    """a @ b as kernels B'' and C'' multiply, with b given split (the
    wrapper's shared-memory operand) and a split here (in registers in the
    kernels): three TF32 products, the small terms first (products=1:
    single-pass TF32, hi*hi only)."""
    a_hi, a_lo = split_tf32(a.contiguous())
    if products == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


# --------------------------------------------------------------------------
# the split


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5e3, 3e30])
def test_split_tf32_keeps_21_bits(scale):
    """hi has the low 13 mantissa bits zero (a TF32 value), lo too, and
    hi + lo recovers x to within 2^-21 of |x|."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=4096) * scale).astype(np.float32))
    hi, lo = split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == x.shape
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    # hi alone is TF32: about 2^-11 of |x|
    assert ((hi.double() - x.double()).abs()
            <= 2.0 ** -11 * x.double().abs()).all()


def test_to_tf32_rounds_to_nearest_ties_away():
    """cvt.rna: a value halfway between two TF32 neighbours rounds away
    from zero; just below halfway rounds down; inf and NaN pass."""
    ulp = 2.0 ** -10  # of TF32 at 1.0
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                      1 + 3 * ulp / 2, float("inf"), float("-inf")],
                     dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp,
                         float("inf"), float("-inf")])
    assert torch.equal(to_tf32(x), want)
    assert torch.isnan(to_tf32(torch.tensor([float("nan")]))).all()
    with pytest.raises(TypeError):
        to_tf32(x.double())


# --------------------------------------------------------------------------
# kernel B'': the fused conv on its packed operands


def _conv_tf32x3(act, w_hi, w_lo, bias, res=None, sc_hi=None, sc_lo=None,
                 products=3):
    """Kernel B'''s product on the packed, split operands: for each of the
    9 taps the shifted activated tile times that tap's (Cout, Cin)
    matrix, then the 1x1 shortcut as extra K steps on the residual."""
    n, h, w, _ = act.shape
    pad = F.pad(act, (0, 0, 1, 1, 1, 1))

    def mm(a, hi, lo):  # the packed weights are K-major: (N, K)
        return _mm(a, hi.t(), lo.t(), products)

    out = torch.zeros(n, h, w, w_hi.shape[1])
    for t in range(9):
        dy, dx = divmod(t, 3)
        out += mm(pad[:, dy:dy + h, dx:dx + w, :], w_hi[t], w_lo[t])
    if sc_hi is not None:
        out += mm(res, sc_hi, sc_lo)
    return out + bias


def _conv_case(variant, seed):
    rng = np.random.default_rng(seed)
    c_in, c_out, hw = 40, 136 if variant == "shortcut" else 64, 6
    tree = {"conv1": {
        "kernel": (rng.normal(size=(3, 3, c_in, c_out)) * 0.05).astype(
            np.float32),
        "bias": (rng.normal(size=(c_out,)) * 0.1).astype(np.float32)}}
    if variant == "shortcut":
        tree["conv_shortcut"] = {
            "kernel": (rng.normal(size=(1, 1, c_in, c_out)) * 0.1).astype(
                np.float32),
            "bias": (rng.normal(size=(c_out,)) * 0.1).astype(np.float32)}
    x = rng.normal(size=(2, hw, hw, c_in)).astype(np.float32)
    gs = (rng.normal(size=(c_in,)) * 0.2 + 1.0).astype(np.float32)
    gb = (rng.normal(size=(c_in,)) * 0.1).astype(np.float32)
    res = x if variant != "plain" else None
    if variant == "residual":
        res = rng.normal(size=(2, hw, hw, c_out)).astype(np.float32)
    return tree, x, gs, gb, res


def _conv_model_and_reference(variant, products):
    tree, x, gs, gb, res = _conv_case(variant, 11)
    c_in = x.shape[-1]
    state = torch_state_from_jax_params(tree)
    hwio = state["conv1.weight"].permute(2, 3, 1, 0)  # the port's .hwio()
    w_hi, w_lo = split_tf32(conv.pack_conv3x3_weight(hwio, torch.float32))
    es, eb = group_norm_affine(torch.from_numpy(x), torch.from_numpy(gs),
                               torch.from_numpy(gb), num_groups=GROUPS)
    act = F.silu(torch.from_numpy(x) * es[:, None, None] + eb[:, None, None])
    sc_hi = sc_lo = None
    bias = state["conv1.bias"]
    if variant == "shortcut":
        sc = state["conv_shortcut.weight"][:, :, 0, 0].t()  # (Cres, Cout)
        sc_hi, sc_lo = split_tf32(conv.pack_shortcut_weight(sc, c_in,
                                                            torch.float32))
        bias = bias + state["conv_shortcut.bias"]
    got = _conv_tf32x3(act, w_hi, w_lo, bias,
                       None if res is None else torch.from_numpy(res),
                       sc_hi, sc_lo, products)
    if variant == "residual":
        got = got + torch.from_numpy(res)

    mean, meansq = jax_group_stats(jnp.asarray(x), GROUPS)
    jes, jeb = jax_effective_affine(mean, meansq, jnp.asarray(gs),
                                    jnp.asarray(gb), c_in, 1e-6)
    sc_tree = tree.get("conv_shortcut", {})
    with pltpu.force_tpu_interpret_mode():
        want = gn_silu_conv3x3_pallas(
            jnp.asarray(x), jes, jeb, jnp.asarray(tree["conv1"]["kernel"]),
            jnp.asarray(tree["conv1"]["bias"]),
            None if res is None else jnp.asarray(res),
            None if not sc_tree else jnp.asarray(sc_tree["kernel"]),
            None if not sc_tree else jnp.asarray(sc_tree["bias"]),
            tile_h=2, tile_cout=tree["conv1"]["kernel"].shape[-1],
            interpret=True)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("variant", ["plain", "residual", "shortcut"])
def test_three_product_conv_matches_the_jax_fused_conv(variant):
    """Fully fp32 weights (not TF32-representable) carried over from a JAX
    ResnetBlock tree, packed and split as the wrapper does: the
    three-product conv equals the Pallas fused conv in fp32."""
    got, want = _conv_model_and_reference(variant, 3)
    assert _rel(got, want) <= TOL_3X


def test_single_tf32_product_misses_the_fp32_gate():
    got, want = _conv_model_and_reference("plain", 1)
    assert _rel(got, want) > GATE_FP32


# --------------------------------------------------------------------------
# kernel C'': attention with K split and V^T permuted and split


PERM8 = [0, 2, 4, 6, 1, 3, 5, 7]  # key of k index p in a group of 8


def _attention_tf32x3(q, k, v, products=3):
    """Kernel C'''s function on the operands ``tf32x3_kv`` lays out: S =
    Q K^T and O = P V as three-product sums, P's columns taken in V^T's
    key order (group of 8: 0 2 4 6 1 3 5 7), padded keys at zero."""
    b, sq, d = q.shape
    skv = k.shape[1]
    k_hi, k_lo, vt_hi, vt_lo, skv_pad = attention.tf32x3_kv(k, v)
    s = _mm(q, k_hi.transpose(1, 2), k_lo.transpose(1, 2), products)
    s = s / d ** 0.5
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    p = F.pad(p, (0, skv_pad - skv))
    order = torch.tensor([8 * (i // 8) + PERM8[i % 8] for i in range(skv_pad)])
    o = _mm(p[..., order], vt_hi.transpose(1, 2), vt_lo.transpose(1, 2),
            products)
    return o, lse


def _attention_case(sq, skv, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, n, 512)).astype(np.float32)
            for n in (sq, skv, skv)]


# The Pallas forward in fp32 is itself 1.1e-6 to 2.3e-6 (rel) from an fp64
# evaluation of these cases, so O is held to 4e-6 of it, and to 2e-6 of
# fp64 (a plain fp32 evaluation in torch is 5.6e-7 to 6.2e-7 from it).
TOL_3X_ATTENTION_JAX = 4e-6
TOL_3X_ATTENTION_F64 = 2e-6


@pytest.mark.parametrize("sq,skv", [(100, 77), (64, 130)])
def test_three_product_attention_matches_the_jax_flash_attention(sq, skv):
    """D = 512, Sq != Skv and Skv not a multiple of 8 (V^T's padding):
    O and the logsumexp against the Pallas forward in fp32, O also
    against fp64."""
    q, k, v = _attention_case(sq, skv, sq + skv)
    o, lse = _attention_tf32x3(*(torch.from_numpy(t) for t in (q, k, v)))
    with pltpu.force_tpu_interpret_mode():
        ref_o, ref_lse = _flash_attention_fwd_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
            block_k=128)
    q64, k64, v64 = (torch.from_numpy(t).double() for t in (q, k, v))
    o64 = torch.softmax(q64 @ k64.transpose(1, 2) / 512 ** 0.5, -1) @ v64
    assert _rel(o, ref_o) <= TOL_3X_ATTENTION_JAX
    assert _rel(o, o64) <= TOL_3X_ATTENTION_F64
    assert _rel(lse, ref_lse) <= TOL_3X


def test_single_tf32_product_attention_misses_the_fp32_gate():
    q, k, v = _attention_case(100, 77, 3)
    o, _ = _attention_tf32x3(*(torch.from_numpy(t) for t in (q, k, v)), 1)
    with pltpu.force_tpu_interpret_mode():
        ref_o, _ = _flash_attention_fwd_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
            block_k=128)
    assert _rel(o, ref_o) > GATE_FP32


@pytest.mark.parametrize("skv", [1, 8, 20, 77])
def test_vt_layout(skv):
    """V^T is (B, D, Skv rounded up to 8): column p of a group of 8 holds
    key PERM8[p] of the group, zeros past Skv; hi + lo recovers V."""
    v = torch.from_numpy(np.random.default_rng(skv).normal(
        size=(2, skv, 512)).astype(np.float32))
    k = torch.zeros_like(v)
    _, _, vt_hi, vt_lo, skv_pad = attention.tf32x3_kv(k, v)
    assert skv_pad == -(-skv // 8) * 8 and vt_hi.shape == (2, 512, skv_pad)
    assert vt_hi.is_contiguous() and vt_lo.is_contiguous()
    vt = vt_hi + vt_lo
    for col in range(skv_pad):
        key = 8 * (col // 8) + PERM8[col % 8]
        want = v[:, key] if key < skv else torch.zeros(2, 512)
        assert ((vt[:, :, col] - want).abs()
                <= 2.0 ** -21 * want.abs()).all()


# --------------------------------------------------------------------------
# dispatch and refusals


def test_fp32_goes_to_b2_and_c2():
    """fp32 CUDA tensors go to B'' and C''; the SIMT B and C have left the
    dispatch tables (their libraries stay built for chip_smoke.py's
    yardsticks), and the fp32 backward goes to D'' and E''."""
    q = torch.zeros(1, 4, 512)
    assert attention.fwd_kernel_for(q) == (
        "flash_attention_fwd_tf32x3", "vt_flash_attn_fwd_tf32x3",
        "flash_attention_fwd_tf32x3")
    assert conv.conv_kernel_for(torch.zeros(1, 4, 4, 64)) == (
        "gn_silu_conv3x3_tf32x3", "vt_gn_silu_conv3x3_tf32x3",
        "gn_silu_conv3x3_tf32x3")
    assert attention.bwd_kernels_for(q)["dq"][0] == \
        "flash_attention_bwd_tf32x3"
    stems = {t[0] for t in (*attention.FWD_KERNELS.values(),
                            *conv.CONV_KERNELS.values())}
    assert not stems & {"gn_silu_conv3x3", "flash_attention_fwd"}
    for name in ("gn_silu_conv3x3_tf32x3", "flash_attention_fwd_tf32x3"):
        assert name in backend.LAUNCHES


@pytest.mark.parametrize("shape", [
    # (N, H, W, Cin, Cout, Cres): the encoder's convs, and ragged ones
    (4, 1024, 1024, 128, 128, 0),
    (4, 256, 256, 512, 512, 256),
    (1, 5, 9, 20, 12, 0),      # multiples of 4, not of 8
    (1, 1, 70, 36, 100, 44),
])
def test_tf32x3_conv_shape_accepts(shape):
    conv.check_tc_conv_shape(*shape, dtype=torch.float32)


@pytest.mark.parametrize("shape", [(1, 8, 8, 38, 64, 0),
                                   (1, 8, 8, 64, 66, 0),
                                   (1, 8, 8, 64, 64, 6),
                                   (1, 0, 8, 64, 64, 0)])
def test_tf32x3_conv_shape_refuses(shape):
    with pytest.raises(ValueError, match="B''|empty"):
        conv.check_tc_conv_shape(*shape, dtype=torch.float32)


@pytest.mark.parametrize("d", [64, 128, 256, 1024])
def test_tf32x3_attention_refuses_head_widths(d):
    with pytest.raises(ValueError, match="head width"):
        attention.fwd_kernel_for(torch.zeros(1, 4, d))


def test_fp32_packing_keeps_fp32():
    """The packed layouts of B'' keep every fp32 bit before the split: the
    (9, Cout, Cin) taps and the (Cout, Cres) shortcut, contiguous."""
    rng = np.random.default_rng(5)
    hwio = torch.from_numpy(rng.normal(size=(3, 3, 12, 20)).astype(
        np.float32))
    packed = conv.pack_conv3x3_weight(hwio, torch.float32)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert torch.equal(packed[4], hwio[1, 1].t())
    sc = torch.from_numpy(rng.normal(size=(12, 20)).astype(np.float32))
    packed_sc = conv.pack_shortcut_weight(sc, 12, torch.float32)
    assert packed_sc.shape == (20, 12) and torch.equal(packed_sc, sc.t())


# --------------------------------------------------------------------------
# the fused conv's wrappers, through the C entries' contract


def _at(ptr, shape, dtype=torch.float32):
    """The CPU tensor of ``shape`` and ``dtype`` at address ``ptr``."""
    n = int(np.prod(shape))
    if dtype == torch.float32:
        raw = (ctypes.c_float * n).from_address(ptr)
        return torch.from_numpy(np.ctypeslib.as_array(raw)).view(shape)
    raw = (ctypes.c_int16 * n).from_address(ptr)
    return torch.from_numpy(np.ctypeslib.as_array(raw)).view(dtype).view(
        shape)


def _conv_tail(act, w, c_in, c_out, bias, res, sc, sc_bias):
    """conv3x3 of the activated input with the packed (9, Cout, Cin)
    weights, + bias, + the residual or its shortcut product, in fp32."""
    w = w.float().view(3, 3, c_out, c_in).permute(2, 3, 0, 1)
    out = F.conv2d(act.float().permute(0, 3, 1, 2), w, padding=1).permute(
        0, 2, 3, 1) + bias
    if sc is not None:
        return out + res.float() @ sc.float().t() + sc_bias
    return out if res is None else out + res.float()


class _StandIns:
    """Kernel A's apply pass, B' and B'' on the CPU: each reads its inputs
    and writes its output at the addresses a wrapper passes, so that a
    wrong argument order or a wrong tensor shows in the output."""

    def __init__(self):
        self.calls = []

    def vt_gn_apply_vec(self, x, dtype, n, s, c, vec, rows, blocks, strips,
                        es, eb, out, silu, stream):
        self.calls.append(("A", silu, x, out))
        y = _at(x, (n, s, c)) * _at(es, (n, 1, c)) + _at(eb, (n, 1, c))
        _at(out, (n, s, c)).copy_(y * torch.sigmoid(y) if silu else y)
        return 0

    def vt_gn_silu_conv3x3_tf32x3(self, x, n, h, w, c_in, c_out, w_hi, w_lo,
                                  bias, res, c_res, sc_hi, sc_lo, sc_bias,
                                  out, stream):
        self.calls.append(("B''", x))
        sc = None
        if sc_hi is not None:
            sc = _at(sc_hi, (c_out, c_res)) + _at(sc_lo, (c_out, c_res))
        wk = _at(w_hi, (9, c_out, c_in)) + _at(w_lo, (9, c_out, c_in))
        _at(out, (n, h, w, c_out)).copy_(_conv_tail(
            _at(x, (n, h, w, c_in)), wk, c_in, c_out, _at(bias, (c_out,)),
            None if res is None else _at(res, (n, h, w, c_res)), sc,
            None if sc_bias is None else _at(sc_bias, (c_out,))))
        return 0

    def vt_gn_silu_conv3x3_tc(self, x, dtype, n, h, w, c_in, c_out, es, eb,
                              wpack, bias, res, c_res, wsc, sc_bias, out,
                              stream):
        self.calls.append(("B'", x))
        bf = torch.bfloat16
        y = (_at(x, (n, h, w, c_in), bf).float() * _at(es, (n, 1, 1, c_in))
             + _at(eb, (n, 1, 1, c_in)))
        act = (y * torch.sigmoid(y)).to(bf)
        _at(out, (n, h, w, c_out), bf).copy_(_conv_tail(
            act, _at(wpack, (9, c_out, c_in), bf), c_in, c_out,
            _at(bias, (c_out,)),
            None if res is None else _at(res, (n, h, w, c_res), bf),
            None if wsc is None else _at(wsc, (c_out, c_res), bf),
            None if sc_bias is None else _at(sc_bias, (c_out,))).to(bf))
        return 0


@pytest.fixture
def stand_ins(monkeypatch):
    """The fused conv's kernel path on the CPU, every launch a stand-in."""
    fake = _StandIns()
    for mod in (conv, normalization):
        monkeypatch.setattr(mod, "lib", lambda stem: fake)
        monkeypatch.setattr(mod, "stream_of", lambda t: 0)
    monkeypatch.setattr(normalization, "_sms", lambda dev: 132)
    monkeypatch.setattr(backend, "use_kernel", lambda t: True)

    def stats(x, gs, gb, *, num_groups, eps):  # the stats pass
        backend.count_launch("group_stats")
        mean, meansq = group_stats_plain(x, num_groups)
        return (mean, meansq, *normalization.effective_affine(
            mean, meansq, gs, gb, x.shape[-1], eps))

    monkeypatch.setattr(conv, "group_norm_stats_affine", stats)
    # the launches without their device guard, a CUDA one
    for mod, name in ((conv, "_gn_silu_conv3x3_kernel"),
                      (conv, "_gn_silu_conv3x3_from_stats_kernel"),
                      (conv, "_gn_apply_kernel"),
                      (normalization, "_gn_apply_kernel")):
        monkeypatch.setattr(mod, name, getattr(mod, name).__wrapped__)
    backend.reset_launch_counts()
    yield fake
    backend.reset_launch_counts()


@pytest.mark.parametrize("form", ["fused", "from_stats"])
@pytest.mark.parametrize("variant", ["plain", "residual", "shortcut"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_conv_wrapper_keeps_the_kernels_contract(stand_ins, dtype,
                                                       variant, form):
    """fp32: kernel A's apply pass with the exact SiLU writes the
    activation, and B'' convolves that tensor, not x; bf16: B' gets x and
    the effective affine.  The output equals the plain version's, x is
    left as it was, and one launch is counted, the conv's."""
    g = torch.Generator().manual_seed(7)
    n, h, w, c_in, c_out, c_res = 2, 5, 9, 16, 24, 8
    x = torch.randn(n, h, w, c_in, generator=g)
    gs, gb = 1 + 0.2 * torch.randn(c_in, generator=g), torch.randn(c_in)
    k = torch.randn(3, 3, c_in, c_out, generator=g) * (9 * c_in) ** -0.5
    b = torch.randn(c_out, generator=g)
    res = sck = scb = None
    if variant == "residual":
        res = torch.randn(n, h, w, c_out, generator=g)
    if variant == "shortcut":
        res = torch.randn(n, h, w, c_res, generator=g)
        sck, scb = torch.randn(c_res, c_out, generator=g), torch.randn(c_out)
    x, res = (None if t is None else t.to(dtype) for t in (x, res))
    kept = x.clone()
    if form == "fused":
        got = conv.gn_silu_conv3x3(x, gs, gb, k, b, res, sck, scb,
                                   num_groups=4)
    else:
        mean, meansq = group_stats_plain(x, 4)
        got = conv.gn_silu_conv3x3_from_stats(x, mean, meansq, gs, gb, k, b,
                                              res, sck, scb)
    want = conv.gn_silu_conv3x3_plain(
        x.float(), gs, gb, k, b, None if res is None else res.float(), sck,
        scb, num_groups=4)
    assert got.dtype == dtype and torch.equal(x, kept)
    assert _rel(got.float(), want) <= (1e-5 if dtype == torch.float32
                                       else 2e-2)
    if dtype == torch.float32:
        (a, silu, a_in, a_out), (b2, conv_in) = stand_ins.calls
        assert (a, b2, silu) == ("A", "B''", EXACT_SILU)
        assert a_in == x.data_ptr() and conv_in == a_out != a_in
    else:
        assert stand_ins.calls == [("B'", x.data_ptr())]
    counter = conv.CONV_KERNELS[dtype][2]
    launched = {k: c for k, c in backend.launch_counts().items() if c}
    assert launched == {counter: 1, **(
        {"group_stats": 1} if form == "fused" else {})}


@pytest.mark.parametrize("apply_silu,code", [(False, 0), (True, 1),
                                             (EXACT_SILU, 2)])
def test_apply_pass_passes_its_silu(stand_ins, apply_silu, code):
    """The apply pass hands the C entry 0 (no SiLU), 1 (the SFU's) or 2
    (exact); the plain version takes both SiLUs for the exact one."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 5, 8, generator=g)
    es, eb = torch.randn(2, 8, generator=g), torch.randn(2, 8, generator=g)
    got = normalization.group_norm_silu_apply(x, es, eb,
                                              apply_silu=apply_silu)
    assert stand_ins.calls[0][1] == code
    want = group_norm_silu_apply_plain(x, es, eb, apply_silu=apply_silu)
    assert _rel(got, want) <= 1e-6
    assert torch.equal(want, group_norm_silu_apply_plain(
        x, es, eb, apply_silu=bool(apply_silu)))
