"""The 3xTF32 arithmetic of kernels D'' and E'' (the fp32 flash-attention
backward, ``csrc/flash_attention_bwd_tf32x3.cu``) and their host code, on
the CPU.

The kernels run only on the card (tests/test_torch_cuda.py).  What they
compute is held here with a torch model of their products, as
tests/test_torch_tf32x3_host.py holds B'' and C'': the model runs on the
operands exactly as the wrapper lays them out (``tf32x3_bwd_operands``:
K, V, Q and dO split as they stand, K^T, Q^T and dO^T padded, permuted and
split), splits the kernels' register operands (the block's raw rows, and
dS or P before the output products) with ``to_tf32`` at each use, and
multiplies as lo*hi + hi*lo + hi*hi.  It is compared with the JAX
package's ``_flash_attention_bwd_impl`` in fp32, in interpret mode, fed
the same O and logsumexp, at D = 512 and ragged Sq != Skv.

Tolerance (max absolute error over the largest reference value): the
Pallas backward in fp32 is itself 4.8e-7 to 1.74e-6 from an fp64
evaluation of these cases, and the model 9.2e-7 to 1.43e-6 (the three
products keep about 21 bits of each operand; the sums over 512 columns
and up to 200 streamed rows run in another order), so the two may differ
by up to their sum, 3e-6 (2.16e-6 measured); the model is held to 3e-6
of the Pallas backward and 2e-6 of fp64, 33 and 50 times below the 1e-4
fp32 gate.  A single TF32 product misses that gate (4.7e-4 to 7.5e-4).
Besides: the layouts of the transposed operands, the dispatch of fp32 to
D'' and E'', and the head widths they refuse.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from vae_tagger_tpu.ops.pallas.flash_attention import (
    _flash_attention_bwd_impl,
    _flash_attention_fwd_impl,
)
from vae_tagger_tpu_torch.ops import _build, attention, backend
from vae_tagger_tpu_torch.ops.tf32x3 import (
    PERM8,
    split_tf32,
    transpose_permuted,
)

D = 512
GATE_FP32 = 1e-4   # chip_smoke.py's fp32 gate
TOL_3X = 3e-6      # the three-product model against the JAX package
TOL_3X_F64 = 2e-6  # and against fp64


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _mm(a, b_hi, b_lo, products=3):
    """a @ b as the kernels multiply, b given split (the wrapper's
    shared-memory operand), a split here (in registers in the kernels):
    three TF32 products, the small terms first (products=1: hi*hi)."""
    a_hi, a_lo = split_tf32(a.contiguous())
    if products == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _t(x):
    return x.transpose(1, 2)


def _permuted(x, pad):
    """x (B, R, S) with S zero-padded to ``pad`` and its columns taken in
    the transposed operands' order: the A operand of an output product as
    the kernels store it."""
    x = F.pad(x, (0, pad - x.shape[-1]))
    order = torch.tensor([8 * (i // 8) + PERM8[i % 8] for i in range(pad)])
    return x[..., order]


def _probs(s, lse, scale):
    """P = exp(S scale - L), L broadcast to S's shape."""
    return torch.exp(s * scale - lse)


def bwd_tf32x3_model(q, k, v, do, lse, delta, products=3):
    """(dQ, dK, dV) as D'' and E'' compute them: D'' over query rows with
    S = Q K^T and dP = dO V^T, then dQ from dS and K^T; E'' in the S^T form
    over key rows, dV from P^T and dO^T, dK from dS^T and Q^T."""
    scale = 1.0 / D ** 0.5
    _, _, kh, kl, vh, vl, kth, ktl, skv_pad = attention.tf32x3_bwd_operands(
        "dq", q, k, v, do)
    s = _mm(q, _t(kh), _t(kl), products)
    dp = _mm(do, _t(vh), _t(vl), products)
    ds = _probs(s, lse[..., None], scale) * (dp - delta[..., None])
    dq = _mm(_permuted(ds, skv_pad), _t(kth), _t(ktl), products) * scale

    (_, _, qh, ql, doh, dol, qth, qtl, doth, dotl,
     sq_pad) = attention.tf32x3_bwd_operands("dkv", q, k, v, do)
    st = _mm(k, _t(qh), _t(ql), products)
    dpt = _mm(v, _t(doh), _t(dol), products)
    pt = _probs(st, lse[:, None, :], scale)
    dst = pt * (dpt - delta[:, None, :])
    dv = _mm(_permuted(pt, sq_pad), _t(doth), _t(dotl), products)
    dk = _mm(_permuted(dst, sq_pad), _t(qth), _t(qtl), products) * scale
    return dq, dk, dv


def _case(b, sq, skv, seed):
    """Seeded fp32 inputs and the JAX package's O, L and backward."""
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, sq, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, skv, D)).astype(np.float32)
            for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        o, lse = _flash_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), block_q=128,
                                           block_k=128)
        want = _flash_attention_bwd_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
            jnp.asarray(do), block_q=128, block_k=128)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = torch.from_numpy(np.array(o))
    lse = torch.from_numpy(np.array(lse))
    delta = attention.bwd_delta(o, tdo)
    return (tq, tk, tv, tdo, lse, delta), [np.asarray(w) for w in want]


def _fp64(q, k, v, do):
    """(dQ, dK, dV) of softmax(Q K^T scale) V in fp64."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    p = torch.softmax(q @ _t(k) / D ** 0.5, -1)
    dp = do @ _t(v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return ds @ k / D ** 0.5, _t(ds) @ q / D ** 0.5, _t(p) @ do


@pytest.mark.parametrize("b,sq,skv", [(1, 130, 200), (2, 64, 33)])
def test_three_product_backward_matches_the_jax_backward(b, sq, skv):
    """D = 512, Sq != Skv, neither a multiple of the 64-row block or the
    32-row tile, and Skv = 33, Sq = 130 not multiples of 8 (the padding of
    the transposes): dQ, dK and dV against the Pallas backward in fp32,
    and against fp64."""
    ins, want = _case(b, sq, skv, sq * skv)
    got = bwd_tf32x3_model(*ins)
    ref64 = _fp64(*ins[:4])
    for name, g, w, r in zip(("dq", "dk", "dv"), got, want, ref64):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= TOL_3X, (name, _rel(g, w), _rel(w, r))
        assert _rel(g, r) <= TOL_3X_F64, (name, _rel(g, r))


def test_single_tf32_product_misses_the_fp32_gate():
    ins, want = _case(1, 130, 200, 7)
    got = bwd_tf32x3_model(*ins, products=1)
    assert max(_rel(g, w) for g, w in zip(got, want)) > GATE_FP32


@pytest.mark.parametrize("s", [1, 8, 33, 130])
def test_transpose_permuted_layout(s):
    """x^T is (B, D, S rounded up to 8), contiguous: column p of a group
    of 8 holds row PERM8[p] of the group, zeros past S."""
    x = torch.from_numpy(np.random.default_rng(s).normal(
        size=(2, s, 24)).astype(np.float32))
    xt, pad = transpose_permuted(x)
    assert pad == -(-s // 8) * 8 and xt.shape == (2, 24, pad)
    assert xt.is_contiguous()
    for col in range(pad):
        row = 8 * (col // 8) + PERM8[col % 8]
        want = x[:, row] if row < s else torch.zeros(2, 24)
        assert torch.equal(xt[:, :, col], want)


@pytest.mark.parametrize("part", ["dq", "dkv"])
def test_bwd_operands_layout(part):
    """The operands of D'' (raw Q and dO; K, V and K^T split) and of E''
    (raw K and V; Q, dO, Q^T and dO^T split), in the order of the C
    entries: each split pair is TF32 hi and lo of its source, and hi + lo
    recovers it to within 2^-21."""
    rng = np.random.default_rng(3)
    q, do = (torch.from_numpy(rng.normal(size=(2, 20, D)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(2, 13, D)).astype(
        np.float32)) for _ in range(2))
    ops = attention.tf32x3_bwd_operands(part, q, k, v, do)
    if part == "dq":
        raw, split, pad = (q, do), (k, v, transpose_permuted(k)[0]), 16
    else:
        raw = (k, v)
        split = (q, do, transpose_permuted(q)[0], transpose_permuted(do)[0])
        pad = 24
    assert ops[-1] == pad
    assert all(a is b for a, b in zip(ops, raw))
    pairs = ops[len(raw):-1]
    assert len(pairs) == 2 * len(split)
    for src, hi, lo in zip(split, pairs[::2], pairs[1::2]):
        assert hi.shape == lo.shape == src.shape and hi.is_contiguous()
        for t in (hi, lo):
            assert not (t.view(torch.int32) & 0x1FFF).any()
        assert ((hi.double() + lo.double() - src.double()).abs()
                <= 2.0 ** -21 * src.double().abs()).all()


def test_fp32_backward_goes_to_d2_and_e2():
    """fp32 CUDA tensors go to D'' and E'' (E'' two launches a call); the
    SIMT D and E have left the dispatch tables (their library stays built
    for chip_smoke.py's yardsticks)."""
    parts = attention.bwd_kernels_for(torch.zeros(1, 4, D))
    assert parts == {
        "dq": ("flash_attention_bwd_tf32x3", "vt_flash_attn_bwd_dq_tf32x3",
               "flash_attention_bwd_dq_tf32x3"),
        "dkv": ("flash_attention_bwd_tf32x3", "vt_flash_attn_bwd_dkv_tf32x3",
                "flash_attention_bwd_dkv_tf32x3")}
    for stem, fn, counter in parts.values():
        assert fn in _build.SIGNATURES[stem]
        assert f"{fn}_attrs" in _build.SIGNATURES[stem]
        assert counter in backend.LAUNCHES
    assert attention.LAUNCHES_PER_CALL["vt_flash_attn_bwd_dkv_tf32x3"] == 2
    stems = {t[0] for parts in attention.BWD_KERNELS.values()
             for t in parts.values()}
    assert "flash_attention_bwd" not in stems


@pytest.mark.parametrize("d", [64, 128, 256, 1024])
def test_fp32_backward_refuses_head_widths(d):
    with pytest.raises(ValueError, match="head width"):
        attention.bwd_kernels_for(torch.zeros(1, 4, d))
