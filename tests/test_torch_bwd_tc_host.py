"""Kernels D' and E' (``csrc/flash_attention_bwd_tc.cu``) on the CPU: a
torch model of their tile plan against the Pallas backward, and their
dispatch table and refusals.

The kernels run only on the card (tests/test_torch_cuda.py).  What can be
checked here is the plan they follow, written out in torch with the
kernels' tile sizes and order: blocks of 64 output rows, streamed tiles of
32 rows, the 512 columns split over two warpgroups, the S^T form and the
two passes of E', rows past the end zero-filled as TMA fills them, streamed
rows past the end masked, P = exp2(S scale log2e - L log2e), and P and dS
rounded to bf16 where the kernels round them.  The model runs on the same
bf16-exact inputs as ``_flash_attention_bwd_impl`` (interpret mode) and is
held to it at ragged shapes whose last tile and last block are partial.

Tolerance: both sides store bf16, whose step at the largest magnitude of
an output is 2^-8 (3.9e-3) of it; exp2 against exp and another summation
order can move a rounding of P, dS or the output by one step, so each
output is held within 1e-2 of its largest magnitude (2.5 steps).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vae_tagger_tpu.ops.pallas.flash_attention import (
    _flash_attention_bwd_impl,
    _flash_attention_fwd_impl,
)
from vae_tagger_tpu_torch.ops import _build, attention, backend

D = 512     # the one head width D' and E' take
BM = 64     # output rows a block
BN = 32     # streamed rows a tile
HALF = D // 2  # output columns a consumer warpgroup owns
LOG2E = 1.4426950408889634
BIG = 1e30


def _bf16(t):
    return t.bfloat16().float()


def _rows(t, start, n):
    """Rows [start, start + n) of a (B, S, ...) tensor, zero past S: what a
    TMA box past the end of the tensor holds."""
    part = t[:, start:start + n]
    pad = n - part.shape[1]
    return torch.cat([part, part.new_zeros(part.shape[0], pad,
                                           *part.shape[2:])], 1)


def _halves(a, tile):
    """a (B, 64, 32) times tile (B, 32, D), each warpgroup its 256 columns."""
    return torch.cat([a @ tile[..., w * HALF:(w + 1) * HALF]
                      for w in range(2)], -1)


def _per_row(vals, start, n, valid, fill):
    """L or Dl of rows [start, start + n): `fill` past `valid`."""
    idx = start + torch.arange(n)
    out = _rows(vals[..., None], start, n)[..., 0]
    return torch.where(idx < valid, out, torch.full_like(out, fill))


def _mirror_pass(a1, a2, b1, b2, lse, delta, scale, rows_are_q):
    """D' (rows_are_q) or E''s dK pass: a1/a2 resident, b1/b2 streamed;
    warpgroup 0 computes X = a1 b1^T over all of D, warpgroup 1 Y = a2
    b2^T; dS = P (Y - Dl) in bf16; out[:, half] += dS b1[:, half]."""
    bsz, rows, _ = a1.shape
    cols = b1.shape[1]
    out = torch.empty(bsz, rows, D)
    for r0 in range(0, rows, BM):
        ra1, ra2 = _rows(a1, r0, BM), _rows(a2, r0, BM)
        if rows_are_q:  # L and Dl per output row, fixed over the tiles
            l2 = _per_row(lse, r0, BM, rows, BIG)[..., :, None] * LOG2E
            dl = _per_row(delta, r0, BM, rows, 0.0)[..., :, None]
        acc = torch.zeros(bsz, BM, D)
        for j in range(math.ceil(cols / BN)):
            t1, t2 = _rows(b1, j * BN, BN), _rows(b2, j * BN, BN)
            x = ra1 @ t1.transpose(1, 2)  # S (or S^T), warpgroup 0
            y = ra2 @ t2.transpose(1, 2)  # dP (or dP^T), warpgroup 1
            if not rows_are_q:  # per streamed q column, read each tile
                l2 = _per_row(lse, j * BN, BN, cols, BIG)[..., None, :] * LOG2E
                dl = _per_row(delta, j * BN, BN, cols, 0.0)[..., None, :]
            live = (j * BN + torch.arange(BN)) < cols
            p = torch.where(live, torch.exp2(x * (scale * LOG2E) - l2), 0.0)
            acc += _halves(_bf16(p * (y - dl)), t1)
        n = min(BM, rows - r0)
        out[:, r0:r0 + n] = _bf16(acc * scale)[:, :n]
    return out


def _dv_pass(k, q, do, lse, scale):
    """E''s dV pass: K resident, Q and dO streamed; S^T = K Q^T split-K
    over the two warpgroups' halves of D and added; P^T in bf16;
    dV[:, half] += P^T dO[:, half]."""
    bsz, skv, _ = k.shape
    sq = q.shape[1]
    out = torch.empty(bsz, skv, D)
    for r0 in range(0, skv, BM):
        kr = _rows(k, r0, BM)
        acc = torch.zeros(bsz, BM, D)
        for j in range(math.ceil(sq / BN)):
            qt, dot = _rows(q, j * BN, BN), _rows(do, j * BN, BN)
            part = [kr[..., w * HALF:(w + 1) * HALF]
                    @ qt[..., w * HALF:(w + 1) * HALF].transpose(1, 2)
                    for w in range(2)]
            st = part[0] + part[1]
            l2 = _per_row(lse, j * BN, BN, sq, BIG)[..., None, :] * LOG2E
            live = (j * BN + torch.arange(BN)) < sq
            p = torch.where(live, torch.exp2(st * (scale * LOG2E) - l2), 0.0)
            acc += _halves(_bf16(p), dot)
        n = min(BM, skv - r0)
        out[:, r0:r0 + n] = _bf16(acc)[:, :n]
    return out


def bwd_tile_plan(q, k, v, do, lse, delta):
    """(dQ, dK, dV) as D' and E' compute them, from bf16-exact fp32
    inputs, L and Dl (B, Sq)."""
    scale = 1.0 / math.sqrt(D)
    dq = _mirror_pass(q, do, k, v, lse, delta, scale, rows_are_q=True)
    dv = _dv_pass(k, q, do, lse, scale)
    dk = _mirror_pass(k, v, q, do, lse, delta, scale, rows_are_q=False)
    return dq, dk, dv


@pytest.mark.parametrize("b,sq,skv", [
    (1, 130, 45),   # Sq: two blocks + 2 rows; Skv: one tile + 13 keys
    (2, 45, 130),   # the same, the other way round
    (1, 70, 20),    # one key tile, partial
    (2, 96, 64),    # Skv a multiple of the tile and the block
])
def test_tile_plan_matches_the_pallas_backward(b, sq, skv):
    rng = np.random.default_rng(b * 1000 + sq + skv)

    def bf16_exact(*shape):
        return _bf16(torch.from_numpy(rng.normal(size=shape)
                                      .astype(np.float32))).numpy()

    q, do = bf16_exact(b, sq, D), bf16_exact(b, sq, D)
    k, v = bf16_exact(b, skv, D), bf16_exact(b, skv, D)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        o, lse = _flash_attention_fwd_impl(jq, jk, jv)
        want = _flash_attention_bwd_impl(jq, jk, jv, o, lse, jdo)
    o = torch.from_numpy(np.asarray(o.astype(jnp.float32)))
    lse = torch.from_numpy(np.asarray(lse, np.float32))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    delta = attention.bwd_delta(o, tdo)
    got = bwd_tile_plan(tq, tk, tv, tdo, lse, delta)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-2, (name, err)


@pytest.mark.parametrize("b,sq,skv", [(1, 130, 45), (2, 70, 20)])
def test_tile_plan_matches_the_plain_versions(b, sq, skv):
    """The same plan against the port's plain versions of D' and E' on
    bf16 inputs (the yardstick chip_smoke.py holds the kernels to), under
    the same 1e-2 of the largest magnitude."""
    g = torch.Generator().manual_seed(sq * skv)
    q, do = (_bf16(torch.randn(b, sq, D, generator=g)) for _ in range(2))
    k, v = (_bf16(torch.randn(b, skv, D, generator=g)) for _ in range(2))
    o, lse = attention.flash_attention_fwd_plain(q, k, v)
    delta = attention.bwd_delta(o, do)
    bf = [t.bfloat16() for t in (q, k, v, do)]
    want = (attention.flash_attention_bwd_dq_plain(*bf, lse, delta),
            *attention.flash_attention_bwd_dkv_plain(*bf, lse, delta))
    for gt, w in zip(bwd_tile_plan(q, k, v, do, lse, delta), want):
        w = w.float()
        assert ((gt - w).abs().max() / w.abs().max()).item() <= 1e-2


def test_backward_dispatch_table():
    """bf16 -> D' and E', fp32 -> D'' and E'' (one library each, E' and E''
    two launches a call); each entry names a built library, its C function
    and its own launch counter."""
    table = attention.BWD_KERNELS
    assert set(table) == {torch.bfloat16, torch.float32}
    counters = set()
    for dt, parts in table.items():
        assert set(parts) == {"dq", "dkv"}
        suffix = "_tc" if dt == torch.bfloat16 else "_tf32x3"
        assert attention.bwd_kernels_for(torch.zeros(1, 4, D, dtype=dt)) \
            == parts
        for stem, fn, counter in parts.values():
            assert stem.endswith(suffix) and counter.endswith(suffix)
            assert fn in _build.SIGNATURES[stem]
            assert counter in backend.LAUNCHES
            counters.add(counter)
    assert len(counters) == 4
    assert attention.LAUNCHES_PER_CALL == {"vt_flash_attn_bwd_dkv_tc": 2,
                                           "vt_flash_attn_bwd_dkv_tf32x3": 2}
    with pytest.raises(TypeError):
        attention.bwd_kernels_for(torch.zeros(1, 4, D, dtype=torch.float16))


@pytest.mark.parametrize("d", [64, 128, 256, 1024])
def test_tc_backward_refuses_head_widths(d):
    with pytest.raises(ValueError, match="head width"):
        attention.bwd_kernels_for(torch.zeros(1, 4, d, dtype=torch.bfloat16))
    # fp32 goes to D'' and E'', which take 512 alone too
    with pytest.raises(ValueError, match="head width"):
        attention.bwd_kernels_for(torch.zeros(1, 4, d))


def test_count_launch_adds_the_kernels_of_one_call():
    backend.reset_launch_counts()
    backend.count_launch("flash_attention_bwd_dkv_tc", 2)
    backend.count_launch("flash_attention_bwd_dq_tc")
    assert {k: n for k, n in backend.launch_counts().items() if n} == {
        "flash_attention_bwd_dkv_tc": 2, "flash_attention_bwd_dq_tc": 1}
    backend.reset_launch_counts()
