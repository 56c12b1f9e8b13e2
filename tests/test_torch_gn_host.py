"""Kernel A's partition, on the CPU (the kernel itself runs only on the
card: tests/test_torch_cuda.py and chip_smoke.py).

A torch model of csrc/groupnorm_silu_vec.cu walks the wrapper's own plan
(``gn_plan``): block (p, n, z) reads a span of whole rows of one sample,
each thread one fixed vector of channels on every rows_par-th row of it;
the block folds its threads' per-channel sums into one pair per group; the
last block folds the (block, group) partials in the kernel's fixed order
(8 threads a group over the blocks, then their butterfly).  The model
counts every element it reads, so the plan is seen to cover every row
exactly once, and its statistics and output are held against the JAX
package's ``group_stats``/``effective_affine`` and its two Pallas
GroupNorm kernels (interpret mode), at small ragged shapes in fp32 and
bf16.

Tolerances: statistics and eff_scale/eff_bias rtol 1e-5, atol 1e-6 (fp32
sums taken in another order); fp32 outputs atol 1e-5, as
test_torch_kernels.py; bf16 outputs one bf16 ulp (rtol 2^-7, atol 1e-6):
fp32 values that differ in their last bits may round to neighbouring bf16
values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vae_tagger_tpu.ops.conv import effective_affine as jax_effective_affine
from vae_tagger_tpu.ops.conv import group_stats as jax_group_stats
from vae_tagger_tpu.ops.pallas.groupnorm_silu import (
    group_norm_silu_chunked_pallas,
    group_norm_silu_pallas,
)
from vae_tagger_tpu_torch.ops.normalization import (
    GN_BLOCKS_PER_SM,
    GN_THREADS,
    GN_UNROLL,
    gn_plan,
)

GROUPS = 32
EPS = 1e-6
# few SMs, so that a small sample still splits into several ragged spans
SMS = 2
H, W = 10, 20  # S = 200
FOLD_LANES = 8  # the kernel's kFoldLanes


def _layout(plan, c):
    """(vectors a row, vectors a strip, rows read side by side), as the
    kernel's geo() computes them."""
    slots = c // plan.vec
    strip = min(slots, GN_THREADS)
    return slots, strip, GN_THREADS // strip


def _blocks(plan, n, s, c):
    """Every block of the grid: (sample, index of the block within its
    sample, its strip's channels [c_lo, c_hi), and for each row lane its
    rows)."""
    slots, strip, rows_par = _layout(plan, c)
    for ni in range(n):
        for p in range(plan.blocks):
            r0, r1 = p * plan.rows, min((p + 1) * plan.rows, s)
            for z in range(plan.strips):
                slot0 = z * strip
                nslot = min(strip, slots - slot0)
                yield (ni, p * plan.strips + z,
                       (slot0 * plan.vec, (slot0 + nslot) * plan.vec),
                       [(rl, torch.arange(r0 + rl, max(r0 + rl, r1),
                                          rows_par))
                        for rl in range(rows_par)])


def model_stats(x, groups, plan):
    """The stats pass: (mean, meansq, element visits), fp32."""
    n, s, c = x.shape
    cg, nb = c // groups, plan.blocks * plan.strips
    xf = x.float()
    partial = torch.zeros(n, groups, nb, 2)
    visits = torch.zeros(n, s, c, dtype=torch.int32)
    for ni, b, (c_lo, c_hi), threads in _blocks(plan, n, s, c):
        red = torch.zeros(2, len(threads), c_hi - c_lo)
        for rl, rows in threads:  # one thread per vector of the strip
            v = xf[ni, rows, c_lo:c_hi]
            visits[ni, rows, c_lo:c_hi] += 1
            red[0, rl], red[1, rl] = v.sum(0), (v * v).sum(0)
        for g in range(c_lo // cg, (c_hi - 1) // cg + 1):
            a, e = max(g * cg, c_lo) - c_lo, min((g + 1) * cg, c_hi) - c_lo
            partial[ni, g, b] = red[:, :, a:e].sum((1, 2))
    # the last block: thread l of a group's 8 folds blocks l, l + 8, ... in
    # order, then the 8 threads' butterfly
    lanes = torch.zeros(n, groups, FOLD_LANES, 2)
    for b in range(nb):
        lanes[:, :, b % FOLD_LANES] += partial[:, :, b]
    for o in (4, 2, 1):
        lanes = lanes + lanes[:, :, torch.arange(FOLD_LANES) ^ o]
    count = torch.tensor(float(s), dtype=torch.float32) * float(cg)
    sums = lanes[:, :, 0]
    return sums[..., 0] / count, sums[..., 1] / count, visits


def model_affine(mean, meansq, gamma, beta, c):
    """The last block's eff_scale/eff_bias, per (sample, channel)."""
    reps = c // mean.shape[1]
    rstd = 1.0 / torch.sqrt(meansq - mean * mean + EPS)
    sc = gamma[None, :] * rstd.repeat_interleave(reps, 1)
    return sc, beta[None, :] - mean.repeat_interleave(reps, 1) * sc


def model_apply(x, es, eb, plan, apply_silu):
    """The apply pass in the same plan; NaN where no thread wrote."""
    n, s, c = x.shape
    out = torch.full((n, s, c), float("nan"))
    for ni, _, (c_lo, c_hi), threads in _blocks(plan, n, s, c):
        for _, rows in threads:
            y = (x[ni, rows, c_lo:c_hi].float() * es[ni, c_lo:c_hi]
                 + eb[ni, c_lo:c_hi])
            out[ni, rows, c_lo:c_hi] = y * torch.sigmoid(y) if apply_silu \
                else y
    return out.to(x.dtype)


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, H, W, c)) + 0.3).astype(np.float32)
    gamma = (rng.normal(size=(c,)) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, gamma, beta


def _close(got, want, dtype):
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,s,c,itemsize,aligned", [
    # the 20 stats sites of a 1024px forward and A's sites, batch 4 and the
    # train step's 3, bf16 and fp32
    *[(n, hw * hw, c, size, True) for n in (3, 4) for size in (2, 4)
      for hw, c in ((1024, 128), (512, 128), (512, 256), (256, 256),
                    (256, 512), (128, 512))],
    (1, 517 * 1031, 64, 2, True),
    (70, 15, 32, 4, True),
    (2, 35, 4096, 2, True),
    (2, 99, 300, 2, True),
    (2, 437, 128, 2, False),
])
def test_plan_covers_every_row_once(n, s, c, itemsize, aligned):
    """Spans of whole unrolled steps, ceil(S / rows) of them: every row in
    exactly one span; at most one wave of GN_BLOCKS_PER_SM blocks an SM."""
    plan = gn_plan(n, s, c, itemsize, aligned)
    vec = 16 // itemsize if aligned and c % (16 // itemsize) == 0 else 1
    assert plan.vec == vec
    slots, strip, rows_par = _layout(plan, c)
    assert plan.strips == -(-slots // strip)
    assert plan.rows % (rows_par * GN_UNROLL) == 0
    assert (plan.blocks - 1) * plan.rows < s <= plan.blocks * plan.rows
    if n * plan.strips <= 132 * GN_BLOCKS_PER_SM:
        assert n * plan.blocks * plan.strips <= 132 * GN_BLOCKS_PER_SM


@pytest.mark.parametrize("c,dtype,aligned,sms", [
    (96, "float32", True, SMS), (96, "bfloat16", True, SMS),  # vectors
    (128, "float32", True, SMS), (128, "bfloat16", True, SMS),  # across
    (512, "float32", True, SMS), (512, "bfloat16", True, SMS),  # groups
    (96, "float32", False, SMS), (128, "bfloat16", False, SMS),  # 1 a thread
    (2304, "float32", True, 7), (2304, "bfloat16", True, 7),  # 3, 2 strips
])
def test_model_stats_match_jax(c, dtype, aligned, sms):
    """The model's mean, E[x^2] and eff_scale/eff_bias against the JAX
    package's group_stats and effective_affine; every element read once."""
    x, gamma, beta = _inputs(c, c)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).reshape(2, H * W, c)
    plan = gn_plan(2, H * W, c, xt.element_size(), aligned, sms)
    assert H * W % plan.rows and plan.blocks > 1  # a ragged last span
    mean, meansq, visits = model_stats(xt, GROUPS, plan)
    assert torch.equal(visits, torch.ones_like(visits))
    es, eb = model_affine(mean, meansq, torch.from_numpy(gamma),
                          torch.from_numpy(beta), c)

    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    jm, jq = jax_group_stats(xj, GROUPS)
    jes, jeb = jax_effective_affine(jm, jq, jnp.asarray(gamma),
                                    jnp.asarray(beta), c, EPS)
    for got, want in ((mean, jm), (meansq, jq), (es, jes), (eb, jeb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("c", [96, 128, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["whole", "chunked"])
def test_model_matches_pallas_group_norm(c, dtype, form):
    """The model's two passes (stats, then apply in the same plan) against
    group_norm_silu_pallas and group_norm_silu_chunked_pallas in interpret
    mode; the apply pass writes every element."""
    x, gamma, beta = _inputs(c, 7 * c)
    apply_silu = c != 128  # both forms of the apply
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).reshape(2, H * W, c)
    plan = gn_plan(2, H * W, c, xt.element_size(), True, SMS)
    mean, meansq, _ = model_stats(xt, GROUPS, plan)
    es, eb = model_affine(mean, meansq, torch.from_numpy(gamma),
                          torch.from_numpy(beta), c)
    out = model_apply(xt, es, eb, plan, apply_silu)
    assert not out.float().isnan().any()

    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    args = (xj, jnp.asarray(gamma), jnp.asarray(beta))
    with pltpu.force_tpu_interpret_mode():
        if form == "whole":
            ref = group_norm_silu_pallas(*args, num_groups=GROUPS, eps=EPS,
                                         apply_silu=apply_silu)
        else:
            ref = group_norm_silu_chunked_pallas(
                *args, num_groups=GROUPS, tile=40, eps=EPS,
                apply_silu=apply_silu)
    ref = np.asarray(ref.astype(jnp.float32)).reshape(2, H * W, c)
    _close(out.float().numpy(), ref, dtype)
