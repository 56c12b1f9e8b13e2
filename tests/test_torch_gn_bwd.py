"""The backward of the GroupNorm and fused-conv sites on the CPU, as the
kernel path computes it (no forward rerun): ``gn_silu_conv3x3_vjp`` (A's
apply pass recomputing the activation, ``aten.convolution_backward``, the
residual and shortcut gradients, then kernel F) and
``group_norm_silu_vjp`` (kernel F alone), each on its plain pieces here,
against the JAX package:

- every fused variant (plain, residual, 1x1 shortcut) and the A site (with
  and without the SiLU) against ``jax.vjp`` of
  ``vae_tagger_tpu.ops.conv.gn_silu_conv3x3`` and
  ``ops.normalization.group_norm_silu`` (their XLA reference on the CPU):
  fp32 at rtol 1e-4 / atol 1e-5; bf16 against JAX's fp32 VJP within 4x
  the reference form's own bf16 VJP error (relative to the largest
  magnitude), every gradient: JAX's at the A site, the port's VJP of the
  same form at a fused site (JAX's bf16 VJP of the fused op does not
  trace);
- the two from-statistics forms (the height slabs') against autograd of
  their plain versions, dmean and dmeansq included (rtol 1e-4 / atol
  1e-5);
- ``group_norm_silu_backward_plain`` (kernel F's plain version) against
  autograd of ``group_norm_silu_from_stats_plain`` and of
  ``group_norm_silu_plain`` (statistics of x's own);
- the four autograd Functions' kernel-path backward, with the launches
  stood in by their plain versions, against ``jax.vjp``, and its launches:
  F once a site, A's apply pass once a fused site, no forward conv;
- kernel F's plan (``gn_plan`` at F's own blocks an SM, ``_f_plan``): the
  rows its threads walk, forward in the reduce pass and from the last in
  the apply pass, cover every (row, channel) once; one wave at most; the
  plan passes ``csrc/gn_plan.cuh::check_plan``'s rules; the resident count
  is read from the runtime once a variant.

Inputs come from a seeded numpy generator at N=2, 7x6, 32 channels to 32
or 48, 8 groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_tagger_tpu.ops.conv import gn_silu_conv3x3 as jax_gn_silu_conv3x3
from vae_tagger_tpu.ops.normalization import (
    group_norm_silu as jax_group_norm_silu,
)
from vae_tagger_tpu_torch.ops import backend, conv, normalization
from vae_tagger_tpu_torch.ops.conv import (
    gn_silu_conv3x3,
    gn_silu_conv3x3_from_stats,
    gn_silu_conv3x3_from_stats_plain,
    gn_silu_conv3x3_plain,
    gn_silu_conv3x3_vjp,
)
from vae_tagger_tpu_torch.ops.normalization import (
    GN_THREADS,
    effective_affine,
    gn_plan,
    group_norm_silu,
    group_norm_silu_backward_plain,
    group_norm_silu_from_stats,
    group_norm_silu_from_stats_plain,
    group_norm_silu_plain,
    group_norm_silu_vjp,
    group_stats_plain,
    vjp_of_plain,
)

GROUPS, EPS = 8, 1e-6
RTOL, ATOL = 1e-4, 1e-5
VARIANTS = ("plain", "residual", "shortcut")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two threads in this process: the suite's workers share the host's
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _cpu_only():
    backend.reset_launch_counts()
    yield
    assert sum(backend.launch_counts().values()) == 0


def _site(variant, seed=12):
    """(arrays, g): numpy inputs of one site, in the op's argument order,
    and the output's cotangent.  ``variant`` is a fused variant, or
    "gn_silu" / "gn" for the A site with and without the SiLU."""
    rng = np.random.default_rng(seed)
    cin = 32
    cout = 48 if variant == "shortcut" else cin
    x = rng.normal(size=(2, 7, 6, cin)) + 0.3
    arrs = [x, rng.normal(size=(cin,)) * 0.2 + 1,
            rng.normal(size=(cin,)) * 0.1]
    if variant in VARIANTS:
        arrs += [rng.normal(size=(3, 3, cin, cout)) * 0.05,
                 rng.normal(size=(cout,)) * 0.1]
    if variant == "residual":
        arrs.append(rng.normal(size=(2, 7, 6, cout)))
    if variant == "shortcut":
        arrs += [rng.normal(size=(2, 7, 6, cin)),
                 rng.normal(size=(cin, cout)) * 0.1,
                 rng.normal(size=(cout,)) * 0.1]
    g = rng.normal(size=(2, 7, 6, cout))
    return [a.astype(np.float32) for a in arrs], g.astype(np.float32)


def _jax_vjp(variant, arrs, g, dtype):
    """jax.vjp of the JAX package's op, every input and g in ``dtype``;
    the gradients as fp32 numpy arrays."""
    if variant in VARIANTS:
        fn = lambda *a: jax_gn_silu_conv3x3(*a, num_groups=GROUPS)  # noqa
    else:
        fn = lambda *a: jax_group_norm_silu(  # noqa: E731
            *a, num_groups=GROUPS, apply_silu=variant == "gn_silu")
    _, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in arrs))
    return [np.asarray(t.astype(jnp.float32))
            for t in vjp(jnp.asarray(g, dtype))]


def _structured(variant, arrs, g, dtype):
    """The kernel path's backward on its plain pieces: the statistics in
    fp32 from x, as the forward's stats pass takes them; gradients in the
    op's argument order."""
    ts = [torch.from_numpy(a).to(dtype) for a in arrs]
    gt = torch.from_numpy(g).to(dtype)
    mean, meansq = group_stats_plain(ts[0], GROUPS)
    if variant in VARIANTS:
        out = gn_silu_conv3x3_vjp(gt, *ts, mean=mean, meansq=meansq, eps=EPS)
        grads = (out[0],) + out[3:3 + len(ts) - 1]
    else:
        dx, _, _, dscale, dbias = group_norm_silu_vjp(
            gt, *ts[:1], mean, meansq, *ts[1:], eps=EPS,
            apply_silu=variant == "gn_silu")
        grads = (dx, dscale, dbias)
    for t, a in zip(grads, ts):
        assert t.dtype == a.dtype and t.shape == a.shape
    return [t.float().numpy() for t in grads]


def _reference_bf16_vjp(variant, arrs, g):
    """The bf16 VJP of the reference form: JAX's at the A site; at a fused
    site the port's VJP of the same form (``vjp_of_plain`` of
    ``gn_silu_conv3x3_plain``, the CPU backward), because JAX's bf16 VJP of
    the fused op does not trace (its conv's transpose meets the fp32
    cotangent of ``preferred_element_type`` and a bf16 kernel)."""
    if variant not in VARIANTS:
        return _jax_vjp(variant, arrs, g, jnp.bfloat16)
    ts = [torch.from_numpy(a).bfloat16() for a in arrs]
    grads = vjp_of_plain(
        lambda *a: gn_silu_conv3x3_plain(*a, num_groups=GROUPS, eps=EPS),
        ts, torch.from_numpy(g).bfloat16())
    return [t.float().numpy() for t in grads]


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", [*VARIANTS, "gn_silu", "gn"])
def test_structured_backward_matches_jax_vjp(variant, dtype):
    """fp32: every gradient within rtol 1e-4 / atol 1e-5 of jax.vjp.
    bf16: every gradient's error against JAX's fp32 VJP within 4x that of
    the reference form's bf16 VJP (F computes in fp32 and rounds once,
    where the reference's VJP rounds the affine and SiLU's product to
    bf16)."""
    arrs, g = _site(variant)
    want = _jax_vjp(variant, arrs, g, jnp.float32)
    got = _structured(variant, arrs, g, getattr(torch, dtype))
    assert len(got) == len(want) == len(arrs)
    if dtype == "float32":
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        return
    own = _reference_bf16_vjp(variant, arrs, g)
    for i, (a, b, o) in enumerate(zip(got, want, own)):
        assert _rel(a, b) <= 4 * _rel(o, b), (i, _rel(a, b), _rel(o, b))


@pytest.mark.parametrize("variant", [*VARIANTS, "gn_silu", "gn"])
def test_from_stats_backward_matches_autograd(variant):
    """The height slabs' forms: gradients to x, the statistics (dmean,
    dmeansq), the scale and bias and the conv's inputs against autograd of
    the plain versions, fp32."""
    arrs, g = _site(variant, seed=21)
    x = torch.from_numpy(arrs[0])
    mean, meansq = group_stats_plain(x, GROUPS)
    # statistics of the whole image, not of this slab's rows
    mean, meansq = mean + 0.05, meansq * 1.1
    ins = [x, mean, meansq, *map(torch.from_numpy, arrs[1:])]
    leaves = [t.clone().requires_grad_() for t in ins]
    gt = torch.from_numpy(g)
    if variant in VARIANTS:
        y = gn_silu_conv3x3_from_stats_plain(*leaves, eps=EPS)
        got = gn_silu_conv3x3_vjp(gt, ins[0], *ins[3:], mean=mean,
                                  meansq=meansq, eps=EPS, stats_term=False)
    else:
        silu = variant == "gn_silu"
        y = group_norm_silu_from_stats_plain(*leaves, eps=EPS,
                                             apply_silu=silu)
        got = group_norm_silu_vjp(gt, *ins, eps=EPS, apply_silu=silu,
                                  stats_term=False)
    want = torch.autograd.grad(y, leaves, gt)
    assert len(got[:len(ins)]) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stats_term", [True, False])
@pytest.mark.parametrize("silu", [True, False])
def test_backward_plain_matches_autograd(silu, stats_term):
    """Kernel F's plain version: with ``stats_term`` against autograd of
    ``group_norm_silu_plain`` (the statistics x's own, dx carrying their
    gradient), else of ``group_norm_silu_from_stats_plain`` (dmean and
    dmeansq out)."""
    arrs, g = _site("gn_silu", seed=31)
    x, scale, bias = map(torch.from_numpy, arrs)
    mean, meansq = group_stats_plain(x, GROUPS)
    es, eb = effective_affine(mean, meansq, scale, bias, x.shape[-1], EPS)
    gt = torch.from_numpy(g)
    dx, dscale, dbias, dmean, dmeansq = group_norm_silu_backward_plain(
        x, gt, mean, meansq, scale, es, eb, eps=EPS, apply_silu=silu,
        stats_term=stats_term)
    if stats_term:
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        y = group_norm_silu_plain(*leaves, num_groups=GROUPS, eps=EPS,
                                  apply_silu=silu)
        got = (dx, dscale, dbias)
        assert dmean is None and dmeansq is None
    else:
        leaves = [t.clone().requires_grad_()
                  for t in (x, mean, meansq, scale, bias)]
        y = group_norm_silu_from_stats_plain(*leaves, eps=EPS,
                                             apply_silu=silu)
        got = (dx, dmean, dmeansq, dscale, dbias)
    for a, b in zip(got, torch.autograd.grad(y, leaves, gt)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


@pytest.fixture
def kernel_path(monkeypatch):
    """The kernel path of the four Functions on the CPU: ``use_kernel``
    true, and each launch stood in by its plain version with the
    wrapper's outputs (the forward's statistics included), so that the
    Functions' backward takes the structured path and counts its
    launches.  cuDNN's conv backward is ``aten.convolution_backward``
    either way."""
    def stats(x, scale, bias, num_groups, eps):
        mean, meansq = group_stats_plain(x, num_groups)
        return (mean, meansq, *effective_affine(mean, meansq, scale, bias,
                                                x.shape[-1], eps))

    def fused(x, gs, gb, k, b, res, sck, scb, num_groups, eps):
        backend.count_launch("group_stats")
        return (gn_silu_conv3x3_plain(x, gs, gb, k, b, res, sck, scb,
                                      num_groups=num_groups, eps=eps),
                "gn_silu_conv3x3_tf32x3", stats(x, gs, gb, num_groups, eps))

    def from_stats(x, mean, meansq, gs, gb, k, b, res, sck, scb, eps):
        return (gn_silu_conv3x3_from_stats_plain(
            x, mean, meansq, gs, gb, k, b, res, sck, scb, eps=eps),
            "gn_silu_conv3x3_tf32x3")

    def gn(x, scale, bias, num_groups, eps, apply_silu):
        st = stats(x, scale, bias, num_groups, eps)
        return (normalization.group_norm_silu_apply_plain(
            x, *st[2:], apply_silu=apply_silu), st)

    def bwd(x, dact, mean, meansq, scale, es, eb, eps, apply_silu,
            stats_term):
        return group_norm_silu_backward_plain(
            x, dact, mean, meansq, scale, es, eb, eps=eps,
            apply_silu=apply_silu, stats_term=stats_term)

    monkeypatch.setattr(backend, "use_kernel", lambda t: True)
    monkeypatch.setattr(conv, "_gn_silu_conv3x3_kernel", fused)
    monkeypatch.setattr(conv, "_gn_silu_conv3x3_from_stats_kernel",
                        from_stats)
    monkeypatch.setattr(normalization, "_group_norm_silu_kernel", gn)
    monkeypatch.setattr(normalization, "_gn_apply_kernel",
                        lambda x, es, eb, silu: normalization.
                        group_norm_silu_apply_plain(x, es, eb,
                                                    apply_silu=silu))
    monkeypatch.setattr(normalization, "_group_norm_silu_backward_kernel",
                        bwd)
    monkeypatch.setattr(normalization, "vjp_of_plain", None)
    monkeypatch.setattr(conv, "vjp_of_plain", None)
    yield
    backend.reset_launch_counts()


@pytest.mark.parametrize("form", ["fused", "fused_from_stats", "gn",
                                  "gn_from_stats"])
def test_functions_take_the_structured_backward(kernel_path, form):
    """On the kernel path each Function's backward is the structured one
    (vjp_of_plain is not reachable): the gradients of every input against
    jax.vjp of the JAX op (fp32; the from-statistics forms against
    autograd of their plain versions), and the launches of one forward and
    backward: F once, A's apply pass once (a fused site's recompute, or
    the A form's forward), the fused forward's kernels once."""
    variant = "shortcut" if form.startswith("fused") else "gn_silu"
    arrs, g = _site(variant, seed=41)
    ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
    gt = torch.from_numpy(g)
    backend.reset_launch_counts()
    if form in ("fused", "gn"):
        y = (gn_silu_conv3x3(*ins, num_groups=GROUPS) if form == "fused"
             else group_norm_silu(*ins, num_groups=GROUPS))
        got = torch.autograd.grad(y, ins, gt)
        want = _jax_vjp(variant, arrs, g, jnp.float32)
    else:
        mean, meansq = (t.detach().requires_grad_()
                        for t in group_stats_plain(ins[0], GROUPS))
        leaves = [ins[0], mean, meansq, *ins[1:]]
        y = (gn_silu_conv3x3_from_stats(*leaves) if form == "fused_from_stats"
             else group_norm_silu_from_stats(*leaves))
        got = torch.autograd.grad(y, leaves, gt)
        plain = (gn_silu_conv3x3_from_stats_plain
                 if form == "fused_from_stats"
                 else group_norm_silu_from_stats_plain)
        ref = [t.detach().clone().requires_grad_() for t in leaves]
        want = [t.numpy() for t in torch.autograd.grad(plain(*ref), ref, gt)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=RTOL,
                                   atol=ATOL)
    counts = {k: n for k, n in backend.launch_counts().items() if n}
    fused = form.startswith("fused")
    expect = {"group_norm_silu_bwd": 1, "group_norm_silu": 1}
    if fused:
        expect["gn_silu_conv3x3_tf32x3"] = 1
    if form == "fused":
        expect["group_stats"] = 1
    assert counts == expect


# --------------------------------------------------------------------------
# kernel F's plan
# --------------------------------------------------------------------------

def _check_plan(n, s, c, itemsize, plan, aligned):
    """csrc/gn_plan.cuh::check_plan's rules, in order: True where the
    kernels take the plan."""
    if n <= 0 or n > 65535 or s <= 0 or c <= 0 or plan.rows <= 0 \
            or plan.blocks <= 0:
        return False
    if plan.blocks * plan.rows < s or (plan.blocks - 1) * plan.rows >= s:
        return False
    if plan.vec != 1 and (plan.vec != 16 // itemsize or c % plan.vec
                          or not aligned):
        return False
    slots = c // plan.vec
    strip = min(slots, GN_THREADS)
    if plan.strips != -(-slots // strip) or plan.strips > 65535:
        return False
    return plan.blocks * plan.strips <= 1 << 30


def _walks(plan, s, c):
    """How often the plan's threads visit each (row, channel) of a sample,
    as csrc/gn_plan.cuh::geo places them and csrc/groupnorm_silu_bwd.cu's
    Rows walks them: thread (row, lane) of block (p, z) takes rows r0 +
    row + k * rows_par, k < cnt, of span [p * rows, min((p + 1) * rows, S));
    the apply pass walks them from k = cnt - 1, which must be the same rows
    backward."""
    slots = c // plan.vec
    strip = min(slots, GN_THREADS)
    rows_par = GN_THREADS // strip
    visits = np.zeros((s, c), np.int64)
    for z in range(plan.strips):
        nslot = min(strip, slots - z * strip)
        for t in range(GN_THREADS):
            lane, row = t % strip, t // strip
            if row >= rows_par or lane >= nslot:
                continue
            ch = (z * strip + lane) * plan.vec
            for p in range(plan.blocks):
                r0, r1 = p * plan.rows, min((p + 1) * plan.rows, s)
                cnt = max(0, -(-(r1 - r0 - row) // rows_par))
                fwd = [r0 + row + k * rows_par for k in range(cnt)]
                back = [r0 + row + (cnt - 1 - k) * rows_par
                        for k in range(cnt)]
                assert back == fwd[::-1] and all(r < r1 for r in fwd)
                visits[fwd, ch:ch + plan.vec] += 1
    return visits


# (N, S, C, itemsize, aligned): ragged S, C = 36 (one element a thread in
# bf16, 4-wide vectors in fp32), 300 (two strips of single elements in
# bf16), 4096 (two and four strips of vectors), N up to 5, S below one span
F_PLAN_CASES = [
    (5, 9 * 13, 96, 2, True),
    (5, 9 * 13, 96, 4, False),
    (2, 3 * 5, 36, 2, True),
    (2, 3 * 5, 36, 4, True),
    (2, 3, 300, 2, True),
    (3, 1037, 300, 4, True),
    (1, 35, 4096, 2, True),
    (4, 35, 4096, 4, True),
    (5, 4097, 128, 2, True),
]


@pytest.mark.parametrize("resident", [1, 3, 4])
@pytest.mark.parametrize("n,s,c,itemsize,aligned", F_PLAN_CASES)
def test_f_plan_walks_every_row_once(n, s, c, itemsize, aligned, resident):
    """At F's own blocks an SM the plan passes check_plan, and the rows its
    threads walk (forward and backward) cover every (row, channel) of a
    sample exactly once, on a few SMs (many spans a sample) and on 132."""
    for sms in (3, 132):
        plan = gn_plan(n, s, c, itemsize, aligned, sms, resident)
        assert _check_plan(n, s, c, itemsize, plan, aligned), plan
        assert (_walks(plan, s, c) == 1).all(), plan


@pytest.mark.parametrize("resident", [1, 2, 3, 4])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_f_plan_is_one_wave(itemsize, resident):
    """At most one wave of ``resident`` blocks an SM at the GroupNorm sites
    of a train_full step (3 images at 1024px), the decoder's (batch 1) and
    a slab's (4 images, 513 x 1024), the ragged cases above included, and
    a full one where a sample's rows allow: every block streams one span."""
    sites = [(3, hw * hw, c) for hw, c in ((1024, 128), (512, 128),
                                           (512, 256), (256, 256),
                                           (256, 512), (128, 512))]
    sites += [(1, 512 * 512, 512), (1, 1024 * 1024, 256), (4, 513 * 1024, 128)]
    sites += [(n, s, c) for n, s, c, _, _ in F_PLAN_CASES]
    for n, s, c in sites:
        plan = gn_plan(n, s, c, itemsize, True, 132, resident)
        wave = 132 * resident
        assert _check_plan(n, s, c, itemsize, plan, True)
        assert n * plan.blocks * plan.strips <= max(wave, n * plan.strips)
        if s >= 64 * 1024:  # long samples fill the wave to a block a span
            assert n * plan.blocks * plan.strips > wave * 0.9, (n, s, c)


def test_f_plan_reads_the_resident_count_once(monkeypatch):
    """_f_plan asks the runtime (vt_gn_bwd_blocks_per_sm) once a variant
    (device, dtype, vector, SiLU) and sizes the grid to one wave of what it
    answered; 16-byte vectors only where every tensor is aligned."""
    import ctypes

    asked = []

    class Lib:
        @staticmethod
        def vt_gn_bwd_blocks_per_sm(dtype, vec, silu, out):
            asked.append((dtype, vec, silu))
            ctypes.c_int.from_address(out).value = 2 + silu
            return 0

    monkeypatch.setattr(normalization, "lib", lambda stem: Lib)
    monkeypatch.setattr(normalization, "_F_RESIDENT", {})
    monkeypatch.setitem(normalization._SMS, None, 132)
    x = torch.zeros(3, 64, 64, 128, dtype=torch.bfloat16)
    off = torch.zeros(1 + x.numel(), dtype=torch.bfloat16)[1:].view(x.shape)
    for _ in range(2):
        plans = [normalization._f_plan(x, silu, x) for silu in (True, False)]
    plan_off = normalization._f_plan(x, True, off)
    assert asked == [(1, 8, 1), (1, 8, 0), (1, 1, 1)]
    for plan, resident in zip(plans, (3, 2)):
        assert plan == gn_plan(3, 64 * 64, 128, 2, True, 132, resident)
    assert plan_off.vec == 1
