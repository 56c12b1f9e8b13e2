"""Normalization primitives over NHWC tensors, and kernels A's and F's
wrappers.

Counterpart of ``vae_tagger_tpu/ops/normalization.py``.  GroupNorm groups
*consecutive* channels (torch ``nn.GroupNorm`` semantics) and takes its
statistics in fp32 whatever the input dtype.

Kernel A (``csrc/groupnorm_silu_vec.cu``; its plan is :func:`gn_plan`)
serves three wrappers here:

- :func:`group_norm_silu`: GroupNorm(+SiLU) -- the stats pass, then the
  apply pass (the VAE's mid-block attention norm and ``conv_norm_out``);
- :func:`group_norm_stats_affine` (and :func:`group_norm_affine`): the
  stats pass alone, giving the statistics and their fold with the affine,
  per-(n, c) ``eff_scale``/``eff_bias``, for the fused conv (ops/conv.py);
- :func:`group_norm_silu_apply`: the apply pass alone, from a given
  effective affine; with the exact SiLU (:data:`EXACT_SILU`), the input
  of kernel B'' (ops/conv.py).

Kernel F (``csrc/groupnorm_silu_bwd.cu``, in A's span and strip rules on a
grid of its own, :func:`_f_plan`) is the backward:
:func:`group_norm_silu_backward` gives dx and the gradients of the scale,
the bias and, where they are an input of their own, the statistics, in two
launches: the reduce pass folds its sums into every gradient but dx.

:func:`group_norm_silu` is a ``torch.autograd.Function``.  On the kernel
path its forward keeps the statistics and its backward is
:func:`group_norm_silu_vjp`: kernel F fed them, as the JAX package's
jitted VJP computes the backward (XLA keeps what the cotangent needs and
fuses the GroupNorm/SiLU backward), with no forward rerun.  On the CPU and
under the ``torch`` backend the backward recomputes the JAX package's
reference form under ``enable_grad`` and takes its VJP
(:func:`vjp_of_plain` of :func:`group_norm_silu_reference`), the custom
VJP's own form, to whose bf16 rounding the CPU tests hold it.

The height-sharded forms (parallel/spatial.py) split the two passes:
:func:`group_stats_with_grad` is the stats pass with an analytic gradient
(a slab's own statistics, combined across slabs), and
:func:`group_norm_silu_from_stats` is the apply pass alone, fed with the
effective affine of given (global) statistics; its backward, with respect
to x and the statistics, is kernel F without the statistics' term in dx on
the kernel path, else the VJP of :func:`group_norm_silu_from_stats_plain`.

The Wan VAE's per-pixel RMS norm (``csrc/rms_norm.cu``, forward only) has
two passes of its own: :func:`rms_norm_stats`, one fp32 factor r = sqrt(C)
/ max(||x||, 1e-12) a pixel, which kernel B' takes in its RMS mode
(ops/conv.py), and :func:`rms_norm_silu_apply`, ``[silu]((x * r) *
gamma)``, the input of kernel B'' in fp32; :func:`rms_norm_silu` runs
both.

Beside them, the plain versions compute the same functions in PyTorch: the
fp32 sum and sum of squares, ``rstd = rsqrt(E[x^2] - mean^2 + eps)``, the
affine and the SiLU in fp32, one cast at the end; the backward's sums and
dx in fp32, one cast.  A wrapper takes the plain version only for a tensor
on the CPU (or under the ``torch`` backend); for a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..utils.profiling import ranged
from . import backend
from ._build import check, dtype_code, lib, on_tensor_device, stream_of


def group_norm(x, scale, bias, *, num_groups: int, eps: float = 1e-6):
    """GroupNorm over an NHWC tensor, two-pass variance (the JAX package's
    reference form); the affine runs in the input dtype."""
    n, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    orig = x.dtype
    xg = x.float().reshape(n, h, w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    y = xg.reshape(n, h, w, c).to(orig)
    return y * scale.to(orig) + bias.to(orig)


def group_norm_silu_reference(x, scale, bias, *, num_groups: int,
                              eps: float = 1e-6, apply_silu: bool = True):
    """The JAX package's reference form of GroupNorm(+SiLU), whose VJP is
    the op's backward there: :func:`group_norm` (two-pass variance, the
    affine in the input dtype), then ``y * sigmoid(y in fp32)`` cast back
    to the input dtype."""
    y = group_norm(x, scale, bias, num_groups=num_groups, eps=eps)
    if apply_silu:
        y = y * torch.sigmoid(y.float()).to(y.dtype)
    return y


def layer_norm(x, scale, bias, *, eps: float = 1e-5):
    """LayerNorm over the last axis, stats in fp32 (torch nn.LayerNorm)."""
    orig = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(orig)
    return y * scale.to(orig) + bias.to(orig)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def group_stats_plain(x, num_groups: int):
    """Per-(sample, group) fp32 mean and E[x^2] over an NHWC tensor."""
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h * w, num_groups, c // num_groups)
    return xf.mean(dim=(1, 3)), (xf * xf).mean(dim=(1, 3))


def effective_affine(mean, meansq, gn_scale, gn_bias, c: int, eps: float):
    """Fold GN stats and affine params into per-(sample, channel) fp32
    scale/bias: rstd = rsqrt(E[x^2] - mean^2 + eps), the kernels' form."""
    reps = c // mean.shape[-1]
    rstd = torch.rsqrt(meansq - mean * mean + eps)
    eff_scale = gn_scale.float()[None, :] * rstd.repeat_interleave(reps, 1)
    eff_bias = gn_bias.float()[None, :] - mean.repeat_interleave(
        reps, 1) * eff_scale
    return eff_scale, eff_bias


def group_norm_silu_apply_plain(x, es, eb, *, apply_silu: bool = True):
    """Kernel A's apply pass in PyTorch: ``[silu](x * es + eb)`` from a
    given (N, C) fp32 effective affine, in fp32, one cast at the end."""
    y = x.float() * es[:, None, None, :] + eb[:, None, None, :]
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_silu_from_stats_plain(x, mean, meansq, scale, bias, *,
                                     eps: float = 1e-6,
                                     apply_silu: bool = True):
    """GroupNorm(+SiLU) of x from given per-(sample, group) fp32
    statistics in PyTorch: the apply pass fed their effective affine."""
    es, eb = effective_affine(mean, meansq, scale, bias, x.shape[-1], eps)
    return group_norm_silu_apply_plain(x, es, eb, apply_silu=apply_silu)


def group_norm_silu_plain(x, scale, bias, *, num_groups: int,
                          eps: float = 1e-6, apply_silu: bool = True):
    """Kernel A's function in PyTorch: fp32 stats, fp32 affine and SiLU."""
    mean, meansq = group_stats_plain(x, num_groups)
    return group_norm_silu_from_stats_plain(x, mean, meansq, scale, bias,
                                            eps=eps, apply_silu=apply_silu)


# --------------------------------------------------------------------------
# kernel A
# --------------------------------------------------------------------------

# the geometry of csrc/groupnorm_silu_vec.cu: threads a block, loads in
# flight a thread, and the blocks an SM the grid is sized for (one wave;
# the kernels' __launch_bounds__ guarantee that many fit)
GN_THREADS = 256
GN_UNROLL = 4
GN_BLOCKS_PER_SM = 4


class GNPlan(NamedTuple):
    """Launch plan of kernel A's two passes over an (N, S, C) tensor: ``vec``
    channels a thread (one 16-byte load, or 1), spans of ``rows`` rows,
    ``blocks`` spans a sample, ``strips`` strips of GN_THREADS vectors a
    row.  Block (p, n, z) reads rows [p * rows, min((p + 1) * rows, S)) of
    sample n; the stats pass writes one partial pair a (block, group)."""
    vec: int
    rows: int
    blocks: int
    strips: int


def gn_vec(c: int, itemsize: int, aligned: bool) -> int:
    """Channels a thread of kernels A and F: one 16-byte vector where C
    allows and the data is 16-byte aligned, else one element."""
    vec = 16 // itemsize
    return vec if aligned and c % vec == 0 else 1


def gn_plan(n: int, s: int, c: int, itemsize: int, aligned: bool,
            sms: int = 132, blocks_per_sm: int = GN_BLOCKS_PER_SM) -> GNPlan:
    """The plan of kernel A (and, at its own ``blocks_per_sm``, of kernel F:
    :func:`_f_plan`) on ``sms`` SMs: :func:`gn_vec` channels a thread;
    spans of whole unrolled steps, at most ``blocks_per_sm`` blocks an SM in
    all (one wave), so that every block streams one long contiguous span.
    ``blocks`` is ceil(S / rows): the spans cover every row exactly once."""
    vec = gn_vec(c, itemsize, aligned)
    slots = c // vec
    strip = min(slots, GN_THREADS)
    strips = -(-slots // strip)
    step = (GN_THREADS // strip) * GN_UNROLL
    per_sample = max(1, sms * blocks_per_sm // (n * strips))
    rows = -(-s // per_sample)
    rows = -(-rows // step) * step
    return GNPlan(vec, rows, -(-s // rows), strips)


_SMS: dict = {}
# per (device, stream): [arrival counters (int32, 0 between launches: A's
# one a sample; F's one a (sample, group of spans), one a sample and one over
# the samples), fp32 scratch for what a launch writes and no caller keeps]
_SCRATCH: dict = {}


def _sms(dev) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch_plan(x, *others) -> GNPlan:
    """The plan of a launch of kernel A over x; 16-byte vectors only where
    x and every other tensor of the launch are 16-byte aligned."""
    n, h, w, c = x.shape
    return gn_plan(n, h * w, c, x.element_size(), _aligned(x, *others),
                   _sms(x.device.index))


def _scratch(x, stream: int, floats: int, counters: int = 0):
    """At least ``counters`` arrival counters (one a sample of x if fewer)
    and ``floats`` of scratch for x's device and stream.  Launches on one
    stream run in order, so each may reuse what the last one wrote; the
    counters are zeros once and every launch leaves them so (the blocks
    that arrive last reset them)."""
    key = (x.device, stream)
    entry = _SCRATCH.get(key)
    if entry is None:
        entry = _SCRATCH[key] = [None, None]
    counters = max(counters, x.shape[0])
    if entry[0] is None or entry[0].numel() < counters:
        entry[0] = torch.zeros(max(counters, 64), dtype=torch.int32,
                               device=x.device)
    if entry[1] is None or entry[1].numel() < floats:
        entry[1] = torch.empty(floats, dtype=torch.float32, device=x.device)
    return entry


@on_tensor_device
def _gn_stats_launch(x, num_groups: int, eps: float, gamma=None, beta=None,
                     out=None):
    """Launch the stats pass (one kernel) on a contiguous CUDA tensor x.
    ``out`` maps "mean", "meansq", "es", "eb" to fp32 tensors that the
    caller keeps; the others (eff_* only with gamma/beta) and the partial
    pairs go to the scratch.  Returns (plan, address of eff_scale, address
    of eff_bias)."""
    n, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    plan = _launch_plan(x)
    stream = stream_of(x)
    out = out or {}
    sizes = {"partial": 2 * n * num_groups * plan.blocks * plan.strips,
             "mean": n * num_groups, "meansq": n * num_groups}
    if gamma is not None:
        sizes.update(es=n * c, eb=n * c)
    # 16-byte aligned offsets: kernels B' and B'' load eff_* 16 bytes a time
    offs, end = {}, 0
    for name, size in sizes.items():
        if name not in out:
            offs[name] = end
            end += -(-size // 4) * 4
    arrivals, scratch = _scratch(x, stream, end)
    ptr = {name: out[name].data_ptr() if name in out
           else scratch.data_ptr() + 4 * offs[name] for name in sizes}
    if gamma is not None:
        gamma = gamma.to(dtype=torch.float32).contiguous()
        beta = beta.to(dtype=torch.float32).contiguous()
    err = lib("groupnorm_silu_vec").vt_gn_stats_vec(
        x.data_ptr(), dtype_code(x), n, h * w, c, num_groups, plan.vec,
        plan.rows, plan.blocks, plan.strips,
        None if gamma is None else gamma.data_ptr(),
        None if beta is None else beta.data_ptr(), float(eps),
        ptr["partial"], arrivals.data_ptr(), ptr["mean"], ptr["meansq"],
        ptr.get("es"), ptr.get("eb"), stream)
    check(err, "vt_gn_stats_vec")
    return plan, ptr.get("es"), ptr.get("eb")


def group_stats(x, num_groups: int):
    """(mean, E[x^2]) per (sample, group), fp32, shape (N, G)."""
    if backend.use_kernel(x):
        mean, meansq = (torch.empty(x.shape[0], num_groups,
                                    dtype=torch.float32, device=x.device)
                        for _ in range(2))
        _gn_stats_launch(x.contiguous(), num_groups, 0.0,
                         out=dict(mean=mean, meansq=meansq))
        backend.count_launch("group_stats")
        return mean, meansq
    return group_stats_plain(x, num_groups)


_STATS = ("mean", "meansq", "es", "eb")


def _stats_launch_kept(x, num_groups, eps, gamma, beta):
    """The stats pass on a contiguous CUDA tensor x, writing (mean, E[x^2])
    (N, G) and (eff_scale, eff_bias) (N, C), fp32, into views of one buffer
    that the caller keeps (each view 16-byte aligned: kernels B' and B''
    load eff_* 16 bytes a time); returns (plan, (mean, meansq, es, eb))."""
    n, c = x.shape[0], x.shape[-1]
    widths = (num_groups, num_groups, c, c)
    sizes = [-(-n * k // 4) * 4 for k in widths]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    stats = tuple(part[:n * k].view(n, k) for part, k in zip(
        buf.split(sizes), widths))
    plan, _, _ = _gn_stats_launch(x, num_groups, eps, gamma, beta,
                                  dict(zip(_STATS, stats)))
    return plan, stats


def group_norm_stats_affine(x, gn_scale, gn_bias, *, num_groups: int,
                            eps: float = 1e-6):
    """GN stats of x and their fold with the affine: (mean, E[x^2]) (N, G)
    and (eff_scale, eff_bias) (N, C), fp32 -- the fused conv's prologue
    takes the affine, its backward the statistics.  One launch of the stats
    pass on a CUDA tensor."""
    if backend.use_kernel(x):
        _, stats = _stats_launch_kept(x.contiguous(), num_groups, eps,
                                      gn_scale, gn_bias)
        backend.count_launch("group_stats")
        return stats
    mean, meansq = group_stats_plain(x, num_groups)
    return (mean, meansq, *effective_affine(mean, meansq, gn_scale, gn_bias,
                                            x.shape[-1], eps))


def group_norm_affine(x, gn_scale, gn_bias, *, num_groups: int,
                      eps: float = 1e-6):
    """GN stats of x folded with the affine: (eff_scale, eff_bias), (N, C)
    fp32 -- the input of the fused conv's prologue."""
    return group_norm_stats_affine(x, gn_scale, gn_bias,
                                   num_groups=num_groups, eps=eps)[2:]


# ``apply_silu`` of the apply pass: False, True (the SiLU on the SFU, a few
# ulp from the exact one) or this, vt::silu's expf and IEEE division (fp32
# only)
EXACT_SILU = 2


def _gn_apply_launch(x, plan: GNPlan, es: int, eb: int, apply_silu):
    """Launch the apply pass on a contiguous CUDA tensor x with the fp32
    eff_scale/eff_bias (N, C) at addresses ``es``, ``eb``; returns the
    output.  ``apply_silu``: False, True or :data:`EXACT_SILU`."""
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    err = lib("groupnorm_silu_vec").vt_gn_apply_vec(
        x.data_ptr(), dtype_code(x), n, h * w, c, plan.vec, plan.rows,
        plan.blocks, plan.strips, es, eb, out.data_ptr(),
        int(apply_silu), stream_of(x))
    check(err, "vt_gn_apply_vec")
    return out


@on_tensor_device
def _group_norm_silu_kernel(x, scale, bias, num_groups, eps, apply_silu):
    """The stats pass, then the apply pass in the same plan: two launches.
    Returns the output and the statistics (mean, meansq, es, eb) that the
    backward takes."""
    x = x.contiguous()
    plan, stats = _stats_launch_kept(x, num_groups, eps, scale, bias)
    out = _gn_apply_launch(x, plan, stats[2].data_ptr(), stats[3].data_ptr(),
                           apply_silu)
    return out, stats


@on_tensor_device
def _gn_apply_kernel(x, es, eb, apply_silu):
    """The apply pass alone (one launch) from a given effective affine."""
    x = x.contiguous()
    es, eb = (t.float().contiguous() for t in (es, eb))
    return _gn_apply_launch(x, _launch_plan(x), es.data_ptr(), eb.data_ptr(),
                            apply_silu)


def group_norm_silu_apply(x, es, eb, *, apply_silu: bool = True):
    """Kernel A's apply pass alone, ``[silu](x * es + eb)`` from a given
    (N, C) fp32 effective affine: one launch on a CUDA tensor, else the
    plain version.  The height slabs' forward (from the combined
    statistics) and the backward's recompute of the activation."""
    if backend.use_kernel(x):
        out = _gn_apply_kernel(x, es, eb, apply_silu)
        backend.count_launch("group_norm_silu")
        return out
    return group_norm_silu_apply_plain(x, es, eb, apply_silu=apply_silu)


# --------------------------------------------------------------------------
# kernel F: the GroupNorm(+SiLU) backward
# --------------------------------------------------------------------------

def _gn_bwd_terms(p, q, mean, meansq, scale, es, eps):
    """Fold the per-(sample, channel) sums P = sum dz * x and Q = sum dz
    into the gradients of the GroupNorm scale and bias (C,) and of the
    statistics (N, G), fp32, through es = scale * rstd and eb = bias - mean
    * es, rstd = rsqrt(meansq - mean^2 + eps) (the kernels' form).  The
    plain version's fold; kernel F folds the same way in its reduce pass."""
    n, c = p.shape
    groups = mean.shape[-1]
    reps = c // groups
    rstd = torch.rsqrt(meansq - mean * mean + eps)
    mean_c = mean.repeat_interleave(reps, 1)
    # the gradient of es, with eb's dependence on es folded in
    p_net = p - mean_c * q
    dscale = (rstd.repeat_interleave(reps, 1) * p_net).sum(0)
    dbias = q.sum(0)
    d_rstd = (scale.float()[None, :] * p_net).reshape(n, groups, reps).sum(-1)
    r3 = rstd * rstd * rstd
    dmean = (-(q * es).reshape(n, groups, reps).sum(-1)
             + r3 * mean * d_rstd)
    dmeansq = -0.5 * r3 * d_rstd
    return dscale, dbias, dmean, dmeansq


def _gn_bwd_stats_coefs(dmean, dmeansq, c: int, s: int):
    """(ca, cb) per (sample, channel): the statistics' term of dx, (dmean +
    2 x dmeansq) / count, as ca + cb * x, count = s * (C / G)."""
    reps = c // dmean.shape[-1]
    count = float(s * reps)
    return ((dmean / count).repeat_interleave(reps, 1).contiguous(),
            (2.0 * dmeansq / count).repeat_interleave(reps, 1).contiguous())


def group_norm_silu_backward_plain(x, dact, mean, meansq, scale, es, eb, *,
                                   eps: float = 1e-6, apply_silu: bool = True,
                                   stats_term: bool = True):
    """Kernel F's function in PyTorch, fp32 arithmetic, one cast of dx: see
    :func:`group_norm_silu_backward`."""
    n, h, w, c = x.shape
    xf = x.float()
    e, b = es[:, None, None, :], eb[:, None, None, :]
    dz = dact.float()
    if apply_silu:
        z = xf * e + b
        sig = torch.sigmoid(z)
        dz = dz * sig * (1.0 + z * (1.0 - sig))
    dscale, dbias, dmean, dmeansq = _gn_bwd_terms(
        (dz * xf).sum((1, 2)), dz.sum((1, 2)), mean, meansq, scale, es, eps)
    dx = dz * e
    if stats_term:
        ca, cb = _gn_bwd_stats_coefs(dmean, dmeansq, c, h * w)
        dx = dx + ca[:, None, None, :] + cb[:, None, None, :] * xf
        dmean = dmeansq = None
    return dx.to(x.dtype), dscale, dbias, dmean, dmeansq


# per (device, dtype code, vector, SiLU): the blocks an SM kernel F's two
# passes keep resident, read from the CUDA runtime at first use
_F_RESIDENT: dict = {}
# spans of a sample that one block of F's reduce pass sums, in the first of
# the fold's two levels
F_GROUP_SPANS = 16


def _f_plan(x, apply_silu: bool, *others) -> GNPlan:
    """Kernel F's plan over x: :func:`gn_plan`'s spans and strips on a grid
    of one wave at the blocks an SM F's kernels keep resident (its own
    registers and ring, not kernel A's GN_BLOCKS_PER_SM), so that the apply
    pass finds every span's last rows in L2."""
    dev = x.device.index
    n, h, w, c = x.shape
    aligned = _aligned(x, *others)
    key = (dev, dtype_code(x), gn_vec(c, x.element_size(), aligned),
           bool(apply_silu))
    if key not in _F_RESIDENT:
        got = ctypes.c_int(0)
        check(lib("groupnorm_silu_bwd").vt_gn_bwd_blocks_per_sm(
            key[1], key[2], int(key[3]), ctypes.addressof(got)),
            "vt_gn_bwd_blocks_per_sm")
        _F_RESIDENT[key] = got.value
    return gn_plan(n, h * w, c, x.element_size(), aligned, _sms(dev),
                   _F_RESIDENT[key])


@on_tensor_device
def _group_norm_silu_backward_kernel(x, dact, mean, meansq, scale, es, eb,
                                     eps, apply_silu, stats_term):
    """Kernel F: the reduce pass, which folds its sums into dscale, dbias
    and the statistics' gradients (or dx's statistics' term), then the
    apply pass: two launches in F's plan (:func:`_f_plan`)."""
    x = x.contiguous()
    dact = dact.to(x.dtype).contiguous()
    es, eb, mean, meansq, scale = (t.float().contiguous() for t in (
        es, eb, mean, meansq, scale))
    n, h, w, c = x.shape
    groups = mean.shape[-1]
    dx = torch.empty_like(x)
    plan = _f_plan(x, apply_silu, dact, dx)
    stream = stream_of(x)
    # the fold's (P, Q) pairs of the spans and of the groups of spans, the
    # groups' terms and the samples' rows (float2 each), then dx's
    # statistics' term ca, cb; 16-byte aligned.  Counters: one a (sample,
    # group of spans), one a sample, one over the samples.
    span_groups = -(-plan.blocks // F_GROUP_SPANS)
    offs = [0]
    for size in (2 * n * plan.blocks * c, 2 * n * span_groups * c, 2 * n * c,
                 2 * n * c, n * c, n * c):
        offs.append(offs[-1] + -(-size // 4) * 4)
    arrivals, scratch = _scratch(x, stream, offs[-1],
                                 n * span_groups + n + 1)
    partial, group_sums, terms, rows, ca, cb = (scratch.data_ptr() + 4 * o
                                                for o in offs[:-1])
    grads = torch.empty(2, c, dtype=torch.float32, device=x.device)
    dmean = dmeansq = None
    if not stats_term:  # the statistics' gradients out, no term in dx
        dmean, dmeansq = torch.empty(2, n, groups, dtype=torch.float32,
                                     device=x.device)
        ca = cb = None
    f = lib("groupnorm_silu_bwd")
    head = (x.data_ptr(), dact.data_ptr(), dtype_code(x), n, h * w, c)
    plan_args = (plan.vec, plan.rows, plan.blocks, plan.strips,
                 es.data_ptr(), eb.data_ptr())
    silu = int(bool(apply_silu))
    check(f.vt_gn_bwd_reduce(
        *head, groups, *plan_args, mean.data_ptr(), meansq.data_ptr(),
        scale.data_ptr(), float(eps), silu, F_GROUP_SPANS, partial,
        group_sums, terms, rows, arrivals.data_ptr(), grads[0].data_ptr(),
        grads[1].data_ptr(), ca, cb,
        *(None, None) if stats_term else (dmean.data_ptr(),
                                          dmeansq.data_ptr()),
        stream), "vt_gn_bwd_reduce")
    check(f.vt_gn_bwd_apply(*head, *plan_args, ca, cb, silu, dx.data_ptr(),
                            stream), "vt_gn_bwd_apply")
    return dx, grads[0], grads[1], dmean, dmeansq


@ranged("op.group_norm_silu_backward")
def group_norm_silu_backward(x, dact, mean, meansq, scale, es, eb, *,
                             eps: float = 1e-6, apply_silu: bool = True,
                             stats_term: bool = True):
    """The backward of GroupNorm(+SiLU) of an NHWC tensor x, given the
    cotangent ``dact`` of its output, its (N, G) fp32 statistics (mean,
    E[x^2]) and their (N, C) effective affine ``es``, ``eb``: kernel F on a
    CUDA tensor (it raises for what kernel A's plan refuses), else the
    plain version.  Returns (dx in x's dtype, dscale, dbias (C,) fp32,
    dmean, dmeansq (N, G) fp32).  With ``stats_term`` the statistics are
    x's own and dx carries their gradient (dmean and dmeansq are None);
    without, they are an input of their own (the height slabs' form) and dx
    is the gradient at fixed statistics."""
    if backend.use_kernel(x):
        out = _group_norm_silu_backward_kernel(x, dact, mean, meansq, scale,
                                               es, eb, eps, apply_silu,
                                               stats_term)
        backend.count_launch("group_norm_silu_bwd")
        return out
    return group_norm_silu_backward_plain(x, dact, mean, meansq, scale, es,
                                          eb, eps=eps, apply_silu=apply_silu,
                                          stats_term=stats_term)


def group_norm_silu_vjp(g, x, mean, meansq, scale, bias, *, eps: float,
                        apply_silu: bool = True, es=None, eb=None,
                        stats_term: bool = True):
    """The backward of :func:`group_norm_silu` (``stats_term``: the
    statistics are x's own) or of :func:`group_norm_silu_from_stats`, as
    the JAX package's jitted VJP computes it: no forward rerun, kernel F
    fed the statistics the forward took (``es``/``eb`` the forward's
    effective affine, else folded from mean and meansq here).  Returns
    (dx, dmean, dmeansq, dscale, dbias), the statistics' None with
    ``stats_term``, the scale's and bias's in their dtypes."""
    if es is None:
        es, eb = effective_affine(mean, meansq, scale, bias, x.shape[-1], eps)
    dx, dscale, dbias, dmean, dmeansq = group_norm_silu_backward(
        x, g, mean, meansq, scale, es, eb, eps=eps, apply_silu=apply_silu,
        stats_term=stats_term)
    return dx, dmean, dmeansq, dscale.to(scale.dtype), dbias.to(bias.dtype)


def vjp_of_plain(plain, inputs, grads):
    """Gradients of ``plain(*inputs)`` for every tensor input (None for the
    others), recomputed under ``enable_grad``: the backward of the kernel
    ops, as the JAX package's ``bwd`` takes ``jax.vjp`` of its reference."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  if isinstance(t, torch.Tensor) else t for t in inputs]
        out = plain(*leaves)
        diff = [t for t in leaves if isinstance(t, torch.Tensor)
                and t.requires_grad]
        got = iter(torch.autograd.grad(out, diff, grads, allow_unused=True))
    return tuple(next(got) if isinstance(t, torch.Tensor) and t.requires_grad
                 else None for t in leaves)


class _GroupNormSiLU(torch.autograd.Function):
    """Forward: kernel A on a CUDA tensor, which keeps its statistics for
    the backward, else the plain version.  Backward on the kernel path:
    :func:`group_norm_silu_vjp` (kernel F); else the VJP of the JAX
    package's reference form, recomputed (:func:`vjp_of_plain`)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, apply_silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, apply_silu)
        ctx.stats = None
        if backend.use_kernel(x):
            out, ctx.stats = _group_norm_silu_kernel(x, scale, bias,
                                                     num_groups, eps,
                                                     apply_silu)
            backend.count_launch("group_norm_silu")
            return out
        return group_norm_silu_plain(x, scale, bias, num_groups=num_groups,
                                     eps=eps, apply_silu=apply_silu)

    @staticmethod
    @ranged("op.group_norm_silu.bwd")
    def backward(ctx, g):
        num_groups, eps, apply_silu = ctx.args
        if ctx.stats is not None:
            x, scale, bias = ctx.saved_tensors
            mean, meansq, es, eb = ctx.stats
            dx, _, _, dscale, dbias = group_norm_silu_vjp(
                g, x, mean, meansq, scale, bias, eps=eps,
                apply_silu=apply_silu, es=es, eb=eb)
            return dx, dscale, dbias, None, None, None

        def plain(x, scale, bias):
            return group_norm_silu_reference(x, scale, bias,
                                             num_groups=num_groups, eps=eps,
                                             apply_silu=apply_silu)

        return vjp_of_plain(plain, ctx.saved_tensors, g) + (None,) * 3


@ranged("op.group_norm_silu")
def group_norm_silu(x, scale, bias, *, num_groups: int, eps: float = 1e-6,
                    apply_silu: bool = True):
    """GroupNorm, optionally followed by SiLU, over an NHWC tensor, with
    gradients to x, scale and bias."""
    return _GroupNormSiLU.apply(x, scale, bias, num_groups, eps, apply_silu)


class _GroupStats(torch.autograd.Function):
    """Forward: :func:`group_stats` (kernel A's stats pass on a CUDA
    tensor, else the plain version); backward: the analytic VJP,
    d mean/dx = 1/count and d E[x^2]/dx = 2x/count over each group."""

    @staticmethod
    def forward(ctx, x, num_groups):
        ctx.save_for_backward(x)
        ctx.num_groups = num_groups
        return group_stats(x, num_groups)

    @staticmethod
    @ranged("op.group_stats_with_grad.bwd")
    def backward(ctx, g_mean, g_meansq):
        (x,) = ctx.saved_tensors
        n, h, w, c = x.shape
        g = ctx.num_groups
        count = h * w * (c // g)
        xg = x.float().reshape(n, h * w, g, c // g)
        dx = (g_mean[:, None, :, None]
              + 2.0 * xg * g_meansq[:, None, :, None]) / count
        return dx.reshape(x.shape).to(x.dtype), None


@ranged("op.group_stats_with_grad")
def group_stats_with_grad(x, num_groups: int):
    """(mean, E[x^2]) per (sample, group), fp32 (N, G), with a gradient to
    x: the statistics a height slab contributes to the whole image's
    (parallel/spatial.py::global_group_stats)."""
    return _GroupStats.apply(x, num_groups)


class _GroupNormSiLUFromStats(torch.autograd.Function):
    """Forward: kernel A's apply pass on a CUDA tensor, else the plain
    version.  Backward with respect to x, the statistics, scale and bias:
    on the kernel path :func:`group_norm_silu_vjp` (kernel F, no statistics'
    term in dx), else the VJP of :func:`group_norm_silu_from_stats_plain`."""

    @staticmethod
    def forward(ctx, x, mean, meansq, scale, bias, eps, apply_silu):
        ctx.save_for_backward(x, mean, meansq, scale, bias)
        ctx.args = (eps, apply_silu)
        ctx.kernel = backend.use_kernel(x)
        if ctx.kernel:
            return group_norm_silu_apply(x, *effective_affine(
                mean, meansq, scale, bias, x.shape[-1], eps),
                apply_silu=apply_silu)
        return group_norm_silu_from_stats_plain(
            x, mean, meansq, scale, bias, eps=eps, apply_silu=apply_silu)

    @staticmethod
    @ranged("op.group_norm_silu_from_stats.bwd")
    def backward(ctx, g):
        eps, apply_silu = ctx.args
        if ctx.kernel:
            return group_norm_silu_vjp(
                g, *ctx.saved_tensors, eps=eps, apply_silu=apply_silu,
                stats_term=False) + (None,) * 2

        def plain(x, mean, meansq, scale, bias):
            return group_norm_silu_from_stats_plain(
                x, mean, meansq, scale, bias, eps=eps, apply_silu=apply_silu)

        return vjp_of_plain(plain, ctx.saved_tensors, g) + (None,) * 2


@ranged("op.group_norm_silu_from_stats")
def group_norm_silu_from_stats(x, mean, meansq, scale, bias, *,
                               eps: float = 1e-6, apply_silu: bool = True):
    """GroupNorm(+SiLU) of x from given (mean, E[x^2]) (N, G) fp32
    statistics -- those of the whole image when x is a height slab -- with
    gradients to x, the statistics, scale and bias."""
    return _GroupNormSiLUFromStats.apply(x, mean, meansq, scale, bias, eps,
                                         apply_silu)


# --------------------------------------------------------------------------
# the per-pixel RMS norm of the Wan VAE (csrc/rms_norm.cu)
# --------------------------------------------------------------------------

# F.normalize's floor on the norm (diffusers WanRMS_norm)
RMS_EPS = 1e-12


def rms_stats_plain(x, eps: float = RMS_EPS):
    """(N, H, W) fp32 factors r = sqrt(C) / max(||x[n, h, w, :]||, eps) of
    an NHWC tensor: ``F.normalize(x, dim=channels) * sqrt(C)`` is x * r."""
    norm = x.float().square().sum(-1).sqrt()
    return math.sqrt(x.shape[-1]) / norm.clamp_min(eps)


def rms_norm_silu_apply_plain(x, r, gamma, *, apply_silu: bool = True):
    """The RMS apply pass in PyTorch: ``[silu]((x * r) * gamma)`` in fp32
    from the (N, H, W) factors r, one cast at the end."""
    y = x.float() * r[..., None] * gamma.float()
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def rms_norm_silu_plain(x, gamma, *, apply_silu: bool = True,
                        eps: float = RMS_EPS):
    """The Wan VAE's RMS norm (+ SiLU) in PyTorch."""
    return rms_norm_silu_apply_plain(x, rms_stats_plain(x, eps), gamma,
                                     apply_silu=apply_silu)


def refuse_grad(*tensors) -> None:
    """Raise where a gradient would be asked of the RMS kernels: the Wan
    VAE's backward (the RMS norm's, and kernels D', D'', E', E'' at head
    width 384) is not ported, so only the plain path on the CPU trains."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the RMS norm's kernels have no backward: the Wan VAE runs "
            "forward only on the card (torch.inference_mode or no_grad)")


@on_tensor_device
def _rms_stats_launch(x, eps: float):
    """The stats pass (one launch) on a contiguous CUDA tensor x."""
    n, h, w, c = x.shape
    r = torch.empty(n, h, w, dtype=torch.float32, device=x.device)
    err = lib("rms_norm").vt_rms_stats(x.data_ptr(), dtype_code(x), n * h * w,
                                       c, float(eps), r.data_ptr(),
                                       stream_of(x))
    check(err, "vt_rms_stats")
    return r


@ranged("op.rms_norm_stats")
def rms_norm_stats(x, eps: float = RMS_EPS):
    """The per-pixel factors r (N, H, W) fp32 of :func:`rms_stats_plain`:
    one launch of the stats pass on a CUDA tensor, else the plain
    version."""
    if backend.use_kernel(x):
        r = _rms_stats_launch(x.contiguous(), eps)
        backend.count_launch("rms_norm_stats")
        return r
    return rms_stats_plain(x, eps)


@on_tensor_device
def _rms_apply_launch(x, r, gamma, apply_silu):
    """The apply pass (one launch) on a contiguous CUDA tensor x."""
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    r = r.float().contiguous()
    gamma = gamma.to(x.device, torch.float32).contiguous()
    err = lib("rms_norm").vt_rms_apply(
        x.data_ptr(), dtype_code(x), n * h * w, c, r.data_ptr(),
        gamma.data_ptr(), out.data_ptr(), int(apply_silu), stream_of(x))
    check(err, "vt_rms_apply")
    return out


@ranged("op.rms_norm_silu")
def rms_norm_silu_apply(x, r, gamma, *, apply_silu=True):
    """The apply pass, ``[silu]((x * r) * gamma)`` from given factors r:
    one launch on a CUDA tensor, else the plain version.  ``apply_silu``:
    False, True (fp32: the exact SiLU, bf16: the SFU's) or
    :data:`EXACT_SILU`."""
    if backend.use_kernel(x):
        mode = (EXACT_SILU if apply_silu and x.dtype == torch.float32
                else apply_silu)
        out = _rms_apply_launch(x.contiguous(), r, gamma, mode)
        backend.count_launch("rms_norm_silu")
        return out
    return rms_norm_silu_apply_plain(x, r, gamma,
                                     apply_silu=bool(apply_silu))


def rms_norm_silu(x, gamma, *, apply_silu: bool = True,
                  eps: float = RMS_EPS):
    """The Wan VAE's RMS norm over the channels of each pixel of an NHWC
    tensor, ``F.normalize(x, dim=C) * sqrt(C) * gamma``, optionally followed
    by SiLU: the stats pass, then the apply pass.  Forward only on the
    card (:func:`refuse_grad`); on the CPU the plain version, with
    autograd's gradients."""
    if backend.use_kernel(x):
        refuse_grad(x, gamma)
    return rms_norm_silu_apply(x, rms_norm_stats(x, eps), gamma,
                               apply_silu=apply_silu)
