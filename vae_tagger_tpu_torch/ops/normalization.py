"""Normalization primitives over NHWC tensors, and kernel A's wrappers.

Counterpart of ``vae_tagger_tpu/ops/normalization.py``.  GroupNorm groups
*consecutive* channels (torch ``nn.GroupNorm`` semantics) and takes its
statistics in fp32 whatever the input dtype.

Kernel A (``csrc/groupnorm_silu_vec.cu``; its plan is :func:`gn_plan`)
serves two wrappers here:

- :func:`group_norm_silu`: GroupNorm(+SiLU) -- the stats pass, then the
  apply pass (the VAE's mid-block attention norm and ``conv_norm_out``);
- :func:`group_norm_affine`: the stats pass alone, folded into per-(n, c)
  ``eff_scale``/``eff_bias`` for the fused conv (ops/conv.py).

:func:`group_norm_silu` is a ``torch.autograd.Function`` on both paths:
its backward recomputes the JAX package's reference form under
``enable_grad`` and takes its VJP (:func:`vjp_of_plain` of
:func:`group_norm_silu_reference`), as the JAX package's custom VJP does,
so the forward saves only its inputs.  The stats pass is forward-only (the
fused conv's Function owns its gradient).

Beside them, the plain versions compute the same function in PyTorch: the
fp32 sum and sum of squares, ``rstd = rsqrt(E[x^2] - mean^2 + eps)``, the
affine and the SiLU in fp32, one cast at the end.  A wrapper takes the plain
version only for a tensor on the CPU (or under the ``torch`` backend); for
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import backend
from ._build import check, dtype_code, lib, stream_of


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


def group_norm_silu_plain(x, scale, bias, *, num_groups: int,
                          eps: float = 1e-6, apply_silu: bool = True):
    """Kernel A's function in PyTorch: fp32 stats, fp32 affine and SiLU."""
    c = x.shape[-1]
    mean, meansq = group_stats_plain(x, num_groups)
    es, eb = effective_affine(mean, meansq, scale, bias, c, eps)
    y = x.float() * es[:, None, None, :] + eb[:, None, None, :]
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


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


def gn_plan(n: int, s: int, c: int, itemsize: int, aligned: bool,
            sms: int = 132) -> GNPlan:
    """The plan of kernel A on ``sms`` SMs: 16-byte vectors where C allows
    and the data is 16-byte aligned, else one element a thread; spans of
    whole unrolled steps, at most GN_BLOCKS_PER_SM blocks an SM in all (one
    wave), so that every block streams one long contiguous span.  ``blocks`` is
    ceil(S / rows): the spans cover every row exactly once."""
    vec = 16 // itemsize
    if not aligned or c % vec:
        vec = 1
    slots = c // vec
    strip = min(slots, GN_THREADS)
    strips = -(-slots // strip)
    step = (GN_THREADS // strip) * GN_UNROLL
    per_sample = max(1, sms * GN_BLOCKS_PER_SM // (n * strips))
    rows = -(-s // per_sample)
    rows = -(-rows // step) * step
    return GNPlan(vec, rows, -(-s // rows), strips)


_SMS: dict = {}
# per (device, stream): [arrival counters (int32, one a sample, 0 between
# launches), fp32 scratch for what a launch writes and no caller keeps]
_SCRATCH: dict = {}


def _launch_plan(x) -> GNPlan:
    dev = x.device.index
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    n, h, w, c = x.shape
    return gn_plan(n, h * w, c, x.element_size(), x.data_ptr() % 16 == 0,
                   _SMS[dev])


def _scratch(x, stream: int, floats: int):
    """The arrival counters and at least ``floats`` of scratch for x's
    device and stream.  Launches on one stream run in order, so each may
    reuse what the last one wrote; the counters are zeros once and every
    launch leaves them so (its last block resets them)."""
    key = (x.device, stream)
    entry = _SCRATCH.get(key)
    if entry is None:
        entry = _SCRATCH[key] = [None, None]
    if entry[0] is None or entry[0].numel() < x.shape[0]:
        entry[0] = torch.zeros(max(x.shape[0], 64), dtype=torch.int32,
                               device=x.device)
    if entry[1] is None or entry[1].numel() < floats:
        entry[1] = torch.empty(floats, dtype=torch.float32, device=x.device)
    return entry


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


def group_norm_affine(x, gn_scale, gn_bias, *, num_groups: int,
                      eps: float = 1e-6):
    """GN stats of x folded with the affine: (eff_scale, eff_bias), (N, C)
    fp32 -- the input of the fused conv's prologue."""
    if backend.use_kernel(x):
        es, eb = (torch.empty(x.shape[0], x.shape[-1], dtype=torch.float32,
                              device=x.device) for _ in range(2))
        _gn_stats_launch(x.contiguous(), num_groups, eps, gn_scale, gn_bias,
                         dict(es=es, eb=eb))
        backend.count_launch("group_stats")
        return es, eb
    mean, meansq = group_stats_plain(x, num_groups)
    return effective_affine(mean, meansq, gn_scale, gn_bias, x.shape[-1], eps)


def _group_norm_silu_kernel(x, scale, bias, num_groups, eps, apply_silu):
    """The stats pass, then the apply pass in the same plan: two launches;
    eff_scale/eff_bias stay in the scratch between them."""
    n, h, w, c = x.shape
    x = x.contiguous()
    plan, es, eb = _gn_stats_launch(x, num_groups, eps, scale, bias)
    out = torch.empty_like(x)
    err = lib("groupnorm_silu_vec").vt_gn_apply_vec(
        x.data_ptr(), dtype_code(x), n, h * w, c, plan.vec, plan.rows,
        plan.blocks, plan.strips, es, eb, out.data_ptr(),
        int(bool(apply_silu)), stream_of(x))
    check(err, "vt_gn_apply_vec")
    return out


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
    """Forward: kernel A on a CUDA tensor, else the plain version; backward:
    the VJP of the JAX package's reference form (GroupNorm's backward is
    cheap next to the convs around it)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, apply_silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, apply_silu)
        if backend.use_kernel(x):
            out = _group_norm_silu_kernel(x, scale, bias, num_groups, eps,
                                          apply_silu)
            backend.count_launch("group_norm_silu")
            return out
        return group_norm_silu_plain(x, scale, bias, num_groups=num_groups,
                                     eps=eps, apply_silu=apply_silu)

    @staticmethod
    def backward(ctx, g):
        num_groups, eps, apply_silu = ctx.args

        def plain(x, scale, bias):
            return group_norm_silu_reference(x, scale, bias,
                                             num_groups=num_groups, eps=eps,
                                             apply_silu=apply_silu)

        return vjp_of_plain(plain, ctx.saved_tensors, g) + (None,) * 3


def group_norm_silu(x, scale, bias, *, num_groups: int, eps: float = 1e-6,
                    apply_silu: bool = True):
    """GroupNorm, optionally followed by SiLU, over an NHWC tensor, with
    gradients to x, scale and bias."""
    return _GroupNormSiLU.apply(x, scale, bias, num_groups, eps, apply_silu)
