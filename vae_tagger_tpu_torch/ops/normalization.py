"""Normalization primitives over NHWC tensors, and kernel A's wrappers.

Counterpart of ``vae_tagger_tpu/ops/normalization.py``.  GroupNorm groups
*consecutive* channels (torch ``nn.GroupNorm`` semantics) and takes its
statistics in fp32 whatever the input dtype.

Kernel A (``csrc/groupnorm_silu.cu``) serves two wrappers here:

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

def _stats_chunks(n: int, s: int, c: int) -> int:
    """Row chunks per sample for the stats pass: about 2048 blocks in all
    (enough to keep 132 SMs reading), at least 64 rows per chunk."""
    strips = -(-c // 32)
    chunks = max(1, -(-2048 // (n * strips)))
    return min(chunks, max(1, -(-s // 64)))


def _gn_stats_kernel(x, num_groups: int, eps: float, gamma=None, beta=None):
    """Launch the stats pass.  Returns (mean, meansq, eff_scale, eff_bias);
    the last two are None without gamma/beta."""
    if not x.is_cuda:
        raise ValueError("the GroupNorm kernel takes a CUDA tensor")
    n, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    x = x.contiguous()
    code = dtype_code(x)
    s = h * w
    chunks = _stats_chunks(n, s, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty(n * chunks * 2 * c, **f32)
    mean = torch.empty(n, num_groups, **f32)
    meansq = torch.empty(n, num_groups, **f32)
    es = eb = None
    gp = bp = None
    if gamma is not None:
        gamma = gamma.to(**f32).contiguous()
        beta = beta.to(**f32).contiguous()
        es = torch.empty(n, c, **f32)
        eb = torch.empty(n, c, **f32)
        gp, bp = gamma.data_ptr(), beta.data_ptr()
    err = lib("groupnorm_silu").vt_gn_stats(
        x.data_ptr(), code, n, s, c, num_groups, chunks, gp, bp, float(eps),
        partial.data_ptr(), mean.data_ptr(), meansq.data_ptr(),
        es.data_ptr() if es is not None else None,
        eb.data_ptr() if eb is not None else None, stream_of(x))
    check(err, "vt_gn_stats")
    return mean, meansq, es, eb


def group_stats(x, num_groups: int):
    """(mean, E[x^2]) per (sample, group), fp32, shape (N, G)."""
    if backend.use_kernel(x):
        mean, meansq, _, _ = _gn_stats_kernel(x, num_groups, 0.0)
        backend.count_launch("group_stats")
        return mean, meansq
    return group_stats_plain(x, num_groups)


def group_norm_affine(x, gn_scale, gn_bias, *, num_groups: int,
                      eps: float = 1e-6):
    """GN stats of x folded with the affine: (eff_scale, eff_bias), (N, C)
    fp32 -- the input of the fused conv's prologue."""
    if backend.use_kernel(x):
        _, _, es, eb = _gn_stats_kernel(x, num_groups, eps, gn_scale, gn_bias)
        backend.count_launch("group_stats")
        return es, eb
    mean, meansq = group_stats_plain(x, num_groups)
    return effective_affine(mean, meansq, gn_scale, gn_bias, x.shape[-1], eps)


def _group_norm_silu_kernel(x, scale, bias, num_groups, eps, apply_silu):
    n, h, w, c = x.shape
    x = x.contiguous()
    _, _, es, eb = _gn_stats_kernel(x, num_groups, eps, scale, bias)
    out = torch.empty_like(x)
    err = lib("groupnorm_silu").vt_gn_apply(
        x.data_ptr(), dtype_code(x), n, h * w, c, es.data_ptr(),
        eb.data_ptr(), out.data_ptr(), int(bool(apply_silu)), stream_of(x))
    check(err, "vt_gn_apply")
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
