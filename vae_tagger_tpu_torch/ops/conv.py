"""Convolutions over NHWC tensors, and kernel B's wrapper.

Counterpart of ``vae_tagger_tpu/ops/conv.py``.  :func:`gn_silu_conv3x3` is
one ResnetBlock branch, ``conv3x3(silu(gn(x))) + bias [+ residual]``, with
the residual optionally projected by the 1x1 ``conv_shortcut``.  On a CUDA
tensor it runs kernel A's stats pass (:func:`group_norm_affine`) and then
kernel B (``csrc/gn_silu_conv3x3.cu``), which applies the GroupNorm affine
and the SiLU as it stages input pixels and adds the residual or the
shortcut product in its epilogue.  Beside it, :func:`gn_silu_conv3x3_plain`
is the same function in PyTorch: ``group_norm`` -> SiLU -> ``F.conv2d`` ->
residual or shortcut.  The op is a ``torch.autograd.Function`` whose
backward recomputes the plain version and takes its VJP, so the forward
keeps only its inputs for the backward.

Every other conv of the encode path (``conv_in``, the stride-2
downsamples, ``conv_out``, the tagger head's convs) is :func:`conv2d_nhwc`,
``F.conv2d``, as the JAX package leaves them to ``lax.conv``.  The
H-folded slab convolution and the NCHW-island experiment of the JAX module
are TPU layout experiments and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import backend
from ._build import check, dtype_code, lib, stream_of
from .normalization import (  # noqa: F401  (re-exported, as in the JAX module)
    effective_affine,
    group_norm,
    group_norm_affine,
    group_stats,
    vjp_of_plain,
)


def conv2d_nhwc(x, weight, bias=None, stride=1, padding=0):
    """F.conv2d on an NHWC tensor with an OIHW weight; NHWC out.

    The permuted views hand cuDNN a channels_last tensor, so no copy is made
    on the way in; ``contiguous()`` on the way out is then free as well."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


def gn_silu_conv3x3_plain(x, gn_scale, gn_bias, kernel, bias, residual=None,
                          shortcut_kernel=None, shortcut_bias=None, *,
                          num_groups: int, eps: float = 1e-6):
    """Kernel B's function in PyTorch (the JAX dispatcher's reference)."""
    dt = x.dtype
    y = group_norm(x, gn_scale, gn_bias, num_groups=num_groups, eps=eps)
    y = y * torch.sigmoid(y.float()).to(dt)
    w = kernel.to(dt).permute(3, 2, 0, 1)  # HWIO -> OIHW
    out = conv2d_nhwc(y, w, padding=1).float() + bias.float()
    if shortcut_kernel is not None:
        sck = shortcut_kernel.to(dt).reshape(residual.shape[-1], -1)
        out = out + (residual.to(dt) @ sck).float() + shortcut_bias.float()
    elif residual is not None:
        out = out + residual.float()
    return out.to(dt)


def _gn_silu_conv3x3_kernel(x, gn_scale, gn_bias, kernel, bias, residual,
                            shortcut_kernel, shortcut_bias, num_groups, eps):
    n, h, w, c_in = x.shape
    c_out = kernel.shape[-1]
    if tuple(kernel.shape) != (3, 3, c_in, c_out):
        raise ValueError(f"kernel must be (3, 3, {c_in}, Cout) HWIO, got "
                         f"{tuple(kernel.shape)}")
    dt = x.dtype
    code = dtype_code(x)
    x = x.contiguous()
    eff_scale, eff_bias = group_norm_affine(x, gn_scale, gn_bias,
                                            num_groups=num_groups, eps=eps)
    wmat = kernel.to(dt).reshape(9 * c_in, c_out).contiguous()
    b = bias.float().contiguous()
    res = wsc = scb = None
    c_res = 0
    if residual is not None:
        if residual.shape[:3] != x.shape[:3]:
            raise ValueError("residual must match x in (N, H, W)")
        res = residual.to(dt).contiguous()
        c_res = res.shape[-1]
        if shortcut_kernel is not None:
            wsc = shortcut_kernel.to(dt).reshape(c_res, c_out).contiguous()
            scb = shortcut_bias.float().contiguous()
        elif c_res != c_out:
            raise ValueError(f"residual has {c_res} channels, output "
                             f"{c_out}: pass the 1x1 shortcut")
    elif shortcut_kernel is not None:
        raise ValueError("a shortcut needs the residual it projects")
    out = torch.empty(n, h, w, c_out, dtype=dt, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib("gn_silu_conv3x3").vt_gn_silu_conv3x3(
        x.data_ptr(), code, n, h, w, c_in, c_out, eff_scale.data_ptr(),
        eff_bias.data_ptr(), wmat.data_ptr(), b.data_ptr(), ptr(res), c_res,
        ptr(wsc), ptr(scb), out.data_ptr(), stream_of(x))
    check(err, "vt_gn_silu_conv3x3")
    return out


class _GnSiluConv3x3(torch.autograd.Function):
    """Forward: kernel A's stats pass and kernel B on a CUDA tensor, else
    the plain version; backward: the VJP of the plain version, recomputed
    (the JAX package's custom VJP), for every tensor input -- x, the GN
    scale and bias, the HWIO kernel, the bias, the residual and the
    shortcut kernel and bias."""

    @staticmethod
    def forward(ctx, num_groups, eps, *tensors):
        ctx.save_for_backward(*(t for t in tensors if t is not None))
        ctx.present = [t is not None for t in tensors]
        ctx.args = (num_groups, eps)
        if backend.use_kernel(tensors[0]):
            out = _gn_silu_conv3x3_kernel(*tensors, num_groups, eps)
            backend.count_launch("gn_silu_conv3x3")
            return out
        return gn_silu_conv3x3_plain(*tensors, num_groups=num_groups,
                                     eps=eps)

    @staticmethod
    def backward(ctx, g):
        num_groups, eps = ctx.args
        saved = iter(ctx.saved_tensors)
        tensors = [next(saved) if p else None for p in ctx.present]

        def plain(*ts):
            return gn_silu_conv3x3_plain(*ts, num_groups=num_groups, eps=eps)

        return (None, None) + vjp_of_plain(plain, tensors, g)


def gn_silu_conv3x3(x, gn_scale, gn_bias, kernel, bias, residual=None,
                    shortcut_kernel=None, shortcut_bias=None, *,
                    num_groups: int, eps: float = 1e-6):
    """Fused ResnetBlock branch: conv3x3(silu(gn(x))) + bias [+ residual],
    with gradients to every tensor input.

    x (N,H,W,Cin); gn_scale/gn_bias (Cin,); kernel (3,3,Cin,Cout) HWIO;
    bias (Cout,); residual (N,H,W,Cout), or (N,H,W,Cres) projected first by
    ``shortcut_kernel`` ((1,1,Cres,Cout) or (Cres,Cout)) + ``shortcut_bias``.
    """
    return _GnSiluConv3x3.apply(num_groups, eps, x, gn_scale, gn_bias,
                                kernel, bias, residual, shortcut_kernel,
                                shortcut_bias)
