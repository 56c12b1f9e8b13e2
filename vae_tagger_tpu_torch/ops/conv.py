"""Convolutions over NHWC tensors, and the wrapper of kernels B' and B''.

Counterpart of ``vae_tagger_tpu/ops/conv.py``.  :func:`gn_silu_conv3x3` is
one ResnetBlock branch, ``conv3x3(silu(gn(x))) + bias [+ residual]``, with
the residual optionally projected by the 1x1 ``conv_shortcut``.  On a CUDA
tensor it runs kernel A's stats pass (:func:`group_norm_affine`) and then
the fused kernel that :data:`CONV_KERNELS` names for the dtype.  Both are
implicit GEMMs on the tensor cores (wgmma) that read weights packed
K-major by :func:`pack_conv3x3_weight` and refuse the shapes
:func:`check_tc_conv_shape` names: bf16 goes to kernel B'
(``csrc/gn_silu_conv3x3_tc.cu``), fp32 to kernel B''
(``csrc/gn_silu_conv3x3_tf32x3.cu``), which keeps fp32-level error with
3xTF32 products (its weights split into hi and lo by
:func:`~.tf32x3.split_tf32` in every call).  B' applies the GroupNorm
affine and the SiLU to the input pixels it stages; B'' reads its input
activated by kernel A's apply pass with the exact SiLU, launched by the
same wrapper call (one launch counted, the conv's).  Both add the
residual or the shortcut product in their epilogue.  The SIMT kernel B
(``csrc/gn_silu_conv3x3.cu``) that B'' replaced is no longer dispatched;
chip_smoke.py launches it directly as a yardstick.  Beside them,
:func:`gn_silu_conv3x3_plain` is the same function in PyTorch:
``group_norm`` -> SiLU -> ``F.conv2d`` -> residual or shortcut.  The op is
a ``torch.autograd.Function``.  On the kernel path its forward keeps the
stats pass's statistics beside its inputs, and its backward is
:func:`gn_silu_conv3x3_vjp`, as the JAX package's jitted VJP computes it:
the activation recomputed by kernel A's apply pass, the conv's input and
weight gradients from cuDNN (``aten.convolution_backward``; XLA computes
them outside any Pallas kernel on the TPU), then kernel F
(ops/normalization.py), with no forward conv.  On the CPU and under the
``torch`` backend the backward recomputes the plain version and takes its
VJP.  :func:`gn_silu_conv3x3_from_stats` is the same op fed given
GroupNorm statistics (no stats pass), with gradients to them: the form a
height slab extended by its neighbours' halo rows takes
(parallel/spatial.py), its plain version
:func:`gn_silu_conv3x3_from_stats_plain`.

:func:`rms_silu_conv3x3` is the Wan VAE's residual-block branch,
``conv3x3(silu(rms_norm(x) * gamma)) + bias [+ residual]``: the RMS stats
pass (ops/normalization.py), then on bf16 kernel B' in its RMS mode (a
compile-time mode of the same kernel: the activation from the per-pixel
factor and gamma), on fp32 the RMS apply pass with the exact SiLU and then
B'' unchanged.  It is forward only on the card; its plain version
:func:`rms_silu_conv3x3_plain` trains on the CPU.

Every other conv of the encode path (``conv_in``, the stride-2
downsamples, ``conv_out``, the tagger head's convs) is :func:`conv2d_nhwc`,
``F.conv2d``, as the JAX package leaves them to ``lax.conv``.  The
H-folded slab convolution and the NCHW-island experiment of the JAX module
are TPU layout experiments and are not ported.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.profiling import ranged
from . import backend
from ._build import (
    check,
    check_tma_aligned,
    dtype_code,
    lib,
    on_tensor_device,
    stream_of,
)
from .tf32x3 import split_tf32
from .normalization import (  # noqa: F401  (re-exported, as in the JAX module)
    effective_affine,
    group_norm,
    group_norm_affine,
    group_norm_silu_apply,
    group_norm_silu_from_stats_plain,
    group_norm_silu_vjp,
    group_norm_stats_affine,
    group_stats,
    vjp_of_plain,
)
from .normalization import (
    EXACT_SILU,
    RMS_EPS,
    _gn_apply_kernel,
    refuse_grad,
    rms_norm_silu_apply,
    rms_norm_silu_apply_plain,
    rms_norm_stats,
    rms_stats_plain,
)


# dtype of a CUDA tensor -> (library, C entry, launch counter) of the
# fused conv.  fp32 takes the tensor cores too: 3xTF32 keeps the fp32
# gates' accuracy, where single-pass TF32 (about 3 decimal digits) would not.
CONV_KERNELS = {
    torch.bfloat16: ("gn_silu_conv3x3_tc", "vt_gn_silu_conv3x3_tc",
                     "gn_silu_conv3x3_tc"),
    torch.float32: ("gn_silu_conv3x3_tf32x3", "vt_gn_silu_conv3x3_tf32x3",
                    "gn_silu_conv3x3_tf32x3"),
}

# the RMS mode of kernel B' (bf16): (C entry, launch counter); in fp32 the
# RMS apply pass feeds B'' as it is
RMS_CONV_KERNEL = ("vt_rms_silu_conv3x3_tc", "rms_silu_conv3x3_tc")

# the residual modes of the instances of kernels B' and B''
TC_MODES = ("plain", "residual", "shortcut")
# dtype -> the name of the kernel that takes it
_KERNEL_NAME = {torch.bfloat16: "B'", torch.float32: "B''"}


def conv_kernel_for(x):
    """(library, C entry, launch counter) of the fused conv for x's dtype;
    raises for a dtype no kernel takes."""
    entry = CONV_KERNELS.get(x.dtype)
    if entry is None:
        raise TypeError(f"the fused conv kernels take bfloat16 or float32, "
                        f"got {x.dtype}")
    return entry


def check_tc_conv_shape(n, h, w, c_in, c_out, c_shortcut=0,
                        dtype=torch.bfloat16):
    """Raise for a conv that kernel B' (bf16) or B'' (fp32) refuses: an
    empty one, or channel counts whose rows are not a multiple of 16 bytes
    (TMA's strides): multiples of 8 in bf16, of 4 in fp32.  The kernels
    pick their own tiles."""
    multiple = 16 // torch.empty(0, dtype=dtype).element_size()
    for name, c in (("Cin", c_in), ("Cout", c_out), ("Cres", c_shortcut)):
        if c % multiple:
            raise ValueError(f"kernel {_KERNEL_NAME[dtype]} takes channel "
                             f"counts that are multiples of {multiple}, got "
                             f"{name}={c}")
    if min(n, h, w, c_in, c_out) <= 0:
        raise ValueError(f"empty conv: {(n, h, w, c_in, c_out)}")


def tc_kernel_attrs(c_out, mode, dtype=torch.bfloat16, norm: str = "gn"):
    """What the CUDA runtime reports for the instance of kernel B' (bf16)
    or B'' (fp32) that a conv with ``c_out`` output channels and residual
    ``mode`` (one of :data:`TC_MODES`) launches, in B''s GroupNorm or
    (``norm="rms"``) RMS mode: its output-channel tile, registers a thread
    and shared memory bytes a block.  On a machine with the card only."""
    stem, fn, _ = CONV_KERNELS[dtype]
    if norm == "rms" and dtype == torch.bfloat16:
        fn = RMS_CONV_KERNEL[0]
    out = (ctypes.c_int * 3)()
    check(getattr(lib(stem), f"{fn}_attrs")(c_out, TC_MODES.index(mode), out),
          f"{fn}_attrs")
    return dict(bn=out[0], registers=out[1], smem_bytes=out[2])


def pack_conv3x3_weight(kernel, dtype=torch.bfloat16):
    """HWIO (3, 3, Cin, Cout) -> (9, Cout, Cin) in ``dtype``: each tap's
    matrix transposed, so that kernels B' and B'' read their weight tiles
    K-major."""
    c_in, c_out = kernel.shape[2], kernel.shape[3]
    return (kernel.to(dtype).permute(0, 1, 3, 2)
            .reshape(9, c_out, c_in).contiguous())


def pack_shortcut_weight(shortcut_kernel, c_res, dtype=torch.bfloat16):
    """The 1x1 shortcut ((1, 1, Cres, Cout) or (Cres, Cout)) -> (Cout, Cres)
    in ``dtype``, K-major for kernels B' and B''."""
    return shortcut_kernel.to(dtype).reshape(c_res, -1).t().contiguous()


@ranged("op.conv2d_nhwc")
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
    return _conv3x3_tail(y, kernel, bias, residual, shortcut_kernel,
                         shortcut_bias)


def gn_silu_conv3x3_from_stats_plain(x, mean, meansq, gn_scale, gn_bias,
                                     kernel, bias, residual=None,
                                     shortcut_kernel=None,
                                     shortcut_bias=None, *,
                                     eps: float = 1e-6):
    """Kernels B' and B'' fed given statistics, in PyTorch: the activation
    from the effective affine of (mean, E[x^2]) in fp32 (kernel A's apply
    pass), cast once, then the conv, the bias and the residual or
    shortcut as in :func:`gn_silu_conv3x3_plain`."""
    y = group_norm_silu_from_stats_plain(x, mean, meansq, gn_scale, gn_bias,
                                         eps=eps)
    return _conv3x3_tail(y, kernel, bias, residual, shortcut_kernel,
                         shortcut_bias)


def _conv3x3_tail(y, kernel, bias, residual, shortcut_kernel, shortcut_bias):
    """conv3x3(y) + bias [+ residual or its 1x1 shortcut], in y's dtype."""
    dt = y.dtype
    w = kernel.to(dt).permute(3, 2, 0, 1)  # HWIO -> OIHW
    out = conv2d_nhwc(y, w, padding=1).float() + bias.float()
    if shortcut_kernel is not None:
        sck = shortcut_kernel.to(dt).reshape(residual.shape[-1], -1)
        out = out + (residual.to(dt) @ sck).float() + shortcut_bias.float()
    elif residual is not None:
        out = out + residual.float()
    return out.to(dt)


@on_tensor_device
def _gn_silu_conv3x3_kernel(x, gn_scale, gn_bias, kernel, bias, residual,
                            shortcut_kernel, shortcut_bias, num_groups, eps):
    """Kernel A's stats pass, then kernel B' or B''; returns (output, launch
    counter, (mean, meansq, es, eb)), the statistics for the backward."""
    _check_conv(x, kernel, residual, shortcut_kernel)
    x = x.contiguous()
    stats = group_norm_stats_affine(x, gn_scale, gn_bias,
                                    num_groups=num_groups, eps=eps)
    return (*_fused_conv_launch(x, *stats[2:], kernel, bias, residual,
                                shortcut_kernel, shortcut_bias), stats)


@on_tensor_device
def _gn_silu_conv3x3_from_stats_kernel(x, mean, meansq, gn_scale, gn_bias,
                                       kernel, bias, residual,
                                       shortcut_kernel, shortcut_bias, eps):
    """Kernel B' or B'' alone (no stats pass), fed the effective affine of
    the given statistics."""
    _check_conv(x, kernel, residual, shortcut_kernel)
    eff_scale, eff_bias = (t.contiguous() for t in effective_affine(
        mean, meansq, gn_scale, gn_bias, x.shape[-1], eps))
    return _fused_conv_launch(x.contiguous(), eff_scale, eff_bias, kernel,
                              bias, residual, shortcut_kernel, shortcut_bias)


def _check_conv(x, kernel, residual, shortcut_kernel):
    """Raise for a kernel, residual or shortcut that does not fit x, and,
    before anything is launched, for what the kernel cannot take."""
    n, h, w, c_in = x.shape
    c_out = kernel.shape[-1]
    if tuple(kernel.shape) != (3, 3, c_in, c_out):
        raise ValueError(f"kernel must be (3, 3, {c_in}, Cout) HWIO, got "
                         f"{tuple(kernel.shape)}")
    if residual is not None:
        if residual.shape[:3] != x.shape[:3]:
            raise ValueError("residual must match x in (N, H, W)")
        if shortcut_kernel is None and residual.shape[-1] != c_out:
            raise ValueError(f"residual has {residual.shape[-1]} channels, "
                             f"output {c_out}: pass the 1x1 shortcut")
    elif shortcut_kernel is not None:
        raise ValueError("a shortcut needs the residual it projects")
    conv_kernel_for(x)
    check_tc_conv_shape(n, h, w, c_in, c_out,
                        0 if shortcut_kernel is None else residual.shape[-1],
                        x.dtype)


def _fused_conv_launch(x, eff_scale, eff_bias, kernel, bias, residual,
                       shortcut_kernel, shortcut_bias, rms=False):
    """Launch kernel B' (bf16) or B'' (fp32) on a contiguous CUDA tensor x
    with the fp32 (N, Cin) eff_scale and eff_bias of its activation (B''
    after kernel A's apply pass); returns (output, launch counter).  With
    ``rms`` they are the RMS norm's gamma (Cin) and per-pixel factors r
    (N, H, W): B' in its RMS mode, or B'' after the RMS apply pass."""
    n, h, w, c_in = x.shape
    c_out = kernel.shape[-1]
    dt = x.dtype
    stem, fn, counter = conv_kernel_for(x)
    if rms and dt == torch.bfloat16:
        fn, counter = RMS_CONV_KERNEL
    c_res = 0 if residual is None else residual.shape[-1]

    def operands(wmat):  # B' reads a packed bf16 weight, B'' its hi and lo
        if dt == torch.bfloat16:
            return [wmat]
        return [None, None] if wmat is None else list(split_tf32(wmat))

    wmats = operands(pack_conv3x3_weight(kernel, dt))
    b = bias.float().contiguous()
    res = None if residual is None else residual.to(dt).contiguous()
    wsc = scb = None
    if shortcut_kernel is not None:
        wsc = pack_shortcut_weight(shortcut_kernel, c_res, dt)
        scb = shortcut_bias.float().contiguous()
    wscs = operands(wsc)
    if dt == torch.bfloat16:  # B' activates the pixels it stages
        head, affine = [x.data_ptr(), dtype_code(x)], [eff_scale, eff_bias]
    elif rms:  # B'' reads x activated by the RMS apply pass, exact SiLU
        x = rms_norm_silu_apply(x, eff_bias, eff_scale, apply_silu=EXACT_SILU)
        head, affine = [x.data_ptr()], []
    else:  # B'' reads x activated, with the SIMT kernel B's exact SiLU
        x = _gn_apply_kernel(x, eff_scale, eff_bias, EXACT_SILU)
        head, affine = [x.data_ptr()], []
    out = torch.empty(n, h, w, c_out, dtype=dt, device=x.device)
    check_tma_aligned(x, *affine, *wmats, res, *wscs, out)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = [*head, n, h, w, c_in, c_out, *(t.data_ptr() for t in affine),
            *(t.data_ptr() for t in wmats), b.data_ptr(), ptr(res), c_res,
            *(ptr(t) for t in wscs), ptr(scb), out.data_ptr()]
    err = getattr(lib(stem), fn)(*args, stream_of(x))
    check(err, fn)
    return out, counter


def gn_silu_conv3x3_vjp(g, x, gn_scale, gn_bias, kernel, bias,
                        residual=None, shortcut_kernel=None,
                        shortcut_bias=None, *, mean, meansq, es=None, eb=None,
                        eps: float = 1e-6, stats_term: bool = True):
    """The backward of :func:`gn_silu_conv3x3` (``stats_term``: the
    statistics are x's own) or of :func:`gn_silu_conv3x3_from_stats`, as
    the JAX package's jitted VJP computes it, with no forward conv: the
    activation recomputed by kernel A's apply pass from the forward's
    statistics (``es``/``eb`` its effective affine, else folded from mean
    and meansq); the conv's input and weight gradients from
    ``aten.convolution_backward`` on the NHWC views (cuDNN on the card, as
    XLA computes them outside any Pallas kernel on the TPU); the bias, the
    residual and the 1x1 shortcut's gradients in torch; then kernel F.  On
    the CPU every piece is its plain version.  Returns the gradients of
    (x, mean, meansq, gn_scale, gn_bias, kernel, bias, residual,
    shortcut_kernel, shortcut_bias), None for an absent input and, with
    ``stats_term``, for the statistics; each in its input's dtype."""
    if es is None:
        es, eb = effective_affine(mean, meansq, gn_scale, gn_bias,
                                  x.shape[-1], eps)
    dt = x.dtype
    g = g.to(dt)
    act = group_norm_silu_apply(x, es, eb)
    w = kernel.to(dt).permute(3, 2, 0, 1)  # HWIO -> OIHW
    dact, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), act.permute(0, 3, 1, 2), w, None, [1, 1],
        [1, 1], [1, 1], False, [0, 0], 1, [True, True, False])
    del act
    dkernel = dw.permute(2, 3, 1, 0).to(kernel.dtype)
    g_sum = g.sum((0, 1, 2), dtype=torch.float32)
    dres = dsck = dscb = None
    if shortcut_kernel is not None:
        c_res = residual.shape[-1]
        sck = shortcut_kernel.to(dt).reshape(c_res, -1)
        g2 = g.reshape(-1, g.shape[-1])
        dres = (g2 @ sck.t()).reshape(residual.shape).to(residual.dtype)
        dsck = ((residual.to(dt).reshape(-1, c_res).t() @ g2)
                .reshape(shortcut_kernel.shape).to(shortcut_kernel.dtype))
        dscb = g_sum.to(shortcut_bias.dtype)
    elif residual is not None:
        dres = g.to(residual.dtype)
    dx, dmean, dmeansq, dscale, dgbias = group_norm_silu_vjp(
        dact.permute(0, 2, 3, 1), x, mean, meansq, gn_scale, gn_bias,
        eps=eps, es=es, eb=eb, stats_term=stats_term)
    return (dx, dmean, dmeansq, dscale, dgbias, dkernel,
            g_sum.to(bias.dtype), dres, dsck, dscb)


class _GnSiluConv3x3(torch.autograd.Function):
    """Forward: kernel A's stats pass and kernel B' (bf16) or B'' (fp32) on a
    CUDA tensor, keeping the statistics, else the plain version.  Backward,
    for every tensor input -- x, the GN scale and bias, the HWIO kernel,
    the bias, the residual and the shortcut kernel and bias: on the kernel
    path :func:`gn_silu_conv3x3_vjp` (A's apply pass, cuDNN's conv
    backward, kernel F); else the VJP of the plain version, recomputed."""

    @staticmethod
    def forward(ctx, num_groups, eps, *tensors):
        ctx.save_for_backward(*(t for t in tensors if t is not None))
        ctx.present = [t is not None for t in tensors]
        ctx.args = (num_groups, eps)
        ctx.stats = None
        if backend.use_kernel(tensors[0]):
            out, counter, ctx.stats = _gn_silu_conv3x3_kernel(
                *tensors, num_groups, eps)
            backend.count_launch(counter)
            return out
        return gn_silu_conv3x3_plain(*tensors, num_groups=num_groups,
                                     eps=eps)

    @staticmethod
    @ranged("op.gn_silu_conv3x3.bwd")
    def backward(ctx, g):
        num_groups, eps = ctx.args
        saved = iter(ctx.saved_tensors)
        tensors = [next(saved) if p else None for p in ctx.present]
        if ctx.stats is not None:
            mean, meansq, es, eb = ctx.stats
            grads = gn_silu_conv3x3_vjp(g, *tensors, mean=mean, meansq=meansq,
                                        es=es, eb=eb, eps=eps)
            return (None, None, grads[0]) + grads[3:]

        def plain(*ts):
            return gn_silu_conv3x3_plain(*ts, num_groups=num_groups, eps=eps)

        return (None, None) + vjp_of_plain(plain, tensors, g)


@ranged("op.gn_silu_conv3x3")
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


class _GnSiluConv3x3FromStats(torch.autograd.Function):
    """Forward: kernel B' (bf16) or B'' (fp32) alone on a CUDA tensor, fed
    the effective affine of given statistics, else the plain version.
    Backward, for every tensor input, the statistics included: on the
    kernel path :func:`gn_silu_conv3x3_vjp` without the statistics' term in
    dx; else the VJP of :func:`gn_silu_conv3x3_from_stats_plain`."""

    @staticmethod
    def forward(ctx, eps, *tensors):
        ctx.save_for_backward(*(t for t in tensors if t is not None))
        ctx.present = [t is not None for t in tensors]
        ctx.eps = eps
        ctx.kernel = backend.use_kernel(tensors[0])
        if ctx.kernel:
            out, counter = _gn_silu_conv3x3_from_stats_kernel(*tensors, eps)
            backend.count_launch(counter)
            return out
        return gn_silu_conv3x3_from_stats_plain(*tensors, eps=eps)

    @staticmethod
    @ranged("op.gn_silu_conv3x3_from_stats.bwd")
    def backward(ctx, g):
        saved = iter(ctx.saved_tensors)
        tensors = [next(saved) if p else None for p in ctx.present]
        if ctx.kernel:
            x, mean, meansq, *rest = tensors
            return (None,) + gn_silu_conv3x3_vjp(
                g, x, *rest, mean=mean, meansq=meansq, eps=ctx.eps,
                stats_term=False)

        def plain(*ts):
            return gn_silu_conv3x3_from_stats_plain(*ts, eps=ctx.eps)

        return (None,) + vjp_of_plain(plain, tensors, g)


@ranged("op.gn_silu_conv3x3_from_stats")
def gn_silu_conv3x3_from_stats(x, mean, meansq, gn_scale, gn_bias, kernel,
                               bias, residual=None, shortcut_kernel=None,
                               shortcut_bias=None, *, eps: float = 1e-6):
    """:func:`gn_silu_conv3x3` with the GroupNorm statistics given, (mean,
    E[x^2]) (N, G) fp32, with gradients to them too: the form of a height
    slab extended by its neighbours' halo rows, whose statistics are the
    whole image's (parallel/spatial.py).  The kernel zero-pads around
    whatever it is given, so a halo row is an input row here, activated
    like any other."""
    return _GnSiluConv3x3FromStats.apply(eps, x, mean, meansq, gn_scale,
                                         gn_bias, kernel, bias, residual,
                                         shortcut_kernel, shortcut_bias)


def rms_silu_conv3x3_plain(x, gamma, kernel, bias, residual=None,
                           shortcut_kernel=None, shortcut_bias=None, *,
                           eps: float = RMS_EPS):
    """:func:`rms_silu_conv3x3` in PyTorch: the RMS norm and the SiLU in
    fp32, cast once (as kernel B' rounds its activated tile), then the
    conv, the bias and the residual or shortcut as
    :func:`gn_silu_conv3x3_plain` adds them."""
    y = rms_norm_silu_apply_plain(x, rms_stats_plain(x, eps), gamma)
    return _conv3x3_tail(y, kernel, bias, residual, shortcut_kernel,
                         shortcut_bias)


@on_tensor_device
def _rms_silu_conv3x3_kernel(x, gamma, kernel, bias, residual,
                             shortcut_kernel, shortcut_bias, eps):
    """The RMS stats pass, then kernel B' in its RMS mode (bf16) or the RMS
    apply pass and kernel B'' (fp32); returns (output, launch counter)."""
    _check_conv(x, kernel, residual, shortcut_kernel)
    x = x.contiguous()
    r = rms_norm_stats(x, eps)
    g = gamma.to(x.device, torch.float32).contiguous()
    if g.data_ptr() % 16:  # B' loads gamma 16 bytes a time
        g = g.clone()
    return _fused_conv_launch(x, g, r, kernel, bias, residual,
                              shortcut_kernel, shortcut_bias, rms=True)


@ranged("op.rms_silu_conv3x3")
def rms_silu_conv3x3(x, gamma, kernel, bias, residual=None,
                     shortcut_kernel=None, shortcut_bias=None, *,
                     eps: float = RMS_EPS):
    """The Wan VAE's residual-block branch: conv3x3(silu(x / max(||x||,
    eps) * sqrt(C) * gamma)) + bias [+ residual], the norm over the
    channels of each pixel.

    x (N,H,W,Cin); gamma (Cin,); kernel (3,3,Cin,Cout) HWIO; bias (Cout,);
    residual (N,H,W,Cout), or (N,H,W,Cres) projected first by
    ``shortcut_kernel`` ((1,1,Cres,Cout) or (Cres,Cout)) + ``shortcut_bias``.
    Forward only on the card; the plain version on the CPU."""
    if backend.use_kernel(x):
        refuse_grad(x, gamma, kernel, bias, residual, shortcut_kernel,
                    shortcut_bias)
        out, counter = _rms_silu_conv3x3_kernel(
            x, gamma, kernel, bias, residual, shortcut_kernel, shortcut_bias,
            eps)
        backend.count_launch(counter)
        return out
    return rms_silu_conv3x3_plain(x, gamma, kernel, bias, residual,
                                  shortcut_kernel, shortcut_bias, eps=eps)
