"""Single-head spatial attention with its gradient, and the wrappers of
kernels C', C'', D, D', E and E'.

Counterpart of ``vae_tagger_tpu/ops/attention.py`` and of the custom VJP in
``vae_tagger_tpu/ops/pallas/flash_attention.py``.  The one long-sequence
attention of the model is the VAE mid-block: one head of D = 512 channels
(FLUX, SD) or 384 (Wan) over the whole latent grid (16,384 tokens at
1024px).

:func:`flash_attention` is a ``torch.autograd.Function``.  Its forward is
:func:`flash_attention_fwd`, which on a CUDA tensor launches the kernel
that :data:`FWD_KERNELS` names for the dtype, both on the tensor cores and
built for head widths 512 and 384 (:data:`TC_HEAD_DIMS`): bf16 goes to
kernel C'
(``csrc/flash_attention_fwd_tc.cu``), fp32 to kernel C''
(``csrc/flash_attention_fwd_tf32x3.cu``, 3xTF32 products; the wrapper
splits K and a key-permuted V^T into hi and lo in every call,
:func:`tf32x3_kv`).  The SIMT kernel C (``csrc/flash_attention_fwd.cu``)
that C'' replaced is no longer dispatched; chip_smoke.py launches it
directly as a yardstick.  The forward saves q, k, v, O and the logsumexp
L.  Its backward is :func:`flash_attention_bwd`: Dl = rowsum(dO * O) in
fp32 with plain torch, as the JAX package takes it in XLA, then the dQ kernel
(:func:`flash_attention_bwd_dq`) and the dK/dV kernel
(:func:`flash_attention_bwd_dkv`) that :data:`BWD_KERNELS` names, all on
the tensor cores for head width 512 alone: bf16 goes to D' and E'
(``csrc/flash_attention_bwd_tc.cu``), fp32 to D'' and E''
(``csrc/flash_attention_bwd_tf32x3.cu``, 3xTF32 products; the wrapper lays
out and splits their shared-memory operands in every call,
:func:`tf32x3_bwd_operands`).  E' and E'' each run a dV pass and a dK pass,
two launches.  The SIMT kernels D and E (``csrc/flash_attention_bwd.cu``)
that D'' and E'' replaced are no longer dispatched; chip_smoke.py launches
them directly as yardsticks.  Neither direction materializes the (S, S)
scores on the card.  Beside each wrapper stands its
plain version: :func:`flash_attention_fwd_plain` (einsum, fp32 softmax,
einsum), :func:`flash_attention_bwd_dq_plain` and
:func:`flash_attention_bwd_dkv_plain` (the recurrences written out in fp32,
composed by :func:`flash_attention_bwd_plain`).  A wrapper takes the plain
version only for a CPU tensor or under the ``torch`` backend.  Sq may
differ from Skv.

:func:`spatial_single_head_attention_sharded` is the height-sharded form:
each slab's queries against the keys and values of every slab, the same
kernels at Sq = S/n, Skv = S.  The tagger head's 64-token MHSA stays plain
PyTorch (models/taggers.py), as the JAX package keeps it on XLA.
"""

from __future__ import annotations

import ctypes

import torch

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
from .tf32x3 import split_tf32, transpose_permuted

# dtype of a CUDA tensor -> (library, C entry, launch counter) of the
# forward kernel.  fp32 takes the tensor cores too: 3xTF32 keeps the fp32
# gates' accuracy, where single-pass TF32 (about 3 decimal digits) would not.
FWD_KERNELS = {
    torch.bfloat16: ("flash_attention_fwd_tc", "vt_flash_attn_fwd_tc",
                     "flash_attention_fwd_tc"),
    torch.float32: ("flash_attention_fwd_tf32x3", "vt_flash_attn_fwd_tf32x3",
                    "flash_attention_fwd_tf32x3"),
}
# dtype of a CUDA tensor -> {"dq": ..., "dkv": ...}, each the (library, C
# entry, launch counter) of a backward kernel: bf16 D' and E', fp32 the
# 3xTF32 kernels D'' and E''.
BWD_KERNELS = {
    torch.bfloat16: {
        "dq": ("flash_attention_bwd_tc", "vt_flash_attn_bwd_dq_tc",
               "flash_attention_bwd_dq_tc"),
        "dkv": ("flash_attention_bwd_tc", "vt_flash_attn_bwd_dkv_tc",
                "flash_attention_bwd_dkv_tc"),
    },
    torch.float32: {
        "dq": ("flash_attention_bwd_tf32x3", "vt_flash_attn_bwd_dq_tf32x3",
               "flash_attention_bwd_dq_tf32x3"),
        "dkv": ("flash_attention_bwd_tf32x3", "vt_flash_attn_bwd_dkv_tf32x3",
                "flash_attention_bwd_dkv_tf32x3"),
    },
}
# the dtypes whose kernels are tensor-core kernels that take the head widths
# of TC_HEAD_DIMS only: all of them
TC_DTYPES = {"fwd": {torch.bfloat16, torch.float32},
             "bwd": {torch.bfloat16, torch.float32}}
# kernels a C entry launches a call: E' and E'' run their dV pass, then
# their dK pass
LAUNCHES_PER_CALL = {"vt_flash_attn_bwd_dkv_tc": 2,
                     "vt_flash_attn_bwd_dkv_tf32x3": 2}
# the head widths the tensor-core kernels are built for, the VAE
# mid-block's channels: the forward's C' and C'' at 512 (FLUX, SD) and 384
# (Wan), the backward's D', D'', E' and E'' at 512 alone
TC_HEAD_DIMS = {"fwd": (384, 512), "bwd": (512,)}
_TC_NAMES = {"fwd": "C', C''", "bwd": "D', D'', E', E''"}


def check_tc_head_width(d, direction: str = "fwd"):
    """Raise for a head width the tensor-core kernels of ``direction``
    ("fwd" or "bwd") are not built for."""
    widths = TC_HEAD_DIMS[direction]
    if d not in widths:
        raise ValueError(f"the tensor-core attention kernels "
                         f"({_TC_NAMES[direction]}) take head width "
                         f"{' or '.join(map(str, widths))}, got {d}")


def fwd_tc_kernel_attrs(dtype=torch.bfloat16, d: int = 512):
    """What the CUDA runtime reports for the instance of kernel C' (bf16)
    or C'' (fp32) at head width ``d``: registers a thread and shared memory
    bytes a block.  On a machine with the card only."""
    check_tc_head_width(d)
    stem, fn, _ = FWD_KERNELS[dtype]
    out = (ctypes.c_int * 2)()
    check(getattr(lib(stem), f"{fn}_attrs")(d, out), f"{fn}_attrs")
    return dict(registers=out[0], smem_bytes=out[1])


def tf32x3_kv(k, v):
    """The shared-memory operands of kernel C'' from fp32 k and v (B, Skv,
    D): (k_hi, k_lo, vt_hi, vt_lo, skv_pad).  K is split as it stands.  V^T
    is :func:`transpose_permuted` of V, (B, D, skv_pad), then split."""
    vt, skv_pad = transpose_permuted(v)
    return (*split_tf32(k.contiguous()), *split_tf32(vt), skv_pad)


def tf32x3_bwd_operands(part, q, k, v, do):
    """The operands of kernel D'' (``part`` "dq") or E'' ("dkv") from fp32
    q, do (B, Sq, D) and k, v (B, Skv, D), in the order of the C entry,
    then the padded length of the transposed operands.  The block's own
    rows stay raw (the kernels split them in registers): q and do for D'',
    k and v for E''.  The streamed operands are split as they stand (D'':
    K, V; E'': Q, dO), and the output products' B operands are
    :func:`transpose_permuted` and split (D'': K^T; E'': Q^T, dO^T)."""
    if part == "dq":
        kt, pad = transpose_permuted(k)
        return (q, do, *split_tf32(k), *split_tf32(v), *split_tf32(kt),
                pad)
    qt, pad = transpose_permuted(q)
    dot, _ = transpose_permuted(do)
    return (k, v, *split_tf32(q), *split_tf32(do), *split_tf32(qt),
            *split_tf32(dot), pad)


def bwd_tc_kernel_attrs(dtype=torch.bfloat16):
    """What the CUDA runtime reports for kernel D' (bf16) or D'' (fp32) and
    for the two passes of E' or E'': registers a thread and shared memory
    bytes a block.  On a machine with the card only."""
    parts = BWD_KERNELS[dtype]
    stem, dq_fn, _ = parts["dq"]
    dkv_fn = parts["dkv"][1]
    bwd = lib(stem)
    dq, dkv = (ctypes.c_int * 2)(), (ctypes.c_int * 4)()
    check(getattr(bwd, f"{dq_fn}_attrs")(dq), f"{dq_fn}_attrs")
    check(getattr(bwd, f"{dkv_fn}_attrs")(dkv), f"{dkv_fn}_attrs")
    return {"dq": dict(registers=dq[0], smem_bytes=dq[1]),
            "dkv_dv_pass": dict(registers=dkv[0], smem_bytes=dkv[1]),
            "dkv_dk_pass": dict(registers=dkv[2], smem_bytes=dkv[3])}


def attention_plain(q, k, v):
    """(B, Sq, D) x (B, Skv, D) single-head attention, softmax in fp32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bqd,bkd->bqk", q, k).float() * scale
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", weights.to(v.dtype), v)


def flash_attention_fwd_plain(q, k, v):
    """Kernel C's function in PyTorch: (out, lse) with lse (B, Sq) fp32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bqd,bkd->bqk", q, k).float() * scale
    return attention_plain(q, k, v), torch.logsumexp(scores, dim=-1)


def bwd_delta(o, do):
    """Dl = rowsum(dO * O) in fp32, (B, Sq): the one reduction of the
    backward outside the kernels (the JAX package takes it in XLA)."""
    return (do.float() * o.float()).sum(-1)


def _probs(q, k, lse, scale):
    """P = exp(Q K^T scale - L) in fp32."""
    return torch.exp(torch.einsum("bqd,bkd->bqk", q.float(), k.float())
                     * scale - lse.float()[..., None])


def _ds(q, k, v, do, lse, delta, scale):
    """(P, dS) with dS = P (dO V^T - Dl) rounded to the input dtype, as
    the JAX kernels cast it before their dots."""
    p = _probs(q, k, lse, scale)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    return p, (p * (dp - delta[..., None])).to(q.dtype).float()


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta):
    """Kernel D's function in PyTorch: dQ = scale dS K, fp32, q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    _, ds = _ds(q, k, v, do, lse, delta, scale)
    return (torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta):
    """Kernel E's function in PyTorch: (dK, dV) with dV = P^T dO (P
    rounded to the input dtype) and dK = scale dS^T Q, fp32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    p, ds = _ds(q, k, v, do, lse, delta, scale)
    dv = torch.einsum("bqk,bqd->bkd", p.to(q.dtype).float(), do.float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """Kernels D and E in PyTorch: (dq, dk, dv) from the forward's O and
    logsumexp, in the inputs' dtypes -- the recurrences
    P = exp(Q K^T scale - L), Dl = rowsum(dO O), dV = P^T dO,
    dS = P (dO V^T - Dl), dQ = scale dS K, dK = scale dS^T Q in fp32."""
    do = do.to(q.dtype)
    delta = bwd_delta(o, do)
    return (flash_attention_bwd_dq_plain(q, k, v, do, lse, delta),
            *flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta))


def _check_qkv(q, k, v):
    b, _, d = q.shape
    if k.shape != (b, k.shape[1], d) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Skv, {d}) alike, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")


def _kernel_entry(table, q, direction):
    entry = table.get(q.dtype)
    if entry is None:
        raise TypeError(f"the attention kernels take bfloat16 or float32, "
                        f"got {q.dtype}")
    if q.dtype in TC_DTYPES[direction]:
        check_tc_head_width(q.shape[-1], direction)
    return entry


def fwd_kernel_for(q):
    """(library, C entry, launch counter) of the forward kernel for q's
    dtype and head width; raises for one that no kernel takes."""
    return _kernel_entry(FWD_KERNELS, q, "fwd")


def bwd_kernels_for(q):
    """{"dq": ..., "dkv": ...}: (library, C entry, launch counter) of the
    backward kernels for q's dtype and head width; raises for one that no
    kernel takes."""
    return _kernel_entry(BWD_KERNELS, q, "bwd")


@on_tensor_device
def _flash_attention_fwd_kernel(q, k, v):
    _check_qkv(q, k, v)
    stem, fn, counter = fwd_kernel_for(q)
    b, sq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(b, sq, dtype=torch.float32, device=q.device)
    if q.dtype == torch.float32:  # C'': this call's split operands
        *kv, skv_pad = tf32x3_kv(k, v)
        check_tma_aligned(q, *kv, out)
        args = (q.data_ptr(), *(t.data_ptr() for t in kv), b, sq, k.shape[1],
                skv_pad, d)
    else:
        check_tma_aligned(q, k, v, out)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dtype_code(q), b,
                sq, k.shape[1], d)
    err = getattr(lib(stem), fn)(*args, 1.0 / (d ** 0.5), out.data_ptr(),
                                 lse.data_ptr(), stream_of(q))
    check(err, fn)
    return out, lse, counter


@ranged("op.flash_attention_fwd")
def flash_attention_fwd(q, k, v):
    """Returns (out (B, Sq, D), lse (B, Sq) fp32); Sq may differ from Skv."""
    if backend.use_kernel(q):
        out, lse, counter = _flash_attention_fwd_kernel(q, k, v)
        backend.count_launch(counter)
        return out, lse
    return flash_attention_fwd_plain(q, k, v)


def _bwd_args(q, k, v, do, lse, delta):
    """Checked, contiguous kernel arguments shared by kernels D, D', E and
    E' (D'' and E'' take :func:`tf32x3_bwd_operands` in place of the
    pointers of q, k, v and do)."""
    _check_qkv(q, k, v)
    b, sq, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("do must match q in shape and dtype")
    if lse.shape != (b, sq) or delta.shape != (b, sq):
        raise ValueError("lse and delta must be (B, Sq)")
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    keep = (q, k, v, do, lse, delta)  # alive until the launch is queued
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dtype_code(q), b, sq,
            k.shape[1], d, 1.0 / (d ** 0.5))
    return keep, args


@on_tensor_device
def _bwd_kernel(part, q, k, v, do, lse, delta):
    """Launch the backward kernel ``part`` ("dq" or "dkv") that
    :data:`BWD_KERNELS` names for q's dtype; returns its outputs."""
    stem, fn, counter = bwd_kernels_for(q)[part]
    keep, args = _bwd_args(q, k, v, do, lse, delta)
    outs = ((torch.empty_like(keep[0]),) if part == "dq"
            else (torch.empty_like(keep[1]), torch.empty_like(keep[2])))
    if q.dtype == torch.float32:  # D'' and E'': this call's operands
        *ops, pad = tf32x3_bwd_operands(part, *keep[:4])
        check_tma_aligned(*ops, *outs)
        b, sq, d = q.shape
        args = (*(t.data_ptr() for t in ops), keep[4].data_ptr(),
                keep[5].data_ptr(), b, sq, k.shape[1], pad, d, args[-1])
    else:
        check_tma_aligned(*keep[:4], *outs)
    check(getattr(lib(stem), fn)(*args, *(t.data_ptr() for t in outs),
                                 stream_of(q)), fn)
    backend.count_launch(counter, LAUNCHES_PER_CALL.get(fn, 1))
    return outs


def flash_attention_bwd_dq(q, k, v, do, lse, delta):
    """dQ (B, Sq, D) from dO, L and Dl = rowsum(dO O); kernel D' (bf16) or
    D'' (fp32) on a CUDA tensor."""
    if not backend.use_kernel(q):
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta)
    return _bwd_kernel("dq", q, k, v, do, lse, delta)[0]


def flash_attention_bwd_dkv(q, k, v, do, lse, delta):
    """(dK, dV) (B, Skv, D) from dO, L and Dl; kernel E' (bf16) or E''
    (fp32), two launches each, on a CUDA tensor."""
    if not backend.use_kernel(q):
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta)
    return _bwd_kernel("dkv", q, k, v, do, lse, delta)


def flash_attention_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) of single-head attention from the forward's O and
    logsumexp: Dl in torch, then kernels D' and E' (bf16) or D'' and E''
    (fp32) on a CUDA tensor."""
    do = do.to(q.dtype)
    delta = bwd_delta(o, do)
    return (flash_attention_bwd_dq(q, k, v, do, lse, delta),
            *flash_attention_bwd_dkv(q, k, v, do, lse, delta))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @ranged("op.flash_attention.bwd")
    def backward(ctx, do):
        return flash_attention_bwd(*ctx.saved_tensors, do)


def flash_attention(q, k, v):
    """Single-head attention (B, Sq, D) x (B, Skv, D) -> (B, Sq, D) with the
    flash backward: kernels C', D' and E' (bf16) or C'', D'' and E''
    (fp32) on the card."""
    return _FlashAttention.apply(q, k, v)


@ranged("op.spatial_single_head_attention")
def spatial_single_head_attention(q, k, v):
    """Single-head self-attention over spatial tokens, (B, S, D) -> (B, S, D)."""
    return flash_attention(q, k, v)


@ranged("op.spatial_single_head_attention_sharded")
def spatial_single_head_attention_sharded(qs, ks, vs):
    """The height-sharded form (the JAX package's
    ``_spatial_sharded_attention``): each slab's (B, S/n, D) queries
    against every slab's keys and values gathered on its device, (B, S, D),
    through :func:`flash_attention` -- kernels C', D', E' or C'', D'', E''
    at Sq = S/n, Skv = S on the card.  The gradients of a slab's keys and
    values are the sum of every slab's (parallel/spatial.py::gathered_kv)."""
    from ..parallel.spatial import gathered_kv

    return [flash_attention(q, k, v)
            for q, (k, v) in zip(qs, gathered_kv(ks, vs))]
