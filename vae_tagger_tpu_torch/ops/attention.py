"""Single-head spatial attention with its gradient, and the wrappers of
kernels C, D and E.

Counterpart of ``vae_tagger_tpu/ops/attention.py`` and of the custom VJP in
``vae_tagger_tpu/ops/pallas/flash_attention.py``.  The one long-sequence
attention of the model is the VAE mid-block: one head of D = 512 channels
over the whole latent grid (16,384 tokens at 1024px).

:func:`flash_attention` is a ``torch.autograd.Function``.  Its forward is
:func:`flash_attention_fwd` (kernel C, ``csrc/flash_attention_fwd.cu``, on a
CUDA tensor) and saves q, k, v, O and the logsumexp L; its backward is
:func:`flash_attention_bwd`: Dl = rowsum(dO * O) in fp32 with plain torch,
as the JAX package takes it in XLA, then kernel D
(:func:`flash_attention_bwd_dq`) and kernel E
(:func:`flash_attention_bwd_dkv`), ``csrc/flash_attention_bwd.cu``.
Neither direction materializes the (S, S) scores on the card.  Beside each
wrapper stands its plain version: :func:`flash_attention_fwd_plain`
(einsum, fp32 softmax, einsum), :func:`flash_attention_bwd_dq_plain` and
:func:`flash_attention_bwd_dkv_plain` (the recurrences written out in fp32,
composed by :func:`flash_attention_bwd_plain`).  A wrapper takes the plain
version only for a CPU tensor or under the ``torch`` backend.  Sq may
differ from Skv.

The height-sharded (spatial) and shard_map forms wait for the multi-GPU
slice.  The tagger head's 64-token MHSA stays plain PyTorch
(models/taggers.py), as the JAX package keeps it on XLA.
"""

from __future__ import annotations

import torch

from . import backend
from ._build import check, dtype_code, lib, stream_of


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


def _flash_attention_fwd_kernel(q, k, v):
    _check_qkv(q, k, v)
    b, sq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(b, sq, dtype=torch.float32, device=q.device)
    err = lib("flash_attention_fwd").vt_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dtype_code(q), b, sq,
        k.shape[1], d, 1.0 / (d ** 0.5), out.data_ptr(), lse.data_ptr(),
        stream_of(q))
    check(err, "vt_flash_attn_fwd")
    return out, lse


def flash_attention_fwd(q, k, v):
    """Returns (out (B, Sq, D), lse (B, Sq) fp32); Sq may differ from Skv."""
    if backend.use_kernel(q):
        out = _flash_attention_fwd_kernel(q, k, v)
        backend.count_launch("flash_attention_fwd")
        return out
    return flash_attention_fwd_plain(q, k, v)


def _bwd_args(q, k, v, do, lse, delta):
    """Checked, contiguous kernel arguments shared by kernels D and E."""
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


def flash_attention_bwd_dq(q, k, v, do, lse, delta):
    """dQ (B, Sq, D) from dO, L and Dl = rowsum(dO O); kernel D on a CUDA
    tensor."""
    if not backend.use_kernel(q):
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta)
    keep, args = _bwd_args(q, k, v, do, lse, delta)
    dq = torch.empty_like(keep[0])
    check(lib("flash_attention_bwd").vt_flash_attn_bwd_dq(
        *args, dq.data_ptr(), stream_of(q)), "vt_flash_attn_bwd_dq")
    backend.count_launch("flash_attention_bwd_dq")
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta):
    """(dK, dV) (B, Skv, D) from dO, L and Dl; kernel E on a CUDA tensor."""
    if not backend.use_kernel(q):
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta)
    keep, args = _bwd_args(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(keep[1]), torch.empty_like(keep[2])
    check(lib("flash_attention_bwd").vt_flash_attn_bwd_dkv(
        *args, dk.data_ptr(), dv.data_ptr(), stream_of(q)),
        "vt_flash_attn_bwd_dkv")
    backend.count_launch("flash_attention_bwd_dkv")
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) of single-head attention from the forward's O and
    logsumexp: Dl in torch, then kernels D and E on a CUDA tensor."""
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
    def backward(ctx, do):
        return flash_attention_bwd(*ctx.saved_tensors, do)


def flash_attention(q, k, v):
    """Single-head attention (B, Sq, D) x (B, Skv, D) -> (B, Sq, D) with the
    flash backward: kernels C, D and E on the card."""
    return _FlashAttention.apply(q, k, v)


def spatial_single_head_attention(q, k, v):
    """Single-head self-attention over spatial tokens, (B, S, D) -> (B, S, D)."""
    return flash_attention(q, k, v)
