"""Single-head spatial attention, and kernel C's wrapper.

Counterpart of ``vae_tagger_tpu/ops/attention.py``.  The one long-sequence
attention of the model is the VAE mid-block: one head of D = 512 channels
over the whole latent grid (16,384 tokens at 1024px).  On a CUDA tensor it
runs kernel C (``csrc/flash_attention_fwd.cu``), a streaming-softmax
forward that never materializes the (S, S) scores.  Beside it,
:func:`attention_plain` is the JAX package's ``_xla_attention``: einsum,
fp32 softmax, einsum.  No sequence-length crossover carries over from the
TPU: the kernel runs at every length on the card.

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


def _flash_attention_fwd_kernel(q, k, v):
    b, sq, d = q.shape
    if k.shape != (b, k.shape[1], d) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Skv, {d}) alike, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
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


def spatial_single_head_attention(q, k, v):
    """Single-head self-attention over spatial tokens, (B, S, D) -> (B, S, D)."""
    if backend.use_kernel(q):
        return flash_attention_fwd(q, k, v)[0]
    return attention_plain(q, k, v)
