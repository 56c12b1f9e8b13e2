"""Mixed-precision policy (the port's copy of
``vae_tagger_tpu/core/precision.py``, with torch dtypes).

Parameters stay fp32; with mixed precision on, the VAE's activations, convs
and matmuls run in bf16 (same exponent range as fp32, so no loss scaling),
while GroupNorm statistics and the attention softmax stay fp32.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """param_dtype:   dtype parameters are stored in
    compute_dtype: dtype activations and matmuls run in
    output_dtype:  dtype of user-facing outputs (latents, logits)"""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32


FP32 = Policy()
BF16 = Policy(compute_dtype=torch.bfloat16)


def resolve_mixed_precision(name: str | None) -> Policy:
    """Map ``--mixed_precision`` values ("no", "fp16", "bf16") to a policy.

    Both "fp16" and "bf16" select bf16 compute; "no"/None selects fp32."""
    if name is None or name in ("no", "fp32", "float32"):
        return FP32
    if name in ("fp16", "float16", "bf16", "bfloat16"):
        return BF16
    raise ValueError(f"unknown mixed_precision: {name!r}")
