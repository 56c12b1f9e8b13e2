"""Kernel backend selection: hand-written CUDA kernels vs plain PyTorch.

Counterpart of ``vae_tagger_tpu/ops/backend.py``.  Every op with a kernel
has a plain PyTorch version beside it in the same module.  The policy:

- backend ``kernel`` (the default): a CUDA tensor goes to the hand kernel,
  a CPU tensor to the plain version -- the plain version is taken only
  because the tensor lies on the CPU;
- backend ``torch``: the plain version on every device.  On the card this
  is the yardstick the kernels are checked against (chip_smoke.py).

Set with the environment variable ``VAE_TAGGER_TORCH_BACKEND`` or, for a
region, the :func:`backend` context.  No TPU policy table or crossover
carries over: none was measured on this card.

The module also holds the launch counters: each kernel wrapper adds one to
its counter where it launches its kernel, and nowhere else, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import contextlib
import os

_VALID = ("kernel", "torch")
_BACKEND = os.environ.get("VAE_TAGGER_TORCH_BACKEND", "kernel")
if _BACKEND not in _VALID:
    raise ValueError(f"VAE_TAGGER_TORCH_BACKEND must be one of {_VALID}, "
                     f"got {_BACKEND!r}")

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES = {
    "group_norm_silu": 0,
    "group_stats": 0,
    "gn_silu_conv3x3": 0,
    "flash_attention_fwd": 0,
    "flash_attention_bwd_dq": 0,
    "flash_attention_bwd_dkv": 0,
}


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}, got {name!r}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


def use_kernel(t) -> bool:
    """True when the op on tensor ``t`` should launch its CUDA kernel."""
    return _BACKEND == "kernel" and t.is_cuda


@contextlib.contextmanager
def backend(name: str):
    """Temporarily force a backend (tests, and chip_smoke's yardstick)."""
    global _BACKEND
    prev = _BACKEND
    set_backend(name)
    try:
        yield
    finally:
        _BACKEND = prev


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
