"""vae_tagger_tpu_torch: the PyTorch/CUDA port of vae_tagger_tpu for an
NVIDIA H100.

It imports torch and never jax or the JAX package.  Every Pallas TPU kernel
on its path is a hand-written CUDA kernel for sm_90a (``csrc/``), with a
plain PyTorch version beside it (``ops/``); the kernels run on CUDA tensors
and the plain versions on CPU tensors.  Entry points run on the card unless
the caller passes ``device="cpu"``.
"""
