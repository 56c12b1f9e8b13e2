// Shared helpers for the hand-written Hopper kernels of vae_tagger_tpu_torch.
//
// Every kernel file exposes a plain C interface (no PyTorch headers), is
// compiled by nvcc into its own shared library (ops/_build.py) and called
// through ctypes.  Pointers and the CUDA stream arrive as void*; each entry
// point launches on that stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define VT_EXPORT extern "C" __attribute__((visibility("default")))

namespace vt {

// dtype codes shared with the Python wrappers (ops/_build.py::DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round an fp32 value through T (identity for fp32): models the cast to the
// compute dtype that the reference applies before a matmul operand.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// y * sigmoid(y), the order of operations of jax.nn.silu / F.silu.
__device__ __forceinline__ float silu(float y) {
  return y * (1.0f / (1.0f + expf(-y)));
}

}  // namespace vt
