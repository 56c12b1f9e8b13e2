// The per-pixel RMS norm of the Wan VAE (diffusers WanRMS_norm,
// F.normalize(x, dim=channels) * sqrt(C) * gamma) over NHWC rows: two
// bytes-bound passes, bf16 or fp32 in and out.
//
// No TPU kernel stands behind them: the JAX package runs no Wan VAE.  They
// are the RMS counterparts of kernel A's two passes (groupnorm_silu_vec.cu):
//  - the stats pass reads x once and writes one fp32 factor a pixel,
//    r[p] = sqrt(C) / max(||x[p, :]||_2, eps): what kernel B' takes in its
//    RMS mode (gn_silu_conv3x3_tc.cu), and what the apply pass takes;
//  - the apply pass writes [silu]((x * r[p]) * gamma[c]) in x's dtype, in
//    fp32 arithmetic and one rounding: the input of kernel B'' in fp32 (the
//    exact SiLU, as kernel A's pass feeds B''), the input of the Wan head's
//    conv and of the mid-block attention's projection (no SiLU there).
// The norm is over the C channels of one pixel, which sit contiguous in
// NHWC, so a pixel is C / V vectors of 16 bytes (V elements) or, where C or
// the base address does not allow that, C single elements.  A block of 256
// threads takes a tile of up to 1,024 consecutive vectors (4 loads in
// flight a thread, each warp's loads contiguous): the stats pass sums each
// vector's squares into shared memory, then one thread a pixel adds its
// pixel's C / V partial sums; the apply pass, on the same tiles, needs no
// exchange.
#include <type_traits>

#include "gn_plan.cuh"

namespace {

using vt::gn::Vec;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTile = kThreads * kUnroll;  // vectors a block

enum Silu : int { kNoSilu = 0, kFastSilu = 1, kExactSilu = 2 };

template <int kSilu>
__device__ __forceinline__ float apply_silu(float y) {
  if constexpr (kSilu == kExactSilu) return vt::silu(y);
  if constexpr (kSilu == kFastSilu) return __fdividef(y, 1.0f + __expf(-y));
  return y;
}

// Block b: pixels [b * pb, min((b + 1) * pb, P)), pb = kTile / vpp.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rms_stats_kernel(const T* __restrict__ x, long long P, int C, int vpp,
                 int pb, float scale, float eps, float* __restrict__ r) {
  __shared__ float part[kTile];
  const long long p0 = (long long)blockIdx.x * pb;
  const int np = (int)min((long long)pb, P - p0);
  const int nv = np * vpp;
  const T* base = x + p0 * C;
  float v[kUnroll][V];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (i < nv) Vec<T, V>::load(base + (long long)i * V, v[u]);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (i < nv) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) s = fmaf(v[u][j], v[u][j], s);
      part[i] = s;
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < np; p += kThreads) {
    const float* q = part + p * vpp;
    float s = 0.f;
    for (int k = 0; k < vpp; ++k) s += q[k];
    r[p0 + p] = scale / fmaxf(sqrtf(s), eps);
  }
}

// Block b: pixels [b * pb, min((b + 1) * pb, P)), as the stats pass; the
// block's vector i is pixel i / vpp, channels (i % vpp) * V (32-bit
// arithmetic: a 64-bit division is a call that spills).
template <typename T, int V, int kSilu>
__global__ void __launch_bounds__(kThreads)
rms_apply_kernel(const T* __restrict__ x, long long P, int C, int vpp,
                 int pb, const float* __restrict__ r,
                 const float* __restrict__ gamma, T* __restrict__ out) {
  const long long p0 = (long long)blockIdx.x * pb;
  const int np = (int)min((long long)pb, P - p0);
  const int nv = np * vpp;
  const T* xs = x + p0 * C;
  T* os = out + p0 * C;
  float v[kUnroll][V];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (i < nv) Vec<T, V>::load(xs + (long long)i * V, v[u]);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (i >= nv) continue;
    const int p = i / vpp;
    const int c0 = (i - p * vpp) * V;
    const float rr = r[p0 + p];
#pragma unroll
    for (int j = 0; j < V; ++j)
      v[u][j] = apply_silu<kSilu>((v[u][j] * rr) * gamma[c0 + j]);
    Vec<T, V>::store(os + (long long)i * V, v[u]);
  }
}

int vec_of(int dtype, int C, bool aligned) {
  const int v = dtype == vt::kF32 ? 4 : 8;
  return aligned && C % v == 0 ? v : 1;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int V>
void launch_stats(const void* x, long long P, int C, float eps, float* r,
                  cudaStream_t st) {
  const int vpp = C / V;
  const int pb = kTile / vpp;
  const long long blocks = (P + pb - 1) / pb;
  rms_stats_kernel<T, V><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), P, C, vpp, pb, sqrtf((float)C), eps, r);
}

template <typename T, int V>
void launch_apply(const void* x, long long P, int C, const float* r,
                  const float* gamma, void* out, int silu, cudaStream_t st) {
  const int vpp = C / V;
  const int pb = kTile / vpp;
  const unsigned blocks = (unsigned)((P + pb - 1) / pb);
  const T* xs = static_cast<const T*>(x);
  T* os = static_cast<T*>(out);
  if constexpr (std::is_same_v<T, float>) {  // the exact SiLU: fp32 only
    if (silu == kExactSilu) {
      rms_apply_kernel<T, V, kExactSilu><<<blocks, kThreads, 0, st>>>(
          xs, P, C, vpp, pb, r, gamma, os);
      return;
    }
  }
  if (silu == kFastSilu)
    rms_apply_kernel<T, V, kFastSilu><<<blocks, kThreads, 0, st>>>(
        xs, P, C, vpp, pb, r, gamma, os);
  else
    rms_apply_kernel<T, V, kNoSilu><<<blocks, kThreads, 0, st>>>(
        xs, P, C, vpp, pb, r, gamma, os);
}

}  // namespace

// Stats pass: x (P, C) rows of a contiguous NHWC tensor (P = N*H*W pixels),
// bf16 or fp32; r (P) fp32, r[p] = sqrt(C) / max(||x[p, :]||_2, eps).
// C / V (V = 8 bf16 or 4 fp32 elements where C and x allow, else 1) must
// not pass 1,024.
VT_EXPORT int vt_rms_stats(const void* x, int dtype, long long P, int C,
                           float eps, float* r, void* stream) {
  if ((dtype != vt::kF32 && dtype != vt::kBF16) || P <= 0 || C <= 0 ||
      x == nullptr || r == nullptr)
    return (int)cudaErrorInvalidValue;
  const int vec = vec_of(dtype, C, aligned16(x));
  if (C / vec > kTile) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32) {
    if (vec == 1) launch_stats<float, 1>(x, P, C, eps, r, st);
    else launch_stats<float, 4>(x, P, C, eps, r, st);
  } else {
    if (vec == 1) launch_stats<__nv_bfloat16, 1>(x, P, C, eps, r, st);
    else launch_stats<__nv_bfloat16, 8>(x, P, C, eps, r, st);
  }
  return (int)cudaGetLastError();
}

// Apply pass: out[p, c] = [silu]((x[p, c] * r[p]) * gamma[c]) in fp32, one
// rounding to x's dtype; gamma (C) fp32; silu: 0 none, 1 on the SFU, 2
// exact (vt::silu, fp32 only).  16-byte vectors where C, x and out allow;
// C / V must not pass 1,024.
VT_EXPORT int vt_rms_apply(const void* x, int dtype, long long P, int C,
                           const float* r, const float* gamma, void* out,
                           int silu, void* stream) {
  if ((dtype != vt::kF32 && dtype != vt::kBF16) || P <= 0 || C <= 0 ||
      x == nullptr || r == nullptr || gamma == nullptr || out == nullptr ||
      silu < kNoSilu || silu > kExactSilu ||
      (silu == kExactSilu && dtype != vt::kF32))
    return (int)cudaErrorInvalidValue;
  const int vec = vec_of(dtype, C, aligned16(x) && aligned16(out));
  if (C / vec > kTile) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32) {
    if (vec == 1) launch_apply<float, 1>(x, P, C, r, gamma, out, silu, st);
    else launch_apply<float, 4>(x, P, C, r, gamma, out, silu, st);
  } else {
    if (vec == 1)
      launch_apply<__nv_bfloat16, 1>(x, P, C, r, gamma, out, silu, st);
    else
      launch_apply<__nv_bfloat16, 8>(x, P, C, r, gamma, out, silu, st);
  }
  return (int)cudaGetLastError();
}
