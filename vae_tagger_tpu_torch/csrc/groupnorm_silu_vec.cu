// Kernel A for Hopper's memory system: GroupNorm(+SiLU) over NHWC
// activations, in two launches -- the stats pass and the apply pass.
//
// Replaces the TPU kernels vae_tagger_tpu/ops/pallas/groupnorm_silu.py::
// group_norm_silu_pallas (whole sample in VMEM) and
// group_norm_silu_chunked_pallas (two grid phases for samples above VMEM),
// and the stats step of the fused conv (vae_tagger_tpu/ops/conv.py::
// group_stats and effective_affine, XLA on the TPU).  The SIMT kernels of
// csrc/groupnorm_silu.cu are the first form of this kernel; they are kept
// as its yardstick and not dispatched.
//
// Function (as the JAX kernels): fp32 statistics whatever the input dtype,
// mean = E[x], meansq = E[x^2] per (sample, group), rstd =
// 1 / sqrt(meansq - mean^2 + eps), eff_scale = gamma * rstd, eff_bias =
// beta - mean * eff_scale; the apply pass computes y = x * eff_scale +
// eff_bias and optionally y * sigmoid(y) in fp32, with one cast at the end.
//
// Bound on this card: bytes.  The stats pass reads x once, the apply pass
// reads it again and writes y; a few operations per element.  So the design
// is about keeping enough bytes in flight and nothing else in the way:
//
// - One block streams a contiguous span of whole rows of one sample (R rows
//   x C channels, contiguous in NHWC).  Each thread owns one fixed vector
//   of V channels -- 8 bf16 or 4 fp32, one 16-byte load -- and steps down
//   the span rows_par rows at a time with kUnroll loads in flight, so its
//   per-channel fp32 sums stay in registers and the block reads 4 KB of
//   contiguous memory a step.  The wrapper's plan (ops/normalization.py::
//   gn_plan) sizes the grid to one wave of GN_BLOCKS_PER_SM blocks an SM.
// - The stats pass is one launch.  Each block folds its per-thread sums in
//   shared memory into one (sum, sum of squares) pair per group and writes
//   those to a partial buffer laid out [n][group][block], then counts its
//   arrival on an integer counter of its sample (release: a fence before
//   the atomic; acquire: a fence after it).  The block that arrives last
//   folds the sample's partials in a fixed order (8 threads a group over
//   the blocks, then their butterfly), writes mean/meansq and
//   eff_scale/eff_bias, and sets the counter back to 0 for the next
//   launch, so no memset runs per call.
//   No float atomics: results repeat bit for bit.
// - The apply pass is a grid over (row spans, samples) in the same plan;
//   each thread keeps its vector's eff_scale/eff_bias in registers and
//   loads and stores 16 bytes at a time.  No per-element integer division;
//   the SiLU runs on the SFU (fast_silu), or, in fp32, exactly (vt::silu:
//   expf and IEEE division) where kernel B'' reads the output
//   (ops/conv.py), at the same rate.
// - Where C is not a multiple of V or x is not 16-byte aligned, the same
//   kernels run with V = 1 (one element a thread).  Where a row holds more
//   than kThreads vectors, blockIdx.z cuts it into strips of kThreads
//   vectors; a block writes zero partials for the groups outside its strip.
#include <type_traits>

#include "gn_plan.cuh"

namespace {

using vt::gn::Geo;
using vt::gn::Vec;
using vt::gn::check_plan;
using vt::gn::geo;
using vt::gn::kMinBlocksPerSm;
using vt::gn::kThreads;
using vt::gn::kUnroll;
constexpr int kWarps = kThreads / 32;
constexpr int kFoldLanes = 8;  // threads a group in the last block's fold

// The apply pass's SiLU, vt_gn_apply_vec's `silu`.
enum Silu : int { kNoSilu = 0, kFastSilu = 1, kExactSilu = 2 };

// y * sigmoid(y) on the SFU (__expf, __fdividef): a few ulp from
// vt::silu's expf and IEEE division, far inside the kernel's fp32 gate
// (1e-4 against torch.sigmoid), at about a fifth of the instructions.  In
// fp32 the exact form streams as fast (10.88 against 10.82 ms over kernel
// B'''s 20 inputs of a 1024px batch of 4, on an H100 at 700 W); in bf16,
// twice the elements a byte, it is neither built nor measured.  For y
// below -87 the quotient is 0, the limit of the exact value.
__device__ __forceinline__ float fast_silu(float y) {
  return __fdividef(y, 1.0f + __expf(-y));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
gn_stats_vec_kernel(const T* __restrict__ x, long long S, int C, int G,
                    int rows, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float eps,
                    float2* __restrict__ partial,
                    unsigned* __restrict__ arrivals,
                    float* __restrict__ mean_out,
                    float* __restrict__ meansq_out,
                    float* __restrict__ eff_scale,
                    float* __restrict__ eff_bias) {
  __shared__ float red_s[kThreads * V];
  __shared__ float red_q[kThreads * V];
  __shared__ bool last;
  const int n = blockIdx.y;
  const Geo g = geo<V>(S, C, rows);

  // 1. this thread's rows, kUnroll loads in flight
  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.f;
  if (g.active) {
    const T* base =
        x + (long long)n * S * C + (long long)(g.slot0 + g.lane) * V;
    const long long step = g.rows_par;
    long long r = g.r0 + g.row;
    for (; r + (kUnroll - 1) * step < g.r1; r += kUnroll * step) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        Vec<T, V>::load(base + (r + u * step) * C, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s[j] += v[u][j];
          q[j] += v[u][j] * v[u][j];
        }
    }
    for (; r < g.r1; r += step) {
      float v[V];
      Vec<T, V>::load(base + r * C, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] += v[j];
        q[j] += v[j] * v[j];
      }
    }
  }
  // thread t's sums sit at [t * V, (t + 1) * V): row-major over
  // (row, channel of the strip)
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red_s[threadIdx.x * V + j] = s[j];
    red_q[threadIdx.x * V + j] = q[j];
  }
  __syncthreads();

  // 2. one (sum, sum of squares) pair per group of this strip: warp w takes
  // groups w, w + kWarps, ...; its lanes the (row, channel) cells in order
  const int cg = C / G;
  const int c_lo = g.slot0 * V, c_hi = (g.slot0 + g.nslot) * V;
  const int g_lo = c_lo / cg, g_hi = (c_hi - 1) / cg;
  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32;
  const int nb = gridDim.x * gridDim.z;  // blocks of one sample
  const int b = blockIdx.x * gridDim.z + blockIdx.z;
  const int width = g.strip * V;  // one row of red_s
  for (int grp = g_lo + warp; grp <= g_hi; grp += kWarps) {
    const int a = max(grp * cg, c_lo) - c_lo;
    const int w = min((grp + 1) * cg, c_hi) - c_lo - a;
    float ts = 0.f, tq = 0.f;
    for (int i = ln; i < g.rows_par * w; i += 32) {
      const int cell = (i / w) * width + a + i % w;
      ts += red_s[cell];
      tq += red_q[cell];
    }
    ts = warp_sum(ts);
    tq = warp_sum(tq);
    if (ln == 0)
      partial[((long long)n * G + grp) * nb + b] = make_float2(ts, tq);
  }
  if (gridDim.z > 1)  // groups outside this strip
    for (int grp = threadIdx.x; grp < G; grp += kThreads)
      if (grp < g_lo || grp > g_hi)
        partial[((long long)n * G + grp) * nb + b] = make_float2(0.f, 0.f);

  // 3. arrival: the last block of the sample folds
  __threadfence();  // release: this thread's partials before the count
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(arrivals + n, 1u) == (unsigned)(nb - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();  // acquire: every block's partials after the count

  // 4. the fold: kFoldLanes threads a group, each summing blocks sub,
  // sub + kFoldLanes, ... in order (loads unrolled, so several are in
  // flight), then a butterfly over those threads; kThreads / kFoldLanes
  // groups a round
  const float count = (float)S * (float)cg;
  const int sub = threadIdx.x % kFoldLanes;
  for (int g0 = 0; g0 < G; g0 += kThreads / kFoldLanes) {
    const int grp = g0 + threadIdx.x / kFoldLanes;
    float ts = 0.f, tq = 0.f;
    if (grp < G) {
      const float2* pg = partial + ((long long)n * G + grp) * nb;
#pragma unroll 8
      for (int i = sub; i < nb; i += kFoldLanes) {
        const float2 v = __ldcg(pg + i);
        ts += v.x;
        tq += v.y;
      }
    }
#pragma unroll
    for (int o = kFoldLanes / 2; o > 0; o >>= 1) {
      ts += __shfl_xor_sync(0xffffffffu, ts, o);
      tq += __shfl_xor_sync(0xffffffffu, tq, o);
    }
    if (grp < G && sub == 0) {
      mean_out[n * G + grp] = ts / count;
      meansq_out[n * G + grp] = tq / count;
    }
  }
  if (threadIdx.x == 0) arrivals[n] = 0u;  // every block of n has arrived
  if (gamma == nullptr) return;
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int grp = c / cg;
    const float mean = mean_out[n * G + grp];
    const float rstd =
        1.0f / sqrtf(meansq_out[n * G + grp] - mean * mean + eps);
    const float sc = gamma[c] * rstd;
    eff_scale[(long long)n * C + c] = sc;
    eff_bias[(long long)n * C + c] = beta[c] - mean * sc;
  }
}

template <int kSilu>
__device__ __forceinline__ float apply_silu(float y) {
  return kSilu == kExactSilu ? vt::silu(y) : kSilu ? fast_silu(y) : y;
}

template <typename T, int V, int kSilu>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
gn_apply_vec_kernel(const T* __restrict__ x, long long S, int C, int rows,
                    const float* __restrict__ eff_scale,
                    const float* __restrict__ eff_bias, T* __restrict__ out) {
  const int n = blockIdx.y;
  const Geo g = geo<V>(S, C, rows);
  if (!g.active) return;
  const int c0 = (g.slot0 + g.lane) * V;
  float sc[V], bi[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sc[j] = eff_scale[(long long)n * C + c0 + j];
    bi[j] = eff_bias[(long long)n * C + c0 + j];
  }
  const long long off = (long long)n * S * C + c0;
  const T* xs = x + off;
  T* os = out + off;
  const long long step = g.rows_par;
  long long r = g.r0 + g.row;
  for (; r + (kUnroll - 1) * step < g.r1; r += kUnroll * step) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      Vec<T, V>::load(xs + (r + u * step) * C, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float y = v[u][j] * sc[j] + bi[j];
        v[u][j] = apply_silu<kSilu>(y);
      }
      Vec<T, V>::store(os + (r + u * step) * C, v[u]);
    }
  }
  for (; r < g.r1; r += step) {
    float v[V];
    Vec<T, V>::load(xs + r * C, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float y = v[j] * sc[j] + bi[j];
      v[j] = apply_silu<kSilu>(y);
    }
    Vec<T, V>::store(os + r * C, v);
  }
}


template <typename T, int V>
void launch_stats(const void* x, int N, long long S, int C, int G, int rows,
                  int blocks, int strips, const float* gamma,
                  const float* beta, float eps, void* partial,
                  void* arrivals, float* mean_out, float* meansq_out,
                  float* eff_scale, float* eff_bias, cudaStream_t st) {
  gn_stats_vec_kernel<T, V><<<dim3(blocks, N, strips), kThreads, 0, st>>>(
      static_cast<const T*>(x), S, C, G, rows, gamma, beta, eps,
      static_cast<float2*>(partial), static_cast<unsigned*>(arrivals),
      mean_out, meansq_out, eff_scale, eff_bias);
}

template <typename T, int V>
void launch_apply(const void* x, int N, long long S, int C, int rows,
                  int blocks, int strips, const float* eff_scale,
                  const float* eff_bias, void* out, int silu,
                  cudaStream_t st) {
  const dim3 grid(blocks, N, strips);
  if constexpr (std::is_same_v<T, float>) {  // the exact SiLU: fp32 only
    if (silu == kExactSilu) {
      gn_apply_vec_kernel<T, V, kExactSilu><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(x), S, C, rows, eff_scale, eff_bias,
          static_cast<T*>(out));
      return;
    }
  }
  if (silu == kFastSilu)
    gn_apply_vec_kernel<T, V, kFastSilu><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), S, C, rows, eff_scale, eff_bias,
        static_cast<T*>(out));
  else
    gn_apply_vec_kernel<T, V, kNoSilu><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), S, C, rows, eff_scale, eff_bias,
        static_cast<T*>(out));
}

}  // namespace

// Stats pass, one launch.  partial: N * G * blocks * strips float2 scratch;
// arrivals: N unsigned counters, 0 on entry and left 0; mean_out and
// meansq_out: N * G; with gamma null, eff_* are not written.
VT_EXPORT int vt_gn_stats_vec(const void* x, int dtype, int N, long long S,
                              int C, int G, int vec, int rows, int blocks,
                              int strips, const float* gamma,
                              const float* beta, float eps, void* partial,
                              void* arrivals, float* mean_out,
                              float* meansq_out, float* eff_scale,
                              float* eff_bias, void* stream) {
  if (G <= 0 || C % G != 0 || partial == nullptr || arrivals == nullptr ||
      mean_out == nullptr || meansq_out == nullptr ||
      (gamma == nullptr) != (beta == nullptr) ||
      (gamma != nullptr && (eff_scale == nullptr || eff_bias == nullptr)) ||
      check_plan(dtype, N, S, C, vec, rows, blocks, strips, x, x))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32) {
    if (vec == 1)
      launch_stats<float, 1>(x, N, S, C, G, rows, blocks, strips, gamma, beta,
                             eps, partial, arrivals, mean_out, meansq_out,
                             eff_scale, eff_bias, st);
    else
      launch_stats<float, 4>(x, N, S, C, G, rows, blocks, strips, gamma, beta,
                             eps, partial, arrivals, mean_out, meansq_out,
                             eff_scale, eff_bias, st);
  } else {
    if (vec == 1)
      launch_stats<__nv_bfloat16, 1>(x, N, S, C, G, rows, blocks, strips,
                                     gamma, beta, eps, partial, arrivals,
                                     mean_out, meansq_out, eff_scale,
                                     eff_bias, st);
    else
      launch_stats<__nv_bfloat16, 8>(x, N, S, C, G, rows, blocks, strips,
                                     gamma, beta, eps, partial, arrivals,
                                     mean_out, meansq_out, eff_scale,
                                     eff_bias, st);
  }
  return (int)cudaGetLastError();
}

// Apply pass: out = [silu](x * eff_scale[n, c] + eff_bias[n, c]), in the
// same plan as the stats pass; silu: 0 none, 1 on the SFU, 2 exact (fp32
// only).
VT_EXPORT int vt_gn_apply_vec(const void* x, int dtype, int N, long long S,
                              int C, int vec, int rows, int blocks,
                              int strips, const float* eff_scale,
                              const float* eff_bias, void* out, int silu,
                              void* stream) {
  if (eff_scale == nullptr || eff_bias == nullptr || out == nullptr ||
      silu < kNoSilu || silu > kExactSilu ||
      (silu == kExactSilu && dtype != vt::kF32) ||
      check_plan(dtype, N, S, C, vec, rows, blocks, strips, x, out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32) {
    if (vec == 1)
      launch_apply<float, 1>(x, N, S, C, rows, blocks, strips, eff_scale,
                             eff_bias, out, silu, st);
    else
      launch_apply<float, 4>(x, N, S, C, rows, blocks, strips, eff_scale,
                             eff_bias, out, silu, st);
  } else {
    if (vec == 1)
      launch_apply<__nv_bfloat16, 1>(x, N, S, C, rows, blocks, strips,
                                     eff_scale, eff_bias, out, silu, st);
    else
      launch_apply<__nv_bfloat16, 8>(x, N, S, C, rows, blocks, strips,
                                     eff_scale, eff_bias, out, silu, st);
  }
  return (int)cudaGetLastError();
}
