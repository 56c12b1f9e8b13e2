// Kernel A: GroupNorm(+SiLU) over NHWC activations.
//
// Replaces the TPU kernels vae_tagger_tpu/ops/pallas/groupnorm_silu.py::
// group_norm_silu_pallas (whole sample in VMEM) and
// group_norm_silu_chunked_pallas (two grid phases for samples above VMEM).
// That split exists only because of VMEM: at 1024px and C=512 one bf16
// sample is 16 MB against 227 KB of shared memory per block, so on Hopper
// every size takes the same three launches:
//
//   1. gn_partial_kernel: each block reduces a chunk of rows of one sample
//      for a strip of 32 channels and writes fp32 sum(x) and sum(x^2) per
//      channel to a scratch buffer the wrapper allocated.  No float atomics:
//      the reduction is two-level and fixed in order, so results repeat.
//   2. gn_finalize_kernel: one block per sample folds the partials in a
//      fixed order into per-(n, group) mean and E[x^2], then into
//      per-(n, channel) eff_scale = gamma * rstd and
//      eff_bias = beta - mean * eff_scale, with
//      rstd = 1 / sqrt(E[x^2] - mean^2 + eps) -- the E[x^2]-mean^2 form of
//      the TPU kernels (ops/conv.py:244-257 of the JAX package).
//   3. gn_apply_kernel (group_norm_silu only): y = x*eff_scale + eff_bias,
//      optional SiLU, in fp32, one read and one write.
//
// Passes 1+2 alone are the stats pass that gn_silu_conv3x3 uses for its
// group_stats + effective_affine step.
//
// Bound on this card: memory.  x is read twice (the second read may hit the
// 50 MB L2 at small sizes) and the output written once; the arithmetic is a
// few operations per element.  The design keeps every access coalesced
// along channels and spreads pass 1 over enough blocks (the wrapper picks
// the chunk count) to keep all 132 SMs reading.
#include "common.cuh"

namespace {

constexpr int kStripC = 32;   // channels per block in pass 1
constexpr int kRowsPar = 8;   // rows read in parallel per block in pass 1

template <typename T>
__global__ void __launch_bounds__(kStripC * kRowsPar)
gn_partial_kernel(const T* __restrict__ x, int64_t S, int C, int P,
                  float* __restrict__ partial) {
  const int p = blockIdx.x;
  const int n = blockIdx.y;
  const int c = blockIdx.z * kStripC + threadIdx.x;
  const int64_t rows = (S + P - 1) / P;
  const int64_t r0 = p * rows;
  const int64_t r1 = r0 + rows < S ? r0 + rows : S;

  float s = 0.f, q = 0.f;
  if (c < C) {
    const T* xs = x + (int64_t)n * S * C + c;
    for (int64_t r = r0 + threadIdx.y; r < r1; r += kRowsPar) {
      const float v = vt::to_f(xs[r * C]);
      s += v;
      q += v * v;
    }
  }
  __shared__ float ss[kRowsPar][kStripC + 1];
  __shared__ float sq[kRowsPar][kStripC + 1];
  ss[threadIdx.y][threadIdx.x] = s;
  sq[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPar; ++i) {
      ts += ss[i][threadIdx.x];
      tq += sq[i][threadIdx.x];
    }
    float* out = partial + ((int64_t)n * P + p) * 2 * C;
    out[c] = ts;
    out[C + c] = tq;
  }
}

// One block per sample; dynamic shared memory holds 2*G floats.
__global__ void gn_finalize_kernel(const float* __restrict__ partial,
                                   int64_t S, int C, int G, int P,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta, float eps,
                                   float* __restrict__ mean_out,
                                   float* __restrict__ meansq_out,
                                   float* __restrict__ eff_scale,
                                   float* __restrict__ eff_bias) {
  extern __shared__ float stats[];  // [G] mean, [G] rstd
  const int n = blockIdx.x;
  const int cg = C / G;
  const float count = (float)S * (float)cg;
  const float* base = partial + (int64_t)n * P * 2 * C;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int p = 0; p < P; ++p) {
      const float* row = base + (int64_t)p * 2 * C + g * cg;
      for (int j = 0; j < cg; ++j) {
        s += row[j];
        q += row[C + j];
      }
    }
    const float mean = s / count;
    const float meansq = q / count;
    stats[g] = mean;
    stats[G + g] = 1.0f / sqrtf(meansq - mean * mean + eps);
    if (mean_out != nullptr) {
      mean_out[n * G + g] = mean;
      meansq_out[n * G + g] = meansq;
    }
  }
  __syncthreads();
  if (gamma == nullptr) return;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float sc = gamma[c] * stats[G + g];
    eff_scale[n * C + c] = sc;
    eff_bias[n * C + c] = beta[c] - stats[g] * sc;
  }
}

template <typename T, bool kSilu>
__global__ void gn_apply_kernel(const T* __restrict__ x, int64_t SC, int C,
                                const float* __restrict__ eff_scale,
                                const float* __restrict__ eff_bias,
                                T* __restrict__ out, int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t n = i / SC;
    const int c = (int)(i % C);
    float y = vt::to_f(x[i]) * eff_scale[n * C + c] + eff_bias[n * C + c];
    if (kSilu) y = vt::silu(y);
    out[i] = vt::from_f<T>(y);
  }
}

template <typename T>
void launch_partial(const void* x, int N, int64_t S, int C, int P,
                    float* partial, cudaStream_t st) {
  dim3 grid(P, N, (C + kStripC - 1) / kStripC);
  dim3 block(kStripC, kRowsPar);
  gn_partial_kernel<T><<<grid, block, 0, st>>>(static_cast<const T*>(x), S,
                                               C, P, partial);
}

template <typename T>
void launch_apply(const void* x, int N, int64_t S, int C,
                  const float* eff_scale, const float* eff_bias, void* out,
                  int silu, cudaStream_t st) {
  const int64_t total = (int64_t)N * S * C;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (silu)
    gn_apply_kernel<T, true><<<(int)blocks, threads, 0, st>>>(
        static_cast<const T*>(x), S * C, C, eff_scale, eff_bias,
        static_cast<T*>(out), total);
  else
    gn_apply_kernel<T, false><<<(int)blocks, threads, 0, st>>>(
        static_cast<const T*>(x), S * C, C, eff_scale, eff_bias,
        static_cast<T*>(out), total);
}

}  // namespace

// Stats pass (passes 1 and 2).  partial: N*P*2*C fp32 scratch.  mean_out and
// meansq_out (N*G) may be null; with gamma null, eff_* are not written.
VT_EXPORT int vt_gn_stats(const void* x, int dtype, int N, long long S, int C,
                          int G, int P, const float* gamma, const float* beta,
                          float eps, float* partial, float* mean_out,
                          float* meansq_out, float* eff_scale,
                          float* eff_bias, void* stream) {
  if (N <= 0 || S <= 0 || C <= 0 || G <= 0 || C % G != 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32)
    launch_partial<float>(x, N, S, C, P, partial, st);
  else if (dtype == vt::kBF16)
    launch_partial<__nv_bfloat16>(x, N, S, C, P, partial, st);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finalize_kernel<<<N, 256, 2 * G * sizeof(float), st>>>(
      partial, S, C, G, P, gamma, beta, eps, mean_out, meansq_out, eff_scale,
      eff_bias);
  return (int)cudaGetLastError();
}

// Apply pass: out = [silu](x * eff_scale[n, c] + eff_bias[n, c]).
VT_EXPORT int vt_gn_apply(const void* x, int dtype, int N, long long S, int C,
                          const float* eff_scale, const float* eff_bias,
                          void* out, int silu, void* stream) {
  if (N <= 0 || S <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32)
    launch_apply<float>(x, N, S, C, eff_scale, eff_bias, out, silu, st);
  else if (dtype == vt::kBF16)
    launch_apply<__nv_bfloat16>(x, N, S, C, eff_scale, eff_bias, out, silu,
                                st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
