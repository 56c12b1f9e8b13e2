// Kernel C: single-head flash-attention forward, O = softmax(Q K^T / sqrt(D)) V
// with a per-row fp32 logsumexp.
//
// Replaces the TPU kernel vae_tagger_tpu/ops/pallas/flash_attention.py::
// _flash_attention_fwd_impl (kernel _fwd_kernel), which runs the VAE
// mid-block attention: one head, D = 512 channels, S = (H/8)*(W/8) tokens
// (4,096 at 512px, 16,384 at 1024px).  Sq may differ from Skv; keys past Skv
// are masked to -1e30 before the exponential, as on the TPU.
//
// The TPU tiles (512 queries x 1024 keys) do not fit a Hopper SM, and the
// trouble is D = 512: a 64 x 512 fp32 output accumulator is 256 registers a
// thread at 128 threads.  Design:
//  - A block owns 32 query rows; each of its 8 warps owns 4 of them for the
//    whole kernel.  The 4 x 512 fp32 accumulator of a warp's rows is split
//    across its 32 lanes by column (lane + 32*j), 64 registers a thread.
//  - Keys stream in tiles of 64.  S = Q K^T for the tile is computed from Q
//    held in shared memory (fp32, 32 x D) and K staged 32 columns of D at a
//    time; lane l of a warp computes keys l and l+32 of its 4 rows, so each
//    row's max and sum reduce inside the warp with shuffles, with the
//    running max m and sum l in registers (the streaming softmax of the TPU
//    kernel, all in fp32).
//  - P (rounded to the input dtype, as the reference casts it before P V)
//    goes to shared memory, read back only by the warp that wrote it; V is
//    staged 16 keys x D at a time and multiplied into the accumulators.
//  - O = acc / l and lse = m + log(max(l, 1e-30)) are written at the end.
//
// Bound on this card: operations.  4*Sq*Skv*D FLOP (550 GFLOP per image at
// S = 16,384) against O(S*D) bytes.  It multiplies with fp32 FMA on the
// CUDA cores and takes fp32 tensors only.  No dispatch table names it any
// more: fp32 tensors go to kernel C'' (flash_attention_fwd_tf32x3.cu),
// which keeps fp32-level error on the tensor cores with 3xTF32 products,
// and bf16 tensors to C' (flash_attention_fwd_tc.cu).  chip_smoke.py
// launches it directly, as the yardstick C'' is checked and timed against.
#include "common.cuh"

namespace {

constexpr int kBQ = 32;
constexpr int kBKV = 64;
constexpr int kThreads = 256;
constexpr int kDChunk = 32;   // D columns of K staged at a time
constexpr int kKPad = 36;     // row stride of the K stage (float4-aligned)
constexpr int kVChunk = 16;   // keys of V staged at a time
constexpr int kJMax = 16;     // D <= 32 * kJMax
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, int Sq, int Skv, int D, float scale,
                 T* __restrict__ out, float* __restrict__ lse) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [kBQ][D]
  float* Ks = Qs + kBQ * D;            // [kBKV][kKPad]
  float* Vs = Ks + kBKV * kKPad;       // [kVChunk][D]
  float* Ps = Vs + kVChunk * D;        // [kBQ][kBKV]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nj = D / 32;
  const T* qb = q + (int64_t)b * Sq * D;
  const T* kb = k + (int64_t)b * Skv * D;
  const T* vb = v + (int64_t)b * Skv * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    Qs[e] = q0 + r < Sq ? vt::to_f(qb[(int64_t)(q0 + r) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kJMax];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kJMax; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < Skv; kv0 += kBKV) {
    // ---- S = Q K^T for this key tile: lane owns keys lane, lane+32
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDChunk) {
      __syncthreads();
      for (int e = tid; e < kBKV * kDChunk; e += kThreads) {
        const int r = e / kDChunk;
        const int dd = e % kDChunk;
        const int kj = kv0 + r;
        Ks[r * kKPad + dd] =
            kj < Skv ? vt::to_f(kb[(int64_t)kj * D + d0 + dd]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < kDChunk; dd += 4) {
        const float4 k0 =
            *reinterpret_cast<const float4*>(&Ks[lane * kKPad + dd]);
        const float4 k1 =
            *reinterpret_cast<const float4*>(&Ks[(lane + 32) * kKPad + dd]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(
              &Qs[(warp * 4 + i) * D + d0 + dd]);
          s[i][0] = fmaf(qv.x, k0.x, s[i][0]);
          s[i][0] = fmaf(qv.y, k0.y, s[i][0]);
          s[i][0] = fmaf(qv.z, k0.z, s[i][0]);
          s[i][0] = fmaf(qv.w, k0.w, s[i][0]);
          s[i][1] = fmaf(qv.x, k1.x, s[i][1]);
          s[i][1] = fmaf(qv.y, k1.y, s[i][1]);
          s[i][1] = fmaf(qv.z, k1.z, s[i][1]);
          s[i][1] = fmaf(qv.w, k1.w, s[i][1]);
        }
      }
    }

    // ---- streaming softmax update, fp32, per row inside the warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s0 = kv0 + lane < Skv ? s[i][0] * scale : kNegInf;
      const float s1 = kv0 + lane + 32 < Skv ? s[i][1] * scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p0 + p1);
      m[i] = m_new;
      Ps[(warp * 4 + i) * kBKV + lane] = vt::round_to<T>(p0);
      Ps[(warp * 4 + i) * kBKV + lane + 32] = vt::round_to<T>(p1);
#pragma unroll
      for (int j = 0; j < kJMax; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();

    // ---- acc += P V, V staged kVChunk keys at a time
    for (int kc = 0; kc < kBKV; kc += kVChunk) {
      __syncthreads();
      for (int e = tid; e < kVChunk * D; e += kThreads) {
        const int r = e / D;
        const int d = e - r * D;
        const int kj = kv0 + kc + r;
        Vs[e] = kj < Skv ? vt::to_f(vb[(int64_t)kj * D + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kVChunk; ++kk) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ps[(warp * 4 + i) * kBKV + kc + kk];
#pragma unroll
        for (int j = 0; j < kJMax; ++j) {
          if (j < nj) {
            const float vv = Vs[kk * D + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + warp * 4 + i;
    if (row >= Sq) continue;
    T* orow = out + ((int64_t)b * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < kJMax; ++j)
      if (j < nj) orow[lane + 32 * j] = vt::from_f<T>(acc[i][j] / l[i]);
    if (lane == 0)
      lse[(int64_t)b * Sq + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, int B, int Sq,
           int Skv, int D, float scale, void* out, float* lse,
           cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * D + kBKV * kKPad + (size_t)kVChunk * D +
                       kBQ * kBKV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), Sq, Skv, D, scale, static_cast<T*>(out), lse);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,Sq,D), k and v (B,Skv,D), all contiguous fp32; out (B,Sq,D) fp32;
// lse (B,Sq) fp32.  D must be a multiple of 32, at most 512.
VT_EXPORT int vt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                int dtype, int B, int Sq, int Skv, int D,
                                float scale, void* out, float* lse,
                                void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 32 != 0 ||
      D > 32 * kJMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32)
    return launch<float>(q, k, v, B, Sq, Skv, D, scale, out, lse, st);
  return (int)cudaErrorInvalidValue;
}
