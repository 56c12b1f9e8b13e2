// Kernels D and E: the single-head flash-attention backward, from the
// forward's saved O and per-row logsumexp L (kernel C):
//
//   P  = exp(Q K^T * scale - L)          recomputed, never stored
//   Dl = rowsum(dO * O)                  (B, Sq) fp32, computed by the wrapper
//   dS = P * (dO V^T - Dl)
//   D: dQ = scale * dS K                 one writer per q row
//   E: dV = P^T dO,  dK = scale * dS^T Q one writer per k row
//
// Replace the TPU kernels of vae_tagger_tpu/ops/pallas/flash_attention.py::
// _flash_attention_bwd_impl: _bwd_dq_kernel (D) and _bwd_dkv_kernel (E).
// The TPU grids run in order and carry the accumulators across the innermost
// grid step in VMEM; here a block owns its output rows and loops over the
// whole reduction itself, so no float atomics are used and results repeat
// from run to run.  Padding is bounds checks: a key past Skv gets P = 0, a
// query row past Sq gets P = 0 (the TPU pads with -inf and L = +BIG).
// All arithmetic is fp32 for fp32 and bf16 inputs; P and dS are rounded to
// the input dtype before the products that use them, as the reference casts
// them before its dots.
//
// Bound on this card: operations.  D does 6 and E 8 * B*Sq*Skv*D FLOP
// (2.5 and 3.3 TFLOP at B=3, S=16,384, D=512) against O(S*D) bytes.  This
// first version runs fp32 FMA on the CUDA cores; wgmma is the later step.
//
// D = 512 is the difficulty, as in kernel C:
//  - D keeps C's layout: a block owns 32 q rows, each warp 4 rows, each lane
//    16 columns of the dQ accumulator (64 registers).  Q and dO of the block
//    sit in shared memory as fp32; K and V stream in tiles of 64 keys, 32
//    columns of D at a time, for the two dot products S and dP of each
//    (q, k) pair (lane l owns keys l and l+32, as in C).  dS goes to shared
//    memory, read back only by the warp that wrote it, and K is staged 16
//    keys x D at a time for dQ += dS K.
//  - E accumulates both dK and dV.  C's layout would need 128 accumulators
//    a thread; E takes fewer rows per warp instead: a block owns 16 k rows,
//    each warp 2, each lane 16 columns of dK and of dV (64 registers).  K and
//    V of the block stay in shared memory; Q and dO stream in tiles of 32
//    rows (lane l owns q row l for S^T and dP^T), rows padded by 4 floats so
//    the per-lane float4 reads hit distinct banks.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kJMax = 16;  // D <= 32 * kJMax
constexpr float kBigPos = 1e30f;

// ---- kernel D: dQ
constexpr int kDRows = 32;    // q rows per block (4 per warp)
constexpr int kDKeys = 64;    // keys per tile (2 per lane)
constexpr int kDChunk = 32;   // D columns of K and V staged at a time
constexpr int kDPad = 36;     // row stride of those stages (float4-aligned)
constexpr int kDKFull = 16;   // keys of K staged with all D columns

// ---- kernel E: dK, dV
constexpr int kERows = 16;    // k rows per block (2 per warp)
constexpr int kEQ = 32;       // q rows per tile (1 per lane)

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int Sq, int Skv, int D,
                    float scale, T* __restrict__ dq) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // [kDRows][D]
  float* dOs = Qs + kDRows * D;         // [kDRows][D]
  float* Ks = dOs + kDRows * D;         // [kDKeys][kDPad]
  float* Vs = Ks + kDKeys * kDPad;      // [kDKeys][kDPad]
  float* Kf = Vs + kDKeys * kDPad;      // [kDKFull][D]
  float* dSs = Kf + kDKFull * D;        // [kDRows][kDKeys]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kDRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nj = D / 32;
  const T* qb = q + (int64_t)b * Sq * D;
  const T* ob = dout + (int64_t)b * Sq * D;
  const T* kb = k + (int64_t)b * Skv * D;
  const T* vb = v + (int64_t)b * Skv * D;

  for (int e = tid; e < kDRows * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const bool ok = q0 + r < Sq;
    const int64_t off = (int64_t)(q0 + r) * D + d;
    Qs[e] = ok ? vt::to_f(qb[off]) : 0.f;
    dOs[e] = ok ? vt::to_f(ob[off]) : 0.f;
  }

  float L[4], Dl[4], acc[4][kJMax];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + warp * 4 + i;
    L[i] = row < Sq ? lse[(int64_t)b * Sq + row] : kBigPos;
    Dl[i] = row < Sq ? delta[(int64_t)b * Sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < kJMax; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < Skv; kv0 += kDKeys) {
    // ---- S = Q K^T and dP = dO V^T for this key tile
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDChunk) {
      __syncthreads();
      for (int e = tid; e < kDKeys * kDChunk; e += kThreads) {
        const int r = e / kDChunk;
        const int dd = e % kDChunk;
        const int kj = kv0 + r;
        const int64_t off = (int64_t)kj * D + d0 + dd;
        Ks[r * kDPad + dd] = kj < Skv ? vt::to_f(kb[off]) : 0.f;
        Vs[r * kDPad + dd] = kj < Skv ? vt::to_f(vb[off]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < kDChunk; dd += 4) {
        const float4 k0 =
            *reinterpret_cast<const float4*>(&Ks[lane * kDPad + dd]);
        const float4 k1 =
            *reinterpret_cast<const float4*>(&Ks[(lane + 32) * kDPad + dd]);
        const float4 v0 =
            *reinterpret_cast<const float4*>(&Vs[lane * kDPad + dd]);
        const float4 v1 =
            *reinterpret_cast<const float4*>(&Vs[(lane + 32) * kDPad + dd]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ro = (warp * 4 + i) * D + d0 + dd;
          const float4 qv = *reinterpret_cast<const float4*>(&Qs[ro]);
          const float4 ov = *reinterpret_cast<const float4*>(&dOs[ro]);
          s[i][0] = fmaf(qv.x, k0.x, s[i][0]);
          s[i][0] = fmaf(qv.y, k0.y, s[i][0]);
          s[i][0] = fmaf(qv.z, k0.z, s[i][0]);
          s[i][0] = fmaf(qv.w, k0.w, s[i][0]);
          s[i][1] = fmaf(qv.x, k1.x, s[i][1]);
          s[i][1] = fmaf(qv.y, k1.y, s[i][1]);
          s[i][1] = fmaf(qv.z, k1.z, s[i][1]);
          s[i][1] = fmaf(qv.w, k1.w, s[i][1]);
          dp[i][0] = fmaf(ov.x, v0.x, dp[i][0]);
          dp[i][0] = fmaf(ov.y, v0.y, dp[i][0]);
          dp[i][0] = fmaf(ov.z, v0.z, dp[i][0]);
          dp[i][0] = fmaf(ov.w, v0.w, dp[i][0]);
          dp[i][1] = fmaf(ov.x, v1.x, dp[i][1]);
          dp[i][1] = fmaf(ov.y, v1.y, dp[i][1]);
          dp[i][1] = fmaf(ov.z, v1.z, dp[i][1]);
          dp[i][1] = fmaf(ov.w, v1.w, dp[i][1]);
        }
      }
    }

    // ---- dS = P * (dP - Dl), rounded to T; rows of this warp only
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kj = kv0 + lane + 32 * h;
        const float p = kj < Skv ? expf(s[i][h] * scale - L[i]) : 0.f;
        dSs[(warp * 4 + i) * kDKeys + lane + 32 * h] =
            vt::round_to<T>(p * (dp[i][h] - Dl[i]));
      }
    }
    __syncwarp();

    // ---- acc += dS K, K staged kDKFull keys x D at a time
    for (int kc = 0; kc < kDKeys; kc += kDKFull) {
      __syncthreads();
      for (int e = tid; e < kDKFull * D; e += kThreads) {
        const int r = e / D;
        const int d = e - r * D;
        const int kj = kv0 + kc + r;
        Kf[e] = kj < Skv ? vt::to_f(kb[(int64_t)kj * D + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kDKFull; ++kk) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds[i] = dSs[(warp * 4 + i) * kDKeys + kc + kk];
#pragma unroll
        for (int j = 0; j < kJMax; ++j) {
          if (j < nj) {
            const float kv = Kf[kk * D + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + warp * 4 + i;
    if (row >= Sq) continue;
    T* drow = dq + ((int64_t)b * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < kJMax; ++j)
      if (j < nj) drow[lane + 32 * j] = vt::from_f<T>(acc[i][j] * scale);
  }
}

// one block per SM (its shared memory allows no second), so all 255
// registers a thread may be used: no spill of the 64 accumulators
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int Sq, int Skv, int D,
                     float scale, T* __restrict__ dk, T* __restrict__ dv) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;                 // padded row stride
  float* Qs = smem;                     // [kEQ][ld]
  float* dOs = Qs + kEQ * ld;           // [kEQ][ld]
  float* Ks = dOs + kEQ * ld;           // [kERows][ld]
  float* Vs = Ks + kERows * ld;         // [kERows][ld]
  float* Pt = Vs + kERows * ld;         // [kERows][kEQ]  P^T, rounded
  float* dSt = Pt + kERows * kEQ;       // [kERows][kEQ]  dS^T, rounded

  const int b = blockIdx.y;
  const int k0 = blockIdx.x * kERows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nj = D / 32;
  const T* qb = q + (int64_t)b * Sq * D;
  const T* ob = dout + (int64_t)b * Sq * D;
  const T* kb = k + (int64_t)b * Skv * D;
  const T* vb = v + (int64_t)b * Skv * D;
  const float* lb = lse + (int64_t)b * Sq;
  const float* db = delta + (int64_t)b * Sq;

  for (int e = tid; e < kERows * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const bool ok = k0 + r < Skv;
    const int64_t off = (int64_t)(k0 + r) * D + d;
    Ks[r * ld + d] = ok ? vt::to_f(kb[off]) : 0.f;
    Vs[r * ld + d] = ok ? vt::to_f(vb[off]) : 0.f;
  }

  float adk[2][kJMax], adv[2][kJMax];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kJMax; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kEQ) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kEQ * D; e += kThreads) {
      const int r = e / D;
      const int d = e - r * D;
      const bool ok = q0 + r < Sq;
      const int64_t off = (int64_t)(q0 + r) * D + d;
      Qs[r * ld + d] = ok ? vt::to_f(qb[off]) : 0.f;
      dOs[r * ld + d] = ok ? vt::to_f(ob[off]) : 0.f;
    }
    __syncthreads();

    // ---- S^T = K Q^T and dP^T = V dO^T: warp's 2 k rows, lane's q row
    float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[lane * ld + d]);
      const float4 ov = *reinterpret_cast<const float4*>(&dOs[lane * ld + d]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ro = (warp * 2 + i) * ld + d;
        const float4 kv = *reinterpret_cast<const float4*>(&Ks[ro]);
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[ro]);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
        dp[i] = fmaf(ov.x, vv.x, dp[i]);
        dp[i] = fmaf(ov.y, vv.y, dp[i]);
        dp[i] = fmaf(ov.z, vv.z, dp[i]);
        dp[i] = fmaf(ov.w, vv.w, dp[i]);
      }
    }
    const int qi = q0 + lane;
    const bool qok = qi < Sq;
    const float L = qok ? lb[qi] : kBigPos;
    const float Dl = qok ? db[qi] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float p = qok ? expf(s[i] * scale - L) : 0.f;
      Pt[(warp * 2 + i) * kEQ + lane] = vt::round_to<T>(p);
      dSt[(warp * 2 + i) * kEQ + lane] = vt::round_to<T>(p * (dp[i] - Dl));
    }
    __syncwarp();

    // ---- dV += P^T dO and dK += dS^T Q over this tile's q rows
#pragma unroll 4
    for (int qq = 0; qq < kEQ; ++qq) {
      float p[2], ds[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        p[i] = Pt[(warp * 2 + i) * kEQ + qq];
        ds[i] = dSt[(warp * 2 + i) * kEQ + qq];
      }
#pragma unroll
      for (int j = 0; j < kJMax; ++j) {
        if (j < nj) {
          const float ov = dOs[qq * ld + lane + 32 * j];
          const float qv = Qs[qq * ld + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            adv[i][j] = fmaf(p[i], ov, adv[i][j]);
            adk[i][j] = fmaf(ds[i], qv, adk[i][j]);
          }
        }
      }
    }
    __syncwarp();  // Pt/dSt rows are rewritten by this warp next tile
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + warp * 2 + i;
    if (row >= Skv) continue;
    T* krow = dk + ((int64_t)b * Skv + row) * D;
    T* vrow = dv + ((int64_t)b * Skv + row) * D;
#pragma unroll
    for (int j = 0; j < kJMax; ++j) {
      if (j < nj) {
        krow[lane + 32 * j] = vt::from_f<T>(adk[i][j] * scale);
        vrow[lane + 32 * j] = vt::from_f<T>(adv[i][j]);
      }
    }
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, int B, int Sq, int Skv,
              int D, float scale, void* dq, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)kDRows * D + 2 * kDKeys * kDPad +
                       (size_t)kDKFull * D + kDRows * kDKeys);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kDRows - 1) / kDRows, B);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, Sq,
      Skv, D, scale, static_cast<T*>(dq));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, int B, int Sq, int Skv,
               int D, float scale, void* dk, void* dv, cudaStream_t st) {
  const size_t ld = (size_t)D + 4;
  const size_t smem =
      sizeof(float) * (2 * kEQ * ld + 2 * kERows * ld + 2 * kERows * kEQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Skv + kERows - 1) / kERows, B);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, Sq,
      Skv, D, scale, static_cast<T*>(dk), static_cast<T*>(dv));
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Skv, int D) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 32 != 0 ||
         D > 32 * kJMax;
}

}  // namespace

// q, dout (B,Sq,D) and k, v (B,Skv,D), all contiguous in one dtype; lse and
// delta (B,Sq) fp32; dq (B,Sq,D) in that dtype.  D a multiple of 32, <= 512.
VT_EXPORT int vt_flash_attn_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   int dtype, int B, int Sq, int Skv, int D,
                                   float scale, void* dq, void* stream) {
  if (bad_shape(B, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32)
    return launch_dq<float>(q, k, v, dout, lse, delta, B, Sq, Skv, D, scale,
                            dq, st);
  if (dtype == vt::kBF16)
    return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, B, Sq, Skv, D,
                                    scale, dq, st);
  return (int)cudaErrorInvalidValue;
}

// The same inputs; dk and dv (B,Skv,D) in the inputs' dtype.
VT_EXPORT int vt_flash_attn_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    int dtype, int B, int Sq, int Skv, int D,
                                    float scale, void* dk, void* dv,
                                    void* stream) {
  if (bad_shape(B, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32)
    return launch_dkv<float>(q, k, v, dout, lse, delta, B, Sq, Skv, D, scale,
                             dk, dv, st);
  if (dtype == vt::kBF16)
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, B, Sq, Skv,
                                     D, scale, dk, dv, st);
  return (int)cudaErrorInvalidValue;
}
