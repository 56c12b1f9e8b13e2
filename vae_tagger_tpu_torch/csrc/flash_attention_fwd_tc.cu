// Kernel C': the single-head flash-attention forward on Hopper's tensor
// cores, bf16 in and out, O = softmax(Q K^T / sqrt(D)) V with the fp32
// logsumexp L = m + log(max(l, 1e-30)) that kernels D and E consume.
//
// Replaces, for bf16 tensors, the TPU kernel vae_tagger_tpu/ops/pallas/
// flash_attention.py::_flash_attention_fwd_impl (its pallas_call at :112);
// fp32 tensors keep the SIMT kernel C (flash_attention_fwd.cu).  The
// numerics are the TPU kernel's: S = Q K^T in bf16 with fp32 accumulation,
// keys at or past Skv masked to -1e30 before the exponential, the streaming
// softmax in fp32, P rounded to bf16 before P V, O accumulated in fp32.
//
// Bound on this card: operations, 4*Sq*Skv*D FLOP (2.2 ms a batch of 4 at
// S = 16,384, D = 512, against the 989 TFLOP/s bf16 peak).  What held the
// SIMT kernel C back, and what this design does about it:
//  - fp32 FMA on the CUDA cores: both products are wgmma (m64n32k16 for S
//    with both operands in shared memory, m64n256k16 for P V with P in
//    registers);
//  - Q widened to fp32 in shared memory, K and V staged through registers
//    with 20 barrier pairs a 64-key tile: Q, K and V arrive by TMA in bf16,
//    as 64-column boxes with the 128-byte swizzle that wgmma reads
//    directly; a producer warp keeps a 2-stage K ring and a 2-stage V ring
//    in flight on mbarriers, so loads overlap the math;
//  - 32 query rows a block: a block owns 64 rows, twice as many, which
//    halves the L2 traffic of K and V.
// The register budget sets the shape.  A 64 x 512 fp32 O accumulator is half
// the register file, so two consumer warpgroups split O by columns (each
// 64 x D/2, 128 registers a thread at D = 512).  Both need the same P, so S
// is computed split-K: each warpgroup multiplies its half of D, the two
// partial tiles are exchanged through shared memory and added (fp32
// addition commutes, so both hold bit-identical S), and both run the same
// softmax on it.  The accumulator layout of S converts in registers to the
// A-fragment layout of P V (the FA3 layout trick for 16-bit types).  Each
// tile's S product is issued right behind the previous tile's P V, and one
// wait covers both.  (Running the softmax of tile j+1 while P(j) V(j) is in
// flight, FA3's intra-warpgroup overlap, made the compiler serialize every
// wgmma, and was slower.)  A third, producer warpgroup (one thread of it
// issues the TMA loads) gives its registers to the consumers with
// setmaxnreg: 40 a thread for it, 232 for them.
//
// Shared memory at D = 512: Q 64 KB, K and V rings 2 x 2 x 32 KB, the S
// exchange 2 x 16 KB (double-buffered, one barrier per tile): 224 KB.
// The head width is a template parameter, built for D = 512 (the FLUX and
// SD VAEs' mid block) and D = 384 (the Wan VAE's): at 384 each warpgroup
// owns 192 columns of O (96 registers a thread), its P V product is
// m64n192k16, and shared memory is 176 KB; every other line is shared.
// Tensor maps: encoded on the host per call (tc_common.cuh, driver entry
// point, no -lcuda).  Ragged shapes: TMA fills rows past Sq or Skv with
// zeros; keys past Skv are masked, rows past Sq are not stored.
#include "tc_common.cuh"

namespace {

constexpr int kBQ = 64;          // query rows a block (one wgmma M)
constexpr int kBKV = 32;         // keys a tile
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBoxBytesQ = kBQ * 128;    // one 64-column box of Q
constexpr int kBoxBytesKV = kBKV * 128;  // one 64-column box of K or V
constexpr int kXBytes = 2 * 16 * 128 * 4;  // both warpgroups' S partials
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int kD>  // the head width: the VAE mid-block's channels
struct Layout {
  static constexpr int kBoxes = kD / 64;      // boxes a row
  static constexpr int kWgBoxes = kD / 128;   // boxes a warpgroup's half
  static constexpr int kHalf = kD / 2;        // O columns a warpgroup
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kD * 2;
  static constexpr int kStage = kBKV * kD * 2;
  static constexpr int kV = kK + 2 * kStage;
  static constexpr int kX = kV + 2 * kStage;
  static constexpr int kBar = kX + 2 * kXBytes;
  static constexpr int kBytes = kBar + 16 * 8 + 1024;  // + alignment slack
};

// O += P V over this warpgroup's D/2 columns, V read MN-major.
template <int kHalf>
__device__ __forceinline__ void wgmma_pv(float (&o)[kHalf / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kHalf == 256) tc::wgmma_rs_n256<1>(o, a, db);
  if constexpr (kHalf == 192) tc::wgmma_rs_n192<1>(o, a, db);
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, int Sq, int Skv,
                    float scale_log2, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse) {
  using L = Layout<kD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = tc::align1024(smem_raw);
  uint8_t* qs = sm + L::kQ;
  uint8_t* ks = sm + L::kK;
  uint8_t* vs = sm + L::kV;
  float* xs = reinterpret_cast<float*>(sm + L::kX);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* qfull = bars;
  uint64_t* kfull = bars + 1;   // [2]
  uint64_t* vfull = bars + 3;   // [2]
  uint64_t* kempty = bars + 5;  // [2]
  uint64_t* vempty = bars + 7;  // [2]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (Skv + kBKV - 1) / kBKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    tc::mbar_init(qfull, 1);
    for (int s = 0; s < 2; ++s) {
      tc::mbar_init(kfull + s, 1);
      tc::mbar_init(vfull + s, 1);
      tc::mbar_init(kempty + s, kConsumers / 32);
      tc::mbar_init(vempty + s, kConsumers / 32);
    }
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    tc::setmaxnreg_dec<kProducerRegs>();
    // ---- producer: one thread loads Q once, then K and V tiles through
    // their rings
    if (warp == kConsumers / 32 && lane == 0) {
      tc::mbar_expect_tx(qfull, kBQ * kD * 2);
      for (int c = 0; c < L::kBoxes; ++c)
        tc::tma_load_3d(qs + c * kBoxBytesQ, &tq, qfull, c * 64, q0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j & 1;
        const uint32_t prev = ((j >> 1) - 1) & 1;
        if (j >= 2) tc::mbar_wait(kempty + s, prev);
        tc::mbar_expect_tx(kfull + s, L::kStage);
        for (int c = 0; c < L::kBoxes; ++c)
          tc::tma_load_3d(ks + s * L::kStage + c * kBoxBytesKV, &tk, kfull + s,
                          c * 64, j * kBKV, b);
        if (j >= 2) tc::mbar_wait(vempty + s, prev);
        tc::mbar_expect_tx(vfull + s, L::kStage);
        for (int c = 0; c < L::kBoxes; ++c)
          tc::tma_load_3d(vs + s * L::kStage + c * kBoxBytesKV, &tv, vfull + s,
                          c * 64, j * kBKV, b);
      }
    }
    return;
  }
  tc::setmaxnreg_inc<kConsumerRegs>();

  // ---- consumer warpgroups: wg owns O columns [wg*D/2, (wg+1)*D/2)
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int g = lane / 4;  // row in the warp's 8-row group
  const int t4 = lane % 4;
  const int row0 = (warp % 4) * 16 + g;  // this thread's rows: row0, row0 + 8

  float o[L::kHalf / 2];
#pragma unroll
  for (int i = 0; i < L::kHalf / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  float sacc[16];      // S of one tile, then its P in fp32
  uint32_t pa[2][4];   // P in bf16: A fragments of two k16 slices of keys
  float alpha[2];      // rescale of O and l for this thread's two rows

  // Issue this warpgroup's half of S(j) = Q K^T (64 x 32, fp32); not waited.
  auto issue_s = [&](int j) {
    const int s = j & 1;
    tc::mbar_wait(kfull + s, (j >> 1) & 1);
#pragma unroll
    for (int i = 0; i < 16; ++i) sacc[i] = 0.f;
    tc::fence_regs(sacc);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < L::kHalf / 16; ++kk) {
      const int box = wg * L::kWgBoxes + kk / 4;
      const uint64_t da =
          tc::desc_sw128(qs + box * kBoxBytesQ + (kk % 4) * 32, 16, 1024);
      const uint64_t db = tc::desc_sw128(
          ks + s * L::kStage + box * kBoxBytesKV + (kk % 4) * 32, 16, 1024);
      tc::wgmma_ss_n32(sacc, da, db);
    }
    tc::wg_commit();
  };

  // Once S(j) has landed: hand K(j) back, exchange the partial tiles (both
  // warpgroups then hold all of S), and run the streaming softmax in base
  // 2 -- P(j) in sacc, the new m and l, and alpha.  Accumulator register i
  // of S holds row row0 + 8*((i/2)%2), key j*32 + (i/4)*8 + 2*t4 + i%2.
  auto softmax = [&](int j) {
    tc::fence_regs(sacc);
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(kempty + (j & 1));
    float* xb = xs + (j & 1) * (kXBytes / 4);
#pragma unroll
    for (int i = 0; i < 16; ++i) xb[(wg * 16 + i) * 128 + tid] = sacc[i];
    tc::bar_sync(1, kConsumers);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = j * kBKV + (i / 4) * 8 + 2 * t4 + (i % 2);
      const float v = sacc[i] + xb[((1 - wg) * 16 + i) * 128 + tid];
      sacc[i] = key < Skv ? v * scale_log2 : kNegInf;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        mx = fmaxf(mx, fmaxf(sacc[c * 4 + 2 * h], sacc[c * 4 + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sacc[c * 4 + 2 * h + e] - m_new);
          sacc[c * 4 + 2 * h + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[h] = exp2f(m[h] - m_new);
      l[h] = alpha[h] * l[h] + sum;
      m[h] = m_new;
    }
  };

  auto pack_p = [&]() {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      pa[t][0] = tc::pack_bf16(sacc[8 * t + 0], sacc[8 * t + 1]);
      pa[t][1] = tc::pack_bf16(sacc[8 * t + 2], sacc[8 * t + 3]);
      pa[t][2] = tc::pack_bf16(sacc[8 * t + 4], sacc[8 * t + 5]);
      pa[t][3] = tc::pack_bf16(sacc[8 * t + 6], sacc[8 * t + 7]);
    }
  };

  tc::mbar_wait(qfull, 0);
  issue_s(0);
  tc::wg_wait<0>();
  softmax(0);  // O is still 0: no rescale
  pack_p();
  for (int j = 0; j < ntiles; ++j) {
    const int s = j & 1;
    const bool more = j + 1 < ntiles;
    // S(j+1) and O += P(j) V(j) (V's rows are keys, its 64-column boxes
    // MN-major) go to the tensor cores back to back, one wait for both.
    if (more) issue_s(j + 1);
    tc::mbar_wait(vfull + s, (j >> 1) & 1);
    tc::fence_regs(o);
    tc::wg_fence();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint64_t db = tc::desc_sw128(
          vs + s * L::kStage + wg * L::kWgBoxes * kBoxBytesKV + t * 2048,
          kBoxBytesKV, 1024);
      wgmma_pv<L::kHalf>(o, pa[t], db);
    }
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::fence_regs(o);
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(vempty + s);
    if (more) {
      softmax(j + 1);
#pragma unroll
      for (int i = 0; i < L::kHalf / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      pack_p();
    }
  }

  // ---- O / l in bf16; L = m + log(max(l, 1e-30)) in natural units
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + 8 * h;
    if (row >= Sq) continue;
    __nv_bfloat16* orow =
        out + ((int64_t)b * Sq + row) * kD + wg * L::kHalf + 2 * t4;
#pragma unroll
    for (int c = 0; c < L::kHalf / 8; ++c) {
      const uint32_t v = tc::pack_bf16(o[c * 4 + 2 * h] / l[h],
                                       o[c * 4 + 2 * h + 1] / l[h]);
      *reinterpret_cast<uint32_t*>(orow + c * 8) = v;
    }
    if (wg == 0 && t4 == 0)
      lse[(int64_t)b * Sq + row] = m[h] * kLn2 + logf(fmaxf(l[h], 1e-30f));
  }
}

template <int kD>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(flash_fwd_tc_kernel<kD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<kD>::kBytes);
}

template <int kD>
int launch(const void* q, const void* k, const void* v, int B, int Sq, int Skv,
           float scale, void* out, float* lse, cudaStream_t st) {
  using L = Layout<kD>;
  CUtensorMap mq, mk, mv;
  const uint64_t dq[3] = {(uint64_t)kD, (uint64_t)Sq, (uint64_t)B};
  const uint64_t dkv[3] = {(uint64_t)kD, (uint64_t)Skv, (uint64_t)B};
  const uint64_t sq_[2] = {(uint64_t)kD * 2, (uint64_t)Sq * kD * 2};
  const uint64_t skv[2] = {(uint64_t)kD * 2, (uint64_t)Skv * kD * 2};
  const uint32_t bq[3] = {64, kBQ, 1};
  const uint32_t bkv[3] = {64, kBKV, 1};
  if (!tc::make_map(&mq, q, 3, dq, sq_, bq) ||
      !tc::make_map(&mk, k, 3, dkv, skv, bkv) ||
      !tc::make_map(&mv, v, 3, dkv, skv, bkv))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<kD>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B);
  flash_fwd_tc_kernel<kD><<<grid, kThreads, L::kBytes, st>>>(
      mq, mk, mv, Sq, Skv, scale * kLog2e, static_cast<__nv_bfloat16*>(out),
      lse);
  return (int)cudaGetLastError();
}

template <int kD>
int attrs(int* out) {
  cudaError_t err = allow_smem<kD>();
  cudaFuncAttributes a;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, flash_fwd_tc_kernel<kD>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes + a.maxDynamicSharedSizeBytes;
  return 0;
}

}  // namespace

// q (B,Sq,D), k and v (B,Skv,D), contiguous bf16, 16-byte aligned; out
// (B,Sq,D) bf16; lse (B,Sq) fp32.  D must be 512 or 384 and dtype bf16
// (fp32 goes to kernel C'').
VT_EXPORT int vt_flash_attn_fwd_tc(const void* q, const void* k, const void* v,
                                   int dtype, int B, int Sq, int Skv, int D,
                                   float scale, void* out, float* lse,
                                   void* stream) {
  if (dtype != vt::kBF16 || (D != 512 && D != 384) || B <= 0 || Sq <= 0 ||
      Skv <= 0 || !tc::aligned16(q) || !tc::aligned16(k) ||
      !tc::aligned16(v) || !tc::aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 384) return launch<384>(q, k, v, B, Sq, Skv, scale, out, lse, st);
  return launch<512>(q, k, v, B, Sq, Skv, scale, out, lse, st);
}

// The instance for head width D (512 or 384): out = {registers a thread at
// launch, shared memory bytes a block (static + the dynamic size every
// launch passes)}, from the CUDA runtime.
VT_EXPORT int vt_flash_attn_fwd_tc_attrs(int D, int* out) {
  if (D == 384) return attrs<384>(out);
  if (D == 512) return attrs<512>(out);
  return (int)cudaErrorInvalidValue;
}
