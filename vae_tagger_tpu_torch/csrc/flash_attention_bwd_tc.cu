// Kernels D' and E': the single-head flash-attention backward on Hopper's
// tensor cores, bf16 in and out, from the forward's saved O and per-row
// logsumexp L (kernel C'):
//
//   P  = exp(Q K^T * scale - L)          recomputed, never stored
//   Dl = rowsum(dO * O)                  (B, Sq) fp32, computed by the wrapper
//   dS = P * (dO V^T - Dl)
//   D': dQ = scale * dS K                one writer per q row
//   E': dV = P^T dO,  dK = scale * dS^T Q one writer per k row
//
// Replace, for bf16 tensors, the TPU kernels of vae_tagger_tpu/ops/pallas/
// flash_attention.py::_flash_attention_bwd_impl: _bwd_dq_kernel (D', its
// pallas_call at :265) and _bwd_dkv_kernel (E', :296); fp32 tensors keep
// the SIMT kernels D and E (flash_attention_bwd.cu).  The numerics are the
// TPU kernels': S = Q K^T and dP = dO V^T in bf16 with fp32 accumulation,
// keys at or past Skv masked (P = 0), rows past Sq give P = 0 (the TPU pads
// L with +BIG), P = exp2(S * scale * log2e - L * log2e) in fp32, P and dS
// rounded to bf16 before the products that use them, dQ, dK and dV
// accumulated in fp32 and stored in bf16.  No float atomics: every output
// element has one writer, and results repeat bit for bit.
//
// Bound on this card: operations.  The function takes 6 (dQ) and 8 (dK,
// dV) * B*Sq*Skv*D FLOP (2.5 and 3.3 ms at B=3, S=16,384, D=512, against
// the 989 TFLOP/s bf16 peak); E' does 10 (4.2 ms), see below.  What held
// the SIMT kernels back, and what this design does about it:
//  - fp32 FMA on the CUDA cores: every product is wgmma (m64n32k16 with
//    both operands in shared memory for S and dP, m64n256k16 with the
//    bf16 P or dS in registers for dQ, dK and dV);
//  - K and V staged through registers with two barriers per 32 columns,
//    K read twice: every operand arrives once by TMA in bf16, as 64-column
//    boxes with the 128-byte swizzle wgmma reads directly, and one tile of
//    K serves both S (K-major) and dS K (MN-major);
//  - 32 (D) and 16 (E) rows a block: a block owns 64 rows, which halves
//    D's and quarters E's L2 traffic per row.
//
// One templated body, three modes, each a block of 64 output rows with two
// consumer warpgroups that own 256 columns of the output each (a 64 x 256
// fp32 accumulator, 128 registers a thread, as in C') and a producer
// warpgroup whose one thread issues the TMA loads; setmaxnreg moves
// registers to the consumers (40 a thread for the producer, 232 for them).
// The streamed side comes in tiles of 32 rows.
//  - kDQ (D'): rows are queries.  Q and dO are resident; K and V stream.
//    Warpgroup 0 computes S = Q K^T (64 x 32, over all of D), warpgroup 1
//    dP = dO V^T at the same time; they exchange the tiles through shared
//    memory (a copy, so both hold the same S and dP), both compute the
//    same dS, convert it in registers to the A fragment (the FA3 layout
//    trick for 16-bit types) and run dQ[:, half] += dS K[:, half].
//  - kDK (E', dK pass): the mirror image with q and k swapped, in the S^T
//    form: rows are keys, K and V resident, Q and dO stream; S^T = K Q^T
//    and dP^T = V dO^T, L and Dl read per streamed q column each tile,
//    dK[:, half] += dS^T Q[:, half].  6*B*Sq*Skv*D FLOP.
//  - kDV (E', dV pass): rows are keys, K resident, Q and dO stream.  Only
//    S^T is needed, so each warpgroup computes it over its half of D
//    (split-K) and the two partials are exchanged and added (fp32 addition
//    commutes: both hold bit-identical S^T), as C' does for S; then
//    dV[:, half] += P^T dO[:, half].  4*B*Sq*Skv*D FLOP.
// E' runs the two passes one after the other: dK and dV together in one
// pass would need 2 x 64 x 512 fp32 accumulators, the whole register file.
// So E' does 10*B*Sq*Skv*D FLOP against the function's 8 (S^T twice).
//
// Shared memory at D = 512, 1024-byte aligned tiles (both 224 KB + barriers):
//   kDQ, kDK: the two resident 64-row operands 2 x 64 KB, one stage of each
//     streamed 32-row operand 2 x 32 KB, the S/dP exchange 2 x 16 KB
//     (double-buffered, one barrier per tile).  Two stages of the streamed
//     tiles do not fit beside 128 KB of resident operands, so the producer
//     loads dP's operand (V or dO) first, freed as soon as that product
//     lands, and the other (K or Q) when the output product has read it;
//     the dP product of the next tile runs while the latter loads.
//   kDV: K 64 KB, 2-stage Q and dO rings 2 x 2 x 32 KB, the exchange 32 KB.
// Tensor maps: encoded on the host per call (tc_common.cuh).  Ragged
// shapes: TMA fills rows past Sq or Skv with zeros; streamed rows past the
// end are masked, output rows past the end are not stored.
#include <initializer_list>

#include "tc_common.cuh"

namespace {

enum Mode : int { kDQ = 0, kDK = 1, kDV = 2 };

constexpr int kD = 512;          // the head width: the VAE mid-block's channels
constexpr int kBM = 64;          // output rows a block (one wgmma M)
constexpr int kBN = 32;          // streamed rows a tile
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBoxes = kD / 64;        // 64-column boxes a row
constexpr int kBoxA = kBM * 128;       // one box of a resident operand
constexpr int kBoxB = kBN * 128;       // one box of a streamed tile
constexpr int kTileA = kBM * kD * 2;   // a resident operand, 64 KB
constexpr int kTileB = kBN * kD * 2;   // a streamed tile, 32 KB
constexpr int kXFloats = 2 * 16 * 128; // both warpgroups' 64 x 32 tiles
constexpr float kBig = 1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int M>
struct Plan {
  // two resident operands, one product a warpgroup (kDQ, kDK)
  static constexpr bool kMirror = M != kDV;
  static constexpr int kStages = kMirror ? 1 : 2;
  static constexpr int kA1 = 0;
  static constexpr int kA2 = kA1 + kTileA;  // kMirror only
  static constexpr int kB1 = kMirror ? kA2 + kTileA : kA1 + kTileA;
  static constexpr int kB2 = kB1 + kStages * kTileB;
  static constexpr int kX = kB2 + kStages * kTileB;
  static constexpr int kBar = kX + 2 * kXFloats * 4;
  static constexpr int kBytes = kBar + 16 * 8 + 1024;  // + alignment slack
};

struct Args {
  int rows;            // output rows: Sq (kDQ) or Skv (kDK, kDV)
  int cols;            // streamed rows: Skv (kDQ) or Sq (kDK, kDV)
  int Sq;              // row stride of lse and delta
  const float* lse;    // (B, Sq)
  const float* delta;  // (B, Sq)
  float scale_log2;    // scale * log2(e)
  float out_scale;     // scale (dQ, dK) or 1 (dV)
  __nv_bfloat16* out;  // (B, rows, D)
};

// a1/a2: the resident operands (kDQ: Q, dO; kDK: K, V; kDV: K, -);
// b1/b2: the streamed ones (kDQ: K, V; kDK and kDV: Q, dO).  The output
// product multiplies by b1 (kDQ, kDK) or b2 (kDV).
template <int M>
__device__ __forceinline__ void bwd_body(uint8_t* sm, const CUtensorMap* ta1,
                                         const CUtensorMap* ta2,
                                         const CUtensorMap* tb1,
                                         const CUtensorMap* tb2,
                                         const Args a) {
  using P = Plan<M>;
  constexpr bool kMirror = P::kMirror;
  constexpr int kS = P::kStages;
  uint8_t* a1 = sm + P::kA1;
  uint8_t* a2 = sm + P::kA2;
  uint8_t* b1 = sm + P::kB1;
  uint8_t* b2 = sm + P::kB2;
  float* xs = reinterpret_cast<float*>(sm + P::kX);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + P::kBar);
  uint64_t* afull = bars;
  uint64_t* b1full = bars + 1;   // [kS]
  uint64_t* b2full = bars + 3;   // [kS]
  uint64_t* b1empty = bars + 5;  // [kS]
  uint64_t* b2empty = bars + 7;  // [kS]

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kBM;
  const int ntiles = (a.cols + kBN - 1) / kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    tc::mbar_init(afull, 1);
    for (int s = 0; s < kS; ++s) {
      tc::mbar_init(b1full + s, 1);
      tc::mbar_init(b2full + s, 1);
      tc::mbar_init(b1empty + s, kConsumers / 32);
      // kMirror: only warpgroup 1 reads b2 (dP's operand)
      tc::mbar_init(b2empty + s, kMirror ? 4 : kConsumers / 32);
    }
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    tc::setmaxnreg_dec<kProducerRegs>();
    // ---- producer: one thread loads the resident operands once, then the
    // streamed tiles through their rings
    if (warp == kConsumers / 32 && lane == 0) {
      tc::mbar_expect_tx(afull, (kMirror ? 2 : 1) * kTileA);
      for (int c = 0; c < kBoxes; ++c)
        tc::tma_load_3d(a1 + c * kBoxA, ta1, afull, c * 64, r0, b);
      if (kMirror)
        for (int c = 0; c < kBoxes; ++c)
          tc::tma_load_3d(a2 + c * kBoxA, ta2, afull, c * 64, r0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kS;
        const uint32_t prev = ((j / kS) - 1) & 1;
        auto load = [&](uint8_t* dst, const CUtensorMap* map, uint64_t* full,
                        uint64_t* empty) {
          if (j >= kS) tc::mbar_wait(empty + s, prev);
          tc::mbar_expect_tx(full + s, kTileB);
          for (int c = 0; c < kBoxes; ++c)
            tc::tma_load_3d(dst + s * kTileB + c * kBoxB, map, full + s,
                            c * 64, j * kBN, b);
        };
        if (kMirror) {  // b2 is freed first (see the header)
          load(b2, tb2, b2full, b2empty);
          load(b1, tb1, b1full, b1empty);
        } else {
          load(b1, tb1, b1full, b1empty);
          load(b2, tb2, b2full, b2empty);
        }
      }
    }
    return;
  }
  tc::setmaxnreg_inc<kConsumerRegs>();

  // ---- consumer warpgroups: wg owns output columns [wg*D/2, (wg+1)*D/2)
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int g = lane / 4;  // row in the warp's 8-row group
  const int t4 = lane % 4;
  const int row0 = (warp % 4) * 16 + g;  // this thread's rows: row0, row0 + 8
  const int64_t lbase = (int64_t)b * a.Sq;

  float acc[kD / 4];
#pragma unroll
  for (int i = 0; i < kD / 4; ++i) acc[i] = 0.f;
  // One 64 x 32 tile of S (or S^T), then dP, P or dS.  Accumulator register
  // i holds row row0 + 8*((i/2)%2), streamed row j*32 + (i/4)*8 + 2*t4 + i%2.
  float x[16];
  uint32_t pa[2][4];  // P or dS in bf16: A fragments of two k16 slices
  // L in log2 units and Dl: per output row (kDQ), or per streamed row,
  // read for each tile (kDK, kDV)
  float lrow[2], drow[2], lcol[8], dcol[8];
  if (M == kDQ) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + row0 + 8 * h;
      const bool ok = row < a.rows;
      lrow[h] = ok ? a.lse[lbase + row] * kLog2e : kBig;
      drow[h] = ok ? a.delta[lbase + row] : 0.f;
    }
  }
  auto load_cols = [&](int j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = j * kBN + (i / 2) * 8 + 2 * t4 + i % 2;
      const bool ok = col < a.cols;
      lcol[i] = ok ? a.lse[lbase + col] * kLog2e : kBig;
      if (M == kDK) dcol[i] = ok ? a.delta[lbase + col] : 0.f;
    }
  };
  // P of register i from its S; 0 for a streamed row past the end
  auto prob = [&](int j, int i, float s) {
    const int col = j * kBN + (i / 4) * 8 + 2 * t4 + i % 2;
    const float l = M == kDQ ? lrow[(i / 2) % 2] : lcol[(i / 4) * 2 + i % 2];
    return col < a.cols ? exp2f(fmaf(s, a.scale_log2, -l)) : 0.f;
  };
  auto pack = [&]() {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      pa[t][0] = tc::pack_bf16(x[8 * t + 0], x[8 * t + 1]);
      pa[t][1] = tc::pack_bf16(x[8 * t + 2], x[8 * t + 3]);
      pa[t][2] = tc::pack_bf16(x[8 * t + 4], x[8 * t + 5]);
      pa[t][3] = tc::pack_bf16(x[8 * t + 6], x[8 * t + 7]);
    }
  };
  // out[:, wg half] += pa (64 x 32) * tile[:, wg half]; the tile's rows are
  // the product's K, its 64-column boxes MN-major
  auto out_product = [&](const uint8_t* tile) {
    tc::fence_regs(acc);
    tc::wg_fence();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint64_t db = tc::desc_sw128(
          tile + wg * (kBoxes / 2) * kBoxB + t * 2048, kBoxB, 1024);
      tc::wgmma_rs_n256<1>(acc, pa[t], db);
    }
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::fence_regs(acc);
  };

  tc::mbar_wait(afull, 0);
  if constexpr (kMirror) {
    // warpgroup 0: S = a1 b1^T; warpgroup 1: dP = a2 b2^T (64 x 32 each)
    const uint8_t* ta = wg == 0 ? a1 : a2;
    const uint8_t* tb = wg == 0 ? b1 : b2;
    uint64_t* tfull = wg == 0 ? b1full : b2full;
    for (int j = 0; j < ntiles; ++j) {
      const uint32_t ph = j & 1;
      if (M == kDK) load_cols(j);
      tc::mbar_wait(tfull, ph);
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = 0.f;
      tc::fence_regs(x);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int box = kk / 4;
        const uint64_t da =
            tc::desc_sw128(ta + box * kBoxA + (kk % 4) * 32, 16, 1024);
        const uint64_t db =
            tc::desc_sw128(tb + box * kBoxB + (kk % 4) * 32, 16, 1024);
        tc::wgmma_ss_n32(x, da, db);
      }
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs(x);
      __syncwarp();
      if (wg == 1 && lane == 0) tc::mbar_arrive(b2empty);
      // exchange: both warpgroups then hold S and dP
      float* xb = xs + (j & 1) * kXFloats;
#pragma unroll
      for (int i = 0; i < 16; ++i) xb[(wg * 16 + i) * 128 + tid] = x[i];
      tc::bar_sync(1, kConsumers);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float other = xb[((1 - wg) * 16 + i) * 128 + tid];
        const float s = wg == 0 ? x[i] : other;
        const float dp = wg == 0 ? other : x[i];
        const float dl = M == kDQ ? drow[(i / 2) % 2] : dcol[(i / 4) * 2 + i % 2];
        x[i] = prob(j, i, s) * (dp - dl);  // dS
      }
      pack();
      tc::mbar_wait(b1full, ph);  // warpgroup 1 has not waited on it yet
      out_product(b1);
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(b1empty);
    }
  } else {
    // S^T(j) = K Q^T, this warpgroup's half of D; not waited
    auto issue_s = [&](int j) {
      const int s = j % kS;
      load_cols(j);
      tc::mbar_wait(b1full + s, (j / kS) & 1);
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = 0.f;
      tc::fence_regs(x);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk) {
        const int box = wg * (kBoxes / 2) + kk / 4;
        const uint64_t da =
            tc::desc_sw128(a1 + box * kBoxA + (kk % 4) * 32, 16, 1024);
        const uint64_t db = tc::desc_sw128(
            b1 + s * kTileB + box * kBoxB + (kk % 4) * 32, 16, 1024);
        tc::wgmma_ss_n32(x, da, db);
      }
      tc::wg_commit();
    };
    // once S^T(j) has landed: hand Q(j) back, add the other half, P^T
    auto probs = [&](int j) {
      tc::fence_regs(x);
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(b1empty + j % kS);
      float* xb = xs + (j & 1) * kXFloats;
#pragma unroll
      for (int i = 0; i < 16; ++i) xb[(wg * 16 + i) * 128 + tid] = x[i];
      tc::bar_sync(1, kConsumers);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        x[i] = prob(j, i, x[i] + xb[((1 - wg) * 16 + i) * 128 + tid]);
    };
    issue_s(0);
    tc::wg_wait<0>();
    probs(0);
    pack();
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kS;
      const bool more = j + 1 < ntiles;
      // S^T(j+1) and dV += P^T(j) dO(j) go to the tensor cores back to
      // back; out_product waits for both
      if (more) issue_s(j + 1);
      tc::mbar_wait(b2full + s, (j / kS) & 1);
      out_product(b2 + s * kTileB);
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(b2empty + s);
      if (more) {
        probs(j + 1);
        pack();
      }
    }
  }

  // ---- the output rows in bf16, times out_scale
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + row0 + 8 * h;
    if (row >= a.rows) continue;
    __nv_bfloat16* orow =
        a.out + ((int64_t)b * a.rows + row) * kD + wg * (kD / 2) + 2 * t4;
#pragma unroll
    for (int c = 0; c < kD / 16; ++c) {
      const uint32_t v = tc::pack_bf16(acc[c * 4 + 2 * h] * a.out_scale,
                                       acc[c * 4 + 2 * h + 1] * a.out_scale);
      *reinterpret_cast<uint32_t*>(orow + c * 8) = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, Args a) {
  extern __shared__ uint8_t smem_raw[];
  bwd_body<kDQ>(tc::align1024(smem_raw), &tq, &tdo, &tk, &tv, a);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dk_tc_kernel(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo, Args a) {
  extern __shared__ uint8_t smem_raw[];
  bwd_body<kDK>(tc::align1024(smem_raw), &tk, &tv, &tq, &tdo, a);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dv_tc_kernel(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo, Args a) {
  extern __shared__ uint8_t smem_raw[];
  bwd_body<kDV>(tc::align1024(smem_raw), &tk, nullptr, &tq, &tdo, a);
}

cudaError_t allow_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Plan<kDQ>::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dk_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Plan<kDK>::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dv_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Plan<kDV>::kBytes);
  return err;
}

// A (B, S, D) bf16 tensor map with boxes of 64 columns x `rows` rows.
bool map_of(CUtensorMap* m, const void* p, int B, int S, int rows) {
  const uint64_t dims[3] = {(uint64_t)kD, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)kD * 2, (uint64_t)S * kD * 2};
  const uint32_t box[3] = {64, (uint32_t)rows, 1};
  return tc::make_map(m, p, 3, dims, strides, box);
}

bool refused(int dtype, int B, int Sq, int Skv, int D,
             std::initializer_list<const void*> ptrs) {
  if (dtype != vt::kBF16 || D != kD || B <= 0 || Sq <= 0 || Skv <= 0)
    return true;
  for (const void* p : ptrs)
    if (!tc::aligned16(p)) return true;
  return false;
}

int attrs_of(const void* fn, int* out) {
  cudaFuncAttributes at;
  cudaError_t err = allow_smem();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&at, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes + at.maxDynamicSharedSizeBytes;
  return 0;
}

}  // namespace

// q, dout (B,Sq,D) and k, v (B,Skv,D), contiguous bf16, 16-byte aligned;
// lse and delta (B,Sq) fp32; dq (B,Sq,D) bf16.  D must be 512 and dtype
// bf16 (fp32 goes to kernel D).
VT_EXPORT int vt_flash_attn_bwd_dq_tc(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      int dtype, int B, int Sq, int Skv, int D,
                                      float scale, void* dq, void* stream) {
  if (refused(dtype, B, Sq, Skv, D, {q, k, v, dout, dq}))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mdo, mk, mv;
  if (!map_of(&mq, q, B, Sq, kBM) || !map_of(&mdo, dout, B, Sq, kBM) ||
      !map_of(&mk, k, B, Skv, kBN) || !map_of(&mv, v, B, Skv, kBN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const Args a{Sq, Skv, Sq, lse, delta, scale * kLog2e, scale,
               static_cast<__nv_bfloat16*>(dq)};
  dim3 grid((Sq + kBM - 1) / kBM, B);
  flash_bwd_dq_tc_kernel<<<grid, kThreads, Plan<kDQ>::kBytes,
                           static_cast<cudaStream_t>(stream)>>>(mq, mdo, mk,
                                                                mv, a);
  return (int)cudaGetLastError();
}

// The same inputs; dk and dv (B,Skv,D) bf16.  Two launches: the dV pass,
// then the dK pass.
VT_EXPORT int vt_flash_attn_bwd_dkv_tc(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       int dtype, int B, int Sq, int Skv,
                                       int D, float scale, void* dk, void* dv,
                                       void* stream) {
  if (refused(dtype, B, Sq, Skv, D, {q, k, v, dout, dk, dv}))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mk, mv, mq, mdo;
  if (!map_of(&mk, k, B, Skv, kBM) || !map_of(&mv, v, B, Skv, kBM) ||
      !map_of(&mq, q, B, Sq, kBN) || !map_of(&mdo, dout, B, Sq, kBN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((Skv + kBM - 1) / kBM, B);
  const Args adv{Skv, Sq, Sq, lse, delta, scale * kLog2e, 1.f,
                 static_cast<__nv_bfloat16*>(dv)};
  flash_bwd_dv_tc_kernel<<<grid, kThreads, Plan<kDV>::kBytes, st>>>(mk, mq,
                                                                    mdo, adv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Args adk{Skv, Sq, Sq, lse, delta, scale * kLog2e, scale,
                 static_cast<__nv_bfloat16*>(dk)};
  flash_bwd_dk_tc_kernel<<<grid, kThreads, Plan<kDK>::kBytes, st>>>(
      mk, mv, mq, mdo, adk);
  return (int)cudaGetLastError();
}

// out = {registers a thread at launch, shared memory bytes a block (static
// + the dynamic size every launch passes)} of D', from the CUDA runtime.
VT_EXPORT int vt_flash_attn_bwd_dq_tc_attrs(int* out) {
  return attrs_of(reinterpret_cast<const void*>(flash_bwd_dq_tc_kernel), out);
}

// out = the same pair for E''s dV pass, then for its dK pass.
VT_EXPORT int vt_flash_attn_bwd_dkv_tc_attrs(int* out) {
  const int err =
      attrs_of(reinterpret_cast<const void*>(flash_bwd_dv_tc_kernel), out);
  return err != 0 ? err
                  : attrs_of(reinterpret_cast<const void*>(
                                 flash_bwd_dk_tc_kernel),
                             out + 2);
}
