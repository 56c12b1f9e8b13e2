// Kernel C'': the single-head flash-attention forward on Hopper's tensor
// cores for fp32 tensors, O = softmax(Q K^T / sqrt(D)) V with the fp32
// logsumexp L = m + log(max(l, 1e-30)), every product in 3xTF32.
//
// Replaces, for fp32 tensors, the TPU kernel vae_tagger_tpu/ops/pallas/
// flash_attention.py::_flash_attention_fwd_impl (its pallas_call at :112);
// bf16 tensors go to kernel C' (flash_attention_fwd_tc.cu).  It computes
// what the SIMT kernel C (flash_attention_fwd.cu) computes: keys at or past
// Skv masked to -1e30, the streaming softmax in fp32, P not rounded before
// P V, O accumulated in fp32, L in natural units.
//
// 3xTF32: each fp32 operand x is split into hi = tf32(x) and lo = tf32(x -
// hi) (round to nearest, cvt.rna), and a product is accumulated in fp32 as
// lo*hi + hi*lo + hi*hi, the small terms first; the dropped lo*lo term and
// the rounding of lo are below 2^-21 of the product, so the result keeps
// fp32-level error where single-pass TF32 (about 2^-11) would not.
//
// Bound on this card: operations, 3 * 4*Sq*Skv*D FLOP on the TF32 tensor
// cores (13.3 ms a batch of 4 at S = 16,384, D = 512, against 495 TFLOP/s),
// against 32.8 ms for the SIMT kernel's fp32 FMA.  What held kernel C back,
// and what this design does about it:
//  - fp32 FMA on the CUDA cores: both products are wgmma tf32 (m64n32k8 for
//    S with Q from registers, m64n64k8 for P V with both operands in
//    shared memory), three a k8 step;
//  - shared-memory bandwidth (6 float4 loads a thread for 32 FMAs) and ~40
//    barriers a 64-key tile: operands arrive by TMA with the 128-byte
//    swizzle that wgmma reads directly, through mbarrier rings kept one
//    item ahead of the products, and S's A operand comes from registers;
//  - 32 query rows a block: 64 here, half the L2 traffic of K and V.
// Shared-memory operand layout: tf32 wgmma reads shared-memory operands
// K-major only (transposition is for 16-bit types), so
//  - S = Q K^T: K (keys x D, D contiguous) is K-major as it stands; the
//    wrapper splits it into hi and lo tensors (split_tf32, a preparation
//    pass of each call);
//  - O += P V: the B operand must be V^T with keys contiguous; the wrapper
//    writes V^T hi and lo, (B, D, Skv rounded up to 8), with the keys of
//    each group of 8 in the order 0 2 4 6 1 3 5 7: the order in which a
//    thread's accumulators of S hold them (keys 2t and 2t+1 of each group
//    sit beside the thread's k indices t and t+4), so that P goes to
//    shared memory, the A operand, with no shuffle; the same permutation
//    of the K dimension on both operands leaves the product unchanged;
//  - Q is the A operand of S from registers: resident raw in shared memory
//    (128 KB), read per tile with ldmatrix (an 8 x 4 fp32 block is an 8 x 8
//    b16 matrix, and four of them are the tf32 A fragment of a k8 step) and
//    split in registers at use.  hi/lo copies of Q, K and V would not fit
//    in 227 KB beside the rings.
// Registers: a 64 x 512 fp32 O is half the register file, so two
// warpgroups split O by columns (64 x 256 each, 128 registers a thread) and
// S split-K: each warpgroup multiplies its half of D, the partial tiles are
// exchanged through shared memory and added (fp32 addition commutes, so
// both hold bit-identical S).  The tensor cores round each accumulation
// toward zero; with O itself as the wgmma accumulator, over the 3 x 2,048
// steps of a 16,384-key row, that bias reached 1.3e-4 of O, so each 64 x
// 64 block of a tile's P V goes to a fresh accumulator (12 steps) that is
// added to O in fp32 on the CUDA cores.  Beside O: that accumulator (32
// registers), S's (16) and two alternating sets of Q
// fragments (one k8 step, hi and lo: 8 each), so one k8 step's S products
// stay in flight while the next step's fragments load.  P goes to shared
// memory rather than registers.  As C' is built (a producer warpgroup and
// setmaxnreg, 168 registers a thread at launch) an earlier form with P in
// registers spilled up to 744 bytes, part of O; so the block is the two
// warpgroups alone, up to 255 registers a thread, and each warpgroup
// keeps its own ring full: when it is done with a stage, one of its
// threads issues the TMA loads of the item two ahead.  Stage, Q and P
// addresses are made opaque in the loop (tc::opaque): hoisted out of it,
// the 100-odd descriptors and ldmatrix addresses derived from them stayed
// live and spilled.
//
// Shared memory: Q 128 KB; per warpgroup a 2-stage ring of 16 KB
// stages (a K chunk, 32 keys x 64 D, or a V^T chunk, 64 D x 32 keys; hi
// then lo), 64 KB; the S exchange 2 x 16 KB, each buffer then holding the
// tile's P (hi and lo, 8 KB each): 224 KB.  Tensor maps: encoded
// on the host per call (tc_common.cuh).  Ragged shapes: TMA fills rows past
// Sq or Skv with zeros; keys past Skv are masked, rows past Sq not stored.
// The head width is a template parameter, built for D = 512 (the FLUX and
// SD VAEs' mid block) and D = 384 (the Wan VAE's): at 384 a warpgroup owns
// three 64-column chunks of O (96 registers a thread) and Q takes 96 KB of
// shared memory; every other line is shared.
#include "tc_common.cuh"

namespace {

constexpr int kBQ = 64;          // query rows a block (one wgmma M)
constexpr int kBKV = 32;         // keys a tile
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kConsumers;
constexpr int kStages = 2;           // ring stages a warpgroup
constexpr int kCopy = 8192;          // one copy (hi or lo) of a chunk
constexpr int kStage = 2 * kCopy;    // hi, then lo
constexpr int kQBox = kBQ * 128;     // one 32-column box of Q
constexpr int kKBox = kBKV * 128;    // one 32-column box of a K chunk
constexpr int kXBytes = 2 * 16 * 128 * 4;  // both warpgroups' S partials
constexpr int kPCopy = kBQ * 128;  // P's hi or lo, in the same buffer
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// kD: the head width, the VAE mid-block's channels
template <int kD>
struct Layout {
  static constexpr int kHalf = kD / 2;  // D columns a warpgroup: S's K, O's N
  static constexpr int kChunks = kHalf / 64;  // K (and V^T) chunks a tile
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + kBQ * kD * 4;
  static constexpr int kX = kRing + 2 * kStages * kStage;
  static constexpr int kBar = kX + 2 * kXBytes;
  static constexpr int kBytes = kBar + 16 * 8 + 1024;  // + alignment slack
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tkh,
                        const __grid_constant__ CUtensorMap tkl,
                        const __grid_constant__ CUtensorMap tvh,
                        const __grid_constant__ CUtensorMap tvl, int Sq,
                        int Skv, float scale_log2, float* __restrict__ out,
                        float* __restrict__ lse) {
  using L = Layout<kD>;
  constexpr int kHalf = L::kHalf;
  constexpr int kChunks = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = tc::align1024(smem_raw);
  uint8_t* qs = sm + L::kQ;
  float* xs = reinterpret_cast<float*>(sm + L::kX);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* qfull = bars;
  uint64_t* full = bars + 1;  // [2][kStages]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (Skv + kBKV - 1) / kBKV;
  const int nitems = ntiles * 2 * kChunks;  // ring items a warpgroup
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    tc::mbar_init(qfull, 1);
    for (int s = 0; s < 2 * kStages; ++s) tc::mbar_init(full + s, 1);
    tc::fence_barrier_init();
  }
  __syncthreads();

  // ---- warpgroup wg owns S's K half and O's columns [wg*D/2, (wg+1)*D/2)
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int g = lane / 4;  // row in the warp's 8-row group
  const int t4 = lane % 4;
  const int row0 = (warp % 4) * 16 + g;  // this thread's rows: row0, row0 + 8
  // ldmatrix: lane gives the row address of matrix lane/8 -- row lm_row of
  // the warp's 16, 16-byte chunk lm_half of the k8 step
  const int lm_row = (warp % 4) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lm_half = lane >> 4;
  const uint32_t q_a = tc::smem_u32(qs) + lm_row * 128;
  uint8_t* ring = sm + L::kRing + wg * kStages * kStage;
  const uint32_t ring_a = tc::smem_u32(ring);
  uint64_t* rfull = full + wg * kStages;

  // Item i of this warpgroup's ring, into stage i % kStages: per tile its K
  // chunks (D columns wg*D/2 + 64c, 32 keys), then its V^T chunks (D rows
  // wg*D/2 + 64c, 32 keys), hi then lo.  Issued by one thread.
  auto issue = [&](int i) {
    const int j = i / (2 * kChunks);
    const int c = i % (2 * kChunks);
    const int s = i % kStages;
    uint8_t* dst = ring + s * kStage;
    tc::mbar_expect_tx(rfull + s, kStage);
    if (c < kChunks) {
      const int col = wg * kHalf + c * 64;
      for (int h = 0; h < 2; ++h) {
        tc::tma_load_3d(dst + h * kKBox, &tkh, rfull + s, col + 32 * h,
                        j * kBKV, b);
        tc::tma_load_3d(dst + kCopy + h * kKBox, &tkl, rfull + s,
                        col + 32 * h, j * kBKV, b);
      }
    } else {
      const int row = wg * kHalf + (c - kChunks) * 64;
      tc::tma_load_3d(dst, &tvh, rfull + s, j * kBKV, row, b);
      tc::tma_load_3d(dst + kCopy, &tvl, rfull + s, j * kBKV, row, b);
    }
  };
  if (tid == 0) {
    if (wg == 0) {
      tc::mbar_expect_tx(qfull, kBQ * kD * 4);
      for (int c = 0; c < kD / 32; ++c)
        tc::tma_load_3d(qs + c * kQBox, &tq, qfull, c * 32, q0, b);
    }
    for (int i = 0; i < kStages && i < nitems; ++i) issue(i);
  }

  float o[kChunks][32];  // O columns wg*D/2 + 64n + ..., as m64n64 tiles
#pragma unroll
  for (int n = 0; n < kChunks; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float sacc[16];         // S of one tile, then its P in fp32
  int item = 0;           // items of this warpgroup's ring taken so far

  auto wait_full = [&](int i) {
    tc::mbar_wait(rfull + i % kStages, (i / kStages) & 1);
  };
  // The warpgroup is done with item i (its products have completed): one
  // thread refills the stage with item i + kStages (an opaque index, so
  // that the loads are not specialised per call site and their addresses
  // hoisted out of the tile loop into registers).
  auto release = [&](int i) {
    tc::bar_sync(2 + wg, 128);
    if (tid == 0 && i + kStages < nitems)
      issue((int)tc::opaque((uint32_t)(i + kStages)));
  };

  tc::mbar_wait(qfull, 0);
  for (int j = 0; j < ntiles; ++j) {
    // ---- this warpgroup's half of S(j) = Q K^T, 64 x 32: one commit group
    // a k8 step (8 columns of Q); two fragment sets alternate
#pragma unroll
    for (int i = 0; i < 16; ++i) sacc[i] = 0.f;
    uint32_t qf[2][2][4];  // [set][hi, lo][fragment]
#pragma unroll
    for (int kc = 0; kc < kChunks; ++kc) {
      wait_full(item + kc);
      // this chunk's stage and Q boxes, recomputed here (tc::opaque) rather
      // than hoisted out of the tile loop as 100-odd live registers
      const uint32_t st =
          tc::opaque(ring_a + ((item + kc) % kStages) * kStage);
      const uint32_t qc =
          tc::opaque(q_a + (wg * (kHalf / 32) + kc * 2) * kQBox);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {  // k8 steps of this 64-column chunk
        const int gi = kc * 8 + ks;
        const int h = ks / 4;   // the 32-column box
        const int kk = ks % 4;  // k8 step in the box
        uint32_t raw[4];
        tc::ldmatrix_x4(raw, qc + h * kQBox +
                                 (((kk * 2 + lm_half) ^ (lm_row & 7)) << 4));
        tc::split_tf32(raw, qf[gi & 1][0], qf[gi & 1][1]);
        tc::fence_regs(sacc);
        tc::wg_fence();
        const int off = h * kKBox + kk * 32;
        const uint64_t dh = tc::desc_sw128_at(st + off, 16, 1024);
        const uint64_t dl = tc::desc_sw128_at(st + kCopy + off, 16, 1024);
        tc::wgmma_tf32_rs_n32(sacc, qf[gi & 1][1], dh);  // lo * hi
        tc::wgmma_tf32_rs_n32(sacc, qf[gi & 1][0], dl);  // hi * lo
        tc::wgmma_tf32_rs_n32(sacc, qf[gi & 1][0], dh);  // hi * hi
        tc::wg_commit();
        if (gi > 0) {
          tc::wg_wait<1>();  // the group before this one is done
          if (ks == 0) release(item + kc - 1);
        }
      }
    }
    tc::wg_wait<0>();
    tc::fence_regs(sacc);
    release(item + kChunks - 1);
    item += kChunks;

    // ---- exchange the partial tiles (both warpgroups then hold all of S)
    // and run the streaming softmax in base 2.  Accumulator register i of S
    // holds row row0 + 8*((i/2)%2), key j*32 + (i/4)*8 + 2*t4 + i%2.
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
    float alpha[2];
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
    // P to shared memory, the A operand of P V: its tf32 hi (written by
    // warpgroup 0) and lo (warpgroup 1; both hold the same P) replace the
    // exchanged partials, once both warpgroups have read them.  Each copy
    // is 64 rows of 32 keys, 128-byte swizzled; a group of 8 keys is stored
    // in V^T's key order, position t4 key 2*t4, position t4 + 4 key
    // 2*t4 + 1 (the keys accumulator registers 4c + 2h and 4c + 2h + 1
    // hold).
    tc::bar_sync(1, kConsumers);
    {
      uint8_t* pc = reinterpret_cast<uint8_t*>(xb) + wg * kPCopy;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // position 8c + 4e + t4
            const float p = sacc[4 * c + 2 * h + e];
            const float hi = __uint_as_float(tc::to_tf32(p));
            const float v = wg == 0 ? hi
                                    : __uint_as_float(tc::to_tf32(p - hi));
            *reinterpret_cast<float*>(
                pc + r * 128 + (((2 * c + e) ^ (r & 7)) << 4) + t4 * 4) = v;
          }
        }
      }
    }
    tc::fence_proxy_async();  // the generic writes, before wgmma reads them
    tc::bar_sync(1, kConsumers);
    const uint32_t pa = tc::opaque(tc::smem_u32(xb));

    // ---- O[:, 64n..] = alpha O + P V^T-chunk n: the tile's product in a
    // fresh accumulator, added to O in fp32 on the CUDA cores.  The tensor
    // cores round each accumulation toward zero; over the 3 x 2,048 steps
    // of a 16,384-key row that bias reached 1.3e-4 of O when O was the
    // wgmma accumulator itself (12 steps a tile here).
#pragma unroll
    for (int n = 0; n < kChunks; ++n) {
      wait_full(item + n);
      const uint32_t st = tc::opaque(ring_a + ((item + n) % kStages) * kStage);
      float t[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) t[i] = 0.f;
      tc::fence_regs(t);
      tc::wg_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint64_t ah = tc::desc_sw128_at(pa + c * 32, 16, 1024);
        const uint64_t al = tc::desc_sw128_at(pa + kPCopy + c * 32, 16, 1024);
        const uint64_t dh = tc::desc_sw128_at(st + c * 32, 16, 1024);
        const uint64_t dl = tc::desc_sw128_at(st + kCopy + c * 32, 16, 1024);
        tc::wgmma_tf32_ss_n64(t, al, dh);  // lo * hi
        tc::wgmma_tf32_ss_n64(t, ah, dl);  // hi * lo
        tc::wgmma_tf32_ss_n64(t, ah, dh);  // hi * hi
      }
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs(t);
      release(item + n);
      // the streaming softmax's rescale, here rather than as a pass over O
      // of its own
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[n][i] = fmaf(o[n][i], alpha[(i / 2) % 2], t[i]);
      tc::fence_regs(o[n]);  // before the next product: one t live
    }
    item += kChunks;
  }

  // ---- O / l; L = m + log(max(l, 1e-30)) in natural units
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + 8 * h;
    if (row >= Sq) continue;
    float* orow = out + ((int64_t)b * Sq + row) * kD + wg * kHalf + 2 * t4;
#pragma unroll
    for (int n = 0; n < kChunks; ++n) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        *reinterpret_cast<float2*>(orow + n * 64 + c * 8) =
            make_float2(o[n][c * 4 + 2 * h] / l[h],
                        o[n][c * 4 + 2 * h + 1] / l[h]);
      }
    }
    if (wg == 0 && t4 == 0)
      lse[(int64_t)b * Sq + row] = m[h] * kLn2 + logf(fmaxf(l[h], 1e-30f));
  }
}

template <int kD>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<kD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<kD>::kBytes);
}

template <int kD>
int launch(const void* q, const void* k_hi, const void* k_lo,
           const void* vt_hi, const void* vt_lo, int B, int Sq, int Skv,
           int Skv_pad, float scale, void* out, float* lse, cudaStream_t st) {
  CUtensorMap mq, mkh, mkl, mvh, mvl;
  const uint64_t dq[3] = {(uint64_t)kD, (uint64_t)Sq, (uint64_t)B};
  const uint64_t dk[3] = {(uint64_t)kD, (uint64_t)Skv, (uint64_t)B};
  const uint64_t dv[3] = {(uint64_t)Skv_pad, (uint64_t)kD, (uint64_t)B};
  const uint64_t sq_[2] = {(uint64_t)kD * 4, (uint64_t)Sq * kD * 4};
  const uint64_t sk[2] = {(uint64_t)kD * 4, (uint64_t)Skv * kD * 4};
  const uint64_t sv[2] = {(uint64_t)Skv_pad * 4, (uint64_t)kD * Skv_pad * 4};
  const uint32_t bq[3] = {32, kBQ, 1};
  const uint32_t bk[3] = {32, kBKV, 1};
  const uint32_t bv[3] = {kBKV, 64, 1};
  if (!tc::make_map(&mq, q, 3, dq, sq_, bq, true) ||
      !tc::make_map(&mkh, k_hi, 3, dk, sk, bk, true) ||
      !tc::make_map(&mkl, k_lo, 3, dk, sk, bk, true) ||
      !tc::make_map(&mvh, vt_hi, 3, dv, sv, bv, true) ||
      !tc::make_map(&mvl, vt_lo, 3, dv, sv, bv, true))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<kD>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B);
  flash_fwd_tf32x3_kernel<kD><<<grid, kThreads, Layout<kD>::kBytes, st>>>(
      mq, mkh, mkl, mvh, mvl, Sq, Skv, scale * kLog2e,
      static_cast<float*>(out), lse);
  return (int)cudaGetLastError();
}

template <int kD>
int attrs(int* out) {
  cudaError_t err = allow_smem<kD>();
  cudaFuncAttributes a;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, flash_fwd_tf32x3_kernel<kD>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes + a.maxDynamicSharedSizeBytes;
  return 0;
}

}  // namespace

// q (B,Sq,D) fp32; k_hi and k_lo (B,Skv,D) fp32, K split by split_tf32;
// vt_hi and vt_lo (B,D,Skv_pad) fp32, V^T split the same way, Skv_pad =
// Skv rounded up to a multiple of 8, the keys of each group of 8 in the
// order 0 2 4 6 1 3 5 7 and zero past Skv; out (B,Sq,D) fp32; lse (B,Sq)
// fp32.  D must be 512 or 384; every operand 16-byte aligned.
VT_EXPORT int vt_flash_attn_fwd_tf32x3(const void* q, const void* k_hi,
                                       const void* k_lo, const void* vt_hi,
                                       const void* vt_lo, int B, int Sq,
                                       int Skv, int Skv_pad, int D,
                                       float scale, void* out, float* lse,
                                       void* stream) {
  if ((D != 512 && D != 384) || B <= 0 || Sq <= 0 || Skv <= 0 ||
      Skv_pad < Skv || Skv_pad % 8 != 0 || !tc::aligned16(q) ||
      !tc::aligned16(k_hi) || !tc::aligned16(k_lo) || !tc::aligned16(vt_hi) ||
      !tc::aligned16(vt_lo) || !tc::aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 384)
    return launch<384>(q, k_hi, k_lo, vt_hi, vt_lo, B, Sq, Skv, Skv_pad,
                       scale, out, lse, st);
  return launch<512>(q, k_hi, k_lo, vt_hi, vt_lo, B, Sq, Skv, Skv_pad, scale,
                     out, lse, st);
}

// The instance for head width D (512 or 384): out = {registers a thread at
// launch, shared memory bytes a block (static + the dynamic size every
// launch passes)}, from the CUDA runtime.
VT_EXPORT int vt_flash_attn_fwd_tf32x3_attrs(int D, int* out) {
  if (D == 384) return attrs<384>(out);
  if (D == 512) return attrs<512>(out);
  return (int)cudaErrorInvalidValue;
}
