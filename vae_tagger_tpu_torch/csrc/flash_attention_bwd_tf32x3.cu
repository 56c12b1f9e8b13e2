// Kernels D'' and E'': the single-head flash-attention backward on Hopper's
// tensor cores for fp32 tensors, every product in 3xTF32, from the
// forward's saved O and per-row logsumexp L (kernel C''):
//
//   P  = exp(Q K^T * scale - L)          recomputed, never stored
//   Dl = rowsum(dO * O)                  (B, Sq) fp32, computed by the wrapper
//   dS = P * (dO V^T - Dl)
//   D'': dQ = scale * dS K               one writer per q row
//   E'': dV = P^T dO,  dK = scale * dS^T Q one writer per k row
//
// Replace, for fp32 tensors, the TPU kernels of vae_tagger_tpu/ops/pallas/
// flash_attention.py::_flash_attention_bwd_impl: _bwd_dq_kernel (D'', its
// pallas_call at :265) and _bwd_dkv_kernel (E'', :296); bf16 tensors go to
// D' and E' (flash_attention_bwd_tc.cu).  They compute what the SIMT kernels
// D and E (flash_attention_bwd.cu) compute in fp32: keys at or past Skv
// masked (P = 0), rows past Sq give P = 0 (the TPU pads L with +BIG),
// P = exp(S * scale - L), dQ, dK and dV accumulated and stored in fp32.  No float atomics: every output element has one writer,
// and results repeat bit for bit.
//
// 3xTF32 (as in B'' and C''): each fp32 operand x is split into hi =
// tf32(x) and lo = tf32(x - hi), and a product is accumulated as lo*hi +
// hi*lo + hi*hi, the small terms first.
//
// Bound on this card: operations, 6 (dQ) and 8 (dK, dV) * B*Sq*Skv*D FLOP
// done three times on the TF32 tensor cores (15.0 and 20.0 ms at B=3,
// S=16,384, D=512, against 495 TFLOP/s; E'' does 10, 25.0 ms, see below),
// against 36.9 and 49.2 ms for the SIMT kernels' fp32 FMA.  What held D and
// E back, and what this design does about it:
//  - fp32 FMA on the CUDA cores: every product is wgmma tf32;
//  - K and V staged through registers, two barriers per 32 columns: every
//    operand arrives by TMA with the 128-byte swizzle wgmma reads directly.
//
// Shared-memory operand layout: tf32 wgmma reads shared-memory operands
// K-major only (transposition is for 16-bit types), so each product's B
// operand is laid out by the wrapper with the summed index contiguous and
// split into hi and lo (ops/attention.py, a preparation pass of each call):
//  - D'' (rows are queries): S = Q K^T and dP = dO V^T take K and V as they
//    stand; dQ += dS K takes K^T (B, D, Skv rounded up to 8);
//  - E'' (rows are keys, the S^T form of D'): S^T = K Q^T and dP^T = V dO^T
//    take Q and dO as they stand; dK += dS^T Q takes Q^T and dV += P^T dO
//    takes dO^T (B, D, Sq rounded up to 8).
// In each transposed operand the summed index is permuted within groups of
// 8 as 0 2 4 6 1 3 5 7, the order in which a thread's S accumulators hold
// it, so that dS (or P) goes to shared memory, the A operand, with no
// shuffle (as C''s P).  The A operands of S and dP are the block's rows: Q
// and dO (D''), K and V (E''), read raw with ldmatrix (an 8 x 4 fp32 block
// is an 8 x 8 b16 matrix, four of them the tf32 A fragment of a k8 step)
// and split in registers at use, as C'' reads Q.
//
// One templated body, three modes, each a block of 64 output rows and two
// warpgroups that own 256 output columns each (a 64 x 256 fp32
// accumulator, 128 registers a thread, as in C''), with no producer
// warpgroup: as C'' found, a producer's setmaxnreg split spills the
// accumulator, so each warpgroup keeps its own ring of TMA loads full (one
// thread issues the item two ahead when the warpgroup is done with a stage)
// and runs at up to 255 registers.  The streamed side comes in tiles of 32.
//  - kDQ (D''): the block's 64 query rows of Q stay resident, raw (128 KB).
//    Each warpgroup computes S and dP over its half of D (split-K); the
//    partial tiles are exchanged through shared memory and added (fp32
//    addition commutes: both hold bit-identical S and dP), both compute the
//    same dS, warpgroup 0 stores its tf32 hi and warpgroup 1 its lo, and
//    each runs dQ[:, half] += dS K^T-chunk.  dO does not fit beside Q (256
//    KB in fp32): it streams, 32 columns at a time with the V chunk of the
//    same columns, from L2 (the block's 64 rows are re-read every tile).
//  - kDK (E'', dK pass): the mirror image with the S^T form: K resident, V
//    streamed beside dO, Q and dO as S^T's and dP^T's B operands, L and Dl
//    read per streamed q column each tile, dK[:, half] += dS^T Q^T-chunk.
//    6*B*Sq*Skv*D FLOP.
//  - kDV (E'', dV pass): K resident; S^T = K Q^T split-K and exchanged, P^T
//    stored as hi and lo, dV[:, half] += P^T dO^T-chunk: C''s structure
//    without the softmax.  4*B*Sq*Skv*D FLOP.
// E'' runs the two passes one after the other: dK and dV together would
// need 2 x 64 x 512 fp32 accumulators, the whole register file.  So E''
// does 10*B*Sq*Skv*D FLOP against the function's 8 (S^T twice).
// The tensor cores round each accumulation toward zero, a bias that grows
// with the steps an accumulator takes.  So each 64 x 64 block of a tile's
// output product goes to a fresh accumulator (12 wgmma steps) that is
// added to the output in fp32 on the CUDA cores, and so does each group
// of 4 k8 steps of S and dP (12 wgmma steps): with one accumulator over a
// warpgroup's 256 columns (96 steps), the bias in S and dP dominated the
// error of dQ, dK and dV; with groups of 4 they are 1.2e-6 from an fp64
// evaluation at B=3, S=16,384, where the SIMT kernels and the plain fp32
// versions are 5.9e-6 to 6.2e-6 from it (chip_smoke.py on an H100 80GB
// HBM3).  P is exp(S scale - L) in natural units, as the plain versions
// compute it.
//
// Ring items a warpgroup, in order, for each tile j of 32 streamed rows
// (16 KB stages, two a warpgroup): the 4 S chunks (32 rows x 64 columns of
// the B1 operand, hi then lo); kDQ and kDK: the 8 dP items (the A2 operand's
// 64 block rows x 32 columns raw, then the B2 operand's 32 rows x 32
// columns hi and lo); the 4 output chunks (64 columns x 32 streamed rows of
// the transposed operand, hi then lo).  Loop-invariant stage and operand
// addresses are made opaque in the loop (tc::opaque), as in C''.
//
// Shared memory: the resident operand 128 KB; the rings 2 x 2 x 16 KB; the
// exchange 32 KB: both warpgroups' S partials (stored as soon as S is
// done, which frees its registers for dP), dP's, then dS's (or P's) hi and
// lo in place of dP's: 224 KB + barriers.  Tensor maps:
// encoded on the host per call (tc_common.cuh).  Ragged shapes: TMA fills
// rows past Sq or Skv (and past the padded transposes) with zeros;
// streamed rows past the end are masked, output rows past the end are not
// stored.
#include <initializer_list>

#include "tc_common.cuh"

namespace {

enum Mode : int { kDQ = 0, kDK = 1, kDV = 2 };

constexpr int kBM = 64;            // output rows a block (one wgmma M)
constexpr int kBN = 32;            // streamed rows a tile
constexpr int kD = 512;            // the head width: the VAE mid-block's
constexpr int kHalf = kD / 2;      // D columns a warpgroup: S's K, out's N
constexpr int kChunks = kHalf / 64;  // 64-column chunks of a half
constexpr int kThreads = 256;      // two warpgroups
constexpr int kStages = 2;         // ring stages a warpgroup
constexpr int kStage = 16384;      // one ring item
constexpr int kCopy = 8192;        // hi or lo of an S or output chunk
constexpr int kABox = kBM * 128;   // one 32-column box of 64 block rows
constexpr int kBBox = kBN * 128;   // one 32-column box of 32 streamed rows
constexpr int kXFloats = 2 * 16 * 128;  // both warpgroups' 64 x 32 partials
constexpr int kPCopy = kBM * 128;  // dS's (or P's) hi or lo
// k8 steps (three wgmma each) a fresh accumulator of S or dP takes (see
// the header)
constexpr int kGroup = 4;
static_assert(4 % kGroup == 0, "a group may not span two ring items");
constexpr float kBig = 1e30f;

struct Layout {
  static constexpr int kA1 = 0;
  static constexpr int kRing = kA1 + kBM * kD * 4;
  static constexpr int kX = kRing + 2 * kStages * kStage;
  static constexpr int kBar = kX + 2 * kXFloats * 4;
  static constexpr int kBytes = kBar + 16 * 8 + 1024;  // + alignment slack
};

struct Args {
  int rows;            // output rows: Sq (kDQ) or Skv (kDK, kDV)
  int cols;            // streamed rows: Skv (kDQ) or Sq (kDK, kDV)
  int Sq;              // row stride of lse and delta
  const float* lse;    // (B, Sq)
  const float* delta;  // (B, Sq)
  float scale;         // 1 / sqrt(D)
  float out_scale;     // scale (dQ, dK) or 1 (dV)
  float* out;          // (B, rows, D)
};

// The operands, by role (kDQ / kDK / kDV):
//  a1: resident raw rows, S's A (Q / K / K);
//  b1: S's B, hi and lo (K / Q / Q);
//  a2: streamed raw rows, dP's A (dO / V / -);
//  b2: dP's B, hi and lo (V / dO / -);
//  b3: the output product's B, transposed, hi and lo (K^T / Q^T / dO^T).
struct Maps {
  CUtensorMap a1, b1h, b1l, a2, b2h, b2l, b3h, b3l;
};

template <int M>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tf32x3_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr bool kHasDP = M != kDV;
  constexpr int kSItems = kChunks;          // S chunks a tile
  constexpr int kDPItems = kHasDP ? 8 : 0;  // dP items (32 columns each)
  constexpr int kPer = kSItems + kDPItems + kChunks;  // items a tile
  using L = Layout;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = tc::align1024(smem_raw);
  uint8_t* a1s = sm + L::kA1;
  float* xs = reinterpret_cast<float*>(sm + L::kX);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* afull = bars;
  uint64_t* full = bars + 1;  // [2][kStages]

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kBM;
  const int ntiles = (a.cols + kBN - 1) / kBN;
  const int nitems = ntiles * kPer;  // ring items a warpgroup
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    tc::mbar_init(afull, 1);
    for (int s = 0; s < 2 * kStages; ++s) tc::mbar_init(full + s, 1);
    tc::fence_barrier_init();
  }
  __syncthreads();

  // ---- warpgroup wg owns the K half of S and dP and the output columns
  // [wg*D/2, (wg+1)*D/2)
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int g = lane / 4;  // row in the warp's 8-row group
  const int t4 = lane % 4;
  const int row0 = (warp % 4) * 16 + g;  // this thread's rows: row0, row0 + 8
  // ldmatrix: lane gives the row address of matrix lane/8 -- row lm_row of
  // the warp's 16, 16-byte chunk lm_half of the k8 step
  const int lm_row = (warp % 4) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lm_half = lane >> 4;
  const uint32_t a1_a = tc::smem_u32(a1s) + lm_row * 128;
  uint8_t* ring = sm + L::kRing + wg * kStages * kStage;
  const uint32_t ring_a = tc::smem_u32(ring);
  uint64_t* rfull = full + wg * kStages;
  const int64_t lbase = (int64_t)b * a.Sq;

  // Item i of this warpgroup's ring, into stage i % kStages (see the
  // header).  Issued by one thread.
  auto issue = [&](int i) {
    const int j = i / kPer;
    const int c = i % kPer;
    const int s = i % kStages;
    uint8_t* dst = ring + s * kStage;
    tc::mbar_expect_tx(rfull + s, kStage);
    if (c < kSItems) {
      const int col = wg * kHalf + c * 64;
      for (int h = 0; h < 2; ++h) {
        tc::tma_load_3d(dst + h * kBBox, &maps.b1h, rfull + s, col + 32 * h,
                        j * kBN, b);
        tc::tma_load_3d(dst + kCopy + h * kBBox, &maps.b1l, rfull + s,
                        col + 32 * h, j * kBN, b);
      }
    } else if (c < kSItems + kDPItems) {
      const int col = wg * kHalf + (c - kSItems) * 32;
      tc::tma_load_3d(dst, &maps.a2, rfull + s, col, r0, b);
      tc::tma_load_3d(dst + kABox, &maps.b2h, rfull + s, col, j * kBN, b);
      tc::tma_load_3d(dst + kABox + kBBox, &maps.b2l, rfull + s, col,
                      j * kBN, b);
    } else {
      const int row = wg * kHalf + (c - kSItems - kDPItems) * 64;
      tc::tma_load_3d(dst, &maps.b3h, rfull + s, j * kBN, row, b);
      tc::tma_load_3d(dst + kCopy, &maps.b3l, rfull + s, j * kBN, row, b);
    }
  };
  if (tid == 0) {
    if (wg == 0) {
      tc::mbar_expect_tx(afull, kBM * kD * 4);
      for (int c = 0; c < kD / 32; ++c)
        tc::tma_load_3d(a1s + c * kABox, &maps.a1, afull, c * 32, r0, b);
    }
    for (int i = 0; i < kStages && i < nitems; ++i) issue(i);
  }

  float o[kChunks][32];  // output columns wg*D/2 + 64n + ..., m64n64 tiles
#pragma unroll
  for (int n = 0; n < kChunks; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  // S (or S^T) of one tile, then P or dS, and dP (or dP^T): fp32 sums of
  // groups of kGroup k8 steps, each group's products in a fresh wgmma
  // accumulator (tacc).  Register i holds row row0 + 8*((i/2)%2), streamed
  // row j*32 + (i/4)*8 + 2*t4 + i%2.
  float sacc[16];
  float dacc[16];
  float tacc[16];
  // L and Dl: per output row (kDQ), or per streamed row read for each tile
  // (kDK, kDV)
  float lrow[2] = {0.f, 0.f}, drow[2] = {0.f, 0.f};
  if (M == kDQ) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + row0 + 8 * h;
      const bool ok = row < a.rows;
      lrow[h] = ok ? a.lse[lbase + row] : kBig;
      drow[h] = ok ? a.delta[lbase + row] : 0.f;
    }
  }
  int item = 0;  // items of this warpgroup's ring taken so far
  // the exchange: S's partials (region B) and dP's (region A), then dS's
  // (or P's) hi and lo in region A
  float* xa = xs;
  float* xb = xs + kXFloats;

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
  // k8 step gi of an S or dP item (8 or 4 steps): A's raw fragment
  // by ldmatrix from a 64-row box at `abox` (k8 step kk of its 32 columns),
  // split in registers into fragment set gi & 1; B's hi and lo at `bh` and
  // `bl` (32 rows, k8 step kk); the products into tacc, overwritten by the
  // first step of a group (scale-d 0).  One commit group.  The fragment
  // sets alternate: the products of one step read their A registers until
  // they complete, while the next step's fragments load into the other set.
  uint32_t fr[2][2][4];  // [set][hi, lo][fragment]
  auto rs_step = [&](int gi, uint32_t abox, int kk, uint32_t bh,
                     uint32_t bl) {
    const int set = gi & 1;
    uint32_t raw[4];
    tc::ldmatrix_x4(raw, abox + (((kk * 2 + lm_half) ^ (lm_row & 7)) << 4));
    tc::split_tf32(raw, fr[set][0], fr[set][1]);
    tc::fence_regs(tacc);
    tc::wg_fence();
    const uint64_t dh = tc::desc_sw128_at(bh + kk * 32, 16, 1024);
    const uint64_t dl = tc::desc_sw128_at(bl + kk * 32, 16, 1024);
    tc::wgmma_tf32_rs_n32(tacc, fr[set][1], dh, gi % kGroup != 0);  // lo*hi
    tc::wgmma_tf32_rs_n32(tacc, fr[set][0], dl);                    // hi*lo
    tc::wgmma_tf32_rs_n32(tacc, fr[set][0], dh);                    // hi*hi
    tc::wg_commit();
  };
  // After step gi of an item: at the end of a group, wait for its products
  // and add them to `sum` (S's or dP's; `first`: the sum's first group),
  // in fp32 on the CUDA cores.  (A second accumulator, to add one group while the next
  // runs, made ptxas spill; the other warpgroup's products fill the tensor
  // cores meanwhile.)
  auto end_group = [&](int gi, float(&sum)[16], bool first) {
    if (gi % kGroup != kGroup - 1) return;
    tc::wg_wait<0>();
    tc::fence_regs(tacc);
#pragma unroll
    for (int i = 0; i < 16; ++i) sum[i] = first ? tacc[i] : sum[i] + tacc[i];
  };
  // S's sum is complete: to region B (its registers are then free for dP).
  // Region B's last reader was the previous tile's exchange, which both
  // warpgroups finished before their last output product.
  auto store_s = [&]() {
#pragma unroll
    for (int i = 0; i < 16; ++i) xb[(wg * 16 + i) * 128 + tid] = sacc[i];
  };

  tc::mbar_wait(afull, 0);
  for (int j = 0; j < ntiles; ++j) {
    // ---- this warpgroup's halves of S(j) (and dP(j)), 64 x 32 each: one
    // commit group a k8 step, the next step's fragments loaded while the
    // last one's products run; a group's accumulator is added at its end,
    // and a stage released once its products are done.  (The fresh
    // accumulators: see the header.)  The item loops are unrolled by two
    // only: unrolled fully, the copies of the ring's load code (one per
    // release) and their hoisted addresses made ptxas spill part of the
    // output; not unrolled, they ran slower.
#pragma unroll 2
    for (int it = 0; it < kSItems; ++it) {
      wait_full(item + it);
      const uint32_t st =
          tc::opaque(ring_a + ((item + it) % kStages) * kStage);
      const uint32_t ac = tc::opaque(a1_a + (wg * 8 + it * 2) * kABox);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {  // k8 steps of this 64-column chunk
        const int h = ks / 4;           // the 32-column box
        rs_step(ks, ac + h * kABox, ks % 4, st + h * kBBox,
                st + kCopy + h * kBBox);
        end_group(ks, sacc, it == 0 && ks < kGroup);
      }
      release(item + it);  // its last step ended a group: all done
    }
    store_s();
    item += kSItems;
#pragma unroll 2
    for (int it = 0; it < kDPItems; ++it) {
      wait_full(item + it);
      const uint32_t st =
          tc::opaque(ring_a + ((item + it) % kStages) * kStage);
      const uint32_t ac = st + lm_row * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // k8 steps of this 32-column item
        rs_step(kk, ac, kk, st + kABox, st + kABox + kBBox);
        end_group(kk, dacc, it == 0 && kk < kGroup);
      }
      release(item + it);
    }
    item += kDPItems;

    // ---- exchange the partial tiles: both warpgroups then hold S and dP
    if constexpr (kHasDP) {
      // both are done reading the last tile's dS, which dP's partials
      // overwrite
      tc::bar_sync(1, kThreads);
#pragma unroll
      for (int i = 0; i < 16; ++i) xa[(wg * 16 + i) * 128 + tid] = dacc[i];
    } else {
    }
    tc::bar_sync(1, kThreads);
    float lcol[8], dcol[8];  // per streamed row (kDK, kDV)
    if (M != kDQ) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = j * kBN + (i / 2) * 8 + 2 * t4 + i % 2;
        const bool ok = col < a.cols;
        lcol[i] = ok ? a.lse[lbase + col] : kBig;
        dcol[i] = (M == kDK && ok) ? a.delta[lbase + col] : 0.f;
      }
    }
    // the sums of the two partials, in the same order in both warpgroups
    // (fp32 addition commutes: both hold bit-identical S, dP and dS)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = j * kBN + (i / 4) * 8 + 2 * t4 + (i % 2);
      const float s = xb[i * 128 + tid] + xb[(16 + i) * 128 + tid];
      const float l = M == kDQ ? lrow[(i / 2) % 2] : lcol[(i / 4) * 2 + i % 2];
      // P = exp(S scale - L) in natural units, as the plain versions and
      // the SIMT kernels take it (exp2 with log2(e) folded into the scale
      // rounds its argument elsewhere: 1.5e-6 of dQ, dK and dV apart)
      const float p = col < a.cols ? expf(s * a.scale - l) : 0.f;
      if constexpr (kHasDP) {
        const float dp = xa[i * 128 + tid] + xa[(16 + i) * 128 + tid];
        const float dl =
            M == kDQ ? drow[(i / 2) % 2] : dcol[(i / 4) * 2 + i % 2];
        sacc[i] = p * (dp - dl);  // dS
      } else {
        sacc[i] = p;
      }
    }
    // dS (or P) to region A, the A operand of the output product: its tf32
    // hi (written by warpgroup 0) and lo (warpgroup 1; both hold the same
    // values), once both warpgroups have read the partials.  Each copy is
    // 64 rows of 32 streamed rows, 128-byte swizzled; a group of 8 is
    // stored in the transposed operand's order, position t4 streamed row
    // 2*t4, position t4 + 4 streamed row 2*t4 + 1 (the rows accumulator
    // registers 4c + 2h and 4c + 2h + 1 hold).
    tc::bar_sync(1, kThreads);
    {
      uint8_t* pc = reinterpret_cast<uint8_t*>(xa) + wg * kPCopy;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // position 8c + 4e + t4
            const float v = sacc[4 * c + 2 * h + e];
            const float hi = __uint_as_float(tc::to_tf32(v));
            const float w = wg == 0 ? hi : __uint_as_float(tc::to_tf32(v - hi));
            *reinterpret_cast<float*>(
                pc + r * 128 + (((2 * c + e) ^ (r & 7)) << 4) + t4 * 4) = w;
          }
        }
      }
    }
    tc::fence_proxy_async();  // the generic writes, before wgmma reads them
    tc::bar_sync(1, kThreads);
    const uint32_t pa = tc::opaque(tc::smem_u32(xa));

    // ---- out[:, 64n..] += dS (or P) times chunk n of the transposed
    // operand: the tile's product in a fresh accumulator, added in fp32 on
    // the CUDA cores (see the header)
#pragma unroll
    for (int n = 0; n < kChunks; ++n) {
      wait_full(item + n);
      const uint32_t st = tc::opaque(ring_a + ((item + n) % kStages) * kStage);
      float t[32];
      tc::fence_regs(t);
      tc::wg_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // k8 steps of the tile's 32 rows
        const uint64_t ah = tc::desc_sw128_at(pa + c * 32, 16, 1024);
        const uint64_t al = tc::desc_sw128_at(pa + kPCopy + c * 32, 16, 1024);
        const uint64_t dh = tc::desc_sw128_at(st + c * 32, 16, 1024);
        const uint64_t dl = tc::desc_sw128_at(st + kCopy + c * 32, 16, 1024);
        tc::wgmma_tf32_ss_n64(t, al, dh, c != 0);  // lo * hi
        tc::wgmma_tf32_ss_n64(t, ah, dl);          // hi * lo
        tc::wgmma_tf32_ss_n64(t, ah, dh);          // hi * hi
      }
      tc::wg_commit();
      tc::wg_wait<0>();
      tc::fence_regs(t);
      release(item + n);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] += t[i];
      tc::fence_regs(o[n]);  // before the next product: one t live
    }
    item += kChunks;
  }

  // ---- the output rows in fp32, times out_scale
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + row0 + 8 * h;
    if (row >= a.rows) continue;
    float* orow =
        a.out + ((int64_t)b * a.rows + row) * kD + wg * kHalf + 2 * t4;
#pragma unroll
    for (int n = 0; n < kChunks; ++n) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        *reinterpret_cast<float2*>(orow + n * 64 + c * 8) =
            make_float2(o[n][c * 4 + 2 * h] * a.out_scale,
                        o[n][c * 4 + 2 * h + 1] * a.out_scale);
      }
    }
  }
}

cudaError_t allow_smem() {
  cudaError_t err = cudaSuccess;
  for (const void* fn : {(const void*)flash_bwd_tf32x3_kernel<kDQ>,
                         (const void*)flash_bwd_tf32x3_kernel<kDK>,
                         (const void*)flash_bwd_tf32x3_kernel<kDV>}) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Layout::kBytes);
  }
  return err;
}

// A (B, S, D) fp32 tensor map with boxes of 32 columns x `rows` rows.
bool rows_map(CUtensorMap* m, const void* p, int B, int S, int rows) {
  const uint64_t dims[3] = {(uint64_t)kD, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)kD * 4, (uint64_t)S * kD * 4};
  const uint32_t box[3] = {32, (uint32_t)rows, 1};
  return tc::make_map(m, p, 3, dims, strides, box, true);
}

// A transposed (B, D, S_pad) fp32 tensor map with boxes of 32 columns (the
// streamed rows) x 64 rows (D).
bool cols_map(CUtensorMap* m, const void* p, int B, int S_pad) {
  const uint64_t dims[3] = {(uint64_t)S_pad, (uint64_t)kD, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)S_pad * 4, (uint64_t)kD * S_pad * 4};
  const uint32_t box[3] = {kBN, 64, 1};
  return tc::make_map(m, p, 3, dims, strides, box, true);
}

bool refused(int B, int Sq, int Skv, int S_pad, int S_t, int D,
             std::initializer_list<const void*> ptrs) {
  if (D != kD || B <= 0 || Sq <= 0 || Skv <= 0 || S_pad < S_t ||
      S_pad % 8 != 0)
    return true;
  for (const void* p : ptrs)
    if (!tc::aligned16(p)) return true;
  return false;
}

template <int M>
cudaError_t launch(const Maps& maps, const Args& a, int B, cudaStream_t st) {
  dim3 grid((a.rows + kBM - 1) / kBM, B);
  flash_bwd_tf32x3_kernel<M><<<grid, kThreads, Layout::kBytes, st>>>(maps, a);
  return cudaGetLastError();
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

// q and dout (B,Sq,D) fp32 raw; k_hi, k_lo, v_hi, v_lo (B,Skv,D) fp32, K
// and V split by split_tf32; kt_hi and kt_lo (B,D,Skv_pad) fp32, K^T split
// the same way, Skv_pad = Skv rounded up to a multiple of 8, the keys of
// each group of 8 in the order 0 2 4 6 1 3 5 7 and zero past Skv; lse and
// delta (B,Sq) fp32; dq (B,Sq,D) fp32.  D must be 512; every operand
// 16-byte aligned.
VT_EXPORT int vt_flash_attn_bwd_dq_tf32x3(
    const void* q, const void* dout, const void* k_hi, const void* k_lo,
    const void* v_hi, const void* v_lo, const void* kt_hi, const void* kt_lo,
    const float* lse, const float* delta, int B, int Sq, int Skv,
    int Skv_pad, int D, float scale, void* dq, void* stream) {
  if (refused(B, Sq, Skv, Skv_pad, Skv, D,
              {q, dout, k_hi, k_lo, v_hi, v_lo, kt_hi, kt_lo, dq}))
    return (int)cudaErrorInvalidValue;
  Maps m;
  if (!rows_map(&m.a1, q, B, Sq, kBM) || !rows_map(&m.a2, dout, B, Sq, kBM) ||
      !rows_map(&m.b1h, k_hi, B, Skv, kBN) ||
      !rows_map(&m.b1l, k_lo, B, Skv, kBN) ||
      !rows_map(&m.b2h, v_hi, B, Skv, kBN) ||
      !rows_map(&m.b2l, v_lo, B, Skv, kBN) ||
      !cols_map(&m.b3h, kt_hi, B, Skv_pad) ||
      !cols_map(&m.b3l, kt_lo, B, Skv_pad))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const Args a{Sq, Skv, Sq, lse, delta, scale, scale,
               static_cast<float*>(dq)};
  return (int)launch<kDQ>(m, a, B, static_cast<cudaStream_t>(stream));
}

// k and v (B,Skv,D) fp32 raw; q_hi, q_lo, do_hi, do_lo (B,Sq,D) fp32, Q
// and dO split; qt_hi, qt_lo, dot_hi, dot_lo (B,D,Sq_pad) fp32, Q^T and
// dO^T laid out as K^T above (Sq_pad = Sq rounded up to 8); lse and delta
// (B,Sq) fp32; dk and dv (B,Skv,D) fp32.  Two launches: the dV pass, then
// the dK pass.
VT_EXPORT int vt_flash_attn_bwd_dkv_tf32x3(
    const void* k, const void* v, const void* q_hi, const void* q_lo,
    const void* do_hi, const void* do_lo, const void* qt_hi,
    const void* qt_lo, const void* dot_hi, const void* dot_lo,
    const float* lse, const float* delta, int B, int Sq, int Skv, int Sq_pad,
    int D, float scale, void* dk, void* dv, void* stream) {
  if (refused(B, Sq, Skv, Sq_pad, Sq, D,
              {k, v, q_hi, q_lo, do_hi, do_lo, qt_hi, qt_lo, dot_hi, dot_lo,
               dk, dv}))
    return (int)cudaErrorInvalidValue;
  Maps m;
  if (!rows_map(&m.a1, k, B, Skv, kBM) || !rows_map(&m.a2, v, B, Skv, kBM) ||
      !rows_map(&m.b1h, q_hi, B, Sq, kBN) ||
      !rows_map(&m.b1l, q_lo, B, Sq, kBN) ||
      !rows_map(&m.b2h, do_hi, B, Sq, kBN) ||
      !rows_map(&m.b2l, do_lo, B, Sq, kBN) ||
      !cols_map(&m.b3h, dot_hi, B, Sq_pad) ||
      !cols_map(&m.b3l, dot_lo, B, Sq_pad))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args adv{Skv, Sq, Sq, lse, delta, scale, 1.f,
                 static_cast<float*>(dv)};
  err = launch<kDV>(m, adv, B, st);  // b3 = dO^T
  if (err != cudaSuccess) return (int)err;
  if (!cols_map(&m.b3h, qt_hi, B, Sq_pad) ||
      !cols_map(&m.b3l, qt_lo, B, Sq_pad))
    return (int)cudaErrorInvalidValue;
  const Args adk{Skv, Sq, Sq, lse, delta, scale, scale,
                 static_cast<float*>(dk)};
  return (int)launch<kDK>(m, adk, B, st);  // b3 = Q^T
}

// out = {registers a thread at launch, shared memory bytes a block (static
// + the dynamic size every launch passes)} of D'', from the CUDA runtime.
VT_EXPORT int vt_flash_attn_bwd_dq_tf32x3_attrs(int* out) {
  return attrs_of(reinterpret_cast<const void*>(flash_bwd_tf32x3_kernel<kDQ>),
                  out);
}

// out = the same pair for E'''s dV pass, then for its dK pass.
VT_EXPORT int vt_flash_attn_bwd_dkv_tf32x3_attrs(int* out) {
  const int err = attrs_of(
      reinterpret_cast<const void*>(flash_bwd_tf32x3_kernel<kDV>), out);
  return err != 0 ? err
                  : attrs_of(reinterpret_cast<const void*>(
                                 flash_bwd_tf32x3_kernel<kDK>),
                             out + 2);
}
