// Kernel B': the fused GroupNorm-affine + SiLU + conv3x3 (SAME) + bias
// [+ residual | + 1x1 shortcut of the residual] on Hopper's tensor cores,
// bf16 in and out, as an implicit GEMM on wgmma.
//
// Replaces, for bf16 tensors, the TPU kernel vae_tagger_tpu/ops/pallas/
// conv_fused.py::gn_silu_conv3x3_pallas (its pallas_call at :260); fp32
// tensors keep the SIMT kernel B (gn_silu_conv3x3.cu).  It computes what
// kernel B computes: the activation silu(x*eff_scale + eff_bias) from kernel
// A's stats pass, rounded to bf16; SAME padding of the *activated* tensor
// (taps outside the image are 0 after activation, silu(eff_bias) is not);
// fp32 accumulation; then bias, then the residual or the shortcut product
// (accumulated in the same registers), and one rounding at the end.
//
// Bound on this card: operations, 2*M*9*Cin*Cout FLOP (16.2 TFLOP, 16.4 ms,
// for the 20 convs of a 1024px batch of 4 against the 989 TFLOP/s bf16
// peak).  The products are wgmma m64nBNk16 (BN = 128 or 256 output
// channels), 64 input channels (one 128-byte swizzled row) a chunk.  The raw
// input arrives by TMA as a halo tile of (rows+2) x (64+2) pixels x 64
// channels, out-of-bounds pixels zero-filled by the copy engine, and is
// activated once, in place (affine + SiLU in fp32, pixels outside the image
// set to 0, rounded to bf16; the exponential and the reciprocal on the SFU):
// the TPU kernel's decomposition (conv_fused.py:22-33), and all 9 taps read
// that one tile.  Tap shifts need no canonical layout: the A operand comes
// from registers (wgmma's RS form), filled by ldmatrix, which takes one row
// address per pixel, so a shift by (dy, dx) is only an address.  The tile's
// 128-byte pixel rows carry TMA's 128-byte swizzle, so the 8 pixels of an
// ldmatrix phase hit 8 distinct bank groups.  The weights, packed K-major by
// the wrapper, (9, Cout, Cin) (and the shortcut (Cout, Cres)), stream
// through a TMA ring of 64 x BN tiles, one (chunk, tap) at a time.  The 1x1
// shortcut is extra K steps over the raw residual tile (no activation,
// centre pixel only).
//
// Warp roles (384 threads):
//  - warps 0-7, the consumers: two warpgroups, each owning output rows of
//    64 pixels and BN channels, one row at BN = 256 (128 accumulators a
//    thread, M = 128 pixels a block) and two at BN = 128 (M = 256, the same
//    registers): the layers with 128 output channels are the largest
//    images, and twice the rows halve the weight traffic, the halo overhead
//    and the fixed cost of a block there.  They issue the products, a
//    (tap, row) group at a time from three A-fragment sets; at BN = 128 a
//    chunk's last group stays in flight while the next chunk's first is
//    issued.
//  - warp 8: lane 0 issues the weight stream, a stage as soon as the
//    consumers free it.
//  - warps 9-11, the activators: each later conv chunk's halo tile is
//    activated by them while the consumers' products of the chunk before
//    run; chunk 0, which nothing can overlap, by them and the consumers.
//    Lane 0 of warp 9 issues the halo stream.
// Barriers: per halo buffer hfull (TMA landed), hact (the 96 activators
// are done with it) and hempty (the 8 consumer warps are); per weight stage
// wfull and wempty; named barrier 1 hands chunk 0 over, 2 the RMS mode's r.
// setmaxnreg: 216 registers a consumer thread, 64 an activator.  Three
// halo buffers; 4 weight stages at BN = 128, 3 at BN = 256.  Takes any N, H,
// W and channel counts that are multiples of 8 (TMA's 16-byte strides).
// Tensor maps: encoded on the host per call (tc_common.cuh, through the
// driver entry point, no -lcuda).
//
// The prologue's normalisation is a compile-time mode, kNorm.  kGN, the
// GroupNorm above: a per-(sample, channel) scale and shift.  kRms, the
// per-pixel RMS norm of the Wan VAE (diffusers WanRMS_norm): the activation
// silu(x * (r[n, y, x] * gamma[c])), where rms_norm.cu's stats pass wrote
// r = sqrt(C) / max(||x[n, :, y, x]||, 1e-12) over the input's channels;
// vt_rms_silu_conv3x3_tc passes gamma (Cin) and r (N, H, W) in the places
// of eff_scale and eff_bias, and a block stages r of its halo tile in
// shared memory once.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; the encoder's 20 fused convs at
// 1024px, batch 8): FLUX 62-66 ms and Wan 53-55 ms a batch against the
// prologue-in-the-consumers design's 76-78 and 64-67 (-13 to -18%), 49-53%
// of the bound.  A copy with the activation loop removed (output wrong,
// timed only) ran 52-55 and 44-46 ms, 60-63%: the ceiling of taking the
// activation off the products' path.  What bounds B' now (clock64
// timelines of single blocks) is what a block cannot overlap: chunk 0's TMA
// and activation and the epilogue, 15-24 of a 35-46 kcycle BN = 128 tile;
// there the three activator warps (14.3 kcycles a chunk, about 0.5 values a
// cycle each) also trail the products (9.9).
#include "tc_common.cuh"

namespace {

constexpr int kTW = 64;        // output pixels along W a tile (wgmma M)
constexpr int kHW = kTW + 2;   // halo tile width
constexpr int kCC = 64;        // channels a chunk: one 128-byte row
constexpr int kConsumers = 256;             // warps 0-7: two wgmma warpgroups
constexpr int kTmaWarp = kConsumers / 32;   // warp 8: the weight stream
constexpr int kActivators = 96;             // warps 9-11: the prologue
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kAllHands = kConsumers + kActivators;  // chunk 0's activators
// registers a thread after setmaxnreg: 128 * 64 + 256 * 216 <= 384 * 168,
// what the block holds at launch
constexpr int kProducerRegs = 64;
constexpr int kConsumerRegs = 216;
constexpr int kFrags = 3;  // A-fragment sets (a conv chunk's groups: 9 kRows)

enum Mode : int { kPlain = 0, kResidual = 1, kShortcut = 2 };
enum Norm : int { kGN = 0, kRms = 1 };

template <int BN>
struct Layout {
  static constexpr int kRows = BN == 128 ? 2 : 1;  // output rows a warpgroup
  static constexpr int kTH = 2 * kRows;            // output rows a tile
  static constexpr int kHH = kTH + 2;              // halo tile height
  static constexpr int kPix = kHH * kHW;           // halo tile pixels
  static constexpr int kHaloBytes = kPix * kCC * 2;
  static constexpr int kHaloStride = (kHaloBytes + 1023) / 1024 * 1024;
  static constexpr int kResBytes = kTH * kTW * kCC * 2;  // shortcut's tile
  static constexpr int kWStage = BN * kCC * 2;
  // Halo tiles in the ring: the consumers read one, the activators work on
  // the next, TMA fills the third; at BN = 256 the third costs a weight
  // stage (227 KB).
  static constexpr int kHStages = 3;
  static constexpr int kWStages = BN == 128 ? 4 : 3;
  static constexpr int kHalo = 0;
  static constexpr int kW = kHStages * kHaloStride;
  static constexpr int kBar = kW + kWStages * kWStage;
  static constexpr int kBars = 3 * kHStages + 2 * kWStages;
  static constexpr int kR = kBar + kBars * 8;  // RMS: r of the tile's pixels
};

// Shared memory a block, + alignment slack.
template <int BN, int kNorm>
constexpr int smem_bytes() {
  using L = Layout<BN>;
  return L::kR + (kNorm == kRms ? L::kPix * 4 : 0) + 1024;
}

template <int BN>
__device__ __forceinline__ void wgmma_conv(float (&acc)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (BN == 256) tc::wgmma_rs_n256<0>(acc, a, db);
  if constexpr (BN == 128) tc::wgmma_rs_n128<0>(acc, a, db);
}

// y * sigmoid(y) with the SFU's exponential and reciprocal (the activation
// is rounded to bf16 next, far coarser than their error); -0 where exp(-y)
// overflows.
__device__ __forceinline__ float silu_fast(float y) {
  return __fdividef(y, 1.0f + __expf(-y));
}

// Byte offset of channel chunk `chunk` (8 channels) of tile pixel p.
__device__ __forceinline__ uint32_t pix_off(int p, int chunk) {
  return (uint32_t)p * 128 + (uint32_t)((chunk ^ (p & 7)) << 4);
}

// Activate the halo tile of channel chunk c in place (shared address tile),
// as thread i of kCount: the affine (or the RMS scale) and the SiLU in fp32,
// one bf16 rounding, 0 for pixels outside the image and channels past Cin.
// Thread i owns 8 channels (16 bytes) of pixels i/8, i/8 + kCount/8, ...,
// so it reads their scale and shift (RMS: gamma) once; r_s holds the RMS
// mode's r of each tile pixel.  Each pixel's load is issued a step ahead,
// and the arithmetic runs on every pixel with the result selected.
template <int BN, int kNorm, int kCount>
__device__ __forceinline__ void activate(uint32_t tile, const float* r_s,
                                         int i, int c, int n, int y0, int x0,
                                         int H, int W, int Cin,
                                         const float* __restrict__ eff_scale,
                                         const float* __restrict__ eff_bias) {
  constexpr int kPix = Layout<BN>::kPix;
  constexpr int kStep = kCount / 8;
  const int grp = i & 7;
  const int ci0 = c * kCC + grp * 8;
  const bool live = ci0 < Cin;
  // GN: scale and shift of (n, ci0..+7); RMS: gamma of ci0..+7
  float sc[8], bi[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sc[e] = bi[e] = 0.f;
  if (live) {
    const float* es =
        kNorm == kRms ? eff_scale + ci0 : eff_scale + (int64_t)n * Cin + ci0;
    const float4 s0 = *reinterpret_cast<const float4*>(es);
    const float4 s1 = *reinterpret_cast<const float4*>(es + 4);
    sc[0] = s0.x, sc[1] = s0.y, sc[2] = s0.z, sc[3] = s0.w;
    sc[4] = s1.x, sc[5] = s1.y, sc[6] = s1.z, sc[7] = s1.w;
    if constexpr (kNorm == kGN) {
      const float* eb = eff_bias + (int64_t)n * Cin + ci0;
      const float4 b0 = *reinterpret_cast<const float4*>(eb);
      const float4 b1 = *reinterpret_cast<const float4*>(eb + 4);
      bi[0] = b0.x, bi[1] = b0.y, bi[2] = b0.z, bi[3] = b0.w;
      bi[4] = b1.x, bi[5] = b1.y, bi[6] = b1.z, bi[7] = b1.w;
    }
  }
  int p = i >> 3;  // < kStep <= kPix
  uint4 raw = tc::lds128(tile + pix_off(p, grp));
  for (; p < kPix; p += kStep) {
    uint4 next = raw;
    if (p + kStep < kPix) next = tc::lds128(tile + pix_off(p + kStep, grp));
    const int r = p / kHW;
    const int y = y0 - 1 + r;
    const int x = x0 - 1 + (p - r * kHW);
    const bool in = live && y >= 0 && y < H && x >= 0 && x < W;
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 v;
    uint32_t* o = reinterpret_cast<uint32_t*>(&v);
    // RMS: r of the pixel times gamma of each channel; no shift
    const float rr = kNorm == kRms ? r_s[p] : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(xv[e]);
      if constexpr (kNorm == kRms) {
        const float s0 = rr * sc[2 * e];
        const float s1 = rr * sc[2 * e + 1];
        o[e] = tc::pack_bf16(silu_fast(f.x * s0), silu_fast(f.y * s1));
      } else {
        o[e] = tc::pack_bf16(silu_fast(f.x * sc[2 * e] + bi[2 * e]),
                             silu_fast(f.y * sc[2 * e + 1] + bi[2 * e + 1]));
      }
      o[e] = in ? o[e] : 0u;
    }
    tc::sts128(tile + pix_off(p, grp), v);
    raw = next;
  }
}

// The RMS mode's r of every pixel of the halo tile at (n, y0 - 1, x0 - 1),
// 0 outside the image, into r_s, as thread i of kCount.
template <int BN>
__device__ __forceinline__ void stage_r(float* r_s, const float* r, int i,
                                        int kCount, int n, int y0, int x0,
                                        int H, int W) {
  for (int p = i; p < Layout<BN>::kPix; p += kCount) {
    const int row = p / kHW;
    const int y = y0 - 1 + row;
    const int x = x0 - 1 + (p - row * kHW);
    r_s[p] = (y >= 0 && y < H && x >= 0 && x < W)
                 ? r[((int64_t)n * H + y) * W + x]
                 : 0.f;
  }
}

template <int BN, int kMode, int kNorm>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_tc_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tr,
                  const __grid_constant__ CUtensorMap tws, int H, int W,
                  int Cin, int Cout, int Cres,
                  const float* __restrict__ eff_scale,
                  const float* __restrict__ eff_bias,
                  const float* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ res,
                  const float* __restrict__ sc_bias,
                  __nv_bfloat16* __restrict__ out) {
  using L = Layout<BN>;
  constexpr int kRows = L::kRows;
  constexpr int kHS = L::kHStages;
  constexpr int kWS = L::kWStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = tc::align1024(smem_raw);
  uint8_t* halo = sm + L::kHalo;
  uint8_t* wring = sm + L::kW;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBar);
  float* r_s = reinterpret_cast<float*>(sm + L::kR);
  const uint32_t halo_a = tc::smem_u32(halo);
  uint64_t* hfull = bars;             // [kHS] the TMA tile has landed
  uint64_t* hact = bars + kHS;        // [kHS] the tile is activated
  uint64_t* hempty = bars + 2 * kHS;  // [kHS] the consumers are done with it
  uint64_t* wfull = bars + 3 * kHS;   // [kWS]
  uint64_t* wempty = wfull + kWS;     // [kWS]

  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + L::kTH - 1) / L::kTH;
  int tile = blockIdx.x;
  const int x0 = (tile % tiles_w) * kTW;
  tile /= tiles_w;
  const int y0 = (tile % tiles_h) * L::kTH;
  const int n = tile / tiles_h;
  const int n0 = blockIdx.y * BN;
  const int nconv = (Cin + kCC - 1) / kCC;
  const int nchunks = nconv + (kMode == kShortcut ? (Cres + kCC - 1) / kCC : 0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kHS; ++s) {
      tc::mbar_init(hfull + s, 1);
      tc::mbar_init(hact + s, kActivators);
      tc::mbar_init(hempty + s, kConsumers / 32);
    }
    for (int s = 0; s < kWS; ++s) {
      tc::mbar_init(wfull + s, 1);
      tc::mbar_init(wempty + s, kConsumers / 32);
    }
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kTmaWarp) {
    tc::setmaxnreg_dec<kProducerRegs>();
    if (warp == kTmaWarp) {
      // ---- the weight stream: the tiles of each (chunk, tap) in order
      if (lane == 0) {
        int wi = 0;
        for (int c = 0; c < nchunks; ++c) {
          const bool conv = c < nconv;
          const int taps = conv ? 9 : 1;
          for (int t = 0; t < taps; ++t, ++wi) {
            const int ws = wi % kWS;
            if (wi >= kWS) tc::mbar_wait(wempty + ws, (wi / kWS - 1) & 1);
            tc::mbar_expect_tx(wfull + ws, L::kWStage);
            if (conv)
              tc::tma_load_3d(wring + ws * L::kWStage, &tw, wfull + ws,
                              c * kCC, n0, t);
            else
              tc::tma_load_2d(wring + ws * L::kWStage, &tws, wfull + ws,
                              (c - nconv) * kCC, n0);
          }
        }
      }
      return;
    }
    // ---- activators: the halo stream (thread 0 loads chunk c's tile once
    // the consumers are done with the tile its buffer held), chunk 0
    // activated with the consumers, every later conv chunk alone, ahead of
    // the consumers' products
    const int i = threadIdx.x - (kTmaWarp + 1) * 32;
    auto load = [&](int c) {
      const int hs = c % kHS;
      uint8_t* dst = halo + hs * L::kHaloStride;
      if (c >= kHS) tc::mbar_wait(hempty + hs, (c / kHS - 1) & 1);
      if (c < nconv) {
        tc::mbar_expect_tx(hfull + hs, L::kHaloBytes);
        tc::tma_load_4d(dst, &tx, hfull + hs, c * kCC, x0 - 1, y0 - 1, n);
      } else {
        tc::mbar_expect_tx(hfull + hs, L::kResBytes);
        tc::tma_load_4d(dst, &tr, hfull + hs, (c - nconv) * kCC, x0, y0, n);
      }
    };
    if (i == 0)
      for (int c = 0; c < kHS && c < nchunks; ++c) load(c);
    if constexpr (kNorm == kRms) {
      stage_r<BN>(r_s, eff_bias, kConsumers + i, kAllHands, n, y0, x0, H, W);
      tc::bar_sync(2, kAllHands);
    }
    tc::mbar_wait(hfull, 0);
    activate<BN, kNorm, kAllHands>(halo_a, r_s, kConsumers + i, 0, n, y0, x0,
                                   H, W, Cin, eff_scale, eff_bias);
    // before a later TMA load overwrites these bytes
    tc::fence_proxy_async();
    tc::mbar_arrive(hact);
    tc::bar_arrive(1, kAllHands);
    for (int c = 1; c < nchunks; ++c) {
      // into a buffer the consumers freed as they started chunk c - kHS + 1
      if (i == 0 && c >= kHS) load(c);
      if (c < nconv) {
        const int hs = c % kHS;
        tc::mbar_wait(hfull + hs, (c / kHS) & 1);
        activate<BN, kNorm, kActivators>(halo_a + hs * L::kHaloStride, r_s, i,
                                         c, n, y0, x0, H, W, Cin, eff_scale,
                                         eff_bias);
        tc::fence_proxy_async();
        tc::mbar_arrive(hact + hs);
      }
    }
    return;
  }
  tc::setmaxnreg_inc<kConsumerRegs>();

  // ---- consumers: warpgroup wg computes output rows y0 + wg*kRows + r
  const int wg = warp / 4;
  // ldmatrix: lane gives the row address of matrix lane/8 -- pixel m of the
  // warp's 16, channel half (lane/16) of each k16 step
  const int lm_m = (warp % 4) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lm_half = lane >> 4;

  float acc[kRows][BN / 2];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0.f;

  // Chunk 0 has nothing to overlap with: the consumers activate it too.
  if constexpr (kNorm == kRms) {
    stage_r<BN>(r_s, eff_bias, threadIdx.x, kAllHands, n, y0, x0, H, W);
    tc::bar_sync(2, kAllHands);
  }
  tc::mbar_wait(hfull, 0);
  activate<BN, kNorm, kAllHands>(halo_a, r_s, threadIdx.x, 0, n, y0, x0, H, W,
                                 Cin, eff_scale, eff_bias);
  tc::bar_sync(1, kAllHands);

  // One k64 step of output row r: the A fragments of the 64 pixels whose
  // first row this lane addresses (tile pixel p) from ldmatrix, times
  // weight tile w; issued, not waited.
  auto mma = [&](uint32_t (&a)[4][4], float (&d)[BN / 2], uint32_t tile_a,
                 int p, int w) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::ldmatrix_x4(a[kk], tile_a + pix_off(p, kk * 2 + lm_half));
    const uint8_t* wt = wring + (w % kWS) * L::kWStage;
    tc::fence_regs(d);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_conv<BN>(d, a[kk], tc::desc_sw128(wt + kk * 32, 16, 1024));
    tc::wg_commit();
  };
  auto release = [&](int w) {
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(wempty + w % kWS);
  };
  // this chunk's tile is no longer read: hand it back to the producer
  auto release_halo = [&](int hs) {
    tc::fence_proxy_async();
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(hempty + hs);
  };

  // Groups of products go out one (tap, row) at a time from three fragment
  // sets, so each group stays in flight while the next loads its fragments,
  // and a tap's weights are released once its last group is done.  A conv
  // chunk has 9 * kRows groups, a multiple of 3, so its last group always
  // uses set 2: at BN = 128 it stays in flight while the next chunk's first
  // group (set 0) is issued, and its tile and weights go back once it is
  // done.  At BN = 256 those two groups share one accumulator: carried
  // across the loop's back-edge, ptxas serializes the wgmma (C7513), which
  // cost more than draining each chunk does.
  uint32_t a[kFrags][4][4];
  int wi = 0;
  for (int c = 0; c < nconv; ++c) {
    const int hs = c % kHS;
    const uint32_t tile_a = halo_a + hs * L::kHaloStride;
    if (c > 0) tc::mbar_wait(hact + hs, (c / kHS) & 1);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      tc::mbar_wait(wfull + (wi + t) % kWS, ((wi + t) / kWS) & 1);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        // halo tile row (wg*kRows + r) + dy, column m + dx
        const int p = (wg * kRows + r + t / 3) * kHW + lm_m + t % 3;
        mma(a[(t * kRows + r) % kFrags], acc[r], tile_a, p, wi + t);
        tc::wg_wait<1>();  // the group before this one is done
        if (t * kRows + r > 0) {
          if (r == 0) release(wi + t - 1);
        } else if (c > 0) {
          release(wi - 1);
          release_halo((c - 1) % kHS);
        }
      }
    }
    wi += 9;
    if constexpr (kRows == 1) tc::wg_wait<0>();
  }
  // The 1x1 shortcut: a k64 step a chunk over the raw residual tile, which
  // has no halo; each chunk's few groups are drained before the next.
  for (int c = nconv; c < nchunks; ++c) {
    const int hs = c % kHS;
    const uint32_t tile_a = halo_a + hs * L::kHaloStride;
    tc::mbar_wait(hfull + hs, (c / kHS) & 1);
    tc::mbar_wait(wfull + wi % kWS, (wi / kWS) & 1);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      mma(a[r], acc[r], tile_a, (wg * kRows + r) * kTW + lm_m, wi);
      tc::wg_wait<1>();
      if (r == 0 && c == nconv) {  // the last conv chunk's group is done
        release(wi - 1);
        release_halo((c - 1) % kHS);
      }
    }
    tc::wg_wait<0>();
    release(wi);
    release_halo(hs);
    ++wi;
  }
  tc::wg_wait<0>();
#pragma unroll
  for (int r = 0; r < kRows; ++r) tc::fence_regs(acc[r]);

  // ---- epilogue: + bias, + residual or shortcut bias, one rounding
  const int g = lane / 4;
  const int t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y0 + wg * kRows + r;
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + (warp % 4) * 16 + g + 8 * h;
      if (x >= W) continue;
      const int64_t pix = ((int64_t)n * H + y) * W + x;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = n0 + j * 8 + 2 * t4;
        if (co >= Cout) continue;
        float o0 = acc[r][j * 4 + 2 * h] + bias[co];
        float o1 = acc[r][j * 4 + 2 * h + 1] + bias[co + 1];
        if (kMode == kResidual) {
          const float2 rv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + pix * Cout +
                                                       co));
          o0 += rv.x;
          o1 += rv.y;
        }
        if (kMode == kShortcut) {
          o0 += sc_bias[co];
          o1 += sc_bias[co + 1];
        }
        *reinterpret_cast<uint32_t*>(out + pix * Cout + co) =
            tc::pack_bf16(o0, o1);
      }
    }
  }
}

// The output-channel tile for Cout: 128 up to 128 channels, else 256.
int bn_for(int Cout) { return Cout <= 128 ? 128 : 256; }

template <int BN, int kMode, int kNorm>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(conv3x3_tc_kernel<BN, kMode, kNorm>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<BN, kNorm>());
}

template <int BN, int kMode, int kNorm>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& mr,
           const CUtensorMap& mws, int N, int H, int W, int Cin, int Cout,
           int Cres, const float* es, const float* eb, const float* bias,
           const void* res, const float* scb, void* out, cudaStream_t st) {
  using L = Layout<BN>;
  cudaError_t err = allow_smem<BN, kMode, kNorm>();
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles =
      (int64_t)N * ((H + L::kTH - 1) / L::kTH) * ((W + kTW - 1) / kTW);
  dim3 grid((unsigned)tiles, (Cout + BN - 1) / BN);
  conv3x3_tc_kernel<BN, kMode, kNorm>
      <<<grid, kThreads, smem_bytes<BN, kNorm>(), st>>>(
      mx, mw, mr, mws, H, W, Cin, Cout, Cres, es, eb, bias,
      static_cast<const __nv_bfloat16*>(res), scb,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// The tensor maps of one call (their boxes depend on BN's tile height) and
// the launch of the variant for the residual mode.
template <int BN, int kNorm>
int dispatch(const void* x, const void* wpack, const void* res,
             const void* wsc_t, int N, int H, int W, int Cin, int Cout,
             int Cres, const float* es, const float* eb, const float* bias,
             const float* scb, void* out, cudaStream_t st) {
  using L = Layout<BN>;
  CUtensorMap mx, mw, mr, mws;
  const uint64_t dx[4] = {(uint64_t)Cin, (uint64_t)W, (uint64_t)H, (uint64_t)N};
  const uint64_t sx[3] = {(uint64_t)Cin * 2, (uint64_t)W * Cin * 2,
                          (uint64_t)H * W * Cin * 2};
  const uint32_t bx[4] = {kCC, kHW, L::kHH, 1};
  const uint64_t dw[3] = {(uint64_t)Cin, (uint64_t)Cout, 9};
  const uint64_t sw[2] = {(uint64_t)Cin * 2, (uint64_t)Cout * Cin * 2};
  const uint32_t bw[3] = {kCC, BN, 1};
  if (!tc::make_map(&mx, x, 4, dx, sx, bx) ||
      !tc::make_map(&mw, wpack, 3, dw, sw, bw))
    return (int)cudaErrorInvalidValue;
  mr = mx;
  mws = mw;
  if (wsc_t != nullptr) {
    const uint64_t dr[4] = {(uint64_t)Cres, (uint64_t)W, (uint64_t)H,
                            (uint64_t)N};
    const uint64_t sr[3] = {(uint64_t)Cres * 2, (uint64_t)W * Cres * 2,
                            (uint64_t)H * W * Cres * 2};
    const uint32_t br[4] = {kCC, kTW, L::kTH, 1};
    const uint64_t ds[2] = {(uint64_t)Cres, (uint64_t)Cout};
    const uint64_t ss[1] = {(uint64_t)Cres * 2};
    const uint32_t bs[2] = {kCC, BN};
    if (!tc::make_map(&mr, res, 4, dr, sr, br) ||
        !tc::make_map(&mws, wsc_t, 2, ds, ss, bs))
      return (int)cudaErrorInvalidValue;
    return launch<BN, kShortcut, kNorm>(mx, mw, mr, mws, N, H, W, Cin, Cout,
                                        Cres, es, eb, bias, res, scb, out, st);
  }
  if (res != nullptr)
    return launch<BN, kResidual, kNorm>(mx, mw, mr, mws, N, H, W, Cin, Cout,
                                        Cres, es, eb, bias, res, scb, out, st);
  return launch<BN, kPlain, kNorm>(mx, mw, mr, mws, N, H, W, Cin, Cout, Cres,
                                   es, eb, bias, res, scb, out, st);
}

// What the runtime reports for one instance: out = {BN, registers a thread
// at launch, shared memory a block (static + the dynamic size every launch
// passes)}.
template <int BN, int kMode, int kNorm>
int attrs(int* out) {
  cudaError_t err = allow_smem<BN, kMode, kNorm>();
  cudaFuncAttributes a;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, conv3x3_tc_kernel<BN, kMode, kNorm>);
  if (err != cudaSuccess) return (int)err;
  out[0] = BN;
  out[1] = a.numRegs;
  out[2] = (int)a.sharedSizeBytes + a.maxDynamicSharedSizeBytes;
  return 0;
}

template <int BN, int kNorm>
int attrs_of_mode(int mode, int* out) {
  if (mode == kShortcut) return attrs<BN, kShortcut, kNorm>(out);
  if (mode == kResidual) return attrs<BN, kResidual, kNorm>(out);
  return attrs<BN, kPlain, kNorm>(out);
}

// The checks and the launch of both exported entries; kNorm picks the
// prologue's normalisation (eff_scale and eff_bias: the GN affine (N, Cin)
// each, or gamma (Cin) and r (N, H, W) for kRms).
template <int kNorm>
int gn_or_rms(const void* x, int dtype, int N, int H, int W, int Cin,
              int Cout, const float* eff_scale, const float* eff_bias,
              const void* wpack, const float* bias, const void* res, int Cres,
              const void* wsc_t, const float* sc_bias, void* out,
              void* stream) {
  if (dtype != vt::kBF16 || N <= 0 || H <= 0 || W <= 0 || Cin <= 0 ||
      Cout <= 0 || Cin % 8 != 0 || Cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (res != nullptr && wsc_t == nullptr && Cres != Cout)
    return (int)cudaErrorInvalidValue;
  if (wsc_t != nullptr &&
      (res == nullptr || sc_bias == nullptr || Cres <= 0 || Cres % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (!tc::aligned16(x) || !tc::aligned16(wpack) || !tc::aligned16(out) ||
      !tc::aligned16(eff_scale) ||
      (kNorm == kGN && !tc::aligned16(eff_bias)) ||
      (res != nullptr && !tc::aligned16(res)) ||
      (wsc_t != nullptr && !tc::aligned16(wsc_t)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn_for(Cout) == 256)
    return dispatch<256, kNorm>(x, wpack, res, wsc_t, N, H, W, Cin, Cout,
                                Cres, eff_scale, eff_bias, bias, sc_bias, out,
                                st);
  return dispatch<128, kNorm>(x, wpack, res, wsc_t, N, H, W, Cin, Cout, Cres,
                              eff_scale, eff_bias, bias, sc_bias, out, st);
}

template <int kNorm>
int attrs_of(int Cout, int mode, int* out) {
  if (Cout <= 0 || mode < kPlain || mode > kShortcut)
    return (int)cudaErrorInvalidValue;
  if (bn_for(Cout) == 256) return attrs_of_mode<256, kNorm>(mode, out);
  return attrs_of_mode<128, kNorm>(mode, out);
}

}  // namespace

// x (N,H,W,Cin) bf16; eff_scale/eff_bias (N,Cin) fp32; wpack (9,Cout,Cin)
// bf16, the HWIO kernel with each tap's matrix transposed (K-major); bias
// (Cout) fp32; res (N,H,W,Cres) bf16 or null; wsc_t (Cout,Cres) bf16, the
// shortcut matrix transposed, or null for a plain residual (then
// Cres == Cout); sc_bias (Cout) fp32 with wsc_t; out (N,H,W,Cout) bf16.
// Channel counts are multiples of 8 and every pointer that a tensor map
// names is 16-byte aligned; the output-channel tile follows from Cout.
VT_EXPORT int vt_gn_silu_conv3x3_tc(const void* x, int dtype, int N, int H,
                                    int W, int Cin, int Cout,
                                    const float* eff_scale,
                                    const float* eff_bias, const void* wpack,
                                    const float* bias, const void* res,
                                    int Cres, const void* wsc_t,
                                    const float* sc_bias, void* out,
                                    void* stream) {
  return gn_or_rms<kGN>(x, dtype, N, H, W, Cin, Cout, eff_scale, eff_bias,
                        wpack, bias, res, Cres, wsc_t, sc_bias, out, stream);
}

// The RMS mode: as vt_gn_silu_conv3x3_tc, the activation
// silu(x * r[n, y, x] * gamma[c]) from gamma (Cin) fp32, 16-byte aligned,
// and r (N,H,W) fp32 (rms_norm.cu's stats pass).
VT_EXPORT int vt_rms_silu_conv3x3_tc(const void* x, int dtype, int N, int H,
                                     int W, int Cin, int Cout,
                                     const float* gamma, const float* r,
                                     const void* wpack, const float* bias,
                                     const void* res, int Cres,
                                     const void* wsc_t, const float* sc_bias,
                                     void* out, void* stream) {
  return gn_or_rms<kRms>(x, dtype, N, H, W, Cin, Cout, gamma, r, wpack, bias,
                         res, Cres, wsc_t, sc_bias, out, stream);
}

// The instance vt_gn_silu_conv3x3_tc launches for Cout and a residual mode
// (0 none, 1 residual, 2 1x1 shortcut): out = {output-channel tile,
// registers a thread, shared memory bytes a block}, from the CUDA runtime.
VT_EXPORT int vt_gn_silu_conv3x3_tc_attrs(int Cout, int mode, int* out) {
  return attrs_of<kGN>(Cout, mode, out);
}

// The same for the instance vt_rms_silu_conv3x3_tc launches.
VT_EXPORT int vt_rms_silu_conv3x3_tc_attrs(int Cout, int mode, int* out) {
  return attrs_of<kRms>(Cout, mode, out);
}
