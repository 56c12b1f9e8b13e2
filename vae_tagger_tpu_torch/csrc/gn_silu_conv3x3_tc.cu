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
// peak).  What held the SIMT kernel B back, and what this design does:
//  - fp32 FMA on the CUDA cores, k-slices of 8 with a barrier pair each:
//    the products are wgmma m64nBNk16 (BN = 128 or 256 output channels),
//    64 input channels (one 128-byte swizzled row) a pipeline step;
//  - a loader that gathered one 2-byte value a thread: the raw input
//    arrives by TMA as a halo tile of (rows+2) x (64+2) pixels x 64
//    channels, out-of-bounds pixels zero-filled by the copy engine;
//  - the GN affine and the SiLU recomputed for every tap and every Cout
//    tile (36 times a value at 512 channels): the TPU kernel's own
//    decomposition instead (conv_fused.py:22-33) -- the consumer warps
//    activate the halo tile once, in place (affine + SiLU in fp32, pixels
//    outside the image set to 0, rounded to bf16; the exponential and the
//    reciprocal on the SFU), and all 9 taps read that one tile.
// Tap shifts need no canonical layout: the A operand comes from registers
// (wgmma's RS form), filled by ldmatrix, which takes one row address per
// pixel, so a shift by (dy, dx) is only an address.  The tile's 128-byte
// pixel rows carry TMA's 128-byte swizzle, so the 8 pixels of an ldmatrix
// phase hit 8 distinct bank groups.  The weights are the operand every block
// re-reads from L2; they are packed by the wrapper K-major, (9, Cout, Cin)
// (and the shortcut (Cout, Cres)), and stream through a 4-stage TMA ring of
// 64 x BN tiles, one (tap, channel chunk) at a time, while the activated
// halo stays resident for its chunk's 9 taps; a tap's products stay in
// flight while the next tap loads its A fragments.  The 1x1 shortcut is extra
// K steps over the raw residual tile (no activation, centre pixel only).
//
// A block: two consumer warpgroups and a producer warpgroup, one thread of
// which issues every TMA load; setmaxnreg gives the consumers 232 registers
// a thread and the producer 40.  Each consumer warpgroup owns output rows of
// 64 pixels and BN channels, one row at BN = 256 (128 accumulators a
// thread, M = 128 pixels a block) and two at BN = 128 (M = 256, the same
// registers): the layers with 128 output channels are the largest images,
// and twice the rows halve the weight traffic, the halo overhead and the
// fixed cost of a block there.  Shared memory: 2 halo tiles and 4 weight
// stages of BN*128 bytes (195 KB at BN = 256, 165 KB at BN = 128).  Takes
// any N, H, W and channel counts that are multiples of 8 (TMA's 16-byte
// strides).  Tensor maps: encoded on the host per call (tc_common.cuh,
// through the driver entry point, no -lcuda).
//
// The prologue's normalisation is a compile-time mode, kNorm.  kGN, the
// GroupNorm above: a per-(sample, channel) scale and shift.  kRms, the
// per-pixel RMS norm of the Wan VAE (diffusers WanRMS_norm): the activation
// silu(x * (r[n, y, x] * gamma[c])), where rms_norm.cu's stats pass wrote
// r = sqrt(C) / max(||x[n, :, y, x]||, 1e-12) over the input's channels;
// vt_rms_silu_conv3x3_tc passes gamma (Cin) and r (N, H, W) in the places
// of eff_scale and eff_bias.  Every other line of the kernel is shared, so
// the GN instances compile to what they were before the mode existed.
#include "tc_common.cuh"

namespace {

constexpr int kTW = 64;        // output pixels along W a tile (wgmma M)
constexpr int kHW = kTW + 2;   // halo tile width
constexpr int kCC = 64;        // channels a chunk: one 128-byte row
constexpr int kWStages = 4;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

enum Mode : int { kPlain = 0, kResidual = 1, kShortcut = 2 };
enum Norm : int { kGN = 0, kRms = 1 };

template <int BN>
struct Layout {
  static constexpr int kRows = BN == 128 ? 2 : 1;  // output rows a warpgroup
  static constexpr int kTH = 2 * kRows;            // output rows a tile
  static constexpr int kHH = kTH + 2;              // halo tile height
  static constexpr int kHaloBytes = kHH * kHW * kCC * 2;
  static constexpr int kHaloStride = (kHaloBytes + 1023) / 1024 * 1024;
  static constexpr int kResBytes = kTH * kTW * kCC * 2;  // shortcut's tile
  static constexpr int kWStage = BN * kCC * 2;
  static constexpr int kHalo = 0;
  static constexpr int kW = 2 * kHaloStride;
  static constexpr int kBar = kW + kWStages * kWStage;
  static constexpr int kBytes = kBar + 16 * 8 + 1024;  // + alignment slack
};

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
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = tc::align1024(smem_raw);
  uint8_t* halo = sm + L::kHalo;
  uint8_t* wring = sm + L::kW;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* hfull = bars;        // [2]
  uint64_t* hempty = bars + 2;   // [2]
  uint64_t* wfull = bars + 4;    // [kWStages]
  uint64_t* wempty = bars + 8;   // [kWStages]

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
    for (int s = 0; s < 2; ++s) {
      tc::mbar_init(hfull + s, 1);
      tc::mbar_init(hempty + s, kConsumers / 32);
    }
    for (int s = 0; s < kWStages; ++s) {
      tc::mbar_init(wfull + s, 1);
      tc::mbar_init(wempty + s, kConsumers / 32);
    }
    tc::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    tc::setmaxnreg_dec<kProducerRegs>();
    // ---- producer: per chunk its input tile, then its weight tiles
    if (warp == kConsumers / 32 && lane == 0) {
      int wi = 0;
      for (int c = 0; c < nchunks; ++c) {
        const int hs = c & 1;
        uint8_t* dst = halo + hs * L::kHaloStride;
        if (c >= 2) tc::mbar_wait(hempty + hs, ((c >> 1) - 1) & 1);
        const bool conv = c < nconv;
        if (conv) {
          tc::mbar_expect_tx(hfull + hs, L::kHaloBytes);
          tc::tma_load_4d(dst, &tx, hfull + hs, c * kCC, x0 - 1, y0 - 1, n);
        } else {
          tc::mbar_expect_tx(hfull + hs, L::kResBytes);
          tc::tma_load_4d(dst, &tr, hfull + hs, (c - nconv) * kCC, x0, y0,
                          n);
        }
        const int taps = conv ? 9 : 1;
        for (int t = 0; t < taps; ++t, ++wi) {
          const int ws = wi % kWStages;
          if (wi >= kWStages)
            tc::mbar_wait(wempty + ws, ((wi / kWStages) - 1) & 1);
          tc::mbar_expect_tx(wfull + ws, L::kWStage);
          if (conv)
            tc::tma_load_3d(wring + ws * L::kWStage, &tw, wfull + ws, c * kCC,
                            n0, t);
          else
            tc::tma_load_2d(wring + ws * L::kWStage, &tws, wfull + ws,
                            (c - nconv) * kCC, n0);
        }
      }
    }
    return;
  }
  tc::setmaxnreg_inc<kConsumerRegs>();

  // ---- consumers: warpgroup wg computes output rows y0 + wg*kRows + r
  const int wg = warp / 4;
  const int tid = threadIdx.x;  // 0..255 over both warpgroups
  // ldmatrix: lane gives the row address of matrix lane/8 -- pixel m of the
  // warp's 16, channel half (lane/16) of each k16 step
  const int lm_m = (warp % 4) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lm_half = lane >> 4;

  float acc[kRows][BN / 2];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0.f;

  int wi = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int hs = c & 1;
    uint8_t* tile_p = halo + hs * L::kHaloStride;
    const uint32_t tile_a = tc::smem_u32(tile_p);
    tc::mbar_wait(hfull + hs, (c >> 1) & 1);
    const bool conv = c < nconv;
    if (conv) {
      // activate the halo tile in place, 16 bytes (8 channels) a step
      const float* es =
          kNorm == kRms ? eff_scale : eff_scale + (int64_t)n * Cin;
      const float* eb = eff_bias + (int64_t)n * Cin;
      for (int u = tid; u < L::kHH * kHW * 8; u += kConsumers) {
        const int p = u >> 3;
        const int q = u & 7;
        const int ci0 = c * kCC + ((q ^ (p & 7)) << 3);
        const int r = p / kHW;
        const int y = y0 - 1 + r;
        const int x = x0 - 1 + (p - r * kHW);
        uint4* ptr = reinterpret_cast<uint4*>(tile_p + p * 128 + q * 16);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (y >= 0 && y < H && x >= 0 && x < W && ci0 < Cin) {
          const uint4 raw = *ptr;
          const __nv_bfloat162* xv =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
          uint32_t* o = reinterpret_cast<uint32_t*>(&v);
          if constexpr (kNorm == kRms) {
            // r of this pixel times gamma of each channel; no shift
            const float rr = eff_bias[((int64_t)n * H + y) * W + x];
            const float4 g0 = *reinterpret_cast<const float4*>(es + ci0);
            const float4 g1 = *reinterpret_cast<const float4*>(es + ci0 + 4);
            const float sc[8] = {rr * g0.x, rr * g0.y, rr * g0.z, rr * g0.w,
                                 rr * g1.x, rr * g1.y, rr * g1.z, rr * g1.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(xv[e]);
              o[e] = tc::pack_bf16(silu_fast(f.x * sc[2 * e]),
                                   silu_fast(f.y * sc[2 * e + 1]));
            }
          } else {
            const float4 s0 = *reinterpret_cast<const float4*>(es + ci0);
            const float4 s1 = *reinterpret_cast<const float4*>(es + ci0 + 4);
            const float4 b0 = *reinterpret_cast<const float4*>(eb + ci0);
            const float4 b1 = *reinterpret_cast<const float4*>(eb + ci0 + 4);
            const float sc[8] = {s0.x, s0.y, s0.z, s0.w,
                                 s1.x, s1.y, s1.z, s1.w};
            const float bi[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(xv[e]);
              o[e] = tc::pack_bf16(
                  silu_fast(f.x * sc[2 * e] + bi[2 * e]),
                  silu_fast(f.y * sc[2 * e + 1] + bi[2 * e + 1]));
            }
          }
        }
        *ptr = v;
      }
      tc::bar_sync(1, kConsumers);
    }

    // One k64 step of output row r: the A fragments of the 64 pixels whose
    // first row this lane addresses (tile pixel p) from ldmatrix, times
    // weight tile w; issued, not waited.
    auto mma = [&](uint32_t (&a)[4][4], float (&d)[BN / 2], int p, int w) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::ldmatrix_x4(a[kk], tile_a + pix_off(p, kk * 2 + lm_half));
      const uint8_t* wt = wring + (w % kWStages) * L::kWStage;
      tc::fence_regs(d);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_conv<BN>(d, a[kk], tc::desc_sw128(wt + kk * 32, 16, 1024));
      tc::wg_commit();
    };
    auto release = [&](int w) {
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(wempty + w % kWStages);
    };
    // Groups of products go out one (tap, row) at a time; two fragment sets
    // alternate, so each group stays in flight while the next loads its
    // fragments, and a tap's weights are released once its last group is
    // done.
    uint32_t a[2][4][4];
    const int taps = conv ? 9 : 1;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      if (t < taps) {
        tc::mbar_wait(wfull + (wi + t) % kWStages,
                      ((wi + t) / kWStages) & 1);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          // halo tile row (wg*kRows + r) + dy, column m + dx; the residual
          // tile of the shortcut has no halo
          const int row = wg * kRows + r;
          const int p = conv ? (row + t / 3) * kHW + lm_m + t % 3
                             : row * kTW + lm_m;
          mma(a[(t * kRows + r) & 1], acc[r], p, wi + t);
          if (t * kRows + r > 0) {
            tc::wg_wait<1>();  // the group before this one is done
            if (r == 0) release(wi + t - 1);
          }
        }
      }
    }
    tc::wg_wait<0>();
#pragma unroll
    for (int r = 0; r < kRows; ++r) tc::fence_regs(acc[r]);
    release(wi + taps - 1);
    wi += taps;
    // this chunk's tile is no longer read: hand it back to the producer
    tc::fence_proxy_async();
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(hempty + hs);
  }

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
                              Layout<BN>::kBytes);
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
  conv3x3_tc_kernel<BN, kMode, kNorm><<<grid, kThreads, L::kBytes, st>>>(
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
