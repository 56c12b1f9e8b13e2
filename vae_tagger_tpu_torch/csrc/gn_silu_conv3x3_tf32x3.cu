// Kernel B'': conv3x3 (SAME) + bias [+ residual | + 1x1 shortcut of the
// residual] on Hopper's tensor cores for fp32 tensors, as an implicit GEMM
// on wgmma with 3xTF32 products, over an input that kernel A's apply pass
// has activated: the two are the fused GroupNorm-affine + SiLU + conv3x3
// of ops/conv.py.
//
// Replaces, for fp32 tensors, the TPU kernel vae_tagger_tpu/ops/pallas/
// conv_fused.py::gn_silu_conv3x3_pallas (its pallas_call at :260); bf16
// tensors go to kernel B' (gn_silu_conv3x3_tc.cu).  With A's apply pass it
// computes what the SIMT kernel B (gn_silu_conv3x3.cu) computes: the
// activation silu(x*eff_scale + eff_bias) from kernel A's stats pass, in
// fp32 and not rounded (A's exact SiLU, vt::silu's expf and IEEE
// division); SAME padding of the *activated* tensor (taps outside the
// image are 0 after activation, silu(eff_bias) is not: the copy engine
// zero-fills them); fp32 accumulation; then bias, then the residual or the
// shortcut product (accumulated in the same registers).
//
// 3xTF32: each fp32 operand x is split into hi = tf32(x) and lo = tf32(x -
// hi) (cvt.rna), and a product is accumulated in fp32 as lo*hi + hi*lo +
// hi*hi, the small terms first; what is dropped (lo*lo, the rounding of lo)
// is below 2^-21 of each product.  The weights are split by the wrapper
// when it packs them (split_tf32, part of each call), the activations in
// registers at use.  The tensor cores round each accumulation toward zero;
// with one accumulator for all 3 x 9 x Cin/8 steps the error reached 2-9x
// the SIMT kernel's (up to 3.5e-5 at 512 channels), so each 32-channel
// chunk's 108 steps go to a fresh accumulator that is added to the
// output's in fp32 on the CUDA cores.
//
// Bound on this card: operations, 3 * 2*M*9*Cin*Cout FLOP on the TF32
// tensor cores (98.3 ms for the 20 convs of a 1024px batch of 4 against
// 495 TFLOP/s), against 242 ms for the SIMT kernel's fp32 FMA.  What held
// kernel B back, and what this design does:
//  - fp32 FMA on the CUDA cores, k-slices of 8 with a barrier pair each:
//    the products are wgmma m64n128k8 tf32, 32 input channels (one
//    128-byte swizzled row) a pipeline step, three products a k8 step;
//  - a loader that gathered one 4-byte value a thread: the input arrives
//    by TMA as a halo tile of 4 x 66 pixels x 32 channels, out-of-bounds
//    pixels zero-filled by the copy engine;
//  - the GN affine and SiLU recomputed for every tap and Cout tile: A's
//    apply pass activates each value once.
// What bounds it now (measured on an H100 at 700 W, the 20 convs of a
// 1024px batch of 4):
//  - not the L2 weight stream.  A CTA reads 9 weight stages of 32 KB (hi
//    and lo) a 32-channel chunk, about 3 TB/s over the card, where TMA
//    delivers 17 TB/s to this ring alone, and a copy that streamed no
//    weights at all ran no faster.  Multicasting each stage to a cluster
//    of two CTAs (each loading half; a stage released by the consumers of
//    both) halved the L2 reads and cost 2.4-3.6% of the conv's time
//    (clusters of four, 13%), so every CTA loads its own.
//  - not the activation any more.  As this kernel's prologue (the consumer
//    warps activating each halo tile in place) it cost 25% of the time: a
//    tile's 8,448 SiLU were computed again for every Cout tile and for the
//    halo rows (2.1x the pixels), and they took the consumer warps' issue
//    from the products between the chunks, beside the products, or in the
//    producer warpgroup alike.  A's pass computes each value once, for 8
//    bytes an element of HBM traffic (about 11 ms a batch of 4).
//  - the products and the issue of their fragments: about 77% of the
//    bound without the activation.
// Operand layouts: tf32 wgmma reads shared-memory operands K-major only.
// The weights are packed K-major, (9, Cout, Cin) hi and lo (and the
// shortcut (Cout, Cres)).  The activations are the A operand from
// registers, so a tap shift is only an ldmatrix row address: ldmatrix's
// 8 x 8 b16 matrices are 8 x 4 fp32 blocks, and four of them are the tf32 A
// fragment of a k8 step ((row g, k t4), (g+8, t4), (g, t4+4), (g+8, t4+4)).
// Registers set the tile: each consumer warpgroup owns one output row of
// 64 pixels by 128 channels, 64 accumulators a thread, 64 more for the
// chunk's fresh accumulator, and two sets of A fragments (2 k8 steps, hi
// and lo: 16 registers each; with 4 k8 steps one instance spilled), so
// that one group of products stays in flight while the next group's
// fragments load.  A producer warpgroup (one thread issues every
// TMA load) gives its registers to the two consumer warpgroups with
// setmaxnreg (40 / 232).  Shared memory: fp32 halves the channels a
// 128-byte row holds, and hi/lo doubles the weight bytes: 2 halo tiles (34
// KB each) and 4 weight stages of 128 x 32 hi and lo (32 KB each), 197 KB.
// Takes any N, H, W and channel counts that are multiples of 4 (TMA's
// 16-byte strides).  Tensor maps: encoded on the host per call.
#include "tc_common.cuh"

namespace {

constexpr int kTW = 64;        // output pixels along W a tile (wgmma M)
constexpr int kHW = kTW + 2;   // halo tile width
constexpr int kTH = 2;         // output rows a tile: one a warpgroup
constexpr int kHH = kTH + 2;   // halo tile height
constexpr int kCC = 32;        // channels a chunk: one 128-byte row
constexpr int kBN = 128;       // output channels a tile (wgmma N)
constexpr int kWStages = 4;
constexpr int kSteps = 2;  // k8 steps a commit group
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

enum Mode : int { kPlain = 0, kResidual = 1, kShortcut = 2 };

struct Layout {
  static constexpr int kHaloBytes = kHH * kHW * kCC * 4;
  static constexpr int kHaloStride = (kHaloBytes + 1023) / 1024 * 1024;
  static constexpr int kResBytes = kTH * kTW * kCC * 4;  // shortcut's tile
  static constexpr int kWCopy = kBN * kCC * 4;           // hi or lo
  static constexpr int kWStage = 2 * kWCopy;
  static constexpr int kHalo = 0;
  static constexpr int kW = 2 * kHaloStride;
  static constexpr int kBar = kW + kWStages * kWStage;
  static constexpr int kBytes = kBar + 16 * 8 + 1024;  // + alignment slack
};

// Byte offset of 16-byte chunk `chunk` (4 channels) of tile pixel p.
__device__ __forceinline__ uint32_t pix_off(int p, int chunk) {
  return (uint32_t)p * 128 + (uint32_t)((chunk ^ (p & 7)) << 4);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_tf32x3_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap twh,
                      const __grid_constant__ CUtensorMap twl,
                      const __grid_constant__ CUtensorMap tr,
                      const __grid_constant__ CUtensorMap tsh,
                      const __grid_constant__ CUtensorMap tsl, int H, int W,
                      int Cin, int Cout, int Cres,
                      const float* __restrict__ bias,
                      const float* __restrict__ res,
                      const float* __restrict__ sc_bias,
                      float* __restrict__ out) {
  using L = Layout;
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
  const int tiles_h = (H + kTH - 1) / kTH;
  int tile = blockIdx.x;
  const int x0 = (tile % tiles_w) * kTW;
  tile /= tiles_w;
  const int y0 = (tile % tiles_h) * kTH;
  const int n = tile / tiles_h;
  const int n0 = blockIdx.y * kBN;
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
    // ---- producer: per chunk its input tile, then its weight tiles (hi
    // and lo in one stage)
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
          uint8_t* wdst = wring + ws * L::kWStage;
          tc::mbar_expect_tx(wfull + ws, L::kWStage);
          if (conv) {
            tc::tma_load_3d(wdst, &twh, wfull + ws, c * kCC, n0, t);
            tc::tma_load_3d(wdst + L::kWCopy, &twl, wfull + ws, c * kCC, n0,
                            t);
          } else {
            tc::tma_load_2d(wdst, &tsh, wfull + ws, (c - nconv) * kCC, n0);
            tc::tma_load_2d(wdst + L::kWCopy, &tsl, wfull + ws,
                            (c - nconv) * kCC, n0);
          }
        }
      }
    }
    return;
  }
  tc::setmaxnreg_inc<kConsumerRegs>();

  // ---- consumers: warpgroup wg computes output row y0 + wg
  const int wg = warp / 4;
  // ldmatrix: lane gives the row address of matrix lane/8 -- pixel m of the
  // warp's 16, 16-byte chunk (lane/16) of each k8 step
  const int lm_m = (warp % 4) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lm_half = lane >> 4;

  float acc[kBN / 2];   // the output tile
  float part[kBN / 2];  // one chunk's products
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

  int wi = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int hs = c & 1;
    const uint32_t tile_a = tc::smem_u32(halo + hs * L::kHaloStride);
    tc::mbar_wait(hfull + hs, (c >> 1) & 1);
    const bool conv = c < nconv;

    // One tap: the A fragments of the 64 pixels whose first row this lane
    // addresses (tile pixel p) from ldmatrix, split into hi and lo, times
    // weight tile w (hi and lo), 4 k8 steps; issued, not waited.
    auto mma = [&](uint32_t (&a)[kSteps][2][4], int p, int w, int k0) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t raw[4];
        tc::ldmatrix_x4(raw, tile_a + pix_off(p, (k0 + kk) * 2 + lm_half));
        tc::split_tf32(raw, a[kk][0], a[kk][1]);
      }
      const uint8_t* wt = wring + (w % kWStages) * L::kWStage;
      tc::fence_regs(part);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int off = (k0 + kk) * 32;
        const uint64_t dh = tc::desc_sw128(wt + off, 16, 1024);
        const uint64_t dl = tc::desc_sw128(wt + L::kWCopy + off, 16, 1024);
        tc::wgmma_tf32_rs_n128(part, a[kk][1], dh);  // lo * hi
        tc::wgmma_tf32_rs_n128(part, a[kk][0], dl);  // hi * lo
        tc::wgmma_tf32_rs_n128(part, a[kk][0], dh);  // hi * hi
      }
      tc::wg_commit();
    };
    auto release = [&](int w) {
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(wempty + w % kWStages);
    };
    // Products go out in groups of kSteps k8 steps; two fragment sets
    // alternate, so each group stays in flight while the next loads its
    // fragments, and a tap's weights are released once its last group is
    // done.
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) part[i] = 0.f;
    uint32_t a[2][kSteps][2][4];
    const int taps = conv ? 9 : 1;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      if (t < taps) {
        tc::mbar_wait(wfull + (wi + t) % kWStages,
                      ((wi + t) / kWStages) & 1);
        // halo tile row wg + dy, column m + dx; the residual tile of the
        // shortcut has no halo
        const int p = conv ? (wg + t / 3) * kHW + lm_m + t % 3
                           : wg * kTW + lm_m;
#pragma unroll
        for (int gq = 0; gq < 4 / kSteps; ++gq) {
          const int gi = t * (4 / kSteps) + gq;
          mma(a[gi & 1], p, wi + t, gq * kSteps);
          if (gi > 0) {
            tc::wg_wait<1>();  // the group before this one is done
            if (gq == 0) release(wi + t - 1);
          }
        }
      }
    }
    tc::wg_wait<0>();
    tc::fence_regs(part);
    release(wi + taps - 1);
    wi += taps;
    // this chunk's tile is no longer read: hand it back to the producer
    tc::fence_proxy_async();
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(hempty + hs);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
    tc::fence_regs(acc);  // the adds before the next chunk's products
  }

  // ---- epilogue: + bias, + residual or shortcut bias
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int y = y0 + wg;
  if (y >= H) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = x0 + (warp % 4) * 16 + g + 8 * h;
    if (x >= W) continue;
    const int64_t pix = ((int64_t)n * H + y) * W + x;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int co = n0 + j * 8 + 2 * t4;
      if (co >= Cout) continue;
      float o0 = acc[j * 4 + 2 * h] + bias[co];
      float o1 = acc[j * 4 + 2 * h + 1] + bias[co + 1];
      if (kMode == kResidual) {
        const float2 rv =
            *reinterpret_cast<const float2*>(res + pix * Cout + co);
        o0 += rv.x;
        o1 += rv.y;
      }
      if (kMode == kShortcut) {
        o0 += sc_bias[co];
        o1 += sc_bias[co + 1];
      }
      *reinterpret_cast<float2*>(out + pix * Cout + co) = make_float2(o0, o1);
    }
  }
}

template <int kMode>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(conv3x3_tf32x3_kernel<kMode>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout::kBytes);
}

struct Maps {
  CUtensorMap x, wh, wl, r, sh, sl;
};

template <int kMode>
int launch(const Maps& m, int N, int H, int W, int Cin, int Cout, int Cres,
           const float* bias, const float* res, const float* scb, float* out,
           cudaStream_t st) {
  cudaError_t err = allow_smem<kMode>();
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles =
      (int64_t)N * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  dim3 grid((unsigned)tiles, (Cout + kBN - 1) / kBN);
  conv3x3_tf32x3_kernel<kMode><<<grid, kThreads, Layout::kBytes, st>>>(
      m.x, m.wh, m.wl, m.r, m.sh, m.sl, H, W, Cin, Cout, Cres, bias, res, scb,
      out);
  return (int)cudaGetLastError();
}

// What the runtime reports for one instance: out = {output-channel tile,
// registers a thread at launch, shared memory a block (static + the
// dynamic size every launch passes)}.
template <int kMode>
int attrs(int* out) {
  cudaError_t err = allow_smem<kMode>();
  cudaFuncAttributes a;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, conv3x3_tf32x3_kernel<kMode>);
  if (err != cudaSuccess) return (int)err;
  out[0] = kBN;
  out[1] = a.numRegs;
  out[2] = (int)a.sharedSizeBytes + a.maxDynamicSharedSizeBytes;
  return 0;
}

}  // namespace

// x (N,H,W,Cin) fp32, the activated input; w_hi and w_lo
// (9,Cout,Cin) fp32, the HWIO kernel with each tap's matrix transposed
// (K-major), split by split_tf32; bias (Cout) fp32; res (N,H,W,Cres) fp32
// or null; sc_hi and sc_lo (Cout,Cres) fp32, the shortcut matrix
// transposed and split, or null for a plain residual (then Cres == Cout);
// sc_bias (Cout) fp32 with them; out (N,H,W,Cout) fp32.  Channel counts
// are multiples of 4, and every pointer that a tensor map names 16-byte
// aligned.
VT_EXPORT int vt_gn_silu_conv3x3_tf32x3(const void* x, int N, int H, int W,
                                        int Cin, int Cout,
                                        const void* w_hi, const void* w_lo,
                                        const float* bias, const void* res,
                                        int Cres, const void* sc_hi,
                                        const void* sc_lo,
                                        const float* sc_bias, void* out,
                                        void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 4 != 0 ||
      Cout % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (res != nullptr && sc_hi == nullptr && Cres != Cout)
    return (int)cudaErrorInvalidValue;
  if (sc_hi != nullptr && (res == nullptr || sc_lo == nullptr ||
                           sc_bias == nullptr || Cres <= 0 || Cres % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if (!tc::aligned16(x) || !tc::aligned16(w_hi) || !tc::aligned16(w_lo) ||
      !tc::aligned16(out) || (res != nullptr && !tc::aligned16(res)) ||
      (sc_hi != nullptr && (!tc::aligned16(sc_hi) || !tc::aligned16(sc_lo))))
    return (int)cudaErrorInvalidValue;
  Maps m;
  const uint64_t dx[4] = {(uint64_t)Cin, (uint64_t)W, (uint64_t)H, (uint64_t)N};
  const uint64_t sx[3] = {(uint64_t)Cin * 4, (uint64_t)W * Cin * 4,
                          (uint64_t)H * W * Cin * 4};
  const uint32_t bx[4] = {kCC, kHW, kHH, 1};
  const uint64_t dw[3] = {(uint64_t)Cin, (uint64_t)Cout, 9};
  const uint64_t sw[2] = {(uint64_t)Cin * 4, (uint64_t)Cout * Cin * 4};
  const uint32_t bw[3] = {kCC, kBN, 1};
  if (!tc::make_map(&m.x, x, 4, dx, sx, bx, true) ||
      !tc::make_map(&m.wh, w_hi, 3, dw, sw, bw, true) ||
      !tc::make_map(&m.wl, w_lo, 3, dw, sw, bw, true))
    return (int)cudaErrorInvalidValue;
  m.r = m.x;
  m.sh = m.wh;
  m.sl = m.wl;
  const float* rf = static_cast<const float*>(res);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sc_hi != nullptr) {
    const uint64_t dr[4] = {(uint64_t)Cres, (uint64_t)W, (uint64_t)H,
                            (uint64_t)N};
    const uint64_t sr[3] = {(uint64_t)Cres * 4, (uint64_t)W * Cres * 4,
                            (uint64_t)H * W * Cres * 4};
    const uint32_t br[4] = {kCC, kTW, kTH, 1};
    const uint64_t ds[2] = {(uint64_t)Cres, (uint64_t)Cout};
    const uint64_t ss[1] = {(uint64_t)Cres * 4};
    const uint32_t bs[2] = {kCC, kBN};
    if (!tc::make_map(&m.r, res, 4, dr, sr, br, true) ||
        !tc::make_map(&m.sh, sc_hi, 2, ds, ss, bs, true) ||
        !tc::make_map(&m.sl, sc_lo, 2, ds, ss, bs, true))
      return (int)cudaErrorInvalidValue;
    return launch<kShortcut>(m, N, H, W, Cin, Cout, Cres, bias, rf, sc_bias,
                             of, st);
  }
  if (res != nullptr)
    return launch<kResidual>(m, N, H, W, Cin, Cout, Cres, bias, rf, sc_bias,
                             of, st);
  return launch<kPlain>(m, N, H, W, Cin, Cout, Cres, bias, rf, sc_bias, of,
                        st);
}

// The instance vt_gn_silu_conv3x3_tf32x3 launches for a residual mode (0
// none, 1 residual, 2 1x1 shortcut): out = {output-channel tile, registers
// a thread, shared memory bytes a block}, from the CUDA runtime.  Cout is
// taken for the signature B' has; every Cout gets the same tile.
VT_EXPORT int vt_gn_silu_conv3x3_tf32x3_attrs(int Cout, int mode, int* out) {
  if (Cout <= 0 || mode < kPlain || mode > kShortcut)
    return (int)cudaErrorInvalidValue;
  if (mode == kShortcut) return attrs<kShortcut>(out);
  if (mode == kResidual) return attrs<kResidual>(out);
  return attrs<kPlain>(out);
}
