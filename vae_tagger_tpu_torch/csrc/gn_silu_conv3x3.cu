// Kernel B: fused GroupNorm-affine + SiLU + conv3x3 (SAME) + bias, then
// + residual, or + a 1x1 shortcut projection of the residual.
//
// Replaces the TPU kernel vae_tagger_tpu/ops/pallas/conv_fused.py::
// gn_silu_conv3x3_pallas, which runs both branches of every encoder
// ResnetBlock.  The GroupNorm statistics come in already folded into
// per-(n, cin) eff_scale / eff_bias (kernel A's stats pass), so the prologue
// is one fused multiply-add and a SiLU per staged input value.
//
// Form: an implicit GEMM over NHWC.  M = N*H*W output pixels, N = Cout,
// K = 9*Cin (tap-major: k = (dy*3 + dx)*Cin + ci, the layout of an HWIO
// kernel reshaped to (9*Cin, Cout)).  With a 1x1 shortcut the residual
// channels are appended to K (K += Cres, rows of the (Cres, Cout) shortcut
// matrix appended to B), so the projection accumulates in the same fp32
// registers as the conv.
//
//  - The A-tile loader applies silu(x*eff_scale + eff_bias) as it stages a
//    pixel's tap into shared memory, rounded to the input dtype as the
//    reference rounds the activation before its conv.  Taps that fall
//    outside the image load 0 AFTER activation (SAME padding pads the
//    activated tensor, not x; silu(eff_bias) is not 0).
//  - 128x128 output tile per block, k-slices of 8, 256 threads each holding
//    an 8x8 fp32 accumulator in registers; the next k-slice is fetched into
//    registers while the current one is multiplied out of shared memory.
//  - The epilogue adds the conv bias and then the residual (same channel
//    count) or the shortcut bias, and casts to the output dtype.
//
// Bound on this card: operations.  At 1024^2 x 128 -> 128 one conv is
// 2*1024^2*9*128^2 = 309 GFLOP per image against well under 1 GB of
// traffic.  It multiplies with fp32 FMA on the CUDA cores and takes fp32
// tensors only.  No dispatch table names it any more: fp32 tensors go to
// kernel B'' (gn_silu_conv3x3_tf32x3.cu), which keeps fp32-level error on
// the tensor cores with 3xTF32 products, and bf16 tensors to B'
// (gn_silu_conv3x3_tc.cu).  chip_smoke.py launches it directly, as the
// yardstick B'' is checked and timed against.
#include "common.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kThreads = 256;
constexpr int kPad = 4;

enum Mode : int { kPlain = 0, kResidual = 1, kShortcut = 2 };

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, int N, int H, int W, int Cin,
               int Cout, const float* __restrict__ eff_scale,
               const float* __restrict__ eff_bias, const T* __restrict__ wmat,
               const float* __restrict__ bias, const T* __restrict__ res,
               int Cres, const T* __restrict__ wsc,
               const float* __restrict__ sc_bias, T* __restrict__ out) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];

  const int tid = threadIdx.x;
  const int64_t HW = (int64_t)H * W;
  const int64_t M = (int64_t)N * HW;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int Kconv = 9 * Cin;
  const int Ktot = Kconv + (kMode == kShortcut ? Cres : 0);

  // A loader: 4 pixels per thread (rows tid/8 + 32r), one k per thread.
  const int a_k = tid % kBK;
  const int a_row = tid / kBK;
  int pn[4], py[4], px[4];
  int64_t pm[4];
  bool pv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t m = m0 + a_row + 32 * r;
    pm[r] = m;
    pv[r] = m < M;
    const int64_t mm = pv[r] ? m : 0;
    pn[r] = (int)(mm / HW);
    const int64_t rem = mm - (int64_t)pn[r] * HW;
    py[r] = (int)(rem / W);
    px[r] = (int)(rem - (int64_t)py[r] * W);
  }
  // B loader: 4 k-rows per thread (tid/128 + 2r), one column per thread.
  const int b_col = tid % kBN;
  const int b_k = tid / kBN;

  float ra[4], rb[4];
  auto fetch = [&](int k0) {
    const int k = k0 + a_k;
    if (k < Kconv) {
      const int tap = k / Cin;
      const int ci = k - tap * Cin;
      const int dy = tap / 3 - 1;
      const int dx = tap % 3 - 1;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int iy = py[r] + dy;
        const int ix = px[r] + dx;
        float v = 0.f;
        if (pv[r] && iy >= 0 && iy < H && ix >= 0 && ix < W) {
          const float xv =
              vt::to_f(x[(((int64_t)pn[r] * H + iy) * W + ix) * Cin + ci]);
          const int e = pn[r] * Cin + ci;
          v = vt::round_to<T>(vt::silu(xv * eff_scale[e] + eff_bias[e]));
        }
        ra[r] = v;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float v = 0.f;
        if (kMode == kShortcut && pv[r] && k < Ktot)
          v = vt::to_f(res[pm[r] * Cres + (k - Kconv)]);
        ra[r] = v;
      }
    }
    const int col = n0 + b_col;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kg = k0 + b_k + 2 * r;
      float w = 0.f;
      if (col < Cout && kg < Ktot) {
        if (kg < Kconv)
          w = vt::to_f(wmat[(int64_t)kg * Cout + col]);
        else if (kMode == kShortcut)
          w = vt::to_f(wsc[(int64_t)(kg - Kconv) * Cout + col]);
      }
      rb[r] = w;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      As[a_k][a_row + 32 * r] = ra[r];
      Bs[b_k + 2 * r][b_col] = rb[r];
    }
  };

  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stage();
  __syncthreads();
  for (int k0 = 0; k0 < Ktot; k0 += kBK) {
    const bool more = k0 + kBK < Ktot;
    if (more) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col >= Cout) continue;
      float o = acc[i][j] + bias[col];
      if (kMode == kResidual) o += vt::to_f(res[m * Cout + col]);
      if (kMode == kShortcut) o += sc_bias[col];
      out[m * Cout + col] = vt::from_f<T>(o);
    }
  }
}

template <typename T>
int launch(const void* x, int N, int H, int W, int Cin, int Cout,
           const float* eff_scale, const float* eff_bias, const void* wmat,
           const float* bias, const void* res, int Cres, const void* wsc,
           const float* sc_bias, void* out, cudaStream_t st) {
  const int64_t M = (int64_t)N * H * W;
  dim3 grid((unsigned)((M + kBM - 1) / kBM), (Cout + kBN - 1) / kBN);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(wmat);
  const T* rt = static_cast<const T*>(res);
  const T* st_w = static_cast<const T*>(wsc);
  T* ot = static_cast<T*>(out);
  if (wsc != nullptr)
    conv3x3_kernel<T, kShortcut><<<grid, kThreads, 0, st>>>(
        xt, N, H, W, Cin, Cout, eff_scale, eff_bias, wt, bias, rt, Cres, st_w,
        sc_bias, ot);
  else if (res != nullptr)
    conv3x3_kernel<T, kResidual><<<grid, kThreads, 0, st>>>(
        xt, N, H, W, Cin, Cout, eff_scale, eff_bias, wt, bias, rt, Cres,
        nullptr, nullptr, ot);
  else
    conv3x3_kernel<T, kPlain><<<grid, kThreads, 0, st>>>(
        xt, N, H, W, Cin, Cout, eff_scale, eff_bias, wt, bias, nullptr, 0,
        nullptr, nullptr, ot);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N,H,W,Cin) fp32; eff_scale/eff_bias (N,Cin) fp32; wmat (9*Cin, Cout)
// fp32; bias (Cout) fp32; res (N,H,W,Cres) fp32 or null; wsc (Cres, Cout)
// fp32, or null for a plain residual (then Cres == Cout); sc_bias (Cout)
// fp32 with wsc; out (N,H,W,Cout) fp32.
VT_EXPORT int vt_gn_silu_conv3x3(const void* x, int dtype, int N, int H,
                                 int W, int Cin, int Cout,
                                 const float* eff_scale,
                                 const float* eff_bias, const void* wmat,
                                 const float* bias, const void* res, int Cres,
                                 const void* wsc, const float* sc_bias,
                                 void* out, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  if (res != nullptr && wsc == nullptr && Cres != Cout)
    return (int)cudaErrorInvalidValue;
  if (wsc != nullptr && (res == nullptr || sc_bias == nullptr || Cres <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32)
    return launch<float>(x, N, H, W, Cin, Cout, eff_scale, eff_bias, wmat,
                         bias, res, Cres, wsc, sc_bias, out, st);
  return (int)cudaErrorInvalidValue;
}
