// Kernel A's plan on the device, shared by its two passes
// (groupnorm_silu_vec.cu) and by kernel F, the GroupNorm(+SiLU) backward
// (groupnorm_silu_bwd.cu), which walks the same plan: the wrapper's
// ops/normalization.py::gn_plan sizes the grid, geo() places a thread in it,
// Vec loads and stores one 16-byte vector of channels (or one element), and
// check_plan refuses a plan the kernels cannot take.
#pragma once

#include "common.cuh"

namespace vt {
namespace gn {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // loads in flight a thread
// blocks an SM must hold at once: the wrapper sizes the grid to one wave of
// this many (ops/normalization.py::GN_BLOCKS_PER_SM)
constexpr int kMinBlocksPerSm = 4;

// V consecutive elements at p, as fp32; y stored back in T.
template <typename T, int V>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  __device__ __forceinline__ static void load(const T* p, float (&v)[1]) {
    v[0] = vt::to_f(p[0]);
  }
  __device__ __forceinline__ static void store(T* p, const float (&v)[1]) {
    p[0] = vt::from_f<T>(v[0]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Vec<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Where a thread sits in the plan: block (p, n, z) reads rows
// [p * rows, min((p + 1) * rows, S)) of sample n, vectors
// [slot0, slot0 + nslot) of each row; thread (row, lane) the rows
// row, row + rows_par, ... of that span at vector slot0 + lane.
struct Geo {
  int strip;     // vectors a block's strip may hold
  int rows_par;  // rows read side by side
  int slot0, nslot;
  int lane, row;
  bool active;
  long long r0, r1;
};

template <int V>
__device__ __forceinline__ Geo geo(long long S, int C, int rows) {
  Geo g;
  const int slots = C / V;
  g.strip = slots < kThreads ? slots : kThreads;
  g.rows_par = kThreads / g.strip;
  g.slot0 = blockIdx.z * g.strip;
  g.nslot = min(g.strip, slots - g.slot0);
  g.lane = threadIdx.x % g.strip;
  g.row = threadIdx.x / g.strip;
  g.active = g.row < g.rows_par && g.lane < g.nslot;
  g.r0 = (long long)blockIdx.x * rows;
  g.r1 = min(g.r0 + rows, S);
  return g;
}

// The plan's checks, shared by every entry: vec is 1 or one 16-byte load
// (16 / itemsize elements; then C is a multiple of it and the pointers are
// 16-byte aligned), the blocks cover every row exactly once, and strips is
// the number of kThreads-vector strips a row takes.
inline int check_plan(int dtype, int N, long long S, int C, int vec,
                      int rows, int blocks, int strips, const void* a,
                      const void* b) {
  const int itemsize = dtype == vt::kF32 ? 4 : dtype == vt::kBF16 ? 2 : 0;
  if (itemsize == 0 || N <= 0 || N > 65535 || S <= 0 || C <= 0 || rows <= 0 ||
      blocks <= 0)
    return 1;
  if ((long long)blocks * rows < S || (long long)(blocks - 1) * rows >= S)
    return 1;
  if (vec != 1 && (vec != 16 / itemsize || C % vec != 0 ||
                   reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
                   reinterpret_cast<uintptr_t>(b) % 16 != 0))
    return 1;
  const int slots = C / vec;
  const int strip = slots < kThreads ? slots : kThreads;
  if (strips != (slots + strip - 1) / strip || strips > 65535) return 1;
  return (long long)blocks * strips > (1LL << 30);
}

}  // namespace gn
}  // namespace vt
