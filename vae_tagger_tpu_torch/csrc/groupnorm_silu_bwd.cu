// Kernel F for Hopper's memory system: the backward of GroupNorm(+SiLU) over
// NHWC activations, in two launches -- the reduce pass and the apply pass --
// in kernel A's plan (gn_plan.cuh).
//
// Replaces no Pallas kernel.  On the TPU the JAX package's custom VJPs
// (vae_tagger_tpu/ops/conv.py::_make_fused's bwd, ops/normalization.py::
// _make_group_norm_silu's bwd) take jax.vjp of the XLA reference inside the
// jitted train step, and XLA fuses the GroupNorm/SiLU backward there; this
// kernel is that fused backward.  Its callers are the backward functions of
// ops/normalization.py and ops/conv.py (group_norm_silu_vjp,
// gn_silu_conv3x3_vjp).
//
// Function: with z = x * es[n, c] + eb[n, c] in fp32 (es, eb: the effective
// affine of kernel A's statistics) and dAct the cotangent of silu(z), or of
// z without the SiLU,
//   dz = dAct * s * (1 + z * (1 - s)), s = sigmoid(z)   (dz = dAct);
//   reduce pass: P[n, c] = sum over the rows of dz * x, Q[n, c] = sum of dz;
//   apply pass:  dx = dz * es[n, c] + ca[n, c] + cb[n, c] * x.
// Between the passes the wrapper (ops/normalization.py::
// group_norm_silu_backward) folds P and Q into the gradients of the GroupNorm
// scale and bias, and of the statistics, in plain torch on (N, C) and (N, G)
// tensors; ca = dmean / count and cb = 2 dmeansq / count carry the
// statistics' term into dx (null where the statistics are an input of their
// own, the height slabs' form: dx = dz * es).  fp32 inside, one cast of dx.
//
// Bound on this card: bytes.  The reduce pass reads x and dAct, the apply
// pass reads both again and writes dx: five element accesses (10 bytes an
// element in bf16).  The design follows kernel A's:
//
// - One block streams a contiguous span of whole rows of one sample; each
//   thread owns one fixed vector of V channels (one 16-byte load: 8 bf16 or
//   4 fp32, else V = 1) and keeps its sums, and its vector's es/eb, in
//   registers.  Two loads of x and two of dAct in flight a thread (kUnrollF):
//   the registers of four of each would not fit beside the sums.
// - The reduce pass is one launch.  Each block folds its rows' sums in
//   shared memory, in row order, into one (P, Q) pair per channel of its
//   strip and writes them to a partial buffer laid out [n][span][channel];
//   the block that arrives last on its sample's counter (release and
//   acquire fences, as in kernel A) folds the sample's spans in order and
//   sets the counter back to 0.  No float atomics: results repeat bit for
//   bit.
// - The SiLU's derivative takes expf and an IEEE division, not kernel A's
//   SFU forms: the fp32 gate is 1e-5 here, and at 10 bytes an element the
//   pass has the instructions to spare.
#include "gn_plan.cuh"

namespace {

using vt::gn::Geo;
using vt::gn::Vec;
using vt::gn::check_plan;
using vt::gn::geo;
using vt::gn::kThreads;
constexpr int kUnrollF = 2;  // rows of x and of dAct in flight a thread
// blocks an SM: 128 registers a thread for the two passes' vectors (the
// plan's grid of GN_BLOCKS_PER_SM blocks an SM then takes two waves)
constexpr int kMinBlocksF = 2;

// d silu(z) / dz times dAct, z from x and the effective affine (or dAct)
template <bool kSilu>
__device__ __forceinline__ float dz_of(float x, float d, float sc, float bi) {
  if (!kSilu) return d;
  const float z = x * sc + bi;
  const float s = 1.0f / (1.0f + expf(-z));
  return d * s * (1.0f + z * (1.0f - s));
}

template <typename T, int V, bool kSilu>
__global__ void __launch_bounds__(kThreads, kMinBlocksF)
gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dact,
                     long long S, int C, int rows,
                     const float* __restrict__ es,
                     const float* __restrict__ eb,
                     float2* __restrict__ partial,
                     unsigned* __restrict__ arrivals,
                     float* __restrict__ p_out, float* __restrict__ q_out) {
  __shared__ float red_p[kThreads * V];
  __shared__ float red_q[kThreads * V];
  __shared__ bool last;
  const int n = blockIdx.y;
  const Geo g = geo<V>(S, C, rows);

  // 1. this thread's rows
  float p[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) p[j] = q[j] = 0.f;
  if (g.active) {
    const int c0 = (g.slot0 + g.lane) * V;
    float sc[V], bi[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sc[j] = es[(long long)n * C + c0 + j];
      bi[j] = eb[(long long)n * C + c0 + j];
    }
    const long long off = (long long)n * S * C + c0;
    const T* xs = x + off;
    const T* ds = dact + off;
    const long long step = g.rows_par;
    long long r = g.r0 + g.row;
    for (; r + (kUnrollF - 1) * step < g.r1; r += kUnrollF * step) {
      float v[kUnrollF][V], d[kUnrollF][V];
#pragma unroll
      for (int u = 0; u < kUnrollF; ++u) {
        Vec<T, V>::load(xs + (r + u * step) * C, v[u]);
        Vec<T, V>::load(ds + (r + u * step) * C, d[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnrollF; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float dz = dz_of<kSilu>(v[u][j], d[u][j], sc[j], bi[j]);
          p[j] += dz * v[u][j];
          q[j] += dz;
        }
    }
    for (; r < g.r1; r += step) {
      float v[V], d[V];
      Vec<T, V>::load(xs + r * C, v);
      Vec<T, V>::load(ds + r * C, d);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float dz = dz_of<kSilu>(v[j], d[j], sc[j], bi[j]);
        p[j] += dz * v[j];
        q[j] += dz;
      }
    }
  }
  // thread t = (row, lane)'s sums sit at [t * V, (t + 1) * V): row-major
  // over (row, channel of the strip)
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red_p[threadIdx.x * V + j] = p[j];
    red_q[threadIdx.x * V + j] = q[j];
  }
  __syncthreads();

  // 2. one (P, Q) pair per channel of this strip, the rows in order
  const int width = g.strip * V;  // one row of red_p
  const int cells = g.nslot * V;  // channels of this strip
  float2* out =
      partial + ((long long)n * gridDim.x + blockIdx.x) * C + g.slot0 * V;
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    float sp = 0.f, sq = 0.f;
    for (int row = 0; row < g.rows_par; ++row) {
      sp += red_p[row * width + i];
      sq += red_q[row * width + i];
    }
    out[i] = make_float2(sp, sq);
  }

  // 3. arrival: the last block of the sample folds
  __threadfence();  // release: this thread's partials before the count
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(arrivals + n, 1u) == gridDim.x * gridDim.z - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // acquire: every block's partials after the count

  // 4. the fold: a thread a channel, the spans in order (loads unrolled, so
  // several are in flight)
  const float2* pn = partial + (long long)n * gridDim.x * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float sp = 0.f, sq = 0.f;
#pragma unroll 8
    for (int b = 0; b < (int)gridDim.x; ++b) {
      const float2 v = __ldcg(pn + (long long)b * C + c);
      sp += v.x;
      sq += v.y;
    }
    p_out[(long long)n * C + c] = sp;
    q_out[(long long)n * C + c] = sq;
  }
  if (threadIdx.x == 0) arrivals[n] = 0u;  // every block of n has arrived
}

template <typename T, int V, bool kSilu>
__global__ void __launch_bounds__(kThreads, kMinBlocksF)
gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dact,
                    long long S, int C, int rows,
                    const float* __restrict__ es,
                    const float* __restrict__ eb,
                    const float* __restrict__ ca,
                    const float* __restrict__ cb, T* __restrict__ dx) {
  const int n = blockIdx.y;
  const Geo g = geo<V>(S, C, rows);
  if (!g.active) return;
  const int c0 = (g.slot0 + g.lane) * V;
  float sc[V], bi[V], a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long k = (long long)n * C + c0 + j;
    sc[j] = es[k];
    bi[j] = eb[k];
    a[j] = ca == nullptr ? 0.f : ca[k];
    b[j] = cb == nullptr ? 0.f : cb[k];
  }
  const long long off = (long long)n * S * C + c0;
  const T* xs = x + off;
  const T* ds = dact + off;
  T* os = dx + off;
  const long long step = g.rows_par;
  long long r = g.r0 + g.row;
  for (; r + (kUnrollF - 1) * step < g.r1; r += kUnrollF * step) {
    float v[kUnrollF][V], d[kUnrollF][V];
#pragma unroll
    for (int u = 0; u < kUnrollF; ++u) {
      Vec<T, V>::load(xs + (r + u * step) * C, v[u]);
      Vec<T, V>::load(ds + (r + u * step) * C, d[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnrollF; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float dz = dz_of<kSilu>(v[u][j], d[u][j], sc[j], bi[j]);
        d[u][j] = dz * sc[j] + a[j] + b[j] * v[u][j];
      }
      Vec<T, V>::store(os + (r + u * step) * C, d[u]);
    }
  }
  for (; r < g.r1; r += step) {
    float v[V], d[V];
    Vec<T, V>::load(xs + r * C, v);
    Vec<T, V>::load(ds + r * C, d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dz = dz_of<kSilu>(v[j], d[j], sc[j], bi[j]);
      d[j] = dz * sc[j] + a[j] + b[j] * v[j];
    }
    Vec<T, V>::store(os + r * C, d);
  }
}

template <typename T, int V>
void launch_reduce(const void* x, const void* dact, int N, long long S, int C,
                   int rows, int blocks, int strips, const float* es,
                   const float* eb, int silu, void* partial, void* arrivals,
                   float* p_out, float* q_out, cudaStream_t st) {
  const dim3 grid(blocks, N, strips);
  auto* xp = static_cast<const T*>(x);
  auto* dp = static_cast<const T*>(dact);
  auto* pp = static_cast<float2*>(partial);
  auto* ap = static_cast<unsigned*>(arrivals);
  if (silu)
    gn_bwd_reduce_kernel<T, V, true><<<grid, kThreads, 0, st>>>(
        xp, dp, S, C, rows, es, eb, pp, ap, p_out, q_out);
  else
    gn_bwd_reduce_kernel<T, V, false><<<grid, kThreads, 0, st>>>(
        xp, dp, S, C, rows, es, eb, pp, ap, p_out, q_out);
}

template <typename T, int V>
void launch_apply(const void* x, const void* dact, int N, long long S, int C,
                  int rows, int blocks, int strips, const float* es,
                  const float* eb, const float* ca, const float* cb, int silu,
                  void* dx, cudaStream_t st) {
  const dim3 grid(blocks, N, strips);
  auto* xp = static_cast<const T*>(x);
  auto* dp = static_cast<const T*>(dact);
  auto* op = static_cast<T*>(dx);
  if (silu)
    gn_bwd_apply_kernel<T, V, true><<<grid, kThreads, 0, st>>>(
        xp, dp, S, C, rows, es, eb, ca, cb, op);
  else
    gn_bwd_apply_kernel<T, V, false><<<grid, kThreads, 0, st>>>(
        xp, dp, S, C, rows, es, eb, ca, cb, op);
}

}  // namespace

// Reduce pass, one launch: p_out[n, c] = sum of dz * x, q_out[n, c] = sum of
// dz (N * C fp32 each).  partial: N * blocks * C float2 scratch; arrivals: N
// unsigned counters, 0 on entry and left 0.  x and dAct in the same dtype,
// the plan kernel A's (vec, rows, blocks, strips), both checked by
// check_plan (for vec > 1 both 16-byte aligned).
VT_EXPORT int vt_gn_bwd_reduce(const void* x, const void* dact, int dtype,
                               int N, long long S, int C, int vec, int rows,
                               int blocks, int strips, const float* es,
                               const float* eb, int silu, void* partial,
                               void* arrivals, float* p_out, float* q_out,
                               void* stream) {
  if (es == nullptr || eb == nullptr || partial == nullptr ||
      arrivals == nullptr || p_out == nullptr || q_out == nullptr ||
      check_plan(dtype, N, S, C, vec, rows, blocks, strips, x, dact))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32) {
    if (vec == 1)
      launch_reduce<float, 1>(x, dact, N, S, C, rows, blocks, strips, es, eb,
                              silu, partial, arrivals, p_out, q_out, st);
    else
      launch_reduce<float, 4>(x, dact, N, S, C, rows, blocks, strips, es, eb,
                              silu, partial, arrivals, p_out, q_out, st);
  } else {
    if (vec == 1)
      launch_reduce<__nv_bfloat16, 1>(x, dact, N, S, C, rows, blocks, strips,
                                      es, eb, silu, partial, arrivals, p_out,
                                      q_out, st);
    else
      launch_reduce<__nv_bfloat16, 8>(x, dact, N, S, C, rows, blocks, strips,
                                      es, eb, silu, partial, arrivals, p_out,
                                      q_out, st);
  }
  return (int)cudaGetLastError();
}

// Apply pass: dx = dz * es + ca + cb * x in the same plan; ca and cb (N * C
// fp32) both given or both null (then dx = dz * es).
VT_EXPORT int vt_gn_bwd_apply(const void* x, const void* dact, int dtype,
                              int N, long long S, int C, int vec, int rows,
                              int blocks, int strips, const float* es,
                              const float* eb, const float* ca,
                              const float* cb, int silu, void* dx,
                              void* stream) {
  if (es == nullptr || eb == nullptr || dx == nullptr ||
      (ca == nullptr) != (cb == nullptr) ||
      check_plan(dtype, N, S, C, vec, rows, blocks, strips, x, dact) ||
      check_plan(dtype, N, S, C, vec, rows, blocks, strips, x, dx))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32) {
    if (vec == 1)
      launch_apply<float, 1>(x, dact, N, S, C, rows, blocks, strips, es, eb,
                             ca, cb, silu, dx, st);
    else
      launch_apply<float, 4>(x, dact, N, S, C, rows, blocks, strips, es, eb,
                             ca, cb, silu, dx, st);
  } else {
    if (vec == 1)
      launch_apply<__nv_bfloat16, 1>(x, dact, N, S, C, rows, blocks, strips,
                                     es, eb, ca, cb, silu, dx, st);
    else
      launch_apply<__nv_bfloat16, 8>(x, dact, N, S, C, rows, blocks, strips,
                                     es, eb, ca, cb, silu, dx, st);
  }
  return (int)cudaGetLastError();
}
