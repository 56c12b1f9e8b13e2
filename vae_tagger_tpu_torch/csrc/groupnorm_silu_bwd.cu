// Kernel F for Hopper's memory system: the backward of GroupNorm(+SiLU) over
// NHWC activations, in two launches -- the reduce pass, which also folds its
// sums into every gradient but dx, and the apply pass -- on a grid of its own
// in kernel A's span and strip rules (gn_plan.cuh).
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
//   reduce pass: P[n, c] = sum over the rows of dz * x, Q[n, c] = sum of dz,
//     then the fold, rstd = rsqrt(meansq - mean^2 + eps) and p_net = P -
//     mean * Q per (n, c) with its group's statistics:
//     dscale[c] = sum_n rstd * p_net, dbias[c] = sum_n Q,
//     d_rstd[n, g] = sum_{c in g} scale * p_net, r3 = rstd^3,
//     dmean = -sum_{c in g} Q * es + r3 * mean * d_rstd,
//     dmeansq = -r3 * d_rstd / 2;
//   apply pass: dx = dz * es[n, c] + ca[n, c] + cb[n, c] * x, ca = dmean /
//     count and cb = 2 dmeansq / count (count = S * C / G) carrying the
//     statistics' term.  Where the statistics are an input of their own (the
//     height slabs' form) dmean and dmeansq are outputs and dx = dz * es.
// fp32 inside, one cast of dx.  The plain version is ops/normalization.py::
// group_norm_silu_backward_plain.
//
// Bound on this card: bytes.  x and dAct read once and dx written once are
// three element accesses (6 bytes an element in bf16); the kernel makes
// five.  Every dx needs ca and cb, which need every row of the sample, and a
// sample's x and dAct (up to 800 MB at the 1024^2 sites) do not stay on the
// chip, so the apply pass reads them a second time.  The design makes the
// two reads as cheap as the card allows:
//
// - The grid is F's own (ops/normalization.py::_f_plan): one wave at the
//   blocks an SM these two kernels keep resident, which the wrapper reads
//   from the runtime (vt_gn_bwd_blocks_per_sm), in A's rules: one block
//   streams a contiguous span of whole rows of one sample, each thread one
//   fixed vector of V channels (one 16-byte load: 8 bf16 or 4 fp32, else
//   V = 1) with its sums and its vector's es/eb in registers.
// - The bytes in flight sit in shared memory, not in registers: each thread
//   streams its own rows of x and dAct through a ring of kStages slots
//   (16-byte cp.async, one commit group a row) and reads back only the slots
//   it filled, so no barrier is needed; kStages rows of both a thread are in
//   flight, 32 KB a block, about 96 KB an SM at three blocks.  (V = 1 -- C
//   not a multiple of the vector, or a misaligned view -- loads directly.)
// - The fold runs inside the reduce pass.  Each block folds its rows' sums
//   in shared memory, in row order, into one (P, Q) pair a channel of its
//   strip, written [n][span][channel].  Then three arrival counters
//   (release and acquire fences, as in kernel A) pick the blocks that fold
//   further, each in a fixed order: the last block of a group of
//   group_spans spans sums the group's spans; the last group of a sample
//   sums the sample's groups, then its channels into its groups' terms,
//   and writes ca and cb (or dmean and dmeansq) and the sample's row of
//   (rstd * p_net, Q); the last sample sums those rows into dscale and
//   dbias.  Two levels, because one block summing every span of a sample
//   alone (up to 396 spans of 512 channels, 1.6 MB, at the decoder's 512^2
//   site) serializes the end of the pass.  No launch runs between the
//   passes, and no float atomics: results repeat bit for bit.
// - The apply pass walks each span from its last row to its first.  With a
//   one-wave grid every span's last rows are the reduce pass's last reads,
//   the ones still in the 50 MB L2, and they are the apply pass's first; dx
//   is stored evict-first so that it does not push them out.
// - The SiLU's derivative: fp32 takes expf and an IEEE division (its gate is
//   1e-5); bf16 the SFU forms (__expf, __fdividef, as kernel A), since at 4
//   bytes an element the reduce pass would otherwise issue nearly as many
//   instructions as the SM can.
#include "gn_plan.cuh"

#include <type_traits>

namespace {

using vt::gn::Geo;
using vt::gn::Vec;
using vt::gn::check_plan;
using vt::gn::geo;
using vt::gn::kThreads;
constexpr int kStages = 4;  // rows of x and of dAct in flight a thread
// at most 80 registers a thread; the wrapper sizes the grid to the blocks
// that do stay resident (vt_gn_bwd_blocks_per_sm)
constexpr int kMinBlocksF = 3;

// Dynamic shared memory of a launch: the ring of 16-byte slots (V > 1); the
// reduce pass then reuses it for its per-thread sums.
template <int V>
constexpr int smem_bytes(bool reduce) {
  const int ring = V > 1 ? kStages * 2 * kThreads * 16 : 0;
  const int sums = reduce ? 2 * kThreads * V * 4 : 0;
  return ring > sums ? ring : sums;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

// dx's stores: evict-first, so that dx does not push out of L2 the rows of
// x and dAct that the apply pass has yet to read
template <typename T>
__device__ __forceinline__ void store_evict_first(T* p, const float (&v)[1]) {
  Vec<T, 1>::store(p, v);
}

__device__ __forceinline__ void store_evict_first(__nv_bfloat16* p,
                                                  const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

__device__ __forceinline__ void store_evict_first(float* p,
                                                  const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

// One thread's rows first, first + step, ... (cnt of them) of x and dAct,
// in that order or reversed: through the thread's ring slots for V > 1,
// loaded directly for V = 1.
template <typename T, int V>
struct Rows {
  const T* xs;
  const T* ds;
  uint4* ring;  // this thread's slot of stage s, tensor t: ring[(2s+t) kThreads]
  long long first, step, C;
  int cnt;
  bool reverse;

  // element offset of the k-th row walked
  __device__ __forceinline__ long long offset(int k) const {
    return (first + (reverse ? cnt - 1 - k : k) * step) * C;
  }

  __device__ __forceinline__ void issue(int k) {
    if (k < cnt) {
      const long long o = offset(k);
      uint4* s = ring + 2 * (k % kStages) * kThreads;
      cp_async16(s, xs + o);
      cp_async16(s + kThreads, ds + o);
    }
    cp_async_commit();  // one group a row, empty past the last
  }

  __device__ __forceinline__ void start() {
    if constexpr (V > 1) {
#pragma unroll
      for (int k = 0; k < kStages; ++k) issue(k);
    }
  }

  // the k-th row's x and dAct in fp32; its slots then take row k + kStages
  __device__ __forceinline__ void get(int k, float (&v)[V], float (&d)[V]) {
    if constexpr (V > 1) {
      cp_async_wait<kStages - 1>();  // groups 0..k have landed
      const uint4* s = ring + 2 * (k % kStages) * kThreads;
      unpack(s[0], v);
      unpack(s[kThreads], d);
      issue(k + kStages);
    } else {
      const long long o = offset(k);
      Vec<T, 1>::load(xs + o, v);
      Vec<T, 1>::load(ds + o, d);
    }
  }
};

// the rows thread (row, lane) of the plan walks in its block's span
__device__ __forceinline__ int rows_of(const Geo& g) {
  const long long r = g.r1 - g.r0 - g.row;
  return g.active && r > 0 ? (int)((r + g.rows_par - 1) / g.rows_par) : 0;
}

// d silu(z) / dz times dAct, z from x and the effective affine (or dAct)
template <typename T, bool kSilu>
__device__ __forceinline__ float dz_of(float x, float d, float sc, float bi) {
  if constexpr (kSilu) {
    const float z = x * sc + bi;
    float s;
    if constexpr (std::is_same<T, float>::value)
      s = 1.0f / (1.0f + expf(-z));
    else
      s = __fdividef(1.0f, 1.0f + __expf(-z));
    return d * s * (1.0f + z * (1.0f - s));
  } else {
    return d;
  }
}

// What the reduce pass folds its sums with, and where the fold goes.
struct Fold {
  const float* mean;    // (N, G) fp32
  const float* meansq;  // (N, G) fp32
  const float* scale;   // (C,) fp32, the GroupNorm scale
  float eps;
  float count;          // S * C / G: a group's elements
  int group_spans;      // spans a group folds
  float2* partial;      // (N, spans, C) scratch: a block's (P, Q)
  float2* group_sums;   // (N, groups, C) scratch: a group's (P, Q)
  float2* terms;        // (N, C) scratch: (scale * p_net, Q * es)
  float2* sample_rows;  // (N, C) scratch: (rstd * p_net, Q)
  // N * groups + N + 1 counters, 0 on entry and left 0: one a (sample,
  // group), one a sample, one over the samples
  unsigned* arrivals;
  float* dscale;        // (C,)
  float* dbias;         // (C,)
  float* ca;            // (N, C), the statistics' term of dx, or null
  float* cb;
  float* dmean;         // (N, G), where ca and cb are null
  float* dmeansq;
};

// Whether this block is the last of ``expected`` to arrive on *counter, for
// every thread of the block: release fence before the count, acquire fence
// after it, as kernel A's stats pass.
__device__ __forceinline__ bool arrive_last(unsigned* counter,
                                            unsigned expected, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1u) == expected - 1;
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// The (P, Q) pairs of rows [b0, b1) of a (rows, C) array at channel c,
// summed in row order
__device__ __forceinline__ float2 sum_rows(const float2* a, int C, int c,
                                           int b0, int b1) {
  float sp = 0.f, sq = 0.f;
#pragma unroll 8
  for (int b = b0; b < b1; ++b) {
    const float2 v = __ldcg(a + (long long)b * C + c);
    sp += v.x;
    sq += v.y;
  }
  return make_float2(sp, sq);
}

// The last block of sample n: P and Q a channel (its groups in order), the
// sample's row of (rstd * p_net, Q), then its groups' ca and cb (or dmean
// and dmeansq).
__device__ void fold_sample(int n, int C, int G, int groups,
                            const float* __restrict__ es, const Fold& f) {
  const int reps = C / G;
  const float2* gn = f.group_sums + (long long)n * groups * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float2 pq = sum_rows(gn, C, c, 0, groups);
    const int k = n * G + c / reps;
    const float mean = f.mean[k];
    const float rstd = rsqrtf(f.meansq[k] - mean * mean + f.eps);
    const float p_net = pq.x - mean * pq.y;
    const long long nc = (long long)n * C + c;
    f.sample_rows[nc] = make_float2(rstd * p_net, pq.y);
    f.terms[nc] = make_float2(f.scale[c] * p_net, pq.y * es[nc]);
  }
  __syncthreads();  // the block's terms, before its groups read them
  for (int grp = threadIdx.x; grp < G; grp += kThreads) {
    const int k = n * G + grp;
    const float mean = f.mean[k];
    const float rstd = rsqrtf(f.meansq[k] - mean * mean + f.eps);
    const long long c0 = (long long)n * C + (long long)grp * reps;
    float d_rstd = 0.f, qes = 0.f;
    for (int i = 0; i < reps; ++i) {
      const float2 t = f.terms[c0 + i];
      d_rstd += t.x;
      qes += t.y;
    }
    const float r3 = rstd * rstd * rstd;
    const float dmean = -qes + r3 * mean * d_rstd;
    const float dmeansq = -0.5f * r3 * d_rstd;
    if (f.ca != nullptr) {
      const float a = dmean / f.count, b = 2.0f * dmeansq / f.count;
      for (int i = 0; i < reps; ++i) {
        f.ca[c0 + i] = a;
        f.cb[c0 + i] = b;
      }
    } else {
      f.dmean[k] = dmean;
      f.dmeansq[k] = dmeansq;
    }
  }
}

template <typename T, int V, bool kSilu>
__global__ void __launch_bounds__(kThreads, kMinBlocksF)
gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dact,
                     long long S, int C, int G, int rows,
                     const float* __restrict__ es,
                     const float* __restrict__ eb, Fold f) {
  extern __shared__ uint4 smem[];
  __shared__ bool last;
  const int n = blockIdx.y;
  const Geo g = geo<V>(S, C, rows);

  // 1. this thread's rows, in order
  float p[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) p[j] = q[j] = 0.f;
  const int cnt = rows_of(g);
  if (cnt > 0) {
    const int c0 = (g.slot0 + g.lane) * V;
    const long long off = (long long)n * S * C + c0;
    Rows<T, V> rs{x + off, dact + off, smem + threadIdx.x, g.r0 + g.row,
                  g.rows_par, C, cnt, false};
    rs.start();
    float sc[V], bi[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sc[j] = es[(long long)n * C + c0 + j];
      bi[j] = eb[(long long)n * C + c0 + j];
    }
    for (int k = 0; k < cnt; ++k) {
      float v[V], d[V];
      rs.get(k, v, d);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float dz = dz_of<T, kSilu>(v[j], d[j], sc[j], bi[j]);
        p[j] += dz * v[j];
        q[j] += dz;
      }
    }
  }
  if constexpr (V > 1) cp_async_wait<0>();
  __syncthreads();  // every thread past its rows: the ring holds the sums

  // thread t = (row, lane)'s sums sit at [t * V, (t + 1) * V): row-major
  // over (row, channel of the strip)
  float* red_p = reinterpret_cast<float*>(smem);
  float* red_q = red_p + kThreads * V;
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
      f.partial + ((long long)n * gridDim.x + blockIdx.x) * C + g.slot0 * V;
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    float sp = 0.f, sq = 0.f;
    for (int row = 0; row < g.rows_par; ++row) {
      sp += red_p[row * width + i];
      sq += red_q[row * width + i];
    }
    out[i] = make_float2(sp, sq);
  }

  // 3. the fold, in three arrivals: the last block of a group of spans
  // (every strip) sums the group's spans in order, the last group of the
  // sample sums the groups in order and folds the sample, the last sample
  // sums the samples' rows in order
  const int spans = gridDim.x, N = gridDim.y;
  const int groups = (spans + f.group_spans - 1) / f.group_spans;
  const int grp = blockIdx.x / f.group_spans;
  const int b0 = grp * f.group_spans;
  const int b1 = min(b0 + f.group_spans, spans);
  unsigned* group_count = f.arrivals + (long long)n * groups + grp;
  if (!arrive_last(group_count, (b1 - b0) * gridDim.z, &last)) return;
  const float2* pn = f.partial + (long long)n * spans * C;
  float2* gs = f.group_sums + ((long long)n * groups + grp) * C;
  for (int c = threadIdx.x; c < C; c += kThreads)
    gs[c] = sum_rows(pn, C, c, b0, b1);
  if (threadIdx.x == 0) *group_count = 0u;  // every block of it arrived

  unsigned* sample_count = f.arrivals + (long long)N * groups + n;
  if (!arrive_last(sample_count, groups, &last)) return;
  fold_sample(n, C, G, groups, es, f);
  if (threadIdx.x == 0) *sample_count = 0u;

  unsigned* all_count = f.arrivals + (long long)N * groups + N;
  if (!arrive_last(all_count, N, &last)) return;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float ds = 0.f, db = 0.f;
    for (int m = 0; m < N; ++m) {
      const float2 v = __ldcg(f.sample_rows + (long long)m * C + c);
      ds += v.x;
      db += v.y;
    }
    f.dscale[c] = ds;
    f.dbias[c] = db;
  }
  if (threadIdx.x == 0) *all_count = 0u;
}

template <typename T, int V, bool kSilu>
__global__ void __launch_bounds__(kThreads, kMinBlocksF)
gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dact,
                    long long S, int C, int rows,
                    const float* __restrict__ es,
                    const float* __restrict__ eb,
                    const float* __restrict__ ca,
                    const float* __restrict__ cb, T* __restrict__ dx) {
  extern __shared__ uint4 smem[];
  const int n = blockIdx.y;
  const Geo g = geo<V>(S, C, rows);
  const int cnt = rows_of(g);
  if (cnt == 0) return;
  const int c0 = (g.slot0 + g.lane) * V;
  const long long off = (long long)n * S * C + c0;
  T* os = dx + off;
  // the span from its last row: the reduce pass's last reads, in L2
  Rows<T, V> rs{x + off, dact + off, smem + threadIdx.x, g.r0 + g.row,
                g.rows_par, C, cnt, true};
  rs.start();
  float sc[V], bi[V], a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long k = (long long)n * C + c0 + j;
    sc[j] = es[k];
    bi[j] = eb[k];
    a[j] = ca == nullptr ? 0.f : ca[k];
    b[j] = cb == nullptr ? 0.f : cb[k];
  }
  for (int k = 0; k < cnt; ++k) {
    float v[V], d[V];
    rs.get(k, v, d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dz = dz_of<T, kSilu>(v[j], d[j], sc[j], bi[j]);
      d[j] = dz * sc[j] + a[j] + b[j] * v[j];
    }
    store_evict_first(os + rs.offset(k), d);
  }
}

// The kernels of one (dtype, vector, SiLU) variant.
template <typename T_, int V, bool kSilu_>
struct Variant {
  using T = T_;
  static constexpr int kVec = V;
  static constexpr bool kSilu = kSilu_;
};

template <typename T, int V, typename Fn>
void with_silu(int silu, Fn&& fn) {
  if (silu)
    fn(Variant<T, V, true>{});
  else
    fn(Variant<T, V, false>{});
}

// fn(Variant<...>{}) for the variant of (dtype, vec, silu)
template <typename Fn>
void dispatch(int dtype, int vec, int silu, Fn&& fn) {
  if (dtype == vt::kF32) {
    if (vec == 1)
      with_silu<float, 1>(silu, fn);
    else
      with_silu<float, 4>(silu, fn);
  } else {
    if (vec == 1)
      with_silu<__nv_bfloat16, 1>(silu, fn);
    else
      with_silu<__nv_bfloat16, 8>(silu, fn);
  }
}

bool known(int dtype, int vec) {
  return (dtype == vt::kF32 && (vec == 1 || vec == 4)) ||
         (dtype == vt::kBF16 && (vec == 1 || vec == 8));
}

}  // namespace

// The blocks an SM that both passes of a variant keep resident at once (the
// fewer of the two), from the CUDA runtime; the wrapper sizes F's grid to
// one wave of them.  *out > 0 on success.
VT_EXPORT int vt_gn_bwd_blocks_per_sm(int dtype, int vec, int silu,
                                      int* out) {
  if (out == nullptr || !known(dtype, vec)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  dispatch(dtype, vec, silu, [&](auto var) {
    using Var = decltype(var);
    using T = typename Var::T;
    int r = 0, a = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &r, gn_bwd_reduce_kernel<T, Var::kVec, Var::kSilu>, kThreads,
        smem_bytes<Var::kVec>(true));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &a, gn_bwd_apply_kernel<T, Var::kVec, Var::kSilu>, kThreads,
          smem_bytes<Var::kVec>(false));
    *out = r < a ? r : a;
  });
  if (err == cudaSuccess && *out <= 0) err = cudaErrorInvalidConfiguration;
  return (int)err;
}

// Reduce pass and fold, one launch.  x and dAct (N, S, C) in the same dtype;
// es, eb (N, C), mean, meansq (N, G) and scale (C,) fp32; the plan (vec,
// rows, blocks, strips) checked by check_plan (for vec > 1 both 16-byte
// aligned).  Writes dscale and dbias (C,), and either ca and cb (N, C) or
// dmean and dmeansq (N, G): exactly one of the two pairs is given.
// The fold sums group_spans spans a group.  Scratch, float2 (8-byte
// aligned): partial N * blocks * C, group_sums N * groups * C (groups =
// ceil(blocks / group_spans)), terms and sample_rows N * C each; arrivals
// N * groups + N + 1 unsigned counters, 0 on entry and left 0.
VT_EXPORT int vt_gn_bwd_reduce(const void* x, const void* dact, int dtype,
                               int N, long long S, int C, int G, int vec,
                               int rows, int blocks, int strips,
                               const float* es, const float* eb,
                               const float* mean, const float* meansq,
                               const float* scale, float eps, int silu,
                               int group_spans, void* partial,
                               void* group_sums, void* terms,
                               void* sample_rows, void* arrivals,
                               float* dscale, float* dbias,
                               float* ca, float* cb, float* dmean,
                               float* dmeansq, void* stream) {
  const bool stats_term = ca != nullptr && cb != nullptr;
  const bool stats_out = dmean != nullptr && dmeansq != nullptr;
  if (es == nullptr || eb == nullptr || mean == nullptr ||
      meansq == nullptr || scale == nullptr || partial == nullptr ||
      group_sums == nullptr || terms == nullptr || sample_rows == nullptr ||
      arrivals == nullptr || group_spans <= 0 ||
      dscale == nullptr || dbias == nullptr || stats_term == stats_out ||
      (ca == nullptr) != (cb == nullptr) ||
      (dmean == nullptr) != (dmeansq == nullptr) || G <= 0 || C % G != 0 ||
      !known(dtype, vec) ||
      check_plan(dtype, N, S, C, vec, rows, blocks, strips, x, dact))
    return (int)cudaErrorInvalidValue;
  const Fold f{mean,
               meansq,
               scale,
               eps,
               (float)(S * (C / G)),
               group_spans,
               static_cast<float2*>(partial),
               static_cast<float2*>(group_sums),
               static_cast<float2*>(terms),
               static_cast<float2*>(sample_rows),
               static_cast<unsigned*>(arrivals),
               dscale,
               dbias,
               ca,
               cb,
               dmean,
               dmeansq};
  const dim3 grid(blocks, N, strips);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dispatch(dtype, vec, silu, [&](auto var) {
    using Var = decltype(var);
    using T = typename Var::T;
    gn_bwd_reduce_kernel<T, Var::kVec, Var::kSilu>
        <<<grid, kThreads, smem_bytes<Var::kVec>(true), st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dact), S, C, G, rows,
        es, eb, f);
  });
  return (int)cudaGetLastError();
}

// Apply pass: dx = dz * es + ca + cb * x in the same plan, each span from
// its last row; ca and cb (N * C fp32) both given or both null (then dx =
// dz * es).
VT_EXPORT int vt_gn_bwd_apply(const void* x, const void* dact, int dtype,
                              int N, long long S, int C, int vec, int rows,
                              int blocks, int strips, const float* es,
                              const float* eb, const float* ca,
                              const float* cb, int silu, void* dx,
                              void* stream) {
  if (es == nullptr || eb == nullptr || dx == nullptr ||
      (ca == nullptr) != (cb == nullptr) || !known(dtype, vec) ||
      check_plan(dtype, N, S, C, vec, rows, blocks, strips, x, dact) ||
      check_plan(dtype, N, S, C, vec, rows, blocks, strips, x, dx))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, N, strips);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dispatch(dtype, vec, silu, [&](auto var) {
    using Var = decltype(var);
    using T = typename Var::T;
    gn_bwd_apply_kernel<T, Var::kVec, Var::kSilu>
        <<<grid, kThreads, smem_bytes<Var::kVec>(false), st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dact), S, C, rows,
        es, eb, ca, cb, static_cast<T*>(dx));
  });
  return (int)cudaGetLastError();
}
