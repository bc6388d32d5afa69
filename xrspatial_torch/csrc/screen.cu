// screen_hilo: the pair evaluation of the exact viewshed's interval screen.
//
// Replaces the TPU kernel xrspatial_tpu/kernels/pallas_screen.py::
// screen_hilo_pallas, which evaluates the scan body of
// xrspatial_tpu/kernels/viewshed_exact.py::_screen_scan.  For every target
// (a cell, in angle-sorted bucket order) it returns sound bounds (hi, lo) of
// the largest interpolated gradient among the candidate blockers of its
// bucket group: the whole global table, and per distance tier one window of
// nb = min(NB, nblk) blocks of E candidates starting at block
// r = min(rows[g, t], nblk - nb) of the block-leading (nblk, 13, E) table.
// That is the scan's window, not the Pallas kernel's superset of two
// nb-aligned blocks, so hi and lo equal the torch twin's
// (xrspatial_torch/kernels/screen.py::screen_hilo) bit for bit.  One
// template serves the float32 level-1 screen and the float64 level-2
// re-screen: the TPU ran level 2 in an XLA scan only for want of float64.
//
// Per pair (screen.py::screen_pairs):
//   maybe = al > a0w && al < a2w && key < kt_hi && idx != it
//   sure  = al > a0n && al < a2n && key < kt_lo && idx != it
//   d = al - a1e;  gi = g1 + d * (d < 0 ? -s01 : s21)
//   gi = min(max(gi, mn), mx)
//   hi = max(hi, maybe ? gi + tw : -inf);  lo = max(lo, sure ? gi - ts : -inf)
// The comparisons are strict, as written.  The product and the sum are
// written with __fmul_rn/__fadd_rn (__dmul_rn/__dadd_rn), so nvcc cannot
// contract them into an fma the twin does not have.  max and min return
// NaN when an operand is NaN, as torch.maximum/minimum and amax do; no NaN
// reaches them in practice (an invalid candidate has a0w = a0n = +inf and
// fails both cover tests; a valid one has finite fields; target angles
// are finite), and a pair that is neither maybe nor sure is skipped, which
// leaves both maxima as a max with -inf would.  hi and lo are never -0
// (tw, ts >= tg_abs > 0), so neither the order of the maxima nor a skipped
// pair that passes no test changes a bit.
//
// What bounds it: operations.  At the 1024^2 bench plan the level-1 plan
// holds 1.8e10 pairs; the first port makes 6 float compares on each, and
// 11 more (the subtract, the sign test, the product and sum, the clip, the
// two bands and the two maxima) on the few percent that pass a cover and
// key test: about 1.7 ms at 67 TFLOP/s.  The culled route evaluates only
// the pairs of the (warp, chunk) pairs it keeps, about an eighth of the
// plan's there, with 3 compares each, and the narrow cover's 3 and the 11
// on the pairs that pass the wide cover: about 0.2 ms at that rate
// (chip_smoke.py counts both from the kernel's counters), against ~88 MB
// of tables, targets and outputs moved in 0.03 ms.
//
// Two routes (kernels/cuda_screen.py::screen_hilo_cuda):
//
// screen_culled_kernel (route "culled", the default), redesigned for
// Hopper.  The first port issues at least 6 shared-memory loads a pair, and
// an SM issues about one a clock: that, not the compares, set its pace.
// - Three loads a pair, then fewer.  sure implies maybe: a0n = a0u + tau_c
//   >= a0u - tau_c = a0w, a2n = a2u - tau_c <= a2w (rounding is monotone),
//   kt_lo = key (1 - tau_k) <= kt_hi = key (1 + tau_k) for key >= 0, and an
//   invalid candidate has a0w = a0n = +inf (tests/test_torch_screen.py
//   pins it on the expanded tables).  So every pair is first held to the
//   wide cover and kt_hi only (a0w, a2w, key); the index, the narrow cover
//   and the interpolation fields are read only for the pairs that pass.
// - Each staged value serves several targets.  A thread owns kR = 4
//   consecutive targets, and reads the three fields of 4 candidates as
//   16-byte broadcast loads (two at float64): 3 loads for 16 pairs.
// - Angular chunk culling.  Both sides are sorted by angle: a tier's
//   candidates by centre angle (viewshed_exact._screen_cache's stable tier
//   re-sort of the angle argsort), the targets in bucket order.  A pre-pass
//   (screen_bounds_kernel) gives every 128-candidate chunk of every table
//   lo = min a0w and hi = max a2w over the candidates that can cover
//   anything (a0w < a2w, so no NaN and no invalid candidate counts).  A
//   pair passes the wide cover only if lo <= a0w < al < a2w <= hi, so a
//   block whose targets all lie at or below lo, or all at or above hi,
//   does not stage the chunk, and a warp whose targets do so skips it; no
//   pair there could pass, so no bit changes.
// - Staging that overlaps compute: the chunks a block keeps come in by
//   bulk copies (one per field row: 512 bytes at float32, 1024 at float64;
//   and the index row), issued by warp 0 into a double-buffered ring and
//   completed by mbarriers (tma.cuh), one chunk ahead of the arithmetic.
//   A block of 128 threads owns 512 targets of one group.
//
// screen_hilo_kernel (route "simple"), the first port, kept by name: one
// thread per target, a block of 256 targets of one group; the block stages
// chunks of 128 candidates (13 fields and the index) in shared memory by
// plain loads between two barriers, and every thread reads every field of
// every candidate it tests: 6 shared loads or more a pair.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kFields = 13;   // screen.py::F13, in this order
constexpr int kMaxTiers = 12;  // viewshed_exact._TIER_BOUNDS gives at most 12
constexpr int kThreads = 256;
constexpr int kChunk = 128;    // divides every E (a power of two >= 128) and Lg
enum { A0W, A0N, A2W, A2N, A1E, G1, S01, S21, MN, MX, TS, TW, KEY };

template <typename T>
struct Tiers {
  const T* stk[kMaxTiers];    // (nblk, 13, E)
  const int* idx[kMaxTiers];  // (nblk, E)
  int E[kMaxTiers], nblk[kMaxTiers], nb[kMaxTiers];
  long long boff[kMaxTiers];  // first chunk of each tier in the bounds
  int n;
};

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float ninf() { return -CUDART_INF_F; }
};

template <>
struct Ops<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double ninf() { return -CUDART_INF; }
};

// torch.maximum / torch.minimum: NaN when either operand is NaN
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

// The same in one instruction where the card has it (max.NaN / min.NaN,
// float32 only): NaN when either operand is NaN (the canonical NaN, where
// max_nan keeps the operand's; hi and lo hold no NaN in practice, see
// above), and a zero's sign only where both operands are zeros, which no
// bit of hi or lo depends on (gi + tw and gi - ts are never -0).
template <typename T>
__device__ __forceinline__ T max1(T a, T b) {
  return max_nan(a, b);
}
template <typename T>
__device__ __forceinline__ T min1(T a, T b) {
  return min_nan(a, b);
}
template <>
__device__ __forceinline__ float max1<float>(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
template <>
__device__ __forceinline__ float min1<float>(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) screen_hilo_kernel(
    const T* __restrict__ al, const T* __restrict__ klo,
    const T* __restrict__ khi, const int* __restrict__ it,
    const T* __restrict__ gstk, const int* __restrict__ gidx, int Lg,
    const Tiers<T> tiers, const int* __restrict__ rows, int T_per_group,
    T* __restrict__ hi_out, T* __restrict__ lo_out) {
  using O = Ops<T>;
  __shared__ T s_f[kFields][kChunk];
  __shared__ int s_i[kChunk];
  const int g = blockIdx.x;
  const int t = blockIdx.y * kThreads + threadIdx.x;
  const bool live = t < T_per_group;
  const long long k = (long long)g * T_per_group + t;
  T a = 0, kl = 0, kh = 0;
  int self = 0;
  if (live) {
    a = al[k];
    kl = klo[k];
    kh = khi[k];
    self = it[k];
  }
  T hi = O::ninf(), lo = O::ninf();

  // segment 0 is the global table (13, Lg), one block of Lg; segment
  // s > 0 the window of tier s - 1
  for (int s = 0; s <= tiers.n; ++s) {
    const T* base;
    const int* ibase;
    int E, len;
    if (s == 0) {
      base = gstk;
      ibase = gidx;
      E = Lg;
      len = Lg;
    } else {
      const int tt = s - 1;
      E = tiers.E[tt];
      const int nb = tiers.nb[tt];
      int r = rows[(long long)g * tiers.n + tt];
      r = r < tiers.nblk[tt] - nb ? r : tiers.nblk[tt] - nb;
      r = r > 0 ? r : 0;
      base = tiers.stk[tt] + (long long)r * kFields * E;
      ibase = tiers.idx[tt] + (long long)r * E;
      len = nb * E;
    }
    for (int c0 = 0; c0 < len; c0 += kChunk) {
      const int b = c0 / E, e0 = c0 - b * E;  // a chunk lies in one block
      const T* fb = base + (long long)b * kFields * E + e0;
      for (int q = threadIdx.x; q < kFields * kChunk; q += kThreads) {
        const int f = q / kChunk, j = q - f * kChunk;
        s_f[f][j] = fb[(long long)f * E + j];
      }
      if (threadIdx.x < kChunk) {
        s_i[threadIdx.x] = ibase[(long long)b * E + e0 + threadIdx.x];
      }
      __syncthreads();
      if (live) {
        for (int j = 0; j < kChunk; ++j) {
          const bool other = s_i[j] != self;
          const T kb = s_f[KEY][j];
          const bool maybe = (a > s_f[A0W][j]) && (a < s_f[A2W][j]) &&
                             (kb < kh) && other;
          const bool sure = (a > s_f[A0N][j]) && (a < s_f[A2N][j]) &&
                            (kb < kl) && other;
          if (!(maybe || sure)) continue;
          const T d = O::sub(a, s_f[A1E][j]);
          const T slope = d < 0 ? -s_f[S01][j] : s_f[S21][j];
          T gi = O::add(s_f[G1][j], O::mul(d, slope));
          gi = min_nan(max_nan(gi, s_f[MN][j]), s_f[MX][j]);
          if (maybe) hi = max_nan(hi, O::add(gi, s_f[TW][j]));
          if (sure) lo = max_nan(lo, O::sub(gi, s_f[TS][j]));
        }
      }
      __syncthreads();
    }
  }
  if (live) {
    hi_out[k] = hi;
    lo_out[k] = lo;
  }
}


// -- the culled route ---------------------------------------------------------

constexpr int kR = 4;                 // targets a thread
constexpr int kCullThreads = 128;     // 4 warps
constexpr int kCullWarps = kCullThreads / 32;
constexpr int kBlockTargets = kR * kCullThreads;
constexpr int kStages = 2;            // chunks in flight: one computed, one landing
constexpr int kBoundsWarps = 8;       // chunks a block of the pre-pass

// One staged chunk: the 13 field rows of 128 candidates, then their index.
template <typename T>
struct Stage {
  static constexpr int kFieldBytes = kChunk * (int)sizeof(T);
  static constexpr int kIdxOffset = kFields * kFieldBytes;
  static constexpr int kBytes = kIdxOffset + kChunk * 4;
};

// 4 consecutive values of shared memory, as 16-byte loads
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() {
  return CUDART_INF_F;
}
template <>
__device__ __forceinline__ double pos_inf<double>() {
  return CUDART_INF;
}

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return CUDART_NAN_F;
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return CUDART_NAN;
}

// One table of the pre-pass: table 0 is the global table (13, Lg), read
// as one block of Lg; table t + 1 is tier t's (nblk, 13, E).
template <typename T>
struct BoundTables {
  const T* stk[kMaxTiers + 1];
  int E[kMaxTiers + 1];
  long long nchunks[kMaxTiers + 1], off[kMaxTiers + 1];
};

// The pre-pass: for chunk c of each table, bounds[2 (off + c)] = lo, the
// least a0w, and bounds[2 (off + c) + 1] = hi, the largest a2w, over the
// chunk's candidates with a0w < a2w; +inf and -inf when it has none.  One
// warp a chunk.  Those are the only candidates whose wide cover
// a0w < al < a2w holds for any al, and no NaN is among them.
template <typename T>
__global__ void __launch_bounds__(kBoundsWarps * 32)
    screen_bounds_kernel(const BoundTables<T> tb, T* __restrict__ bounds) {
  const int tab = blockIdx.y;
  const long long c = (long long)blockIdx.x * kBoundsWarps + (threadIdx.x >> 5);
  if (c >= tb.nchunks[tab]) return;
  const int lane = threadIdx.x & 31;
  const long long E = tb.E[tab];
  const long long flat = c * kChunk;
  const long long b = flat / E;
  const T* const f = tb.stk[tab] + b * kFields * E + (flat - b * E);
  T lo = pos_inf<T>(), hi = -pos_inf<T>();
  for (int j = lane; j < kChunk; j += 32) {
    const T w0 = f[A0W * E + j], w2 = f[A2W * E + j];
    if (w0 < w2) {
      lo = w0 < lo ? w0 : lo;
      hi = w2 > hi ? w2 : hi;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T l2 = __shfl_xor_sync(0xffffffffu, lo, o);
    const T h2 = __shfl_xor_sync(0xffffffffu, hi, o);
    lo = l2 < lo ? l2 : lo;
    hi = h2 > hi ? h2 : hi;
  }
  if (lane == 0) {
    bounds[2 * (tb.off[tab] + c)] = lo;
    bounds[2 * (tb.off[tab] + c) + 1] = hi;
  }
}

// One segment of a group's candidates: the global table, or one tier's
// window, with its chunks' bounds.
template <typename T>
struct Seg {
  const T* f;      // field rows of the segment's first block
  const int* idx;  // index row of the segment's first block
  const T* bnd;    // (lo, hi) of the segment's first chunk
  int E, nchunks;
};

// Where the scan of a block's chunks stands: segment s, chunk c, and that
// chunk's bounds.
template <typename T>
struct Cursor {
  int s, c;
  T lo, hi;
};

// Moves `cur` to the first chunk at or after it that the block keeps: one
// whose (lo, hi) the block's target range [bmin, bmax] reaches into.
// Every thread of the block runs the same scan (uniform loads).  Counts
// the chunks passed over in `passed`; false at the end of the segments.
template <typename T>
__device__ __forceinline__ bool next_kept(Cursor<T>& cur, const Seg<T>* segs,
                                          int nseg, T bmin, T bmax,
                                          unsigned& passed) {
  for (; cur.s < nseg; ++cur.s, cur.c = 0) {
    const Seg<T>& sg = segs[cur.s];
    for (; cur.c < sg.nchunks; ++cur.c) {
      const T lo = __ldg(sg.bnd + 2 * cur.c), hi = __ldg(sg.bnd + 2 * cur.c + 1);
      if (!(bmax <= lo || bmin >= hi)) {
        cur.lo = lo;
        cur.hi = hi;
        return true;
      }
      ++passed;
    }
  }
  return false;
}

// Warp 0: chunk c of segment `sg` into `stage`, by one bulk copy a field
// row and one for the index row, completing on `bar`.
template <typename T>
__device__ __forceinline__ void stage_chunk(const Seg<T>& sg, int c,
                                            unsigned char* stage,
                                            uint32_t bar, int lane) {
  using S = Stage<T>;
  const long long E = sg.E;
  const long long flat = (long long)c * kChunk;
  const long long b = flat / E, e0 = flat - b * E;
  if (lane == 0) xrt::mbar_expect_tx(bar, S::kBytes);
  __syncwarp();
  if (lane < kFields) {
    xrt::bulk_load(xrt::smem_addr(stage + lane * S::kFieldBytes),
                   sg.f + (b * kFields + lane) * E + e0, S::kFieldBytes, bar);
  } else if (lane == kFields) {
    xrt::bulk_load(xrt::smem_addr(stage + S::kIdxOffset), sg.idx + b * E + e0,
                   kChunk * 4, bar);
  }
}

// This thread's kR targets against one staged chunk.
template <typename T>
__device__ __forceinline__ void eval_chunk(const unsigned char* stage,
                                           const T (&a)[kR], const T (&kl)[kR],
                                           const T (&kh)[kR],
                                           const int (&self)[kR], T (&hi)[kR],
                                           T (&lo)[kR]) {
  using O = Ops<T>;
  const T* const F = reinterpret_cast<const T*>(stage);
  const int* const I =
      reinterpret_cast<const int*>(stage + Stage<T>::kIdxOffset);
  for (int j = 0; j < kChunk; j += 4) {
    T w0[4], w2[4], kb[4];
    load4(F + A0W * kChunk + j, w0);
    load4(F + A2W * kChunk + j, w2);
    load4(F + KEY * kChunk + j, kb);
    // bit 4c + r: candidate j + c passes target r's wide cover and kt_hi
    unsigned m = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < kR; ++r)
        m |= (unsigned)((a[r] > w0[c]) & (a[r] < w2[c]) & (kb[c] < kh[r]))
             << (4 * c + r);
    if (m == 0) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned mc = (m >> (4 * c)) & 0xFu;
      if (mc == 0) continue;
      const int q = j + c;
      const int idx = I[q];
      const T a0n = F[A0N * kChunk + q], a2n = F[A2N * kChunk + q];
      const T a1e = F[A1E * kChunk + q], g1 = F[G1 * kChunk + q];
      const T s01 = F[S01 * kChunk + q], s21 = F[S21 * kChunk + q];
      const T mn = F[MN * kChunk + q], mx = F[MX * kChunk + q];
      const T ts = F[TS * kChunk + q], tw = F[TW * kChunk + q];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (!((mc >> r) & 1u) || idx == self[r]) continue;
        const T d = O::sub(a[r], a1e);
        const T slope = d < 0 ? -s01 : s21;
        T gi = O::add(g1, O::mul(d, slope));
        gi = min1(max1(gi, mn), mx);
        hi[r] = max1(hi[r], O::add(gi, tw));
        if ((a[r] > a0n) && (a[r] < a2n) && (kb[c] < kl[r]))
          lo[r] = max1(lo[r], O::sub(gi, ts));
      }
    }
  }
}

// stats (when not null): [0] pairs evaluated (live targets x candidates of
// the (warp, chunk) pairs not culled), [1] (warp, chunk) pairs evaluated,
// [2] (warp, chunk) pairs culled, by the block or by the warp, [3] chunks
// staged; warps with no live target count nothing.
template <typename T>
__global__ void __launch_bounds__(kCullThreads) screen_culled_kernel(
    const T* __restrict__ al, const T* __restrict__ klo,
    const T* __restrict__ khi, const int* __restrict__ it,
    const T* __restrict__ gstk, const int* __restrict__ gidx, int Lg,
    const Tiers<T> tiers, const int* __restrict__ rows, int T_per_group,
    const T* __restrict__ bounds, unsigned long long* __restrict__ stats,
    T* __restrict__ hi_out, T* __restrict__ lo_out) {
  using S = Stage<T>;
  __shared__ __align__(128) unsigned char s_stage[kStages][S::kBytes];
  __shared__ __align__(8) unsigned long long s_bar[kStages];
  __shared__ Seg<T> s_seg[kMaxTiers + 1];
  __shared__ T s_range[2][kCullWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x;
  const int t0 = blockIdx.y * kBlockTargets + tid * kR;
  const long long k0 = (long long)g * T_per_group + t0;

  // the targets: a dead one (past the group's end) gets a NaN angle, which
  // passes no test
  T a[kR], kl[kR], kh[kR], hi[kR], lo[kR];
  int self[kR];
  T tmin = pos_inf<T>(), tmax = -pos_inf<T>();
  int live = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const bool on = t0 + r < T_per_group;
    a[r] = on ? al[k0 + r] : quiet_nan<T>();
    kl[r] = on ? klo[k0 + r] : (T)0;
    kh[r] = on ? khi[k0 + r] : (T)0;
    self[r] = on ? it[k0 + r] : -1;
    hi[r] = lo[r] = Ops<T>::ninf();
    live += on;
    if (a[r] == a[r]) {
      tmin = a[r] < tmin ? a[r] : tmin;
      tmax = a[r] > tmax ? a[r] : tmax;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T m0 = __shfl_xor_sync(0xffffffffu, tmin, o);
    const T m1 = __shfl_xor_sync(0xffffffffu, tmax, o);
    tmin = m0 < tmin ? m0 : tmin;
    tmax = m1 > tmax ? m1 : tmax;
  }
  const T wmin = tmin, wmax = tmax;  // the warp's target range
  const int warp_live = __reduce_add_sync(0xffffffffu, live);
  if (lane == 0) {
    s_range[0][warp] = wmin;
    s_range[1][warp] = wmax;
  }
  const int nseg = tiers.n + 1;
  if (tid < nseg) {
    Seg<T> sg;
    if (tid == 0) {
      sg.f = gstk;
      sg.idx = gidx;
      sg.bnd = bounds;
      sg.E = Lg;
      sg.nchunks = Lg / kChunk;
    } else {
      const int tt = tid - 1;
      const int E = tiers.E[tt], nb = tiers.nb[tt];
      int r = rows[(long long)g * tiers.n + tt];
      r = r < tiers.nblk[tt] - nb ? r : tiers.nblk[tt] - nb;
      r = r > 0 ? r : 0;
      sg.f = tiers.stk[tt] + (long long)r * kFields * E;
      sg.idx = tiers.idx[tt] + (long long)r * E;
      sg.bnd = bounds + 2 * (tiers.boff[tt] + (long long)r * (E / kChunk));
      sg.E = E;
      sg.nchunks = nb * (E / kChunk);
    }
    s_seg[tid] = sg;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) xrt::mbar_init(xrt::smem_addr(s_bar + s), 1);
    xrt::mbar_fence_init();
  }
  __syncthreads();
  T bmin = s_range[0][0], bmax = s_range[1][0];  // the block's target range
#pragma unroll
  for (int w = 1; w < kCullWarps; ++w) {
    bmin = s_range[0][w] < bmin ? s_range[0][w] : bmin;
    bmax = s_range[1][w] > bmax ? s_range[1][w] : bmax;
  }

  unsigned passed = 0, kept = 0, culled = 0;
  Cursor<T> cur{0, 0, (T)0, (T)0};
  bool have = next_kept(cur, s_seg, nseg, bmin, bmax, passed);
  if (warp == 0 && have)
    stage_chunk(s_seg[cur.s], cur.c, s_stage[0], xrt::smem_addr(s_bar), lane);
  int n = 0;  // chunks staged so far; chunk n sits in stage n % kStages
  for (; have; ++n) {
    Cursor<T> nxt = cur;
    ++nxt.c;
    const bool more = next_kept(nxt, s_seg, nseg, bmin, bmax, passed);
    // every thread has left chunk n - 1's stage, and waited for it to land
    __syncthreads();
    if (warp == 0 && more)
      stage_chunk(s_seg[nxt.s], nxt.c, s_stage[(n + 1) % kStages],
                  xrt::smem_addr(s_bar + (n + 1) % kStages), lane);
    // every thread waits for every phase, so that a stage is refilled only
    // after its last copy landed
    xrt::mbar_wait(xrt::smem_addr(s_bar + n % kStages),
                   (uint32_t)((n / kStages) & 1));
    if (!(wmax <= cur.lo || wmin >= cur.hi)) {
      eval_chunk<T>(s_stage[n % kStages], a, kl, kh, self, hi, lo);
      ++kept;
    } else {
      ++culled;
    }
    cur = nxt;
    have = more;
  }
  if (stats != nullptr && lane == 0 && warp_live > 0) {
    atomicAdd(stats, (unsigned long long)kept * warp_live * kChunk);
    atomicAdd(stats + 1, (unsigned long long)kept);
    atomicAdd(stats + 2, (unsigned long long)(culled + passed));
    if (warp == 0) atomicAdd(stats + 3, (unsigned long long)n);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (t0 + r < T_per_group) {
      hi_out[k0 + r] = hi[r];
      lo_out[k0 + r] = lo[r];
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// -- the launchers --------------------------------------------------------------

// The tiers' arguments, checked: cudaErrorInvalidValue for what the kernels
// do not take (more than 12 tiers, a block length that is not a multiple
// of 128, a window of no block or more than the table), else 0.
template <typename T>
int tiers_of(int Lg, int ntier, const void* const* stk, const void* const* idx,
             const int* E, const int* nblk, const int* nb, Tiers<T>& tiers) {
  if (ntier < 0 || ntier > kMaxTiers || Lg <= 0 || Lg % kChunk != 0) {
    return (int)cudaErrorInvalidValue;
  }
  tiers = Tiers<T>{};
  tiers.n = ntier;
  long long off = Lg / kChunk;
  for (int t = 0; t < ntier; ++t) {
    if (E[t] <= 0 || E[t] % kChunk != 0 || nb[t] < 1 || nb[t] > nblk[t]) {
      return (int)cudaErrorInvalidValue;
    }
    tiers.stk[t] = static_cast<const T*>(stk[t]);
    tiers.idx[t] = static_cast<const int*>(idx[t]);
    tiers.E[t] = E[t];
    tiers.nblk[t] = nblk[t];
    tiers.nb[t] = nb[t];
    tiers.boff[t] = off;
    off += (long long)nblk[t] * (E[t] / kChunk);
  }
  return 0;
}

template <typename T>
int launch_bounds(const T* gstk, int Lg, int ntier, const void* const* stk,
                  const int* E, const int* nblk, T* bounds, void* stream) {
  if (ntier < 0 || ntier > kMaxTiers || Lg <= 0 || Lg % kChunk != 0) {
    return (int)cudaErrorInvalidValue;
  }
  BoundTables<T> tb{};
  tb.stk[0] = gstk;
  tb.E[0] = Lg;
  tb.nchunks[0] = Lg / kChunk;
  long long most = tb.nchunks[0], off = tb.nchunks[0];
  for (int t = 0; t < ntier; ++t) {
    if (E[t] <= 0 || E[t] % kChunk != 0 || nblk[t] < 1) {
      return (int)cudaErrorInvalidValue;
    }
    tb.stk[t + 1] = static_cast<const T*>(stk[t]);
    tb.E[t + 1] = E[t];
    tb.nchunks[t + 1] = (long long)nblk[t] * (E[t] / kChunk);
    tb.off[t + 1] = off;
    off += tb.nchunks[t + 1];
    most = tb.nchunks[t + 1] > most ? tb.nchunks[t + 1] : most;
  }
  const long long gx = (most + kBoundsWarps - 1) / kBoundsWarps;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  screen_bounds_kernel<T><<<dim3((unsigned)gx, (unsigned)(ntier + 1)),
                            kBoundsWarps * 32, 0, (cudaStream_t)stream>>>(
      tb, bounds);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_culled(const T* al, const T* klo, const T* khi, const int* it,
                  const T* gstk, const int* gidx, int Lg, int ntier,
                  const void* const* stk, const void* const* idx,
                  const int* E, const int* nblk, const int* nb,
                  const int* rows, int G, int Tg, const T* bounds,
                  unsigned long long* stats, T* hi, T* lo, void* stream) {
  if (G <= 0 || Tg <= 0) return 0;
  Tiers<T> tiers;
  const int err = tiers_of<T>(Lg, ntier, stk, idx, E, nblk, nb, tiers);
  if (err != 0) return err;
  // the bulk copies need 16-byte aligned rows: every table's base
  bool ok = aligned16(gstk) && aligned16(gidx);
  for (int t = 0; t < ntier; ++t)
    ok = ok && aligned16(tiers.stk[t]) && aligned16(tiers.idx[t]);
  const int ty = (Tg + kBlockTargets - 1) / kBlockTargets;
  if (!ok || ty > 65535) return (int)cudaErrorInvalidValue;
  screen_culled_kernel<T><<<dim3((unsigned)G, (unsigned)ty), kCullThreads, 0,
                            (cudaStream_t)stream>>>(
      al, klo, khi, it, gstk, gidx, Lg, tiers, rows, Tg, bounds, stats, hi,
      lo);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* al, const T* klo, const T* khi, const int* it,
           const T* gstk, const int* gidx, int Lg, int ntier,
           const void* const* stk, const void* const* idx, const int* E,
           const int* nblk, const int* nb, const int* rows, int G, int Tg,
           T* hi, T* lo, void* stream) {
  if (G <= 0 || Tg <= 0) return 0;
  Tiers<T> tiers;
  const int err = tiers_of<T>(Lg, ntier, stk, idx, E, nblk, nb, tiers);
  if (err != 0) return err;
  const int ty = (Tg + kThreads - 1) / kThreads;
  if (ty > 65535) return (int)cudaErrorInvalidValue;
  screen_hilo_kernel<T><<<dim3((unsigned)G, (unsigned)ty), kThreads, 0,
                          (cudaStream_t)stream>>>(
      al, klo, khi, it, gstk, gidx, Lg, tiers, rows, Tg, hi, lo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Route "simple", the first port: per-target (hi, lo) of G groups of Tg
// targets (al, klo, khi, it, hi, lo: (G*Tg,) in group order) against the
// global table gstk (13, Lg), gidx (Lg,) and, per tier t < ntier, the table
// stk[t] (nblk[t], 13, E[t]), idx[t] (nblk[t], E[t]), read as nb[t] blocks
// from row rows[g*ntier + t].  Every array is contiguous on the card.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments the kernel does not take (more than 12 tiers, a block
// length that is not a multiple of 128).
int screen_hilo_f32(const float* al, const float* klo, const float* khi,
                    const int* it, const float* gstk, const int* gidx,
                    int Lg, int ntier, const void* const* stk,
                    const void* const* idx, const int* E, const int* nblk,
                    const int* nb, const int* rows, int G, int Tg,
                    float* hi, float* lo, void* stream) {
  return launch<float>(al, klo, khi, it, gstk, gidx, Lg, ntier, stk, idx, E,
                       nblk, nb, rows, G, Tg, hi, lo, stream);
}

// The float64 instantiation, for the level-2 re-screen; same arguments.
int screen_hilo_f64(const double* al, const double* klo, const double* khi,
                    const int* it, const double* gstk, const int* gidx,
                    int Lg, int ntier, const void* const* stk,
                    const void* const* idx, const int* E, const int* nblk,
                    const int* nb, const int* rows, int G, int Tg,
                    double* hi, double* lo, void* stream) {
  return launch<double>(al, klo, khi, it, gstk, gidx, Lg, ntier, stk, idx,
                        E, nblk, nb, rows, G, Tg, hi, lo, stream);
}

// The culled route's pre-pass: every 128-candidate chunk's (lo, hi) into
// `bounds`, 2 values a chunk, the global table's chunks first, then each
// tier's (all nblk[t] blocks) in order.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue as screen_hilo_f32.
int screen_bounds_f32(const float* gstk, int Lg, int ntier,
                      const void* const* stk, const int* E, const int* nblk,
                      float* bounds, void* stream) {
  return launch_bounds<float>(gstk, Lg, ntier, stk, E, nblk, bounds, stream);
}

int screen_bounds_f64(const double* gstk, int Lg, int ntier,
                      const void* const* stk, const int* E, const int* nblk,
                      double* bounds, void* stream) {
  return launch_bounds<double>(gstk, Lg, ntier, stk, E, nblk, bounds, stream);
}

// Route "culled": screen_hilo_f32's arguments, plus the pre-pass's
// `bounds` and `stats` (null, or 4 counters the kernel adds to: pairs
// evaluated, (warp, chunk) pairs evaluated and culled, chunks staged).
// Every table's base must be 16-byte aligned (the bulk copies'
// rule): cudaErrorInvalidValue otherwise.
int screen_culled_f32(const float* al, const float* klo, const float* khi,
                      const int* it, const float* gstk, const int* gidx,
                      int Lg, int ntier, const void* const* stk,
                      const void* const* idx, const int* E, const int* nblk,
                      const int* nb, const int* rows, int G, int Tg,
                      const float* bounds, unsigned long long* stats,
                      float* hi, float* lo, void* stream) {
  return launch_culled<float>(al, klo, khi, it, gstk, gidx, Lg, ntier, stk,
                              idx, E, nblk, nb, rows, G, Tg, bounds, stats,
                              hi, lo, stream);
}

int screen_culled_f64(const double* al, const double* klo, const double* khi,
                      const int* it, const double* gstk, const int* gidx,
                      int Lg, int ntier, const void* const* stk,
                      const void* const* idx, const int* E, const int* nblk,
                      const int* nb, const int* rows, int G, int Tg,
                      const double* bounds, unsigned long long* stats,
                      double* hi, double* lo, void* stream) {
  return launch_culled<double>(al, klo, khi, it, gstk, gidx, Lg, ntier, stk,
                               idx, E, nblk, nb, rows, G, Tg, bounds, stats,
                               hi, lo, stream);
}

}  // extern "C"
