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
// (tw, ts >= tg_abs > 0), so the order of the maxima changes no bit.
//
// What bounds it: operations.  At the 1024^2 bench plan the level-1 screen
// evaluates 1.8e10 pairs: 6 float compares on each, and 11 more (the
// subtract, the sign test, the product and sum, the clip, the two bands
// and the two maxima) on the few percent that pass a cover and key test;
// the rest are skipped.  That is about 1.7 ms at 67 TFLOP/s, against
// ~88 MB of tables, targets and outputs moved in 0.03 ms.  The design: one
// thread per target, a block of 256 targets
// of one group; the block stages chunks of 128 candidates (13 fields and
// the index) in shared memory, every thread reads the same candidate, so
// each read is a broadcast; each thread keeps its hi and lo in registers.
// This is the simple first version: the 14 shared-memory loads per pair
// and the divergence of the cover test are left as they are.

#include <cuda_runtime.h>
#include <math_constants.h>

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

template <typename T>
int launch(const T* al, const T* klo, const T* khi, const int* it,
           const T* gstk, const int* gidx, int Lg, int ntier,
           const void* const* stk, const void* const* idx, const int* E,
           const int* nblk, const int* nb, const int* rows, int G, int Tg,
           T* hi, T* lo, void* stream) {
  if (G <= 0 || Tg <= 0) return 0;
  if (ntier < 0 || ntier > kMaxTiers || Lg <= 0 || Lg % kChunk != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Tiers<T> tiers{};
  tiers.n = ntier;
  for (int t = 0; t < ntier; ++t) {
    if (E[t] <= 0 || E[t] % kChunk != 0 || nb[t] < 1 || nb[t] > nblk[t]) {
      return (int)cudaErrorInvalidValue;
    }
    tiers.stk[t] = static_cast<const T*>(stk[t]);
    tiers.idx[t] = static_cast<const int*>(idx[t]);
    tiers.E[t] = E[t];
    tiers.nblk[t] = nblk[t];
    tiers.nb[t] = nb[t];
  }
  const int ty = (Tg + kThreads - 1) / kThreads;
  if (ty > 65535) return (int)cudaErrorInvalidValue;
  screen_hilo_kernel<T><<<dim3((unsigned)G, (unsigned)ty), kThreads, 0,
                          (cudaStream_t)stream>>>(
      al, klo, khi, it, gstk, gidx, Lg, tiers, rows, Tg, hi, lo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Per-target (hi, lo) of G groups of Tg targets (al, klo, khi, it, hi, lo:
// (G*Tg,) in group order) against the global table gstk (13, Lg), gidx
// (Lg,) and, per tier t < ntier, the table stk[t] (nblk[t], 13, E[t]),
// idx[t] (nblk[t], E[t]), read as nb[t] blocks from row rows[g*ntier + t].
// Every array is contiguous on the card.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not
// take (more than 12 tiers, a block length that is not a multiple of 128).
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

}  // extern "C"
