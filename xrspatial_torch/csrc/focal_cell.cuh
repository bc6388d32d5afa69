// Per-cell device code of the focal statistics, shared by focal_kernel
// (focal.cu), the staged and ring kernels (focal_halo.cu) and
// pipeline_kernel (pipeline.cu): the window accumulation and the epilogue.
//
// Semantics follow the torch twin (xrspatial_torch/kernels/window.py):
// NaNs are excluded by count, and so is a neighbour outside the raster;
// min/max start from +-inf sentinels and a result that is still +-inf
// becomes NaN; var is two-pass (deviations from the window mean),
// population; the mean is a true division; a window with no value sums to
// 0, as np.nansum does.  Values are accumulated in the caller's order.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

namespace xrt {

// stat slots, in this order: index into the caller's (S, H, W) stack, or
// -1 when the stat was not requested
enum { kMean, kSum, kMin, kMax, kRange, kVar, kStd, kNumStats };

struct Slots {
  int s[kNumStats];
};

__device__ __forceinline__ bool needs_var(const Slots& sl) {
  return sl.s[kVar] >= 0 || sl.s[kStd] >= 0;
}

// The first pass's running count, sum and extremes of one window.
struct FocalAcc {
  float cnt, ssum, smin, smax;
};

__device__ __forceinline__ FocalAcc focal_acc_init() {
  return FocalAcc{0.0f, 0.0f, CUDART_INF_F, -CUDART_INF_F};
}

__device__ __forceinline__ void focal_acc_add(FocalAcc& a, float s) {
  if (isnan(s)) return;
  a.cnt += 1.0f;
  a.ssum += s;
  // fminf/fmaxf would drop a NaN; NaNs are skipped above instead
  a.smin = s < a.smin ? s : a.smin;
  a.smax = s > a.smax ? s : a.smax;
}

// focal_acc_add for a value known not to be NaN, without the count: a
// caller that knows a whole window has no NaN sets the count to the number
// of offsets, which is what n additions of 1 give (n < 2^24).
__device__ __forceinline__ void focal_acc_add_number(FocalAcc& a, float s) {
  a.ssum += s;
  a.smin = s < a.smin ? s : a.smin;
  a.smax = s > a.smax ? s : a.smax;
}

__device__ __forceinline__ float focal_mean(const FocalAcc& a) {
  return a.cnt > 0.0f ? a.ssum / fmaxf(a.cnt, 1.0f) : CUDART_NAN_F;
}

// The second pass: dev2 += (s - mean)^2, the square and the sum rounded
// apart (__fmul_rn/__fadd_rn), as the twin's separate torch ops do, so
// that nvcc cannot contract them into one fma: every focal kernel
// (focal_kernel, the staged and ring routes, pipeline_kernel) rounds the
// same way.  kNanFree leaves out the NaN test, for a caller that knows s
// is not NaN.
template <bool kNanFree = false>
__device__ __forceinline__ void focal_dev2_add(float& dev2, float s,
                                               float mean) {
  if (!kNanFree && isnan(s)) return;
  const float dv = s - mean;
  dev2 = __fadd_rn(dev2, __fmul_rn(dv, dv));
}

// The seven statistics of one cell, in the slot order, from its first
// pass and second-pass sum: a window whose extreme is +-inf (no value, or
// +-inf data) has a NaN extreme.
struct FocalOut {
  float v[kNumStats];
};

__device__ __forceinline__ FocalOut focal_values(FocalAcc a, float mean,
                                                 float dev2) {
  FocalOut o;
  o.v[kMean] = mean;
  o.v[kSum] = a.ssum;
  if (isinf(a.smin)) a.smin = CUDART_NAN_F;
  if (isinf(a.smax)) a.smax = CUDART_NAN_F;
  o.v[kMin] = a.smin;
  o.v[kMax] = a.smax;
  o.v[kRange] = a.smax - a.smin;
  const float var = a.cnt > 0.0f ? dev2 / fmaxf(a.cnt, 1.0f) : CUDART_NAN_F;
  o.v[kVar] = var;
  o.v[kStd] = sqrtf(var);
  return o;
}

// Writes the requested statistics of the cell at flat index i of each
// (h * w)-cell plane of `out`.
__device__ __forceinline__ void focal_store(const Slots& sl,
                                            float* __restrict__ out,
                                            long long plane, long long i,
                                            FocalAcc a, float mean,
                                            float dev2) {
  const FocalOut o = focal_values(a, mean, dev2);
#pragma unroll
  for (int k = 0; k < kNumStats; ++k)
    if (sl.s[k] >= 0) out[sl.s[k] * plane + i] = o.v[k];
}

// Writes the requested statistics of the 4 cells at flat indices i .. i +
// 3, one 16-byte streaming store a plane: out + i and the plane stride must
// keep 16-byte alignment.
__device__ __forceinline__ void focal_store4(const Slots& sl,
                                             float* __restrict__ out,
                                             long long plane, long long i,
                                             const FocalOut (&o)[4]) {
#pragma unroll
  for (int k = 0; k < kNumStats; ++k)
    if (sl.s[k] >= 0)
      __stcs(reinterpret_cast<float4*>(out + sl.s[k] * plane + i),
             make_float4(o[0].v[k], o[1].v[k], o[2].v[k], o[3].v[k]));
}

// x[row + dy, col + dx], or NaN outside the h x w raster
__device__ __forceinline__ float window_value(const float* __restrict__ x,
                                              long long h, long long w,
                                              long long row, long long col,
                                              int dy, int dx) {
  const long long yy = row + dy, xx = col + dx;
  if (yy < 0 || yy >= h || xx < 0 || xx >= w) return CUDART_NAN_F;
  return x[yy * w + xx];
}

// The statistics of cell (row, col) over the n (dy, dx) offsets of `offs`,
// in their order, each neighbour read from `x` (through L1) with bounds
// checks.
__device__ __forceinline__ void focal_cell(const float* __restrict__ x,
                                           const int* __restrict__ offs,
                                           int n, const Slots& sl,
                                           float* __restrict__ out,
                                           long long h, long long w,
                                           long long row, long long col) {
  FocalAcc a = focal_acc_init();
  for (int k = 0; k < n; ++k)
    focal_acc_add(a, window_value(x, h, w, row, col, offs[2 * k],
                                  offs[2 * k + 1]));
  const float mean = focal_mean(a);
  float dev2 = 0.0f;
  if (needs_var(sl))
    for (int k = 0; k < n; ++k)
      focal_dev2_add(dev2,
                     window_value(x, h, w, row, col, offs[2 * k],
                                  offs[2 * k + 1]),
                     mean);
  focal_store(sl, out, h * w, row * w + col, a, mean, dev2);
}

}  // namespace xrt
