// Per-cell device code of the focal statistics, shared by focal_kernel
// (focal.cu), focal_halo_kernel (focal_halo.cu) and pipeline_kernel
// (pipeline.cu): the window accumulation and the epilogue.
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

// The second pass: dev2 += (s - mean)^2.  kRounded rounds the square and
// the sum separately (__fmul_rn/__fadd_rn), as the twin's separate torch
// ops do; otherwise nvcc may contract them into one fma.  kNanFree leaves
// out the NaN test, for a caller that knows s is not NaN.
template <bool kRounded, bool kNanFree = false>
__device__ __forceinline__ void focal_dev2_add(float& dev2, float s,
                                               float mean) {
  if (!kNanFree && isnan(s)) return;
  const float dv = s - mean;
  if (kRounded)
    dev2 = __fadd_rn(dev2, __fmul_rn(dv, dv));
  else
    dev2 += dv * dv;
}

// Writes the requested statistics of the cell at flat index i of each
// (h * w)-cell plane of `out`.
__device__ __forceinline__ void focal_store(const Slots& sl,
                                            float* __restrict__ out,
                                            long long plane, long long i,
                                            FocalAcc a, float mean,
                                            float dev2) {
  if (sl.s[kMean] >= 0) out[sl.s[kMean] * plane + i] = mean;
  if (sl.s[kSum] >= 0) out[sl.s[kSum] * plane + i] = a.ssum;
  // a window whose extreme is +-inf (no value, or +-inf data) is NaN
  if (isinf(a.smin)) a.smin = CUDART_NAN_F;
  if (isinf(a.smax)) a.smax = CUDART_NAN_F;
  if (sl.s[kMin] >= 0) out[sl.s[kMin] * plane + i] = a.smin;
  if (sl.s[kMax] >= 0) out[sl.s[kMax] * plane + i] = a.smax;
  if (sl.s[kRange] >= 0) out[sl.s[kRange] * plane + i] = a.smax - a.smin;
  if (needs_var(sl)) {
    const float var = a.cnt > 0.0f ? dev2 / fmaxf(a.cnt, 1.0f) : CUDART_NAN_F;
    if (sl.s[kVar] >= 0) out[sl.s[kVar] * plane + i] = var;
    if (sl.s[kStd] >= 0) out[sl.s[kStd] * plane + i] = sqrtf(var);
  }
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
      focal_dev2_add<false>(dev2,
                            window_value(x, h, w, row, col, offs[2 * k],
                                         offs[2 * k + 1]),
                            mean);
  focal_store(sl, out, h * w, row * w + col, a, mean, dev2);
}

}  // namespace xrt
