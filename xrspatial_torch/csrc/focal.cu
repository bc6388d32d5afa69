// focal_kernel: masked-window focal statistics (mean, sum, min, max,
// range, var, std) of a float32 raster, stacked as (S, H, W).
//
// Replaces the TPU kernel xrspatial_tpu/kernels/pallas_window2.py::
// focal_stats_tiled (body emit_focal).  It also covers the shapes and
// radii that the JAX package sends to pallas_window.py::focal_stats_pallas
// or to XLA: any raster shape and any footprint of up to 1024 offsets.
// The TPU kernel's seam-band passes have no counterpart: every thread
// reads its own window with bounds checks, and a neighbour outside the
// raster is excluded like a NaN.
//
// Semantics follow the torch twin (xrspatial_torch/kernels/window.py):
// NaNs are excluded by count; min/max start from +-inf sentinels and a
// result that is still +-inf becomes NaN; var is two-pass (deviations from
// the window mean), population; the mean is a true division.  The
// accumulation runs in offsets order in float32, as the twin's does.
//
// Bound on this card: device memory traffic, 4 bytes read and 4*S bytes
// written per cell (1 read + S writes of f32); the window reads hit L1/L2.
//
// This is the simple first version: one thread per output cell, 32x8
// blocks, neighbours read straight from global memory.  Shared-memory halo
// tiles, cp.async or TMA, and compile-time offsets are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

namespace {

// stat slots, in this order: index into the caller's (S, H, W) stack, or
// -1 when the stat was not requested
enum { kMean, kSum, kMin, kMax, kRange, kVar, kStd, kNumStats };
constexpr int kBlockX = 32, kBlockY = 8;

struct Slots {
  int s[kNumStats];
};

__device__ __forceinline__ float window_value(const float* __restrict__ x,
                                              long long h, long long w,
                                              long long row, long long col,
                                              int dy, int dx) {
  const long long yy = row + dy, xx = col + dx;
  if (yy < 0 || yy >= h || xx < 0 || xx >= w) return CUDART_NAN_F;
  return x[yy * w + xx];
}

__global__ void focal_kernel(const float* __restrict__ x,
                             const int* __restrict__ offs, int n,
                             Slots slots, float* __restrict__ out,
                             long long h, long long w) {
  const long long col = (long long)blockIdx.x * kBlockX + threadIdx.x;
  if (col >= w) return;
  const long long plane = h * w;
  const bool need_sum = slots.s[kMean] >= 0 || slots.s[kSum] >= 0 ||
                        slots.s[kVar] >= 0 || slots.s[kStd] >= 0;
  const bool need_minmax = slots.s[kMin] >= 0 || slots.s[kMax] >= 0 ||
                           slots.s[kRange] >= 0;
  const bool need_var = slots.s[kVar] >= 0 || slots.s[kStd] >= 0;
  const long long row_step = (long long)gridDim.y * kBlockY;
  for (long long row = (long long)blockIdx.y * kBlockY + threadIdx.y;
       row < h; row += row_step) {
    float cnt = 0.0f, ssum = 0.0f;
    float smin = CUDART_INF_F, smax = -CUDART_INF_F;
    for (int k = 0; k < n; ++k) {
      const float s = window_value(x, h, w, row, col, offs[2 * k],
                                   offs[2 * k + 1]);
      if (isnan(s)) continue;
      cnt += 1.0f;
      ssum += s;
      // fminf/fmaxf would drop a NaN; NaNs are skipped above instead
      smin = s < smin ? s : smin;
      smax = s > smax ? s : smax;
    }
    const long long i = row * w + col;
    float mean = CUDART_NAN_F;
    if (need_sum) {
      mean = cnt > 0.0f ? ssum / fmaxf(cnt, 1.0f) : CUDART_NAN_F;
      if (slots.s[kMean] >= 0) out[slots.s[kMean] * plane + i] = mean;
      // a window with no value sums to 0, as np.nansum does
      if (slots.s[kSum] >= 0) out[slots.s[kSum] * plane + i] = ssum;
    }
    if (need_minmax) {
      // a window whose extreme is +-inf (no value, or +-inf data) is NaN
      if (isinf(smin)) smin = CUDART_NAN_F;
      if (isinf(smax)) smax = CUDART_NAN_F;
      if (slots.s[kMin] >= 0) out[slots.s[kMin] * plane + i] = smin;
      if (slots.s[kMax] >= 0) out[slots.s[kMax] * plane + i] = smax;
      if (slots.s[kRange] >= 0) out[slots.s[kRange] * plane + i] = smax - smin;
    }
    if (need_var) {
      float dev2 = 0.0f;
      for (int k = 0; k < n; ++k) {
        const float s = window_value(x, h, w, row, col, offs[2 * k],
                                     offs[2 * k + 1]);
        if (isnan(s)) continue;
        const float dv = s - mean;
        dev2 += dv * dv;
      }
      const float var = cnt > 0.0f ? dev2 / fmaxf(cnt, 1.0f) : CUDART_NAN_F;
      if (slots.s[kVar] >= 0) out[slots.s[kVar] * plane + i] = var;
      if (slots.s[kStd] >= 0) out[slots.s[kStd] * plane + i] = sqrtf(var);
    }
  }
}

}  // namespace

extern "C" {

// Launches focal_kernel on `stream`.  `offs` is a device array of n
// (dy, dx) int32 pairs; `slots` a host array of 7 ints giving each stat's
// plane in `out` (order: mean, sum, min, max, range, var, std; -1 = not
// requested).  Returns cudaGetLastError() after the launch.
int focal_launch(const float* x, const int* offs, int n, const int* slots,
                 float* out, long long h, long long w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  Slots sl;
  for (int k = 0; k < kNumStats; ++k) sl.s[k] = slots[k];
  const long long blocks_y = (h + kBlockY - 1) / kBlockY;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((unsigned)((w + kBlockX - 1) / kBlockX),
            (unsigned)(blocks_y < 65535 ? blocks_y : 65535));
  focal_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, offs, n, sl, out,
                                                          h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
