// Per-cell device code of the surface products (slope, aspect, curvature,
// hillshade), shared by surface_kernel (surface.cu) and pipeline_kernel
// (pipeline.cu): both compute each product from these same instructions.
//
// Formulas and operation order follow the torch twins in
// xrspatial_torch/kernels/surface.py; libdevice atanf/atan2f replace the
// TPU's polynomial atan (xrspatial_tpu/kernels/pallas_surface.py).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

namespace xrt {

constexpr int kSlope = 1, kAspect = 2, kCurvature = 4, kHillshade = 8;
constexpr float kDeg = 57.29578f;                  // slope's constant
constexpr float kRadToDeg = 57.295779513082323f;  // 180 / pi

// The product planes and the float32 scalars they need.  `mask` selects
// the products (kSlope | kAspect | ...); the plane of a product that is not
// selected is not touched.
struct SurfaceArgs {
  float* slope;
  float* aspect;
  float* curv;
  float* hill;
  int mask;
  float csx, csy, sin_a, cos_a, sin_p, cos_p;
};

// Writes the selected products of cell (row, col) of an h x w raster,
// reading its 3x3 neighbourhood from `x`; the 1-cell ring is NaN (every
// cell when h < 3 or w < 3).
__device__ __forceinline__ void surface_cell(const float* __restrict__ x,
                                             long long h, long long w,
                                             long long row, long long col,
                                             const SurfaceArgs& p) {
  const long long i = row * w + col;
  if (row == 0 || row == h - 1 || col == 0 || col == w - 1) {
    if (p.mask & kSlope) p.slope[i] = CUDART_NAN_F;
    if (p.mask & kAspect) p.aspect[i] = CUDART_NAN_F;
    if (p.mask & kCurvature) p.curv[i] = CUDART_NAN_F;
    if (p.mask & kHillshade) p.hill[i] = CUDART_NAN_F;
    return;
  }
  // a b c = row above, d e f = this row, g hh ii = row below
  const float a = x[i - w - 1], b = x[i - w], c = x[i - w + 1];
  const float d = x[i - 1], e = x[i], f = x[i + 1];
  const float g = x[i + w - 1], hh = x[i + w], ii = x[i + w + 1];
  if (p.mask & (kSlope | kAspect)) {
    const float sx = (c + 2.0f * f + ii) - (a + 2.0f * d + g);
    const float sy = (g + 2.0f * hh + ii) - (a + 2.0f * b + c);
    if (p.mask & kSlope) {
      const float dzdx = sx / (8.0f * p.csx);
      const float dzdy = sy / (8.0f * p.csy);
      p.slope[i] = atanf(sqrtf(dzdx * dzdx + dzdy * dzdy)) * kDeg;
    }
    if (p.mask & kAspect) {
      const float dzdx = sx / 8.0f;
      const float dzdy = sy / 8.0f;
      const float angle = atan2f(dzdy, -dzdx) * kRadToDeg;
      // math angle -> compass direction (0-360, 0 = north)
      float compass = angle < 0.0f    ? 90.0f - angle
                      : angle > 90.0f ? 450.0f - angle
                                      : 90.0f - angle;
      if (dzdx == 0.0f && dzdy == 0.0f) compass = -1.0f;
      p.aspect[i] = compass;
    }
  }
  if (p.mask & kCurvature) {
    const float cs = (p.csx + p.csy) * 0.5f;
    const float dd = (hh + b) * 0.5f - e;
    const float ee = (f + d) * 0.5f - e;
    p.curv[i] = -2.0f * (dd + ee) * 100.0f / (cs * cs);
  }
  if (p.mask & kHillshade) {
    const float gx = (hh - b) * 0.5f;  // gradient along rows
    const float gy = (f - d) * 0.5f;   // gradient along columns
    const float shaded = (p.sin_a + p.cos_a * (p.cos_p * gy - p.sin_p * gx)) *
                         rsqrtf(1.0f + gx * gx + gy * gy);
    p.hill[i] = (shaded + 1.0f) / 2.0f;
  }
}

}  // namespace xrt
