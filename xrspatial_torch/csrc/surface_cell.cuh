// Per-cell device code of the surface products (slope, aspect, curvature,
// hillshade), shared by every surface kernel: B1's staged kernel and its
// first port surface_kernel, the stacked kernel B0 (surface.cu), the fused
// pipeline's staged kernel (focal_halo.cu) and its first port
// pipeline_kernel (pipeline.cu).  Each computes each product from these
// same instructions (sobel, slope_value, aspect_value, curvature_value,
// hillshade_value).
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

// Each product of one cell from its 3x3 neighbourhood (a b c = row above,
// d e f = its row, g hh ii = row below), one function a product, and the
// Sobel sums slope and aspect share.  Every surface kernel computes its
// products through these functions (surface_quad for the staged kernels
// of surface.cu and focal_halo.cu, surface_cell for the first ports), so
// all run the same instructions in the same order and give the same
// bits.  A NaN neighbour (the NaN fill of a staged window outside
// the raster) makes every product NaN: each reads b, d, f and hh.
__device__ __forceinline__ void sobel(float a, float b, float c, float d,
                                      float f, float g, float hh, float ii,
                                      float& sx, float& sy) {
  sx = (c + 2.0f * f + ii) - (a + 2.0f * d + g);
  sy = (g + 2.0f * hh + ii) - (a + 2.0f * b + c);
}

__device__ __forceinline__ float slope_value(float sx, float sy,
                                             const SurfaceArgs& p) {
  const float dzdx = sx / (8.0f * p.csx);
  const float dzdy = sy / (8.0f * p.csy);
  return atanf(sqrtf(dzdx * dzdx + dzdy * dzdy)) * kDeg;
}

__device__ __forceinline__ float aspect_value(float sx, float sy) {
  const float dzdx = sx / 8.0f;
  const float dzdy = sy / 8.0f;
  const float angle = atan2f(dzdy, -dzdx) * kRadToDeg;
  // math angle -> compass direction (0-360, 0 = north)
  float compass = angle < 0.0f    ? 90.0f - angle
                  : angle > 90.0f ? 450.0f - angle
                                  : 90.0f - angle;
  if (dzdx == 0.0f && dzdy == 0.0f) compass = -1.0f;
  return compass;
}

__device__ __forceinline__ float curvature_value(float b, float d, float e,
                                                 float f, float hh,
                                                 const SurfaceArgs& p) {
  const float cs = (p.csx + p.csy) * 0.5f;
  const float dd = (hh + b) * 0.5f - e;
  const float ee = (f + d) * 0.5f - e;
  return -2.0f * (dd + ee) * 100.0f / (cs * cs);
}

__device__ __forceinline__ float hillshade_value(float b, float d, float f,
                                                 float hh,
                                                 const SurfaceArgs& p) {
  const float gx = (hh - b) * 0.5f;  // gradient along rows
  const float gy = (f - d) * 0.5f;   // gradient along columns
  const float shaded = (p.sin_a + p.cos_a * (p.cos_p * gy - p.sin_p * gx)) *
                       rsqrtf(1.0f + gx * gx + gy * gy);
  return (shaded + 1.0f) / 2.0f;
}

// Writes the selected products of cell (row, col) of an h x w raster,
// reading its 3x3 neighbourhood from `x`; the 1-cell ring is NaN (every
// cell when h < 3 or w < 3).  The first ports' per-cell code (surface.cu's
// surface_kernel and surface_stacked_kernel, pipeline.cu): each product
// is stored as soon as it is computed.
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
    float sx, sy;
    sobel(a, b, c, d, f, g, hh, ii, sx, sy);
    if (p.mask & kSlope) p.slope[i] = slope_value(sx, sy, p);
    if (p.mask & kAspect) p.aspect[i] = aspect_value(sx, sy);
  }
  if (p.mask & kCurvature) p.curv[i] = curvature_value(b, d, e, f, hh, p);
  if (p.mask & kHillshade) p.hill[i] = hillshade_value(b, d, f, hh, p);
}

// The 6 floats p[3 .. 8] of a staged window row (p 16-byte aligned): a
// 4-byte, a 16-byte and a 4-byte shared load.  With p the window cell of
// (row, col - 4), they are the row's cells col - 1 .. col + 4, the
// neighbourhoods of the 4 cells col .. col + 3.
__device__ __forceinline__ void load6(const float* p, float r[6]) {
  const float4 mid = *reinterpret_cast<const float4*>(p + 4);
  r[0] = p[3];
  r[1] = mid.x;
  r[2] = mid.y;
  r[3] = mid.z;
  r[4] = mid.w;
  r[5] = p[8];
}

// The selected products of 4 neighbouring cells of a row from a staged
// window: p is the window cell of (row - 1, col - 4), `pitch` floats a
// window row; v[k][j] is product k (0 slope, 1 aspect, 2 curvature, 3
// hillshade) of cell col + j; the entries of a product not in s.mask are
// not touched.  One branch a product, and the 4 cells' chains inside it
// are independent, so their long-latency steps (division, sqrt, atan)
// overlap.
__device__ __forceinline__ void surface_quad(const float* p, int pitch,
                                             const SurfaceArgs& s,
                                             float v[4][4]) {
  float u[6], m[6], d[6];
  load6(p, u);
  load6(p + pitch, m);
  load6(p + 2 * pitch, d);
  if (s.mask & (kSlope | kAspect)) {
    float sx[4], sy[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sobel(u[j], u[j + 1], u[j + 2], m[j], m[j + 2], d[j], d[j + 1],
            d[j + 2], sx[j], sy[j]);
    if (s.mask & kSlope) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[0][j] = slope_value(sx[j], sy[j], s);
    }
    if (s.mask & kAspect) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[1][j] = aspect_value(sx[j], sy[j]);
    }
  }
  if (s.mask & kCurvature) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[2][j] = curvature_value(u[j + 1], m[j], m[j + 1], m[j + 2],
                                d[j + 1], s);
  }
  if (s.mask & kHillshade) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[3][j] = hillshade_value(u[j + 1], m[j], m[j + 2], d[j + 1], s);
  }
}

// Stores surface_quad's products of cells i .. i + 3 (flat indices) of
// each selected plane: one 16-byte streaming store a plane where `vec`
// (w % 4 == 0 and every plane 16-byte aligned: the 4 cells lie in the
// raster together), else the first `n` cells one by one.  Streaming
// (evict first): the planes are not read again, and the L2 keeps the
// windows' halos for the neighbouring tiles.
__device__ __forceinline__ void surface_store4(const SurfaceArgs& s,
                                               long long i,
                                               const float (&v)[4][4],
                                               bool vec, long long n) {
  float* const planes[4] = {s.slope, s.aspect, s.curv, s.hill};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!(s.mask & (1 << k))) continue;
    float* const o = planes[k] + i;
    if (vec) {
      __stcs(reinterpret_cast<float4*>(o),
             make_float4(v[k][0], v[k][1], v[k][2], v[k][3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n) __stcs(o + j, v[k][j]);
    }
  }
}

}  // namespace xrt
