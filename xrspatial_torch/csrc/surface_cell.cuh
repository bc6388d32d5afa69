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
#include <stdint.h>

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

// load6 on a window row staged at phase f (route phased, staged_window.cuh:
// window column c at row[f + c], `row` 16-byte aligned): the 6 floats of
// window columns tc + 3 .. tc + 8 (tc a multiple of 4) from two aligned
// 16-byte loads and one 4-byte load, then shifted by o = (f + 3) mod 4 in
// two selects on o's bits (o is the same for a whole warp).
__device__ __forceinline__ void load6_phased(const float* row, int f, int tc,
                                             float r[6]) {
  const int o = (f + 3) & 3;
  const float* const p = row + tc + (f + 3 - o);  // 16-byte aligned
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  const float v[9] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w, p[8]};
  float y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = (o & 1) ? v[j + 1] : v[j];
#pragma unroll
  for (int j = 0; j < 6; ++j) r[j] = (o & 2) ? y[j + 2] : y[j];
}

// The selected products of 4 neighbouring cells of a row from the 3 x 6
// values around them (u the row above, m theirs, d the row below, cells
// col - 1 .. col + 4): v[k][j] is product k (0 slope, 1 aspect, 2
// curvature, 3 hillshade) of cell col + j; the entries of a product not in
// s.mask are not touched.  One branch a product, and the 4 cells' chains
// inside it are independent, so their long-latency steps (division, sqrt,
// atan) overlap.
__device__ __forceinline__ void surface_quad_of(const float (&u)[6],
                                                const float (&m)[6],
                                                const float (&d)[6],
                                                const SurfaceArgs& s,
                                                float v[4][4]) {
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

// surface_quad_of from a staged window: p is the window cell of (row - 1,
// col - 4), `pitch` floats a window row (16-byte aligned rows).
__device__ __forceinline__ void surface_quad(const float* p, int pitch,
                                             const SurfaceArgs& s,
                                             float v[4][4]) {
  float u[6], m[6], d[6];
  load6(p, u);
  load6(p + pitch, m);
  load6(p + 2 * pitch, d);
  surface_quad_of(u, m, d, s, v);
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

// The phased route's stores (surface.cu, surface_phased_kernel).  A 32-byte
// sector of a plane written in parts, by two warps, costs far more than one
// written whole (B1's TMA route with four products is about a third slower
// at 16384 x 16388, where every other row starts 16 bytes off a sector,
// than at 16384^2: chip_smoke.py phase 17, PERF.md), and with odd H * W
// the planes of one buffer lie at four different offsets.  So a warp
// computes the 128 cells cc0 .. cc0 + 127 of a row (lane l cells cc0 + 4l
// .. + 3) and writes, for each plane, the 120 cells from the first 32-byte
// boundary of that plane at or after cc0 + 1: the span c0 - s .. c0 + 119
// - s, c0 = cc0 + 8, s (0-7) the plane's float offset of cell c0 from a
// 32-byte boundary, the same for every tile of a row (tiles 120 columns
// apart), so the spans of a row's tiles meet.  Only the sectors around a
// raster row's ends are written in parts.
constexpr int kSpanCells = 120, kSpanShift = 8;

// A lane's 16-byte group of a span whose groups start T cells into the
// quads: g[j] = q[j + T], and past q[3] the next lane's q[j + T - 4], by
// shuffle.
template <int T>
__device__ __forceinline__ void span_group(const float (&q)[4],
                                           float (&g)[4]) {
  float n[4];
#pragma unroll
  for (int j = 0; j < T; ++j) n[j] = __shfl_down_sync(0xffffffffu, q[j], 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) g[j] = j + T < 4 ? q[j + T] : n[(j + T) & 3];
}

// Stores the span of one plane row, `o` the plane's cell (row, 0), from a
// whole warp: lane l + b (b = (8 - s) / 4) stores the span's 16-byte group
// l, cells cc0 + 4(l + b) + t .. + 3 with t = (8 - s) mod 4, its own
// q[t..3] and the next lane's q[0..t-1], with one streaming store; where
// the warp's 128 cells are not `inside` the raster row [0, w), cells
// outside it are skipped, one by one.  Every lane of the warp must call
// it; t and b are the same for all of them.
__device__ __forceinline__ void store_span(float* o, long long cc0,
                                           const float (&q)[4], long long w,
                                           bool inside) {
  const int lane = threadIdx.x & 31;
  float* const base = o + cc0;
  const int rel = kSpanShift - (int)(((uintptr_t)(base + kSpanShift) >> 2)
                                     & 7u);  // the span's start from cc0
  const int t = rel & 3, b = rel >> 2;
  float g[4];
  switch (t) {
    case 0: span_group<0>(q, g); break;
    case 1: span_group<1>(q, g); break;
    case 2: span_group<2>(q, g); break;
    default: span_group<3>(q, g); break;
  }
  if ((unsigned)(lane - b) >= (unsigned)(kSpanCells / 4)) return;
  const int c = 4 * lane + t;  // the group's first cell, from cc0
  if (inside || (cc0 + c >= 0 && cc0 + c + 4 <= w)) {
    __stcs(reinterpret_cast<float4*>(base + c), make_float4(g[0], g[1], g[2],
                                                            g[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (cc0 + c + j >= 0 && cc0 + c + j < w) __stcs(base + c + j, g[j]);
  }
}

// surface_quad's products of a warp's 128 cells of `row` from cc0: each
// selected plane's span stored by store_span.
__device__ __forceinline__ void surface_store_spans(const SurfaceArgs& s,
                                                    long long row,
                                                    long long w,
                                                    long long cc0,
                                                    const float (&v)[4][4]) {
  float* const planes[4] = {s.slope, s.aspect, s.curv, s.hill};
  const bool inside = cc0 >= 0 && cc0 + 128 <= w;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (s.mask & (1 << k))
      store_span(planes[k] + row * w, cc0, v[k], w, inside);
}

}  // namespace xrt
