// surface_kernel: slope, aspect, curvature and hillshade of a float32 DEM
// from one read of its 3x3 neighbourhood.
//
// Replaces the TPU kernel xrspatial_tpu/kernels/pallas_surface2.py::
// surface_tiled (body emit_surface), together with the polynomial
// atan/atan2 of xrspatial_tpu/kernels/pallas_surface.py (_atan_of_sqrt,
// _atan2, _atan, _atan_poly): those exist only because the TPU compiler
// has no atan, so this kernel calls libdevice atanf/atan2f instead.  The
// TPU kernel's seam-band passes and ragged-edge NaN pad have no
// counterpart: every thread reads its own neighbours with bounds checks.
//
// Bound on this card: device memory traffic, 4 bytes read and 4 bytes
// written per product per cell (1 read + K writes of f32); the few dozen
// flops per cell are far below the compute roof.
//
// This is the simple first version: one thread per output cell, 32x8
// blocks, neighbours read straight from global memory (the 3x3 reuse is
// left to L1/L2).  Shared-memory halo tiles, cp.async or TMA are later
// work.  Formulas and operation order follow the torch twins in
// xrspatial_torch/kernels/surface.py.

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

namespace {

constexpr int kSlope = 1, kAspect = 2, kCurvature = 4, kHillshade = 8;
constexpr int kBlockX = 32, kBlockY = 8;
constexpr float kDeg = 57.29578f;                  // slope's constant
constexpr float kRadToDeg = 57.295779513082323f;  // 180 / pi

__global__ void surface_kernel(const float* __restrict__ x,
                               float* __restrict__ slope,
                               float* __restrict__ aspect,
                               float* __restrict__ curv,
                               float* __restrict__ hill,
                               long long h, long long w, int mask,
                               float csx, float csy, float sin_a,
                               float cos_a, float sin_p, float cos_p) {
  const long long col = (long long)blockIdx.x * kBlockX + threadIdx.x;
  if (col >= w) return;
  const long long row_step = (long long)gridDim.y * kBlockY;
  for (long long row = (long long)blockIdx.y * kBlockY + threadIdx.y;
       row < h; row += row_step) {
    const long long i = row * w + col;
    if (row == 0 || row == h - 1 || col == 0 || col == w - 1) {
      // 1-cell NaN ring; covers every cell when h < 3 or w < 3
      if (mask & kSlope) slope[i] = CUDART_NAN_F;
      if (mask & kAspect) aspect[i] = CUDART_NAN_F;
      if (mask & kCurvature) curv[i] = CUDART_NAN_F;
      if (mask & kHillshade) hill[i] = CUDART_NAN_F;
      continue;
    }
    // a b c = row above, d e f = this row, g hh ii = row below
    const float a = x[i - w - 1], b = x[i - w], c = x[i - w + 1];
    const float d = x[i - 1], e = x[i], f = x[i + 1];
    const float g = x[i + w - 1], hh = x[i + w], ii = x[i + w + 1];
    if (mask & (kSlope | kAspect)) {
      const float sx = (c + 2.0f * f + ii) - (a + 2.0f * d + g);
      const float sy = (g + 2.0f * hh + ii) - (a + 2.0f * b + c);
      if (mask & kSlope) {
        const float dzdx = sx / (8.0f * csx);
        const float dzdy = sy / (8.0f * csy);
        slope[i] = atanf(sqrtf(dzdx * dzdx + dzdy * dzdy)) * kDeg;
      }
      if (mask & kAspect) {
        const float dzdx = sx / 8.0f;
        const float dzdy = sy / 8.0f;
        const float angle = atan2f(dzdy, -dzdx) * kRadToDeg;
        // math angle -> compass direction (0-360, 0 = north)
        float compass = angle < 0.0f    ? 90.0f - angle
                        : angle > 90.0f ? 450.0f - angle
                                        : 90.0f - angle;
        if (dzdx == 0.0f && dzdy == 0.0f) compass = -1.0f;
        aspect[i] = compass;
      }
    }
    if (mask & kCurvature) {
      const float cs = (csx + csy) * 0.5f;
      const float dd = (hh + b) * 0.5f - e;
      const float ee = (f + d) * 0.5f - e;
      curv[i] = -2.0f * (dd + ee) * 100.0f / (cs * cs);
    }
    if (mask & kHillshade) {
      const float gx = (hh - b) * 0.5f;  // gradient along rows
      const float gy = (f - d) * 0.5f;   // gradient along columns
      const float shaded = (sin_a + cos_a * (cos_p * gy - sin_p * gx)) *
                           rsqrtf(1.0f + gx * gx + gy * gy);
      hill[i] = (shaded + 1.0f) / 2.0f;
    }
  }
}

}  // namespace

extern "C" {

// Launches surface_kernel on `stream`.  `mask` selects the products
// (1 slope, 2 aspect, 4 curvature, 8 hillshade); the pointer of a product
// that is not selected is not touched.  Returns cudaGetLastError() after
// the launch, so a refused launch is reported to the caller.
int surface_launch(const float* x, float* slope, float* aspect, float* curv,
                   float* hill, long long h, long long w, int mask,
                   float csx, float csy, float sin_a, float cos_a,
                   float sin_p, float cos_p, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const long long blocks_y = (h + kBlockY - 1) / kBlockY;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((unsigned)((w + kBlockX - 1) / kBlockX),
            (unsigned)(blocks_y < 65535 ? blocks_y : 65535));
  surface_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, slope, aspect, curv, hill, h, w, mask, csx, csy, sin_a, cos_a,
      sin_p, cos_p);
  return (int)cudaGetLastError();
}

const char* xrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
