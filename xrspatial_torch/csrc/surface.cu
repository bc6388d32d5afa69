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
// work.  The per-cell code is surface_cell.cuh, shared with the fused
// pipeline kernel (pipeline.cu).
//
// surface_stacked_kernel: the same products written as the planes of one
// (K, H, W) float32 buffer, plane k = which[k] in any order.  Replaces the
// TPU kernel xrspatial_tpu/kernels/pallas_surface.py::surface_pallas (its
// emit_pipeline body), with the same libdevice atanf/atan2f in place of
// that file's polynomial atan.  The TPU kernel's tile padding and ragged
// NaN pad have no counterpart.  It runs surface_cell on plane pointers
// taken from the product -> plane map, so each plane equals
// surface_kernel's product bit for bit.  Same bound: 1 read + K writes.

#include "surface_cell.cuh"

namespace {

constexpr int kBlockX = 32, kBlockY = 8;

__global__ void surface_kernel(const float* __restrict__ x,
                               xrt::SurfaceArgs args, long long h,
                               long long w) {
  const long long col = (long long)blockIdx.x * kBlockX + threadIdx.x;
  if (col >= w) return;
  const long long row_step = (long long)gridDim.y * kBlockY;
  for (long long row = (long long)blockIdx.y * kBlockY + threadIdx.y;
       row < h; row += row_step)
    xrt::surface_cell(x, h, w, row, col, args);
}

// Plane of each product in the stacked buffer, in the order slope,
// aspect, curvature, hillshade; -1 where the product is not computed.
struct PlaneMap {
  int plane[4];
};

__global__ void surface_stacked_kernel(const float* __restrict__ x,
                                       float* __restrict__ out,
                                       PlaneMap map, float csx, float csy,
                                       float sin_a, float cos_a, float sin_p,
                                       float cos_p, long long h,
                                       long long w) {
  const long long col = (long long)blockIdx.x * kBlockX + threadIdx.x;
  if (col >= w) return;
  float* planes[4];
  int mask = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    planes[j] = map.plane[j] >= 0 ? out + map.plane[j] * h * w : nullptr;
    if (map.plane[j] >= 0) mask |= 1 << j;  // xrt::kSlope ... kHillshade
  }
  const xrt::SurfaceArgs args{planes[0], planes[1], planes[2], planes[3],
                              mask,      csx,       csy,       sin_a,
                              cos_a,     sin_p,     cos_p};
  const long long row_step = (long long)gridDim.y * kBlockY;
  for (long long row = (long long)blockIdx.y * kBlockY + threadIdx.y;
       row < h; row += row_step)
    xrt::surface_cell(x, h, w, row, col, args);
}

dim3 surface_grid(long long h, long long w) {
  const long long blocks_y = (h + kBlockY - 1) / kBlockY;
  return dim3((unsigned)((w + kBlockX - 1) / kBlockX),
              (unsigned)(blocks_y < 65535 ? blocks_y : 65535));
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
  const xrt::SurfaceArgs args{slope, aspect, curv,  hill,  mask, csx,
                              csy,   sin_a,  cos_a, sin_p, cos_p};
  surface_kernel<<<surface_grid(h, w), dim3(kBlockX, kBlockY), 0,
                   (cudaStream_t)stream>>>(x, args, h, w);
  return (int)cudaGetLastError();
}

// Launches surface_stacked_kernel on `stream`: plane p_slope ... p_hill of
// the (K, h, w) buffer `out` receives that product; a product whose plane
// is -1 is not computed.  Returns cudaGetLastError() after the launch.
int surface_stacked_launch(const float* x, float* out, long long h,
                           long long w, int p_slope, int p_aspect,
                           int p_curv, int p_hill, float csx, float csy,
                           float sin_a, float cos_a, float sin_p, float cos_p,
                           void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const PlaneMap map{{p_slope, p_aspect, p_curv, p_hill}};
  surface_stacked_kernel<<<surface_grid(h, w), dim3(kBlockX, kBlockY), 0,
                           (cudaStream_t)stream>>>(
      x, out, map, csx, csy, sin_a, cos_a, sin_p, cos_p, h, w);
  return (int)cudaGetLastError();
}

const char* xrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
