// pipeline_kernel: terrain_pipeline's fused branch, the selected surface
// products (slope, aspect, curvature, hillshade) plus one (S, H, W) stack
// of focal statistics, from one launch over the DEM.
//
// Replaces the TPU kernel xrspatial_tpu/kernels/pallas_pipeline.py::
// pipeline_tiled, which reads each DEM tile once for both surface_tiled's
// and focal_stats_tiled's work.  Each output comes from the same device
// code as the split kernels (surface_cell.cuh, focal_cell.cuh), so the
// fused and split paths compute the same numbers.  The TPU's seam bands
// (surface_seam_bands, focal_seam_bands) and its VMEM tiling have no
// counterpart: every thread reads its own neighbours with bounds checks.
//
// Bound on this card: device memory traffic.  The split path reads the
// DEM twice (once per kernel); this kernel reads it once, so the main
// path's traffic drops from 2 reads + 6 writes of f32 per cell to 1 + 6.
// The neighbour reads of both halves hit L1/L2.
//
// This is B4's first port, kept by name (route "simple"): one thread per
// output cell, 32x8 blocks, neighbours read straight from global memory.
// The redesign, on B2's staged window, is focal_halo.cu's
// focal_halo_staged_kernel with its surface epilogue.

#include "focal_cell.cuh"
#include "surface_cell.cuh"

namespace {

constexpr int kBlockX = 32, kBlockY = 8;

__global__ void pipeline_kernel(const float* __restrict__ x,
                                xrt::SurfaceArgs surf,
                                const int* __restrict__ offs, int n,
                                xrt::Slots slots, float* __restrict__ out,
                                long long h, long long w) {
  const long long col = (long long)blockIdx.x * kBlockX + threadIdx.x;
  if (col >= w) return;
  const long long row_step = (long long)gridDim.y * kBlockY;
  for (long long row = (long long)blockIdx.y * kBlockY + threadIdx.y;
       row < h; row += row_step) {
    xrt::surface_cell(x, h, w, row, col, surf);
    xrt::focal_cell(x, offs, n, slots, out, h, w, row, col);
  }
}

}  // namespace

extern "C" {

// Launches pipeline_kernel on `stream`.  The surface arguments are
// surface_launch's (`mask` 1 slope, 2 aspect, 4 curvature, 8 hillshade;
// mask 0 writes no product), the focal ones focal_launch's.  Returns
// cudaGetLastError() after the launch.
int pipeline_launch(const float* x, float* slope, float* aspect, float* curv,
                    float* hill, int mask, float csx, float csy, float sin_a,
                    float cos_a, float sin_p, float cos_p, const int* offs,
                    int n, const int* slots, float* out, long long h,
                    long long w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const xrt::SurfaceArgs surf{slope, aspect, curv,  hill,  mask, csx,
                              csy,   sin_a,  cos_a, sin_p, cos_p};
  xrt::Slots sl;
  for (int k = 0; k < xrt::kNumStats; ++k) sl.s[k] = slots[k];
  const long long blocks_y = (h + kBlockY - 1) / kBlockY;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((unsigned)((w + kBlockX - 1) / kBlockX),
            (unsigned)(blocks_y < 65535 ? blocks_y : 65535));
  pipeline_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, surf, offs, n, sl, out, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
