// focal_kernel: masked-window focal statistics (mean, sum, min, max,
// range, var, std) of a float32 raster, stacked as (S, H, W).
//
// The first port of the TPU kernel xrspatial_tpu/kernels/pallas_window2.py::
// focal_stats_tiled (body emit_focal), kept by name as route "simple" of
// kernels/cuda_window.py::focal_stats_cuda: the footprints the JAX package
// sends there (ry <= 32, rx <= 256) now run on the staged template of
// focal_halo.cu, which gives the same bits.  It takes any raster shape and
// any number of offsets.  The TPU kernel's seam-band passes have no
// counterpart: every thread reads its own window with bounds checks, and a
// neighbour outside the raster is excluded like a NaN.  The per-cell code
// is focal_cell.cuh, shared with the fused pipeline kernel (pipeline.cu).
//
// Bound on this card: device memory traffic, 4 bytes read and 4*S bytes
// written per cell (1 read + S writes of f32).  One thread per output
// cell, 32x8 blocks, every neighbour read straight from global memory with
// a 64-bit index and four bounds tests, the offsets read from global
// memory each time, twice for the variance: on an H100, 5.2 ms on the
// 5-cell plus at 16384^2 against a 1.6 ms byte bound.

#include "focal_cell.cuh"

namespace {

constexpr int kBlockX = 32, kBlockY = 8;

__global__ void focal_kernel(const float* __restrict__ x,
                             const int* __restrict__ offs, int n,
                             xrt::Slots slots, float* __restrict__ out,
                             long long h, long long w) {
  const long long col = (long long)blockIdx.x * kBlockX + threadIdx.x;
  if (col >= w) return;
  const long long row_step = (long long)gridDim.y * kBlockY;
  for (long long row = (long long)blockIdx.y * kBlockY + threadIdx.y;
       row < h; row += row_step)
    xrt::focal_cell(x, offs, n, slots, out, h, w, row, col);
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
  xrt::Slots sl;
  for (int k = 0; k < xrt::kNumStats; ++k) sl.s[k] = slots[k];
  const long long blocks_y = (h + kBlockY - 1) / kBlockY;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((unsigned)((w + kBlockX - 1) / kBlockX),
            (unsigned)(blocks_y < 65535 ? blocks_y : 65535));
  focal_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, offs, n, sl, out,
                                                          h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
