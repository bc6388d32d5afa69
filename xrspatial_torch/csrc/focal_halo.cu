// focal_halo_kernel: masked-window focal statistics, stacked as (S, H, W),
// for the footprints beyond focal_kernel's radius (ry > 32 or rx > 256),
// such as the 512-offset annulus of a topographic position index with an
// outer radius of 40 cells.
//
// Replaces the TPU kernel xrspatial_tpu/kernels/pallas_window.py::
// focal_stats_pallas (the emit_pipeline halo-window variant).  The TPU
// kernel copies a whole (th + 2ry) x (tw + 2rx) halo window into VMEM;
// a block's shared memory cannot hold that at these radii, so this kernel
// stages input rows instead.
//
// Design.  Each block of 32x8 threads owns an 8-row x 32-column output
// tile, one thread per cell.  It copies the offset table into shared
// memory once.  It then visits the footprint rows in offsets order
// (kernel_offsets gives them row-major by dy, then dx): for footprint row
// dy it needs input rows r0+dy ... r0+dy+7, which it keeps in a ring of 8
// rows x (32 + 2*rxs) cells, NaN outside the raster.  Moving to the next
// dy loads only the rows the ring lacks (one row for consecutive dy).
// rxs = min(rx, 511) bounds the ring at 8 x 1054 cells (33.7 KB): every
// contiguous footprint of at most 1024 offsets has rx <= 511, and an
// offset with |dx| > rxs (a sparse footprint) is read from global memory.
// Var/std stay two-pass: a second sweep over the rows once the mean is
// known.
//
// Each cell accumulates in offsets order in float32, with the square and
// sum of the second pass rounded separately (__fmul_rn/__fadd_rn), as the
// torch twin (kernels/window.py::window_stats) computes them, so the two
// can agree bit for bit.
//
// Bound on this card: shared-memory reads and instructions, 1-2 reads per
// offset per cell (a 512-offset annulus: ~1000 per cell); device memory
// moves (8 + 2*ry) x (32 + 2*rxs) cells a pass per tile, plus S writes.

#include "focal_cell.cuh"

namespace {

constexpr int kTW = 32, kTH = 8;  // kTH is a power of two (ring slots)
constexpr int kThreads = kTW * kTH;
constexpr int kMaxStagedRx = 511;
constexpr long long kNoRows = -(1LL << 62);

// Loads input rows [lo, hi) of the block's column window (c0 - rxs ...
// c0 + kTW + rxs - 1) into the ring; row r goes to slot r & (kTH - 1).
__device__ __forceinline__ void stage_rows(float* ring, int rw,
                                           const float* __restrict__ x,
                                           long long h, long long w,
                                           long long c0, int rxs,
                                           long long lo, long long hi) {
  // at most kTH rows of at most kTW + 2 * kMaxStagedRx cells: int indices
  const int count = (int)(hi - lo) * rw;
  for (int t = threadIdx.y * kTW + threadIdx.x; t < count; t += kThreads) {
    const int rr = t / rw, j = t - rr * rw;
    const long long r = lo + rr;
    const long long gc = c0 - rxs + j;
    ring[(r & (kTH - 1)) * rw + j] =
        (r >= 0 && r < h && gc >= 0 && gc < w) ? x[r * w + gc] : CUDART_NAN_F;
  }
}

// One sweep of the footprint over the tile whose first row is r0: calls
// visit(value) for each offset of this thread's cell, in offsets order.
// `base` is the first of the kTH rows the ring holds (kNoRows: none); the
// rows it holds are reused.  Every thread of the block calls this.
template <typename Visit>
__device__ __forceinline__ void sweep(const int* s_offs, int n, float* ring,
                                      int rw, const float* __restrict__ x,
                                      long long h, long long w, long long r0,
                                      long long c0, int rxs, long long& base,
                                      Visit visit) {
  const long long row = r0 + threadIdx.y, col = c0 + threadIdx.x;
  for (int k = 0; k < n;) {
    const int dy = s_offs[2 * k];
    const long long need = r0 + dy;  // rows need ... need + kTH - 1
    const long long lo =
        (need >= base && need < base + kTH) ? base + kTH : need;
    __syncthreads();  // reads of the slots about to be overwritten are done
    stage_rows(ring, rw, x, h, w, c0, rxs, lo, need + kTH);
    __syncthreads();
    base = need;
    const float* src =
        ring + ((row + dy) & (kTH - 1)) * rw + threadIdx.x + rxs;
    for (; k < n && s_offs[2 * k] == dy; ++k) {
      const int dx = s_offs[2 * k + 1];
      float v;
      if (dx >= -rxs && dx <= rxs)
        v = src[dx];
      else
        v = xrt::window_value(x, h, w, row, col, dy, dx);
      visit(v);
    }
  }
}

__global__ void focal_halo_kernel(const float* __restrict__ x,
                                  const int* __restrict__ offs, int n,
                                  xrt::Slots slots, float* __restrict__ out,
                                  long long h, long long w, int rxs) {
  extern __shared__ int smem[];
  int* s_offs = smem;                                 // 2n ints
  float* ring = reinterpret_cast<float*>(smem + 2 * n);  // kTH x rw floats
  const int rw = kTW + 2 * rxs;
  for (int t = threadIdx.y * kTW + threadIdx.x; t < 2 * n; t += kThreads)
    s_offs[t] = offs[t];
  __syncthreads();
  const long long c0 = (long long)blockIdx.x * kTW;
  const long long col = c0 + threadIdx.x;
  const bool need_var = xrt::needs_var(slots);
  long long base = kNoRows;
  for (long long r0 = (long long)blockIdx.y * kTH; r0 < h;
       r0 += (long long)gridDim.y * kTH) {
    xrt::FocalAcc acc = xrt::focal_acc_init();
    sweep(s_offs, n, ring, rw, x, h, w, r0, c0, rxs, base,
          [&](float s) { xrt::focal_acc_add(acc, s); });
    const float mean = xrt::focal_mean(acc);
    float dev2 = 0.0f;
    if (need_var)
      sweep(s_offs, n, ring, rw, x, h, w, r0, c0, rxs, base,
            [&](float s) { xrt::focal_dev2_add<true>(dev2, s, mean); });
    const long long row = r0 + threadIdx.y;
    if (row < h && col < w)
      xrt::focal_store(slots, out, h * w, row * w + col, acc, mean, dev2);
  }
}

}  // namespace

extern "C" {

// Launches focal_halo_kernel on `stream`.  Arguments as focal_launch's,
// plus rx = max |dx| of the offsets.  Opts the kernel in to more than
// 48 KB of dynamic shared memory when the offset table and the ring need
// it.  Returns the first CUDA error, or cudaGetLastError() after the
// launch.
int focal_halo_launch(const float* x, const int* offs, int n,
                      const int* slots, float* out, long long h, long long w,
                      int rx, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  xrt::Slots sl;
  for (int k = 0; k < xrt::kNumStats; ++k) sl.s[k] = slots[k];
  const int rxs = rx < kMaxStagedRx ? rx : kMaxStagedRx;
  const size_t smem = 2 * (size_t)n * sizeof(int) +
                      (size_t)kTH * (kTW + 2 * rxs) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        focal_halo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks_y = (h + kTH - 1) / kTH;
  dim3 block(kTW, kTH);
  dim3 grid((unsigned)((w + kTW - 1) / kTW),
            (unsigned)(blocks_y < 65535 ? blocks_y : 65535));
  focal_halo_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      x, offs, n, sl, out, h, w, rxs);
  return (int)cudaGetLastError();
}

}  // extern "C"
