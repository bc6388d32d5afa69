// focal_halo: masked-window focal statistics, stacked as (S, H, W): the
// staged template for every footprint whose window fits a block, and the
// ring kernel for the rest.
//
// Replaces three TPU kernels:
// - xrspatial_tpu/kernels/pallas_window.py::focal_stats_pallas (the
//   emit_pipeline halo-window variant), for the footprints beyond the
//   tiled radii (ry > 32 or rx > 256), such as the 512-offset annulus of a
//   topographic position index with an outer radius of 40 cells; it
//   copies a whole (th + 2ry) x (tw + 2rx) halo window into VMEM and
//   computes every cell of the tile from it (kernels/cuda_window.py::
//   focal_stats_halo_cuda);
// - xrspatial_tpu/kernels/pallas_window2.py::focal_stats_tiled, for the
//   footprints within them, such as terrain_pipeline's 5-cell plus
//   (focal_stats_cuda; its first port, focal.cu::focal_kernel, is kept by
//   name as route "simple");
// - xrspatial_tpu/kernels/pallas_pipeline.py::pipeline_tiled (B4),
//   terrain_pipeline's fused branch: the staged kernel with its surface
//   epilogue (SURF; kernels/cuda_pipeline.py::pipeline_cuda; its first
//   port, pipeline.cu::pipeline_kernel, is kept by name as route
//   "simple").  Its bound is bytes: 1 read, the product planes and the
//   stat planes written (7.52 GB at 16384^2 with slope, hillshade and 4
//   stats, 2.244 ms at 3.35 TB/s), below the split kernels' 0.962 +
//   1.603 ms because the DEM is read once.  After a thread's focal
//   statistics, the same window gives its 2 x 4 cells' surface products
//   through surface_cell.cuh::surface_quad (B1's cell code) and each
//   product plane takes 16-byte streaming stores.  The window is halo_plan's over
//   radii max(ry, 1) and max(rx, 1) (kernels/pipeline.py::pipeline_plan):
//   the fused gate admits a 1x3 row or a 3x1 column, and the surface half
//   needs one halo row and column.  So B4 equals B1 + B2 bit for bit.
// Two kernels, three routes (kernels/focal_halo.py::halo_plan chooses;
// the launcher checks that the plan is safe to launch):
//
// focal_halo_staged_kernel (routes "tma" and "async"), redesigned for
// Hopper after the TPU kernel's own design.  What bounds it on this card
// is instruction issue, not bytes: 9 float operations a (cell, offset)
// (adds, compares and selects, no fma) against 8 bytes a cell.  So:
// - The whole window, once a tile.  A block of 256 threads takes one
//   TH x 128 output tile (TH = 32 for the annulus) and stages its full
//   halo window, rows r0 - ry .. r0 + TH + ry - 1 and columns c0 - pad ..
//   c0 + 127 + pad (pad = rx rounded up to 4, so that the first column is
//   16-byte aligned, as TMA needs of a box's innermost coordinate), into
//   dynamic shared memory: one thread asks TMA for the boxes, whose
//   out-of-bounds fill is NaN (the ring kernel's NaN outside the raster,
//   with no bounds or ring test), completing on one mbarrier; the async
//   route copies the same window with 4-byte cp.async and NaN stores.  One
//   barrier a tile, and both passes read the same window.  Two blocks an
//   SM (about 100 KB each for the annulus), or three where three windows
//   fit (the plus's is 22 KB; register_class), so one block's staging
//   hides under another's arithmetic.
// - The footprint as row runs.  The wrapper merges consecutive offsets of
//   one footprint row into runs (158 for the annulus's 512 offsets) and
//   gives each as the window's 16-byte group that lane 0 reads first and
//   the alignment within it; the block reads a run once a pass, the same
//   for every thread (a shared-memory broadcast).  No per-offset table
//   read and no per-offset range test: the window holds every offset.
// - Four cells along x a thread.  A warp owns one tile row at a time,
//   lane l cells c0 + 4l .. c0 + 4l + 3, so a run of length L needs L + 3
//   values a thread, not 4L.  The thread loads them as 16-byte groups
//   (conflict-free: the warp reads 512 consecutive bytes) into registers
//   v[0..11] that slide by 4 floats, and a switch on the run's alignment
//   selects an instantiation whose register indices are all static.  A
//   warp takes two tile rows, so the 8 warps cover 16 rows a step: on the
//   8-row tiles that halo_plan falls back to for tall or wide windows
//   (the 1x2001 row, say), warps 4-7 help stage the window and test it
//   for NaN but own no cells, and half the block idles through the
//   arithmetic.  No footprint of the main path takes such a tile.
// - Each cell accumulates in offsets order with focal_cell.cuh's float
//   operations: focal_acc_add, then focal_dev2_add (the rounded
//   square and sum of the twin).  The route is therefore equal bit for bit
//   to the ring kernel.  A block whose whole window holds no NaN (every
//   interior tile of a DEM without nodata; __syncthreads_or) takes the
//   same steps without the NaN tests, and sets the count to the number of
//   offsets, which n additions of 1 give: the same bits.
// - Each plane is stored as one 16-byte streaming store of a thread's 4
//   cells where w % 4 == 0 (and the output is aligned): a small footprint
//   is bound by its output bytes (4 planes of 4 bytes a cell for 4 bytes
//   read), which a warp writes in whole 16-byte vectors rather than as 4
//   scalar stores 16 bytes apart.
//
// focal_halo_kernel (route "ring"), the first port, kept by name and for
// windows that fit no block (a sparse footprint of radius 500, say).  Each
// block of 32x8 threads owns an 8-row x 32-column output tile, one thread
// a cell, copies the offset table into shared memory, and visits the
// footprint rows in offsets order: for row dy it keeps input rows r0 + dy
// .. r0 + dy + 7 in a ring of 8 rows x (32 + 2 rxs) cells, NaN outside the
// raster, loading only the rows the ring lacks; rxs = min(rx, 511), and an
// offset with |dx| > rxs is read from global memory.  Two barriers and a
// row load a footprint row and pass, and about three shared-memory
// instructions a (cell, offset): what made it slow.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "focal_cell.cuh"
#include "surface_cell.cuh"
#include "tma.cuh"

namespace {

// -- the staged kernel ---------------------------------------------------------

constexpr int kRouteTma = 0, kRouteAsync = 1;
constexpr int kTileCols = 128;      // 32 lanes x kCells
constexpr int kCells = 4;           // cells along x a thread
constexpr int kRows = 2;            // cells along y a thread
constexpr int kStagedThreads = 256;
constexpr int kWarps = kStagedThreads / 32;
constexpr int kBoxMax = 256;
constexpr int kAlignSlack = 128, kBarrierBytes = 128, kReadSlack = 64;
constexpr long long kSmemPerBlock = 232448;

long long round_up(long long a, long long b) { return (a + b - 1) / b * b; }

struct StagedArgs {
  const float* x;
  const int2* runs;  // (16-byte group, alignment + 4 * length) a run
  int nruns, n;      // runs and offsets of the footprint
  xrt::Slots slots;
  float* out;
  long long h, w, tiles_x;
  int th, ry, pad, pitch, rows, box_cols, box_rows, per_row;
  bool vec;  // w % 4 == 0 and every output 16-byte aligned: float4 stores
  xrt::SurfaceArgs surf;  // the fused pipeline's products (B4)
};

__device__ __forceinline__ void put4(float* v, float4 q) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// One run of `len` offsets for this thread's kRows x kCells cells: q is
// the window's 16-byte group holding the first row's cell 0's first value,
// at position A of it; row r's is q + r * pitch4.  Calls visit(r, j,
// value) for each cell (r, j) and each offset, in offsets order for every
// cell.  v[r][i] holds the float 4 * (groups advanced) + i floats past
// row r's first group.
template <int A, typename Visit>
__device__ __forceinline__ void walk_run(const float4* q, int pitch4,
                                         int len, Visit visit) {
  float v[kRows][12];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    put4(v[r], q[r * pitch4]);
    put4(v[r] + 4, q[r * pitch4 + 1]);
  }
  for (int m0 = 0; m0 < len; m0 += 4, ++q) {
    const int left = len - m0;
    // the highest index this step reads is A + min(left, 4) + 2; the next
    // step needs v[r][8..11] as its v[r][4..7]
    if (left > 4 || A + left + 2 >= 8) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) put4(v[r] + 8, q[r * pitch4 + 2]);
    }
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      if (mm < left) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < kCells; ++j) visit(r, j, v[r][A + mm + j]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) v[r][i] = v[r][i + 4];
  }
}

// Every run of the footprint, in order, for the cells whose first row of
// the window starts at `base` (this lane's 16-byte group of it).
template <typename Visit>
__device__ __forceinline__ void walk_runs(const float4* base, int pitch4,
                                          const int2* runs, int nruns,
                                          Visit visit) {
  for (int i = 0; i < nruns; ++i) {
    const int2 r = runs[i];
    const float4* q = base + r.x;
    const int len = r.y >> 2;
    switch (r.y & 3) {
      case 0: walk_run<0>(q, pitch4, len, visit); break;
      case 1: walk_run<1>(q, pitch4, len, visit); break;
      case 2: walk_run<2>(q, pitch4, len, visit); break;
      default: walk_run<3>(q, pitch4, len, visit); break;
    }
  }
}

// The statistics of cells (row + r, col + j), r < kRows, j < kCells, from
// the window; kNanFree: the block's window holds no NaN.
template <bool kNanFree>
__device__ __forceinline__ void tile_cells(const StagedArgs& a,
                                           const float4* base,
                                           const int2* runs, long long row,
                                           long long col) {
  const int pitch4 = a.pitch / 4;
  xrt::FocalAcc acc[kRows][kCells];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCells; ++j) acc[r][j] = xrt::focal_acc_init();
  walk_runs(base, pitch4, runs, a.nruns, [&](int r, int j, float s) {
    if (kNanFree)
      xrt::focal_acc_add_number(acc[r][j], s);
    else
      xrt::focal_acc_add(acc[r][j], s);
  });
  float mean[kRows][kCells], dev2[kRows][kCells];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (kNanFree) acc[r][j].cnt = (float)a.n;
      mean[r][j] = xrt::focal_mean(acc[r][j]);
      dev2[r][j] = 0.0f;
    }
  if (xrt::needs_var(a.slots))
    walk_runs(base, pitch4, runs, a.nruns, [&](int r, int j, float s) {
      xrt::focal_dev2_add<kNanFree>(dev2[r][j], s, mean[r][j]);
    });
  const long long plane = a.h * a.w;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row + r >= a.h) break;
    if (a.vec) {
      // w % 4 == 0: the 4 cells lie in the raster together
      if (col >= a.w) continue;
      xrt::FocalOut o[kCells];
#pragma unroll
      for (int j = 0; j < kCells; ++j)
        o[j] = xrt::focal_values(acc[r][j], mean[r][j], dev2[r][j]);
      xrt::focal_store4(a.slots, a.out, plane, (row + r) * a.w + col, o);
    } else {
#pragma unroll
      for (int j = 0; j < kCells; ++j)
        if (col + j < a.w)
          xrt::focal_store(a.slots, a.out, plane, (row + r) * a.w + col + j,
                           acc[r][j], mean[r][j], dev2[r][j]);
    }
  }
}

// The fused pipeline's surface products of cells (row + r, col + j),
// r < kRows, j < kCells, from the same window: cell (row + r, col + j)'s
// 3x3 neighbourhood lies at window rows tr + r - 1 + ry .. tr + r + 1 + ry
// and columns pad + 4 lane + j - 1 .. pad + 4 lane + j + 1, inside the
// window because its radii are at least 1 (ry >= 1, pad >= 4).  Each
// product plane is stored 4 cells at a time.
__device__ __forceinline__ void surface_cells(const StagedArgs& a,
                                              const float* win, int tr,
                                              int lane, long long row,
                                              long long col) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row + r >= a.h || col >= a.w) break;
    float v[4][4];
    xrt::surface_quad(
        win + (tr + r - 1 + a.ry) * a.pitch + a.pad - 4 + kCells * lane,
        a.pitch, a.surf, v);
    xrt::surface_store4(a.surf, (row + r) * a.w + col, v, a.vec, a.w - col);
  }
}

// SURF: the fused pipeline (B4): after each thread's focal statistics,
// its cells' surface products from the same window.
template <int ROUTE, int MIN_BLOCKS, bool SURF>
__global__ void __launch_bounds__(kStagedThreads, MIN_BLOCKS)
    focal_halo_staged_kernel(const __grid_constant__ CUtensorMap map,
                             const StagedArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = xrt::smem_addr(smem_raw);
  unsigned char* const smem = smem_raw + (((raw + 127u) & ~127u) - raw);
  const uint32_t bar = xrt::smem_addr(smem);
  int2* const s_runs = reinterpret_cast<int2*>(smem + kBarrierBytes);
  float* const win = reinterpret_cast<float*>(
      smem + kBarrierBytes + ((a.nruns * 8 + 127) & ~127));
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x / a.tiles_x * a.th;
  const long long c0 = (long long)blockIdx.x % a.tiles_x * kTileCols;
  const int win_floats = a.rows * a.pitch;

  if (ROUTE == kRouteTma) {
    if (tid == 0) {
      xrt::mbar_init(bar, 1);
      xrt::mbar_fence_init();
      xrt::mbar_expect_tx(bar, (uint32_t)win_floats * 4);
      const int col0 = (int)(c0 - a.pad), row0 = (int)(r0 - a.ry);
      if (a.per_row == 1) {
        for (int r = 0; r < a.rows; r += a.box_rows)
          xrt::tma_load_2d(xrt::smem_addr(win + r * a.pitch), &map, col0,
                           row0 + r, bar);
      } else {
        for (int r = 0; r < a.rows; ++r)
          for (int k = 0; k < a.per_row; ++k)
            xrt::tma_load_2d(
                xrt::smem_addr(win + r * a.pitch + k * a.box_cols), &map,
                col0 + k * a.box_cols, row0 + r, bar);
      }
    }
  } else {
    for (int e = tid; e < win_floats; e += kStagedThreads) {
      const int r = e / a.pitch;
      const long long row = r0 - a.ry + r;
      const long long col = c0 - a.pad + (e - r * a.pitch);
      if (row >= 0 && row < a.h && col >= 0 && col < a.w)
        xrt::cp_async_4(xrt::smem_addr(win + e), a.x + row * a.w + col);
      else
        win[e] = CUDART_NAN_F;
    }
    xrt::cp_async_commit();
  }
  for (int i = tid; i < a.nruns; i += kStagedThreads) s_runs[i] = a.runs[i];
  if (ROUTE == kRouteTma) {
    __syncthreads();  // the mbarrier is initialised before anyone waits
    xrt::mbar_wait(bar, 0);
  } else {
    xrt::cp_async_wait(0);
  }
  __syncthreads();

  bool nan_seen = false;
  const float4* const win4 = reinterpret_cast<const float4*>(win);
  for (int e = tid; e < win_floats / 4; e += kStagedThreads) {
    const float4 v = win4[e];
    nan_seen |= isnan(v.x) || isnan(v.y) || isnan(v.z) || isnan(v.w);
  }
  const bool nan_free = !__syncthreads_or(nan_seen);

  const int lane = tid & 31;
  const long long col = c0 + kCells * lane;
  // warp w: tile rows kRows * w .. kRows * w + kRows - 1, then kWarps *
  // kRows further down (TH is a multiple of kRows)
  for (int tr = (tid >> 5) * kRows; tr < a.th; tr += kWarps * kRows) {
    const long long row = r0 + tr;
    if (row >= a.h) break;
    const float4* const base = win4 + tr * (a.pitch / 4) + lane;
    if (nan_free)
      tile_cells<true>(a, base, s_runs, row, col);
    else
      tile_cells<false>(a, base, s_runs, row, col);
    if (SURF) surface_cells(a, win, tr, lane, row, col);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// -- the ring kernel -----------------------------------------------------------

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
            [&](float s) { xrt::focal_dev2_add(dev2, s, mean); });
    const long long row = r0 + threadIdx.y;
    if (row < h && col < w)
      xrt::focal_store(slots, out, h * w, row * w + col, acc, mean, dev2);
  }
}

xrt::Slots slots_of(const int* slots) {
  xrt::Slots sl;
  for (int k = 0; k < xrt::kNumStats; ++k) sl.s[k] = slots[k];
  return sl;
}

// A staged launch's plan (kernels/focal_halo.py::HaloPlan and
// register_class).
struct StagedPlan {
  int route, th, pad, pitch, rows, box_cols, box_rows, smem;
  long long grid;
  int min_blocks;
};

// Launches focal_halo_staged_kernel on plan `p`, with the surface
// epilogue where `surf` is given, after checking what keeps the launch
// safe: the route is the route rule's (TMA where w % 4 == 0 and x is
// 16-byte aligned), boxes of at most 256 a side and whole 32-float widths
// that tile the pitch, a window that covers the tile and its halo, shared
// bytes that hold it and fit a block, and a grid of one block a tile.
int staged_launch(const float* x, const int* runs, int nruns, int n,
                  const int* slots, float* out, long long h, long long w,
                  int ry, int rx, const StagedPlan& p,
                  const xrt::SurfaceArgs* surf, cudaStream_t stream) {
  if (h <= 0 || w <= 0) return 0;
  const bool tma = w % 4 == 0 && aligned16(x);
  const int per_row = p.box_cols > 0 ? p.pitch / p.box_cols : 0;
  const long long tiles_x = (w + kTileCols - 1) / kTileCols;
  const long long need = kAlignSlack + kBarrierBytes +
                         round_up(nruns * 8LL, 128) +
                         (long long)p.rows * p.pitch * 4 + kReadSlack;
  const bool boxes_ok =
      p.box_cols > 0 && p.box_cols <= kBoxMax && p.box_cols % 32 == 0 &&
      per_row * p.box_cols == p.pitch &&
      (per_row == 1 ? p.box_rows > 0 && p.box_rows <= kBoxMax &&
                          p.rows % p.box_rows == 0
                    : p.box_rows == 1);
  if (p.route != (tma ? kRouteTma : kRouteAsync) || nruns <= 0 || n <= 0 ||
      p.th <= 0 || p.th % kRows != 0 || p.pad < rx || p.pad % 4 != 0 ||
      !boxes_ok || p.pitch < kTileCols + 2 * p.pad ||
      p.rows < p.th + 2LL * ry || p.smem < need || p.smem > kSmemPerBlock ||
      p.grid != (h + p.th - 1) / p.th * tiles_x || p.min_blocks < 2 ||
      p.min_blocks > 3)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map{};
  if (tma) {
    const int err =
        xrt::encode_raster_map(&map, x, h, w, p.box_cols, p.box_rows);
    if (err != 0) return err;
  }
  StagedArgs a{};
  a.x = x;
  a.runs = reinterpret_cast<const int2*>(runs);
  a.nruns = nruns;
  a.n = n;
  a.slots = slots_of(slots);
  a.out = out;
  a.h = h;
  a.w = w;
  a.tiles_x = tiles_x;
  a.th = p.th;
  a.ry = ry;
  a.pad = p.pad;
  a.pitch = p.pitch;
  a.rows = p.rows;
  a.box_cols = p.box_cols;
  a.box_rows = p.box_rows;
  a.per_row = per_row;
  a.vec = w % 4 == 0 && aligned16(out);
  if (surf != nullptr) {
    a.surf = *surf;
    const float* const planes[4] = {surf->slope, surf->aspect, surf->curv,
                                    surf->hill};
    for (int k = 0; k < 4; ++k)
      if (surf->mask & (1 << k)) a.vec = a.vec && aligned16(planes[k]);
  }
  using Kernel = void (*)(const CUtensorMap, const StagedArgs);
  const Kernel kernels[2][2][2] = {
      {{focal_halo_staged_kernel<kRouteTma, 2, false>,
        focal_halo_staged_kernel<kRouteTma, 2, true>},
       {focal_halo_staged_kernel<kRouteTma, 3, false>,
        focal_halo_staged_kernel<kRouteTma, 3, true>}},
      {{focal_halo_staged_kernel<kRouteAsync, 2, false>,
        focal_halo_staged_kernel<kRouteAsync, 2, true>},
       {focal_halo_staged_kernel<kRouteAsync, 3, false>,
        focal_halo_staged_kernel<kRouteAsync, 3, true>}}};
  const Kernel kernel =
      kernels[tma ? 0 : 1][p.min_blocks - 2][surf != nullptr ? 1 : 0];
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)p.grid, kStagedThreads, p.smem, stream>>>(map, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches focal_halo_kernel, the ring route, on `stream`.  Arguments as
// focal_launch's, plus rx = max |dx| of the offsets.  Opts the kernel in
// to more than 48 KB of dynamic shared memory when the offset table and
// the ring need it.  Returns the first CUDA error, or cudaGetLastError()
// after the launch.
int focal_halo_launch(const float* x, const int* offs, int n,
                      const int* slots, float* out, long long h, long long w,
                      int rx, void* stream) {
  if (h <= 0 || w <= 0) return 0;
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
      x, offs, n, slots_of(slots), out, h, w, rxs);
  return (int)cudaGetLastError();
}

// Launches focal_halo_staged_kernel on `stream`, as kernels/focal_halo.py::
// halo_plan planned it: `runs` (2 ints a run, kernels/focal_halo.py::
// run_table) on the card; n offsets of radii ry, rx; route 0 TMA or 1
// cp.async; tile rows th; window pad, pitch and rows; box columns and
// rows; shared bytes; grid; and the blocks an SM the kernel is compiled
// for (kernels/focal_halo.py::register_class: 2 or 3, its register cap).
// The plan's choice of tile and blocks an SM is halo_plan's alone; this
// checks what keeps the launch safe (staged_launch).  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a plan
// that fails a check, or the negated CUresult of a failed tensor-map
// encode.
int focal_halo_staged_launch(const float* x, const int* runs, int nruns,
                             int n, const int* slots, float* out,
                             long long h, long long w, int ry, int rx,
                             int route, int th, int pad, int pitch, int rows,
                             int box_cols, int box_rows, int smem,
                             long long grid, int min_blocks, void* stream) {
  const StagedPlan plan{route, th,       pad,      pitch, rows,
                        box_cols, box_rows, smem, grid,  min_blocks};
  return staged_launch(x, runs, nruns, n, slots, out, h, w, ry, rx, plan,
                       nullptr, (cudaStream_t)stream);
}

// Launches the fused pipeline's staged kernel (B4) on `stream`: the
// surface products of surface_launch's `mask` (1 slope, 2 aspect, 4
// curvature, 8 hillshade; 0 writes none) and its scalars, plus the focal
// statistics of focal_halo_staged_launch's arguments, as kernels/
// pipeline.py::pipeline_plan planned them: halo_plan over the radii
// max(ry, 1), max(rx, 1), which the caller passes as ry and rx, so that
// every cell's 3x3 neighbourhood lies in its tile's window.  Also refuses
// ry < 1 or rx < 1.  Returns as focal_halo_staged_launch.
int pipeline_staged_launch(const float* x, float* slope, float* aspect,
                           float* curv, float* hill, int mask, float csx,
                           float csy, float sin_a, float cos_a, float sin_p,
                           float cos_p, const int* runs, int nruns, int n,
                           const int* slots, float* out, long long h,
                           long long w, int ry, int rx, int route, int th,
                           int pad, int pitch, int rows, int box_cols,
                           int box_rows, int smem, long long grid,
                           int min_blocks, void* stream) {
  if (ry < 1 || rx < 1 || mask < 0 || mask > 15)
    return (int)cudaErrorInvalidValue;
  const xrt::SurfaceArgs surf{slope, aspect, curv,  hill,  mask, csx,
                              csy,   sin_a,  cos_a, sin_p, cos_p};
  const StagedPlan plan{route, th,       pad,      pitch, rows,
                        box_cols, box_rows, smem, grid,  min_blocks};
  return staged_launch(x, runs, nruns, n, slots, out, h, w, ry, rx, plan,
                       &surf, (cudaStream_t)stream);
}

}  // extern "C"
