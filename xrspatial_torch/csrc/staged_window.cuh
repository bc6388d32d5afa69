// staged_window.cuh: the persistent, TMA-staged window ring of the 3x3
// stencil kernels: the surface kernel B1 (surface.cu, surface_staged_kernel)
// and the stencil probe B8c (stencil_probe.cu, stencil_staged_kernel).
//
// Persistent blocks of kStagedThreads threads walk TH x TW output tiles in
// row-major order with the grid's stride.  Each tile's window, rows
// r0 - 1 .. r0 + TH and columns c0 - 4 .. c0 + TW + 3, is staged into an
// S-stage ring in dynamic shared memory, S windows ahead, each stage
// tracked by an mbarrier:
// - route TMA: one thread asks TMA for the window as one box of a tensor
//   map whose out-of-bounds fill is NaN, so the 1-cell ring of a stencil
//   comes out NaN from the arithmetic itself (no ring test).  The window
//   starts 4 columns left of the tile, not 1: TMA refuses (illegal
//   instruction) a box whose innermost coordinate is not a multiple of 16
//   bytes, and the tile's c0 - 1 is not one.  A stage is refilled after a
//   block barrier says every thread has left it.
// - route async: for a pitch or base TMA refuses (w % 4 != 0, or a base
//   that is not 16-byte aligned), every thread copies the same window with
//   4-byte cp.async copies and NaN stores outside the raster.
// The launcher of each kernel picks the route by that rule alone
// (staged_route) and checks that the caller's plan (kernels/staged.py::
// staged_plan) agrees.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tma.cuh"

namespace xrt {

constexpr int kStagedThreads = 256;
constexpr int kStagedRouteTma = 0, kStagedRouteAsync = 1;
constexpr int kStagedBarrierBytes = 128;  // the stages' mbarriers, 8 each
constexpr int kStagedAlignSlack = 128;    // room to align the ring
constexpr int kStagedMaxStages = 8;       // cp_async_wait counts up to 7

// A TH x TW tile's window in shared memory: TH + 2 rows of kCols = TW + 8
// floats, window (r, c) holding image cell (r0 - 1 + r, c0 - 4 + c).
template <int TH, int TW>
struct Window {
  static constexpr int kCols = TW + 8;
  static constexpr int kRows = TH + 2;
  static constexpr int kBoxBytes = kCols * kRows * 4;
  static constexpr int kStageBytes = (kBoxBytes + 127) / 128 * 128;
  static_assert(TW % 4 == 0, "a tile row is whole 16-byte stores");
  static_assert(kCols <= 256 && kRows <= 256, "a TMA box is at most 256");
};

// The raster and the ring a staged kernel walks.
struct RingArgs {
  const float* x;
  long long h, w, tiles_x, tiles;
  int stages;
};

// The first row and column of tile t of a raster `tiles_x` tiles wide.
template <int TH, int TW>
__device__ __forceinline__ void tile_origin(long long t, long long tiles_x,
                                            long long& r0, long long& c0) {
  r0 = t / tiles_x * TH;
  c0 = t % tiles_x * TW;
}

// One thread: the window of the tile at (r0, c0) by TMA into `dst`.
template <int TH, int TW>
__device__ __forceinline__ void stage_tma(const CUtensorMap* map,
                                          uint32_t dst, uint32_t bar,
                                          long long r0, long long c0) {
  mbar_expect_tx(bar, Window<TH, TW>::kBoxBytes);
  tma_load_2d(dst, map, (int)(c0 - 4), (int)(r0 - 1), bar);
}

// Every thread: the same window by 4-byte cp.async copies, NaN outside
// the raster.
template <int TH, int TW>
__device__ __forceinline__ void stage_async(const RingArgs& a, float* win,
                                            long long r0, long long c0) {
  using Win = Window<TH, TW>;
  for (int e = threadIdx.x; e < Win::kRows * Win::kCols;
       e += kStagedThreads) {
    const int r = e / Win::kCols;
    const long long row = r0 - 1 + r, col = c0 - 4 + (e - r * Win::kCols);
    if (row >= 0 && row < a.h && col >= 0 && col < a.w)
      cp_async_4(smem_addr(win + e), a.x + row * a.w + col);
    else
      win[e] = CUDART_NAN_F;
  }
}

// The block's tiles, blockIdx.x + k * gridDim.x for k < mine, tile k
// staged in stage k % stages: calls tile(win, r0, c0) on every thread
// once tile k's window (the tile at r0, c0) has landed in `win`.
// `smem_raw` is the kernel's dynamic shared memory, kStagedAlignSlack +
// kStagedBarrierBytes + stages * Window::kStageBytes bytes.
template <int TH, int TW, int ROUTE, typename Tile>
__device__ __forceinline__ void staged_tiles(const CUtensorMap* map,
                                             const RingArgs& a,
                                             unsigned char* smem_raw,
                                             Tile tile) {
  using Win = Window<TH, TW>;
  constexpr int kStageFloats = Win::kStageBytes / 4;
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* const smem = smem_raw + (((raw + 127u) & ~127u) - raw);
  const uint32_t bars = smem_addr(smem);
  float* const ring = reinterpret_cast<float*>(smem + kStagedBarrierBytes);
  const uint32_t ring_addr = smem_addr(ring);
  const int tid = threadIdx.x;
  const long long step = gridDim.x;
  const long long mine =
      blockIdx.x < a.tiles ? (a.tiles - blockIdx.x + step - 1) / step : 0;
  long long r0, c0;

  if (ROUTE == kStagedRouteTma) {
    if (tid == 0) {
      for (int s = 0; s < a.stages; ++s) mbar_init(bars + 8 * s, 1);
      mbar_fence_init();
      for (int s = 0; s < a.stages && s < mine; ++s) {
        tile_origin<TH, TW>(blockIdx.x + s * step, a.tiles_x, r0, c0);
        stage_tma<TH, TW>(map, ring_addr + s * Win::kStageBytes,
                          bars + 8 * s, r0, c0);
      }
    }
    __syncthreads();
  } else {
    for (int s = 0; s + 1 < a.stages; ++s) {
      if (s < mine) {
        tile_origin<TH, TW>(blockIdx.x + s * step, a.tiles_x, r0, c0);
        stage_async<TH, TW>(a, ring + s * kStageFloats, r0, c0);
      }
      cp_async_commit();
    }
  }
  for (long long k = 0; k < mine; ++k) {
    const int s = (int)(k % a.stages);
    if (ROUTE == kStagedRouteTma) {
      mbar_wait(bars + 8 * s, (uint32_t)((k / a.stages) & 1));
    } else {
      // tile k + stages - 1 into the stage of tile k - 1, which every
      // thread left at the barrier that ended the last iteration
      const long long j = k + a.stages - 1;
      if (j < mine) {
        tile_origin<TH, TW>(blockIdx.x + j * step, a.tiles_x, r0, c0);
        stage_async<TH, TW>(a, ring + (int)(j % a.stages) * kStageFloats, r0,
                            c0);
      }
      cp_async_commit();
      cp_async_wait(a.stages - 1);
      __syncthreads();
    }
    tile_origin<TH, TW>(blockIdx.x + k * step, a.tiles_x, r0, c0);
    tile(static_cast<const float*>(ring + s * kStageFloats), r0, c0);
    __syncthreads();  // every thread has left stage s
    if (ROUTE == kStagedRouteTma && tid == 0 && k + a.stages < mine) {
      tile_origin<TH, TW>(blockIdx.x + (k + a.stages) * step, a.tiles_x, r0,
                          c0);
      stage_tma<TH, TW>(map, ring_addr + s * Win::kStageBytes, bars + 8 * s,
                        r0, c0);
    }
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The route rule: TMA needs a 16-byte-aligned base and row pitch
// (w % 4 == 0), and the 16-byte stores aligned outputs; anything else
// stages the window with cp.async.
inline int staged_route(const float* x, bool outs_aligned, long long w) {
  return w % 4 == 0 && aligned16(x) && outs_aligned ? kStagedRouteTma
                                                    : kStagedRouteAsync;
}

// The dynamic shared memory of a ring of `stages` windows of TH x TW tiles.
template <int TH, int TW>
constexpr int staged_shared_bytes(int stages) {
  return kStagedBarrierBytes + kStagedAlignSlack +
         stages * Window<TH, TW>::kStageBytes;
}

// The ring's raster arguments, a plan checked against what keeps a launch
// safe (the route rule, 2 .. kStagedMaxStages stages, the shared bytes of
// that ring, a grid), and the TMA route's tensor map.  Returns 0, or
// cudaErrorInvalidValue for a plan that disagrees, or the negated CUresult
// of a failed tensor-map encode.
template <int TH, int TW>
int staged_setup(const float* x, bool outs_aligned, long long h, long long w,
                 int route, int stages, int grid, int smem, CUtensorMap* map,
                 RingArgs* a) {
  using Win = Window<TH, TW>;
  if (route != staged_route(x, outs_aligned, w) || stages < 2 ||
      stages > kStagedMaxStages || grid <= 0 ||
      smem != staged_shared_bytes<TH, TW>(stages))
    return (int)cudaErrorInvalidValue;
  if (route == kStagedRouteTma) {
    const int err = encode_raster_map(map, x, h, w, Win::kCols, Win::kRows);
    if (err != 0) return err;
  }
  const long long tiles_x = (w + TW - 1) / TW;
  *a = RingArgs{x, h, w, tiles_x, tiles_x * ((h + TH - 1) / TH), stages};
  return 0;
}

}  // namespace xrt
