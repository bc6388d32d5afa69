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
// The walk is a compile-time parameter.  kWalkFull (every kernel's
// default) tiles the whole raster from (0, 0), so the last row and column
// of tiles are ragged and the windows at the raster's border reach out of
// it.  kWalkInterior (the stencil probes B8e and B8f) tiles only output
// rows [1, h - 1) and columns [4, w - 4): the tile at (ty, tx) starts at
// r0 = 1 + min(ty * TH, h - 2 - TH), c0 = 4 + min(tx * TW, w - 8 - TW), so
// the last row and column of tiles are pulled back to overlap their
// neighbours (which write the same bits twice) and every window lies
// wholly inside the raster; where w % 4 == 0, c0 - 4 is a multiple of 4.
// It has tiles only where h - 2 >= TH and w - 8 >= TW.
// - route phased (the stacked surface kernel B0 where TMA refuses, and by
//   name at any pitch or base): each window row is placed in a row of
//   kCols + 4 floats at its global phase f, the row's first image column's
//   float offset from a 16-byte boundary (row_phase), so that every
//   16-byte-aligned chunk of the image row lands on a 16-byte-aligned
//   shared address: the chunks wholly inside the raster are 16-byte
//   cp.async copies, the at most 3 head and 3 tail cells of a row 4-byte
//   copies, NaN outside.  Window (r, c) is shared float r * kPhasedPitch +
//   f_r + c; the reader undoes the phase (load6_phased).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tma.cuh"

namespace xrt {

constexpr int kStagedThreads = 256;
constexpr int kStagedRouteTma = 0, kStagedRouteAsync = 1,
              kStagedRoutePhased = 2;
constexpr int kStagedBarrierBytes = 128;  // the stages' mbarriers, 8 each
constexpr int kStagedAlignSlack = 128;    // room to align the ring
constexpr int kStagedMaxStages = 8;       // cp_async_wait counts up to 7
constexpr int kWalkFull = 0, kWalkInterior = 1;

// A TH x TW tile's window in shared memory: TH + 2 rows of kCols = TW + 8
// floats, window (r, c) holding image cell (r0 - 1 + r, c0 - 4 + c).
template <int TH, int TW>
struct Window {
  static constexpr int kCols = TW + 8;
  static constexpr int kRows = TH + 2;
  static constexpr int kBoxBytes = kCols * kRows * 4;
  static constexpr int kStageBytes = (kBoxBytes + 127) / 128 * 128;
  // route phased: a row of kCols + 4 floats, so that a row placed at its
  // phase (0-3 floats in) still holds its kCols cells; whole 16-byte chunks
  static constexpr int kPhasedPitch = kCols + 4;
  static constexpr int kPhasedChunks = kPhasedPitch / 4;
  static constexpr int kPhasedStageBytes =
      (kRows * kPhasedPitch * 4 + 127) / 128 * 128;
  static_assert(TW % 4 == 0, "a tile row is whole 16-byte stores");
  static_assert(kCols <= 256 && kRows <= 256, "a TMA box is at most 256");
};

// The raster and the ring a staged kernel walks; `phase` is x's offset in
// floats from a 16-byte boundary.
struct RingArgs {
  const float* x;
  long long h, w, tiles_x, tiles;
  int stages, phase;
};

// The bytes of one stage of a TH x TW tile's window on `route`.
template <int TH, int TW>
__host__ __device__ constexpr int stage_bytes(int route) {
  return route == kStagedRoutePhased ? Window<TH, TW>::kPhasedStageBytes
                                     : Window<TH, TW>::kStageBytes;
}

// Route phased: the float offset from a 16-byte boundary of image cell
// (row, c0 - 4), the first cell of a window row of the tile at column c0
// (any row, the halo's -1 and h included; & 3 is the mod of a negative
// too).
__device__ __forceinline__ int row_phase(const RingArgs& a, long long row,
                                         long long c0) {
  return (int)((a.phase + row * a.w + c0 - 4) & 3);
}

// The first row and column of tile t of the walk WALK over a raster
// a.tiles_x tiles wide.  kWalkFull: tiles STRIDE columns apart from
// (0, 0); a kernel that computes SHIFT columns left of the tile it writes
// gets its computing origin, SHIFT columns left.  kWalkInterior: TH x TW
// tiles from (1, 4), the last row and column pulled back inside (see the
// top of the file).
template <int TH, int TW, int STRIDE = TW, int SHIFT = 0,
          int WALK = kWalkFull>
__device__ __forceinline__ void tile_origin(long long t, const RingArgs& a,
                                            long long& r0, long long& c0) {
  if (WALK == kWalkInterior) {
    const long long ty = t / a.tiles_x, tx = t % a.tiles_x;
    r0 = 1 + (ty * TH < a.h - 2 - TH ? ty * TH : a.h - 2 - TH);
    c0 = 4 + (tx * TW < a.w - 8 - TW ? tx * TW : a.w - 8 - TW);
  } else {
    r0 = t / a.tiles_x * TH;
    c0 = t % a.tiles_x * STRIDE - SHIFT;
  }
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

// Every thread: the window by route phased (see the top of the file):
// chunk m of window row r covers that row's shared floats 4m .. 4m + 3,
// image columns c0 - 4 - f_r + 4m .. + 3.
template <int TH, int TW>
__device__ __forceinline__ void stage_phased(const RingArgs& a, float* win,
                                             long long r0, long long c0) {
  using Win = Window<TH, TW>;
  for (int e = threadIdx.x; e < Win::kRows * Win::kPhasedChunks;
       e += kStagedThreads) {
    const int r = e / Win::kPhasedChunks;
    const int m = e - r * Win::kPhasedChunks;
    const long long row = r0 - 1 + r;
    float* const dst = win + r * Win::kPhasedPitch + 4 * m;
    if (row < 0 || row >= a.h) {
      *reinterpret_cast<float4*>(dst) = make_float4(
          CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
      continue;
    }
    const long long col = c0 - 4 - row_phase(a, row, c0) + 4 * m;
    const float* const src = a.x + row * a.w + col;
    if (col >= 0 && col + 4 <= a.w) {
      cp_async_16(smem_addr(dst), src);  // the row's 16-byte-aligned body
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // its head or tail, NaN outside
        if (col + j >= 0 && col + j < a.w)
          cp_async_4(smem_addr(dst + j), src + j);
        else
          dst[j] = CUDART_NAN_F;
      }
    }
  }
}

// The window of the tile at (r0, c0) into `win` by every thread on a
// cp.async route (async or phased).
template <int TH, int TW, int ROUTE>
__device__ __forceinline__ void stage_copies(const RingArgs& a, float* win,
                                             long long r0, long long c0) {
  if (ROUTE == kStagedRoutePhased)
    stage_phased<TH, TW>(a, win, r0, c0);
  else
    stage_async<TH, TW>(a, win, r0, c0);
}

// The block's tiles, blockIdx.x + k * gridDim.x for k < mine, tile k
// staged in stage k % stages: calls tile(win, r0, c0) on every thread
// once tile k's window (the tile at r0, c0, tile_origin's with STRIDE,
// SHIFT and WALK) has landed in `win`.  `smem_raw` is the kernel's dynamic shared
// memory, kStagedAlignSlack + kStagedBarrierBytes + stages *
// stage_bytes(ROUTE) bytes.
template <int TH, int TW, int ROUTE, int STRIDE = TW, int SHIFT = 0,
          int WALK = kWalkFull, typename Tile>
__device__ __forceinline__ void staged_tiles(const CUtensorMap* map,
                                             const RingArgs& a,
                                             unsigned char* smem_raw,
                                             Tile tile) {
  constexpr int kStageBytes = stage_bytes<TH, TW>(ROUTE);
  constexpr int kStageFloats = kStageBytes / 4;
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
        tile_origin<TH, TW, STRIDE, SHIFT, WALK>(blockIdx.x + s * step, a,
                                                 r0, c0);
        stage_tma<TH, TW>(map, ring_addr + s * kStageBytes, bars + 8 * s,
                          r0, c0);
      }
    }
    __syncthreads();
  } else {
    for (int s = 0; s + 1 < a.stages; ++s) {
      if (s < mine) {
        tile_origin<TH, TW, STRIDE, SHIFT, WALK>(blockIdx.x + s * step, a,
                                                 r0, c0);
        stage_copies<TH, TW, ROUTE>(a, ring + s * kStageFloats, r0, c0);
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
        tile_origin<TH, TW, STRIDE, SHIFT, WALK>(blockIdx.x + j * step, a,
                                                 r0, c0);
        stage_copies<TH, TW, ROUTE>(
            a, ring + (int)(j % a.stages) * kStageFloats, r0, c0);
      }
      cp_async_commit();
      cp_async_wait(a.stages - 1);
      __syncthreads();
    }
    tile_origin<TH, TW, STRIDE, SHIFT, WALK>(blockIdx.x + k * step, a, r0,
                                             c0);
    tile(static_cast<const float*>(ring + s * kStageFloats), r0, c0);
    __syncthreads();  // every thread has left stage s
    if (ROUTE == kStagedRouteTma && tid == 0 && k + a.stages < mine) {
      tile_origin<TH, TW, STRIDE, SHIFT, WALK>(
          blockIdx.x + (k + a.stages) * step, a, r0, c0);
      stage_tma<TH, TW>(map, ring_addr + s * kStageBytes, bars + 8 * s, r0,
                        c0);
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

// The dynamic shared memory of a ring of `stages` windows of TH x TW tiles
// on `route`.
template <int TH, int TW>
constexpr int staged_shared_bytes(int stages, int route = kStagedRouteTma) {
  return kStagedBarrierBytes + kStagedAlignSlack +
         stages * stage_bytes<TH, TW>(route);
}

// The ring's raster arguments, a plan checked against what keeps a launch
// safe (TMA or async: the route rule's; phased, which takes any pitch and
// base, where the caller asks for it; 2 .. kStagedMaxStages stages, the
// shared bytes of that ring, a grid), and the TMA route's tensor map.
// On kWalkFull, tiles lie `stride` columns apart and cover w + `reach`
// columns; kWalkInterior has its own tiles (tile_origin), none where
// h - 2 < TH or w - 8 < TW.  Returns 0, or cudaErrorInvalidValue for a
// plan that disagrees, or the negated CUresult of a failed tensor-map
// encode.
template <int TH, int TW>
int staged_setup(const float* x, bool outs_aligned, long long h, long long w,
                 int route, int stages, int grid, int smem, CUtensorMap* map,
                 RingArgs* a, long long stride = TW, long long reach = 0,
                 int walk = kWalkFull) {
  using Win = Window<TH, TW>;
  if ((route != kStagedRoutePhased &&
       route != staged_route(x, outs_aligned, w)) ||
      stages < 2 || stages > kStagedMaxStages || grid <= 0 ||
      smem != staged_shared_bytes<TH, TW>(stages, route))
    return (int)cudaErrorInvalidValue;
  if (route == kStagedRouteTma) {
    const int err = encode_raster_map(map, x, h, w, Win::kCols, Win::kRows);
    if (err != 0) return err;
  }
  long long tiles_x = (w + reach + stride - 1) / stride;
  long long tiles_y = (h + TH - 1) / TH;
  if (walk == kWalkInterior) {
    const bool any = h - 2 >= TH && w - 8 >= TW;
    tiles_x = any ? (w - 8 + TW - 1) / TW : 0;
    tiles_y = any ? (h - 2 + TH - 1) / TH : 0;
  }
  *a = RingArgs{x,      h, w, tiles_x, tiles_x * tiles_y,
                stages, (int)(((uintptr_t)x >> 2) & 3)};
  return 0;
}

}  // namespace xrt
