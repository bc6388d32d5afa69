// Staging of a jump-flood window in shared memory, shared by jfa.cu's
// staged route and jfa_group.cu's single-buffered route.
//
// A window is `rows` x `pitch` cells of each plane, whose cell (0, 0) is
// raster cell (r0, c0); plane q starts at win + q * plane_words.  The
// first `state` planes are the state (1 packed, 2 coordinates), the rest
// a value plane.  Cells outside the raster must read as no target:
// - by TMA (tma_load_2d, one box a plane, all on one mbarrier) where the
//   pitch and every base are 16-byte aligned and c0 is a multiple of 4.
//   TMA fills out-of-bounds cells with 0 (tma.cuh's encode_word_map), and
//   0 is a real packed target (row 0, column 0); a NaN fill read as an
//   int32 would be 0x7FFFFFFF, a far but valid-looking target.  So a
//   block whose window crosses the raster's edge writes the sentinel
//   (-1 packed, +inf coordinates) there after the copy has landed;
// - by 4-byte cp.async elsewhere, which writes the sentinel itself.
// A value plane outside the raster is never read (an out-of-bounds
// candidate's key is inf, and inf < best is false) and stays as it falls.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "jfa_key.cuh"
#include "tma.cuh"

namespace xrt {

constexpr int kStageTma = 0, kStageAsync = 1;

struct WindowMaps {
  CUtensorMap m[3];  // one a plane, in plane order
};

template <int FORM>
__device__ __forceinline__ int plane_sentinel(int q) {
  return q == 0 ? StateForm<FORM>::kSentinel : kInfBits;
}

// Stages the window; every thread of the block calls it, and it returns
// after a barrier, with the window ready.  `maps` is the kernel's
// __grid_constant__ parameter; `in` the planes' bases in device memory.
template <int FORM>
__device__ __forceinline__ void stage_window(
    const WindowMaps& maps, const int* const* in, int planes, int* win,
    int plane_words, int rows, int pitch, long long r0, long long c0,
    long long h, long long w, int stage, uint32_t bar, int tid,
    int nthreads) {
  constexpr int S = StateForm<FORM>::kPlanes;
  const int cells = rows * pitch;
  if (stage == kStageTma) {
    if (tid == 0) {
      mbar_init(bar, 1);
      mbar_fence_init();
      mbar_expect_tx(bar, (uint32_t)(planes * cells * 4));
      for (int q = 0; q < planes; ++q)
        tma_load_2d(smem_addr(win + q * plane_words), &maps.m[q], (int)c0,
                    (int)r0, bar);
    }
    __syncthreads();  // the mbarrier is initialised before anyone waits
    mbar_wait(bar, 0);
    if (r0 < 0 || r0 + rows > h || c0 < 0 || c0 + pitch > w) {
      for (int e = tid; e < cells; e += nthreads) {
        const int y = e / pitch;
        const long long row = r0 + y, col = c0 + (e - y * pitch);
        if (row < 0 || row >= h || col < 0 || col >= w) {
#pragma unroll
          for (int q = 0; q < S; ++q)
            win[q * plane_words + e] = plane_sentinel<FORM>(q);
        }
      }
    }
  } else {
    for (int e = tid; e < cells; e += nthreads) {
      const int y = e / pitch;
      const long long row = r0 + y, col = c0 + (e - y * pitch);
      const bool inside = row >= 0 && row < h && col >= 0 && col < w;
      const long long g = row * w + col;
      for (int q = 0; q < planes; ++q) {
        if (inside)
          cp_async_4(smem_addr(win + q * plane_words + e), in[q] + g);
        else
          win[q * plane_words + e] = q < S ? plane_sentinel<FORM>(q) : 0;
      }
    }
    cp_async_commit();
    cp_async_wait(0);
  }
  __syncthreads();
}

// Host side: the maps of `planes` planes for a window of box_cols x
// box_rows; 0 or the first failed encode's code.
inline int encode_window_maps(WindowMaps* maps, const void* const* in,
                              int planes, long long h, long long w,
                              int box_cols, int box_rows) {
  for (int q = 0; q < planes; ++q) {
    const int err =
        encode_word_map(&maps->m[q], in[q], h, w, box_cols, box_rows);
    if (err != 0) return err;
  }
  return 0;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace xrt
