// jfa_group: a group of small-stride jump-flood rounds in one launch.
//
// Replaces the TPU probe tools/exp_jfa_fixed.py::multi_round_fixed: one
// kernel runs the strides ks (H = sum(ks)) over one fixed window of
// (T+2H)^2 cells per block.  Each block loads its window of the state
// into shared memory (cells outside the raster hold the no-target
// sentinel: -1 packed, inf coordinates), runs the rounds there, and
// writes its T x T centre.  No value plane, as in the TPU probe.  The TPU
// probe's neighbour reads by pltpu.roll have no counterpart: a thread
// reads its candidates from shared memory at (y + sy*k, x + sx*k).
//
// Semantics of each round are jfa.cu's (the keys are jfa_key.cuh, shared
// with it): a cell starts from its own round-start target and key, visits
// the 8 candidates in (sy, sx) row-major order and adopts one whose key is
// strictly smaller.  Round-start values come from the other half of a
// double buffer.  Round r writes only the cells within m_r = sum(ks[r+1:])
// of the centre, and its candidates then lie within m_r + k_r = m_{r-1}
// <= H: inside the window, and in the cells round r-1 wrote.  By
// induction every cell a round writes equals jfa_round's value after the
// same rounds, so the T x T centre equals jfa_round applied round by
// round, bit for bit, and no candidate is ever outside the window.  The
// shrinking region also cuts the work: for proximity's tail group
// (16, 8, 4, 2, 1, 2, 1) at T = 64, 41,412 cell-rounds a block instead of
// 7 x 132^2 = 121,968.
//
// What bounds it: the state is read once and written once (2 planes of
// 4 bytes a cell), and each of the group's rounds evaluates 8 candidates
// a cell (8 float operations each, jfa.cu's count): at 7 rounds the
// operations bound it (1.20e11 at 16384^2, 1.80 ms at 67 TFLOP/s against
// 0.64 ms for the bytes).  Shared memory bounds the window: a block may
// use 227 KB, so the wrapper (kernels/cuda_jfa_group.py) takes the largest
// T in (128, 64, 32, 16, 8) whose double-buffered window fits, and refuses
// a group that fits at none (the TPU probe's H = 130).  The window is
// reloaded by every block that overlaps it: (T+2H)^2 / T^2 reads a cell
// (4.25 at T = 64, H = 34), most of them from L2.  Simple first version:
// 32 x 32 threads, one block per tile, barriers between rounds.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "jfa_key.cuh"

namespace {

using xrt::kEuclidean;
using xrt::kGreatCircle;
using xrt::kManhattan;

constexpr int kThreadsX = 32, kThreadsY = 32;
constexpr int kMaxRounds = 16;

struct Group {
  int n;                // rounds
  int k[kMaxRounds];    // strides, in order
};

// Runs the group's rounds on a block's window, whose row 0 and column 0
// are raster row r0 and column c0.  `visit(cur, y, x, row, col, k)`
// computes window cell (y, x) = raster cell (row, col) of a round at
// stride k from buffer `cur` into buffer cur ^ 1.  Returns the index of
// the buffer that holds the last round.
template <typename Visit>
__device__ __forceinline__ int run_rounds(const Group& g, int H, int tile,
                                          long long r0, long long c0,
                                          long long h, long long w,
                                          Visit visit) {
  int m = H;
  int cur = 0;
  for (int r = 0; r < g.n; ++r) {
    const int k = g.k[r];
    m -= k;
    __syncthreads();
    const int lo = H - m, hi = H + tile + m;
    for (int y = lo + (int)threadIdx.y; y < hi; y += kThreadsY) {
      const long long row = r0 + y;
      if (row < 0 || row >= h) continue;
      for (int x = lo + (int)threadIdx.x; x < hi; x += kThreadsX) {
        const long long col = c0 + x;
        if (col < 0 || col >= w) continue;
        visit(cur, y, x, row, col, k);
      }
    }
    cur ^= 1;
  }
  __syncthreads();
  return cur;
}

template <int METRIC>
__global__ void __launch_bounds__(kThreadsX* kThreadsY)
    jfa_group_packed_kernel(const int* __restrict__ s_in,
                            int* __restrict__ s_out, long long h, long long w,
                            Group g, int H, int tile, float step_y,
                            float step_x) {
  extern __shared__ int smem_i[];
  // two buffers of side^2 cells; buffer b starts at smem_i + b * cells
  // (plain offsets: an array of the two pointers would live on the stack)
  const int side = tile + 2 * H, cells = side * side;
  const long long r0 = (long long)blockIdx.y * tile - H;
  const long long c0 = (long long)blockIdx.x * tile - H;
  for (int y = threadIdx.y; y < side; y += kThreadsY) {
    const long long row = r0 + y;
    for (int x = threadIdx.x; x < side; x += kThreadsX) {
      const long long col = c0 + x;
      const int v = (row >= 0 && row < h && col >= 0 && col < w)
                        ? s_in[row * w + col]
                        : -1;
      // cells outside the raster are never written: both buffers hold
      // the sentinel there
      smem_i[y * side + x] = v;
      smem_i[cells + y * side + x] = v;
    }
  }
  const int out = run_rounds(
      g, H, tile, r0, c0, h, w,
      [&](int cur, int y, int x, long long row, long long col, int k) {
        const int* src = smem_i + cur * cells;
        int s = src[y * side + x];
        float best = xrt::key_packed<METRIC>((int)row, (int)col, s, step_y,
                                             step_x);
#pragma unroll
        for (int sy = -1; sy <= 1; ++sy) {
#pragma unroll
          for (int sx = -1; sx <= 1; ++sx) {
            if (sy == 0 && sx == 0) continue;
            const int cand = src[(y + sy * k) * side + x + sx * k];
            const float nd = xrt::key_packed<METRIC>((int)row, (int)col,
                                                     cand, step_y, step_x);
            if (nd < best) {
              best = nd;
              s = cand;
            }
          }
        }
        smem_i[(cur ^ 1) * cells + y * side + x] = s;
      });
  for (int y = H + threadIdx.y; y < H + tile; y += kThreadsY) {
    const long long row = r0 + y;
    if (row >= h) break;
    for (int x = H + threadIdx.x; x < H + tile; x += kThreadsX) {
      const long long col = c0 + x;
      if (col >= w) break;
      s_out[row * w + col] = smem_i[out * cells + y * side + x];
    }
  }
}

template <int METRIC>
__global__ void __launch_bounds__(kThreadsX* kThreadsY)
    jfa_group_coords_kernel(const float* __restrict__ tx_in,
                            const float* __restrict__ ty_in,
                            float* __restrict__ tx_out,
                            float* __restrict__ ty_out,
                            const float* __restrict__ xs,
                            const float* __restrict__ ys, long long h,
                            long long w, Group g, int H, int tile) {
  extern __shared__ float smem_f[];
  // tx in buffers 0 and 1, ty in buffers 2 and 3, side^2 cells each
  const int side = tile + 2 * H, cells = side * side;
  float* const ty_buf = smem_f + 2 * cells;
  const long long r0 = (long long)blockIdx.y * tile - H;
  const long long c0 = (long long)blockIdx.x * tile - H;
  for (int y = threadIdx.y; y < side; y += kThreadsY) {
    const long long row = r0 + y;
    for (int x = threadIdx.x; x < side; x += kThreadsX) {
      const long long col = c0 + x;
      const bool in = row >= 0 && row < h && col >= 0 && col < w;
      const float vx = in ? tx_in[row * w + col] : CUDART_INF_F;
      const float vy = in ? ty_in[row * w + col] : CUDART_INF_F;
      smem_f[y * side + x] = smem_f[cells + y * side + x] = vx;
      ty_buf[y * side + x] = ty_buf[cells + y * side + x] = vy;
    }
  }
  const int out = run_rounds(
      g, H, tile, r0, c0, h, w,
      [&](int cur, int y, int x, long long row, long long col, int k) {
        const float px = xs[col], py = ys[row];
        const float* tx_in_buf = smem_f + cur * cells;
        const float* ty_in_buf = ty_buf + cur * cells;
        const int i = y * side + x;
        float tx = tx_in_buf[i], ty = ty_in_buf[i];
        float best = xrt::key_coords<METRIC>(px, py, tx, ty);
#pragma unroll
        for (int sy = -1; sy <= 1; ++sy) {
#pragma unroll
          for (int sx = -1; sx <= 1; ++sx) {
            if (sy == 0 && sx == 0) continue;
            const int j = i + (sy * side + sx) * k;
            const float ctx = tx_in_buf[j], cty = ty_in_buf[j];
            const float nd = xrt::key_coords<METRIC>(px, py, ctx, cty);
            if (nd < best) {
              best = nd;
              tx = ctx;
              ty = cty;
            }
          }
        }
        smem_f[(cur ^ 1) * cells + i] = tx;
        ty_buf[(cur ^ 1) * cells + i] = ty;
      });
  for (int y = H + threadIdx.y; y < H + tile; y += kThreadsY) {
    const long long row = r0 + y;
    if (row >= h) break;
    for (int x = H + threadIdx.x; x < H + tile; x += kThreadsX) {
      const long long col = c0 + x;
      if (col >= w) break;
      tx_out[row * w + col] = smem_f[out * cells + y * side + x];
      ty_out[row * w + col] = ty_buf[out * cells + y * side + x];
    }
  }
}

// Sets the kernel's dynamic shared memory limit when above the default
// 48 KB, then launches it on a (ceil(w/tile), ceil(h/tile)) grid.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, long long h, long long w, int tile,
           cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((w + tile - 1) / tile),
                  (unsigned)((h + tile - 1) / tile));
  kernel<<<grid, dim3(kThreadsX, kThreadsY), smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

bool make_group(const int* ks, int n, Group* g, int* H) {
  if (n < 1 || n > kMaxRounds) return false;
  g->n = n;
  *H = 0;
  for (int r = 0; r < n; ++r) {
    if (ks[r] < 1) return false;
    g->k[r] = ks[r];
    *H += ks[r];
  }
  return true;
}

}  // namespace

extern "C" {

// The group of `n` strides `ks` over the packed int32 state (iy<<15|ix,
// -1 for none) of an h x w raster, on tiles of `tile` cells with `smem`
// bytes of shared memory (2 (tile+2H)^2 int32).  metric: 0 euclidean,
// 2 manhattan.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unknown metric or a bad group.
int jfa_group_packed(const int* s_in, int* s_out, long long h, long long w,
                     const int* ks, int n, int tile, int smem, float step_y,
                     float step_x, int metric, void* stream) {
  Group g;
  int H;
  if (!make_group(ks, n, &g, &H) || tile < 1) return cudaErrorInvalidValue;
  if (h <= 0 || w <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (metric == kEuclidean)
    return launch(jfa_group_packed_kernel<kEuclidean>, smem, h, w, tile, st,
                  s_in, s_out, h, w, g, H, tile, step_y, step_x);
  if (metric == kManhattan)
    return launch(jfa_group_packed_kernel<kManhattan>, smem, h, w, tile, st,
                  s_in, s_out, h, w, g, H, tile, step_y, step_x);
  return cudaErrorInvalidValue;
}

// The group over the float32 coordinate state (tx, ty; inf for none) with
// the cells' coordinates xs (w,) and ys (h,); `smem` is 4 (tile+2H)^2
// float32.  metric: 0 euclidean, 1 great circle, 2 manhattan.
int jfa_group_coords(const float* tx_in, const float* ty_in, float* tx_out,
                     float* ty_out, const float* xs, const float* ys,
                     long long h, long long w, const int* ks, int n, int tile,
                     int smem, int metric, void* stream) {
  Group g;
  int H;
  if (!make_group(ks, n, &g, &H) || tile < 1) return cudaErrorInvalidValue;
  if (h <= 0 || w <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (metric == kEuclidean)
    return launch(jfa_group_coords_kernel<kEuclidean>, smem, h, w, tile, st,
                  tx_in, ty_in, tx_out, ty_out, xs, ys, h, w, g, H, tile);
  if (metric == kGreatCircle)
    return launch(jfa_group_coords_kernel<kGreatCircle>, smem, h, w, tile, st,
                  tx_in, ty_in, tx_out, ty_out, xs, ys, h, w, g, H, tile);
  if (metric == kManhattan)
    return launch(jfa_group_coords_kernel<kManhattan>, smem, h, w, tile, st,
                  tx_in, ty_in, tx_out, ty_out, xs, ys, h, w, g, H, tile);
  return cudaErrorInvalidValue;
}

}  // extern "C"
