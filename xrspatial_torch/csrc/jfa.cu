// jfa_round: one jump-flood round of the nearest-target transform behind
// proximity, allocation and direction.
//
// Replaces the TPU kernels of xrspatial_tpu/kernels/pallas_jfa.py: the
// small-stride round _multi_round_small, the tile-jump round _large_round
// and the two state forms of their callers jfa_rounds_pallas (float32
// target coordinates) and jfa_rounds_packed (int32 iy<<15|ix).  Here one
// kernel takes the stride k as a runtime argument, so the whole schedule
// (powers of two, then the JFA+2 rounds 2, 1) is one binary per metric.
// The TPU kernels' T=256 pad-and-relay tiling has no counterpart: every
// thread reads its own 8 candidates with bounds checks, and an
// out-of-bounds candidate is infinitely far, as in the XLA rounds of
// xrspatial_tpu/kernels/jfa.py::_jfa_rounds.  The great-circle key calls
// libdevice sinf/cosf in place of the polynomials _sin_poly/_cos_poly/
// _gc_key_poly, which exist only because the TPU compiler builds trig
// slowly.
//
// Semantics, as the torch twins in xrspatial_torch/kernels/jfa_rounds.py:
// each cell starts from its own round-start target and key, visits the
// candidates at (i + sy*k, j + sx*k) in (sy, sx) row-major order over
// {-1,0,1}^2 without the centre, and adopts one whose key is strictly
// smaller.  Candidates come from the round-start state: the kernel reads
// state_in and writes state_out, never in place (an in-place round would
// read neighbours already updated in the same round).
//
// The keys (jfa_key.cuh) are shared with the fused group kernel
// jfa_group.cu, so both choose the same targets bit for bit.
//
// What bounds it: a round reads the state 9 times (the own cell and 8
// candidates, 4 bytes each per int32 plane) and writes it once.  At large
// strides each candidate row is a separate stream and device memory
// bounds the round; at small strides the candidates come from L1/L2 and
// the per-candidate work bounds it (64-bit index arithmetic, an
// int-to-float conversion, the key and a branch).  On an H100 80GB HBM3
// at 700 W a 16384^2 round took 3.4-5.3 ms at every stride (PERF.md).
// This is the simple first version: one thread per cell, 32x8 blocks,
// candidates straight from global memory.  Shared-memory tiles for small
// strides and an L2-friendly order for large strides are later work.

#include <cuda_runtime.h>

#include "jfa_key.cuh"

namespace {

using xrt::kEuclidean;
using xrt::kGreatCircle;
using xrt::kManhattan;
using xrt::key_coords;
using xrt::key_packed;

constexpr int kBlockX = 32, kBlockY = 8;

template <int METRIC, bool WITH_VAL>
__global__ void jfa_round_packed_kernel(
    const int* __restrict__ s_in, const float* __restrict__ v_in,
    int* __restrict__ s_out, float* __restrict__ v_out,
    float* __restrict__ best_out, long long h, long long w, long long k,
    float step_y, float step_x) {
  const long long col = (long long)blockIdx.x * kBlockX + threadIdx.x;
  if (col >= w) return;
  const long long row_step = (long long)gridDim.y * kBlockY;
  for (long long row = (long long)blockIdx.y * kBlockY + threadIdx.y;
       row < h; row += row_step) {
    const long long i = row * w + col;
    int s = s_in[i];
    float v = WITH_VAL ? v_in[i] : 0.0f;
    float best = key_packed<METRIC>((int)row, (int)col, s, step_y, step_x);
#pragma unroll
    for (int sy = -1; sy <= 1; ++sy) {
      const long long r = row + sy * k;
      if (r < 0 || r >= h) continue;
#pragma unroll
      for (int sx = -1; sx <= 1; ++sx) {
        if (sy == 0 && sx == 0) continue;
        const long long c = col + sx * k;
        if (c < 0 || c >= w) continue;
        const long long j = r * w + c;
        const int cand = s_in[j];
        const float nd =
            key_packed<METRIC>((int)row, (int)col, cand, step_y, step_x);
        if (nd < best) {
          best = nd;
          s = cand;
          if (WITH_VAL) v = v_in[j];
        }
      }
    }
    s_out[i] = s;
    if (WITH_VAL) v_out[i] = v;
    if (best_out != nullptr) best_out[i] = best;
  }
}

template <int METRIC, bool WITH_VAL>
__global__ void jfa_round_coords_kernel(
    const float* __restrict__ tx_in, const float* __restrict__ ty_in,
    const float* __restrict__ v_in, float* __restrict__ tx_out,
    float* __restrict__ ty_out, float* __restrict__ v_out,
    const float* __restrict__ xs, const float* __restrict__ ys, long long h,
    long long w, long long k) {
  const long long col = (long long)blockIdx.x * kBlockX + threadIdx.x;
  if (col >= w) return;
  const float px = xs[col];
  const long long row_step = (long long)gridDim.y * kBlockY;
  for (long long row = (long long)blockIdx.y * kBlockY + threadIdx.y;
       row < h; row += row_step) {
    const long long i = row * w + col;
    const float py = ys[row];
    float tx = tx_in[i], ty = ty_in[i];
    float v = WITH_VAL ? v_in[i] : 0.0f;
    float best = key_coords<METRIC>(px, py, tx, ty);
#pragma unroll
    for (int sy = -1; sy <= 1; ++sy) {
      const long long r = row + sy * k;
      if (r < 0 || r >= h) continue;
#pragma unroll
      for (int sx = -1; sx <= 1; ++sx) {
        if (sy == 0 && sx == 0) continue;
        const long long c = col + sx * k;
        if (c < 0 || c >= w) continue;
        const long long j = r * w + c;
        const float ctx = tx_in[j], cty = ty_in[j];
        const float nd = key_coords<METRIC>(px, py, ctx, cty);
        if (nd < best) {
          best = nd;
          tx = ctx;
          ty = cty;
          if (WITH_VAL) v = v_in[j];
        }
      }
    }
    tx_out[i] = tx;
    ty_out[i] = ty;
    if (WITH_VAL) v_out[i] = v;
  }
}

dim3 grid_for(long long h, long long w) {
  const long long blocks_y = (h + kBlockY - 1) / kBlockY;
  return dim3((unsigned)((w + kBlockX - 1) / kBlockX),
              (unsigned)(blocks_y < 65535 ? blocks_y : 65535));
}

template <int METRIC>
void launch_packed(const int* s_in, const float* v_in, int* s_out,
                   float* v_out, float* best_out, long long h, long long w,
                   long long k, float step_y, float step_x,
                   cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY), grid = grid_for(h, w);
  if (v_in != nullptr) {
    jfa_round_packed_kernel<METRIC, true><<<grid, block, 0, stream>>>(
        s_in, v_in, s_out, v_out, best_out, h, w, k, step_y, step_x);
  } else {
    jfa_round_packed_kernel<METRIC, false><<<grid, block, 0, stream>>>(
        s_in, v_in, s_out, v_out, best_out, h, w, k, step_y, step_x);
  }
}

template <int METRIC>
void launch_coords(const float* tx_in, const float* ty_in, const float* v_in,
                   float* tx_out, float* ty_out, float* v_out,
                   const float* xs, const float* ys, long long h,
                   long long w, long long k, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY), grid = grid_for(h, w);
  if (v_in != nullptr) {
    jfa_round_coords_kernel<METRIC, true><<<grid, block, 0, stream>>>(
        tx_in, ty_in, v_in, tx_out, ty_out, v_out, xs, ys, h, w, k);
  } else {
    jfa_round_coords_kernel<METRIC, false><<<grid, block, 0, stream>>>(
        tx_in, ty_in, v_in, tx_out, ty_out, v_out, xs, ys, h, w, k);
  }
}

}  // namespace

extern "C" {

// One round over the packed int32 state (iy<<15|ix, -1 for no target) and
// an optional float32 value channel (v_in and v_out both null without
// one).  metric: 0 euclidean, 2 manhattan.  best_out, when not null,
// receives each cell's float32 key after the round.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown metric.
int jfa_round_packed(const int* s_in, const float* v_in, int* s_out,
                     float* v_out, float* best_out, long long h, long long w,
                     long long k, float step_y, float step_x, int metric,
                     void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (metric == kEuclidean) {
    launch_packed<kEuclidean>(s_in, v_in, s_out, v_out, best_out, h, w, k,
                              step_y, step_x, st);
  } else if (metric == kManhattan) {
    launch_packed<kManhattan>(s_in, v_in, s_out, v_out, best_out, h, w, k,
                              step_y, step_x, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One round over the float32 coordinate state (tx, ty; inf for no target)
// and an optional float32 value channel, with the cells' coordinates xs
// (w,) and ys (h,).  metric: 0 euclidean, 1 great circle, 2 manhattan.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for an unknown metric.
int jfa_round_coords(const float* tx_in, const float* ty_in,
                     const float* v_in, float* tx_out, float* ty_out,
                     float* v_out, const float* xs, const float* ys,
                     long long h, long long w, long long k, int metric,
                     void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (metric == kEuclidean) {
    launch_coords<kEuclidean>(tx_in, ty_in, v_in, tx_out, ty_out, v_out, xs,
                              ys, h, w, k, st);
  } else if (metric == kGreatCircle) {
    launch_coords<kGreatCircle>(tx_in, ty_in, v_in, tx_out, ty_out, v_out,
                                xs, ys, h, w, k, st);
  } else if (metric == kManhattan) {
    launch_coords<kManhattan>(tx_in, ty_in, v_in, tx_out, ty_out, v_out, xs,
                              ys, h, w, k, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
