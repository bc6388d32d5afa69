// jfa_round: one jump-flood round of the nearest-target transform behind
// proximity, allocation and direction.
//
// Replaces the TPU kernels of xrspatial_tpu/kernels/pallas_jfa.py: the
// small-stride round _multi_round_small (B6a), the tile-jump round
// _large_round (B6b) and the two state forms of their callers
// jfa_rounds_pallas (float32 target coordinates) and jfa_rounds_packed
// (int32 iy<<15|ix) (B6c).  The stride k is a runtime argument, so the
// whole schedule (powers of two, then the JFA+2 rounds 2, 1) runs on one
// set of binaries.  The great-circle key calls libdevice sinf/cosf in
// place of the polynomials _sin_poly/_cos_poly/_gc_key_poly, which exist
// only because the TPU compiler builds trig slowly.
//
// Semantics, as the torch twins in xrspatial_torch/kernels/jfa_rounds.py:
// each cell starts from its own round-start target and key, visits the
// candidates at (i + sy*k, j + sx*k) in (sy, sx) row-major order over
// {-1,0,1}^2 without the centre, and adopts one whose key is strictly
// smaller; an out-of-bounds candidate is infinitely far.  Candidates come
// from the round-start state: every route reads state_in and writes
// state_out, never in place.  The keys and the candidate step (key_of,
// adopt) are jfa_key.cuh's, shared with jfa_group.cu, so every route of
// both kernels chooses the same targets bit for bit.
//
// What bounds a round on the H100: it moves the state once in and once
// out (8 bytes a cell a plane; 2 GiB for the packed state at 16384^2,
// 0.64 ms at 3.35 TB/s) and issues ~20 instructions a candidate, 9
// candidates a cell.  The first port (route simple below) took 3.4-5.3 ms
// a round at every stride: one thread a cell with 64-bit index
// arithmetic, and nine scalar loads each behind its own bounds test and
// `continue`, so they were never in flight together: bound by load
// latency and instruction count.  At large strides the rows r-k and r+k
// are refetched from device memory once the reuse distance (2k rows)
// passes the L2.  kernels/jfa_plan.py::round_plan chooses a route for each
// round; the launcher checks only the rules that keep a launch safe.
//
// - staged (small strides; k = 1, 2, where 16-byte loads at c +- k would
//   be misaligned, and any multiple of 4 up to 64): a block of 256 threads
//   takes a TH x 128 tile, stages its window (TH + 2k rows, 128 + 2 pad
//   columns, pad = k rounded up to 4 so that the box starts 16-byte
//   aligned) of every plane in shared memory by TMA, one box a plane, or
//   by cp.async where TMA refuses the pitch or a base (jfa_stage.cuh,
//   which also writes the no-target sentinel over TMA's zero fill outside
//   the raster).  Each thread evaluates 4 cells along x from three 16-byte
//   shared loads a candidate row and plane, with no bounds test; a warp
//   reads 512 consecutive bytes, conflict-free.
// - vector (k a multiple of 4, w % 4 == 0, 16-byte aligned planes,
//   h*w < 2^31): each thread owns 4 consecutive cells of one row and
//   issues 9 unconditional 16-byte loads, one at each candidate position,
//   before any comparison.  A position outside the raster gets a clamped
//   address and the sentinel (whole 4-cell groups are in or out, since w
//   and k are multiples of 4).  Offsets are 32-bit.  The value plane is
//   read once a cell, at the winner, after the comparisons: the same
//   value as the first port's load inside the branch, since the winner is
//   the last strict improvement.  Where 2k rows of state pass a quarter
//   of L2, blocks take the rows in k-phase order (r, r + k, r + 2k, ...),
//   so that each row band is fetched from device memory about once a
//   round instead of three times.
// - simple: the first port, one thread a cell, 32x8 blocks, candidates
//   straight from global memory with bounds tests; where neither new
//   route can run (w % 4 != 0 or an unaligned base at a vector stride)
//   and by name, for the A/B and the bit check.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 8, PERF.md):
// a round at 16384^2 takes 0.86-0.95 ms staged (k <= 32), 1.14-1.37 ms
// vector and 3.4-5.3 ms simple on proximity's first state; 1.6 / 1.9 / 4.3-
// 5.6 ms on a state with targets everywhere, where every candidate costs
// its full key.  Both new routes sit near their issue floor (~20
// instructions a candidate), not at the 0.64 ms of the bytes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "jfa_key.cuh"
#include "jfa_stage.cuh"

namespace {

using xrt::kEuclidean;
using xrt::kGreatCircle;
using xrt::kManhattan;
using xrt::key_coords;
using xrt::key_packed;

// -- the simple route (the first port) ---------------------------------------

constexpr int kBlockX = 32, kBlockY = 8;

template <int METRIC, bool WITH_VAL>
__global__ void jfa_round_packed_kernel(
    const int* __restrict__ s_in, const float* __restrict__ v_in,
    int* __restrict__ s_out, float* __restrict__ v_out,
    float* __restrict__ best_out, long long h, long long w, long long k,
    float step_y, float step_x, int row0, int col0) {
  const long long col = (long long)blockIdx.x * kBlockX + threadIdx.x;
  if (col >= w) return;
  const long long row_step = (long long)gridDim.y * kBlockY;
  for (long long row = (long long)blockIdx.y * kBlockY + threadIdx.y;
       row < h; row += row_step) {
    const long long i = row * w + col;
    // the cell's own indices in the whole raster: the block's origin plus
    // its place in the block (the origin is 0 outside a mesh)
    const int iy = (int)row + row0, ix = (int)col + col0;
    int s = s_in[i];
    float v = WITH_VAL ? v_in[i] : 0.0f;
    float best = key_packed<METRIC>(iy, ix, s, step_y, step_x);
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
        const float nd = key_packed<METRIC>(iy, ix, cand, step_y, step_x);
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
                   long long k, float step_y, float step_x, int row0,
                   int col0, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY), grid = grid_for(h, w);
  if (v_in != nullptr) {
    jfa_round_packed_kernel<METRIC, true><<<grid, block, 0, stream>>>(
        s_in, v_in, s_out, v_out, best_out, h, w, k, step_y, step_x, row0,
        col0);
  } else {
    jfa_round_packed_kernel<METRIC, false><<<grid, block, 0, stream>>>(
        s_in, v_in, s_out, v_out, best_out, h, w, k, step_y, step_x, row0,
        col0);
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

// -- the staged and vector routes -------------------------------------------

using xrt::kCoords;
using xrt::kPacked;
using xrt::Pos;
using xrt::StateForm;

constexpr int kRouteStaged = 0, kRouteVector = 1;
constexpr int kThreads = 256;   // a block of either route
constexpr int kCells = 4;       // cells along x a thread
constexpr int kTileCols = 128;  // staged: a warp's 32 lanes x kCells
constexpr int kWarps = kThreads / 32;
constexpr int kBoxMax = 256;
constexpr int kAlignSlack = 128, kBarrierBytes = 128;
constexpr long long kSmemPerBlock = 232448;

long long round_up(long long a, long long b) { return (a + b - 1) / b * b; }

struct RoundArgs {
  const int* in[3];  // the state planes (1 packed, 2 coordinates), the value
  int* out[3];       // likewise
  float* best;       // each cell's key after the round, or null
  const float* xs;   // coordinates: the cells' x (w,) and y (h,)
  const float* ys;
  int h, w, k;
  float step_y, step_x;
  int row0, col0;  // packed: the block's origin in the whole raster
  int stage, th, pad, pitch, rows, tiles_x, plane_words;  // staged
  int per_row, phased;                                   // vector
};

__device__ __forceinline__ Pos cell_pos(int row, int col, float px,
                                        float py) {
  Pos p;
  p.iy = row;
  p.ix = col;
  p.px = px;
  p.py = py;
  return p;
}

// x of the cells col .. col + 3 (coordinates only; clamped to the raster)
template <int FORM>
__device__ __forceinline__ void cells_x(const RoundArgs& a, int col,
                                        float (&px)[kCells]) {
#pragma unroll
  for (int j = 0; j < kCells; ++j)
    px[j] = FORM == kCoords ? a.xs[col + j < a.w ? col + j : a.w - 1] : 0.0f;
}

__device__ __forceinline__ void put4(int* v, int4 q) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// The outputs of cells col .. col + 3 of `row`: 16-byte stores where the
// planes allow them (`wide`: w % 4 == 0 and aligned bases), else one a
// cell inside the raster.
template <int S, bool WITH_VAL>
__device__ __forceinline__ void store_cells(const RoundArgs& a, int row,
                                            int col, bool wide,
                                            const int (&s0)[kCells],
                                            const int (&s1)[kCells],
                                            const float (&v)[kCells],
                                            const float (&best)[kCells]) {
  const long long i = (long long)row * a.w + col;
  if (wide) {
    *reinterpret_cast<int4*>(a.out[0] + i) =
        make_int4(s0[0], s0[1], s0[2], s0[3]);
    if (S == 2)
      *reinterpret_cast<int4*>(a.out[1] + i) =
          make_int4(s1[0], s1[1], s1[2], s1[3]);
    if (WITH_VAL)
      *reinterpret_cast<float4*>(a.out[S] + i) =
          make_float4(v[0], v[1], v[2], v[3]);
    if (a.best != nullptr)
      *reinterpret_cast<float4*>(a.best + i) =
          make_float4(best[0], best[1], best[2], best[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    if (col + j >= a.w) break;
    a.out[0][i + j] = s0[j];
    if (S == 2) a.out[1][i + j] = s1[j];
    if (WITH_VAL) reinterpret_cast<float*>(a.out[S])[i + j] = v[j];
    if (a.best != nullptr) a.best[i + j] = best[j];
  }
}

// The staged route.  KS: the stride when it is 1 or 2 (a row's 12 loaded
// words cover columns wx - 4 .. wx + 7), or 0 for a multiple of 4 (the
// three groups at wx - k, wx, wx + k); either way candidate (sx, cell j)
// of a row is word 4 + j + sx * D of it.  ORIGIN: the packed state of a
// mesh block, whose cells lie at (row0 + row, col0 + col) in the whole
// raster; a separate instantiation, since the two adds a cell cost the
// whole raster's rounds ~3% on this issue-bound kernel.
template <int FORM, int METRIC, bool WITH_VAL, bool ORIGIN, int KS>
__global__ void __launch_bounds__(kThreads)
    jfa_staged_kernel(const __grid_constant__ xrt::WindowMaps maps,
                      const RoundArgs a) {
  constexpr int S = StateForm<FORM>::kPlanes;
  constexpr int D = KS > 0 ? KS : 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = xrt::smem_addr(smem_raw);
  unsigned char* const smem = smem_raw + (((raw + 127u) & ~127u) - raw);
  int* const win = reinterpret_cast<int*>(smem + kBarrierBytes);
  const int tid = threadIdx.x;
  const int k = KS > 0 ? KS : a.k;
  const int r0 = (int)(blockIdx.x / a.tiles_x) * a.th;
  const int c0 = (int)(blockIdx.x % a.tiles_x) * kTileCols;
  xrt::stage_window<FORM>(maps, a.in, S + (WITH_VAL ? 1 : 0), win,
                          a.plane_words, a.rows, a.pitch, r0 - k, c0 - a.pad,
                          a.h, a.w, a.stage, xrt::smem_addr(smem), tid,
                          kThreads);

  const int lane = tid & 31;
  const int col = c0 + kCells * lane;
  if (col >= a.w) return;  // no barrier follows
  const bool wide = a.stage == xrt::kStageTma;
  const int wx = a.pad + kCells * lane;  // the window column of cell 0
  const int G = KS > 0 ? 4 : k;          // columns between loaded groups
  float px[kCells];
  cells_x<FORM>(a, col, px);
  for (int tr = tid >> 5; tr < a.th; tr += kWarps) {
    const int row = r0 + tr;
    if (row >= a.h) break;
    const int wy = tr + k;  // the window row of the cells
    // the 12 words of each state plane on window row wy + sy * k
    auto load_row = [&](int sy, int (&v)[S][12]) {
      const int base = (wy + sy * k) * a.pitch + wx;
#pragma unroll
      for (int q = 0; q < S; ++q)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          put4(v[q] + 4 * g, *reinterpret_cast<const int4*>(
                                 win + q * a.plane_words + base +
                                 (g - 1) * G));
    };
    const float py = FORM == kCoords ? a.ys[row] : 0.0f;
    Pos p[kCells];
    int s0[kCells], s1[kCells];
    float best[kCells];
    int wo[kCells];  // the window offset of each cell's winner
    int vc[S][12], vr[S][12];
    load_row(0, vc);
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      p[j] = cell_pos(ORIGIN ? row + a.row0 : row,
                      ORIGIN ? col + j + a.col0 : col + j, px[j], py);
      s0[j] = vc[0][4 + j];
      s1[j] = S == 2 ? vc[S - 1][4 + j] : 0;
      best[j] = xrt::key_of<FORM, METRIC>(p[j], s0[j], s1[j], a.step_y,
                                          a.step_x);
      wo[j] = wy * a.pitch + wx + j;
    }
    auto visit_row = [&](int sy, const int (&v)[S][12]) {
#pragma unroll
      for (int sx = -1; sx <= 1; ++sx) {
        if (sy == 0 && sx == 0) continue;
#pragma unroll
        for (int j = 0; j < kCells; ++j) {
          const int i = 4 + j + sx * D;
          if (xrt::adopt<FORM, METRIC>(p[j], a.step_y, a.step_x, v[0][i],
                                       S == 2 ? v[S - 1][i] : 0, best[j],
                                       s0[j], s1[j]) &&
              WITH_VAL)
            wo[j] = (wy + sy * k) * a.pitch + wx + j + sx * k;
        }
      }
    };
    load_row(-1, vr);
    visit_row(-1, vr);
    visit_row(0, vc);
    load_row(1, vr);
    visit_row(1, vr);
    float val[kCells];
#pragma unroll
    for (int j = 0; j < kCells; ++j)
      val[j] = WITH_VAL ? __int_as_float(win[S * a.plane_words + wo[j]])
                        : 0.0f;
    store_cells<S, WITH_VAL>(a, row, col, wide, s0, s1, val, best);
  }
}

// The row of the vector route's row slot t: t itself, or in k-phase order
// the slots run over rows p, p + k, p + 2k, ... for p = 0 .. k - 1
// (kernels/jfa_plan.py::phase_rows).
__device__ __forceinline__ int slot_row(int t, int h, int k, bool phased) {
  if (!phased) return t;
  const int q = h / k, rem = h - q * k;
  int p, j;
  if (t < rem * (q + 1)) {
    p = t / (q + 1);
    j = t - p * (q + 1);
  } else {
    const int t2 = t - rem * (q + 1);
    p = rem + t2 / q;
    j = t2 - (p - rem) * q;
  }
  return p + j * k;
}

template <int FORM, int METRIC, bool WITH_VAL, bool ORIGIN>
__global__ void __launch_bounds__(kThreads)
    jfa_vector_kernel(const RoundArgs a) {
  constexpr int S = StateForm<FORM>::kPlanes;
  const int t = blockIdx.x / a.per_row;
  const int col =
      ((blockIdx.x - t * a.per_row) * kThreads + threadIdx.x) * kCells;
  if (col >= a.w) return;
  const int h = a.h, w = a.w, k = a.k;
  const int row = slot_row(t, h, k, a.phased != 0);
  // the 9 positions, loaded before any comparison; (sy, sx) row-major
  int4 g[9][S];
  int idx[9];
  bool ok[9];
#pragma unroll
  for (int sy = -1; sy <= 1; ++sy) {
    const int r = row + sy * k;
    const bool in_r = (unsigned)r < (unsigned)h;
    const int rr = in_r ? r : row;
#pragma unroll
    for (int sx = -1; sx <= 1; ++sx) {
      const int c = col + sx * k;
      const bool in_c = (unsigned)c < (unsigned)w;
      const int n = (sy + 1) * 3 + sx + 1;
      idx[n] = rr * w + (in_c ? c : col);
      ok[n] = in_r && in_c;
#pragma unroll
      for (int q = 0; q < S; ++q)
        g[n][q] = __ldg(reinterpret_cast<const int4*>(a.in[q] + idx[n]));
    }
  }
  const float py = FORM == kCoords ? a.ys[row] : 0.0f;
  float px[kCells];
  cells_x<FORM>(a, col, px);
  Pos p[kCells];
  int s0[kCells], s1[kCells], wi[kCells];
  float best[kCells];
  put4(s0, g[4][0]);
  put4(s1, g[4][S - 1]);
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    p[j] = cell_pos(ORIGIN ? row + a.row0 : row,
                    ORIGIN ? col + j + a.col0 : col + j, px[j], py);
    if (S == 1) s1[j] = 0;
    best[j] = xrt::key_of<FORM, METRIC>(p[j], s0[j], s1[j], a.step_y,
                                        a.step_x);
    wi[j] = idx[4] + j;
  }
#pragma unroll
  for (int n = 0; n < 9; ++n) {
    if (n == 4) continue;
    int c[S][kCells];
#pragma unroll
    for (int q = 0; q < S; ++q) put4(c[q], g[n][q]);
    if (!ok[n]) {
#pragma unroll
      for (int j = 0; j < kCells; ++j) c[0][j] = StateForm<FORM>::kSentinel;
    }
#pragma unroll
    for (int j = 0; j < kCells; ++j)
      if (xrt::adopt<FORM, METRIC>(p[j], a.step_y, a.step_x, c[0][j],
                                   S == 2 ? c[S - 1][j] : 0, best[j],
                                   s0[j], s1[j]) &&
          WITH_VAL)
        wi[j] = idx[n] + j;
  }
  float val[kCells];
#pragma unroll
  for (int j = 0; j < kCells; ++j)
    val[j] = WITH_VAL ? __ldg(reinterpret_cast<const float*>(a.in[S]) + wi[j])
                      : 0.0f;
  store_cells<S, WITH_VAL>(a, row, col, true, s0, s1, val, best);
}

template <int FORM, int METRIC, bool WITH_VAL, bool ORIGIN>
int launch_routed_at(const RoundArgs& a, const xrt::WindowMaps& maps,
                     int route, int smem, long long grid,
                     cudaStream_t stream) {
  if (route == kRouteVector) {
    jfa_vector_kernel<FORM, METRIC, WITH_VAL, ORIGIN>
        <<<(unsigned)grid, kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  auto kernel =
      a.k == 1   ? jfa_staged_kernel<FORM, METRIC, WITH_VAL, ORIGIN, 1>
      : a.k == 2 ? jfa_staged_kernel<FORM, METRIC, WITH_VAL, ORIGIN, 2>
                 : jfa_staged_kernel<FORM, METRIC, WITH_VAL, ORIGIN, 0>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

// The origin's instantiation only for a packed state with an origin; the
// coordinate state has none.
template <int FORM, int METRIC, bool WITH_VAL>
int launch_routed(const RoundArgs& a, const xrt::WindowMaps& maps, int route,
                  int smem, long long grid, cudaStream_t stream) {
  if (FORM == kPacked && (a.row0 != 0 || a.col0 != 0))
    return launch_routed_at<FORM, METRIC, WITH_VAL, FORM == kPacked>(
        a, maps, route, smem, grid, stream);
  return launch_routed_at<FORM, METRIC, WITH_VAL, false>(a, maps, route,
                                                         smem, grid, stream);
}

template <int FORM, int METRIC>
int launch_valued(const RoundArgs& a, const xrt::WindowMaps& maps,
                  bool with_val, int route, int smem, long long grid,
                  cudaStream_t stream) {
  return with_val
             ? launch_routed<FORM, METRIC, true>(a, maps, route, smem, grid,
                                                 stream)
             : launch_routed<FORM, METRIC, false>(a, maps, route, smem, grid,
                                                  stream);
}

}  // namespace

extern "C" {

// The simple route.  One round over the packed int32 state (iy<<15|ix,
// -1 for no target) and an optional float32 value channel (v_in and v_out
// both null without one).  metric: 0 euclidean, 2 manhattan.  best_out,
// when not null, receives each cell's float32 key after the round.
// (row0, col0): the block's origin, the indices in the whole raster of
// its cell (0, 0) (a block of a mesh; 0, 0 for a whole raster).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for an unknown metric.
int jfa_round_packed(const int* s_in, const float* v_in, int* s_out,
                     float* v_out, float* best_out, long long h, long long w,
                     long long k, float step_y, float step_x, int metric,
                     int row0, int col0, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (metric == kEuclidean) {
    launch_packed<kEuclidean>(s_in, v_in, s_out, v_out, best_out, h, w, k,
                              step_y, step_x, row0, col0, st);
  } else if (metric == kManhattan) {
    launch_packed<kManhattan>(s_in, v_in, s_out, v_out, best_out, h, w, k,
                              step_y, step_x, row0, col0, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The simple route.  One round over the float32 coordinate state (tx, ty;
// inf for no target) and an optional float32 value channel, with the
// cells' coordinates xs (w,) and ys (h,).  metric: 0 euclidean, 1 great
// circle, 2 manhattan.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unknown metric.
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

// One round on the staged (route 0) or vector (route 1) route, as
// kernels/jfa_plan.py::round_plan planned it.  form 0: the packed state
// (in[0]: int32 iy<<15|ix, -1 for none; metric 0 euclidean, 2
// manhattan), form 1: coordinates (in[0], in[1]: float32 tx, ty, inf for
// none, with xs (w,) and ys (h,); metric 0, 1 great circle, 2); with_val:
// in[S] / out[S] hold the float32 value plane after the S state planes;
// best, when not null, receives each cell's key.  stage 0 TMA or 1
// cp.async; th, pad, pitch, rows: the staged tile's rows and its window;
// smem: shared bytes; phased: the vector route's k-phase row order; grid:
// blocks; (row0, col0): the packed state's block origin, as for
// jfa_round_packed (0 for the coordinate state).  The plan's choices are
// round_plan's; this checks what keeps the
// launch safe: the route's rules (vector: w and k multiples of 4, h*w <
// 2^31; staged: k 1, 2 or a multiple of 4, TMA only where w % 4 == 0 and
// every plane is 16-byte aligned), a window that covers the tile and its
// halo in boxes of at most 256 a side, shared bytes that hold it and fit
// a block, and a grid of one block a tile or a 4-cell group's row.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// a plan that fails a check, or the negated CUresult of a failed
// tensor-map encode.
int jfa_round_routed(int form, const void* const* in, void* const* out,
                     float* best, const float* xs, const float* ys,
                     long long h, long long w, long long k, float step_y,
                     float step_x, int metric, int with_val, int route,
                     int stage, int th, int pad, int pitch, int rows,
                     int smem, int phased, long long grid, int row0,
                     int col0, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const int S = form == kPacked ? 1 : 2;
  const int planes = S + (with_val ? 1 : 0);
  const bool metric_ok = form == kPacked
                             ? metric == kEuclidean || metric == kManhattan
                             : form == kCoords && metric >= kEuclidean &&
                                   metric <= kManhattan;
  bool aligned = w % 4 == 0 && (best == nullptr || xrt::aligned16(best));
  for (int q = 0; q < planes; ++q)
    aligned = aligned && xrt::aligned16(in[q]) && xrt::aligned16(out[q]);
  if (!metric_ok || k < 1 || h > (1LL << 30) || w > (1LL << 30) ||
      (form == kCoords && (xs == nullptr || ys == nullptr ||
                           row0 != 0 || col0 != 0)))
    return (int)cudaErrorInvalidValue;
  RoundArgs a{};
  for (int q = 0; q < planes; ++q) {
    a.in[q] = static_cast<const int*>(in[q]);
    a.out[q] = static_cast<int*>(out[q]);
  }
  a.best = best;
  a.xs = xs;
  a.ys = ys;
  a.h = (int)h;
  a.w = (int)w;
  a.k = (int)k;
  a.step_y = step_y;
  a.step_x = step_x;
  a.row0 = row0;
  a.col0 = col0;
  xrt::WindowMaps maps{};
  if (route == kRouteVector) {
    a.per_row = (int)((w / kCells + kThreads - 1) / kThreads);
    a.phased = phased != 0;
    if (!aligned || k % 4 != 0 || h * w >= (1LL << 31) ||
        grid != h * a.per_row)
      return (int)cudaErrorInvalidValue;
  } else if (route == kRouteStaged) {
    a.stage = stage;
    a.th = th;
    a.pad = pad;
    a.pitch = pitch;
    a.rows = rows;
    a.tiles_x = (int)((w + kTileCols - 1) / kTileCols);
    a.plane_words = (int)round_up((long long)rows * pitch, 32);
    const long long need =
        kAlignSlack + kBarrierBytes + planes * 4LL * a.plane_words;
    if (!(k == 1 || k == 2 || k % 4 == 0) || pad < k || pad % 4 != 0 ||
        pitch != kTileCols + 2 * pad || pitch > kBoxMax || th <= 0 ||
        rows != th + 2 * k || rows > kBoxMax || smem < need ||
        smem > kSmemPerBlock ||
        stage != (aligned ? xrt::kStageTma : xrt::kStageAsync) ||
        grid != (h + th - 1) / th * a.tiles_x)
      return (int)cudaErrorInvalidValue;
    if (stage == xrt::kStageTma) {
      const int err =
          xrt::encode_window_maps(&maps, in, planes, h, w, pitch, rows);
      if (err != 0) return err;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const bool v = with_val != 0;
  if (form == kPacked) {
    if (metric == kEuclidean)
      return launch_valued<kPacked, kEuclidean>(a, maps, v, route, smem,
                                                grid, st);
    return launch_valued<kPacked, kManhattan>(a, maps, v, route, smem, grid,
                                              st);
  }
  if (metric == kEuclidean)
    return launch_valued<kCoords, kEuclidean>(a, maps, v, route, smem, grid,
                                              st);
  if (metric == kGreatCircle)
    return launch_valued<kCoords, kGreatCircle>(a, maps, v, route, smem,
                                                grid, st);
  return launch_valued<kCoords, kManhattan>(a, maps, v, route, smem, grid,
                                            st);
}

}  // extern "C"
