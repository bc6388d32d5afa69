// jfa_group: a group of small-stride jump-flood rounds in one launch.
//
// Replaces the TPU probe tools/exp_jfa_fixed.py::multi_round_fixed (B8g):
// one kernel runs the strides ks (H = sum(ks)) over one fixed window of
// (T+2H)^2 cells a block.  Each block stages its window of the state in
// shared memory (cells outside the raster hold the no-target sentinel:
// -1 packed, inf coordinates), runs the rounds there, and writes its
// T x T centre.  No value plane, as in the TPU probe.  The TPU probe's
// neighbour reads by pltpu.roll have no counterpart: a thread reads its
// candidates from shared memory at (y + sy*k, x + sx*k).
//
// Semantics of each round are jfa.cu's (the candidate step is
// jfa_key.cuh's, shared with it): a cell starts from its own round-start
// target and key, visits the 8 candidates in (sy, sx) row-major order
// and adopts one whose key is strictly smaller.  Round r writes only the
// cells within m_r = sum(ks[r+1:]) of the centre, and its candidates then
// lie within m_r + k_r = m_{r-1} <= H: inside the window, and in the
// cells round r-1 wrote.  By induction every cell a round writes equals
// jfa_round's value after the same rounds, so the T x T centre equals
// jfa_round applied round by round, bit for bit, and no candidate is
// ever outside the window.
//
// What bounds it on the H100: the state is read once and written once (2
// planes of 4 bytes a cell), and each round evaluates 8 candidates a cell
// (8 float operations each): at 7 rounds the operations bound it (1.20e11
// at 16384^2, 1.80 ms at 67 TFLOP/s against 0.64 ms for the bytes).  The
// first port (route double, below) ran at 6% of that: its double-buffered
// window forced T = 64 for proximity's tail (139 KB, one block an SM, 10.1
// cell-rounds a cell for 7 rounds), its window came in by scalar, 64-bit,
// bounds-tested loads that nothing overlapped, and its 2D region loops,
// x strided by 32, left most lanes of a 100-wide region's last pass idle.
// kernels/jfa_group.py::window_plan plans both routes; the launcher checks
// only what keeps a launch safe.
//
// - single (jfa_group_single_kernel): the window is staged once, by TMA
//   where the pitch and the bases allow it (cp.async elsewhere), with
//   jfa.cu's staged route's helper (jfa_stage.cuh): its columns start at
//   H rounded up to 4 left of the halo, so that a box starts 16-byte
//   aligned, and the sentinel is written over TMA's zero fill outside the
//   raster.  One buffer: each round, every thread computes its cells' new
//   states into registers, then a barrier, the stores, a barrier.  For
//   the tail that fits T = 128 packed (196 x 200 cells, 157 KB): 8.43
//   cell-rounds a cell instead of 10.1.  Each round's region is one flat
//   index over its side^2 cells, so every lane has a cell; a cell's
//   (row, col) comes from the index once, by a float reciprocal that is
//   exact at these sizes.  A thread holds its cells of the first, largest
//   region (27 at T = 128 and 1024 threads) in CELLS registers a plane;
//   the plan refuses a tile whose cells pass 32 words a thread.
// - double (jfa_group_packed/coords_kernel): the first port, kept by name
//   for the A/B and the bit check: 32 x 32 threads, one block a tile, the
//   window held twice (round-start values and the round's output).
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 22, PERF.md):
// the tail on proximity's 16384^2 state takes 22.9 ms single-buffered at
// T = 128 (in an A/B, T = 64 at 512 threads and two blocks an SM took
// 29.2; the first port 30.7), and jfa.cu's seven launches 11.1 ms.  With the round kernel at
// its issue floor, the group saves only bytes, which no longer bound the
// rounds, and it evaluates 8.43 cell-rounds a cell for 7 rounds.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "jfa_key.cuh"
#include "jfa_stage.cuh"

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

// -- the single-buffered route ---------------------------------------------

using xrt::kCoords;
using xrt::kPacked;
using xrt::StateForm;

constexpr int kAlignSlack = 128, kBarrierBytes = 128;
constexpr int kBoxMax = 256;
constexpr long long kSmemPerBlock = 232448;

struct SingleArgs {
  const int* in[2];  // the state planes (1 packed, 2 coordinates)
  int* out[2];
  const float* xs;   // coordinates: the cells' x (w,) and y (h,)
  const float* ys;
  int h, w;
  Group g;
  int H, tile, pad, pitch, rows, stage, plane_words;
  float step_y, step_x;
};

constexpr int NT = 1024;  // threads a block of the single route

// Each thread holds the new state of at most CELLS cells a round.
template <int FORM, int METRIC, int CELLS>
__global__ void __launch_bounds__(NT)
    jfa_group_single_kernel(const __grid_constant__ xrt::WindowMaps maps,
                            const SingleArgs a) {
  constexpr int S = StateForm<FORM>::kPlanes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = xrt::smem_addr(smem_raw);
  unsigned char* const smem = smem_raw + (((raw + 127u) & ~127u) - raw);
  int* const win = reinterpret_cast<int*>(smem + kBarrierBytes);
  const int tid = threadIdx.x, T = a.tile, H = a.H, pw = a.plane_words;
  const int r0 = (int)blockIdx.y * T - H;  // raster row of window row 0
  const int c0 = (int)blockIdx.x * T - H;  // raster column of window col 0
  const int xo = a.pad - H;                // its column in shared memory
  xrt::stage_window<FORM>(maps, a.in, S, win, pw, a.rows, a.pitch, r0,
                          c0 - xo, a.h, a.w, a.stage, xrt::smem_addr(smem),
                          tid, NT);
  int m = H;
  for (int r = 0; r < a.g.n; ++r) {
    const int k = a.g.k[r];
    m -= k;
    const int side = T + 2 * m, lo = H - m, n = side * side;
    const float inv = 1.0f / (float)side;
    // the window offset of flat index idx of the region and its raster
    // (row, col), or -1 for a cell outside the region or the raster
    // (which keeps its sentinel)
    auto locate = [&](int idx, int& row, int& col) {
      if (idx >= n) return -1;
      const int dy = (int)(((float)idx + 0.5f) * inv);
      const int y = lo + dy, x = lo + idx - dy * side;
      row = r0 + y;
      col = c0 + x;
      if (row < 0 || row >= a.h || col < 0 || col >= a.w) return -1;
      return y * a.pitch + x + xo;
    };
    int n0[CELLS], n1[CELLS];
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      int row, col;
      const int o = locate(tid + c * NT, row, col);
      if (o < 0) continue;
      xrt::Pos p;
      p.iy = row;
      p.ix = col;
      p.px = FORM == kCoords ? a.xs[col] : 0.0f;
      p.py = FORM == kCoords ? a.ys[row] : 0.0f;
      int s0 = win[o], s1 = S == 2 ? win[pw + o] : 0;
      float best = xrt::key_of<FORM, METRIC>(p, s0, s1, a.step_y, a.step_x);
#pragma unroll
      for (int sy = -1; sy <= 1; ++sy)
#pragma unroll
        for (int sx = -1; sx <= 1; ++sx) {
          if (sy == 0 && sx == 0) continue;
          const int j = o + (sy * a.pitch + sx) * k;
          xrt::adopt<FORM, METRIC>(p, a.step_y, a.step_x, win[j],
                                   S == 2 ? win[pw + j] : 0, best, s0, s1);
        }
      n0[c] = s0;
      n1[c] = s1;
    }
    __syncthreads();  // every read of the round-start state is done
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      int row, col;
      const int o = locate(tid + c * NT, row, col);
      if (o < 0) continue;
      win[o] = n0[c];
      if (S == 2) win[pw + o] = n1[c];
    }
    __syncthreads();
  }
  for (int e = tid; e < T * T; e += NT) {
    const int dy = e / T, dx = e - dy * T;
    const long long row = (long long)blockIdx.y * T + dy;
    const long long col = (long long)blockIdx.x * T + dx;
    if (row >= a.h || col >= a.w) continue;
    const int o = (H + dy) * a.pitch + H + dx + xo;
#pragma unroll
    for (int q = 0; q < S; ++q) a.out[q][row * a.w + col] = win[q * pw + o];
  }
}

template <int FORM, int METRIC, int CELLS>
int launch_single(const xrt::WindowMaps& maps, const SingleArgs& a,
                  int smem, dim3 grid, cudaStream_t stream) {
  auto kernel = jfa_group_single_kernel<FORM, METRIC, CELLS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

// The instantiations: 16 or 28 cells a thread (the coordinate state's two
// planes only 16: at most 32 words of new state; 28 holds the 27 of
// proximity's tail at T = 128).
template <int FORM, int METRIC>
int launch_cells(const xrt::WindowMaps& maps, const SingleArgs& a, int cells,
                 int smem, dim3 grid, cudaStream_t stream) {
  if (cells == 16)
    return launch_single<FORM, METRIC, 16>(maps, a, smem, grid, stream);
  if constexpr (FORM == kPacked) {
    if (cells == 28)
      return launch_single<FORM, METRIC, 28>(maps, a, smem, grid, stream);
  }
  return (int)cudaErrorInvalidValue;
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

// The double route.  The group of `n` strides `ks` over the packed int32
// state (iy<<15|ix, -1 for none) of an h x w raster, on tiles of `tile`
// cells with `smem` bytes of shared memory (2 (tile+2H)^2 int32).
// metric: 0 euclidean, 2 manhattan.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an unknown metric or a bad group.
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

// The double route.  The group over the float32 coordinate state (tx, ty;
// inf for none) with the cells' coordinates xs (w,) and ys (h,); `smem` is
// 4 (tile+2H)^2 float32.  metric: 0 euclidean, 1 great circle, 2 manhattan.
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

// The group of `n` strides `ks` on the single-buffered route, as
// kernels/jfa_group.py::window_plan planned it.  form 0: the packed state
// (in[0]: int32 iy<<15|ix, -1 for none; metric 0 euclidean, 2 manhattan);
// form 1: coordinates (in[0], in[1]: float32 tx, ty, inf for none, with
// xs (w,) and ys (h,); metric 0, 1 great circle, 2).  tile T, cells a
// thread (of 1024), the window's pad, pitch and rows, stage 0 TMA or 1
// cp.async, shared bytes.  Checks what keeps the launch safe: the stage
// rule (TMA only where w % 4 == 0 and every plane is 16-byte aligned), a
// window of T + 2H rows and T + 2 pad columns (pad >= H, a multiple of 4;
// T a multiple of 4) in boxes of at most 256 a side, 1024 x cells that
// cover the first round's region, shared bytes that hold the window and
// fit a block, and at most 65535 tile rows.  Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for a plan that fails a check,
// or the negated CUresult of a failed tensor-map encode.
int jfa_group_single(int form, const void* const* in, void* const* out,
                     const float* xs, const float* ys, long long h,
                     long long w, const int* ks, int n, int tile,
                     int cells, int pad, int pitch, int rows,
                     int stage, int smem, float step_y, float step_x,
                     int metric, void* stream) {
  Group g;
  int H;
  if (!make_group(ks, n, &g, &H) || tile < 4 || tile % 4 != 0)
    return cudaErrorInvalidValue;
  if (h <= 0 || w <= 0) return 0;
  const int S = form == kPacked ? 1 : 2;
  bool aligned = w % 4 == 0;
  for (int q = 0; q < S; ++q)
    aligned = aligned && xrt::aligned16(in[q]) && xrt::aligned16(out[q]);
  const long long side0 = tile + 2LL * (H - g.k[0]);
  const long long words = (long long)rows * pitch;
  const long long plane_words = (words + 31) / 32 * 32;
  const long long need = kAlignSlack + kBarrierBytes + S * 4 * plane_words;
  const long long tiles_y = (h + tile - 1) / tile;
  if ((form != kPacked && form != kCoords) || h > (1LL << 30) ||
      w > (1LL << 30) || pad < H || pad % 4 != 0 ||
      pitch != tile + 2 * pad || pitch > kBoxMax || rows != tile + 2 * H ||
      rows > kBoxMax || (long long)NT * cells < side0 * side0 ||
      smem < need || smem > kSmemPerBlock || tiles_y > 65535 ||
      stage != (aligned ? xrt::kStageTma : xrt::kStageAsync) ||
      (form == kCoords && (xs == nullptr || ys == nullptr)))
    return cudaErrorInvalidValue;
  SingleArgs a{};
  for (int q = 0; q < S; ++q) {
    a.in[q] = static_cast<const int*>(in[q]);
    a.out[q] = static_cast<int*>(out[q]);
  }
  a.xs = xs;
  a.ys = ys;
  a.h = (int)h;
  a.w = (int)w;
  a.g = g;
  a.H = H;
  a.tile = tile;
  a.pad = pad;
  a.pitch = pitch;
  a.rows = rows;
  a.stage = stage;
  a.plane_words = (int)plane_words;
  a.step_y = step_y;
  a.step_x = step_x;
  xrt::WindowMaps maps{};
  if (stage == xrt::kStageTma) {
    const int err = xrt::encode_window_maps(&maps, in, S, h, w, pitch, rows);
    if (err != 0) return err;
  }
  const dim3 grid((unsigned)((w + tile - 1) / tile), (unsigned)tiles_y);
  const cudaStream_t st = (cudaStream_t)stream;
  if (form == kPacked) {
    if (metric == kEuclidean)
      return launch_cells<kPacked, kEuclidean>(maps, a, cells, smem,
                                               grid, st);
    if (metric == kManhattan)
      return launch_cells<kPacked, kManhattan>(maps, a, cells, smem,
                                               grid, st);
    return cudaErrorInvalidValue;
  }
  if (metric == kEuclidean)
    return launch_cells<kCoords, kEuclidean>(maps, a, cells, smem,
                                             grid, st);
  if (metric == kGreatCircle)
    return launch_cells<kCoords, kGreatCircle>(maps, a, cells, smem,
                                               grid, st);
  if (metric == kManhattan)
    return launch_cells<kCoords, kManhattan>(maps, a, cells, smem,
                                             grid, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
