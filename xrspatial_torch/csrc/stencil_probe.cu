// stencil_probe: one templated float32 3x3 slope stencil whose
// instantiations are the port of four TPU probes of the surface kernel
// B1 (xrspatial_torch/kernels/stencil_probe.py names which is which):
//
// - tools/exp_stencil2.py::pipe_stencil (B8c): FORM staged, MODE copy,
//   grad or slope, redesigned for Hopper after the TPU probe's own
//   design.  The TPU probe stages each tile's (th+2) x (tw+2) window in
//   VMEM through a double-buffered DMA pipeline and computes from it.
//   Here persistent blocks (two an SM) walk TH x TW output tiles (32x128,
//   64x128, 32x248 take the place of the TPU probe's tile shapes) in
//   row-major order with the grid's stride.  One thread asks TMA for each
//   tile's window (rows r0-1 .. r0+TH, columns c0-4 .. c0+TW+3: TMA takes
//   no innermost coordinate that is not 16-byte aligned) into an S-stage
//   ring in dynamic shared memory, S windows
//   ahead, each stage tracked by an mbarrier; a stage is refilled after a
//   block barrier says every thread has left it.  The tensor map fills
//   out-of-bounds cells with NaN, the TPU probe's NaN pad, so the 1-cell
//   ring comes out NaN from the arithmetic itself: no ring test, and one
//   bounds test per 4 cells at the store.  Each thread computes 4
//   neighbouring cells of a row from 3 x 6 shared values (every cell's
//   nine neighbours; 3 shared loads a row) and writes them with one
//   16-byte store; copy writes the window's centre, and TMA's load cannot
//   be optimised away.  A pitch or
//   base that TMA refuses (w % 4 != 0, or x or out not 16-byte aligned)
//   takes the same kernel with the same window staged by 4-byte cp.async
//   copies (NaN stores outside the raster) and scalar stores: the launcher
//   picks the route by that rule alone and checks that the caller's plan
//   (kernels/staged.py::staged_plan) agrees.  The ring is
//   staged_window.cuh's, which the surface kernel B1 runs too.
//   The first port of this probe, FORM nine (each thread makes nine
//   global loads, B1's access pattern; copy folds the 8 neighbours into
//   its output through a mask the wrapper passes as 0, so the loads stay),
//   runs at blocks 32x8, 32x16 and 64x4 and stays by name, as do its
//   interior and bare variants, B8e's and B8f's first ports.
// - tools/exp_separable_horn.py::run (B8d): FORM nine (B1's nine reads)
//   or separable: each warp walks down a strip of rows and keeps each
//   column's vertical smooth x[r-1] + 2x[r] + x[r+1] and difference
//   x[r+1] - x[r-1] in a shared row tile, and lanes combine neighbouring
//   columns from it, so each cell is read about once.  dzdy then
//   rounds as (g-a) + 2(hh-b) + (ii-c), not (g+2hh+ii) - (a+2b+c): the
//   forms are not equal bit for bit, and on a DEM a kilometre high they
//   part by more than the surface tolerance.  The TPU
//   probe leaves each tile's border columns unwritten; here both forms
//   compute the whole raster with the 1-cell NaN ring.
//   Redesigned for Hopper as FORM separable_staged: the separable
//   arithmetic on B8c's staged window ring, at B8c's tiles and on both of
//   its routes.  Each thread forms the 6 column smooths and differences of
//   its 4 cells' 3 x 6 staged values once (6 + 6 where the nine-read
//   arithmetic makes 4 x 14 sums) and writes the 4 slopes with one 16-byte
//   streaming store (scalar on the cp.async route).  Its expressions are
//   the first port's, operand for operand, so nvcc contracts them alike
//   and the forms give the same bits; the NaN ring comes from the
//   window's NaN fill.  The first port (FORM separable, blocks 32x8, 32x16,
//   64x4) stays by name.  It asks the TPU probe's question with the window
//   in shared memory, where no read is repeated from device memory: does
//   computing the vertical sums once a column buy anything?
// - tools/exp_padfree_stencil.py::slope_2d (B8e): EDGES interior.  The
//   TPU probe clamps its interior tiles so that the last overlaps its
//   neighbour and no window reaches outside the raster, and writes the
//   thin edge bands in a second pass.  Redesigned for Hopper as FORM
//   staged, EDGES interior: B8c's staged ring on staged_window.cuh's
//   interior walk (kWalkInterior: output rows [1, h - 1), columns
//   [4, w - 4), the last tiles pulled back), so every window lies wholly
//   inside the raster, TMA takes every box and none needs its NaN fill;
//   the tile loop has no bounds test, and the TMA route stores 16 bytes a
//   thread.  A second launch, stencil_edge_kernel on the extent
//   (1, h - 1, 4, w - 4), writes rows 0 and h - 1 and the 4 columns at
//   each side (B1's per-cell ring test, checked_cell).  The result equals
//   B1's slope bit for bit.  The first port, FORM nine with the main
//   launch on the blocks wholly inside the ring (stencil_interior_kernel)
//   and the same edge kernel on the rest, stays by name.
// - tools/exp_seam_cost.py::run (B8f): the port has no seam passes; the
//   question becomes what B1's border machinery (the NaN-filled edge
//   windows, the bounds tests, the ragged tiles) costs on the staged
//   ring.  FORM staged, EDGES bare is the interior walk alone (the cells
//   outside [1, h - 1) x [4, w - 4) left unwritten); EDGES ring_branch is
//   B8c's full walk with B1's first port's per-cell ring test compiled
//   into the quad in place of relying on the NaN fill; prod is B1 itself,
//   called by name.  The first ports, FORM nine EDGES ring (B1's per-cell
//   test) and EDGES bare (the interior blocks alone), stay by name.
//
// Every slope is B1's expression: sx / (8*csx) (exact at csx = 1, where
// the TPU probes multiply by 0.125), libdevice sqrtf and atanf, the same
// operation order, so B1's contractions happen here too; no fast math.
//
// What bounds it: one read and one write of the float32 plane (8 bytes a
// cell) against ~24 float operations a cell: device memory, 0.641 ms at
// 16384^2 and 3.35 TB/s; the staged form also re-reads each window's halo,
// 2/TH + 8/TW of the plane (12.5% at 32x128), mostly from the 50 MB L2.
// What the variants measure: copy against slope is the arithmetic's share
// of the time; on the staged ring, bare against B1 what the NaN-filled
// edge windows, the bounds tests and the ragged tiles cost, ring_branch
// against staged slope what an explicit ring test costs; separable
// against nine the cost of the nine reads, staged against nine what a
// shared-memory window buys,
// separable_staged against staged what the separable arithmetic (~20
// float operations a cell against ~24) buys once the window is in shared
// memory.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "staged_window.cuh"
#include "surface_cell.cuh"

namespace {

constexpr int kCopy = 0, kGrad = 1, kSlope = 2;
constexpr int kSepSlope = 3;  // the staged kernel's separable slope
constexpr int kNine = 0, kSeparable = 1;
constexpr int kRing = 0, kInterior = 1, kBare = 2, kRingBranch = 3;
constexpr int kEdgeThreads = 256;

// grad or slope from the Sobel sums, as surface_cell.cuh computes slope
template <int MODE>
__device__ __forceinline__ float slope_of(float sx, float sy, float csx,
                                          float csy) {
  const float dzdx = sx / (8.0f * csx);
  const float dzdy = sy / (8.0f * csy);
  if (MODE == kGrad) return sqrtf(dzdx * dzdx + dzdy * dzdy);
  return atanf(sqrtf(dzdx * dzdx + dzdy * dzdy)) * xrt::kDeg;
}

// grad or slope of a cell from its 3x3 window (a b c above, d _ f at, g hh
// ii below): B1's expression in B1's order, surface_cell.cuh's sobel and
// slope_value operation for operation
template <int MODE>
__device__ __forceinline__ float window_value(float a, float b, float c,
                                              float d, float f, float g,
                                              float hh, float ii, float csx,
                                              float csy) {
  const float sx = (c + 2.0f * f + ii) - (a + 2.0f * d + g);
  const float sy = (g + 2.0f * hh + ii) - (a + 2.0f * b + c);
  return slope_of<MODE>(sx, sy, csx, csy);
}

// The value of cell i, which lies inside the ring, from its 3x3 window.
template <int MODE>
__device__ __forceinline__ float nine_cell(const float* __restrict__ x,
                                           long long i, long long w,
                                           float csx, float csy,
                                           unsigned keep) {
  // a b c = row above, d e f = this row, g hh ii = row below
  const float a = x[i - w - 1], b = x[i - w], c = x[i - w + 1];
  const float d = x[i - 1], e = x[i], f = x[i + 1];
  const float g = x[i + w - 1], hh = x[i + w], ii = x[i + w + 1];
  if (MODE == kCopy) {
    const unsigned fold = __float_as_uint(a) ^ __float_as_uint(b) ^
                          __float_as_uint(c) ^ __float_as_uint(d) ^
                          __float_as_uint(f) ^ __float_as_uint(g) ^
                          __float_as_uint(hh) ^ __float_as_uint(ii);
    return __uint_as_float(__float_as_uint(e) | (fold & keep));
  }
  return window_value<MODE>(a, b, c, d, f, g, hh, ii, csx, csy);
}

// Any cell, with B1's ring test: copy passes the ring through, grad and
// slope write NaN there.
template <int MODE>
__device__ __forceinline__ float checked_cell(const float* __restrict__ x,
                                              long long h, long long w,
                                              long long row, long long col,
                                              float csx, float csy,
                                              unsigned keep) {
  const long long i = row * w + col;
  if (row == 0 || row == h - 1 || col == 0 || col == w - 1)
    return MODE == kCopy ? x[i] : CUDART_NAN_F;
  return nine_cell<MODE>(x, i, w, csx, csy, keep);
}

template <int MODE, int BX, int BY>
__global__ void __launch_bounds__(BX* BY)
    stencil_ring_kernel(const float* __restrict__ x, float* __restrict__ out,
                        long long h, long long w, float csx, float csy,
                        unsigned keep) {
  const long long col = (long long)blockIdx.x * BX + threadIdx.x;
  if (col >= w) return;
  const long long row_step = (long long)gridDim.y * BY;
  for (long long row = (long long)blockIdx.y * BY + threadIdx.y; row < h;
       row += row_step)
    out[row * w + col] = checked_cell<MODE>(x, h, w, row, col, csx, csy,
                                            keep);
}

// Blocks wholly inside the ring: rows [r0, r0 + tiles_y*BY), columns
// [c0, c0 + gridDim.x*BX); no bounds test.
template <int MODE, int BX, int BY>
__global__ void __launch_bounds__(BX* BY)
    stencil_interior_kernel(const float* __restrict__ x,
                            float* __restrict__ out, long long w,
                            long long r0, long long c0, long long tiles_y,
                            float csx, float csy, unsigned keep) {
  const long long col = c0 + (long long)blockIdx.x * BX + threadIdx.x;
  for (long long t = blockIdx.y; t < tiles_y; t += gridDim.y) {
    const long long i = (r0 + t * BY + threadIdx.y) * w + col;
    out[i] = nine_cell<MODE>(x, i, w, csx, csy, keep);
  }
}

// The cells outside the interior blocks [r0, r1) x [c0, c1): the top and
// bottom bands over the full width, then the left and right bands of the
// interior rows; `n` cells in all.
template <int MODE>
__global__ void __launch_bounds__(kEdgeThreads)
    stencil_edge_kernel(const float* __restrict__ x, float* __restrict__ out,
                        long long h, long long w, long long r0, long long r1,
                        long long c0, long long c1, long long n, float csx,
                        float csy, unsigned keep) {
  const long long top = r0 * w, bottom = (h - r1) * w, left = (r1 - r0) * c0;
  for (long long e = (long long)blockIdx.x * kEdgeThreads + threadIdx.x;
       e < n; e += (long long)gridDim.x * kEdgeThreads) {
    long long row, col, k = e;
    if (k < top) {
      row = k / w;
      col = k % w;
    } else if ((k -= top) < bottom) {
      row = r1 + k / w;
      col = k % w;
    } else if ((k -= bottom) < left) {
      row = r0 + k / c0;
      col = k % c0;
    } else {
      k -= left;
      row = r0 + k / (w - c1);
      col = c1 + k % (w - c1);
    }
    out[row * w + col] = checked_cell<MODE>(x, h, w, row, col, csx, csy,
                                            keep);
  }
}

// The separable form.  Each warp walks down a strip of kSepRows rows over
// 32 columns, keeping x[r-1] and x[r] of its column in registers: per row
// a lane loads x[r+1] (each cell is read about once), writes its column's
// vertical smooth and difference into the warp's row of a shared tile,
// and lanes 1..30 combine their neighbours' columns from that row.  A
// warp covers 30 output columns; a block of BX x BY threads has BX / 32
// warps side by side and BY strips one above the other.
constexpr int kSepCols = 30, kSepRows = 32;

template <int BX, int BY>
__global__ void __launch_bounds__(BX* BY)
    stencil_separable_kernel(const float* __restrict__ x,
                             float* __restrict__ out, long long h,
                             long long w, float csx, float csy) {
  static_assert(BX % 32 == 0, "a row of threads is whole warps");
  __shared__ float smooth[BY][BX];
  __shared__ float diff[BY][BX];
  const int lane = threadIdx.x % 32, warp_x = threadIdx.x / 32;
  const long long col =
      ((long long)blockIdx.x * (BX / 32) + warp_x) * kSepCols - 1 + lane;
  const bool col_in = col >= 0 && col < w;
  const bool writes = lane >= 1 && lane <= kSepCols && col < w;
  float* const s_row = smooth[threadIdx.y] + warp_x * 32;
  float* const d_row = diff[threadIdx.y] + warp_x * 32;
  const long long strips = (h + kSepRows - 1) / kSepRows;
  for (long long strip = (long long)blockIdx.y * BY + threadIdx.y;
       strip < strips; strip += (long long)gridDim.y * BY) {
    const long long r0 = strip * kSepRows;
    const long long r1 = r0 + kSepRows < h ? r0 + kSepRows : h;
    float up = (col_in && r0 >= 1) ? x[(r0 - 1) * w + col] : CUDART_NAN_F;
    float mid = col_in ? x[r0 * w + col] : CUDART_NAN_F;
    for (long long row = r0; row < r1; ++row) {
      const float dn =
          (col_in && row + 1 < h) ? x[(row + 1) * w + col] : CUDART_NAN_F;
      __syncwarp();
      s_row[lane] = up + 2.0f * mid + dn;
      d_row[lane] = dn - up;
      __syncwarp();
      if (writes) {
        float v = CUDART_NAN_F;
        if (row != 0 && row != h - 1 && col != 0 && col != w - 1) {
          const float sx = s_row[lane + 1] - s_row[lane - 1];
          const float sy = d_row[lane - 1] + 2.0f * d_row[lane] +
                           d_row[lane + 1];
          v = slope_of<kSlope>(sx, sy, csx, csy);
        }
        out[row * w + col] = v;
      }
      up = mid;
      mid = dn;
    }
  }
}

unsigned grid_y(long long tiles) {
  return (unsigned)(tiles < 65535 ? tiles : 65535);
}

struct Launch {
  const float* x;
  float* out;
  long long h, w, r0, r1, c0, c1;
  float csx, csy;
  unsigned keep;
  cudaStream_t stream;
};

// The edge-band kernel on the cells outside [r0, r1) x [c0, c1), if any.
template <int MODE>
int launch_edges(const Launch& a) {
  const long long n = a.r0 * a.w + (a.h - a.r1) * a.w +
                      (a.r1 - a.r0) * (a.c0 + a.w - a.c1);
  if (n <= 0) return 0;
  const long long blocks = (n + kEdgeThreads - 1) / kEdgeThreads;
  stencil_edge_kernel<MODE><<<(unsigned)(blocks < 4096 ? blocks : 4096),
                              kEdgeThreads, 0, a.stream>>>(
      a.x, a.out, a.h, a.w, a.r0, a.r1, a.c0, a.c1, n, a.csx, a.csy, a.keep);
  return (int)cudaGetLastError();
}

template <int MODE, int BX, int BY>
int launch_variant(int form, int edges, const Launch& a) {
  const dim3 block(BX, BY);
  if (form == kSeparable) {
    if constexpr (MODE == kSlope) {
      if (edges != kRing) return (int)cudaErrorInvalidValue;
      const long long cols = (BX / 32) * kSepCols;
      const long long strips = (a.h + kSepRows - 1) / kSepRows;
      const dim3 grid((unsigned)((a.w + cols - 1) / cols),
                      grid_y((strips + BY - 1) / BY));
      stencil_separable_kernel<BX, BY><<<grid, block, 0, a.stream>>>(
          a.x, a.out, a.h, a.w, a.csx, a.csy);
      return (int)cudaGetLastError();
    }
    return (int)cudaErrorInvalidValue;
  }
  if (form != kNine) return (int)cudaErrorInvalidValue;
  if (edges == kRing) {
    const dim3 grid((unsigned)((a.w + BX - 1) / BX),
                    grid_y((a.h + BY - 1) / BY));
    stencil_ring_kernel<MODE, BX, BY><<<grid, block, 0, a.stream>>>(
        a.x, a.out, a.h, a.w, a.csx, a.csy, a.keep);
    return (int)cudaGetLastError();
  }
  if constexpr (MODE == kSlope) {
    if (edges != kInterior && edges != kBare) return (int)cudaErrorInvalidValue;
    const long long tiles_y = (a.r1 - a.r0) / BY, tiles_x = (a.c1 - a.c0) / BX;
    if (tiles_y > 0 && tiles_x > 0) {
      stencil_interior_kernel<MODE, BX, BY>
          <<<dim3((unsigned)tiles_x, grid_y(tiles_y)), block, 0, a.stream>>>(
              a.x, a.out, a.w, a.r0, a.c0, tiles_y, a.csx, a.csy, a.keep);
      const int err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
    return edges == kInterior ? launch_edges<MODE>(a) : 0;
  }
  return (int)cudaErrorInvalidValue;
}

template <int MODE>
int launch_mode(int form, int edges, int bx, int by, const Launch& a) {
  if (bx == 32 && by == 8) return launch_variant<MODE, 32, 8>(form, edges, a);
  if (bx == 32 && by == 16)
    return launch_variant<MODE, 32, 16>(form, edges, a);
  if (bx == 64 && by == 4) return launch_variant<MODE, 64, 4>(form, edges, a);
  return (int)cudaErrorInvalidValue;
}

// -- the staged form (B8c) ----------------------------------------------------
// The window ring is staged_window.cuh's, shared with the surface kernel B1.

struct StagedArgs {
  xrt::RingArgs ring;
  float* out;
  float csx, csy;
};

// Cells (row, col .. col + 3) from the window at p, the window cell of
// (row - 1, col - 4); copy takes the window's centre.  kSepSlope forms the
// 6 columns' vertical smooth and difference once and combines
// neighbouring columns, in stencil_separable_kernel's expressions.
template <int MODE, int COLS>
__device__ __forceinline__ void quad(const float* p, float csx, float csy,
                                     float v[4]) {
  float u[6], m[6], d[6];
  xrt::load6(p, u);
  xrt::load6(p + COLS, m);
  xrt::load6(p + 2 * COLS, d);
  if constexpr (MODE == kSepSlope) {
    float smooth[6], diff[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      smooth[i] = u[i] + 2.0f * m[i] + d[i];
      diff[i] = d[i] - u[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sx = smooth[j + 2] - smooth[j];
      const float sy = diff[j] + 2.0f * diff[j + 1] + diff[j + 2];
      v[j] = slope_of<kSlope>(sx, sy, csx, csy);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = MODE == kCopy
                 ? m[j + 1]
                 : window_value<MODE>(u[j], u[j + 1], u[j + 2], m[j],
                                      m[j + 2], d[j], d[j + 1], d[j + 2],
                                      csx, csy);
  }
}

// EDGES kRing: B8c's full walk, bounds tests at the store, the ring NaN
// from the windows' NaN fill.  kInterior: the interior walk (edges
// interior and bare), no bounds test.  kRingBranch: the full walk with
// B1's first port's per-cell ring test on each of the 4 cells.
template <int MODE, int TH, int TW, int ROUTE, int EDGES>
__global__ void __launch_bounds__(xrt::kStagedThreads, 2)
    stencil_staged_kernel(const __grid_constant__ CUtensorMap map,
                          const StagedArgs a) {
  using Win = xrt::Window<TH, TW>;
  constexpr int kQuadCols = TW / 4;
  constexpr int kWalk =
      EDGES == kInterior ? xrt::kWalkInterior : xrt::kWalkFull;
  extern __shared__ unsigned char smem_raw[];
  const long long h = a.ring.h, w = a.ring.w;
  xrt::staged_tiles<TH, TW, ROUTE, TW, 0, kWalk>(
      &map, a.ring, smem_raw,
      [&](const float* win, long long r0, long long c0) {
        for (int q = threadIdx.x; q < TH * kQuadCols;
             q += xrt::kStagedThreads) {
          const int tr = q / kQuadCols, tc = 4 * (q - tr * kQuadCols);
          const long long row = r0 + tr, col = c0 + tc;
          // the interior walk's tiles lie inside the raster
          if (EDGES != kInterior && (row >= h || col >= w)) continue;
          float v[4];
          quad<MODE, Win::kCols>(win + tr * Win::kCols + tc, a.csx, a.csy,
                                 v);
          if (EDGES == kRingBranch) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (row == 0 || row == h - 1 || col + j == 0 ||
                  col + j == w - 1)
                v[j] = CUDART_NAN_F;
          }
          float* const o = a.out + row * w + col;
          // streaming stores (evict first): the output is not read again,
          // and the L2 keeps the windows' halos for the neighbouring tiles
          if (ROUTE == xrt::kStagedRouteTma) {
            // w % 4 == 0: the 4 cells lie in the raster together
            __stcs(reinterpret_cast<float4*>(o),
                   make_float4(v[0], v[1], v[2], v[3]));
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (EDGES == kInterior || col + j < w) __stcs(o + j, v[j]);
          }
        }
      });
}

// Launches one instantiation on a plan staged_setup accepts, whose walk
// has `tiles` tiles.
template <int MODE, int TH, int TW, int ROUTE, int EDGES>
int launch_staged(const float* x, float* out, long long h, long long w,
                  int stages, int grid, int smem, long long tiles, float csx,
                  float csy, cudaStream_t stream) {
  CUtensorMap map{};
  StagedArgs a{};
  int err = xrt::staged_setup<TH, TW>(
      x, xrt::aligned16(out), h, w, ROUTE, stages, grid, smem, &map, &a.ring,
      TW, 0, EDGES == kInterior ? xrt::kWalkInterior : xrt::kWalkFull);
  if (err != 0) return err;
  if (a.ring.tiles != tiles || grid > tiles) return (int)cudaErrorInvalidValue;
  a.out = out;
  a.csx = csx;
  a.csy = csy;
  auto kernel = stencil_staged_kernel<MODE, TH, TW, ROUTE, EDGES>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  kernel<<<grid, xrt::kStagedThreads, smem, stream>>>(map, a);
  return (int)cudaGetLastError();
}

// A staged launch's arguments after the mode, tile and edges.
struct StagedLaunch {
  int route;
  const float* x;
  float* out;
  long long h, w;
  int stages, grid, smem;
  long long tiles;
  float csx, csy;
  cudaStream_t stream;
};

template <int MODE, int TH, int TW, int EDGES>
int staged_on_route(const StagedLaunch& l) {
  if (l.route == xrt::kStagedRouteTma)
    return launch_staged<MODE, TH, TW, xrt::kStagedRouteTma, EDGES>(
        l.x, l.out, l.h, l.w, l.stages, l.grid, l.smem, l.tiles, l.csx,
        l.csy, l.stream);
  return launch_staged<MODE, TH, TW, xrt::kStagedRouteAsync, EDGES>(
      l.x, l.out, l.h, l.w, l.stages, l.grid, l.smem, l.tiles, l.csx, l.csy,
      l.stream);
}

template <int MODE, int EDGES = kRing>
int staged_tile(int th, int tw, const StagedLaunch& l) {
  if (th == 32 && tw == 128) return staged_on_route<MODE, 32, 128, EDGES>(l);
  if (th == 64 && tw == 128) return staged_on_route<MODE, 64, 128, EDGES>(l);
  if (th == 32 && tw == 248) return staged_on_route<MODE, 32, 248, EDGES>(l);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the instantiation (mode, form, edges, bx x by) on `stream`:
// mode 0 copy, 1 grad, 2 slope; form 0 nine, 1 separable (slope, ring
// only); edges 0 ring, 1 interior, 2 bare (slope only).  [r0, r1) x
// [c0, c1) are the interior blocks' rows and columns (multiples of by and
// bx from by and bx), read only by interior and bare.  `keep` must be 0
// (copy's fold mask).  Returns cudaGetLastError() after the last launch,
// or cudaErrorInvalidValue for a variant that is not instantiated.
int stencil_probe_launch(const float* x, float* out, long long h,
                         long long w, int mode, int form, int edges, int bx,
                         int by, long long r0, long long r1, long long c0,
                         long long c1, float csx, float csy, unsigned keep,
                         void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const Launch a{x,  out, h,   w,   r0,   r1,
                 c0, c1,  csx, csy, keep, (cudaStream_t)stream};
  if (mode == kCopy) return launch_mode<kCopy>(form, edges, bx, by, a);
  if (mode == kGrad) return launch_mode<kGrad>(form, edges, bx, by, a);
  if (mode == kSlope) return launch_mode<kSlope>(form, edges, bx, by, a);
  return (int)cudaErrorInvalidValue;
}

// Launches a staged form at tile th x tw on `stream`, as kernels/staged.py::
// staged_plan planned it: form 0 staged (mode 0 copy, 1 grad, 2 slope, the
// nine-read arithmetic) or 1 separable_staged (mode 2 slope only); edges
// 0 ring (the full walk), 1 interior or 2 bare (the interior walk, staged
// slope only; the edge bands are stencil_edge_launch's) or 3 ring_branch
// (the full walk with a per-cell ring test, staged slope only); route
// 0 TMA or 1 cp.async, which must be the route rule's (xrt::staged_route);
// `stages` ring stages; `grid` persistent blocks; `smem` dynamic shared
// bytes, which must equal the ring's; `tiles` the walk's tiles.  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a plan
// that disagrees or a tile or (form, mode, edges) that is not
// instantiated, or the negated CUresult of a failed tensor-map encode.
int stencil_staged_launch(const float* x, float* out, long long h,
                          long long w, int mode, int form, int edges, int th,
                          int tw, int route, int stages, int grid, int smem,
                          long long tiles, float csx, float csy,
                          void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (route != xrt::kStagedRouteTma && route != xrt::kStagedRouteAsync)
    return (int)cudaErrorInvalidValue;
  const StagedLaunch l{route, x,    out,   h,   w,   stages,
                       grid,  smem, tiles, csx, csy, (cudaStream_t)stream};
  if (edges != kRing) {
    if (form != 0 || mode != kSlope) return (int)cudaErrorInvalidValue;
    if (edges == kInterior || edges == kBare)
      return staged_tile<kSlope, kInterior>(th, tw, l);
    if (edges == kRingBranch)
      return staged_tile<kSlope, kRingBranch>(th, tw, l);
    return (int)cudaErrorInvalidValue;
  }
  if (form == 1) {
    if (mode != kSlope) return (int)cudaErrorInvalidValue;
    return staged_tile<kSepSlope>(th, tw, l);
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
  if (mode == kCopy) return staged_tile<kCopy>(th, tw, l);
  if (mode == kGrad) return staged_tile<kGrad>(th, tw, l);
  if (mode == kSlope) return staged_tile<kSlope>(th, tw, l);
  return (int)cudaErrorInvalidValue;
}

// Launches the edge-band kernel alone on `stream`: the slope (B1's
// expression, NaN on the 1-cell ring) of every cell outside [r0, r1) x
// [c0, c1), which must lie inside the raster (r0 == r1 and c0 == c1 for
// an empty interior: every cell).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an extent outside the raster.
int stencil_edge_launch(const float* x, float* out, long long h, long long w,
                        long long r0, long long r1, long long c0,
                        long long c1, float csx, float csy, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (r0 < 0 || r1 < r0 || r1 > h || c0 < 0 || c1 < c0 || c1 > w)
    return (int)cudaErrorInvalidValue;
  const Launch a{x,  out, h,   w,   r0, r1,
                 c0, c1,  csx, csy, 0u, (cudaStream_t)stream};
  return launch_edges<kSlope>(a);
}
}  // extern "C"
