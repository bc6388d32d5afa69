// stencil_probe: one templated float32 3x3 slope stencil whose
// instantiations are the port of four TPU probes of the surface kernel
// B1 (xrspatial_torch/kernels/stencil_probe.py names which is which):
//
// - tools/exp_stencil2.py::pipe_stencil (B8c): MODE copy, grad or slope
//   on BX x BY blocks, B1's per-cell ring test.  The TPU probe sweeps
//   tile shapes; here the block shapes 32x8, 32x16 and 64x4 take their
//   place.  Its NaN pad has no counterpart: the 1-cell ring is NaN in
//   grad and slope, as in B1.  copy reads B1's whole 3x3 window and folds
//   the 8 neighbours into its output through a mask the wrapper passes as
//   0, so the compiler keeps those loads and the output equals the input
//   bit for bit: B1's data movement without its arithmetic.
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
// - tools/exp_padfree_stencil.py::slope_2d (B8e): EDGES interior.  The
//   main launch covers only the blocks that lie wholly inside the ring and
//   tests no bound; a second, small launch writes the edge bands and the
//   ring.  The result equals B1's slope bit for bit.
// - tools/exp_seam_cost.py::run (B8f): the port has no seam passes, so its
//   variants become B1 with and without the border branch: ring_branch is
//   EDGES ring (B1's per-cell test, surface_cell.cuh), bare is EDGES bare
//   (interior blocks only, the ring and edge bands left unwritten); prod
//   is B1 itself, called by name.
//
// Every slope is B1's expression: sx / (8*csx) (exact at csx = 1, where
// the TPU probes multiply by 0.125), libdevice sqrtf and atanf, the same
// operation order, so B1's contractions happen here too; no fast math.
//
// What bounds it: one read and one write of the float32 plane (8 bytes a
// cell) against ~24 float operations a cell: device memory, 0.641 ms at
// 16384^2 and 3.35 TB/s.  What the variants measure: copy against slope
// is the arithmetic's share of B1's time, interior and bare against
// ring_branch the bounds checks' and the ring branch's, separable against
// nine the cost of the nine reads.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "surface_cell.cuh"

namespace {

constexpr int kCopy = 0, kGrad = 1, kSlope = 2;
constexpr int kNine = 0, kSeparable = 1;
constexpr int kRing = 0, kInterior = 1, kBare = 2;
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
  const float sx = (c + 2.0f * f + ii) - (a + 2.0f * d + g);
  const float sy = (g + 2.0f * hh + ii) - (a + 2.0f * b + c);
  return slope_of<MODE>(sx, sy, csx, csy);
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
    const long long n = a.r0 * a.w + (a.h - a.r1) * a.w +
                        (a.r1 - a.r0) * (a.c0 + a.w - a.c1);
    if (edges == kInterior && n > 0) {
      const long long blocks = (n + kEdgeThreads - 1) / kEdgeThreads;
      stencil_edge_kernel<MODE><<<(unsigned)(blocks < 4096 ? blocks : 4096),
                                  kEdgeThreads, 0, a.stream>>>(
          a.x, a.out, a.h, a.w, a.r0, a.r1, a.c0, a.c1, n, a.csx, a.csy,
          a.keep);
      return (int)cudaGetLastError();
    }
    return 0;
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

}  // extern "C"
