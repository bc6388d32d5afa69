// XDraw's per-cell passes around its scan X1 (csrc/xdraw.cu), as two
// kernels: xdraw_fields_kernel, each cell's slope from the viewpoint
// (X1's input), and xdraw_epilogue_kernel, each cell's inward max slope
// read from X1's field at its primary and secondary inward neighbours,
// its visibility and its vertical angle.
//
// Replaces no Pallas kernel: in the JAX package these are XLA's fused
// elementwise passes, xrspatial_tpu/kernels/viewshed.py:836 _xdraw_fields
// and :926 _xdraw_epilogue.  Their plain versions are kernels/viewshed.py::
// _xdraw_fields and _xdraw_epilogue (_xdraw_inward_max, _xdraw_angles),
// some sixty torch-op passes over (H, W) planes, which the kernels equal
// bit for bit on the card.
//
// Bound on this card: device memory.  The fields read the DEM and write
// the slope, 8 bytes a cell (0.641 ms at 16384^2); the epilogue reads the
// DEM and X1's field and writes the angles, 12 bytes a cell (0.962 ms).
// The fields run at ~81% of that, the epilogue at ~65%: its two divisions
// and square root a cell cost instruction slots, so a hidden cell (most of
// a viewshed from the ground) skips the angle's third division and atanf.
// Nothing else touches device memory:
// every per-cell quantity the torch passes kept as a plane (dy, dx, the
// distance, its floor, the target's slope, the neighbours' offsets, the
// masks) is computed in registers from the cell's (row, col), the block's
// origin in the raster and scalars passed as arguments, and the
// viewpoint's elevation is read on the card, so the host never waits.
// Each thread takes 4 cells of a row: one 16-byte load and one 16-byte
// streaming store where every row is 16-byte aligned, else 4 scalar ones.
// The epilogue's neighbours lie in the cell's own row and in the row one
// step toward the viewpoint: each thread reads 6 cells of each (a 16-byte
// load and two scalars at the group's sides), which the neighbouring
// threads and the blocks of the neighbouring row read too, so they come
// from L1 and L2 and X1's field leaves device memory about once.
//
// On a mesh the same kernels run per block, at the block's origin, the
// viewpoint's elevation copied to the block's card, and the epilogue reads
// the field with a one-cell halo (`off` 1: halo_extend's -inf beyond the
// raster); on one card the field has no halo (`off` 0) and a neighbour
// outside the raster reads -inf, as the torch passes' shifts fill.
//
// Bits: every product, sum, difference, quotient and square root is
// rounded apart (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn),
// as torch's kernels compute each pass apart, so nvcc contracts nothing
// into an FMA; atanf is the libdevice call of torch's arctan; the
// division by pi is a product with the float32 reciprocal of float32(pi),
// as torch's true division by a scalar from the host computes it on the
// card; the distance's floor and every comparison are float32; max
// propagates NaN, as torch.maximum does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCells = 4;                   // cells a thread, in one row
constexpr int kMaxRowsGrid = 65535;         // gridDim.y's limit

// The raster's geometry and the scalars of both kernels, float32 as the
// torch passes round them (kernels/cuda_xdraw_cells.py::_f32).
struct Geom {
  int h, w;                  // this raster's (or block's) cells
  int y0, x0;                // its cell (0, 0) in the whole raster
  float vp_row, vp_col;      // the viewpoint, in the whole raster
  const float* vp_cell;      // the viewpoint's terrain, on this card
  float observer, target;    // heights above the terrain
  float ew, ns;              // the cell spacings
  float tiny;                // the distance's floor
  float inv_pi;              // float32(1 / float32(pi))
};

__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

// A cell's offsets from the viewpoint, its distance and the distance's
// floor (torch.clamp(min=tiny): the distance is never NaN).
struct Cell {
  float dy, dx, dist, safe;
};

__device__ __forceinline__ Cell cell_at(const Geom& g, int r, int c) {
  Cell k;
  k.dy = __fsub_rn((float)(g.y0 + r), g.vp_row);
  k.dx = __fsub_rn((float)(g.x0 + c), g.vp_col);
  const float wx = __fmul_rn(k.dx, g.ew);
  const float wy = __fmul_rn(k.dy, g.ns);
  k.dist = __fsqrt_rn(__fadd_rn(__fmul_rn(wx, wx), __fmul_rn(wy, wy)));
  k.safe = k.dist < g.tiny ? g.tiny : k.dist;
  return k;
}

// The 4 cells of a row from column c: one 16-byte load where `vec`, else
// the first n one by one (the rest are never used).
__device__ __forceinline__ void load4(float (&v)[kCells],
                                      const float* __restrict__ row, int c,
                                      int n, bool vec) {
  if (vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + c));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kCells; ++j) v[j] = j < n ? __ldg(row + c + j) : 0.f;
  }
}

__device__ __forceinline__ void store4(float* __restrict__ row, int c,
                                       const float (&v)[kCells], int n,
                                       bool vec) {
  if (vec) {
    __stcs(reinterpret_cast<float4*>(row + c),
           make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kCells; ++j)
      if (j < n) __stcs(row + c + j, v[j]);
  }
}

// slope (h, w), contiguous = the slope of each cell of data (h, w), row
// stride ld, from the viewpoint: (z - vp_elev) / max(dist, tiny), -inf
// where the distance is 0 (the viewpoint).  Blocks of kThreads threads,
// kCells cells a thread along a row; gridDim.y rows at a time.
__global__ void __launch_bounds__(kThreads)
xdraw_fields_kernel(Geom g, const float* __restrict__ data, long long ld,
                    float* __restrict__ slope, bool vec) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kCells;
  if (c >= g.w) return;
  const int n = min(kCells, g.w - c);
  const float vpe = __fadd_rn(__ldg(g.vp_cell), g.observer);
  for (int r = blockIdx.y; r < g.h; r += gridDim.y) {
    float z[kCells], s[kCells];
    load4(z, data + (long long)r * ld, c, n, vec);
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      const Cell k = cell_at(g, r, c + j);
      s[j] = k.dist > 0.0f ? __fdiv_rn(__fsub_rn(z[j], vpe), k.safe)
                           : -INFINITY;
    }
    store4(slope + (long long)r * g.w, c, s, n, vec);
  }
}

// Cells c - 1 .. c + 4 of row rr of the field m (mh x mw, row stride ldm),
// -inf outside it: the middle four by one 16-byte load where `vec`.
__device__ __forceinline__ void load6(float (&v)[kCells + 2],
                                      const float* __restrict__ m,
                                      long long ldm, int mh, int mw, int rr,
                                      int c, bool vec) {
  if (rr < 0 || rr >= mh) {
#pragma unroll
    for (int k = 0; k < kCells + 2; ++k) v[k] = -INFINITY;
    return;
  }
  const float* const row = m + (long long)rr * ldm;
  if (vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + c));
    v[1] = q.x; v[2] = q.y; v[3] = q.z; v[4] = q.w;
    v[0] = c > 0 ? __ldg(row + c - 1) : -INFINITY;
    v[5] = c + kCells < mw ? __ldg(row + c + kCells) : -INFINITY;
  } else {
#pragma unroll
    for (int k = 0; k < kCells + 2; ++k) {
      const int cc = c - 1 + k;
      v[k] = cc >= 0 && cc < mw ? __ldg(row + cc) : -INFINITY;
    }
  }
}

// The field at the cell j of the group - s (s = -1, 0, 1 columns) of a
// 6-cell window whose index 1 is the group's first cell.
template <int J>
__device__ __forceinline__ float pick(const float (&v)[kCells + 2], int s) {
  return s > 0 ? v[J] : (s < 0 ? v[J + 2] : v[J + 1]);
}

// The vertical angle of one cell from its terrain z, the two windows of
// X1's field (own: the cell's row; in: the row one step toward the
// viewpoint) and its geometry: the interpolated max slope strictly inward
// of the cell (-inf within one ring of the viewpoint), the visibility
// test against the target's slope, then 0..180 degrees, INVISIBLE (-1)
// where hidden or where the DEM is NaN, 180 at the viewpoint.
template <int J>
__device__ __forceinline__ float angle(const Geom& g, const Cell& k,
                                       float z, float vpe,
                                       const float (&own)[kCells + 2],
                                       const float (&in)[kCells + 2]) {
  const float ady = fabsf(k.dy), adx = fabsf(k.dx);
  const int sx = (k.dx > 0.0f) - (k.dx < 0.0f);
  const bool dom_y = ady >= adx;
  // primary: one step inward along the major axis; secondary: one step
  // inward on both axes
  const float mp = dom_y ? in[J + 1] : pick<J>(own, sx);
  const float ms = pick<J>(in, sx);
  const float ring = fmaxf(ady, adx);
  const float denom = fmaxf(ring, 1.0f);
  const float minor = fminf(ady, adx);
  const bool use_sec = dom_y ? adx > 0.0f : ady > 0.0f;
  const float wsec = use_sec ? __fdiv_rn(minor, denom) : 0.0f;
  float inward = isfinite(mp) && isfinite(ms)
                     ? __fadd_rn(__fmul_rn(mp, __fsub_rn(1.0f, wsec)),
                                 __fmul_rn(ms, wsec))
                     : nan_max(mp, ms);
  if (ring <= 1.0f) inward = -INFINITY;

  const float zt = __fadd_rn(z, g.target);
  const float tgt = k.dist > 0.0f ? __fdiv_rn(__fsub_rn(zt, vpe), k.safe)
                                  : INFINITY;
  if (k.dy == 0.0f && k.dx == 0.0f) return 180.0f;
  // hidden or no terrain: the angle is not computed (most cells of a
  // viewshed from the ground are hidden)
  if (isnan(z) || !(inward <= tgt)) return -1.0f;
  const float diff = __fsub_rn(vpe, zt);
  if (diff == 0.0f) return 90.0f;
  if (diff > 0.0f)
    return __fmul_rn(__fmul_rn(atanf(__fdiv_rn(k.safe, diff)), 180.0f),
                     g.inv_pi);
  return __fadd_rn(
      __fmul_rn(__fmul_rn(atanf(__fdiv_rn(fabsf(diff), k.safe)), 180.0f),
                g.inv_pi),
      90.0f);
}

// angles (h, w), contiguous = the vertical angle of each cell of data
// (h, w), row stride ld, from X1's field m: cell (r, c) of data is m's
// (r + off, c + off) (off 1: a one-cell halo around a mesh block), m
// mh x mw cells, row stride ldm.  The grid as xdraw_fields_kernel's; a
// row's offset from the viewpoint, and so its inward row, is one for all
// its cells.
__global__ void __launch_bounds__(kThreads)
xdraw_epilogue_kernel(Geom g, const float* __restrict__ m, long long ldm,
                      int mh, int mw, int off,
                      const float* __restrict__ data, long long ld,
                      float* __restrict__ angles, bool vec, bool vec_m) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kCells;
  if (c >= g.w) return;
  const int n = min(kCells, g.w - c);
  const float vpe = __fadd_rn(__ldg(g.vp_cell), g.observer);
  for (int r = blockIdx.y; r < g.h; r += gridDim.y) {
    const float dy = __fsub_rn((float)(g.y0 + r), g.vp_row);
    const int sy = (dy > 0.0f) - (dy < 0.0f);
    float own[kCells + 2], in[kCells + 2], z[kCells], a[kCells];
    load6(own, m, ldm, mh, mw, r + off, c + off, vec_m);
    if (sy != 0) {
      load6(in, m, ldm, mh, mw, r + off - sy, c + off, vec_m);
    } else {
#pragma unroll
      for (int k = 0; k < kCells + 2; ++k) in[k] = own[k];
    }
    load4(z, data + (long long)r * ld, c, n, vec);
    a[0] = angle<0>(g, cell_at(g, r, c), z[0], vpe, own, in);
    a[1] = angle<1>(g, cell_at(g, r, c + 1), z[1], vpe, own, in);
    a[2] = angle<2>(g, cell_at(g, r, c + 2), z[2], vpe, own, in);
    a[3] = angle<3>(g, cell_at(g, r, c + 3), z[3], vpe, own, in);
    store4(angles + (long long)r * g.w, c, a, n, vec);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

dim3 grid_of(int h, int w) {
  const int per_block = kThreads * kCells;
  return dim3((unsigned)((w + per_block - 1) / per_block),
              (unsigned)(h < kMaxRowsGrid ? h : kMaxRowsGrid));
}

Geom geom(int h, int w, int y0, int x0, int vp_row, int vp_col,
          const float* vp_cell, float observer, float target, float ew,
          float ns, float tiny, float inv_pi) {
  return Geom{h, w, y0, x0, (float)vp_row, (float)vp_col, vp_cell,
              observer, target, ew, ns, tiny, inv_pi};
}

}  // namespace

extern "C" {

// slope (h, w), contiguous = the XDraw slope field of data (h, w), row
// stride ld (in floats), whose cell (0, 0) is the raster's (y0, x0), seen
// from (vp_row, vp_col) of the raster at the height *vp_cell + observer
// (vp_cell on the card); ew, ns the spacings, tiny the distance's floor.
// On `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an empty raster or a row stride below w.
int xdraw_fields_launch(const float* data, long long ld, float* slope, int h,
                        int w, int y0, int x0, int vp_row, int vp_col,
                        const float* vp_cell, float observer, float ew,
                        float ns, float tiny, void* stream) {
  if (h <= 0 || w <= 0 || ld < w || vp_cell == nullptr)
    return (int)cudaErrorInvalidValue;
  const Geom g = geom(h, w, y0, x0, vp_row, vp_col, vp_cell, observer, 0.f,
                      ew, ns, tiny, 0.f);
  const bool vec = w % kCells == 0 && ld % kCells == 0 && aligned16(data) &&
                   aligned16(slope);
  xdraw_fields_kernel<<<grid_of(h, w), kThreads, 0, (cudaStream_t)stream>>>(
      g, data, ld, slope, vec);
  return (int)cudaGetLastError();
}

// angles (h, w), contiguous = the XDraw viewshed's vertical angles of data
// (h, w), row stride ld, from X1's field m (mh x mw, row stride ldm),
// data's cell (r, c) at m's (r + off, c + off), off 0 (m is the raster's
// field, mh = h, mw = w) or 1 (a one-cell halo, mh = h + 2, mw = w + 2);
// the geometry as xdraw_fields_launch's, target the targets' height,
// inv_pi float32(1 / float32(pi)).  Returns as xdraw_fields_launch does.
int xdraw_epilogue_launch(const float* m, long long ldm, int mh, int mw,
                          int off, const float* data, long long ld,
                          float* angles, int h, int w, int y0, int x0,
                          int vp_row, int vp_col, const float* vp_cell,
                          float observer, float target, float ew, float ns,
                          float tiny, float inv_pi, void* stream) {
  if (h <= 0 || w <= 0 || ld < w || ldm < mw || vp_cell == nullptr ||
      (off != 0 && off != 1) || mh != h + 2 * off || mw != w + 2 * off)
    return (int)cudaErrorInvalidValue;
  const Geom g = geom(h, w, y0, x0, vp_row, vp_col, vp_cell, observer, target,
                      ew, ns, tiny, inv_pi);
  const bool vec = w % kCells == 0 && ld % kCells == 0 && aligned16(data) &&
                   aligned16(angles);
  const bool vec_m = vec && off == 0 && ldm % kCells == 0 && aligned16(m);
  xdraw_epilogue_kernel<<<grid_of(h, w), kThreads, 0,
                          (cudaStream_t)stream>>>(g, m, ldm, mh, mw, off,
                                                  data, ld, angles, vec,
                                                  vec_m);
  return (int)cudaGetLastError();
}

}  // extern "C"
