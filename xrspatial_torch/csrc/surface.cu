// surface_staged_kernel (B1): slope, aspect, curvature and hillshade of a
// float32 DEM from one read of each tile's window.
//
// Replaces the TPU kernel xrspatial_tpu/kernels/pallas_surface2.py::
// surface_tiled (body emit_surface), together with the polynomial
// atan/atan2 of xrspatial_tpu/kernels/pallas_surface.py (_atan_of_sqrt,
// _atan2, _atan, _atan_poly): those exist only because the TPU compiler
// has no atan, so this kernel calls libdevice atanf/atan2f instead.  The
// TPU kernel's seam-band passes and ragged-edge NaN pad have no
// counterpart.
//
// Bound on this card: device memory traffic, 1 read + K writes of f32 a
// cell (3.22 GB for slope + hillshade at 16384^2, 0.962 ms at 3.35 TB/s);
// ~41 float operations a cell are far below the compute roof.
//
// Redesigned for Hopper on the stencil probe B8c's staged form, whose
// slope reached 0.88 ms against 2.19 ms for the first port's nine global
// reads a cell (the same bits).  Persistent blocks, three an SM, walk TH x
// TW tiles through a ring of TMA-staged (TH + 2) x (TW + 8) windows
// (staged_window.cuh: NaN out-of-bounds fill, so the 1-cell NaN ring, and
// every cell of a raster with h < 3 or w < 3, come out of the arithmetic
// with no ring or bounds test; cp.async where TMA refuses the pitch or
// base).  Each thread computes 4 neighbouring cells of a row from 3 x 6
// shared values for every product in the mask (surface_cell.cuh::
// surface_quad) and writes each product plane with one 16-byte streaming
// store (scalar stores on the cp.async route).  The tile, the ring's
// stages and the grid are kernels/surface.py::surface_plan's.
//
// surface_kernel: B1's first port, kept by name (route "simple"): one
// thread per output cell, 32x8 blocks, neighbours read straight from
// global memory with the ring test (surface_cell.cuh::surface_cell).
//
// B0, the stacked surface kernel: the same products written as the planes
// of one (K, H, W) float32 buffer, plane k = which[k] in any order.
// Replaces the TPU kernel xrspatial_tpu/kernels/pallas_surface.py::
// surface_pallas (its emit_pipeline body), with the same libdevice
// atanf/atan2f in place of that file's polynomial atan.  The TPU kernel's
// tile padding and ragged NaN pad have no counterpart.  Same bound: 1 read
// + K writes (5.37 GB for all four products at 16384^2, 1.603 ms at 3.35
// TB/s).  Redesigned on B1's persistent window ring, its planes being the
// product pointers out + plane * H * W (kernels/surface.py::stacked_plan
// names the route):
// - route TMA (w % 4 == 0 and 16-byte-aligned bases: every plane is then
//   16-byte aligned): surface_staged_kernel itself.
// - route phased (any pitch and base; the plan takes it where TMA
//   refuses): surface_phased_kernel.  Its windows are staged with 16-byte
//   cp.async copies of each row's aligned body, the row placed in shared
//   memory at its global phase (staged_window.cuh), read back through
//   load6_phased.  With odd H * W the planes of one buffer lie at four
//   different offsets, and a 32-byte sector written in parts by two warps
//   costs more than a third of the kernel's time (surface_cell.cuh,
//   store_span): so a warp computes 128 cells of a tile row and writes
//   each plane's 120-cell span that starts on a 32-byte boundary of that
//   plane, with 16-byte streaming stores, lanes handing their neighbours
//   the cells a store needs by shuffle; tiles lie 120 columns apart, and
//   only the sectors around a raster row's ends are written in parts.
// - surface_stacked_kernel, B0's first port, kept by name (route
//   "simple"): surface_cell on the plane pointers, one thread a cell.
//
// Every kernel here computes every product through surface_cell.cuh's
// per-product functions (sobel, slope_value, ...): the same instructions
// in the same order, so each of B0's planes equals B1's product bit for
// bit.

#include "staged_window.cuh"
#include "surface_cell.cuh"

namespace {

constexpr int kBlockX = 32, kBlockY = 8;

__global__ void surface_kernel(const float* __restrict__ x,
                               xrt::SurfaceArgs args, long long h,
                               long long w) {
  const long long col = (long long)blockIdx.x * kBlockX + threadIdx.x;
  if (col >= w) return;
  const long long row_step = (long long)gridDim.y * kBlockY;
  for (long long row = (long long)blockIdx.y * kBlockY + threadIdx.y;
       row < h; row += row_step)
    xrt::surface_cell(x, h, w, row, col, args);
}

// Plane of each product in the stacked buffer, in the order slope,
// aspect, curvature, hillshade; -1 where the product is not computed.
struct PlaneMap {
  int plane[4];
};

__global__ void surface_stacked_kernel(const float* __restrict__ x,
                                       float* __restrict__ out,
                                       PlaneMap map, float csx, float csy,
                                       float sin_a, float cos_a, float sin_p,
                                       float cos_p, long long h,
                                       long long w) {
  const long long col = (long long)blockIdx.x * kBlockX + threadIdx.x;
  if (col >= w) return;
  float* planes[4];
  int mask = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    planes[j] = map.plane[j] >= 0 ? out + map.plane[j] * h * w : nullptr;
    if (map.plane[j] >= 0) mask |= 1 << j;  // xrt::kSlope ... kHillshade
  }
  const xrt::SurfaceArgs args{planes[0], planes[1], planes[2], planes[3],
                              mask,      csx,       csy,       sin_a,
                              cos_a,     sin_p,     cos_p};
  const long long row_step = (long long)gridDim.y * kBlockY;
  for (long long row = (long long)blockIdx.y * kBlockY + threadIdx.y;
       row < h; row += row_step)
    xrt::surface_cell(x, h, w, row, col, args);
}

// Blocks an SM the staged kernel is compiled for, its register cap (80 a
// thread), and the ring's size (kernels/surface.py::SURFACE_BLOCKS_PER_SM):
// three blocks of 2 stages at 64x128 were faster than two of 3 stages at
// every tile on an H100, four no faster than three.
constexpr int kSurfaceBlocksPerSm = 3;

template <int TH, int TW, int ROUTE>
__global__ void __launch_bounds__(xrt::kStagedThreads, kSurfaceBlocksPerSm)
    surface_staged_kernel(const __grid_constant__ CUtensorMap map,
                          const xrt::RingArgs a, const xrt::SurfaceArgs p) {
  using Win = xrt::Window<TH, TW>;
  constexpr int kQuadCols = TW / 4;
  extern __shared__ unsigned char smem_raw[];
  xrt::staged_tiles<TH, TW, ROUTE>(
      &map, a, smem_raw, [&](const float* win, long long r0, long long c0) {
        for (int q = threadIdx.x; q < TH * kQuadCols;
             q += xrt::kStagedThreads) {
          const int tr = q / kQuadCols, tc = 4 * (q - tr * kQuadCols);
          const long long row = r0 + tr, col = c0 + tc;
          if (row >= a.h || col >= a.w) continue;
          float v[4][4];
          xrt::surface_quad(win + tr * Win::kCols + tc, Win::kCols, p, v);
          // the TMA route has w % 4 == 0: the 4 cells lie in the raster
          // together
          xrt::surface_store4(p, row * a.w + col, v,
                              ROUTE == xrt::kStagedRouteTma, a.w - col);
        }
      });
}

template <int TH, int TW, int ROUTE>
int launch_staged(const float* x, const xrt::SurfaceArgs& p, bool aligned,
                  long long h, long long w, int stages, int grid, int smem,
                  cudaStream_t stream) {
  CUtensorMap map{};
  xrt::RingArgs a{};
  int err = xrt::staged_setup<TH, TW>(x, aligned, h, w, ROUTE, stages, grid,
                                      smem, &map, &a);
  if (err != 0) return err;
  auto kernel = surface_staged_kernel<TH, TW, ROUTE>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  kernel<<<grid, xrt::kStagedThreads, smem, stream>>>(map, a, p);
  return (int)cudaGetLastError();
}

// B0's route phased: B1's loop on windows staged by route phased.  Each
// warp computes 128 cells of a tile row (32 quads) from cc0 = c0 - 8 and
// stores each plane's 120-cell span (surface_cell.cuh::store_span); tiles
// lie 120 columns apart, and one more covers a row whose last span ends
// past the last tile's 120 columns.
template <int TH>
__global__ void __launch_bounds__(xrt::kStagedThreads, kSurfaceBlocksPerSm)
    surface_phased_kernel(const xrt::RingArgs a, const xrt::SurfaceArgs p) {
  constexpr int TW = 128;
  using Win = xrt::Window<TH, TW>;
  static_assert(TW / 4 == 32, "a tile row is one warp's quads");
  extern __shared__ unsigned char smem_raw[];
  xrt::staged_tiles<TH, TW, xrt::kStagedRoutePhased, xrt::kSpanCells,
                    xrt::kSpanShift>(
      nullptr, a, smem_raw,
      [&](const float* win, long long r0, long long cc0) {
        const int tc = 4 * (threadIdx.x & 31);
        // rows grow with tr, and a warp shares its tr: the break and the
        // product branches are the same for all 32 lanes, as the
        // shuffles of the stores need
        for (int tr = threadIdx.x / 32; tr < TH;
             tr += xrt::kStagedThreads / 32) {
          const long long row = r0 + tr;
          if (row >= a.h) break;
          const float* const w0 = win + tr * Win::kPhasedPitch;
          float u[6], m[6], d[6];
          xrt::load6_phased(w0, xrt::row_phase(a, row - 1, cc0), tc, u);
          xrt::load6_phased(w0 + Win::kPhasedPitch,
                            xrt::row_phase(a, row, cc0), tc, m);
          xrt::load6_phased(w0 + 2 * Win::kPhasedPitch,
                            xrt::row_phase(a, row + 1, cc0), tc, d);
          float v[4][4];
          xrt::surface_quad_of(u, m, d, p, v);
          xrt::surface_store_spans(p, row, a.w, cc0, v);
        }
      });
}

template <int TH>
int launch_phased(const float* x, const xrt::SurfaceArgs& p, long long h,
                  long long w, int stages, int grid, int smem,
                  cudaStream_t stream) {
  xrt::RingArgs a{};
  int err = xrt::staged_setup<TH, 128>(
      x, true, h, w, xrt::kStagedRoutePhased, stages, grid, smem, nullptr,
      &a, xrt::kSpanCells, xrt::kSpanShift - 1);
  if (err != 0) return err;
  auto kernel = surface_phased_kernel<TH>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  kernel<<<grid, xrt::kStagedThreads, smem, stream>>>(a, p);
  return (int)cudaGetLastError();
}

template <int TH, int TW>
int staged_on_route(int route, const float* x, const xrt::SurfaceArgs& p,
                    bool aligned, long long h, long long w, int stages,
                    int grid, int smem, cudaStream_t stream) {
  if (route == xrt::kStagedRouteTma)
    return launch_staged<TH, TW, xrt::kStagedRouteTma>(
        x, p, aligned, h, w, stages, grid, smem, stream);
  return launch_staged<TH, TW, xrt::kStagedRouteAsync>(
      x, p, aligned, h, w, stages, grid, smem, stream);
}

dim3 surface_grid(long long h, long long w) {
  const long long blocks_y = (h + kBlockY - 1) / kBlockY;
  return dim3((unsigned)((w + kBlockX - 1) / kBlockX),
              (unsigned)(blocks_y < 65535 ? blocks_y : 65535));
}

}  // namespace

extern "C" {

// Launches surface_kernel, B1's first port, on `stream`.  `mask` selects
// the products (1 slope, 2 aspect, 4 curvature, 8 hillshade); the pointer
// of a product that is not selected is not touched.  Returns cudaGetLastError() after
// the launch, so a refused launch is reported to the caller.
int surface_launch(const float* x, float* slope, float* aspect, float* curv,
                   float* hill, long long h, long long w, int mask,
                   float csx, float csy, float sin_a, float cos_a,
                   float sin_p, float cos_p, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const xrt::SurfaceArgs args{slope, aspect, curv,  hill,  mask, csx,
                              csy,   sin_a,  cos_a, sin_p, cos_p};
  surface_kernel<<<surface_grid(h, w), dim3(kBlockX, kBlockY), 0,
                   (cudaStream_t)stream>>>(x, args, h, w);
  return (int)cudaGetLastError();
}

// Launches surface_staged_kernel at tile th x tw (32x128, 64x128 or
// 32x248) on `stream`, as kernels/surface.py::surface_plan planned it:
// route 0 TMA or 1 cp.async, which must be the route rule's
// (xrt::staged_route over x and every selected plane); `stages` ring
// stages; `grid` persistent blocks; `smem` dynamic shared bytes, which
// must equal the ring's.  `mask` and the planes as surface_launch's; mask
// 0 or above 15 is refused.  Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for a plan that disagrees or a tile that is not
// instantiated, or the negated CUresult of a failed tensor-map encode.
int surface_staged_launch(const float* x, float* slope, float* aspect,
                          float* curv, float* hill, long long h, long long w,
                          int mask, float csx, float csy, float sin_a,
                          float cos_a, float sin_p, float cos_p, int th,
                          int tw, int route, int stages, int grid, int smem,
                          void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (mask <= 0 || mask > 15 ||
      (route != xrt::kStagedRouteTma && route != xrt::kStagedRouteAsync))
    return (int)cudaErrorInvalidValue;
  const xrt::SurfaceArgs p{slope, aspect, curv,  hill,  mask, csx,
                           csy,   sin_a,  cos_a, sin_p, cos_p};
  float* const planes[4] = {slope, aspect, curv, hill};
  bool aligned = true;
  for (int k = 0; k < 4; ++k)
    if (mask & (1 << k)) aligned = aligned && xrt::aligned16(planes[k]);
  const cudaStream_t s = (cudaStream_t)stream;
  if (th == 32 && tw == 128)
    return staged_on_route<32, 128>(route, x, p, aligned, h, w, stages, grid,
                                     smem, s);
  if (th == 64 && tw == 128)
    return staged_on_route<64, 128>(route, x, p, aligned, h, w, stages, grid,
                                     smem, s);
  if (th == 32 && tw == 248)
    return staged_on_route<32, 248>(route, x, p, aligned, h, w, stages, grid,
                                     smem, s);
  return (int)cudaErrorInvalidValue;
}

// Launches B0 on `stream` as kernels/surface.py::stacked_plan planned it:
// plane p_slope ... p_hill of the (K, h, w) buffer `out` receives that
// product (a product whose plane is -1 is not computed); route 0 TMA
// (surface_staged_kernel at tile th x tw, 32x128, 64x128 or 32x248; the
// route rule's, over x and every plane) or 2 phased (surface_phased_kernel
// writing tiles of 32x120 or 64x120, any pitch and base); `stages`, `grid`
// and `smem` as surface_staged_launch's.  Returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for no product, a plan that disagrees
// or a tile the route lacks, or the negated CUresult of a failed
// tensor-map encode.
int surface_stacked_staged_launch(const float* x, float* out, long long h,
                                  long long w, int p_slope, int p_aspect,
                                  int p_curv, int p_hill, float csx,
                                  float csy, float sin_a, float cos_a,
                                  float sin_p, float cos_p, int th, int tw,
                                  int route, int stages, int grid, int smem,
                                  void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const int plane[4] = {p_slope, p_aspect, p_curv, p_hill};
  float* planes[4];
  int mask = 0;
  bool aligned = true;
  for (int k = 0; k < 4; ++k) {
    planes[k] = plane[k] >= 0 ? out + plane[k] * h * w : nullptr;
    if (plane[k] < 0) continue;
    mask |= 1 << k;
    aligned = aligned && xrt::aligned16(planes[k]);
  }
  if (mask == 0) return (int)cudaErrorInvalidValue;
  const xrt::SurfaceArgs p{planes[0], planes[1], planes[2], planes[3], mask,
                           csx,       csy,       sin_a,     cos_a,     sin_p,
                           cos_p};
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == xrt::kStagedRoutePhased) {
    if (th == 32 && tw == xrt::kSpanCells)
      return launch_phased<32>(x, p, h, w, stages, grid, smem, s);
    if (th == 64 && tw == xrt::kSpanCells)
      return launch_phased<64>(x, p, h, w, stages, grid, smem, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route != xrt::kStagedRouteTma) return (int)cudaErrorInvalidValue;
  if (th == 32 && tw == 128)
    return launch_staged<32, 128, xrt::kStagedRouteTma>(
        x, p, aligned, h, w, stages, grid, smem, s);
  if (th == 64 && tw == 128)
    return launch_staged<64, 128, xrt::kStagedRouteTma>(
        x, p, aligned, h, w, stages, grid, smem, s);
  if (th == 32 && tw == 248)
    return launch_staged<32, 248, xrt::kStagedRouteTma>(
        x, p, aligned, h, w, stages, grid, smem, s);
  return (int)cudaErrorInvalidValue;
}

// Launches surface_stacked_kernel, B0's first port, on `stream`: planes
// as surface_stacked_staged_launch's.  Returns cudaGetLastError() after
// the launch.
int surface_stacked_launch(const float* x, float* out, long long h,
                           long long w, int p_slope, int p_aspect,
                           int p_curv, int p_hill, float csx, float csy,
                           float sin_a, float cos_a, float sin_p, float cos_p,
                           void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const PlaneMap map{{p_slope, p_aspect, p_curv, p_hill}};
  surface_stacked_kernel<<<surface_grid(h, w), dim3(kBlockX, kBlockY), 0,
                           (cudaStream_t)stream>>>(
      x, out, map, csx, csy, sin_a, cos_a, sin_p, cos_p, h, w);
  return (int)cudaGetLastError();
}

const char* xrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
