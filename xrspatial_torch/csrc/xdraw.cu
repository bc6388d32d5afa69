// xdraw_scan_kernel: the XDraw viewshed's running max slope along each
// cell's ray, all four half-plane scans in one launch.
//
// Replaces no Pallas kernel: in the JAX package the scan is a lax.scan of
// XLA, xrspatial_tpu/kernels/viewshed.py:771 _halfplane_scan4 (and the four
// separate scans of :863-886 above 8192 cells a side).  As torch ops it
// would be N steps of about 20 launches each; here it is one launch.  The
// plain version is kernels/viewshed.py::xdraw_scan_twin.
//
// The recurrence: a half-plane is walked along its major axis, one line
// of cells a step; each cell's value is the max of its own slope and the
// blocking slope interpolated from two cells of the previous line (the
// primary, one step toward the viewpoint, and the secondary, one more
// step toward the viewpoint's minor coordinate).  East and west walk the
// columns (reading the transposed slope, so each step's loads are
// contiguous), south and north the rows.
//
// Bound on this card: the dependence from one step to the next.  Each
// block owns one half-plane: 1024 threads, each L lanes of the minor
// axis, the carry double-buffered in shared memory (2 x max(h, w) floats,
// 128 KB at 16384; in a global scratch buffer above what a block can
// take), one __syncthreads() a step, the next step's slopes loaded into
// registers while this step computes.  Only 4 of the 132 SMs work: a
// banded form over many blocks is later work.  The steps before the
// viewpoint (all -inf) are skipped, and so are the lanes outside the
// ray cone |minor| <= dxf, which are -inf in both buffers from the start
// (the cone only grows).  The kernel writes only the cells of its own
// octant into one (H, W) field (kernels/viewshed.py::_xdraw_octant_masks:
// east and west own |dy| <= |dx|, diagonals included, east the viewpoint
// too; south and north the rest).
//
// Bits: every product, sum, difference and the division is rounded apart
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc contracts nothing
// into an FMA and the kernel equals its torch twin bit for bit; max
// propagates NaN, as torch.maximum does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxLanes = 64;               // lanes a thread, at most
constexpr int kSmemMax = 232448;            // a block's shared memory limit

__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

// The slopes of step k's line for this thread's lanes: those in the
// ray cone |minor| <= dxf, -inf elsewhere (never read).
template <int L>
__device__ __forceinline__ void load_line(float (&s)[L],
                                          const float* __restrict__ src,
                                          int k, float vpm, bool reverse,
                                          int last, int lanes,
                                          float vp_minor) {
  const float dxf = __fsub_rn((float)k, vpm);
  const size_t line = (size_t)(reverse ? last - k : k) * lanes;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int lane = threadIdx.x + i * blockDim.x;
    s[i] = -INFINITY;
    if (lane < lanes && fabsf(__fsub_rn((float)lane, vp_minor)) <= dxf)
      s[i] = __ldg(src + line + lane);
  }
}

// Half-plane blockIdx.x: 0 east, 1 west (walking columns of slope_t, the
// (w, h) transpose), 2 south, 3 north (rows of slope, (h, w)).  `carry`
// holds 2 * n floats of this block (shared, or its part of the scratch).
template <int L>
__device__ void scan(const float* __restrict__ slope,
                     const float* __restrict__ slope_t,
                     float* __restrict__ out, int h, int w, int vp_row,
                     int vp_col, float* carry, int n) {
  const float neginf = -INFINITY;
  const int hp = blockIdx.x;
  const bool x_major = hp < 2;
  const bool reverse = hp & 1;
  const int steps = x_major ? w : h;        // major extent
  const int lanes = x_major ? h : w;        // minor extent
  const int last = steps - 1;
  const int vp_major = x_major ? vp_col : vp_row;
  const float vp_minor = (float)(x_major ? vp_row : vp_col);
  const float vpm =
      reverse ? __fsub_rn((float)last, (float)vp_major) : (float)vp_major;
  const int k0 = (reverse ? last - vp_major : vp_major) + 1;  // dxf = 1
  const float* const src = x_major ? slope_t : slope;

  float* cur = carry;
  float* nxt = carry + n;
  for (int lane = threadIdx.x; lane < lanes; lane += blockDim.x)
    cur[lane] = nxt[lane] = neginf;
  if (hp == 0 && threadIdx.x == 0)
    out[(size_t)vp_row * w + vp_col] = neginf;   // the viewpoint: east's
  __syncthreads();

  float s_next[L];
  if (k0 < steps)
    load_line<L>(s_next, src, k0, vpm, reverse, last, lanes, vp_minor);

  for (int k = k0; k < steps; ++k) {
    float s_cur[L];
#pragma unroll
    for (int i = 0; i < L; ++i) s_cur[i] = s_next[i];
    if (k + 1 < steps)
      load_line<L>(s_next, src, k + 1, vpm, reverse, last, lanes, vp_minor);
    const float dxf = __fsub_rn((float)k, vpm);      // > 0 from k0 on
    const float wden = fmaxf(dxf, 1.0f);
    const int line = reverse ? last - k : k;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int lane = threadIdx.x + i * blockDim.x;
      if (lane >= lanes) break;
      const float minor = __fsub_rn((float)lane, vp_minor);
      const float ady = fabsf(minor);
      if (!(ady <= dxf)) continue;      // outside the cone: -inf, unwritten
      const float prim = cur[lane];
      float sec = prim;
      if (minor > 0.0f) sec = lane > 0 ? cur[lane - 1] : neginf;
      if (minor < 0.0f) sec = lane + 1 < lanes ? cur[lane + 1] : neginf;
      const float wsec = ady > 0.0f ? __fdiv_rn(ady, wden) : 0.0f;
      const float interp =
          isfinite(prim) && isfinite(sec)
              ? __fadd_rn(__fmul_rn(prim, __fsub_rn(1.0f, wsec)),
                          __fmul_rn(sec, wsec))
              : nan_max(prim, sec);
      const float blocked = dxf == 1.0f ? neginf : interp;
      const float m = nan_max(blocked, s_cur[i]);
      nxt[lane] = m;
      if (x_major)                      // |dy| <= |dx|: east or west owns it
        out[(size_t)lane * w + line] = m;
      else if (ady < dxf)               // |dx| < |dy|: south or north
        out[(size_t)line * w + lane] = m;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <int L>
__global__ void __launch_bounds__(kMaxThreads)
    xdraw_scan_kernel(const float* __restrict__ slope,
                      const float* __restrict__ slope_t,
                      float* __restrict__ out, int h, int w, int vp_row,
                      int vp_col, float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int n = h > w ? h : w;
  float* carry = scratch ? scratch + (size_t)blockIdx.x * 2 * n : smem;
  scan<L>(slope, slope_t, out, h, w, vp_row, vp_col, carry, n);
}

template <int L>
int launch(const float* slope, const float* slope_t, float* out, int h,
           int w, int vp_row, int vp_col, float* scratch, int threads,
           cudaStream_t stream) {
  const int n = h > w ? h : w;
  const int smem = scratch ? 0 : 2 * n * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xdraw_scan_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  xdraw_scan_kernel<L><<<4, threads, smem, stream>>>(
      slope, slope_t, out, h, w, vp_row, vp_col, scratch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the global scratch the launch needs for an h x w raster: 0
// where the carry fits a block's shared memory.
long long xdraw_scratch_bytes(int h, int w) {
  const long long n = h > w ? h : w;
  return 8 * n <= kSmemMax ? 0 : 4 * 2 * n * (long long)sizeof(float);
}

// out (h, w) = the running max slope of slope (h, w), slope_t its (w, h)
// transpose, for the viewpoint (vp_row, vp_col), on `stream`.  `scratch`
// holds xdraw_scratch_bytes(h, w) bytes, or is null when that is 0.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a raster the kernel does not take (more than 65536 cells a side) or
// a viewpoint outside it.
int xdraw_scan_launch(const float* slope, const float* slope_t, float* out,
                      int h, int w, int vp_row, int vp_col, float* scratch,
                      void* stream) {
  if (h <= 0 || w <= 0 || vp_row < 0 || vp_row >= h || vp_col < 0 ||
      vp_col >= w)
    return (int)cudaErrorInvalidValue;
  const int n = h > w ? h : w;
  if ((xdraw_scratch_bytes(h, w) != 0) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = n < kMaxThreads ? (n + 31) / 32 * 32 : kMaxThreads;
  const int per = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (per <= 1) return launch<1>(slope, slope_t, out, h, w, vp_row, vp_col,
                                 scratch, threads, s);
  if (per <= 2) return launch<2>(slope, slope_t, out, h, w, vp_row, vp_col,
                                 scratch, threads, s);
  if (per <= 4) return launch<4>(slope, slope_t, out, h, w, vp_row, vp_col,
                                 scratch, threads, s);
  if (per <= 8) return launch<8>(slope, slope_t, out, h, w, vp_row, vp_col,
                                 scratch, threads, s);
  if (per <= 16) return launch<16>(slope, slope_t, out, h, w, vp_row, vp_col,
                                   scratch, threads, s);
  if (per <= 32) return launch<32>(slope, slope_t, out, h, w, vp_row, vp_col,
                                   scratch, threads, s);
  if (per <= kMaxLanes)
    return launch<kMaxLanes>(slope, slope_t, out, h, w, vp_row, vp_col,
                             scratch, threads, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
