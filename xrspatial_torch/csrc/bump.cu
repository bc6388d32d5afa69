// bump_scan_kernel (X2): the bump map's sequential accumulation, every
// bump in one launch.
//
// Replaces no Pallas kernel: in the JAX package the walk is a lax.scan of
// XLA, xrspatial_tpu/bump.py:25 _scan_bumps (and the scatter-add of
// _scan_bumps_nospread, :58, at spread 0).  As torch ops it is about three
// launches a bump, and the default count is w * h / 10 bumps (1.68M at
// 4096^2); here it is one launch.  The plain version is
// kernels/bump.py::bump_scan_twin.
//
// Bump i, in order: the centre cell (y, x) gains its height; then every
// cell of the half-open square [y - s, y + s) x [x - s, x + s) whose
// squared offset is at most s^2 and that lies inside the raster gains
// centre * k[o], k = d2 / s^2 taken from a table the wrapper computes in
// float64 (offset (0, 0) included, with k = 0).  A later bump reads the
// centre as the earlier ones left it, so the bumps cannot be reordered.
//
// Bound on this card: the dependent chain, not bytes.  One block walks
// the bumps: thread 0 adds the height to the centre and puts the new value
// in shared memory; a barrier; the block's threads (one warp at spread 1,
// up to 1024) add the ring, one offset a thread; a barrier.  Each bump thus
// costs a round trip to device memory and two barriers, about a
// microsecond, on one SM of 132.  The next bump's location and height are
// loaded while this one is added.  Batching bumps whose footprints do not
// overlap is later work.
//
// Bits: every product and sum is rounded apart (__dmul_rn, __dadd_rn), so
// nvcc contracts nothing into an FMA and the kernel equals its twin, and
// the JAX package's float64 scan, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bump_scan_kernel(double* __restrict__ out,
                                 const int* __restrict__ locs,
                                 const double* __restrict__ heights,
                                 long long n, int h, int w, int spread,
                                 const double* __restrict__ k) {
  __shared__ double centre;
  const int side = 2 * spread;
  const int n_off = side * side;
  const int s2 = spread * spread;
  int x = 0, y = 0;
  double z = 0.0;
  if (n > 0) {
    x = __ldg(locs);
    y = __ldg(locs + 1);
    z = __ldg(heights);
  }
  for (long long i = 0; i < n; ++i) {
    const int cx = x, cy = y;
    const double cz = z;
    if (i + 1 < n) {               // the next bump, read ahead
      x = __ldg(locs + 2 * (i + 1));
      y = __ldg(locs + 2 * (i + 1) + 1);
      z = __ldg(heights + i + 1);
    }
    if (threadIdx.x == 0) {
      double* c = out + (size_t)cy * w + cx;
      const double v = __dadd_rn(*c, cz);
      *c = v;
      centre = v;
    }
    if (n_off == 0) continue;      // spread 0: one thread, no ring
    __syncthreads();
    const double cv = centre;
    for (int o = threadIdx.x; o < n_off; o += blockDim.x) {
      const int oy = o / side - spread;
      const int ox = o % side - spread;
      const int ny = cy + oy;
      const int nx = cx + ox;
      if (ox * ox + oy * oy <= s2 && ny >= 0 && ny < h && nx >= 0 &&
          nx < w) {
        double* p = out + (size_t)ny * w + nx;
        *p = __dadd_rn(*p, __dmul_rn(cv, __ldg(k + o)));
      }
    }
    __syncthreads();
  }
}

}  // namespace

// out: (h, w) float64, the running map; locs: (n, 2) int32 (x, y), each
// inside the raster; heights: (n,) float64; k: (2 spread)^2 float64,
// d2 / spread^2 at every offset of the square, oy slowest (unused at
// spread 0).  Returns the launch's CUDA error code.
extern "C" int bump_scan_launch(void* out, const void* locs,
                                const void* heights, long long n, int h,
                                int w, int spread, const void* k,
                                void* stream) {
  const int n_off = 4 * spread * spread;
  int threads = 1;
  if (n_off > 0) {
    threads = n_off < 1024 ? ((n_off + 31) / 32) * 32 : 1024;
  }
  bump_scan_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (double*)out, (const int*)locs, (const double*)heights, n, h, w, spread,
      (const double*)k);
  return (int)cudaGetLastError();
}
