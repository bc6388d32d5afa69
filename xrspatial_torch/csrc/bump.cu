// The bump map's sequential accumulation (X2), in two kernels:
// bump_rounds_kernel, rounds of bumps whose footprints do not overlap
// across the card, then the walk of what is left; and bump_scan_kernel,
// the first port, one block walking every bump in order.
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
// centre as the earlier ones left it.  A bump's footprint is its centre
// and those ring cells; two bumps conflict if their footprints share a
// cell.
//
// Bound on this card: the dependent chain.  The first port walks it on
// one SM of 132, a device-memory round trip and two barriers a bump
// (about 0.9 us).  The rounds cut the chain: every cell gets its
// additions in bump order exactly when no bump runs before an earlier one
// it conflicts with, so a bump that holds the smallest index among the
// bumps not yet done on every cell of its footprint is ready, the ready
// bumps of a round are pairwise disjoint, and each runs alone in one
// thread, with no atomics on the map.  A round: (1) claim, each remaining
// bump writes (round << 32 | ~index) into a 64-bit owner map over its
// footprint with atomicMax, so the smallest index of this round wins and
// entries of earlier rounds lose without a clearing pass; (2) test and
// apply, each block over its contiguous part of the ordered list of
// remaining bumps, keeping the unready ones in order; (3) pack the
// blocks' parts into the next ordered list.  The done set stays closed
// under "earlier and conflicting", so once a round makes fewer than
// `threshold` bumps ready (kernels/bump.py::rounds_threshold) block 0
// walks the rest in index order, as the first port does.  One cooperative
// launch: grid-wide barriers between the parts, nothing back on the host
// until the map is done; the rounds, the bumps done in them and the
// bumps the walk took are left in `stats`.  Data another block wrote are
// read with __ldcg (L2), never from a stale line of this SM's L1.
//
// Bits: every product and sum is rounded apart (__dmul_rn, __dadd_rn), so
// nvcc contracts nothing into an FMA and both kernels equal their twin,
// and the JAX package's float64 scan, bit for bit; a non-finite centre
// makes its (0, 0) term centre * 0 NaN, as there.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRoundThreads = 256;

__device__ __forceinline__ bool in_ring(int o, int side, int spread, int cx,
                                        int cy, int h, int w, int* cell) {
  const int oy = o / side - spread;
  const int ox = o % side - spread;
  const int ny = cy + oy;
  const int nx = cx + ox;
  *cell = ny * w + nx;
  return ox * ox + oy * oy <= spread * spread && ny >= 0 && ny < h &&
         nx >= 0 && nx < w;
}

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

__device__ __forceinline__ unsigned long long owner_key(unsigned round,
                                                        int i) {
  return ((unsigned long long)round << 32) | (unsigned)~i;
}

// The block's exclusive prefix of `flag` and, in *total, its sum; every
// thread of the block calls it.
__device__ int block_rank(bool flag, int* total) {
  __shared__ int warp_sum[kRoundThreads / 32];
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, sum = 0;
  for (int i = 0; i < kRoundThreads / 32; ++i) {
    before += i < warp ? warp_sum[i] : 0;
    sum += warp_sum[i];
  }
  __syncthreads();                 // warp_sum is reused by the next call
  *total = sum;
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// The sum over the grid's blocks of counts[b] for b < blockIdx.x, and in
// *total over every block.
__device__ int block_offset(const int* counts, int* total) {
  __shared__ int part[2][kRoundThreads];
  int before = 0, sum = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
    const int c = __ldcg(counts + b);
    sum += c;
    before += b < (int)blockIdx.x ? c : 0;
  }
  part[0][threadIdx.x] = before;
  part[1][threadIdx.x] = sum;
  __syncthreads();
  for (int s = kRoundThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) {
      part[0][threadIdx.x] += part[0][threadIdx.x + s];
      part[1][threadIdx.x] += part[1][threadIdx.x + s];
    }
    __syncthreads();
  }
  before = part[0][0];
  *total = part[1][0];
  __syncthreads();
  return before;
}

__global__ void __launch_bounds__(kRoundThreads)
    bump_rounds_kernel(double* __restrict__ out,
                       unsigned long long* __restrict__ owner,
                       int* __restrict__ list, int* __restrict__ kept,
                       int* __restrict__ counts, long long* __restrict__ stats,
                       const int* __restrict__ locs,
                       const double* __restrict__ heights, int n, int h,
                       int w, int spread, const double* __restrict__ k,
                       int threshold) {
  __shared__ double centre;
  cg::grid_group grid = cg::this_grid();
  const int side = 2 * spread;
  const int n_off = spread > 0 ? side * side : 1;
  const size_t cells = (size_t)h * w;
  for (size_t c = grid.thread_rank(); c < cells; c += grid.size())
    owner[c] = 0;
  for (int j = grid.thread_rank(); j < n; j += grid.size()) list[j] = j;
  grid.sync();

  // every block takes the same branches: `remaining` and `ready` come from
  // the counts all blocks read after the same barrier
  int remaining = n, ready = n;
  unsigned round = 0;
  long long round_bumps = 0;
  while (remaining > 0 && ready >= threshold) {
    ++round;
    // (1) claim
    for (int j = grid.thread_rank(); j < remaining; j += grid.size()) {
      const int i = __ldcg(list + j);
      const int cx = __ldg(locs + 2 * i), cy = __ldg(locs + 2 * i + 1);
      const unsigned long long key = owner_key(round, i);
      for (int o = 0; o < n_off; ++o) {
        int cell = cy * w + cx;
        if (spread == 0 || in_ring(o, side, spread, cx, cy, h, w, &cell))
          atomicMax(owner + cell, key);
      }
    }
    grid.sync();
    // (2) test and apply this block's part of the list, keeping the rest
    // in order in the same part of `kept`
    const int part = (remaining + gridDim.x - 1) / gridDim.x;
    const int lo = min((int)blockIdx.x * part, remaining);
    const int hi = min(lo + part, remaining);
    int n_kept = 0;
    for (int base = lo; base < hi; base += blockDim.x) {
      const int j = base + threadIdx.x;
      bool keep = false;
      int i = 0;
      if (j < hi) {
        i = __ldcg(list + j);
        const int cx = __ldg(locs + 2 * i), cy = __ldg(locs + 2 * i + 1);
        const unsigned long long key = owner_key(round, i);
        bool mine = true;
        for (int o = 0; o < n_off && mine; ++o) {
          int cell = cy * w + cx;
          if (spread == 0 || in_ring(o, side, spread, cx, cy, h, w, &cell))
            mine = __ldcg(owner + cell) == key;
        }
        keep = !mine;
        if (mine) {                // alone on its footprint this round
          double* c = out + (size_t)cy * w + cx;
          const double v = __dadd_rn(__ldcg(c), __ldg(heights + i));
          *c = v;
          if (spread > 0) {
            for (int o = 0; o < n_off; ++o) {
              int cell;
              if (in_ring(o, side, spread, cx, cy, h, w, &cell)) {
                double* p = out + cell;
                *p = __dadd_rn(__ldcg(p), __dmul_rn(v, __ldg(k + o)));
              }
            }
          }
        }
      }
      int total;
      const int rank = block_rank(keep, &total);
      if (keep) kept[lo + n_kept + rank] = i;
      n_kept += total;
    }
    if (threadIdx.x == 0) counts[blockIdx.x] = n_kept;
    grid.sync();
    // (3) pack the parts, in block order, into the next list
    int left;
    const int at = block_offset(counts, &left);
    for (int j = threadIdx.x; j < n_kept; j += blockDim.x)
      list[at + j] = __ldcg(kept + lo + j);
    ready = remaining - left;
    round_bumps += ready;
    remaining = left;
    grid.sync();
  }

  // the rest of the bumps, in index order, walked by one block
  if (blockIdx.x != 0) return;
  for (int j = 0; j < remaining; ++j) {
    const int i = __ldcg(list + j);
    const int cx = __ldg(locs + 2 * i), cy = __ldg(locs + 2 * i + 1);
    if (threadIdx.x == 0) {
      double* c = out + (size_t)cy * w + cx;
      const double v = __dadd_rn(__ldcg(c), __ldg(heights + i));
      *c = v;
      centre = v;
    }
    if (spread == 0) continue;
    __syncthreads();
    const double cv = centre;
    for (int o = threadIdx.x; o < n_off; o += blockDim.x) {
      int cell;
      if (in_ring(o, side, spread, cx, cy, h, w, &cell)) {
        double* p = out + cell;
        *p = __dadd_rn(__ldcg(p), __dmul_rn(cv, __ldg(k + o)));
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    stats[0] = round;
    stats[1] = round_bumps;
    stats[2] = remaining;
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

// The grid bump_rounds_launch takes on the current device: as many blocks
// of 256 threads as are resident at once, at most one per 256 bumps (at
// least one); 0 if the device cannot say.
extern "C" int bump_rounds_grid(int n) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) !=
          cudaSuccess ||
      !coop ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bump_rounds_kernel, kRoundThreads, 0) != cudaSuccess)
    return 0;
  const int want = (n + kRoundThreads - 1) / kRoundThreads;
  const int most = sms * per_sm;
  return want < 1 ? 1 : (want < most ? want : most);
}

// The rounds, then the walk of the rest: out as above; owner (h * w)
// 64-bit words, cleared by the kernel; list and kept (n,) int32 each;
// counts (grid,) int32; stats (3,) int64 receives the rounds, the bumps
// done in them and the bumps the walk took; grid from bump_rounds_grid.
// n < 2^31.  Returns the launch's CUDA error code.
extern "C" int bump_rounds_launch(void* out, void* owner, void* list,
                                  void* kept, void* counts, void* stats,
                                  const void* locs, const void* heights,
                                  int n, int h, int w, int spread,
                                  const void* k, int threshold, int grid,
                                  void* stream) {
  if (grid < 1 || n < 0 || threshold < 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&out, &owner, &list, &kept, &counts, &stats, &locs,
                  &heights, &n, &h, &w, &spread, &k, &threshold};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)bump_rounds_kernel, dim3(grid), dim3(kRoundThreads), args,
      0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
