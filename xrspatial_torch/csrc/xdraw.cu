// The XDraw viewshed's running max slope along each cell's ray, all four
// half-plane scans in one launch: xdraw_banded_kernel, the half-planes
// cut into bands of lanes across the SMs (on one card the whole raster in
// one launch, on a mesh a strip of lanes and a window of steps a launch),
// and xdraw_scan_kernel, the first port, one block a half-plane.
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
// columns, south and north the rows.  A lane thus reads only itself and
// its neighbour toward the viewpoint's lane, which reads only itself.
//
// Bound on this card: the dependence from one step to the next, a
// shared-memory round trip and a barrier a step, ~16,300 steps at 16384^2.
// The first port runs it on 4 SMs, 1024 threads x N/1024 lanes each.  The
// banded kernel spreads the lanes: 4 half-planes x bands of B lanes, one
// block a band, one lane a thread, walking K steps a chunk (the plan,
// kernels/viewshed.py::xdraw_plan).  A band away from the viewpoint's lane
// also recomputes the K lanes on its side toward the viewpoint (a halo cut
// at the viewpoint's lane): the values that enter its own lanes within K
// steps come from no further, so its own lanes stay exact while the
// halo's inner edge decays.  At the end of a chunk each band writes its
// lanes' carry to a global slot of that chunk (every chunk keeps its own,
// so no producer waits for a consumer), fences and raises its progress
// flag; at the start of a chunk a band waits for the flags of the bands
// that own its halo and reads their carries from L2.  Bands only wait on
// bands nearer the viewpoint, and the cone reaches a band B lanes out B
// steps later, so the one-chunk lag hides behind it; the launch is
// cooperative so that every band that waits is resident.  Each chunk's
// K x (B + K) slope tile is staged in shared memory by cp.async while the
// chunk before it runs, straight from `slope` (no transpose), and the
// chunk's results, written over the tile, leave as coalesced rows.  Only
// the cone |minor| <= dxf is read, computed and written, and a band
// starts at the chunk where its first lane enters the cone.  Each cell is
// written by its own octant's scan (kernels/viewshed.py::
// _xdraw_octant_masks: east and west own |dy| <= |dx|, diagonals
// included, east the viewpoint too; south and north the rest).
//
// Bits: every product, sum, difference and the division is rounded apart
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc contracts nothing
// into an FMA and both kernels equal their torch twin bit for bit; max
// propagates NaN, as torch.maximum does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

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


// -- the banded kernel --------------------------------------------------------

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// One half-plane's geometry: steps along the major axis, lanes along the
// minor one, the viewpoint's step offset vpm (dxf = k - vpm) and lane.
struct HalfPlane {
  bool x_major, reverse;
  int steps, lanes, last, vp_lane, vpm_i, k0;
  float vpm, vp_minor;
};

__device__ HalfPlane half_plane(int hp, int h, int w, int vp_row,
                                int vp_col) {
  HalfPlane g;
  g.x_major = hp < 2;
  g.reverse = hp & 1;
  g.steps = g.x_major ? w : h;
  g.lanes = g.x_major ? h : w;
  g.last = g.steps - 1;
  const int vp_major = g.x_major ? vp_col : vp_row;
  g.vp_lane = g.x_major ? vp_row : vp_col;
  g.vpm_i = g.reverse ? g.last - vp_major : vp_major;
  g.vpm = g.reverse ? __fsub_rn((float)g.last, (float)vp_major)
                    : (float)vp_major;
  g.vp_minor = (float)g.vp_lane;
  g.k0 = g.vpm_i + 1;                         // dxf = 1
  return g;
}

// Copies or writes the cone's cells of chunk c (steps s .. s + ns) over
// lanes [lo, hi) of the window [wlo, ...) between `tile` ([ns][wmax], lane
// p at column p) and the raster (`src` or `dst`), coalesced along the
// raster's rows; a write from south and north skips the cells on the
// diagonals, which east and west own.  The raster holds lane L, line t at
// (L - buf_lo) * pitch + t (east and west) or t * pitch + (L - buf_lo)
// (south and north): the whole raster (buf_lo 0, pitch w) or a strip.
template <bool kLoad>
__device__ __forceinline__ void move_tile(const HalfPlane& g, float* tile,
                                          const float* src, float* dst,
                                          int pitch, int buf_lo, int s,
                                          int ns, int lo, int hi, int wlo,
                                          int wmax) {
  // element e = q * inner + r, r the index along the raster's rows (a
  // lane's steps for east and west, a step's lanes for south and north);
  // q and r advance by the block's width, no division in the loop
  const int inner = g.x_major ? ns : hi - lo;
  const int total = ns * (hi - lo);
  if (total <= 0) return;
  const int dq = blockDim.x / inner, dr = blockDim.x % inner;
  int q = threadIdx.x / inner, r = threadIdx.x % inner;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int kk = g.x_major ? r : q;
    const int lane = lo + (g.x_major ? q : r);
    const int k = s + kk;
    const int dx = k - g.vpm_i;
    const int ady = abs(lane - g.vp_lane);
    if (ady <= dx && (kLoad || g.x_major || ady != dx)) {
      const int line = g.reverse ? g.last - k : k;
      const size_t at = g.x_major ? (size_t)(lane - buf_lo) * pitch + line
                                  : (size_t)line * pitch + (lane - buf_lo);
      float* cell = tile + kk * wmax + (lane - wlo);
      if (kLoad)
        xrt::cp_async_4(xrt::smem_addr(cell), src + at);
      else
        dst[at] = *cell;
    }
    r += dr;
    q += dq;
    if (r >= inner) {
      r -= inner;
      ++q;
    }
  }
}

// -- the banded kernel: bands of lanes over a window of lanes and steps ------
//
// Block: half-plane hp (0 east, 1 west, 2 south, 3 north), band b of the
// window's lanes [buf_lo + b * band, buf_lo + (b + 1) * band).  Shared
// memory: the carry, double-buffered, lane p of the band's window at
// [p + 1] with -inf at both ends, then two K x (band + K) tiles.  The
// slots hold n_slots x (the window's lanes) floats a half-plane, the carry
// of lane L after chunk c - 1 at [c * lanes + L - buf_lo]; progress one int
// a block, raised to pbase + c once that slot is written.
//
// One launch runs the steps [s0, s0 + steps) of the lanes [buf_lo,
// lane_hi) of the four half-planes, starting from a carry-in row of those
// lanes (-inf where none is given) and writing a carry-out row (where one
// is given).  On one card (xdraw_banded_launch) the window is the whole
// raster and all its steps.  On a mesh (kernels/viewshed.py::
// xdraw_mesh_max_slope) the four half-plane scans run on strips of lanes,
// one strip a device: east and west on a strip of rows, south and north on
// a strip of columns, each extended by L halo lanes toward the viewpoint's
// lane (cut at it), one launch a window of L steps (xdraw_strip_launch).
// The argument of the bands' K-lane halo holds at the strip's scale: with L
// halo lanes the owned lanes are exact after L steps, and the host copies
// the owned carries at each strip's edge into the halo of the strip beside
// it between two launches.

// One orientation of a strip: its slope lanes and scan field (lane L, line
// t at (L - buf_lo) * pitch + t for a strip of rows, t * pitch + (L -
// buf_lo) for one of columns), the carries before and after the window
// (two rows of buf_lanes floats: forward, reverse; lane L at L - buf_lo;
// null: -inf before, none kept after) and the window's lanes [buf_lo,
// lane_hi).
struct StripSide {
  const float* src;
  float* out;
  const float* carry_in;
  float* carry_out;
  long long pitch;
  int buf_lo, lane_hi, buf_lanes;
};

struct StripArgs {
  StripSide side[2];          // 0: rows (east, west), 1: columns (south, north)
  float* slots;               // the four half-planes' chunk-end slots
  int* progress;              // one int a block, raised to pbase + c + 1
  int h, w, vp_row, vp_col, band, chunk, s0, steps, n_slots, pbase;
  int bases[5];               // the first block of each half-plane
};

// The chunk of the window [s_lo, s_hi) in which band [b0, b1)'s lane
// nearest the viewpoint's enters the cone (0 if it entered before the
// window); n_chunks if it does not enter within it.  Before it every lane
// of the band is -inf, or its carry-in.
__device__ __forceinline__ int first_chunk(const HalfPlane& g, int b0,
                                           int b1, int s_lo, int s_hi,
                                           int chunk, int n_chunks) {
  const int near = b0 > g.vp_lane ? b0 - g.vp_lane
                                  : (b1 <= g.vp_lane ? g.vp_lane - (b1 - 1)
                                                     : 0);
  const int k = g.vpm_i + max(near, 1);
  if (k >= s_hi) return n_chunks;
  return k < s_lo ? 0 : (k - s_lo) / chunk;
}

__global__ void __launch_bounds__(kMaxThreads)
    xdraw_banded_kernel(const StripArgs a) {
  extern __shared__ float smem[];
  const float neginf = -INFINITY;
  int hp = 0;
  while ((int)blockIdx.x >= a.bases[hp + 1]) ++hp;
  const int base = a.bases[hp];
  const int b = blockIdx.x - base;
  const StripSide& sd = a.side[hp >> 1];
  const int band = a.band, chunk = a.chunk;
  const HalfPlane g = half_plane(hp, a.h, a.w, a.vp_row, a.vp_col);
  const int lo = sd.buf_lo, hi = sd.lane_hi, win_all = hi - lo;
  const int nb = (win_all + band - 1) / band;
  const int vpb = g.vp_lane < lo ? -1
                  : (g.vp_lane >= hi ? nb : (g.vp_lane - lo) / band);
  const int b0 = lo + b * band;
  const int b1 = min(b0 + band, hi);
  int wlo = b0, whi = b1;                       // the window: band + halo
  if (b > vpb) wlo = max(b0 - chunk, max(g.vp_lane, lo));
  if (b < vpb) whi = min(b1 + chunk, min(g.vp_lane + 1, hi));
  const int win = whi - wlo;
  const int hlo = b > vpb ? wlo : b1;           // the halo [hlo, hhi)
  const int hhi = b > vpb ? b0 : whi;
  const int wmax = band + chunk;
  // this launch's steps
  const int s_lo = max(a.s0, g.k0);
  const int s_hi = min(a.s0 + a.steps, g.steps);
  const int n_chunks = s_hi > s_lo ? (s_hi - s_lo + chunk - 1) / chunk : 0;
  float* cur = smem;
  float* nxt = smem + (wmax + 2);
  float* const tiles = smem + 2 * (wmax + 2);
  // the slots of half-plane hp: east's, west's, south's, north's in turn
  size_t slot_base = 0;
  for (int q = 0; q < hp; ++q) {
    const StripSide& o = a.side[q >> 1];
    slot_base += (size_t)a.n_slots * (o.lane_hi - o.buf_lo);
  }
  float* const slots = a.slots + slot_base;
  const float* const c_in =
      sd.carry_in ? sd.carry_in + (size_t)(hp & 1) * sd.buf_lanes : nullptr;
  float* const c_out =
      sd.carry_out ? sd.carry_out + (size_t)(hp & 1) * sd.buf_lanes : nullptr;

  for (int p = threadIdx.x; p < wmax + 2; p += blockDim.x)
    cur[p] = nxt[p] = neginf;
  if (hp == 0 && b == vpb && threadIdx.x == 0 && a.s0 <= g.vpm_i &&
      g.vpm_i < a.s0 + a.steps)                 // the viewpoint: east's
    sd.out[(size_t)(a.vp_row - lo) * sd.pitch + a.vp_col] = neginf;
  const int c_first =
      first_chunk(g, b0, b1, s_lo, s_hi, chunk, n_chunks);
  if (c_first >= n_chunks) return;              // not in the cone yet
  __syncthreads();
  if (c_first == 0 && c_in)                     // the window from the carry
    for (int p = threadIdx.x; p < win; p += blockDim.x)
      cur[p + 1] = c_in[wlo + p - lo];

  move_tile<true>(g, tiles + (c_first & 1) * chunk * wmax, sd.src, nullptr,
                  (int)sd.pitch, lo, s_lo + c_first * chunk,
                  min(chunk, s_hi - s_lo - c_first * chunk), wlo, whi, wlo,
                  wmax);
  xrt::cp_async_commit();
  for (int c = c_first; c < n_chunks; ++c) {
    const int s = s_lo + c * chunk;
    const int ns = min(chunk, s_hi - s);
    float* const tile = tiles + (c & 1) * chunk * wmax;
    if (c + 1 < n_chunks)                       // the next chunk's slopes
      move_tile<true>(g, tiles + ((c + 1) & 1) * chunk * wmax, sd.src,
                      nullptr, (int)sd.pitch, lo, s + chunk,
                      min(chunk, s_hi - s - chunk), wlo, whi, wlo, wmax);
    xrt::cp_async_commit();

    // the halo at the chunk's start: from the carry-in at the window's
    // first chunk, else from the slots of the bands that own it
    if (hlo < hhi && c > 0) {
      if (threadIdx.x == 0) {
        for (int o = (hlo - lo) / band; o <= (hhi - 1 - lo) / band; ++o) {
          const int o0 = lo + o * band;
          if (c - 1 < first_chunk(g, o0, min(o0 + band, hi), s_lo,
                                         s_hi, chunk, n_chunks))
            continue;
          while (ld_acquire(a.progress + base + o) < a.pbase + c)
            __nanosleep(20);
        }
      }
      __syncthreads();
      for (int L = hlo + threadIdx.x; L < hhi; L += blockDim.x) {
        const int o0 = lo + (L - lo) / band * band;
        cur[L - wlo + 1] =
            c - 1 < first_chunk(g, o0, min(o0 + band, hi), s_lo, s_hi,
                                       chunk, n_chunks)
                ? neginf
                : __ldcg(slots + (size_t)c * win_all + (L - lo));
      }
    }
    xrt::cp_async_wait(1);
    __syncthreads();

    for (int kk = 0; kk < ns; ++kk) {
      const float dxf = __fsub_rn((float)(s + kk), g.vpm);   // >= 1
      const float wden = fmaxf(dxf, 1.0f);
      float* const row = tile + kk * wmax;
      for (int p = threadIdx.x; p < win; p += blockDim.x) {
        const float minor = __fsub_rn((float)(wlo + p), g.vp_minor);
        const float ady = fabsf(minor);
        if (!(ady <= dxf)) continue;    // outside the cone: -inf, unwritten
        const float prim = cur[p + 1];
        float sec = prim;
        if (minor > 0.0f) sec = cur[p];
        if (minor < 0.0f) sec = cur[p + 2];
        const float wsec = ady > 0.0f ? __fdiv_rn(ady, wden) : 0.0f;
        const float interp =
            isfinite(prim) && isfinite(sec)
                ? __fadd_rn(__fmul_rn(prim, __fsub_rn(1.0f, wsec)),
                            __fmul_rn(sec, wsec))
                : nan_max(prim, sec);
        const float blocked = dxf == 1.0f ? neginf : interp;
        const float m = nan_max(blocked, row[p]);
        nxt[p + 1] = m;
        row[p] = m;
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }

    // publish this band's lanes after the chunk, then raise its flag
    for (int L = b0 + threadIdx.x; L < b1; L += blockDim.x)
      slots[(size_t)(c + 1) * win_all + (L - lo)] = cur[L - wlo + 1];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) st_release(a.progress + base + b, a.pbase + c + 1);
    move_tile<false>(g, tile, nullptr, sd.out, (int)sd.pitch, lo, s, ns,
                     b0, b1, wlo, wmax);
    __syncthreads();                            // the tile is reloaded next
  }
  // the carry after the window, for the next launch
  if (c_out)
    for (int L = b0 + threadIdx.x; L < b1; L += blockDim.x)
      c_out[L - lo] = cur[L - wlo + 1];
}


// Dynamic shared memory of the banded kernel: the carry's two windows
// and two tiles.
int banded_smem(int band, int chunk) {
  const int wmax = band + chunk;
  return (int)sizeof(float) * (2 * (wmax + 2) + 2 * chunk * wmax);
}

// Launches the banded kernel on `a` (its blocks' bases filled in here)
// cooperatively: 4 half-planes x their bands, blocks of min(1024, band +
// chunk rounded up to 32) threads.
int launch_banded(StripArgs& a, cudaStream_t stream) {
  a.bases[0] = 0;
  for (int hp = 0; hp < 4; ++hp) {
    const StripSide& sd = a.side[hp >> 1];
    a.bases[hp + 1] =
        a.bases[hp] + (sd.lane_hi - sd.buf_lo + a.band - 1) / a.band;
  }
  const int blocks = a.bases[4];
  if (blocks == 0) return (int)cudaSuccess;
  const int wmax = a.band + a.chunk;
  const int threads = wmax < kMaxThreads ? (wmax + 31) / 32 * 32
                                         : kMaxThreads;
  const int smem = banded_smem(a.band, a.chunk);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      xdraw_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(xdraw_banded_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)xdraw_banded_kernel,
                                    dim3(blocks), dim3(threads), args,
                                    (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
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


// out (h, w) = the running max slope of slope (h, w) for the viewpoint
// (vp_row, vp_col), by the banded kernel in bands of `band` lanes and
// chunks of `chunk` steps, on `stream`: the whole raster one window of all
// its steps, from -inf, launched cooperatively.  carry: 4 * n_slots *
// max(h, w) floats, n_slots = ceil((max(h, w) - 1) / chunk) + 1; progress:
// one int a block, zeroed.  Returns the launch's CUDA error code,
// cudaErrorInvalidValue for arguments it does not take,
// cudaErrorCooperativeLaunchTooLarge if the blocks cannot all be resident.
int xdraw_banded_launch(const float* slope, float* out, int h, int w,
                        int vp_row, int vp_col, int band, int chunk,
                        int n_slots, float* carry, int* progress,
                        void* stream) {
  if (h <= 0 || w <= 0 || vp_row < 0 || vp_row >= h || vp_col < 0 ||
      vp_col >= w || band < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int n = h > w ? h : w;
  if (n_slots != (n - 1 + chunk - 1) / chunk + 1)
    return (int)cudaErrorInvalidValue;
  StripArgs a;
  a.side[0] = StripSide{slope, out, nullptr, nullptr, w, 0, h, h};
  a.side[1] = StripSide{slope, out, nullptr, nullptr, w, 0, w, w};
  a.slots = carry;
  a.progress = progress;
  a.h = h;
  a.w = w;
  a.vp_row = vp_row;
  a.vp_col = vp_col;
  a.band = band;
  a.chunk = chunk;
  a.s0 = 0;
  a.steps = n;
  a.n_slots = n_slots;
  a.pbase = 0;
  return launch_banded(a, (cudaStream_t)stream);
}

// One window of the strip route: steps [s0, s0 + steps) of one strip's
// four half-planes, the rows side (east, west) and the columns side
// (south, north) each given by its slope, field, carries (two rows of
// buf_lanes floats, forward then reverse), pitch and lanes [buf_lo,
// lane_hi) (a side with no lanes launches no block), in bands of `band`
// lanes and chunks of `chunk` steps, on `stream`, launched cooperatively.
// slots: n_slots * (lanes of each half-plane, summed) floats, n_slots =
// ceil(steps / chunk) + 1; progress: one int a block, every value below
// pbase + 1 (zeroed before the first window; pbase grows by n_slots a
// window).  Returns the launch's CUDA error code, cudaErrorInvalidValue
// for arguments it does not take, cudaErrorCooperativeLaunchTooLarge if
// the blocks cannot all be resident.
int xdraw_strip_launch(const float* r_src, float* r_out,
                       const float* r_carry_in, float* r_carry_out,
                       long long r_pitch, int r_buf_lo, int r_lane_hi,
                       int r_buf_lanes, const float* c_src, float* c_out,
                       const float* c_carry_in, float* c_carry_out,
                       long long c_pitch, int c_buf_lo, int c_lane_hi,
                       int c_buf_lanes, float* slots, int* progress, int h,
                       int w, int vp_row, int vp_col, int band, int chunk,
                       int s0, int steps, int n_slots, int pbase,
                       void* stream) {
  if (h <= 0 || w <= 0 || vp_row < 0 || vp_row >= h || vp_col < 0 ||
      vp_col >= w || band < 1 || chunk < 1 || steps < 1 || s0 < 0 ||
      n_slots != (steps + chunk - 1) / chunk + 1)
    return (int)cudaErrorInvalidValue;
  StripArgs a;
  a.side[0] = StripSide{r_src, r_out, r_carry_in, r_carry_out, r_pitch,
                        r_buf_lo, r_lane_hi, r_buf_lanes};
  a.side[1] = StripSide{c_src, c_out, c_carry_in, c_carry_out, c_pitch,
                        c_buf_lo, c_lane_hi, c_buf_lanes};
  for (int q = 0; q < 2; ++q) {
    const StripSide& sd = a.side[q];
    const int n = q == 0 ? h : w;
    if (sd.lane_hi < sd.buf_lo || sd.buf_lo < 0 || sd.lane_hi > n ||
        sd.lane_hi - sd.buf_lo > sd.buf_lanes ||
        (sd.lane_hi > sd.buf_lo && (!sd.src || !sd.out || !sd.carry_in ||
                                    !sd.carry_out)))
      return (int)cudaErrorInvalidValue;
  }
  a.slots = slots;
  a.progress = progress;
  a.h = h;
  a.w = w;
  a.vp_row = vp_row;
  a.vp_col = vp_col;
  a.band = band;
  a.chunk = chunk;
  a.s0 = s0;
  a.steps = steps;
  a.n_slots = n_slots;
  a.pbase = pbase;
  return launch_banded(a, (cudaStream_t)stream);
}

}  // extern "C"
