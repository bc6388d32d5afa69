// stream_copy_kernel, stream_add_kernel: device-memory stream probes of
// float32, y = x (1 read + 1 write) and z = x + y (2 reads + 1 write).
//
// Replace the TPU probes tools/measure_stream.py::pallas_copy and
// pallas_add, which measured the stream rate a TPU kernel can reach, so
// that kernels are judged against a measured roof and not only the
// nominal one.  Bound on this card: device memory traffic alone (no
// arithmetic beyond one add a value).
//
// stream_copy_kernel is redesigned for Hopper after the TPU probe's own
// design, whose DMA moves blocks through VMEM.  A grid-stride loop of one
// float4 load and store a thread has no load in flight ahead of its
// store; here a persistent grid of one block an SM moves the buffer's
// 16-byte-aligned body in 32 KB chunks (chunk blockIdx.x + k * gridDim.x)
// through a 4-stage ring in shared memory, with bulk copies that one
// thread starts:
// cp.async.bulk loads completing on one mbarrier a stage, cp.async.bulk
// stores in bulk groups; a stage is loaded again once the store that read
// it has finished reading (wait_group.read).  Three chunks are in flight
// into shared memory while one goes out, about 128 KB an SM, far above
// what Little's law asks of 3.35 TB/s.  The other lanes copy the scalar
// head and tail (kernels/stream.py::copy_plan: fewer than 4 values each).
// Where x and y differ in alignment mod 16 the whole copy is scalar, a
// grid-stride loop of many blocks.
//
// stream_add_kernel is redesigned too: a one-shot grid of one block a
// 16 KB piece of x and of y, each thread loading its four float4 pairs
// before it adds and stores any (streaming loads and stores, __ldcs/
// __stcs).  In an A/B on the card, the copy's ring with two bulk loads a
// stage, the same ring at more blocks an SM, and a one-wave grid-stride
// form with four pairs in flight a thread each came out 3-6% slower
// (PERF.md §6).  The scalar head and tail and the all-scalar case
// follow the copy's rule for all three pointers (kernels/stream.py::
// add_plan).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kChunkBytes = 32 * 1024;
constexpr int kStages = 4;
constexpr int kBulkThreads = 32;    // lane 0 drives the ring
constexpr int kBarrierBytes = 128;  // the stages' mbarriers
constexpr int kAlignSlack = 128;    // room to align the barriers to 128
constexpr int kBulkSmem =
    kAlignSlack + kBarrierBytes + kStages * kChunkBytes;

// y[i] = x[i] for the `head` values before the body and those after it,
// then (thread 0 of each block) the body's chunks through the ring.
__global__ void stream_copy_kernel(const float* __restrict__ x,
                                   float* __restrict__ y, long long n,
                                   long long head, long long body) {
  const long long after = head + body, scalars = n - body;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < scalars; e += stride) {
    const long long i = e < head ? e : after + (e - head);
    y[i] = x[i];
  }
  if (body == 0 || threadIdx.x != 0) return;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = xrt::smem_addr(smem_raw);
  const uint32_t bars = (raw + 127u) & ~127u;
  const uint32_t ring = bars + kBarrierBytes;
  const char* const src = reinterpret_cast<const char*>(x + head);
  char* const dst = reinterpret_cast<char*>(y + head);
  const long long bytes = body * 4;
  const long long chunks = (bytes + kChunkBytes - 1) / kChunkBytes;
  const long long step = gridDim.x;
  const long long mine =
      blockIdx.x < chunks ? (chunks - blockIdx.x + step - 1) / step : 0;
  auto offset = [&](long long k) {
    return (blockIdx.x + k * step) * (long long)kChunkBytes;
  };
  auto size = [&](long long k) {
    const long long left = bytes - offset(k);
    return (uint32_t)(left < kChunkBytes ? left : kChunkBytes);
  };
  auto load = [&](long long k) {
    const uint32_t s = (uint32_t)(k % kStages), bar = bars + 8 * s;
    xrt::mbar_expect_tx(bar, size(k));
    xrt::bulk_load(ring + s * kChunkBytes, src + offset(k), size(k), bar);
  };

  for (int s = 0; s < kStages; ++s) xrt::mbar_init(bars + 8 * s, 1);
  xrt::mbar_fence_init();
  for (long long k = 0; k < kStages && k < mine; ++k) load(k);
  for (long long k = 0; k < mine; ++k) {
    const uint32_t s = (uint32_t)(k % kStages);
    xrt::mbar_wait(bars + 8 * s, (uint32_t)((k / kStages) & 1));
    xrt::fence_proxy_async();
    xrt::bulk_store(dst + offset(k), ring + s * kChunkBytes, size(k));
    xrt::bulk_commit();
    // the store of chunk k - 1 has read its stage: load chunk k - 1 +
    // kStages there
    if (k >= 1 && k - 1 + kStages < mine) {
      xrt::bulk_wait_read<1>();
      load(k - 1 + kStages);
    }
  }
  xrt::bulk_wait_all();
}

constexpr int kAddPairs = 4;  // float4 pairs in flight a thread

// z[i] = x[i] + y[i] for the `head` values before the body and those
// after it (a grid-stride loop), then the body as 16-byte groups: block b
// adds groups b * kThreads * kAddPairs + u * kThreads + threadIdx.x, u <
// kAddPairs, all of them loaded before any is stored, with streaming loads
// and stores (__ldcs/__stcs).
__global__ void stream_add_kernel(const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  float* __restrict__ z, long long n,
                                  long long head, long long body) {
  const long long after = head + body, scalars = n - body;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < scalars; e += stride) {
    const long long i = e < head ? e : after + (e - head);
    z[i] = x[i] + y[i];
  }
  const float4* const x4 = reinterpret_cast<const float4*>(x + head);
  const float4* const y4 = reinterpret_cast<const float4*>(y + head);
  float4* const z4 = reinterpret_cast<float4*>(z + head);
  const long long n4 = body / 4;
  const long long base =
      (long long)blockIdx.x * kThreads * kAddPairs + threadIdx.x;
  float4 a[kAddPairs], b[kAddPairs];
#pragma unroll
  for (int u = 0; u < kAddPairs; ++u) {
    const long long i = base + u * kThreads;
    if (i < n4) {
      a[u] = __ldcs(x4 + i);
      b[u] = __ldcs(y4 + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kAddPairs; ++u) {
    const long long i = base + u * kThreads;
    if (i >= n4) continue;
    __stcs(z4 + i, make_float4(a[u].x + b[u].x, a[u].y + b[u].y,
                               a[u].z + b[u].z, a[u].w + b[u].w));
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Blocks of the grid-stride loop: a few per SM, fewer for a small buffer.
unsigned grid_for(long long items) {
  const long long need = (items + kThreads - 1) / kThreads;
  const long long most = (long long)sm_count() * kBlocksPerSm;
  return (unsigned)(need < most ? (need > 0 ? need : 1) : most);
}

// The split rule of kernels/stream.py::copy_plan and add_plan: with every
// pointer 4-byte aligned and all alike mod 16, `head` scalars up to x's
// next 16-byte boundary, a body of whole 16-byte groups, the rest a
// scalar tail; otherwise every value is scalar (head = body = 0).
bool plan_matches(const float* x, const float* y, const float* z,
                  long long n, long long head, long long body) {
  const uintptr_t ax = (uintptr_t)x & 15;
  if (ax != ((uintptr_t)y & 15) || ax != ((uintptr_t)z & 15) || ax % 4 != 0)
    return head == 0 && body == 0;
  long long want = (long long)((16 - ax) % 16 / 4);
  if (want > n) want = n;
  return head == want && body == (n - want) / 4 * 4;
}

// The one-shot grid of stream_add_kernel for `body` values, or the
// grid-stride loop's for n scalars when there is no body.
unsigned add_grid(long long n, long long body) {
  if (body == 0) return grid_for(n);
  const long long per_block = 4LL * kThreads * kAddPairs;
  return (unsigned)((body + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// y[i] = x[i] for i < n, on `stream`, split as copy_plan(n, x, y) says:
// the scalar head, the bulk body, the scalar tail.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// split that is not the rule's.
int stream_copy_launch(const float* x, float* y, long long n, long long head,
                       long long body, void* stream) {
  if (n <= 0) return 0;
  if (!plan_matches(x, y, y, n, head, body))
    return (int)cudaErrorInvalidValue;
  if (body == 0) {
    stream_copy_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        x, y, n, head, body);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = cudaFuncSetAttribute(
      stream_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBulkSmem);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (body * 4 + kChunkBytes - 1) / kChunkBytes;
  const long long sms = sm_count();
  stream_copy_kernel<<<(unsigned)(chunks < sms ? chunks : sms), kBulkThreads,
                       kBulkSmem, (cudaStream_t)stream>>>(x, y, n, head,
                                                          body);
  return (int)cudaGetLastError();
}

// z[i] = x[i] + y[i] for i < n, on `stream`, split as add_plan(n, x, y,
// z) says: the scalar head, the bulk body, the scalar tail.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// split that is not the rule's.
int stream_add_launch(const float* x, const float* y, float* z, long long n,
                      long long head, long long body, void* stream) {
  if (n <= 0) return 0;
  if (!plan_matches(x, y, z, n, head, body))
    return (int)cudaErrorInvalidValue;
  stream_add_kernel<<<add_grid(n, body), kThreads, 0,
                      (cudaStream_t)stream>>>(x, y, z, n, head, body);
  return (int)cudaGetLastError();
}

}  // extern "C"
