// stream_copy_kernel, stream_add_kernel: device-memory stream probes of
// float32, y = x (1 read + 1 write) and z = x + y (2 reads + 1 write).
//
// Replace the TPU probes tools/measure_stream.py::pallas_copy and
// pallas_add, which measured the stream rate a TPU kernel can reach, so
// that kernels are judged against a measured roof and not only the
// nominal one.  The TPU kernels tiled the raster into (th, tw) VMEM blocks;
// here the buffer is flat: a grid-stride loop over 16-byte float4 loads
// and stores when every pointer is 16-byte aligned, then a scalar tail (or
// scalars throughout when a pointer is not aligned).
//
// Bound on this card: device memory traffic alone (no arithmetic beyond
// one add a value).  The grid is a few blocks per SM, each thread keeping
// one float4 load in flight per operand per iteration.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void stream_copy_kernel(const float* __restrict__ x,
                                   float* __restrict__ y, long long n,
                                   long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (long long i = tid; i < n4; i += stride) y4[i] = x4[i];
  for (long long i = 4 * n4 + tid; i < n; i += stride) y[i] = x[i];
}

__global__ void stream_add_kernel(const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  float* __restrict__ z, long long n,
                                  long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* z4 = reinterpret_cast<float4*>(z);
  for (long long i = tid; i < n4; i += stride) {
    const float4 a = x4[i], b = y4[i];
    z4[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) z[i] = x[i] + y[i];
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Blocks of the grid-stride loop: a few per SM, fewer for a small buffer.
unsigned grid_for(long long items) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (items + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  return (unsigned)(need < most ? (need > 0 ? need : 1) : most);
}

}  // namespace

extern "C" {

// y[i] = x[i] for i < n, on `stream`.  Returns cudaGetLastError() after
// the launch.
int stream_copy_launch(const float* x, float* y, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long n4 = aligned16(x) && aligned16(y) ? n / 4 : 0;
  stream_copy_kernel<<<grid_for(n4 > 0 ? n4 : n), kThreads, 0,
                       (cudaStream_t)stream>>>(x, y, n, n4);
  return (int)cudaGetLastError();
}

// z[i] = x[i] + y[i] for i < n, on `stream`.  Returns cudaGetLastError()
// after the launch.
int stream_add_launch(const float* x, const float* y, float* z, long long n,
                      void* stream) {
  if (n <= 0) return 0;
  const long long n4 =
      aligned16(x) && aligned16(y) && aligned16(z) ? n / 4 : 0;
  stream_add_kernel<<<grid_for(n4 > 0 ? n4 : n), kThreads, 0,
                      (cudaStream_t)stream>>>(x, y, z, n, n4);
  return (int)cudaGetLastError();
}

}  // extern "C"
