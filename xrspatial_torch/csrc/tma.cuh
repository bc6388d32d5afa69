// tma.cuh: Hopper's asynchronous copies, in inline PTX, for the kernels
// that stage their data through shared memory (stencil_probe.cu's staged
// form, stream.cu's bulk copy, focal_halo.cu, jfa.cu's staged route and
// jfa_group.cu).
//
// - mbarriers: a 64-bit barrier in shared memory that completes a phase
//   when its expected arrivals have arrived and its expected bytes have
//   landed; waiters test the phase's parity.
// - TMA 2D tiled loads (cp.async.bulk.tensor): one thread asks for a box of
//   a tensor map; the hardware fills out-of-bounds elements as the map
//   says and reports the bytes to an mbarrier.
// - bulk copies (cp.async.bulk): contiguous bytes, global to shared with
//   mbarrier completion, shared to global in bulk groups.
// - cp.async: 4-byte and 16-byte copies global to shared, in commit groups.
// - on the host, encode_tiled: cuTensorMapEncodeTiled without linking
//   libcuda; encode_raster_map (float32, NaN fill) and encode_word_map
//   (32-bit words, zero fill) on top of it.

#pragma once

#include <cuda.h>  // CUtensorMap (the header only: nothing links libcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace xrt {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime, so that the
// library links no libcuda.
inline cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The tensor map of a row-major h x w plane of 4-byte elements of `type`
// at p (16-byte aligned, w % 4 == 0) in boxes of box_cols x box_rows,
// with out-of-bounds cells filled as `fill` says; a failed encode returns
// the negated CUresult, a failed lookup its cudaError_t.
inline int encode_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                         const void* p, long long h, long long w,
                         int box_cols, int box_rows,
                         CUtensorMapFloatOOBfill fill) {
  EncodeTiled encode;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return (int)err;
  const cuuint64_t dims[2] = {(cuuint64_t)w, (cuuint64_t)h};
  const cuuint64_t pitch[1] = {(cuuint64_t)w * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, type, 2, (void*)p, dims, pitch, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, fill);
  return res == CUDA_SUCCESS ? 0 : -(int)res;
}

// The tensor map of a row-major h x w float32 raster at x (16-byte
// aligned, w % 4 == 0) in boxes of box_cols x box_rows, cells outside the
// raster read as NaN.
inline int encode_raster_map(CUtensorMap* map, const float* x, long long h,
                             long long w, int box_cols, int box_rows) {
  return encode_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, h, w,
                       box_cols, box_rows,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA);
}

// The tensor map of a row-major h x w plane of 32-bit words (an int32 or
// a float32 plane, copied as bits) at p, as encode_raster_map's; cells
// outside the plane read as 0, which the caller overwrites where 0 means
// something (a packed jump-flood target of row 0, column 0).
inline int encode_word_map(CUtensorMap* map, const void* p, long long h,
                           long long w, int box_cols, int box_rows) {
  return encode_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_INT32, p, h, w, box_cols,
                       box_rows, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised mbarriers visible to the async proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects `bytes` more bytes in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Clock cycles (~9 s) after which a wait that never ends traps, so that
// a copy that cannot complete fails the launch instead of hanging.
constexpr long long kWaitLimitCycles = 1LL << 34;

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > kWaitLimitCycles) __trap();
}

// Orders this thread's view of shared memory before its later async-proxy
// operations.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The box of `map` whose first element is (column c0, row c1), which may
// lie outside the tensor (c0 * element size a multiple of 16 bytes: TMA
// faults with an illegal instruction otherwise), into shared memory at
// `dst`, 128-byte aligned; completes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// `src` to shared `dst`; completes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"((uint64_t)src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` from shared `src` to global `dst`, in the open bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          (uint64_t)dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read shared
// memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Waits until every bulk group of this thread has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// 4 bytes from global `src` to shared `dst`, in the open cp.async group.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"((uint64_t)src)
               : "memory");
}

// 16 bytes from global `src` to shared `dst`, both 16-byte aligned, in the
// open cp.async group; .cg: cached in L2 only, as the window's halo is
// read again by the neighbouring tile from L2, not from this SM's L1.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"((uint64_t)src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most `pending` (0-7) of this thread's cp.async groups are
// still in flight; the PTX instruction takes the count as an immediate.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;" ::: "memory"); break;
  }
}

}  // namespace xrt
