// Hopper's asynchronous copies for the port's kernels: mbarriers, TMA tile
// loads (cp.async.bulk.tensor, 2-D and 4-D), plain bulk copies, and the
// host-side tensor maps that describe them. Raw PTX as in the PTX ISA; no
// CUTLASS.
//
// Tensor maps are encoded with the driver's cuTensorMapEncodeTiled, found
// through the runtime (cudaGetDriverEntryPoint*), so the library needs no
// link against libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace jl {

// --- device side ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (and the cluster)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// orders this thread's generic-proxy shared-memory accesses with the async
// proxy's (TMA, wgmma) before buffers change hands
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_timer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait that has not completed after this long is a fault (a copy that was
// never issued, a wrong phase): trap, so the launch fails instead of hanging.
constexpr uint64_t kWaitLimitNs = 4000000000ull;

// whether the barrier's phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_test(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.b32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  while (!mbar_test(addr, parity)) {
    const uint64_t now = global_timer_ns();
    if (t0 == 0) t0 = now;
    else if (now - t0 > kWaitLimitNs) __trap();
  }
}

// mbar_wait without the time limit, for code under setmaxnreg.inc: a trap
// anywhere in such a region makes ptxas hold it to the kernel's entry
// register count. A kernel using it keeps one thread in a timed mbar_wait
// on the same progress (a barrier the waiting threads arrive on last), so
// a stall still fails the launch.
__device__ __forceinline__ void mbar_wait_untimed(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  while (!mbar_test(addr, parity)) {
  }
}

// TMA: the box of `map` at coordinates (c0 innermost, c1) into shared memory
// at `dst`; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// TMA: the box of a 4-D `map` at coordinates (c0 innermost .. c3)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// TMA store: the box of `map` at coordinates (c0 innermost, c1) from shared
// memory at `src` (written by this block's threads, then fence_proxy_async
// and a barrier); boxes past the tensor's edge are clipped. Each thread that
// issues stores groups them (bulk_commit) and waits on its groups.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0, int c1,
                                             const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// until at most N of this thread's store groups are still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
// until at most N of this thread's store groups are still incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// a plain bulk copy of `bytes` contiguous bytes from global memory (both
// addresses 16-byte aligned, bytes a multiple of 16), counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

// --- host side ------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tiled map over a RANK-d tensor: dims[0] innermost and contiguous, the
// byte strides of dims 1.. (multiples of 16), boxes of box[] elements. Reads
// past the tensor's edge fill the box with zeros. -> false if
// cuTensorMapEncodeTiled refused it.
template <int RANK>
inline bool make_tmap(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                      const cuuint64_t (&dims)[RANK], const cuuint64_t (&stride_bytes)[RANK - 1],
                      const cuuint32_t (&box)[RANK], CUtensorMapSwizzle swizzle) {
  // cuTensorMapEncodeTiled needs the thread's current context, which the
  // runtime binds at a thread's first runtime call: a host thread
  // whose first CUDA work is one of these launches has none yet, and the
  // encoder refuses (a model group's ranks played by threads of one
  // process). cudaSetDevice binds the device's primary context (CUDA 12),
  // once a thread, and is no stream work, so it is legal during capture.
  thread_local bool bound = false;
  if (!bound) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess) return false;
    bound = true;
  }
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint32_t elem[RANK];
  for (int i = 0; i < RANK; ++i) elem[i] = 1;
  return fn(map, type, RANK, const_cast<void*>(ptr), dims, stride_bytes, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// over a row-major [outer][inner] tensor (row pitch `row_bytes`) with boxes
// of [box_outer][box_inner]
inline bool make_tmap_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                         uint64_t inner, uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
                         uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  return make_tmap<2>(map, ptr, type, {inner, outer}, {row_bytes}, {box_inner, box_outer},
                      swizzle);
}

}  // namespace jl
