// Hopper (sm_90a) building blocks shared by the kernels that use TMA,
// mbarriers, clusters and wgmma: attention.cu, sae_encode.cu and
// frontend_tail.cu.  Header-only; every function is internal to the
// translation unit that includes it.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int SWIZZLE_ALIGN = 1024;  // the 128-byte swizzle's repeat

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// p rounded up to the 128-byte swizzle's 1024-byte repeat
__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((SWIZZLE_ALIGN - (a & (SWIZZLE_ALIGN - 1))) & (SWIZZLE_ALIGN - 1));
}

// -- mbarriers -----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// arrive on the barrier at the same shared-memory offset in the cluster's
// block `rank` (this block's own included).  The default (CTA-scope)
// release, as CUTLASS's cluster barriers use: the arriving warp's reads
// of the stage were wgmma's, complete at its wait.  An explicit
// .release.cluster made the conv kernel far slower on the H100.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      :: "r"(smem_u32(bar)), "r"(rank) : "memory");
}

// spin until the barrier's phase of this parity has completed; a wait of
// more than about ten seconds traps, so that a fault shows as a launch
// error rather than as a card that never finishes
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) break;
    if (clock64() - t0 > 20000000000ll) __trap();
  }
}

// -- clusters --------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// -- TMA -----------------------------------------------------------------------------

// one box of a 2-D tensor map at (c0, c1) into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// one box of a 3-D tensor map at (c0, c1, c2) into shared memory
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// one box of a 3-D tensor map at (c0, c1, c2) into the same shared-memory
// offset of every block of the cluster in `mask`, each block's barrier at
// the offset of `bar` counting the bytes that land there
__device__ __forceinline__ void tma_load_3d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1, int c2,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

// -- warpgroups --------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers
// across the issue and the wait
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (all >> 4), layout type 1 in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// A or B K-major in 128-byte swizzled rows (as TMA writes a box whose
// inner extent is 128 bytes), 8-row groups 1024 bytes apart; the k-step
// kk of 32 bytes (16 bf16 or 8 tf32 values) starts 32 bytes further in
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + 32 * kk, 0, 1024);
}

// -- host: tensor maps and launch attributes -----------------------------------------

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so
// that a library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A tensor map of `rank` dimensions (innermost first; strides in bytes of
// dimensions 1.. ), 128-byte swizzle, zeros read past every extent.  A
// CUresult error comes back offset by 10000, beside the cudaError_t codes.
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

constexpr int MAX_DEVICES = 64;

// dynamic shared memory above 48 KB, once a process and device for each kernel
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

}  // namespace hopper
