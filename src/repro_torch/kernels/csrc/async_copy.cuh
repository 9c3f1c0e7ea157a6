// Helpers shared by the graph-mix, Gram and selective-scan kernels:
// element conversion and cp.async copies from device memory into shared
// memory (sm_80 and later).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace async_copy {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void set_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16* p) {
  *p = __float2bfloat16(0.f);
}

// Four consecutive elements of shared memory (16 bytes of f32 or 8 bytes
// of bf16, aligned to their size) as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Copy `valid` (0 to 16) bytes from `src` to `dst` and zero the rest of
// the 16; both addresses 16-byte aligned.  With valid == 0 nothing is
// read, but `src` must still be a device address.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid) : "memory");
}

// Copy `valid` (0 or 4) bytes from `src` to `dst` and zero the rest of
// the 4; both addresses 4-byte aligned.  With valid == 0 nothing is read,
// but `src` must still be a device address.
__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      int valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// The dynamic shared memory of the calling block, moved up to the next
// 128-byte boundary (a block asks for 128 bytes more): wavefronts of
// shared memory are 128-byte lines, so a warp's vector reads of a row of
// a tile take the fewest when the row starts on one.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  return p + ((128u - s % 128u) % 128u);
}
constexpr size_t kSmemAlign = 128;

// Host: the dynamic shared memory a kernel was last set up for on each
// device, so a launch asks the driver only when it changes.  (Racing first
// calls from two host threads both set the same values.)
struct KernelSetup {
  static constexpr int kDevices = 16;
  size_t smem[kDevices] = {};
};

// Allow `kernel` `smem` bytes of dynamic shared memory, with all of L1 as
// shared memory so as many blocks fit on an SM as their shared memory
// allows (the copies bypass L1).
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, KernelSetup& setup, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < KernelSetup::kDevices;
  if (cached && setup.smem[dev] == smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributePreferredSharedMemoryCarveout,
                            (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (cached) setup.smem[dev] = smem;
  return cudaSuccess;
}

}  // namespace async_copy
