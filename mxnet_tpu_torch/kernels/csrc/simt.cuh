// Helpers of the CUDA-core (SIMT) flash kernels in flash_fwd.cu and
// flash_bwd.cu: element access for f32 and bf16 storage with f32
// arithmetic, and the cp.async copies that stream tiles into shared
// memory.  Built for sm_90a with the sources that include it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace simt {

template <typename T> struct Elt;

template <> struct Elt<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
  // round an f32 value to the storage type (identity for f32)
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float of(float x) { return x; }
};

template <> struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    // 4 bf16 in 8 bytes; a bf16 is the high half of its f32
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
    uint2 u;
    u.x = hopper::pack_bf16(x.x, x.y);
    u.y = hopper::pack_bf16(x.z, x.w);
    *reinterpret_cast<uint2*>(p) = u;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 of(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ float lane(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// arrive at named barrier `id` of `count` threads without waiting: this
// thread's earlier shared-memory writes are visible to the threads that
// wait there (bar.sync) once the barrier completes
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

}  // namespace simt
