// async_copy.cuh — cp.async into shared memory, vector loads out of it, and
// their host stand-ins.
//
// On the card copy16 issues a 16-byte cp.async that bypasses L1 (.cg),
// copy8 and copy4 an 8- and a 4-byte one through it (.ca), and
// cp_async_commit / cp_async_wait<N> close a group of copies and wait
// until at most N groups are in flight; the block's __syncthreads after
// the wait makes the tile visible to every thread.  Compiled for the host (the tests' harnesses),
// the same calls copy at once and the group calls do nothing, so a harness
// that runs a kernel's phases in order sees what the kernel's barriers
// guarantee.
#pragma once

#include <cstdint>
#include <cstring>

#if !defined(__CUDACC__)
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace tdp {

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// dst (shared) = the 16 bytes at src (4 float32 or 8 bfloat16 values); both
// 16-byte aligned.
__host__ __device__ __forceinline__ void copy16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

// dst (shared) = the 8 bytes at src (4 bfloat16 values); both 8-byte
// aligned.  cp.async copies 8 bytes through L1 only (.ca).
__host__ __device__ __forceinline__ void copy8(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
               : "memory");
#else
  memcpy(dst, src, 8);
#endif
}

// dst (shared) = src[0].
__host__ __device__ __forceinline__ void copy4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
#else
  dst[0] = src[0];
#endif
}

// dst (shared) = 0, 16-byte aligned: an ordinary store.
__host__ __device__ __forceinline__ void zero16(float* dst) {
  for (int i = 0; i < 4; ++i) dst[i] = 0.0f;
}

__host__ __device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__host__ __device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// r = p[0, N) of shared memory (N 1, 2 or 4; p aligned to 4·N bytes): one
// vector load on the card.
template <int N>
__host__ __device__ __forceinline__ void ld_shared(const float* p, float (&r)[N]) {
#if defined(__CUDA_ARCH__)
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
    return;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    r[0] = a.x, r[1] = a.y;
    return;
  }
#endif
  for (int i = 0; i < N; ++i) r[i] = p[i];
}

}  // namespace tdp
