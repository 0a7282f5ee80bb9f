// bf16.cuh — bfloat16 as a storage type, for nvcc and for the host compiler.
//
// The kernels that take bfloat16 operands (lm_sites.cuh's rmsnorm, gated,
// act and mamba; flash_attention.cuh) load each value as float32, compute in
// float32 as the TPU kernels do (src/repro/kernels/lm.py:55-59, :90-96;
// src/repro/kernels/flash_attention.py:57-59) and round each result to
// bfloat16 once, to nearest with ties to even (torch's and XLA's rounding).
// The type is the value's 16 bits, no arithmetic: the same code runs on the
// card and in the tests' host harnesses, which have no cuda_bf16.h.
#pragma once

#include <stdint.h>
#include <string.h>

#if !defined(__CUDACC__)
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace tdp {

// The top 16 bits of a float32.
struct bf16 {
  uint16_t bits;
};

// The storage type codes of the C entries that take one
// (kernels/_build.py: DTYPE_ID).
enum DtypeId : int { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

// A storage type outside DtypeId, or one a kernel is not instantiated for.
constexpr int ERR_BAD_DTYPE = -10;

__host__ __device__ __forceinline__ float f32_from_bits(uint32_t u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

__host__ __device__ __forceinline__ uint32_t bits_from_f32(float f) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
#endif
}

__host__ __device__ __forceinline__ float to_f32(float x) { return x; }
__host__ __device__ __forceinline__ float to_f32(bf16 x) {
  return f32_from_bits((uint32_t)x.bits << 16);
}

// x in the storage type T: float as it is; bfloat16 rounded to nearest,
// ties to even (a NaN stays a quiet NaN, an overflow becomes infinity).
template <class T>
__host__ __device__ __forceinline__ T from_f32(float x);

template <>
__host__ __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

template <>
__host__ __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  uint32_t u = bits_from_f32(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return bf16{(uint16_t)((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return bf16{(uint16_t)(u >> 16)};
}

// Two bfloat16 values packed in a 32-bit word (element 0 in the low half,
// as they lie in memory) and back.
__host__ __device__ __forceinline__ void unpack_bf16x2(uint32_t w, float& a, float& b) {
  a = f32_from_bits(w << 16);
  b = f32_from_bits(w & 0xffff0000u);
}

__host__ __device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  return (uint32_t)from_f32<bf16>(a).bits | ((uint32_t)from_f32<bf16>(b).bits << 16);
}

// A read-only load of one bfloat16, as float32: through the non-coherent
// cache on the card.
__host__ __device__ __forceinline__ float ldg(const bf16* p) {
#if defined(__CUDA_ARCH__)
  return to_f32(bf16{__ldg(reinterpret_cast<const unsigned short*>(p))});
#else
  return to_f32(*p);
#endif
}

// r = p[0, N) of shared memory, widened to float32 (N 1, 2 or 4; p aligned
// to 2·N bytes): one 4- or 8-byte load on the card.
template <int N>
__host__ __device__ __forceinline__ void ld_shared(const bf16* p, float (&r)[N]) {
#if defined(__CUDA_ARCH__)
  if constexpr (N == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    unpack_bf16x2(w.x, r[0], r[1]);
    unpack_bf16x2(w.y, r[2], r[3]);
    return;
  } else if constexpr (N == 2) {
    unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p), r[0], r[1]);
    return;
  }
#endif
  for (int i = 0; i < N; ++i) r[i] = to_f32(p[i]);
}

// *p = x in p's storage type.
__host__ __device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__host__ __device__ __forceinline__ void store_f32(bf16* p, float x) { *p = from_f32<bf16>(x); }

}  // namespace tdp
