// bf16.cuh — bfloat16 as a storage type, for nvcc and for the host compiler.
//
// The kernels that take bfloat16 operands (lm_sites.cuh's rmsnorm, gated,
// act and mamba; flash_attention.cuh) load each value as float32, compute in
// float32 as the TPU kernels do (src/repro/kernels/lm.py:55-59, :90-96;
// src/repro/kernels/flash_attention.py:57-59) and round each result to
// bfloat16 once, to nearest with ties to even (torch's and XLA's rounding).
// The type is the value's 16 bits, no arithmetic: the same code runs on the
// card and in the tests' host harnesses, which have no cuda_bf16.h.
//
// The LB and example site functions (lb_sites.cuh, example_sites.cuh) take
// bfloat16 as the reference's bodies compute in it, op by op: their values
// are `rbf` below, a bfloat16 held widened in a float32 register, whose +,
// -, *, / compute in float32 (IEEE, never contracted into an FMA) and round
// the result to bfloat16, as XLA's CPU backend runs a bfloat16 op (convert,
// float32 op, convert).  A sum the reference takes in float32 (jnp.sum, a
// contraction) accumulates in float32 (sum_add) and rounds once (sum_end).
// The float32 instantiation of the same bodies is plain float arithmetic.
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

// ---------------------------------------------------------------------------
// bfloat16 arithmetic (the LB and example site functions)
// ---------------------------------------------------------------------------

// float32 operations rounded to nearest, never contracted into an FMA.
__host__ __device__ __forceinline__ float fadd_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
__host__ __device__ __forceinline__ float fsub_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
__host__ __device__ __forceinline__ float fmul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
__host__ __device__ __forceinline__ float fdiv_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

// x rounded to bfloat16 (nearest, ties to even), as float32: one cvt on the
// card (a NaN comes out as the canonical NaN there, keeps its payload on the
// host).
__host__ __device__ __forceinline__ float round_bf16(float x) {
#if defined(__CUDA_ARCH__)
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(x));
  return __uint_as_float((unsigned)h << 16);
#else
  return to_f32(from_f32<bf16>(x));
#endif
}

// A bfloat16 value held widened in a float32 register.  From a float it is
// rounded (literals fold at compile time; the physics scalars arrive
// rounded already); exact() wraps a value that is a bfloat16 already.
struct rbf {
  float v;
  rbf() = default;
  __host__ __device__ __forceinline__ rbf(float x) : v(to_f32(from_f32<bf16>(x))) {}
  __host__ __device__ __forceinline__ static rbf exact(float x) {
    rbf r;
    r.v = x;
    return r;
  }
};

__host__ __device__ __forceinline__ rbf operator+(rbf a, rbf b) {
  return rbf::exact(round_bf16(fadd_rn(a.v, b.v)));
}
__host__ __device__ __forceinline__ rbf operator-(rbf a, rbf b) {
  return rbf::exact(round_bf16(fsub_rn(a.v, b.v)));
}
__host__ __device__ __forceinline__ rbf operator*(rbf a, rbf b) {
  return rbf::exact(round_bf16(fmul_rn(a.v, b.v)));
}
__host__ __device__ __forceinline__ rbf operator/(rbf a, rbf b) {
  return rbf::exact(round_bf16(fdiv_rn(a.v, b.v)));
}
__host__ __device__ __forceinline__ rbf operator-(rbf a) { return rbf::exact(-a.v); }

// A value as float32, and a float32 that holds a value of V exactly as V.
__host__ __device__ __forceinline__ float value_f32(float x) { return x; }
__host__ __device__ __forceinline__ float value_f32(rbf x) { return x.v; }
template <class V>
__host__ __device__ __forceinline__ V as_value(float x);
template <>
__host__ __device__ __forceinline__ float as_value<float>(float x) {
  return x;
}
template <>
__host__ __device__ __forceinline__ rbf as_value<rbf>(float x) {
  return rbf::exact(x);
}

// A sum of values V in a float32 accumulator: sum_add(acc, term), then
// sum_end rounds it once into V.  For float the plain additions.
template <class V>
__host__ __device__ __forceinline__ float sum_add(float a, float b);
template <>
__host__ __device__ __forceinline__ float sum_add<float>(float a, float b) {
  return a + b;
}
template <>
__host__ __device__ __forceinline__ float sum_add<rbf>(float a, float b) {
  return fadd_rn(a, b);
}
template <class V>
__host__ __device__ __forceinline__ V sum_end(float a);
template <>
__host__ __device__ __forceinline__ float sum_end<float>(float a) {
  return a;
}
template <>
__host__ __device__ __forceinline__ rbf sum_end<rbf>(float a) {
  return rbf::exact(round_bf16(a));
}

// The value type of a storage type: float for float, rbf for bf16.
template <class T>
struct value_of {
  using type = float;
};
template <>
struct value_of<bf16> {
  using type = rbf;
};
template <class T>
using value_t = typename value_of<T>::type;

// A bfloat16 value stored: its 16 bits (it is one already).
__host__ __device__ __forceinline__ void store_value(bf16* p, rbf x) {
  *p = bf16{(uint16_t)(bits_from_f32(x.v) >> 16)};
}

}  // namespace tdp
