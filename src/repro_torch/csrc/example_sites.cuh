// example_sites.cuh — the paper's example site functions for kernel 2.
//
// The site bodies of repro_torch/kernels/example_sites.py, run by
// tdp_gathered_example.cu: the §III-C `scale` of the paper (y = a·x), its
// two-field companion `saxpy` (y = a·x + y') and `site_pos` (y = x + the
// site's global index, the position-dependent role of KernelSpec
// .site_index).  Every field is pointwise, (ncomp, n) float32, site s of
// component c at c·n + s; ncomp is a runtime value, as in the LM entry.
//
// Mapping (example_thread): thread t takes the VVL consecutive sites t·VVL
// ... t·VVL + VVL - 1 (the paper's TARGET_TLP × TARGET_ILP), every
// component of each; the ragged end (s >= n) is masked, nothing is padded.
// Site indices are 32-bit (the wrapper refuses n >= 2^31); a thread's
// first site and a component's base offset c·n are computed in 64 bits.  A site function gets each site's global index
// s, the counterpart of `base + iota` in the Pallas executor
// (src/repro/kernels/tdp_pointwise.py:122-125).
//
// AoSoA (Target(layout="aosoa"), example_aosoa_thread): x, y' and out are
// blocks of W sites, (ceil(n / W), ncomp, W), site s of component c at
// tdp::aosoa_index (lb_sites.cuh).  Thread t takes site t, every component,
// so a block's W sites sit on consecutive lanes; site_pos gets t, the SoA
// index; the pad lanes (t >= n) are neither read nor written.
//
// The arithmetic is rounded as the plain version's is: saxpy's a·x and + y
// are two roundings (__fmul_rn, __fadd_rn: no FMA contraction), so every
// site function is bit-equal to its plain body.  Everything a thread runs
// is __host__ __device__, so the tests run it with the host compiler.
#pragma once

#include <cstdint>

#include "lb_sites.cuh"  // tdp::ldg, tdp::ERR_*, tdp::dispatch_vvl

namespace tdp {
namespace ex {

enum SiteId : int { SITE_SCALE = 0, SITE_SAXPY = 1, SITE_SITE_POS = 2 };

// Operands of one launch: x is in[0], y' (saxpy) is in[1]; out is (ncomp, n).
struct ExampleIO {
  const float* in[2];
  float* out;
  int n;
  int ncomp;
  float a;
};

__host__ __device__ __forceinline__ float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

__host__ __device__ __forceinline__ float add_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

struct ScaleSite {
  __host__ __device__ static float at(float x, float, float a, int) {
    return mul_rn(a, x);
  }
};

struct SaxpySite {
  __host__ __device__ static float at(float x, float y, float a, int) {
    return add_rn(mul_rn(a, x), y);
  }
};

struct SitePosSite {
  __host__ __device__ static float at(float x, float, float, int s) {
    return add_rn(x, (float)s);  // int -> float rounds to nearest, as torch
  }
};

template <int VVL>
__host__ __device__ __forceinline__ int64_t example_threads(const ExampleIO& io) {
  return ((int64_t)io.n + VVL - 1) / VVL;
}

// Thread t: sites t·VVL ... t·VVL + VVL - 1, each component.
template <class Site, int VVL>
__host__ __device__ __forceinline__ void example_thread(const ExampleIO& io,
                                                        int64_t t) {
  if (t >= example_threads<VVL>(io)) return;
  const int64_t s0 = t * VVL;
  for (int c = 0; c < io.ncomp; ++c) {
    const int64_t base = (int64_t)c * io.n;
    const float* x = io.in[0] + base;
    const float* y = io.in[1] ? io.in[1] + base : nullptr;
    float* out = io.out + base;
#pragma unroll
    for (int v = 0; v < VVL; ++v) {
      const int64_t s = s0 + v;
      if (s < io.n) out[s] = Site::at(ldg(x + s), y ? ldg(y + s) : 0.0f, io.a, (int)s);
    }
  }
}

// Operands of one AoSoA launch.
struct ExampleAosoaIO {
  ExampleIO io;
  AosoaMap map;
};

template <class Site>
__host__ __device__ __forceinline__ void example_aosoa_thread(const ExampleAosoaIO& a,
                                                              int64_t t) {
  const ExampleIO& io = a.io;
  if (t >= io.n) return;
  for (int c = 0; c < io.ncomp; ++c) {
    const int64_t i = aosoa_index(a.map, (int)t, io.ncomp, c);
    io.out[i] = Site::at(ldg(io.in[0] + i), io.in[1] ? ldg(io.in[1] + i) : 0.0f, io.a,
                         (int)t);
  }
}

// (site id) -> Launch<Site>::run(io, stream)
template <template <class> class Launch, class IO>
int dispatch_site_aosoa(int site, const IO& io, void* stream) {
  switch (site) {
    case SITE_SCALE: return Launch<ScaleSite>::run(io, stream);
    case SITE_SAXPY: return Launch<SaxpySite>::run(io, stream);
    case SITE_SITE_POS: return Launch<SitePosSite>::run(io, stream);
    default: return ERR_BAD_SITE;
  }
}

template <template <class, int> class Launch, class IO>
int dispatch_site(int site, int vvl, const IO& io, void* stream) {
  switch (site) {
    case SITE_SCALE: return dispatch_vvl<Launch, ScaleSite>(vvl, io, stream);
    case SITE_SAXPY: return dispatch_vvl<Launch, SaxpySite>(vvl, io, stream);
    case SITE_SITE_POS: return dispatch_vvl<Launch, SitePosSite>(vvl, io, stream);
    default: return ERR_BAD_SITE;
  }
}

}  // namespace ex
}  // namespace tdp
