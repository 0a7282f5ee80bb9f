// lm_sites.cuh — the LM site functions of the gathered executor, written once.
//
// The site bodies of repro_torch/kernels/lm.py (rmsnorm_site, gated_site,
// act_site, mamba_site), run by tdp_gathered_lm.cu over the same
// strip-of-VVL thread mapping as tdp::gathered_thread (lb_sites.cuh): thread
// t covers the VVL consecutive sites [t*VVL, t*VVL + VVL), the ragged last
// strip masked.
//
//   rmsnorm  site = token: x is (ncomp, n), component c of site s at
//            c*n + s, so a warp's 32 threads read 32 neighbouring tokens of
//            one component — coalesced.  ncomp (d_model, 2304 for gemma2)
//            is a runtime value; the weight is a pointer to ncomp floats.
//   gated    site = flattened element: out = act(u) * v over (1, n).
//   act      out = act(u) over (1, n).
//   mamba    site = channel: the selective scan, sequential in time.  x, dt
//            and y are (L, n), a is (N, n), d is (1, n), b and c are (L, N)
//            (no channel axis: every thread reads the same b[t], c[t], a
//            broadcast), the final state h is (N, n).  A thread walks its
//            VVL channels together in time, so at each step a warp reads
//            32·VVL neighbouring floats of x and dt — coalesced — and the
//            strip's states h[VVL][N] and rates a[VVL][N] stay in registers
//            (N is a template parameter: 8 and 16 are instantiated).  It has
//            an entry of its own, tdp_gathered_mamba_launch, since it takes
//            six inputs and gives two outputs.
//
// The activation (silu, gelu with the tanh approximation, relu^2) is a
// template parameter.  Arithmetic keeps the plain version's order
// (x * rsqrt(mean(x*x) + eps) * (w + offset); u * sigmoid(u);
// 0.5 u (1 + tanh(sqrt(2/pi) (u + 0.044715 u^3)))); the card is held to
// tolerances, not bits.  Every index is 64-bit: the gated site runs over
// B*S*d_ff = 85 M elements at the full-width prompt.
#pragma once

#include <math.h>

#include <cstdint>

#include "lb_sites.cuh"  // tdp::ldg, tdp::ERR_*, tdp::dispatch_vvl

namespace tdp {
namespace lm {

enum SiteId : int { SITE_RMSNORM = 0, SITE_GATED = 1, SITE_ACT = 2 };
enum ActId : int { ACT_SILU = 0, ACT_GELU_TANH = 1, ACT_RELU2 = 2 };

// Operands of one launch: x/u is in[0], v is in[1]; out is (ncomp, n).
struct LmIO {
  const float* in[2];
  float* out;
  const float* weight;  // rmsnorm: ncomp floats
  int64_t n;
  int ncomp;
  float eps, scale_offset;
};

template <int ACT>
__host__ __device__ __forceinline__ float act(float u) {
  if (ACT == ACT_SILU) return u * (1.0f / (1.0f + expf(-u)));
  if (ACT == ACT_GELU_TANH) {
    const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
    const float inner = kBeta * (u + 0.044715f * u * u * u);
    return 0.5f * u * (1.0f + tanhf(inner));
  }
  const float r = u > 0.0f ? u : 0.0f;
  return r * r;
}

struct RmsnormSite {
  __host__ __device__ static void run(const LmIO& io, int64_t s) {
    const float* x = io.in[0] + s;
    float ss = 0.0f;
    for (int c = 0; c < io.ncomp; ++c) {
      const float xc = ldg(x + (int64_t)c * io.n);
      ss += xc * xc;
    }
    const float inv = 1.0f / sqrtf(ss / (float)io.ncomp + io.eps);
    float* o = io.out + s;
    for (int c = 0; c < io.ncomp; ++c)
      o[(int64_t)c * io.n] = ldg(x + (int64_t)c * io.n) * inv *
                             (ldg(io.weight + c) + io.scale_offset);
  }
};

template <int ACT>
struct GatedSite {
  __host__ __device__ static void run(const LmIO& io, int64_t s) {
    io.out[s] = act<ACT>(ldg(io.in[0] + s)) * ldg(io.in[1] + s);
  }
};

template <int ACT>
struct ActSite {
  __host__ __device__ static void run(const LmIO& io, int64_t s) {
    io.out[s] = act<ACT>(ldg(io.in[0] + s));
  }
};

// The strip mapping of tdp::gathered_thread.
template <class Site, int VVL>
__host__ __device__ __forceinline__ void lm_thread(const LmIO& io, int64_t t) {
  const int64_t site0 = t * VVL;
  if (site0 >= io.n) return;
#pragma unroll
  for (int l = 0; l < VVL; ++l)
    if (site0 + l < io.n) Site::run(io, site0 + l);
}

// Threads of a launch over io.n sites (LmIO or MambaIO).
template <int VVL, class IO>
__host__ __device__ __forceinline__ int64_t lm_threads(const IO& io) {
  return (io.n + VVL - 1) / VVL;
}

// ---------------------------------------------------------------------------
// mamba: the selective scan, site = channel
// ---------------------------------------------------------------------------

// d_state not instantiated (8 and 16 are): the mamba entry's return code
constexpr int ERR_BAD_NSTATE = -5;

// Operands of one mamba launch (one batch row).
struct MambaIO {
  const float* x;   // (L, n)
  const float* dt;  // (L, n)
  const float* a;   // (N, n)
  const float* d;   // (1, n)
  const float* b;   // (L, N)
  const float* c;   // (L, N)
  float* y;         // (L, n)
  float* h;         // (N, n): the state after the last step
  int64_t L, n;
};

template <int N>
struct MambaSite {
  // Channels [site0, site0 + VVL), the first nv of them live.  Per step t:
  // h[k] = h[k]·exp(dt·a[k]) + (dt·x)·b[k], y = Σ_k h[k]·c[k] + d·x — the
  // plain body's order (kernels/lm.py:mamba_site).
  template <int VVL>
  __host__ __device__ static void run_strip(const MambaIO& io, int64_t site0,
                                            int nv) {
    float h[VVL][N], a[VVL][N], d[VVL];
#pragma unroll
    for (int l = 0; l < VVL; ++l) {
      d[l] = l < nv ? ldg(io.d + site0 + l) : 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        h[l][k] = 0.0f;
        a[l][k] = l < nv ? ldg(io.a + (int64_t)k * io.n + site0 + l) : 0.0f;
      }
    }
    for (int64_t t = 0; t < io.L; ++t) {
      float bt[N], ct[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        bt[k] = ldg(io.b + t * N + k);
        ct[k] = ldg(io.c + t * N + k);
      }
      const int64_t row = t * io.n + site0;
#pragma unroll
      for (int l = 0; l < VVL; ++l) {
        if (l >= nv) continue;
        const float xv = ldg(io.x + row + l);
        const float dtv = ldg(io.dt + row + l);
        const float dx = dtv * xv;
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          h[l][k] = h[l][k] * expf(dtv * a[l][k]) + dx * bt[k];
          acc += h[l][k] * ct[k];
        }
        io.y[row + l] = acc + d[l] * xv;
      }
    }
#pragma unroll
    for (int l = 0; l < VVL; ++l) {
      if (l >= nv) continue;
#pragma unroll
      for (int k = 0; k < N; ++k) io.h[(int64_t)k * io.n + site0 + l] = h[l][k];
    }
  }
};

// The strip mapping of lm_thread; the strip's channels advance in time
// together.
template <class Site, int VVL>
__host__ __device__ __forceinline__ void mamba_thread(const MambaIO& io, int64_t t) {
  const int64_t site0 = t * VVL;
  if (site0 >= io.n) return;
  const int64_t left = io.n - site0;
  Site::template run_strip<VVL>(io, site0, left < VVL ? (int)left : VVL);
}

// ---------------------------------------------------------------------------
// host-side dispatch: (site id, act id, VVL) -> Launch<Site, VVL>::run(io, stream)
// ---------------------------------------------------------------------------

template <template <class, int> class Launch, template <int> class Site>
int dispatch_act(int act_id, int vvl, const LmIO& io, void* stream) {
  switch (act_id) {
    case ACT_SILU: return tdp::dispatch_vvl<Launch, Site<ACT_SILU>>(vvl, io, stream);
    case ACT_GELU_TANH: return tdp::dispatch_vvl<Launch, Site<ACT_GELU_TANH>>(vvl, io, stream);
    case ACT_RELU2: return tdp::dispatch_vvl<Launch, Site<ACT_RELU2>>(vvl, io, stream);
    default: return tdp::ERR_BAD_SITE;
  }
}

// (d_state, VVL) -> Launch<MambaSite<N>, VVL>::run(io, stream)
template <template <class, int> class Launch>
int dispatch_mamba(int nstate, int vvl, const MambaIO& io, void* stream) {
  switch (nstate) {
    case 8: return tdp::dispatch_vvl<Launch, MambaSite<8>>(vvl, io, stream);
    case 16: return tdp::dispatch_vvl<Launch, MambaSite<16>>(vvl, io, stream);
    default: return ERR_BAD_NSTATE;
  }
}

template <template <class, int> class Launch>
int dispatch_site(int site, int act_id, int vvl, const LmIO& io, void* stream) {
  switch (site) {
    case SITE_RMSNORM: return tdp::dispatch_vvl<Launch, RmsnormSite>(vvl, io, stream);
    case SITE_GATED: return dispatch_act<Launch, GatedSite>(act_id, vvl, io, stream);
    case SITE_ACT: return dispatch_act<Launch, ActSite>(act_id, vvl, io, stream);
    default: return tdp::ERR_BAD_SITE;
  }
}

}  // namespace lm
}  // namespace tdp
