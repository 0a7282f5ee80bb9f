// lm_sites.cuh — the LM site functions of the gathered executor, written once.
//
// The site bodies of repro_torch/kernels/lm.py (rmsnorm_site, gated_site,
// act_site, mamba_site), run by tdp_gathered_lm.cu.  Every piece a thread
// runs is __host__ __device__, so the tests run each launch's own
// decomposition (block by block, thread by thread, in the kernel's combine
// order) with the host compiler.
//
//   gated    site = flattened element: out = act(u) * v over (1, n).
//   act      out = act(u) over (1, n).  Both run ew_thread: a grid that
//            covers the work, block b over the EW_BLOCK·4·VVL elements from
//            b·EW_BLOCK·4·VVL; thread t moves VVL 16-byte groups, group j
//            at j·EW_BLOCK + t, so each of a warp's loads is 512
//            contiguous bytes.  Where u, v and out are not all 16-byte
//            aligned (a view at a storage offset) the same thread moves the
//            same elements as 4·VVL scalars, element k at k·EW_BLOCK + t;
//            the last block's ragged tail (< 4 elements) is scalar too.
//            Offsets inside a block are 32-bit.
//   rmsnorm  site = token: x is (d, n), component c of token s at c*n + s;
//            d (2304 for gemma2, 4096 for falcon-mamba) is a runtime value,
//            the weight a pointer to d floats.  No thread walks a token
//            alone:
//            - tiled (n >= RMS_FEW): a block of RMS_WARPS warps covers 32·VVL
//              neighbouring tokens, lane l the VVL tokens from l·VVL (one
//              float2/float4 load per component row where n % VVL == 0 and
//              x, out are aligned to it; VVL scalars otherwise), so each
//              warp load of a component row is coalesced.  Warp w sums the
//              squares of the components c = w, w + RMS_WARPS, ... in that
//              order, rms_unroll<VVL>() rows loaded before they are added;
//              the warps' partials meet in shared memory, thread t adds
//              token t's in warp order into 1/sqrt(mean + eps), and the
//              warps scale their components, reading x a second time (from
//              L2 while the block's 32·VVL·d·4 bytes stay resident).
//            - few tokens (n < RMS_FEW, decode): lanes over tokens would
//              idle, so one block of n·J threads (J a power of two, n·J <=
//              RMS_FEW_THREADS) sweeps the contiguous (d, n) array: thread
//              j·n + s takes elements j·n + s + k·n·J, i.e. token s,
//              components j, j + J, ...; the J partials of each token meet
//              in a shared-memory tree (h = J/2, ..., 1).  VVL does not
//              change this mapping.
//   mamba    site = channel: the selective scan, sequential in time.  x, dt
//            and y are (L, n), a is (N, n), d is (1, n), b and c are (L, N)
//            (no channel axis: every thread reads the same b[t], c[t], a
//            broadcast), the final state h is (N, n).  Thread t covers the
//            VVL consecutive channels [t*VVL, t*VVL + VVL), the ragged last
//            strip masked, and walks them together in time, so at each step
//            a warp reads 32·VVL neighbouring floats of x and dt —
//            coalesced — and the strip's states h[VVL][N] and rates
//            a[VVL][N] stay in registers (N is a template parameter: 8 and
//            16 are instantiated).  It has an entry of its own,
//            tdp_gathered_mamba_launch, since it takes six inputs and gives
//            two outputs.
//
// The activation (silu, gelu with the tanh approximation, relu^2) is a
// template parameter.  Arithmetic keeps the plain version's order where it
// is elementwise (x * rsqrt(mean(x*x) + eps) * (w + offset); u * sigmoid(u);
// 0.5 u (1 + tanh(sqrt(2/pi) (u + 0.044715 u^3)))); rmsnorm's sum of
// squares runs in the order above, not the plain version's, so the card is
// held to tolerances, not bits.
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

// ---------------------------------------------------------------------------
// rows of V consecutive floats: one vector load or store where aligned
// ---------------------------------------------------------------------------

// p is aligned for the V-float vector access (V 1, 2, 4; 8 is two float4).
template <int V>
__host__ __device__ __forceinline__ bool vec_aligned(const void* p) {
  constexpr uintptr_t kAlign = V >= 4 ? 16 : 4 * V;
  return ((uintptr_t)p & (kAlign - 1)) == 0;
}

// r = p[0, V): vector loads when vec (then nv == V), else the first nv as
// scalars and the rest 0.
template <int V>
__host__ __device__ __forceinline__ void load_row(const float* p, bool vec,
                                                  int nv, float (&r)[V]) {
#if defined(__CUDA_ARCH__)
  if (V > 1 && vec) {
    if constexpr (V == 2) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      r[0] = a.x;
      r[1] = a.y;
    } else {
#pragma unroll
      for (int h = 0; h < V / 4; ++h) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p) + h);
        r[4 * h] = a.x;
        r[4 * h + 1] = a.y;
        r[4 * h + 2] = a.z;
        r[4 * h + 3] = a.w;
      }
    }
    return;
  }
#endif
#pragma unroll
  for (int l = 0; l < V; ++l) r[l] = l < nv ? ldg(p + l) : 0.0f;
}

// p[0, nv) = r: vector stores when vec (then nv == V), else scalars.
template <int V>
__host__ __device__ __forceinline__ void store_row(float* p, bool vec, int nv,
                                                   const float (&r)[V]) {
#if defined(__CUDA_ARCH__)
  if (V > 1 && vec) {
    if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
    } else {
#pragma unroll
      for (int h = 0; h < V / 4; ++h)
        reinterpret_cast<float4*>(p)[h] =
            make_float4(r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]);
    }
    return;
  }
#endif
#pragma unroll
  for (int l = 0; l < V; ++l)
    if (l < nv) p[l] = r[l];
}

// ---------------------------------------------------------------------------
// gated, act: the elementwise launch
// ---------------------------------------------------------------------------

constexpr int EW_BLOCK = 512;  // threads of a block

template <int ACT>
struct GatedSite {
  static constexpr bool kGated = true;
  __host__ __device__ static float op(float u, float v) { return act<ACT>(u) * v; }
};

template <int ACT>
struct ActSite {
  static constexpr bool kGated = false;
  __host__ __device__ static float op(float u, float) { return act<ACT>(u); }
};

template <int VVL>
__host__ __device__ __forceinline__ int64_t ew_blocks(int64_t n) {
  constexpr int64_t kTile = EW_BLOCK * 4 * VVL;
  return (n + kTile - 1) / kTile;
}

// Thread `tid` of block `block`: VVL groups of 4 elements (see the header).
template <class Site, int VVL>
__host__ __device__ __forceinline__ void ew_thread(const LmIO& io, int64_t block,
                                                   int tid) {
  constexpr int kTile = EW_BLOCK * 4 * VVL;
  const int64_t base = block * kTile;  // a multiple of 4: keeps alignment
  if (base >= io.n) return;
  const int left = io.n - base < kTile ? (int)(io.n - base) : kTile;
  const float* u = io.in[0] + base;
  const float* v = Site::kGated ? io.in[1] + base : nullptr;
  float* o = io.out + base;
  const bool vec = vec_aligned<4>(u) && vec_aligned<4>(o) &&
                   (!Site::kGated || vec_aligned<4>(v));
  if (vec) {
    const int n4 = left / 4;
    float a[VVL][4], b[VVL][4];
#pragma unroll
    for (int j = 0; j < VVL; ++j) {
      const int g = j * EW_BLOCK + tid;
      if (g >= n4) continue;
      load_row<4>(u + 4 * g, true, 4, a[j]);
      if (Site::kGated) load_row<4>(v + 4 * g, true, 4, b[j]);
    }
#pragma unroll
    for (int j = 0; j < VVL; ++j) {
      const int g = j * EW_BLOCK + tid;
      if (g >= n4) continue;
      float r[4];
#pragma unroll
      for (int l = 0; l < 4; ++l)
        r[l] = Site::op(a[j][l], Site::kGated ? b[j][l] : 0.0f);
      store_row<4>(o + 4 * g, true, 4, r);
    }
    const int t = 4 * n4 + tid;  // the ragged tail of the last block
    if (t < left) o[t] = Site::op(ldg(u + t), Site::kGated ? ldg(v + t) : 0.0f);
    return;
  }
  float a[4 * VVL], b[4 * VVL];
#pragma unroll
  for (int k = 0; k < 4 * VVL; ++k) {
    const int i = k * EW_BLOCK + tid;
    if (i >= left) continue;
    a[k] = ldg(u + i);
    b[k] = Site::kGated ? ldg(v + i) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 4 * VVL; ++k) {
    const int i = k * EW_BLOCK + tid;
    if (i < left) o[i] = Site::op(a[k], b[k]);
  }
}

// ---------------------------------------------------------------------------
// rmsnorm: the tiled and the few-token mappings
// ---------------------------------------------------------------------------

struct RmsnormSite {};  // the site function's tag for dispatch_site

constexpr int RMS_WARPS = 16;                // warps of a tiled block
constexpr int RMS_THREADS = 32 * RMS_WARPS;  // threads of a tiled block
constexpr int RMS_FEW = 32;                  // n below: the few-token mapping
constexpr int RMS_FEW_THREADS = 1024;        // most threads of its block

// Component rows a lane loads before adding them: 64 bytes in flight per
// lane at every VVL.
template <int VVL>
__host__ __device__ constexpr int rms_unroll() {
  return VVL >= 16 ? 1 : 16 / VVL;
}

__host__ __device__ __forceinline__ float rms_inv(float ss, const LmIO& io) {
  return 1.0f / sqrtf(ss / (float)io.ncomp + io.eps);
}

template <int VVL>
__host__ __device__ __forceinline__ int64_t rms_tiled_blocks(int64_t n) {
  return (n + 32 * VVL - 1) / (32 * VVL);
}

// What lane `lane` of a tiled block covers: tokens s0 + [0, nv) of row 0.
struct RmsLane {
  const float* x;
  float* o;
  int nv;
  bool vec;
};

template <int VVL>
__host__ __device__ __forceinline__ RmsLane rms_lane(const LmIO& io,
                                                     int64_t block, int lane) {
  const int64_t s0 = block * (32 * VVL) + (int64_t)lane * VVL;
  const int64_t left = io.n - s0;
  RmsLane r;
  r.x = io.in[0] + s0;
  r.o = io.out + s0;
  r.nv = left <= 0 ? 0 : left < VVL ? (int)left : VVL;
  r.vec = io.n % VVL == 0 && vec_aligned<VVL>(io.in[0]) &&
          vec_aligned<VVL>(io.out);
  return r;
}

// Tiled, phase 1: thread `tid` (warp w, lane l) sums the squares of its
// tokens over the components w, w + RMS_WARPS, ... into red[w][l·VVL + i].
template <int VVL>
__host__ __device__ __forceinline__ void rms_tiled_partial(const LmIO& io,
                                                           int64_t block,
                                                           int tid, float* red) {
  constexpr int U = rms_unroll<VVL>();
  const int w = tid / 32, lane = tid % 32;
  const RmsLane L = rms_lane<VVL>(io, block, lane);
  float ss[VVL];
#pragma unroll
  for (int i = 0; i < VVL; ++i) ss[i] = 0.0f;
  if (L.nv > 0) {
    const int64_t stride = (int64_t)RMS_WARPS * io.n;
    const float* p = L.x + (int64_t)w * io.n;
    int c = w;
    for (; c + (U - 1) * RMS_WARPS < io.ncomp; c += U * RMS_WARPS) {
      float r[U][VVL];
#pragma unroll
      for (int k = 0; k < U; ++k, p += stride) load_row<VVL>(p, L.vec, L.nv, r[k]);
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int i = 0; i < VVL; ++i) ss[i] += r[k][i] * r[k][i];
    }
    for (; c < io.ncomp; c += RMS_WARPS, p += stride) {
      float r[VVL];
      load_row<VVL>(p, L.vec, L.nv, r);
#pragma unroll
      for (int i = 0; i < VVL; ++i) ss[i] += r[i] * r[i];
    }
  }
#pragma unroll
  for (int i = 0; i < VVL; ++i) red[w * 32 * VVL + lane * VVL + i] = ss[i];
}

// Tiled, phase 2: thread t < 32·VVL adds token t's partials in warp order.
template <int VVL>
__host__ __device__ __forceinline__ void rms_tiled_combine(const LmIO& io, int tid,
                                                           const float* red,
                                                           float* inv) {
  if (tid >= 32 * VVL) return;
  float ss = 0.0f;
  for (int w = 0; w < RMS_WARPS; ++w) ss += red[w * 32 * VVL + tid];
  inv[tid] = rms_inv(ss, io);
}

// Tiled, phase 3: thread `tid` scales its tokens over its components.
template <int VVL>
__host__ __device__ __forceinline__ void rms_tiled_scale(const LmIO& io,
                                                         int64_t block, int tid,
                                                         const float* inv) {
  constexpr int U = rms_unroll<VVL>();
  const int w = tid / 32, lane = tid % 32;
  const RmsLane L = rms_lane<VVL>(io, block, lane);
  if (L.nv == 0) return;
  float iv[VVL];
#pragma unroll
  for (int i = 0; i < VVL; ++i) iv[i] = inv[lane * VVL + i];
  const int64_t stride = (int64_t)RMS_WARPS * io.n;
  const float* p = L.x + (int64_t)w * io.n;
  float* q = L.o + (int64_t)w * io.n;
  int c = w;
  for (; c + (U - 1) * RMS_WARPS < io.ncomp; c += U * RMS_WARPS) {
    float r[U][VVL], wt[U];
#pragma unroll
    for (int k = 0; k < U; ++k, p += stride) {
      load_row<VVL>(p, L.vec, L.nv, r[k]);
      wt[k] = ldg(io.weight + c + k * RMS_WARPS) + io.scale_offset;
    }
#pragma unroll
    for (int k = 0; k < U; ++k, q += stride) {
#pragma unroll
      for (int i = 0; i < VVL; ++i) r[k][i] = r[k][i] * iv[i] * wt[k];
      store_row<VVL>(q, L.vec, L.nv, r[k]);
    }
  }
  for (; c < io.ncomp; c += RMS_WARPS, p += stride, q += stride) {
    float r[VVL];
    load_row<VVL>(p, L.vec, L.nv, r);
    const float wt = ldg(io.weight + c) + io.scale_offset;
#pragma unroll
    for (int i = 0; i < VVL; ++i) r[i] = r[i] * iv[i] * wt;
    store_row<VVL>(q, L.vec, L.nv, r);
  }
}

// Few tokens: J, the threads per token (a power of two, n·J <=
// RMS_FEW_THREADS); the block has n·J threads.
__host__ __device__ __forceinline__ int rms_few_group(int64_t n) {
  int j = RMS_FEW_THREADS;
  while (j > 1 && j * n > RMS_FEW_THREADS) j >>= 1;
  return j;
}

// Few tokens, phase 1: thread `tid` sums the squares of elements tid,
// tid + n·J, ... (4 loaded before they are added) into red[tid].
__host__ __device__ __forceinline__ void rms_few_partial(const LmIO& io, int J,
                                                         int tid, float* red) {
  const int64_t T = io.n * J, total = io.n * io.ncomp;
  const float* x = io.in[0];
  float ss = 0.0f;
  int64_t i = tid;
  for (; i + 3 * T < total; i += 4 * T) {
    float r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = ldg(x + i + k * T);
#pragma unroll
    for (int k = 0; k < 4; ++k) ss += r[k] * r[k];
  }
  for (; i < total; i += T) {
    const float r = ldg(x + i);
    ss += r * r;
  }
  red[tid] = ss;
}

// Few tokens, tree step h (J/2, ..., 1): thread j·n + s with j < h adds the
// partial of thread (j + h)·n + s.
__host__ __device__ __forceinline__ void rms_few_tree(const LmIO& io, int h,
                                                      int tid, float* red) {
  if (tid < h * io.n) red[tid] += red[tid + h * io.n];
}

// Few tokens, phase 3: thread `tid` scales the elements it summed; red[s]
// holds token s's sum of squares.
__host__ __device__ __forceinline__ void rms_few_scale(const LmIO& io, int J,
                                                       int tid, const float* red) {
  const int64_t T = io.n * J, total = io.n * io.ncomp;
  const float inv = rms_inv(red[tid % io.n], io);
  int c = (int)(tid / io.n);
  for (int64_t i = tid; i < total; i += T, c += J)
    io.out[i] = ldg(io.in[0] + i) * inv * (ldg(io.weight + c) + io.scale_offset);
}

// ---------------------------------------------------------------------------
// mamba: the selective scan, site = channel
// ---------------------------------------------------------------------------

// Threads of a launch over io.n sites, VVL per thread.
template <int VVL, class IO>
__host__ __device__ __forceinline__ int64_t lm_threads(const IO& io) {
  return (io.n + VVL - 1) / VVL;
}

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

// Thread t covers the VVL channels from t*VVL, the ragged last strip
// masked; the strip's channels advance in time together.
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
