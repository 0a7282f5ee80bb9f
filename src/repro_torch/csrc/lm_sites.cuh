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
//            and y are (L, n) per batch row, a is (N, n), d is (1, n), b and
//            c are (L, N) per row (no channel axis), the final state h is
//            (N, n) per row; one launch covers every row (grid.y).  A
//            channel's N states are split over MAMBA_LANES = 4 lanes (a lane
//            group), lane g holding states g·N/4 ... g·N/4 + N/4 - 1 (N is a
//            template parameter: 8 and 16 are instantiated), and VVL is the
//            channels of a lane group: a block of 128 threads = 32 groups
//            covers 32·VVL channels, group j the channels j, j + 32, ...
//            (interleaved, so a warp's 8 groups read 8 neighbouring floats).
//            The block stages chunks of T = 1024 / (32·VVL) steps — x and dt
//            of its channels, b and c whole — into shared memory by
//            cp.async, double-buffered: chunk q + 1 is in flight while the
//            lanes walk chunk q, so the chain reads only shared memory and
//            registers.  Per step a lane takes exp(dt·a) as exp2(dt·a·log2 e)
//            (one MUFU.EX2), updates its states, sums h·c over them in state
//            order, and the group's four shares meet by shuffles, xor 1 then
//            xor 2: y = (p0 + p1) + (p2 + p3) + d·x, written by lane 0.  The
//            ragged last block and chunk are masked, not padded.  It has an
//            entry of its own, tdp_gathered_mamba_launch, since it takes six
//            inputs and gives two outputs.
//
// AoSoA (Target(layout="aosoa"), W = Target.vvl; lb_sites.cuh: aosoa_index):
//
//   gated, act  every operand is (ceil(n / W), 1, W), one layout for all, so
//            ew_kernel over the nblk·W elements of the blocks is the AoSoA
//            kernel (the pad lanes are zeros in, ignored out).
//   rmsnorm  x and out are (ceil(n / W), d, W), component c of token s at
//            (s / W)·d·W + c·W + s % W.  A block of RMS_THREADS threads takes
//            Wc = min(W, RMS_THREADS) tokens of one AoSoA block, thread t the
//            token t % Wc and the components g, g + G, ... (g = t / Wc, G =
//            RMS_THREADS / Wc groups), so consecutive threads read
//            consecutive floats: a warp's load is one contiguous run when W
//            <= 32.  The groups' partials meet in shared memory in group
//            order.  At W = 32 this is the tiled mapping at VVL 1 (16
//            groups of 32 tokens, the same order of every sum).
//   mamba    x, dt, y are (ceil(n / W), batch·L, W), a (.., N, W), d (.., 1,
//            W), h (.., batch·N, W): step k of channel ch at (ch / W)·K·W +
//            k·W + ch % W (K the component count).  The scan is the SoA one
//            at MAMBA_AOSOA_VVL channels a lane group; only the chunk stage,
//            the loads of a and the stores of y and h take the index map.
//            The stage copies 4 channels at a time (16 bytes of float32, 8
//            of bfloat16), so W must be a multiple of MAMBA_AOSOA_ALIGN = 4:
//            a copy then never straddles two blocks, in either type.
//
// Storage (rmsnorm, gated, act): float32 or bfloat16 (bf16.cuh), one type
// for x/u, v, the weight and out, a template parameter of every piece and a
// runtime code of the C entry.  A bfloat16 value is loaded as float32, the
// arithmetic is the float32 code's, and each result is rounded to bfloat16
// once (to nearest even), as the reference's site bodies do; the weight
// enters as float32 before scale_offset is added (src/repro/kernels/lm.py:58).
// Where the float32 code moves 16 bytes (4 elements), the bfloat16 code
// moves the same elements in 8.
//
// Storage (mamba): x, dt, b, c and y float32 or bfloat16, one type for the
// five; a, d and the final state h float32 in either case, as the
// reference's site takes and returns them (src/repro/kernels/lm.py:120-137:
// every operand widened to float32, y returned in x's dtype, h_final
// float32).  A bfloat16 chunk is staged raw, by the same cp.async copies (8
// values a 16-byte copy where n % 8 == 0 and the pointers are aligned),
// into a stage of half the bytes, and each value is widened to float32 as a
// lane reads it from shared memory; the recurrence, exp(dt·a) and the sum
// over states are the float32 code's, and y is rounded to bfloat16 once.
// The AoSoA launches take the same types: rmsnorm's pieces are templated on
// the storage type as the tiled ones are, gated/act run ew_kernel, and the
// AoSoA scan stages a bfloat16 block's 4 channels by one 8-byte copy.
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

#include "async_copy.cuh"  // tdp::copy16, copy4, cp_async_*, ld_shared
#include "bf16.cuh"         // tdp::bf16, ldg(const bf16*), store_f32
#include "lb_sites.cuh"     // tdp::ldg, load_row, store_row, ERR_*, dispatch_vvl

namespace tdp {

// Rows of V bfloat16 values as float32 (lb_sites.cuh's load_row/store_row
// for float): one V·2-byte access where vec (aligned to it, nv == V), else
// the first nv as scalars (and the rest 0 on a load).
template <int V>
__host__ __device__ __forceinline__ bool vec_aligned(const bf16* p) {
  constexpr uintptr_t kAlign = V >= 8 ? 16 : 2 * V;
  return ((uintptr_t)p & (kAlign - 1)) == 0;
}

template <int V>
__host__ __device__ __forceinline__ void load_row(const bf16* p, bool vec, int nv,
                                                  float (&r)[V]) {
#if defined(__CUDA_ARCH__)
  if (V > 1 && vec) {
    if constexpr (V == 2) {
      unpack_bf16x2(__ldg(reinterpret_cast<const unsigned*>(p)), r[0], r[1]);
    } else if constexpr (V == 4) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
      unpack_bf16x2(w.x, r[0], r[1]);
      unpack_bf16x2(w.y, r[2], r[3]);
    } else {
#pragma unroll
      for (int h = 0; h < V / 8; ++h) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + h);
        unpack_bf16x2(w.x, r[8 * h], r[8 * h + 1]);
        unpack_bf16x2(w.y, r[8 * h + 2], r[8 * h + 3]);
        unpack_bf16x2(w.z, r[8 * h + 4], r[8 * h + 5]);
        unpack_bf16x2(w.w, r[8 * h + 6], r[8 * h + 7]);
      }
    }
    return;
  }
#endif
#pragma unroll
  for (int l = 0; l < V; ++l) r[l] = l < nv ? ldg(p + l) : 0.0f;
}

template <int V>
__host__ __device__ __forceinline__ void store_row(bf16* p, bool vec, int nv,
                                                   const float (&r)[V]) {
#if defined(__CUDA_ARCH__)
  if (V > 1 && vec) {
    if constexpr (V == 2) {
      *reinterpret_cast<unsigned*>(p) = pack_bf16x2(r[0], r[1]);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(r[0], r[1]),
                                                pack_bf16x2(r[2], r[3]));
    } else {
#pragma unroll
      for (int h = 0; h < V / 8; ++h)
        reinterpret_cast<uint4*>(p)[h] = make_uint4(
            pack_bf16x2(r[8 * h], r[8 * h + 1]), pack_bf16x2(r[8 * h + 2], r[8 * h + 3]),
            pack_bf16x2(r[8 * h + 4], r[8 * h + 5]), pack_bf16x2(r[8 * h + 6], r[8 * h + 7]));
    }
    return;
  }
#endif
#pragma unroll
  for (int l = 0; l < V; ++l)
    if (l < nv) p[l] = from_f32<bf16>(r[l]);
}

namespace lm {

enum SiteId : int { SITE_RMSNORM = 0, SITE_GATED = 1, SITE_ACT = 2 };
enum ActId : int { ACT_SILU = 0, ACT_GELU_TANH = 1, ACT_RELU2 = 2 };

// Operands of one launch in storage type T: x/u is in[0], v is in[1]; out
// is (ncomp, n).
template <class T>
struct LmIOT {
  const T* in[2];
  T* out;
  const T* weight;  // rmsnorm: ncomp values
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
template <class Site, int VVL, class T>
__host__ __device__ __forceinline__ void ew_thread(const LmIOT<T>& io, int64_t block,
                                                   int tid) {
  constexpr int kTile = EW_BLOCK * 4 * VVL;
  const int64_t base = block * kTile;  // a multiple of 4: keeps alignment
  if (base >= io.n) return;
  const int left = io.n - base < kTile ? (int)(io.n - base) : kTile;
  const T* u = io.in[0] + base;
  const T* v = Site::kGated ? io.in[1] + base : nullptr;
  T* o = io.out + base;
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
    if (t < left) store_f32(o + t, Site::op(ldg(u + t), Site::kGated ? ldg(v + t) : 0.0f));
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
    if (i < left) store_f32(o + i, Site::op(a[k], b[k]));
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

template <class T>
__host__ __device__ __forceinline__ float rms_inv(float ss, const LmIOT<T>& io) {
  return 1.0f / sqrtf(ss / (float)io.ncomp + io.eps);
}

template <int VVL>
__host__ __device__ __forceinline__ int64_t rms_tiled_blocks(int64_t n) {
  return (n + 32 * VVL - 1) / (32 * VVL);
}

// What lane `lane` of a tiled block covers: tokens s0 + [0, nv) of row 0.
template <class T>
struct RmsLane {
  const T* x;
  T* o;
  int nv;
  bool vec;
};

template <int VVL, class T>
__host__ __device__ __forceinline__ RmsLane<T> rms_lane(const LmIOT<T>& io,
                                                        int64_t block, int lane) {
  const int64_t s0 = block * (32 * VVL) + (int64_t)lane * VVL;
  const int64_t left = io.n - s0;
  RmsLane<T> r;
  r.x = io.in[0] + s0;
  r.o = io.out + s0;
  r.nv = left <= 0 ? 0 : left < VVL ? (int)left : VVL;
  r.vec = io.n % VVL == 0 && vec_aligned<VVL>(io.in[0]) &&
          vec_aligned<VVL>(io.out);
  return r;
}

// Tiled, phase 1: thread `tid` (warp w, lane l) sums the squares of its
// tokens over the components w, w + RMS_WARPS, ... into red[w][l·VVL + i].
template <int VVL, class T>
__host__ __device__ __forceinline__ void rms_tiled_partial(const LmIOT<T>& io,
                                                           int64_t block,
                                                           int tid, float* red) {
  constexpr int U = rms_unroll<VVL>();
  const int w = tid / 32, lane = tid % 32;
  const RmsLane<T> L = rms_lane<VVL>(io, block, lane);
  float ss[VVL];
#pragma unroll
  for (int i = 0; i < VVL; ++i) ss[i] = 0.0f;
  if (L.nv > 0) {
    const int64_t stride = (int64_t)RMS_WARPS * io.n;
    const T* p = L.x + (int64_t)w * io.n;
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
template <int VVL, class T>
__host__ __device__ __forceinline__ void rms_tiled_combine(const LmIOT<T>& io, int tid,
                                                           const float* red,
                                                           float* inv) {
  if (tid >= 32 * VVL) return;
  float ss = 0.0f;
  for (int w = 0; w < RMS_WARPS; ++w) ss += red[w * 32 * VVL + tid];
  inv[tid] = rms_inv(ss, io);
}

// Tiled, phase 3: thread `tid` scales its tokens over its components.
template <int VVL, class T>
__host__ __device__ __forceinline__ void rms_tiled_scale(const LmIOT<T>& io,
                                                         int64_t block, int tid,
                                                         const float* inv) {
  constexpr int U = rms_unroll<VVL>();
  const int w = tid / 32, lane = tid % 32;
  const RmsLane<T> L = rms_lane<VVL>(io, block, lane);
  if (L.nv == 0) return;
  float iv[VVL];
#pragma unroll
  for (int i = 0; i < VVL; ++i) iv[i] = inv[lane * VVL + i];
  const int64_t stride = (int64_t)RMS_WARPS * io.n;
  const T* p = L.x + (int64_t)w * io.n;
  T* q = L.o + (int64_t)w * io.n;
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
template <class T>
__host__ __device__ __forceinline__ void rms_few_partial(const LmIOT<T>& io, int J,
                                                         int tid, float* red) {
  const int64_t nt = io.n * J, total = io.n * io.ncomp;
  const T* x = io.in[0];
  float ss = 0.0f;
  int64_t i = tid;
  for (; i + 3 * nt < total; i += 4 * nt) {
    float r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = ldg(x + i + k * nt);
#pragma unroll
    for (int k = 0; k < 4; ++k) ss += r[k] * r[k];
  }
  for (; i < total; i += nt) {
    const float r = ldg(x + i);
    ss += r * r;
  }
  red[tid] = ss;
}

// Few tokens, tree step h (J/2, ..., 1): thread j·n + s with j < h adds the
// partial of thread (j + h)·n + s.
template <class T>
__host__ __device__ __forceinline__ void rms_few_tree(const LmIOT<T>& io, int h,
                                                      int tid, float* red) {
  if (tid < h * io.n) red[tid] += red[tid + h * io.n];
}

// Few tokens, phase 3: thread `tid` scales the elements it summed; red[s]
// holds token s's sum of squares.
template <class T>
__host__ __device__ __forceinline__ void rms_few_scale(const LmIOT<T>& io, int J,
                                                       int tid, const float* red) {
  const int64_t nt = io.n * J, total = io.n * io.ncomp;
  const float inv = rms_inv(red[tid % io.n], io);
  int c = (int)(tid / io.n);
  for (int64_t i = tid; i < total; i += nt, c += J)
    store_f32(io.out + i, ldg(io.in[0] + i) * inv * (ldg(io.weight + c) + io.scale_offset));
}

// AoSoA rmsnorm (see the header): the tokens a block covers.
__host__ __device__ __forceinline__ int rms_aosoa_width(const AosoaMap& m) {
  return m.W < RMS_THREADS ? m.W : RMS_THREADS;
}

template <class T>
__host__ __device__ __forceinline__ int64_t rms_aosoa_blocks(const LmIOT<T>& io,
                                                             const AosoaMap& m) {
  const int wc = rms_aosoa_width(m);
  return (io.n + m.W - 1) / m.W * ((m.W + wc - 1) / wc);
}

// Thread `tid` of CUDA block `block`: its token's offset in x and out (-1
// when the thread has no live token) and its first component.
struct RmsAosoaThread {
  int64_t base;  // offset of component 0 of the token
  int g, G, wc;
};

template <class T>
__host__ __device__ __forceinline__ RmsAosoaThread rms_aosoa_thread(const LmIOT<T>& io,
                                                                    const AosoaMap& m,
                                                                    int64_t block,
                                                                    int tid) {
  RmsAosoaThread r;
  r.wc = rms_aosoa_width(m);
  r.G = RMS_THREADS / r.wc;
  r.g = tid / r.wc;
  const int64_t parts = (m.W + r.wc - 1) / r.wc;
  const int64_t b = block / parts;
  const int l = (int)(block % parts) * r.wc + tid % r.wc;
  const bool live = r.g < r.G && l < m.W && b * m.W + l < io.n;
  r.base = live ? b * io.ncomp * m.W + l : -1;
  return r;
}

// Phase 1: red[tid] = the sum of squares over components g, g + G, ...,
// in that order, rms_unroll<1>() rows loaded before they are added (as the
// tiled SoA kernel does at VVL 1).
template <class T>
__host__ __device__ __forceinline__ void rms_aosoa_partial(const LmIOT<T>& io,
                                                           const AosoaMap& m,
                                                           int64_t block, int tid,
                                                           float* red) {
  constexpr int U = rms_unroll<1>();
  const RmsAosoaThread r = rms_aosoa_thread(io, m, block, tid);
  float ss = 0.0f;
  if (r.base >= 0) {
    const int64_t step = (int64_t)r.G * m.W;
    const T* p = io.in[0] + r.base + (int64_t)r.g * m.W;
    int c = r.g;
    for (; c + (U - 1) * r.G < io.ncomp; c += U * r.G, p += U * step) {
      float v[U];
#pragma unroll
      for (int k = 0; k < U; ++k) v[k] = ldg(p + k * step);
#pragma unroll
      for (int k = 0; k < U; ++k) ss += v[k] * v[k];
    }
    for (; c < io.ncomp; c += r.G, p += step) {
      const float v = ldg(p);
      ss += v * v;
    }
  }
  red[tid] = ss;
}

// Phase 2: thread t < wc adds token t's partials in group order.
template <class T>
__host__ __device__ __forceinline__ void rms_aosoa_combine(const LmIOT<T>& io,
                                                           const AosoaMap& m, int tid,
                                                           const float* red,
                                                           float* inv) {
  const int wc = rms_aosoa_width(m);
  if (tid >= wc) return;
  float ss = 0.0f;
  for (int g = 0; g < RMS_THREADS / wc; ++g) ss += red[g * wc + tid];
  inv[tid] = rms_inv(ss, io);
}

// Phase 3: the thread scales its token over its components, each result
// rounded to the storage type once.
template <class T>
__host__ __device__ __forceinline__ void rms_aosoa_scale(const LmIOT<T>& io,
                                                         const AosoaMap& m,
                                                         int64_t block, int tid,
                                                         const float* inv) {
  constexpr int U = rms_unroll<1>();
  const RmsAosoaThread r = rms_aosoa_thread(io, m, block, tid);
  if (r.base < 0) return;
  const float iv = inv[tid % r.wc];
  const int64_t step = (int64_t)r.G * m.W;
  int64_t i = r.base + (int64_t)r.g * m.W;
  int c = r.g;
  for (; c + (U - 1) * r.G < io.ncomp; c += U * r.G, i += U * step) {
    float v[U], wt[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      v[k] = ldg(io.in[0] + i + k * step);
      wt[k] = ldg(io.weight + c + k * r.G) + io.scale_offset;
    }
#pragma unroll
    for (int k = 0; k < U; ++k) store_f32(io.out + i + k * step, v[k] * iv * wt[k]);
  }
  for (; c < io.ncomp; c += r.G, i += step)
    store_f32(io.out + i, ldg(io.in[0] + i) * iv * (ldg(io.weight + c) + io.scale_offset));
}

// ---------------------------------------------------------------------------
// mamba: the selective scan, site = channel, a channel's states over lanes
// ---------------------------------------------------------------------------

// d_state not instantiated (8 and 16 are): the mamba entry's return code
constexpr int ERR_BAD_NSTATE = -5;

constexpr int MAMBA_LANES = 4;       // lanes sharing one channel's N states
constexpr int MAMBA_ROUNDS = 2;      // shuffle rounds over them: log2(MAMBA_LANES)
constexpr int MAMBA_THREADS = 128;   // threads of a block
constexpr int MAMBA_GROUPS = MAMBA_THREADS / MAMBA_LANES;  // lane groups
constexpr int MAMBA_TILE = 1024;     // values of x (and of dt) a chunk stages
constexpr float MAMBA_LOG2E = 1.4426950408889634f;
constexpr int MAMBA_AOSOA_VVL = 2;    // channels of a lane group under AoSoA
constexpr int MAMBA_AOSOA_ALIGN = 4;  // W must be a multiple of it

// Operands of one mamba launch: `rows` batch rows, row r's operands at
// r·L·n (x, dt, y), r·L·N (b, c) and r·N·n (h) elements from the pointers.
// x, dt, b, c and y in storage type T; a, d and h float32.
template <class T>
struct MambaIOT {
  const T* x;       // (rows·L, n)
  const T* dt;      // (rows·L, n)
  const float* a;   // (N, n)
  const float* d;   // (1, n)
  const T* b;       // (rows·L, N)
  const T* c;       // (rows·L, N)
  T* y;             // (rows·L, n)
  float* h;         // (rows·N, n): each row's state after its last step
  int64_t L, n;
  int rows;
  AosoaMap map;     // the AoSoA launch's blocks (unused under SoA)
};

// Offset of component k (of K) of channel ch in a field: SoA k·n + ch, AoSoA
// the index map.
template <bool AOSOA, class T>
__host__ __device__ __forceinline__ int64_t mamba_at(const MambaIOT<T>& io, int64_t K,
                                                     int64_t k, int64_t ch) {
  if constexpr (AOSOA) return aosoa_index(io.map, (int)ch, (int)K, (int)k);
  return k * io.n + ch;
}

// The site function's tag for dispatch_mamba: d_state N.
template <int N>
struct MambaSite {
  static constexpr int kN = N;
};

// A block's tile: C channels, T steps a chunk; one stage of shared memory
// holds x[T][C], dt[T][C], b[T][N] and c[T][N] from element X, DT, B, CC
// (elements of the storage type: float32 or bfloat16, staged as stored).
template <int N, int VVL>
struct MambaTile {
  static constexpr int S = N / MAMBA_LANES;     // states of a lane
  static constexpr int C = MAMBA_GROUPS * VVL;  // channels of a block
  static constexpr int T = MAMBA_TILE / C;      // steps of a chunk
  static constexpr int X = 0, DT = T * C, B = 2 * T * C, CC = 2 * T * C + T * N;
  static constexpr int ELEMS = 2 * T * C + 2 * T * N;  // one stage
};

// Lane g of a group holds states mamba_state(g, 0 .. S-1) of its channels.
template <int N>
__host__ __device__ constexpr int mamba_state(int g, int s) {
  return g * (N / MAMBA_LANES) + s;
}

// Channel slot v of lane group j in block blk: the block's VVL·32 channels
// are interleaved, so a warp's 8 groups read 8 neighbouring floats of x.
__host__ __device__ __forceinline__ int mamba_slot(int j, int v) {
  return v * MAMBA_GROUPS + j;
}

// Shuffle round r of the sum of y over a group's lanes: xor 1, then xor 2.
__host__ __device__ constexpr int mamba_xor(int r) { return 1 << r; }

template <int N, int VVL>
__host__ __device__ __forceinline__ int64_t mamba_blocks(int64_t n) {
  return (n + MambaTile<N, VVL>::C - 1) / MambaTile<N, VVL>::C;
}

template <int N, int VVL>
__host__ __device__ __forceinline__ int64_t mamba_chunks(int64_t L) {
  return (L + MambaTile<N, VVL>::T - 1) / MambaTile<N, VVL>::T;
}

// What a lane keeps in registers over the whole scan.
template <int N, int VVL>
struct MambaLane {
  static constexpr int S = MambaTile<N, VVL>::S;
  float h[VVL][S];   // the states
  float a2[VVL][S];  // a·log2(e): the decay exp(dt·a) is exp2(dt·a2)
  float d[VVL];
  int64_t y0[VVL];   // AoSoA: offset of step 0 of the slot's channel in y
};

// exp2 by one MUFU.EX2 on the card (ex2.approx, ~2 ulp); exp2f on the host.
__host__ __device__ __forceinline__ float fast_exp2(float x) {
#if defined(__CUDA_ARCH__)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return exp2f(x);
#endif
}

template <int N, int VVL, bool AOSOA = false, class T>
__host__ __device__ __forceinline__ void mamba_lane_init(const MambaIOT<T>& io,
                                                         int64_t blk, int tid,
                                                         MambaLane<N, VVL>& ln) {
  constexpr int S = MambaTile<N, VVL>::S;
  const int j = tid / MAMBA_LANES, g = tid % MAMBA_LANES;
#pragma unroll
  for (int v = 0; v < VVL; ++v) {
    const int64_t ch = blk * MambaTile<N, VVL>::C + mamba_slot(j, v);
    const bool live = ch < io.n;
    ln.d[v] = live ? ldg(io.d + mamba_at<AOSOA>(io, 1, 0, ch)) : 0.0f;
    ln.y0[v] = AOSOA && live ? mamba_at<AOSOA>(io, (int64_t)io.rows * io.L, 0, ch) : 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ln.h[v][s] = 0.0f;
      ln.a2[v][s] =
          live ? ldg(io.a + mamba_at<AOSOA>(io, N, mamba_state<N>(g, s), ch)) * MAMBA_LOG2E
               : 0.0f;
    }
  }
}

// One element of the stage: a 4-byte cp.async for float32; for bfloat16 an
// ordinary load and store (cp.async copies 4, 8 or 16 bytes), the unaligned
// fallback only.
__host__ __device__ __forceinline__ void mamba_copy1(float* dst, const float* src) {
  copy4(dst, src);
}
__host__ __device__ __forceinline__ void mamba_copy1(bf16* dst, const bf16* src) {
  *dst = *src;
}

// MAMBA_AOSOA_ALIGN = 4 channels of an AoSoA block in one cp.async: 16 bytes
// of float32, 8 of bfloat16; `p` aligned to that size.
__host__ __device__ __forceinline__ void mamba_copy_group(float* dst, const float* src) {
  copy16(dst, src);
}
__host__ __device__ __forceinline__ void mamba_copy_group(bf16* dst, const bf16* src) {
  copy8(dst, src);
}
template <class T>
__host__ __device__ __forceinline__ bool mamba_group_aligned(const T* p) {
  return ((uintptr_t)p & (MAMBA_AOSOA_ALIGN * sizeof(T) - 1)) == 0;
}

// Thread `tid` copies its share of chunk q of row `row` into the stage at
// buf, in the storage type: the chunk's live steps of x and dt over the
// block's live channels (16-byte copies of E = 16 / sizeof(T) channels where
// n % E == 0 and x, dt are 16-byte aligned, else one element at a time), and
// of b and c, T·N contiguous elements each (16-byte copies where b and c are
// aligned: a row of N >= 8 is a whole number of them).  Slots past the
// ragged last block or chunk are left as they were: no live lane reads them.
// Under AoSoA the x and dt copies go through the index map, a group of
// MAMBA_AOSOA_ALIGN = 4 channels a copy (16 bytes of float32, 8 of
// bfloat16), which W % 4 == 0 keeps inside one block; one element at a time
// where x or dt is not aligned to a group.
template <int N, int VVL, bool AOSOA = false, class T>
__host__ __device__ __forceinline__ void mamba_stage(const MambaIOT<T>& io, int row,
                                                     int64_t blk, int64_t q, int tid,
                                                     T* buf) {
  using Tl = MambaTile<N, VVL>;
  constexpr int E = 16 / (int)sizeof(T);  // elements of a 16-byte copy
  static_assert(N % E == 0, "a b/c row is whole 16-byte copies");
  const int64_t t0 = q * Tl::T;
  const int steps = io.L - t0 < Tl::T ? (int)(io.L - t0) : Tl::T;
  const int64_t c0 = blk * Tl::C;
  const int cl = io.n - c0 < Tl::C ? (int)(io.n - c0) : Tl::C;
  const int64_t base = ((int64_t)row * io.L + t0) * io.n + c0;
  if constexpr (AOSOA) {
    const int64_t K = (int64_t)io.rows * io.L, k0 = (int64_t)row * io.L + t0;
    const bool vec = mamba_group_aligned(io.x) && mamba_group_aligned(io.dt);
    const int width = vec ? MAMBA_AOSOA_ALIGN : 1;
    const int CW = Tl::C / width;
    for (int i = tid; i < steps * CW; i += MAMBA_THREADS) {
      const int t = i / CW, c = width * (i % CW);
      if (c >= cl) continue;
      const int64_t off = mamba_at<true>(io, K, k0 + t, c0 + c);
      if (vec) {
        mamba_copy_group(buf + Tl::X + t * Tl::C + c, io.x + off);
        mamba_copy_group(buf + Tl::DT + t * Tl::C + c, io.dt + off);
      } else {
        mamba_copy1(buf + Tl::X + t * Tl::C + c, io.x + off);
        mamba_copy1(buf + Tl::DT + t * Tl::C + c, io.dt + off);
      }
    }
  } else if (io.n % E == 0 && aligned16(io.x) && aligned16(io.dt)) {
    constexpr int CE = Tl::C / E;
    for (int i = tid; i < steps * CE; i += MAMBA_THREADS) {
      const int t = i / CE, c = E * (i % CE);
      if (c >= cl) continue;
      copy16(buf + Tl::X + t * Tl::C + c, io.x + base + t * io.n + c);
      copy16(buf + Tl::DT + t * Tl::C + c, io.dt + base + t * io.n + c);
    }
  } else {
    for (int i = tid; i < steps * Tl::C; i += MAMBA_THREADS) {
      const int t = i / Tl::C, c = i % Tl::C;
      if (c >= cl) continue;
      mamba_copy1(buf + Tl::X + i, io.x + base + t * io.n + c);
      mamba_copy1(buf + Tl::DT + i, io.dt + base + t * io.n + c);
    }
  }
  const int64_t bbase = ((int64_t)row * io.L + t0) * N;
  const int nb = steps * N;
  if (aligned16(io.b) && aligned16(io.c)) {
    for (int i = E * tid; i < nb; i += E * MAMBA_THREADS) {
      copy16(buf + Tl::B + i, io.b + bbase + i);
      copy16(buf + Tl::CC + i, io.c + bbase + i);
    }
  } else {
    for (int i = tid; i < nb; i += MAMBA_THREADS) {
      mamba_copy1(buf + Tl::B + i, io.b + bbase + i);
      mamba_copy1(buf + Tl::CC + i, io.c + bbase + i);
    }
  }
}

// Step s of the staged chunk, channel slot v: lane (j, g) advances its S
// states, h = h·exp(dt·a) + (dt·x)·b — the plain body's order
// (kernels/lm.py:mamba_site) — and returns its share of y, Σ h·c over its
// states in state order.
template <int N, int VVL, class T>
__host__ __device__ __forceinline__ float mamba_partial(const T* buf, int s,
                                                        int v, int tid,
                                                        MambaLane<N, VVL>& ln) {
  using Tl = MambaTile<N, VVL>;
  constexpr int S = Tl::S;
  const int j = tid / MAMBA_LANES, g = tid % MAMBA_LANES;
  const int slot = s * Tl::C + mamba_slot(j, v);
  const float xv = to_f32(buf[Tl::X + slot]), dtv = to_f32(buf[Tl::DT + slot]);
  const float dx = dtv * xv;
  float bt[S], ct[S];
  ld_shared<S>(buf + Tl::B + s * N + mamba_state<N>(g, 0), bt);
  ld_shared<S>(buf + Tl::CC + s * N + mamba_state<N>(g, 0), ct);
  float p = 0.0f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    ln.h[v][k] = fmaf(ln.h[v][k], fast_exp2(dtv * ln.a2[v][k]), dx * bt[k]);
    p = fmaf(ln.h[v][k], ct[k], p);
  }
  return p;
}

// y of step s (chunk q), slot v, from the group's summed share: the group's
// lane 0 writes y = Σ_k h·c + d·x for a live channel.
template <int N, int VVL, bool AOSOA = false, class T>
__host__ __device__ __forceinline__ void mamba_out(const MambaIOT<T>& io, const T* buf,
                                                   int row, int64_t blk, int64_t q,
                                                   int s, int v, int tid,
                                                   const MambaLane<N, VVL>& ln,
                                                   float sum) {
  using Tl = MambaTile<N, VVL>;
  const int j = tid / MAMBA_LANES;
  const int64_t ch = blk * Tl::C + mamba_slot(j, v);
  if (tid % MAMBA_LANES != 0 || ch >= io.n) return;
  const float xv = to_f32(buf[Tl::X + s * Tl::C + mamba_slot(j, v)]);
  const int64_t k = (int64_t)row * io.L + q * Tl::T + s;
  // AoSoA: step k of the channel lies k·W past its step 0; y rounded to the
  // storage type once
  store_f32(io.y + (AOSOA ? ln.y0[v] + k * io.map.W : k * io.n + ch), sum + ln.d[v] * xv);
}

// The final state of each live channel's states.
template <int N, int VVL, bool AOSOA = false, class T>
__host__ __device__ __forceinline__ void mamba_final(const MambaIOT<T>& io, int row,
                                                     int64_t blk, int tid,
                                                     const MambaLane<N, VVL>& ln) {
  constexpr int S = MambaTile<N, VVL>::S;
  const int j = tid / MAMBA_LANES, g = tid % MAMBA_LANES;
#pragma unroll
  for (int v = 0; v < VVL; ++v) {
    const int64_t ch = blk * MambaTile<N, VVL>::C + mamba_slot(j, v);
    if (ch >= io.n) continue;
#pragma unroll
    for (int s = 0; s < S; ++s)
      io.h[mamba_at<AOSOA>(io, (int64_t)io.rows * N, (int64_t)row * N + mamba_state<N>(g, s),
                           ch)] = ln.h[v][s];
  }
}

// ---------------------------------------------------------------------------
// host-side dispatch: (site id, act id, VVL) -> Launch<Site, VVL>::run(io, stream)
// ---------------------------------------------------------------------------

template <template <class, int> class Launch, template <int> class Site, class IO>
int dispatch_act(int act_id, int vvl, const IO& io, void* stream) {
  switch (act_id) {
    case ACT_SILU: return tdp::dispatch_vvl<Launch, Site<ACT_SILU>>(vvl, io, stream);
    case ACT_GELU_TANH: return tdp::dispatch_vvl<Launch, Site<ACT_GELU_TANH>>(vvl, io, stream);
    case ACT_RELU2: return tdp::dispatch_vvl<Launch, Site<ACT_RELU2>>(vvl, io, stream);
    default: return tdp::ERR_BAD_SITE;
  }
}

// (d_state, VVL) -> Launch<MambaSite<N>, VVL>::run(io, stream), io in either
// storage type
template <template <class, int> class Launch, class IO>
int dispatch_mamba(int nstate, int vvl, const IO& io, void* stream) {
  switch (nstate) {
    case 8: return tdp::dispatch_vvl<Launch, MambaSite<8>>(vvl, io, stream);
    case 16: return tdp::dispatch_vvl<Launch, MambaSite<16>>(vvl, io, stream);
    default: return ERR_BAD_NSTATE;
  }
}

// (d_state) -> Launch<MambaSite<N>>::run(io, stream): the AoSoA scan, io in
// either storage type
template <template <class> class Launch, class IO>
int dispatch_mamba_aosoa(int nstate, const IO& io, void* stream) {
  switch (nstate) {
    case 8: return Launch<MambaSite<8>>::run(io, stream);
    case 16: return Launch<MambaSite<16>>::run(io, stream);
    default: return ERR_BAD_NSTATE;
  }
}

template <template <class, int> class Launch, class IO>
int dispatch_site(int site, int act_id, int vvl, const IO& io, void* stream) {
  switch (site) {
    case SITE_RMSNORM: return tdp::dispatch_vvl<Launch, RmsnormSite>(vvl, io, stream);
    case SITE_GATED: return dispatch_act<Launch, GatedSite>(act_id, vvl, io, stream);
    case SITE_ACT: return dispatch_act<Launch, ActSite>(act_id, vvl, io, stream);
    default: return tdp::ERR_BAD_SITE;
  }
}

}  // namespace lm
}  // namespace tdp
