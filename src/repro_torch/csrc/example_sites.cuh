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
// component of each.  VVL is the width of the thread's accesses: one
// float2 per component row at VVL 2, one float4 at VVL 4, two at VVL 8
// (load_row / store_row, lb_sites.cuh), where every operand's rows start
// on a VVL-float boundary (example_vec: n a multiple of VVL, pointers
// aligned), chosen once per launch; VVL scalars otherwise, the ragged end
// (s >= n) masked, nothing padded.  At VVL 1, whose accesses are scalars, a
// thread of a one-operand site function takes two groups, sites t and t +
// T (T the threads of the launch, a grid-strided second site), so that it
// keeps twice the loads in flight (example_groups).  A thread holds EX_CG
// components at a time and issues every load of them (every component,
// every site it owns) before its first store, so the loads are in flight
// together.  Site indices are 32-bit (the wrapper refuses n >= 2^31); a
// thread's first site and a component's base offset c·n are computed in
// 64 bits.  A site function gets each site's global index s, the
// counterpart of `base + iota` in the Pallas executor
// (src/repro/kernels/tdp_pointwise.py:122-125).
//
// AoSoA (Target(layout="aosoa"), example_aosoa_thread): x, y' and out are
// blocks of W sites, (ceil(n / W), ncomp, W), site s of component c at
// tdp::aosoa_index (lb_sites.cuh).  Where W is a multiple of 32 and the
// operands are 16-byte aligned (example_aosoa_lanes), thread t takes the 4
// consecutive lanes of sites 4t ... 4t + 3, one float4 per component;
// otherwise site t.  Loads before stores as above; site_pos gets the SoA
// index; the pad lanes (s >= n) are neither read nor written.
//
// The reduce (reduce_thread, block_combine, final_thread; launched by
// tdp_gathered_example_reduce_launch): the site function mapped and
// reduced over the sites in one pass, writing only the (ncomp,) result.
// Block (b, gy) takes the components gy·EX_CG ... of group gy; its thread
// gtid = b·EX_BLOCK + tid the VVL-site groups gtid + i·T, T the threads of
// a group's grid (more than one group a thread: the grid is one resident
// wave), EX_RED_SITES sites of each component loaded a round before any is
// added.  Each thread keeps a partial per component in registers, sites
// past n contributing the op's identity; the warps combine by shuffles
// (red_xor), the block's warps in warp order in shared memory, the blocks'
// partials in block order in the last block to finish (a counter).  Every
// order is fixed by n, ncomp and the grid, so a call gives the same bits
// every time; there are no floating-point atomics.  The sum accumulates in
// double and rounds once, at the end.
//
// The arithmetic is rounded as the plain version's is: saxpy's a·x and + y
// are two roundings (__fmul_rn, __fadd_rn: no FMA contraction), so every
// site function is bit-equal to its plain body.  Everything a thread runs
// is __host__ __device__, so the tests run it with the host compiler.
//
// bfloat16 (ExampleIOT<tdp::bf16>, the SoA launch and the reduce): the
// same site functions on tdp::rbf values (bf16.cuh), as the reference's
// Pallas bodies compute in bfloat16: `a` rounded to bfloat16 (by the host:
// a weak scalar), each * and + rounded (saxpy twice), site_pos's int32
// index converted to float32 and then to bfloat16 before the add (PyTorch's
// conversion); a row of VVL bfloat16 values moves as one 4-, 8- or 16-byte
// access.  The reduce accumulates as in float32 (double for the sum) and
// rounds the result to bfloat16 once.  The AoSoA launch takes float32 only.
#pragma once

#include <math.h>

#include <cstdint>

#include "lb_sites.cuh"  // tdp::ldg, load_row, store_row, ERR_*, dispatch_vvl

namespace tdp {
namespace ex {

enum SiteId : int { SITE_SCALE = 0, SITE_SAXPY = 1, SITE_SITE_POS = 2 };
enum ReduceOpId : int { RED_SUM = 0, RED_MAX = 1, RED_MIN = 2 };

constexpr int EX_BLOCK = 256;                  // threads of a block, every launch
constexpr int EX_WARPS = EX_BLOCK / 32;
constexpr int EX_CG = 4;                       // components a thread holds at once
constexpr int EX_RED_SITES = 8;                // sites of a component a reduce round loads
constexpr int EX_RED_MAX_BLOCKS = 1024;        // reduce blocks per component group, at most

// Operands of one launch: x is in[0], y' (saxpy) is in[1]; out is (ncomp, n)
// (the (ncomp,) result of a reduce), all of storage type T.  vec: the
// vector path, set by the launcher.
template <class T>
struct ExampleIOT {
  const T* in[2];
  T* out;
  int n;
  int ncomp;
  float a;
  bool vec;
};
using ExampleIO = ExampleIOT<float>;

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

// bfloat16: each operation rounded (bf16.cuh)
__host__ __device__ __forceinline__ rbf mul_rn(rbf a, rbf b) { return a * b; }
__host__ __device__ __forceinline__ rbf add_rn(rbf a, rbf b) { return a + b; }

struct ScaleSite {
  static constexpr bool kTwo = false;
  template <class V>
  __host__ __device__ static V at(V x, V, V a, int) {
    return mul_rn(a, x);
  }
};

struct SaxpySite {
  static constexpr bool kTwo = true;
  template <class V>
  __host__ __device__ static V at(V x, V y, V a, int) {
    return add_rn(mul_rn(a, x), y);
  }
};

struct SitePosSite {
  static constexpr bool kTwo = false;
  template <class V>
  __host__ __device__ static V at(V x, V, V, int s) {
    // int -> float rounds to nearest, as torch; in bfloat16 then to
    // bfloat16 (V's constructor), as torch converts it
    return add_rn(x, V((float)s));
  }
};

// VVL-site groups a thread takes: two (groups t and t + T, T the threads
// of the launch) for a one-operand site function at VVL 1, whose scalar
// accesses would keep only EX_CG loads in flight; one otherwise (on an
// H100, two made scale 6 % faster at VVL 1 and saxpy 1 % slower).
template <class Site, int VVL>
__host__ __device__ constexpr int example_groups() {
  return VVL == 1 && !Site::kTwo ? 2 : 1;
}

template <class Site, int VVL, class T>
__host__ __device__ __forceinline__ int64_t example_threads(const ExampleIOT<T>& io) {
  constexpr int G = example_groups<Site, VVL>();
  return (((int64_t)io.n + VVL - 1) / VVL + G - 1) / G;
}

// The vector path: every operand's component rows start on a VVL-float
// boundary (a null operand passes).
template <int VVL, class T>
__host__ __device__ __forceinline__ bool example_vec(const ExampleIOT<T>& io) {
  return io.n % VVL == 0 && vec_aligned<VVL, T>(io.in[0]) &&
         vec_aligned<VVL, T>(io.in[1]) && vec_aligned<VVL, T>(io.out);
}

// Thread t: sites t·VVL ... t·VVL + VVL - 1 (and site t + T where it takes
// two groups), each component.
template <class Site, int VVL, class S>
__host__ __device__ __forceinline__ void example_thread(const ExampleIOT<S>& io,
                                                        int64_t t) {
  using V = value_t<S>;
  constexpr int G = example_groups<Site, VVL>();
  const int64_t T = example_threads<Site, VVL>(io);
  if (t >= T) return;
  const V a = io.a;
  int64_t s0[G];
  int nv[G];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    s0[u] = (t + u * T) * VVL;
    nv[u] = s0[u] >= io.n ? 0 : io.n - s0[u] < VVL ? (int)(io.n - s0[u]) : VVL;
  }
  for (int c0 = 0; c0 < io.ncomp; c0 += EX_CG) {
    V x[EX_CG][G][VVL], y[EX_CG][G][VVL];
#pragma unroll
    for (int k = 0; k < EX_CG; ++k) {
      if (c0 + k >= io.ncomp) break;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (u > 0 && nv[u] == 0) continue;  // t < T: group 0 has sites
        const int64_t off = (int64_t)(c0 + k) * io.n + s0[u];
        load_row<VVL>(io.in[0] + off, io.vec, nv[u], x[k][u]);
        if (Site::kTwo) load_row<VVL>(io.in[1] + off, io.vec, nv[u], y[k][u]);
      }
    }
#pragma unroll
    for (int k = 0; k < EX_CG; ++k) {
      if (c0 + k >= io.ncomp) break;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (u > 0 && nv[u] == 0) continue;  // t < T: group 0 has sites
        V r[VVL];
#pragma unroll
        for (int v = 0; v < VVL; ++v)
          r[v] = Site::at(x[k][u][v], Site::kTwo ? y[k][u][v] : V(0.0f), a,
                          (int)(s0[u] + v));
        store_row<VVL>(io.out + (int64_t)(c0 + k) * io.n + s0[u], io.vec, nv[u], r);
      }
    }
  }
}

// Operands of one AoSoA launch.
struct ExampleAosoaIO {
  ExampleIO io;
  AosoaMap map;
};

// The AoSoA launch's lanes a thread: 4 (one float4 per component) where W
// is a multiple of 32, so that a block's component row is whole 128-byte
// lines, and the operands are 16-byte aligned; 1 otherwise.  (On an H100
// at W 8, 4 lanes a thread ran 2.2x slower than one: a warp's float4
// access then spans 16 rows of 32 bytes.)
__host__ __device__ __forceinline__ int example_aosoa_lanes(const ExampleAosoaIO& a) {
  return a.map.W % 32 == 0 && vec_aligned<4>(a.io.in[0]) &&
                 vec_aligned<4>(a.io.in[1]) && vec_aligned<4>(a.io.out)
             ? 4
             : 1;
}

// Thread t: sites t·L ... t·L + L - 1 (lanes of one block), each component.
template <class Site, int L>
__host__ __device__ __forceinline__ void example_aosoa_thread(const ExampleAosoaIO& a,
                                                              int64_t t) {
  const ExampleIO& io = a.io;
  const int64_t s0 = t * L;
  if (s0 >= io.n) return;
  const int nv = io.n - s0 < L ? (int)(io.n - s0) : L;
  for (int c0 = 0; c0 < io.ncomp; c0 += EX_CG) {
    float x[EX_CG][L], y[EX_CG][L];
#pragma unroll
    for (int k = 0; k < EX_CG; ++k) {
      if (c0 + k >= io.ncomp) break;
      const int64_t i = aosoa_index(a.map, (int)s0, io.ncomp, c0 + k);
      load_row<L>(io.in[0] + i, nv == L, nv, x[k]);
      if (Site::kTwo) load_row<L>(io.in[1] + i, nv == L, nv, y[k]);
    }
#pragma unroll
    for (int k = 0; k < EX_CG; ++k) {
      if (c0 + k >= io.ncomp) break;
      float r[L];
#pragma unroll
      for (int l = 0; l < L; ++l)
        r[l] = Site::at(x[k][l], Site::kTwo ? y[k][l] : 0.0f, io.a, (int)(s0 + l));
      store_row<L>(io.out + aosoa_index(a.map, (int)s0, io.ncomp, c0 + k), nv == L, nv, r);
    }
  }
}

// ---------------------------------------------------------------------------
// the reduce: the site function mapped and reduced in one pass
// ---------------------------------------------------------------------------

// Each op: its accumulator type, the identity every site past n
// contributes, and the combine.  max and min propagate NaN, as torch.amax
// and amin do.
struct SumOp {
  using T = double;
  __host__ __device__ static T identity() { return 0.0; }
  __host__ __device__ static T f(T a, T b) { return a + b; }
};

struct MaxOp {
  using T = float;
  __host__ __device__ static T identity() { return -INFINITY; }
  __host__ __device__ static T f(T a, T b) { return (a > b || a != a) ? a : b; }
};

struct MinOp {
  using T = float;
  __host__ __device__ static T identity() { return INFINITY; }
  __host__ __device__ static T f(T a, T b) { return (a < b || a != a) ? a : b; }
};

// Operands of one reduce launch: io.out is the (ncomp,) result.
template <class T>
struct ReduceIOT {
  ExampleIOT<T> io;
  double* partial;  // (ncomp, blocks): each block's partial of its components
  unsigned* count;  // blocks done: 0 before a launch, 0 again after it
  int blocks;       // blocks per component group (gridDim.x)
  int op;           // ReduceOpId
};
using ReduceIO = ReduceIOT<float>;

__host__ __device__ __forceinline__ int reduce_groups(int ncomp) {
  return (ncomp + EX_CG - 1) / EX_CG;
}

// VVL-site groups of a component a thread loads in one round.
template <int VVL>
__host__ __device__ constexpr int reduce_unroll() {
  return VVL >= EX_RED_SITES ? 1 : EX_RED_SITES / VVL;
}

// Blocks per component group: enough for one round of every thread, at
// most `resident` blocks in all (one wave) and EX_RED_MAX_BLOCKS a group.
template <int VVL>
__host__ __device__ __forceinline__ int reduce_blocks(int n, int ncomp, int resident) {
  const int64_t groups = ((int64_t)n + VVL - 1) / VVL;
  const int64_t per_block = (int64_t)EX_BLOCK * reduce_unroll<VVL>();
  int64_t most = resident / reduce_groups(ncomp);
  most = most < 1 ? 1 : most > EX_RED_MAX_BLOCKS ? EX_RED_MAX_BLOCKS : most;
  const int64_t want = (groups + per_block - 1) / per_block;
  return (int)(want < 1 ? 1 : want > most ? most : want);
}

// The shuffle rounds: in round i (0 ... 4) lane l combines its value with
// that of lane l ^ red_xor(i) of the round before.
__host__ __device__ constexpr int red_xor(int i) { return 16 >> i; }

// Thread tid of block (b, gy): its partial of each component of group gy.
template <class Site, class Op, int VVL, class S>
__host__ __device__ __forceinline__ void reduce_thread(const ReduceIOT<S>& r, int b, int gy,
                                                       int tid,
                                                       typename Op::T (&acc)[EX_CG]) {
  using V = value_t<S>;
  constexpr int U = reduce_unroll<VVL>();
  const ExampleIOT<S>& io = r.io;
  const V a = io.a;
  const int c0 = gy * EX_CG;
  const int64_t stride = (int64_t)r.blocks * EX_BLOCK;
  const int64_t ng = ((int64_t)io.n + VVL - 1) / VVL;
#pragma unroll
  for (int k = 0; k < EX_CG; ++k) acc[k] = Op::identity();
  for (int64_t g0 = (int64_t)b * EX_BLOCK + tid; g0 < ng; g0 += U * stride) {
    V x[EX_CG][U][VVL], y[EX_CG][U][VVL];
#pragma unroll
    for (int k = 0; k < EX_CG; ++k) {
      if (c0 + k >= io.ncomp) break;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int64_t s0 = (g0 + j * stride) * VVL;
        const int nv = s0 >= io.n ? 0 : io.n - s0 < VVL ? (int)(io.n - s0) : VVL;
        const int64_t off = (int64_t)(c0 + k) * io.n + s0;
        load_row<VVL>(io.in[0] + off, io.vec && nv > 0, nv, x[k][j]);
        if (Site::kTwo) load_row<VVL>(io.in[1] + off, io.vec && nv > 0, nv, y[k][j]);
      }
    }
#pragma unroll
    for (int k = 0; k < EX_CG; ++k) {
      if (c0 + k >= io.ncomp) break;
#pragma unroll
      for (int j = 0; j < U; ++j) {
#pragma unroll
        for (int v = 0; v < VVL; ++v) {
          const int64_t s = (g0 + j * stride) * VVL + v;
          if (s < io.n)
            acc[k] = Op::f(acc[k], (typename Op::T)value_f32(Site::at(
                                       x[k][j][v], Site::kTwo ? y[k][j][v] : V(0.0f),
                                       a, (int)s)));
        }
      }
    }
  }
}

// The block's value of component k: its warps' values (red[k·EX_WARPS +
// w], lane 0's after the shuffles) in warp order.
template <class Op>
__host__ __device__ __forceinline__ typename Op::T block_combine(const typename Op::T* red,
                                                                 int k) {
  typename Op::T v = red[k * EX_WARPS];
  for (int w = 1; w < EX_WARPS; ++w) v = Op::f(v, red[k * EX_WARPS + w]);
  return v;
}

// A partial the other blocks wrote: read from L2, past this SM's L1.
__host__ __device__ __forceinline__ double ld_partial(const double* p) {
#if defined(__CUDA_ARCH__)
  return __ldcg(p);
#else
  return *p;
#endif
}

// Thread tid of the last block: the blocks' partials of component c, blocks
// tid, tid + EX_BLOCK, ... in that order.
template <class Op, class S>
__host__ __device__ __forceinline__ typename Op::T final_thread(const ReduceIOT<S>& r, int c,
                                                                int tid) {
  typename Op::T v = Op::identity();
  for (int b = tid; b < r.blocks; b += EX_BLOCK)
    v = Op::f(v, (typename Op::T)ld_partial(r.partial + (int64_t)c * r.blocks + b));
  return v;
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

// (op id) -> Launch<Site, VVL>::template go<Op>(r, stream), for the reduce
template <class Launch, class S>
int dispatch_op(const ReduceIOT<S>& r, void* stream) {
  switch (r.op) {
    case RED_SUM: return Launch::template go<SumOp>(r, stream);
    case RED_MAX: return Launch::template go<MaxOp>(r, stream);
    case RED_MIN: return Launch::template go<MinOp>(r, stream);
    default: return ERR_BAD_OP;
  }
}

}  // namespace ex
}  // namespace tdp
