// lb_sites.cuh — the D3Q19 binary-fluid site functions, written once.
//
// The seven lattice-Boltzmann site functions of repro_torch/lb/stencil.py
// (stream, grad6, moment, collide, fused, phi_stream, fused_two) as
// templates over a *neighbour accessor*: a site function reads
// nb.at(field, slot, comp, lane) and writes nb.put(out, comp, lane, value),
// and never sees the memory layout.  One accessor, FieldNb, serves both
// launchers: a stencil field is the caller's own (ncomp, X+2hx, Y+2hy,
// Z+2hz) array, read in place; a dimension with no ghost planes (h == 0)
// wraps periodically inside the accessor, one with h > 0 reads the
// caller's ghost planes.  No neighbour stack and no padded copy exists.
//
//   tdp_gathered.cu  every site function, one thread per VVL z-sites;
//   tdp_windowed.cu  the stencil site functions the same way, except
//                    `fused`, which runs in shared-memory tiles
//                    (fused_tile_phi / fused_tile_collide below).
//
// Both also run an ensemble of B members in one launch (a fleet's stage):
// member_io() below turns member blockIdx.y of an EnsembleIO into a
// FieldIO, and the same bodies run on it.
//
// lb_collision.cu runs collide_core() over plain SoA arrays.
//
// One thread covers VVL consecutive sites (the paper's TARGET_TLP strip,
// TARGET_ILP lanes); the per-thread body field_thread() and the tile phases
// are __host__ __device__, so the same code runs in a host loop for testing
// on a machine without a card.
//
// The velocity set, weights and stencil slot tables are compile-time, so
// products with c = 0 and c = ±1 fold away.  Arithmetic keeps the plain
// version's association order (cu*cu, phi*phi*phi, ascending-q phi sums,
// the grad6 Laplacian order); FMA contraction still changes rounding, so
// the card is held to tolerances, not to bit-identity.  Component strides
// are 64-bit.
//
// Two arithmetics, one body: every site function is a template over its
// values V, float for float32 fields and tdp::rbf (bf16.cuh) for bfloat16
// ones, the storage type T of FieldIOT<T>.  In bfloat16 each operation
// rounds as the reference's body does op by op (src/repro/kernels/
// lb_collision.py:57-100, src/repro/lb/stencil.py:110-197): every +, -, *,
// / rounded to bfloat16, no FMA; the sums the reference takes with jnp.sum
// and its two contractions with c (rho, the momentum, c·u, c·F, u·u, u·F,
// the gt sum, moment's phi) accumulated in float32 and rounded once
// (sum_add / sum_end); the ascending-q phi of fused and phi_stream rounded
// at every add, as the reference's `acc = acc + ...` is; the weights and
// the literals rounded to bfloat16, the physics scalars by the host
// (Phys).  So the bfloat16 kernels are bit-equal to the port's plain
// bfloat16 versions.  In float32 V is float and the code is the float32
// arithmetic it always was.  The AoSoA and ensemble launchers take float32
// only.
#pragma once

#include <cstdint>

#include "bf16.cuh"

#if !defined(__CUDACC__)
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace tdp {

// A read-only load: through the non-coherent cache on the card.
__host__ __device__ __forceinline__ float ldg(const float* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

// ---------------------------------------------------------------------------
// rows of V consecutive floats: one vector load or store where aligned
// ---------------------------------------------------------------------------

// p is aligned for the vector access of V values of T (V 1, 2, 4; 8 floats
// are two float4, 8 bfloat16 one 16-byte access).
template <int V, class T = float>
__host__ __device__ __forceinline__ bool vec_aligned(const void* p) {
  constexpr uintptr_t kAlign = V * sizeof(T) >= 16 ? 16 : V * sizeof(T);
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

// The bfloat16 rows: V consecutive bfloat16 values as rbf, one 4-, 8- or
// 16-byte access when vec (V 2, 4, 8), else the first nv as scalars and
// the rest 0; and back.
template <int V>
__host__ __device__ __forceinline__ void load_row(const bf16* p, bool vec, int nv,
                                                  rbf (&r)[V]) {
#if defined(__CUDA_ARCH__)
  if constexpr (V > 1) {
    if (vec) {
      uint32_t w[V / 2];
      if constexpr (V == 2) {
        w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
      } else if constexpr (V == 4) {
        const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = a.x;
        w[1] = a.y;
      } else {
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
        w[0] = a.x;
        w[1] = a.y;
        w[2] = a.z;
        w[3] = a.w;
      }
#pragma unroll
      for (int h = 0; h < V / 2; ++h) {
        float lo, hi;
        unpack_bf16x2(w[h], lo, hi);
        r[2 * h] = rbf::exact(lo);
        r[2 * h + 1] = rbf::exact(hi);
      }
      return;
    }
  }
#endif
#pragma unroll
  for (int l = 0; l < V; ++l) r[l] = rbf::exact(l < nv ? ldg(p + l) : 0.0f);
}

template <int V>
__host__ __device__ __forceinline__ void store_row(bf16* p, bool vec, int nv,
                                                   const rbf (&r)[V]) {
#if defined(__CUDA_ARCH__)
  if constexpr (V > 1) {
    if (vec) {
      uint32_t w[V / 2];
#pragma unroll
      for (int h = 0; h < V / 2; ++h)
        w[h] = (bits_from_f32(r[2 * h].v) >> 16) |
               (bits_from_f32(r[2 * h + 1].v) & 0xffff0000u);
      if constexpr (V == 2) {
        *reinterpret_cast<unsigned*>(p) = w[0];
      } else if constexpr (V == 4) {
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
      } else {
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
      }
      return;
    }
  }
#endif
#pragma unroll
  for (int l = 0; l < V; ++l)
    if (l < nv) store_value(p + l, r[l]);
}

constexpr int NVEL = 19;
constexpr int MAX_IN = 5;
constexpr int MAX_OUT = 2;

// Error codes of the C entries besides cudaError_t values (all positive).
constexpr int ERR_BAD_SITE = -1;
constexpr int ERR_BAD_VVL = -2;
constexpr int ERR_GEOMETRY = -6;
constexpr int ERR_PLANE_BLOCK = -7;
constexpr int ERR_BAD_OP = -8;  // a reduction op outside {sum, max, min}
constexpr int ERR_ENSEMBLE = -9;  // an ensemble extent outside 1..65535

enum SiteId : int {
  SITE_STREAM = 0,
  SITE_GRAD6 = 1,
  SITE_MOMENT = 2,
  SITE_COLLIDE = 3,
  SITE_FUSED = 4,
  SITE_PHI_STREAM = 5,
  SITE_FUSED_TWO = 6,
};

// Stencil of a field: pointwise, or one of the repo's Stencil descriptors.
enum StencilId : int { ST_POINT = 0, ST_PULL = 1, ST_GRAD6 = 2, ST_FUSED_G = 3 };

// D3Q19 velocities: rest, 6 axis vectors, 12 face diagonals
// (repro_torch.core.lattice.D3Q19_VELOCITIES).
__host__ __device__ __forceinline__ int cv(int q, int d) {
  constexpr signed char T[NVEL][3] = {
      {0, 0, 0},
      {1, 0, 0}, {-1, 0, 0}, {0, 1, 0}, {0, -1, 0}, {0, 0, 1}, {0, 0, -1},
      {1, 1, 0}, {1, -1, 0}, {-1, 1, 0}, {-1, -1, 0},
      {1, 0, 1}, {1, 0, -1}, {-1, 0, 1}, {-1, 0, -1},
      {0, 1, 1}, {0, 1, -1}, {0, -1, 1}, {0, -1, -1}};
  return T[q][d];
}

__host__ __device__ __forceinline__ float wq(int q) {
  return q == 0 ? 1.0f / 3.0f : (q < 7 ? 1.0f / 18.0f : 1.0f / 36.0f);
}

// STENCIL_GRAD_6PT.compose(STENCIL_D3Q19_PULL): 57 offsets, radius 2.
__host__ __device__ __forceinline__ int fused_g_off(int slot, int d) {
  constexpr signed char T[57][3] = {
      { 0,  0,  0}, {-1,  0,  0}, { 1,  0,  0}, { 0, -1,  0}, { 0,  1,  0}, { 0,  0, -1},
      { 0,  0,  1}, {-1, -1,  0}, {-1,  1,  0}, { 1, -1,  0}, { 1,  1,  0}, {-1,  0, -1},
      {-1,  0,  1}, { 1,  0, -1}, { 1,  0,  1}, { 0, -1, -1}, { 0, -1,  1}, { 0,  1, -1},
      { 0,  1,  1}, { 2,  0,  0}, { 2, -1,  0}, { 2,  1,  0}, { 2,  0, -1}, { 2,  0,  1},
      { 1, -1, -1}, { 1, -1,  1}, { 1,  1, -1}, { 1,  1,  1}, {-2,  0,  0}, {-2, -1,  0},
      {-2,  1,  0}, {-2,  0, -1}, {-2,  0,  1}, {-1, -1, -1}, {-1, -1,  1}, {-1,  1, -1},
      {-1,  1,  1}, { 0,  2,  0}, {-1,  2,  0}, { 1,  2,  0}, { 0,  2, -1}, { 0,  2,  1},
      { 0, -2,  0}, {-1, -2,  0}, { 1, -2,  0}, { 0, -2, -1}, { 0, -2,  1}, { 0,  0,  2},
      {-1,  0,  2}, { 1,  0,  2}, { 0, -1,  2}, { 0,  1,  2}, { 0,  0, -2}, {-1,  0, -2},
      { 1,  0, -2}, { 0, -1, -2}, { 0,  1, -2}};
  return T[slot][d];
}

// _FUSED_G_IDX[dir][q]: slot of (grad-star dir - c_q) in the fused g stencil.
__host__ __device__ __forceinline__ int fused_g_idx(int dir, int q) {
  constexpr signed char T[7][NVEL] = {
      { 0,  1,  2,  3,  4,  5,  6,  7,  8,  9, 10, 11, 12, 13, 14, 15, 16, 17, 18},
      { 2,  0, 19,  9, 10, 13, 14,  3,  4, 20, 21,  5,  6, 22, 23, 24, 25, 26, 27},
      { 1, 28,  0,  7,  8, 11, 12, 29, 30,  3,  4, 31, 32,  5,  6, 33, 34, 35, 36},
      { 4,  8, 10,  0, 37, 17, 18,  1, 38,  2, 39, 35, 36, 26, 27,  5,  6, 40, 41},
      { 3,  7,  9, 42,  0, 15, 16, 43,  1, 44,  2, 33, 34, 24, 25, 45, 46,  5,  6},
      { 6, 12, 14, 16, 18,  0, 47, 34, 36, 25, 27,  1, 48,  2, 49,  3, 50,  4, 51},
      { 5, 11, 13, 15, 17, 52,  0, 33, 35, 24, 26, 53,  1, 54,  2, 55,  3, 56,  4}};
  return T[dir][q];
}

// _PULL_IDX[q]: slot of -c_q in the pull stencil (the identity).
__host__ __device__ __forceinline__ int pull_idx(int q) { return q; }

__host__ __device__ __forceinline__ int st_off(int st, int slot, int d) {
  return st == ST_PULL ? -cv(slot, d)
       : st == ST_GRAD6 ? cv(slot, d)
       : st == ST_FUSED_G ? fused_g_off(slot, d) : 0;
}

__host__ __device__ __forceinline__ int st_radius(int st) {
  return st == ST_FUSED_G ? 2 : (st == ST_POINT ? 0 : 1);
}

// The six physics scalars plus the two coefficients the plain version folds
// in double precision before rounding to float: (1 - 1/(2 tau)) and 3 gamma.
// A bfloat16 launch gets every one rounded to bfloat16 by the host, as the
// reference rounds its weak scalars (kernels/tdp_pointwise.py: phys_row).
struct Phys {
  float A, B, kappa, tau, tau_phi, gamma, fcoef, g3;
};

inline Phys make_phys(float A, float B, float kappa, float tau, float tau_phi,
                      float gamma) {
  return Phys{A, B, kappa, tau, tau_phi, gamma,
              (float)(1.0 - 0.5 / (double)tau), (float)(3.0 * (double)gamma)};
}

// The device table of an ensemble launch: row m = make_phys of consts[6m ..
// 6m+5] = (A, B, kappa, tau, tau_phi, gamma), so a member computes with the
// bits its single launch would.
inline void make_phys_rows(int B, const float* consts, Phys* rows) {
  for (int m = 0; m < B; ++m) {
    const float* c = consts + 6 * (int64_t)m;
    rows[m] = make_phys(c[0], c[1], c[2], c[3], c[4], c[5]);
  }
}

// sum_d c_qd v_d with the zero terms dropped and the unit products folded
// (a contraction: in bfloat16 summed in float32 and rounded once)
template <class V>
__host__ __device__ __forceinline__ V cdot(int q, const V (&v)[3]) {
  float s = 0.0f;
  bool first = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int c = cv(q, d);
    if (c == 0) continue;
    const float t = c > 0 ? value_f32(v[d]) : -value_f32(v[d]);
    s = first ? t : sum_add<V>(s, t);
    first = false;
  }
  return sum_end<V>(s);
}

// D3Q19 binary BGK collision of one site with the chemical potential
// mu = -A phi + B phi^3 - kappa lap(phi) fused in and Guo forcing F = mu grad(phi)
// (repro_torch.kernels.lb_collision.collision_site_kernel).
template <class V>
__host__ __device__ __forceinline__ void collide_core(
    const V (&f)[NVEL], const V (&g)[NVEL], V phi, const V (&grad)[3], V lap,
    const Phys& p, V (&fo)[NVEL], V (&go)[NVEL]) {
  // The scalars are read where used (a float makes a V; in bfloat16 they
  // are bfloat16 values already).  Copied into locals first, they change
  // nvcc's FMA contraction of the float32 kernels at VVL 2-8.
  const V mu = -p.A * phi + p.B * phi * phi * phi - p.kappa * lap;
  V F[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) F[d] = mu * grad[d];

  float rho_s = value_f32(f[0]);
#pragma unroll
  for (int q = 1; q < NVEL; ++q) rho_s = sum_add<V>(rho_s, value_f32(f[q]));
  const V rho = sum_end<V>(rho_s);
  V u[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float m = 0.0f;
    bool first = true;
#pragma unroll
    for (int q = 1; q < NVEL; ++q) {
      const int c = cv(q, d);
      if (c == 0) continue;
      const float t = c > 0 ? value_f32(f[q]) : -value_f32(f[q]);
      m = first ? t : sum_add<V>(m, t);
      first = false;
    }
    u[d] = (sum_end<V>(m) + 0.5f * F[d]) / rho;
  }
  const V usq = sum_end<V>(sum_add<V>(
      sum_add<V>(value_f32(u[0] * u[0]), value_f32(u[1] * u[1])), value_f32(u[2] * u[2])));
  const V uf = sum_end<V>(sum_add<V>(
      sum_add<V>(value_f32(u[0] * F[0]), value_f32(u[1] * F[1])), value_f32(u[2] * F[2])));

  V gt[NVEL];
#pragma unroll
  for (int q = 0; q < NVEL; ++q) {
    const V w = wq(q);
    const V cu = cdot(q, u);
    const V cf = cdot(q, F);
    const V feq = w * rho * (1.0f + 3.0f * cu + 4.5f * cu * cu - 1.5f * usq);
    const V fterm = p.fcoef * w * (3.0f * (cf - uf) + 9.0f * cu * cf);
    fo[q] = f[q] - (f[q] - feq) / p.tau + fterm;
    gt[q] = w * (p.g3 * mu + 3.0f * phi * cu);
  }
  float gsum = value_f32(gt[0]);
#pragma unroll
  for (int q = 1; q < NVEL; ++q) gsum = sum_add<V>(gsum, value_f32(gt[q]));
  const V g0 = phi - (sum_end<V>(gsum) - gt[0]);
  go[0] = g[0] - (g[0] - g0) / p.tau_phi;
#pragma unroll
  for (int q = 1; q < NVEL; ++q) go[q] = g[q] - (g[q] - gt[q]) / p.tau_phi;
}

// grad(phi) and lap(phi) from phi at the 7 grad-star slots (centre, +x, -x,
// +y, -y, +z, -z) in the plain version's accumulation order.
template <class V>
__host__ __device__ __forceinline__ void grad6_from_p(const V (&p)[7], V (&grad)[3],
                                                      V& lap) {
  grad[0] = 0.5f * (p[1] - p[2]);
  grad[1] = 0.5f * (p[3] - p[4]);
  grad[2] = 0.5f * (p[5] - p[6]);
  lap = -6.0f * p[0];
  lap = lap + p[1] + p[2];
  lap = lap + p[3] + p[4];
  lap = lap + p[5] + p[6];
}

// ---------------------------------------------------------------------------
// site functions: NIN/NOUT, per-field ncomp and stencil, and run()
// ---------------------------------------------------------------------------

struct StreamSite {
  static constexpr int NIN = 1, NOUT = 1;
  static constexpr int RADIUS = 1;
  __host__ __device__ static constexpr int ncomp_in(int) { return NVEL; }
  __host__ __device__ static constexpr int ncomp_out(int) { return NVEL; }
  __host__ __device__ static constexpr int stencil(int) { return ST_PULL; }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys&) {
#pragma unroll
    for (int q = 0; q < NVEL; ++q) nb.put(0, q, lane, nb.at(0, pull_idx(q), q, lane));
  }
};

struct Grad6Site {
  static constexpr int NIN = 1, NOUT = 2;
  static constexpr int RADIUS = 1;
  __host__ __device__ static constexpr int ncomp_in(int) { return 1; }
  __host__ __device__ static constexpr int ncomp_out(int k) { return k == 0 ? 3 : 1; }
  __host__ __device__ static constexpr int stencil(int) { return ST_GRAD6; }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys&) {
    using V = typename Nb::V;
    V p[7], grad[3], lap;
#pragma unroll
    for (int k = 0; k < 7; ++k) p[k] = nb.at(0, k, 0, lane);
    grad6_from_p(p, grad, lap);
#pragma unroll
    for (int d = 0; d < 3; ++d) nb.put(0, d, lane, grad[d]);
    nb.put(1, 0, lane, lap);
  }
};

struct MomentSite {
  static constexpr int NIN = 1, NOUT = 1;
  static constexpr int RADIUS = 0;
  __host__ __device__ static constexpr int ncomp_in(int) { return NVEL; }
  __host__ __device__ static constexpr int ncomp_out(int) { return 1; }
  __host__ __device__ static constexpr int stencil(int) { return ST_POINT; }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys&) {
    // jnp.sum: in bfloat16 summed in float32, rounded once
    using V = typename Nb::V;
    float acc = value_f32(nb.at(0, 0, 0, lane));
#pragma unroll
    for (int q = 1; q < NVEL; ++q) acc = sum_add<V>(acc, value_f32(nb.at(0, 0, q, lane)));
    nb.put(0, 0, lane, sum_end<V>(acc));
  }
};

template <class Nb, class V>
__host__ __device__ __forceinline__ void put_fg(const Nb& nb, int lane, const V (&fo)[NVEL],
                                                const V (&go)[NVEL]) {
#pragma unroll
  for (int q = 0; q < NVEL; ++q) {
    nb.put(0, q, lane, fo[q]);
    nb.put(1, q, lane, go[q]);
  }
}

struct CollideSite {  // fields: f, g, phi, gradphi, del2phi (all pointwise)
  static constexpr int NIN = 5, NOUT = 2;
  static constexpr int RADIUS = 0;
  __host__ __device__ static constexpr int ncomp_in(int i) {
    return i < 2 ? NVEL : (i == 3 ? 3 : 1);
  }
  __host__ __device__ static constexpr int ncomp_out(int) { return NVEL; }
  __host__ __device__ static constexpr int stencil(int) { return ST_POINT; }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys& p) {
    using V = typename Nb::V;
    V f[NVEL], g[NVEL], grad[3], fo[NVEL], go[NVEL];
#pragma unroll
    for (int q = 0; q < NVEL; ++q) {
      f[q] = nb.at(0, 0, q, lane);
      g[q] = nb.at(1, 0, q, lane);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) grad[d] = nb.at(3, 0, d, lane);
    collide_core(f, g, nb.at(2, 0, 0, lane), grad, nb.at(4, 0, 0, lane), p, fo, go);
    put_fg(nb, lane, fo, go);
  }
};

// The fused site function's tail: grad(phi) and lap(phi) from phi at the 7
// grad-star slots, then the collision of the pulled f and g.
template <class Nb, class V>
__host__ __device__ __forceinline__ void fused_tail(const Nb& nb, int lane,
                                                    const V (&f)[NVEL], const V (&g)[NVEL],
                                                    const V (&ph)[7], const Phys& p) {
  V grad[3], lap, fo[NVEL], go[NVEL];
  grad6_from_p(ph, grad, lap);
  collide_core(f, g, ph[0], grad, lap, p, fo, go);
  put_fg(nb, lane, fo, go);
}

struct FusedSite {  // fields: f (pull), g (fused_g, radius 2)
  static constexpr int NIN = 2, NOUT = 2;
  static constexpr int RADIUS = 2;
  __host__ __device__ static constexpr int ncomp_in(int) { return NVEL; }
  __host__ __device__ static constexpr int ncomp_out(int) { return NVEL; }
  __host__ __device__ static constexpr int stencil(int i) {
    return i == 0 ? ST_PULL : ST_FUSED_G;
  }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys& p) {
    using V = typename Nb::V;
    V f[NVEL], g[NVEL], ph[7];
#pragma unroll
    for (int q = 0; q < NVEL; ++q) {
      f[q] = nb.at(0, pull_idx(q), q, lane);
      g[q] = nb.at(1, fused_g_idx(0, q), q, lane);
    }
    // phi of the streamed g at the site and its 6 gradient neighbours,
    // phi(x + d) = sum_q g(x + d - c_q), ascending q
    ph[0] = g[0];
#pragma unroll
    for (int q = 1; q < NVEL; ++q) ph[0] = ph[0] + g[q];
#pragma unroll
    for (int d = 1; d < 7; ++d) {
      V acc = nb.at(1, fused_g_idx(d, 0), 0, lane);
#pragma unroll
      for (int q = 1; q < NVEL; ++q) acc = acc + nb.at(1, fused_g_idx(d, q), q, lane);
      ph[d] = acc;
    }
    fused_tail(nb, lane, f, g, ph, p);
  }
};

struct PhiStreamSite {  // field: g (pull)
  static constexpr int NIN = 1, NOUT = 1;
  static constexpr int RADIUS = 1;
  __host__ __device__ static constexpr int ncomp_in(int) { return NVEL; }
  __host__ __device__ static constexpr int ncomp_out(int) { return 1; }
  __host__ __device__ static constexpr int stencil(int) { return ST_PULL; }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys&) {
    typename Nb::V acc = nb.at(0, pull_idx(0), 0, lane);
#pragma unroll
    for (int q = 1; q < NVEL; ++q) acc = acc + nb.at(0, pull_idx(q), q, lane);
    nb.put(0, 0, lane, acc);
  }
};

struct FusedTwoSite {  // fields: f (pull), g (pull), phi_streamed (grad6)
  static constexpr int NIN = 3, NOUT = 2;
  static constexpr int RADIUS = 1;
  __host__ __device__ static constexpr int ncomp_in(int i) { return i < 2 ? NVEL : 1; }
  __host__ __device__ static constexpr int ncomp_out(int) { return NVEL; }
  __host__ __device__ static constexpr int stencil(int i) {
    return i < 2 ? ST_PULL : ST_GRAD6;
  }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys& p) {
    using V = typename Nb::V;
    V f[NVEL], g[NVEL], ph[7], grad[3], lap, fo[NVEL], go[NVEL];
#pragma unroll
    for (int q = 0; q < NVEL; ++q) {
      f[q] = nb.at(0, pull_idx(q), q, lane);
      g[q] = nb.at(1, pull_idx(q), q, lane);
    }
#pragma unroll
    for (int k = 0; k < 7; ++k) ph[k] = nb.at(2, k, 0, lane);
    grad6_from_p(ph, grad, lap);
    collide_core(f, g, ph[0], grad, lap, p, fo, go);
    put_fg(nb, lane, fo, go);
  }
};

// ---------------------------------------------------------------------------
// the neighbour accessor and the per-thread body
// ---------------------------------------------------------------------------

// Field operands, one form for both launchers: stencil field i is the
// caller's own (ncomp, X+2hx, Y+2hy, Z+2hz) array, read in place; a
// pointwise field and every output are (ncomp, X*Y*Z) over the interior.
// A launch with no stencil field passes (1, 1, n) and no ghost planes.
// T is the storage type of every field and output (float or bf16).
template <class T>
struct FieldIOT {
  const T* in[MAX_IN];
  T* out[MAX_OUT];
  int X, Y, Z;
  int hx, hy, hz;
  int64_t n;
  Phys phys;
};
using FieldIO = FieldIOT<float>;

// A field's value at p, as V (bfloat16 widened exactly), and a value stored.
__host__ __device__ __forceinline__ float load_value(const float* p) { return ldg(p); }
__host__ __device__ __forceinline__ rbf load_value(const bf16* p) {
  return rbf::exact(ldg(p));
}
__host__ __device__ __forceinline__ void store_value(float* p, float x) { *p = x; }

// Where site coordinate c + o lies along a dimension of interior extent s
// stored with h ghost planes on each side: wrapped periodically when h == 0
// (one correction suffices while |o| <= s and -1 <= c <= s, which
// check_geometry() ensures), on the caller's ghost planes when h > 0.
__host__ __device__ __forceinline__ int wrap(int c, int o, int s, int h) {
  if (h) return c + o + h;
  const int v = c + o;
  return v < 0 ? v + s : (v >= s ? v - s : v);
}

// The SoA C entries' operands as a FieldIOT<T>: in[i] / out[k] of storage
// type T, the lattice and its ghost planes, and the host Phys at `phys`.
template <class T>
inline FieldIOT<T> make_field_io(const void* const* in, void* const* out, int X, int Y,
                                 int Z, int hx, int hy, int hz, const void* phys) {
  FieldIOT<T> io{};
  for (int i = 0; i < MAX_IN; ++i) io.in[i] = static_cast<const T*>(in[i]);
  for (int k = 0; k < MAX_OUT; ++k) io.out[k] = static_cast<T*>(out[k]);
  io.X = X;
  io.Y = Y;
  io.Z = Z;
  io.hx = hx;
  io.hy = hy;
  io.hz = hz;
  io.n = (int64_t)X * Y * Z;
  io.phys = *static_cast<const Phys*>(phys);
  return io;
}

// 0, or ERR_GEOMETRY when a stencil of radius r cannot be served: r above a
// periodic extent (h == 0), or fewer ghost planes than r (h > 0).
template <class T>
inline int check_geometry(const FieldIOT<T>& io, int r) {
  const int s[3] = {io.X, io.Y, io.Z}, h[3] = {io.hx, io.hy, io.hz};
  for (int d = 0; d < 3; ++d)
    if (r && (h[d] ? h[d] < r : r > s[d])) return ERR_GEOMETRY;
  return 0;
}

// The neighbour accessor of VVL consecutive z-sites (x, y, z0 .. z0+VVL-1).
// The wrapped coordinate of every offset value -R..R the site function's
// stencils can name (R = Site::RADIUS) is worked out once, at construction,
// as an element offset per dimension: ox[o + R], oy[o + R] and, for lane l,
// oz[l + o + R].  A read then adds three of them, picked at compile time
// from the stencil tables.  Offsets within one component are 32-bit (the
// wrapper checks that a component of an extended field has fewer than 2^31
// elements).
template <class Site, int VVL, class T = float>
struct FieldNb {
  static constexpr int R = Site::RADIUS;
  using V = value_t<T>;
  const FieldIOT<T>& io;
  int64_t site0;  // flat interior index of lane 0
  int64_t cs;     // component stride of a stencil field
  int ox[2 * R + 1], oy[2 * R + 1], oz[2 * R + VVL];

  __host__ __device__ __forceinline__ FieldNb(const FieldIOT<T>& io_, int x, int y, int z0)
      : io(io_), site0(((int64_t)x * io_.Y + y) * io_.Z + z0), cs(0) {
    if constexpr (R > 0) {
      const int ze = io.Z + 2 * io.hz, yze = (io.Y + 2 * io.hy) * ze;
      cs = (int64_t)(io.X + 2 * io.hx) * yze;
#pragma unroll
      for (int o = -R; o <= R; ++o) {
        ox[o + R] = wrap(x, o, io.X, io.hx) * yze;
        oy[o + R] = wrap(y, o, io.Y, io.hy) * ze;
      }
#pragma unroll
      for (int k = 0; k < 2 * R + VVL; ++k) oz[k] = wrap(z0, k - R, io.Z, io.hz);
    }
  }
  __host__ __device__ __forceinline__ V at(int f, int slot, int c, int lane) const {
    const int st = Site::stencil(f);
    if (st == ST_POINT) return load_value(io.in[f] + (int64_t)c * io.n + site0 + lane);
    return load_value(io.in[f] + c * cs +
                      (ox[st_off(st, slot, 0) + R] + oy[st_off(st, slot, 1) + R] +
                       oz[lane + st_off(st, slot, 2) + R]));
  }
  __host__ __device__ __forceinline__ void put(int k, int c, int lane, V v) const {
    store_value(io.out[k] + ((int64_t)c * io.n + site0 + lane), v);
  }
};

// Thread t covers VVL consecutive z-sites of one (x, y) row of the interior,
// so neighbouring threads read neighbouring addresses; the ragged end of a
// row is masked.  A site function with no stencil field takes the sites as
// one flat row.  The thread count is below 2^31 (the wrapper bounds a
// component of a field), so the index arithmetic is 32-bit.
template <class Site, int VVL, class T>
__host__ __device__ __forceinline__ void field_thread(const FieldIOT<T>& io, int64_t t64) {
  const int nzb = (io.Z + VVL - 1) / VVL;
  if (t64 >= (int64_t)io.X * io.Y * nzb) return;
  const int t = (int)t64;
  int x = 0, y = 0, z0 = t * VVL, zend = (int)io.n;
  if constexpr (Site::RADIUS > 0) {
    const int xy = t / nzb;
    y = xy % io.Y;
    x = xy / io.Y;
    z0 = (t % nzb) * VVL;
    zend = io.Z;
  }
  const FieldNb<Site, VVL, T> nb(io, x, y, z0);
#pragma unroll
  for (int l = 0; l < VVL; ++l)
    if (z0 + l < zend) Site::run(nb, l, io.phys);
}

template <int VVL, class T>
__host__ __device__ __forceinline__ int64_t field_threads(const FieldIOT<T>& io) {
  return (int64_t)io.X * io.Y * ((io.Z + VVL - 1) / VVL);
}

// ---------------------------------------------------------------------------
// ensembles: B independent members in one launch (a fleet's stage)
// ---------------------------------------------------------------------------
//
// Member m's operands lie at in[i] + m·in_stride[i] and out[k] +
// m·out_stride[k] (elements; each member contiguous, the members at any
// 64-bit distance, so gaps between them are never touched), and its physics
// is row m of a device table of B Phys rows (make_phys_rows).  Geometry is
// shared.  The launchers put the member on blockIdx.y; member_io() turns the
// ensemble into member m's FieldIO, and the single launchers' per-thread
// bodies and tile phases run on it unchanged.

struct EnsembleIO {
  FieldIO io;  // member 0's pointers and the shared geometry
  int64_t in_stride[MAX_IN];
  int64_t out_stride[MAX_OUT];
  const Phys* phys;  // B rows
  int B;
};

__host__ __device__ __forceinline__ FieldIO member_io(const EnsembleIO& e, int m) {
  FieldIO io = e.io;
#pragma unroll
  for (int i = 0; i < MAX_IN; ++i) io.in[i] += m * e.in_stride[i];
#pragma unroll
  for (int k = 0; k < MAX_OUT; ++k) io.out[k] += m * e.out_stride[k];
  io.phys = e.phys[m];
  return io;
}

// 0, or ERR_ENSEMBLE when B is not an extent blockIdx.y can take.
inline int check_ensemble(int B) { return B < 1 || B > 65535 ? ERR_ENSEMBLE : 0; }

// The C entries' arguments as an EnsembleIO (unused in/out slots are null
// with stride 0).
inline EnsembleIO make_ensemble_io(int B, const void* const* in, void* const* out,
                                   const long long* in_stride,
                                   const long long* out_stride, int X, int Y, int Z,
                                   int hx, int hy, int hz, const void* phys) {
  EnsembleIO e{};
  for (int i = 0; i < MAX_IN; ++i) {
    e.io.in[i] = static_cast<const float*>(in[i]);
    e.in_stride[i] = in[i] ? in_stride[i] : 0;
  }
  for (int k = 0; k < MAX_OUT; ++k) {
    e.io.out[k] = static_cast<float*>(out[k]);
    e.out_stride[k] = out[k] ? out_stride[k] : 0;
  }
  e.io.X = X;
  e.io.Y = Y;
  e.io.Z = Z;
  e.io.hx = hx;
  e.io.hy = hy;
  e.io.hz = hz;
  e.io.n = (int64_t)X * Y * Z;
  e.phys = static_cast<const Phys*>(phys);
  e.B = B;
  return e;
}

// ---------------------------------------------------------------------------
// the AoSoA layout: a second accessor over the same site functions
// ---------------------------------------------------------------------------
//
// Under Target(layout="aosoa") every operand arrives as contiguous blocks of
// W sites (W = Target.vvl, any W >= 1): site e, component c of a buffer of
// ncomp components at (e / W)·ncomp·W + c·W + e % W, the last block
// zero-padded (repro_torch/core/layout.py).  A pointwise field's blocks run
// over the interior sites, a stencil field's over its flat extended grid
// whose x-planes hold `plane` sites each: the extended plane's own count
// for the gathered launcher, that count padded to a multiple of W for the
// windowed one, which groups each x-plane into whole blocks.  AosoaNb
// resolves a neighbour's flat index exactly as FieldNb does (the wrap, the
// ghost planes) and then maps it; its outputs are AoSoA over the interior
// (gathered) or SoA (windowed, as the reference's are).
//
// Mapping: one thread per site, so a block's W sites sit on consecutive
// lanes and a warp's load of one component is ceil(32 / W) runs of W
// contiguous floats (whole 32-byte sectors for W >= 8).  A thread over VVL
// sites would stride its lanes' loads across blocks once VVL > W.

// The block width W of an AoSoA buffer, with the multiplier and shift that
// divide by it: for 0 <= e < 2^31, e / W = (e · magic) >> shift, where shift
// = 31 + ceil(log2 W) and magic = ceil(2^shift / W) < 2^32 (Granlund and
// Montgomery, PLDI 1994: magic·W - 2^shift < W <= 2^(shift - 31)).  One
// 32 x 32 -> 64-bit multiply and a shift, the same code for every W, with
// no branch among a site function's unrolled loads.
struct AosoaMap {
  int W;
  unsigned magic;
  int shift;
};

inline AosoaMap make_aosoa_map(int W) {
  int l = 0;
  while ((1ll << l) < W) ++l;
  const int shift = 31 + l;
  return AosoaMap{W, (unsigned)(((1ull << shift) + W - 1) / W), shift};
}

// Offset of (site e, component c) in a buffer of ncomp components: block b
// = e / W, lane e - b·W, at (b·ncomp + c)·W + lane.  Site indices and the
// row index b·ncomp + c are 32-bit (the wrappers refuse 2^31 sites, or
// 2^31 rows of W in a buffer), the offset 64.
__host__ __device__ __forceinline__ int64_t aosoa_index(const AosoaMap& m, int e,
                                                        int ncomp, int c) {
  const int b = (int)(((uint64_t)(unsigned)e * m.magic) >> m.shift);
  return (int64_t)(b * ncomp + c) * m.W + (e - b * m.W);
}

// AoSoA operands of one LB launch.
struct AosoaIO {
  FieldIO io;     // pointers to the AoSoA buffers, geometry, physics
  AosoaMap map;
  int plane;      // sites of an x-plane of a stencil field's buffer
  bool soa_out;   // outputs SoA (windowed) instead of AoSoA
};

// The neighbour accessor of one site (x, y, z): the wrapped coordinate of
// every offset -R..R is worked out once, as in FieldNb, as flat-index
// parts ox (x-planes of `plane` sites), oy and oz.  `lane` is always 0.
template <class Site>
struct AosoaNb {
  static constexpr int R = Site::RADIUS;
  using V = float;
  const AosoaIO& a;
  int site;  // flat interior index
  int ox[2 * R + 1], oy[2 * R + 1], oz[2 * R + 1];

  __host__ __device__ __forceinline__ AosoaNb(const AosoaIO& a_, int x, int y, int z)
      : a(a_), site((x * a_.io.Y + y) * a_.io.Z + z) {
    if constexpr (R > 0) {
      const FieldIO& io = a.io;
      const int ze = io.Z + 2 * io.hz;
#pragma unroll
      for (int o = -R; o <= R; ++o) {
        ox[o + R] = wrap(x, o, io.X, io.hx) * a.plane;
        oy[o + R] = wrap(y, o, io.Y, io.hy) * ze;
        oz[o + R] = wrap(z, o, io.Z, io.hz);
      }
    }
  }
  __host__ __device__ __forceinline__ float at(int f, int slot, int c, int) const {
    const int st = Site::stencil(f);
    if (st == ST_POINT) return ldg(a.io.in[f] + aosoa_index(a.map, site, Site::ncomp_in(f), c));
    const int e = ox[st_off(st, slot, 0) + R] + oy[st_off(st, slot, 1) + R] +
                  oz[st_off(st, slot, 2) + R];
    return ldg(a.io.in[f] + aosoa_index(a.map, e, Site::ncomp_in(f), c));
  }
  __host__ __device__ __forceinline__ void put(int k, int c, int, float v) const {
    if (a.soa_out)
      a.io.out[k][(int64_t)c * a.io.n + site] = v;
    else
      a.io.out[k][aosoa_index(a.map, site, Site::ncomp_out(k), c)] = v;
  }
};

// Thread t takes interior site t (x, y, z from it; a site function with no
// stencil field takes the sites as one flat row); t >= n is masked.
template <class Site>
__host__ __device__ __forceinline__ void aosoa_thread(const AosoaIO& a, int64_t t) {
  const FieldIO& io = a.io;
  if (t >= io.n) return;
  int x = 0, y = 0, z = (int)t;
  if constexpr (Site::RADIUS > 0) {
    const int xy = (int)(t / io.Z);
    z = (int)(t - (int64_t)xy * io.Z);
    y = xy % io.Y;
    x = xy / io.Y;
  }
  const AosoaNb<Site> nb(a, x, y, z);
  Site::run(nb, 0, io.phys);
}

// ---------------------------------------------------------------------------
// the fused site function in shared-memory tiles (tdp_windowed.cu)
// ---------------------------------------------------------------------------
//
// A block takes P x-planes (P = plane_block) by a TILE_Y x TILE_Z patch of
// sites, and a rim of one site around it.  Phase 1 sums the streamed phi,
// phi(s) = sum_q g_q(s - c_q), of every site of tile and rim into shared
// memory; phase 2 gives each site of the tile its 7 grad-star phi from
// there and collides its pulled f and g (read once per component).  The
// untiled FusedSite sums the 6 neighbours' phi again at every site: 133 g
// reads a site, against 19 per site of tile and rim here.  Both phases are
// functions of (block, thread, shared array): the kernel runs them with a
// barrier between, the host harness block by block.

constexpr int TILE_Y = 8, TILE_Z = 32;
constexpr int RIM_Y = TILE_Y + 2, RIM_Z = TILE_Z + 2;
// Shared memory a block may hold on the H100 (227 KB).  phi is staged as
// float32 in both arithmetics (a bfloat16 launch stages its bfloat16 phi
// widened), so the tile's bytes do not depend on the dtype.
constexpr int64_t SMEM_LIMIT = 232448;

template <int VVL>
__host__ __device__ constexpr int tile_threads() { return TILE_Y * TILE_Z / VVL; }

__host__ __device__ inline int64_t tile_smem_bytes(int P) {
  return ((int64_t)P + 2) * RIM_Y * RIM_Z * (int64_t)sizeof(float);
}

// 0, or ERR_PLANE_BLOCK when P is not positive or the tile does not fit.
inline int check_tile(int P) {
  return P <= 0 || tile_smem_bytes(P) > SMEM_LIMIT ? ERR_PLANE_BLOCK : 0;
}

// The tile phases run over SoA fields (FieldIO, read in place by FieldNb)
// or AoSoA ones (AosoaIO, one site a thread: VVL 1); these pick the pieces.
template <class T>
__host__ __device__ __forceinline__ const FieldIOT<T>& field_io(const FieldIOT<T>& io) {
  return io;
}
__host__ __device__ __forceinline__ const FieldIO& field_io(const AosoaIO& a) { return a.io; }

// Flat-index stride of an x-plane of a stencil field.
template <class T>
__host__ __device__ __forceinline__ int tile_plane(const FieldIOT<T>& io) {
  return (io.Y + 2 * io.hy) * (io.Z + 2 * io.hz);
}
__host__ __device__ __forceinline__ int tile_plane(const AosoaIO& a) { return a.plane; }

// Component q of g (19 components, component stride cs under SoA) at flat
// index e.
template <class T>
__host__ __device__ __forceinline__ value_t<T> tile_g(const FieldIOT<T>&, const T* g,
                                                      int64_t cs, int e, int q) {
  return load_value(g + q * cs + e);
}
__host__ __device__ __forceinline__ float tile_g(const AosoaIO& a, const float* g, int64_t,
                                                 int e, int q) {
  return ldg(g + aosoa_index(a.map, e, NVEL, q));
}

template <class T>
__host__ __device__ inline int64_t tile_blocks(const FieldIOT<T>& io, int P) {
  return (int64_t)((io.X + P - 1) / P) * ((io.Y + TILE_Y - 1) / TILE_Y) *
         ((io.Z + TILE_Z - 1) / TILE_Z);
}

// Block b's tile corner; z-tiles vary fastest, then y, then x, so blocks in
// flight together share their rims in L2.
struct TileCorner {
  int x0, y0, z0;
};

template <class T>
__host__ __device__ inline TileCorner tile_corner(const FieldIOT<T>& io, int P, int64_t b) {
  const int nz = (io.Z + TILE_Z - 1) / TILE_Z, ny = (io.Y + TILE_Y - 1) / TILE_Y;
  const int bz = (int)(b % nz);
  b /= nz;
  return {(int)(b / ny) * P, (int)(b % ny) * TILE_Y, bz * TILE_Z};
}

// Pull-only field access of the tile's sites (f and g, radius 1).
struct TileSite {
  static constexpr int NIN = 2, NOUT = 2;
  static constexpr int RADIUS = 1;
  __host__ __device__ static constexpr int ncomp_in(int) { return NVEL; }
  __host__ __device__ static constexpr int ncomp_out(int) { return NVEL; }
  __host__ __device__ static constexpr int stencil(int) { return ST_PULL; }
};

// The tile's accessor of f and g: FieldNb over SoA fields, AosoaNb over
// AoSoA ones.
template <class IO, int VVL>
struct TileNb;
template <class T, int VVL>
struct TileNb<FieldIOT<T>, VVL> {
  using type = FieldNb<TileSite, VVL, T>;
};
template <>
struct TileNb<AosoaIO, 1> {
  using type = AosoaNb<TileSite>;
};

// Phase 1: thread tid sums phi at rim-box sites tid, tid + threads, ... of
// the (P+2) x RIM_Y x RIM_Z box with corner (x0-1, y0-1, z0-1), z fastest,
// into phi[site].  Box sites past the far rim of the lattice (x > X, ...)
// belong to no tile site's star and are skipped.
template <int VVL, class IO>
__host__ __device__ __forceinline__ void fused_tile_phi(const IO& lay, int P,
                                                        int64_t block, int tid,
                                                        float* phi) {
  const auto& io = field_io(lay);
  const TileCorner t = tile_corner(io, P, block);
  const auto* g = io.in[1];
  const int ze = io.Z + 2 * io.hz, yze = tile_plane(lay);
  const int64_t cs = (int64_t)(io.X + 2 * io.hx) * yze;
  const int nbox = (P + 2) * RIM_Y * RIM_Z;
  for (int s = tid; s < nbox; s += tile_threads<VVL>()) {
    const int x = t.x0 - 1 + s / (RIM_Y * RIM_Z);
    const int y = t.y0 - 1 + (s / RIM_Z) % RIM_Y;
    const int z = t.z0 - 1 + s % RIM_Z;
    if (x > io.X || y > io.Y || z > io.Z) continue;
    int ix[3], iy[3], iz[3];
#pragma unroll
    for (int o = -1; o <= 1; ++o) {
      ix[o + 1] = wrap(x, o, io.X, io.hx) * yze;
      iy[o + 1] = wrap(y, o, io.Y, io.hy) * ze;
      iz[o + 1] = wrap(z, o, io.Z, io.hz);
    }
    auto acc = tile_g(lay, g, cs, ix[1] + iy[1] + iz[1], 0);
#pragma unroll
    for (int q = 1; q < NVEL; ++q)
      acc = acc + tile_g(lay, g, cs, ix[1 - cv(q, 0)] + iy[1 - cv(q, 1)] + iz[1 - cv(q, 2)], q);
    phi[s] = value_f32(acc);
  }
}

// Phase 2: thread tid takes row y0 + tid / (TILE_Z/VVL) and the VVL z-sites
// from z0 + (tid % (TILE_Z/VVL))·VVL, at each of the tile's P planes.
template <int VVL, class IO>
__host__ __device__ __forceinline__ void fused_tile_collide(const IO& lay, int P,
                                                            int64_t block, int tid,
                                                            const float* phi) {
  constexpr int ZT = TILE_Z / VVL;
  constexpr int PX = RIM_Y * RIM_Z;
  using Nb = typename TileNb<IO, VVL>::type;
  using V = typename Nb::V;
  const auto& io = field_io(lay);
  const TileCorner t = tile_corner(io, P, block);
  const int j = tid / ZT, zl = (tid % ZT) * VVL;
  const int y = t.y0 + j, z0 = t.z0 + zl;
  if (y >= io.Y || z0 >= io.Z) return;
  for (int i = 0; i < P && t.x0 + i < io.X; ++i) {
    const Nb nb(lay, t.x0 + i, y, z0);
#pragma unroll
    for (int l = 0; l < VVL; ++l) {
      if (z0 + l >= io.Z) break;
      const float* c = phi + ((i + 1) * RIM_Y + j + 1) * RIM_Z + zl + l + 1;
      const V ph[7] = {as_value<V>(c[0]),      as_value<V>(c[PX]),    as_value<V>(c[-PX]),
                       as_value<V>(c[RIM_Z]), as_value<V>(c[-RIM_Z]), as_value<V>(c[1]),
                       as_value<V>(c[-1])};
      V f[NVEL], g[NVEL];
#pragma unroll
      for (int q = 0; q < NVEL; ++q) {
        f[q] = nb.at(0, pull_idx(q), q, l);
        g[q] = nb.at(1, pull_idx(q), q, l);
      }
      fused_tail(nb, l, f, g, ph, io.phys);
    }
  }
}

// ---------------------------------------------------------------------------
// host-side dispatch: (site id, VVL) -> Launch<Site, VVL>::run(io, stream)
// ---------------------------------------------------------------------------

template <template <class, int> class Launch, class Site, class IO>
int dispatch_vvl(int vvl, const IO& io, void* stream) {
  switch (vvl) {
    case 1: return Launch<Site, 1>::run(io, stream);
    case 2: return Launch<Site, 2>::run(io, stream);
    case 4: return Launch<Site, 4>::run(io, stream);
    case 8: return Launch<Site, 8>::run(io, stream);
    default: return ERR_BAD_VVL;
  }
}

// (site id) -> Launch<Site>::run(io, stream): the AoSoA launchers, one site
// a thread.
template <template <class> class Launch, class IO>
int dispatch_site_aosoa(int site, const IO& io, void* stream) {
  switch (site) {
    case SITE_STREAM: return Launch<StreamSite>::run(io, stream);
    case SITE_GRAD6: return Launch<Grad6Site>::run(io, stream);
    case SITE_MOMENT: return Launch<MomentSite>::run(io, stream);
    case SITE_COLLIDE: return Launch<CollideSite>::run(io, stream);
    case SITE_FUSED: return Launch<FusedSite>::run(io, stream);
    case SITE_PHI_STREAM: return Launch<PhiStreamSite>::run(io, stream);
    case SITE_FUSED_TWO: return Launch<FusedTwoSite>::run(io, stream);
    default: return ERR_BAD_SITE;
  }
}

template <template <class, int> class Launch, class IO>
int dispatch_site(int site, int vvl, const IO& io, void* stream) {
  switch (site) {
    case SITE_STREAM: return dispatch_vvl<Launch, StreamSite>(vvl, io, stream);
    case SITE_GRAD6: return dispatch_vvl<Launch, Grad6Site>(vvl, io, stream);
    case SITE_MOMENT: return dispatch_vvl<Launch, MomentSite>(vvl, io, stream);
    case SITE_COLLIDE: return dispatch_vvl<Launch, CollideSite>(vvl, io, stream);
    case SITE_FUSED: return dispatch_vvl<Launch, FusedSite>(vvl, io, stream);
    case SITE_PHI_STREAM: return dispatch_vvl<Launch, PhiStreamSite>(vvl, io, stream);
    case SITE_FUSED_TWO: return dispatch_vvl<Launch, FusedTwoSite>(vvl, io, stream);
    default: return ERR_BAD_SITE;
  }
}

}  // namespace tdp
