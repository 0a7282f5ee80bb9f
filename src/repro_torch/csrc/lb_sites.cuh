// lb_sites.cuh — the D3Q19 binary-fluid site functions, written once.
//
// The seven lattice-Boltzmann site functions of repro_torch/lb/stencil.py
// (stream, grad6, moment, collide, fused, phi_stream, fused_two) as
// templates over a *neighbour accessor*: a site function reads
// nb.at(field, slot, comp, lane) and writes nb.put(out, comp, lane, value),
// and never sees the memory layout.  Two launchers instantiate them and
// differ only in the accessor they pass:
//
//   tdp_gathered.cu  GatheredNb  — (noffsets, ncomp, n) neighbour stacks
//                                  and (ncomp, n) pointwise arrays;
//   tdp_windowed.cu  WindowedNb  — halo-extended (ncomp, X+2r, Y+2r, Z+2r)
//                                  grids, offsets resolved in the kernel.
//
// lb_collision.cu runs collide_core() over plain SoA arrays.
//
// One thread covers VVL consecutive sites (the paper's TARGET_TLP strip,
// TARGET_ILP lanes); the per-thread bodies gathered_thread() and
// windowed_thread() are __host__ __device__, so the same code runs in a
// host loop for testing on a machine without a card.
//
// The velocity set, weights and stencil slot tables are compile-time, so
// products with c = 0 and c = ±1 fold away.  Arithmetic keeps the plain
// version's association order (cu*cu, phi*phi*phi, ascending-q phi sums,
// the grad6 Laplacian order); FMA contraction still changes rounding, so
// the card is held to tolerances, not to bit-identity.  Every index is
// 64-bit: the one-launch g-stack at 128^3 has 57*19*2^21 > INT_MAX entries.
#pragma once

#include <cstdint>

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

constexpr int NVEL = 19;
constexpr int MAX_IN = 5;
constexpr int MAX_OUT = 2;

// Error codes of the C entries besides cudaError_t values (all positive).
constexpr int ERR_BAD_SITE = -1;
constexpr int ERR_BAD_VVL = -2;

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
struct Phys {
  float A, B, kappa, tau, tau_phi, gamma, fcoef, g3;
};

inline Phys make_phys(float A, float B, float kappa, float tau, float tau_phi,
                      float gamma) {
  return Phys{A, B, kappa, tau, tau_phi, gamma,
              (float)(1.0 - 0.5 / (double)tau), (float)(3.0 * (double)gamma)};
}

// sum_d c_qd v_d with the zero terms dropped and the unit products folded
__host__ __device__ __forceinline__ float cdot(int q, const float (&v)[3]) {
  float s = 0.0f;
  bool first = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int c = cv(q, d);
    if (c == 0) continue;
    const float t = c > 0 ? v[d] : -v[d];
    s = first ? t : s + t;
    first = false;
  }
  return s;
}

// D3Q19 binary BGK collision of one site with the chemical potential
// mu = -A phi + B phi^3 - kappa lap(phi) fused in and Guo forcing F = mu grad(phi)
// (repro_torch.kernels.lb_collision.collision_site_kernel).
__host__ __device__ __forceinline__ void collide_core(
    const float (&f)[NVEL], const float (&g)[NVEL], float phi,
    const float (&grad)[3], float lap, const Phys& p, float (&fo)[NVEL],
    float (&go)[NVEL]) {
  const float mu = -p.A * phi + p.B * phi * phi * phi - p.kappa * lap;
  float F[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) F[d] = mu * grad[d];

  float rho = f[0];
#pragma unroll
  for (int q = 1; q < NVEL; ++q) rho += f[q];
  float u[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float m = 0.0f;
    bool first = true;
#pragma unroll
    for (int q = 1; q < NVEL; ++q) {
      const int c = cv(q, d);
      if (c == 0) continue;
      const float t = c > 0 ? f[q] : -f[q];
      m = first ? t : m + t;
      first = false;
    }
    u[d] = (m + 0.5f * F[d]) / rho;
  }
  const float usq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
  const float uf = u[0] * F[0] + u[1] * F[1] + u[2] * F[2];

  float gt[NVEL];
#pragma unroll
  for (int q = 0; q < NVEL; ++q) {
    const float w = wq(q);
    const float cu = cdot(q, u);
    const float cf = cdot(q, F);
    const float feq = w * rho * (1.0f + 3.0f * cu + 4.5f * cu * cu - 1.5f * usq);
    const float fterm = p.fcoef * w * (3.0f * (cf - uf) + 9.0f * cu * cf);
    fo[q] = f[q] - (f[q] - feq) / p.tau + fterm;
    gt[q] = w * (p.g3 * mu + 3.0f * phi * cu);
  }
  float gsum = gt[0];
#pragma unroll
  for (int q = 1; q < NVEL; ++q) gsum += gt[q];
  const float g0 = phi - (gsum - gt[0]);
  go[0] = g[0] - (g[0] - g0) / p.tau_phi;
#pragma unroll
  for (int q = 1; q < NVEL; ++q) go[q] = g[q] - (g[q] - gt[q]) / p.tau_phi;
}

// grad(phi) and lap(phi) from phi at the 7 grad-star slots (centre, +x, -x,
// +y, -y, +z, -z) in the plain version's accumulation order.
__host__ __device__ __forceinline__ void grad6_from_p(const float (&p)[7],
                                                      float (&grad)[3],
                                                      float& lap) {
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
  __host__ __device__ static constexpr int ncomp_in(int) { return NVEL; }
  __host__ __device__ static constexpr int stencil(int) { return ST_PULL; }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys&) {
#pragma unroll
    for (int q = 0; q < NVEL; ++q) nb.put(0, q, lane, nb.at(0, pull_idx(q), q, lane));
  }
};

struct Grad6Site {
  static constexpr int NIN = 1, NOUT = 2;
  __host__ __device__ static constexpr int ncomp_in(int) { return 1; }
  __host__ __device__ static constexpr int stencil(int) { return ST_GRAD6; }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys&) {
    float p[7], grad[3], lap;
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
  __host__ __device__ static constexpr int ncomp_in(int) { return NVEL; }
  __host__ __device__ static constexpr int stencil(int) { return ST_POINT; }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys&) {
    float acc = nb.at(0, 0, 0, lane);
#pragma unroll
    for (int q = 1; q < NVEL; ++q) acc += nb.at(0, 0, q, lane);
    nb.put(0, 0, lane, acc);
  }
};

template <class Nb>
__host__ __device__ __forceinline__ void put_fg(const Nb& nb, int lane,
                                                const float (&fo)[NVEL],
                                                const float (&go)[NVEL]) {
#pragma unroll
  for (int q = 0; q < NVEL; ++q) {
    nb.put(0, q, lane, fo[q]);
    nb.put(1, q, lane, go[q]);
  }
}

struct CollideSite {  // fields: f, g, phi, gradphi, del2phi (all pointwise)
  static constexpr int NIN = 5, NOUT = 2;
  __host__ __device__ static constexpr int ncomp_in(int i) {
    return i < 2 ? NVEL : (i == 3 ? 3 : 1);
  }
  __host__ __device__ static constexpr int stencil(int) { return ST_POINT; }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys& p) {
    float f[NVEL], g[NVEL], grad[3], fo[NVEL], go[NVEL];
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

struct FusedSite {  // fields: f (pull), g (fused_g, radius 2)
  static constexpr int NIN = 2, NOUT = 2;
  __host__ __device__ static constexpr int ncomp_in(int) { return NVEL; }
  __host__ __device__ static constexpr int stencil(int i) {
    return i == 0 ? ST_PULL : ST_FUSED_G;
  }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys& p) {
    float f[NVEL], g[NVEL], ph[7], grad[3], lap, fo[NVEL], go[NVEL];
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
      float acc = nb.at(1, fused_g_idx(d, 0), 0, lane);
#pragma unroll
      for (int q = 1; q < NVEL; ++q) acc = acc + nb.at(1, fused_g_idx(d, q), q, lane);
      ph[d] = acc;
    }
    grad6_from_p(ph, grad, lap);
    collide_core(f, g, ph[0], grad, lap, p, fo, go);
    put_fg(nb, lane, fo, go);
  }
};

struct PhiStreamSite {  // field: g (pull)
  static constexpr int NIN = 1, NOUT = 1;
  __host__ __device__ static constexpr int ncomp_in(int) { return NVEL; }
  __host__ __device__ static constexpr int stencil(int) { return ST_PULL; }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys&) {
    float acc = nb.at(0, pull_idx(0), 0, lane);
#pragma unroll
    for (int q = 1; q < NVEL; ++q) acc = acc + nb.at(0, pull_idx(q), q, lane);
    nb.put(0, 0, lane, acc);
  }
};

struct FusedTwoSite {  // fields: f (pull), g (pull), phi_streamed (grad6)
  static constexpr int NIN = 3, NOUT = 2;
  __host__ __device__ static constexpr int ncomp_in(int i) { return i < 2 ? NVEL : 1; }
  __host__ __device__ static constexpr int stencil(int i) {
    return i < 2 ? ST_PULL : ST_GRAD6;
  }
  template <class Nb>
  __host__ __device__ static void run(const Nb& nb, int lane, const Phys& p) {
    float f[NVEL], g[NVEL], ph[7], grad[3], lap, fo[NVEL], go[NVEL];
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
// accessors and per-thread bodies
// ---------------------------------------------------------------------------

// Gathered operands: stencil field f is a (noffsets, ncomp, n) stack, a
// pointwise field a (ncomp, n) array; outputs are (ncomp, n).
struct GatheredIO {
  const float* in[MAX_IN];
  float* out[MAX_OUT];
  int64_t n;
  Phys phys;
};

template <class Site>
struct GatheredNb {
  const GatheredIO& io;
  int64_t site0;
  __host__ __device__ __forceinline__ float at(int f, int slot, int c, int lane) const {
    return ldg(io.in[f] + ((int64_t)slot * Site::ncomp_in(f) + c) * io.n + site0 + lane);
  }
  __host__ __device__ __forceinline__ void put(int k, int c, int lane, float v) const {
    io.out[k][(int64_t)c * io.n + site0 + lane] = v;
  }
};

// Thread t covers sites [t*VVL, t*VVL + VVL); the ragged last strip is masked.
template <class Site, int VVL>
__host__ __device__ __forceinline__ void gathered_thread(const GatheredIO& io, int64_t t) {
  const int64_t site0 = t * VVL;
  if (site0 >= io.n) return;
  const GatheredNb<Site> nb{io, site0};
#pragma unroll
  for (int l = 0; l < VVL; ++l)
    if (site0 + l < io.n) Site::run(nb, l, io.phys);
}

template <int VVL>
__host__ __device__ __forceinline__ int64_t gathered_threads(const GatheredIO& io) {
  return (io.n + VVL - 1) / VVL;
}

// Halo-extended operands: stencil field f is a (ncomp, X+2r, Y+2r, Z+2r)
// grid with r = st_radius(Site::stencil(f)); pointwise fields and outputs
// are (ncomp, X*Y*Z) over the interior.
struct WindowedIO {
  const float* in[MAX_IN];
  float* out[MAX_OUT];
  int X, Y, Z;
  int64_t n;
  Phys phys;
};

template <class Site>
struct WindowedNb {
  const WindowedIO& io;
  int x, y, z0;
  int64_t site0;
  __host__ __device__ __forceinline__ float at(int f, int slot, int c, int lane) const {
    const int st = Site::stencil(f);
    if (st == ST_POINT) return ldg(io.in[f] + (int64_t)c * io.n + site0 + lane);
    const int r = st_radius(st);
    const int64_t ye = io.Y + 2 * r, ze = io.Z + 2 * r;
    const int64_t xx = x + r + st_off(st, slot, 0);
    const int64_t yy = y + r + st_off(st, slot, 1);
    const int64_t zz = z0 + lane + r + st_off(st, slot, 2);
    return ldg(io.in[f] + (((int64_t)c * (io.X + 2 * r) + xx) * ye + yy) * ze + zz);
  }
  __host__ __device__ __forceinline__ void put(int k, int c, int lane, float v) const {
    io.out[k][(int64_t)c * io.n + site0 + lane] = v;
  }
};

// Thread t covers VVL consecutive z-sites of one (x, y) row of the interior,
// so neighbouring threads read neighbouring addresses.
template <class Site, int VVL>
__host__ __device__ __forceinline__ void windowed_thread(const WindowedIO& io, int64_t t) {
  const int nzb = (io.Z + VVL - 1) / VVL;
  if (t >= (int64_t)io.X * io.Y * nzb) return;
  const int zb = (int)(t % nzb);
  const int64_t xy = t / nzb;
  const int y = (int)(xy % io.Y), x = (int)(xy / io.Y);
  const int z0 = zb * VVL;
  const WindowedNb<Site> nb{io, x, y, z0, ((int64_t)x * io.Y + y) * io.Z + z0};
#pragma unroll
  for (int l = 0; l < VVL; ++l)
    if (z0 + l < io.Z) Site::run(nb, l, io.phys);
}

template <int VVL>
__host__ __device__ __forceinline__ int64_t windowed_threads(const WindowedIO& io) {
  return (int64_t)io.X * io.Y * ((io.Z + VVL - 1) / VVL);
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
