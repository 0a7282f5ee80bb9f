// tdp_gathered.cu — the targetDP site-kernel executor on Hopper (LB sites).
//
// Replaces: src/repro/kernels/tdp_pointwise.py:_run_pallas (the Pallas
// executor behind Target("pallas"): one grid step per VVL chunk of sites,
// (ncomp, VVL) pointwise and (noffsets, ncomp, VVL) gathered blocks).
//
// Design: one thread per VVL consecutive z-sites of one (x, y) row (the
// paper's CUDA TARGET_TLP/TARGET_ILP mapping), VVL in {1, 2, 4, 8} as a
// template parameter; the ragged end of a row is masked, nothing is
// padded.  A stencil field arrives as the caller's own (ncomp, X+2hx,
// Y+2hy, Z+2hz) array and the neighbour accessor (FieldNb, lb_sites.cuh)
// reads each neighbour in place, wrapping periodic dimensions itself: the
// (noffsets, ncomp, n) stack of the reference's gather prologue is never
// built.  A launch with no stencil field runs as one (1, 1, n) row.  No
// shared memory.
//
// Bound on the H100 (3.35 TB/s): device-memory bytes, each input read once
// and each output written once: collide 324, moment 80, stream 152,
// phi_stream 80, grad6 20, fused_two 308, fused 304 bytes/site in float32,
// half of each in bfloat16.
//
// bfloat16 (the dtype code DTYPE_BF16, bf16.cuh): the same site functions
// instantiated for FieldIOT<tdp::bf16>, every operand and output bfloat16,
// each operation rounded as the reference's body rounds it (lb_sites.cuh);
// the AoSoA and ensemble entries take float32 only.  The
// kernel issues one load per (offset, component) a site function names (19
// for stream, 7·19 for fused's g); neighbouring threads read neighbouring
// addresses, and reuse between neighbouring sites is left to L1/L2.
//
// The AoSoA branch (Target(layout="aosoa"), the reference's :96-170):
// tdp_gathered_aosoa_launch runs the same seven site functions through
// AosoaNb (lb_sites.cuh) over AoSoA blocks of W sites, one thread per site,
// and writes AoSoA outputs (the wrapper turns them back into SoA).  The
// operands are the wrapper's AoSoA copies of the fields, so the kernel's
// bytes are those of the SoA kernel; the two boundary transforms move the
// fields' and outputs' bytes once more each.
//
// The ensemble branch (a fleet's stage; the reference vmaps the compiled
// step, which adds a grid axis to this pallas_call): tdp_gathered_ensemble_
// launch runs the same site functions over B members in one launch, member
// on blockIdx.y, each member's operands at its own 64-bit offset
// (EnsembleIO, lb_sites.cuh) and its physics from row blockIdx.y of a
// device table built by make_phys_rows, so a member computes what its
// single launch computes.  Bound: B times the single launch's bytes.
#include <cuda_runtime.h>

#include <type_traits>

#include "lb_sites.cuh"

// The library is built as seventeen translation units compiled in
// parallel (kernels/_build.py UNITS) and linked: TDP_UNIT 1-4 compile the
// float32 SoA kernels at VVL 1, 2, 4 and 8 (unit 1 also the SoA entry), 5
// the AoSoA entry, 6-9 the ensemble kernels at VVL 1, 2, 4 and 8 (unit 6
// also the ensemble entries), 10-13 the bfloat16 SoA kernels of every site
// function but the two fused ones at VVL 1, 2, 4 and 8, and 14-17 those of
// fused and fused_two; unset, all of them.  Each unit instantiates only the
// kernels it launches, so no unit is the build's long pole alone.
#ifndef TDP_UNIT
#define TDP_UNIT_HAS(k) 1
#else
#define TDP_UNIT_HAS(k) (TDP_UNIT == (k))
#endif

namespace {

constexpr int kBlock = 128;

template <class Site, int VVL, class T>
__global__ void __launch_bounds__(kBlock)
    field_kernel(const __grid_constant__ tdp::FieldIOT<T> io) {
  tdp::field_thread<Site, VVL>(io, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <class Site, int VVL>
struct Launch {
  template <class T>
  static int run(const tdp::FieldIOT<T>& io, void* stream) {
    if (const int rc = tdp::check_geometry(io, Site::RADIUS)) return rc;
    const int64_t threads = tdp::field_threads<VVL>(io);
    if (threads == 0) return 0;
    const unsigned blocks = (unsigned)((threads + kBlock - 1) / kBlock);
    field_kernel<Site, VVL, T><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(io);
    return (int)cudaGetLastError();
  }
};

template <class Site>
__global__ void __launch_bounds__(kBlock)
    aosoa_kernel(const __grid_constant__ tdp::AosoaIO a) {
  tdp::aosoa_thread<Site>(a, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <class Site>
struct AosoaLaunch {
  static int run(const tdp::AosoaIO& a, void* stream) {
    if (const int rc = tdp::check_geometry(a.io, Site::RADIUS)) return rc;
    if (a.io.n == 0) return 0;
    const unsigned blocks = (unsigned)((a.io.n + kBlock - 1) / kBlock);
    aosoa_kernel<Site><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
};

template <class Site, int VVL>
__global__ void __launch_bounds__(kBlock)
    field_ensemble_kernel(const __grid_constant__ tdp::EnsembleIO e) {
  const tdp::FieldIO io = tdp::member_io(e, (int)blockIdx.y);
  tdp::field_thread<Site, VVL>(io, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <class Site, int VVL>
struct EnsembleLaunch {
  static int run(const tdp::EnsembleIO& e, void* stream) {
    if (const int rc = tdp::check_geometry(e.io, Site::RADIUS)) return rc;
    const int64_t threads = tdp::field_threads<VVL>(e.io);
    if (threads == 0) return 0;
    const dim3 grid((unsigned)((threads + kBlock - 1) / kBlock), (unsigned)e.B);
    field_ensemble_kernel<Site, VVL><<<grid, kBlock, 0, (cudaStream_t)stream>>>(e);
    return (int)cudaGetLastError();
  }
};

// The part of the bfloat16 SoA kernels of one VVL a site function's kernel
// is compiled in: 1 for the two fused site functions, 0 for the rest.
template <class Site>
constexpr int site_part() {
  return std::is_same_v<Site, tdp::FusedSite> || std::is_same_v<Site, tdp::FusedTwoSite>;
}

// L<Site, V> at the one VVL V, and of part P of the site functions (every
// one when P < 0): tdp::dispatch_site instantiates no other kernels
// through it.
template <template <class, int> class L, int V, int P = -1>
struct AtVvl {
  template <class Site, int VVL>
  struct Launch {
    template <class IO>
    static int run(const IO& io, void* stream) {
      if constexpr (VVL == V && (P < 0 || site_part<Site>() == P)) {
        return L<Site, VVL>::run(io, stream);
      } else {
        return tdp::ERR_BAD_VVL;
      }
    }
  };
};

// An unknown site before an unknown VVL, as tdp::dispatch_site reports them.
constexpr int bad_site_or_vvl(int site) {
  return site < tdp::SITE_STREAM || site > tdp::SITE_FUSED_TWO ? tdp::ERR_BAD_SITE
                                                               : tdp::ERR_BAD_VVL;
}

}  // namespace

// The SoA and ensemble launches at one VVL V (the SoA ones at one storage
// type T and part P of the site functions): every unit declares them, and
// one unit alone instantiates each (extern template: no other unit compiles
// their kernels).
namespace tdp_gathered_units {
template <int V, class T, int P = -1>
int soa(int site, const tdp::FieldIOT<T>& io, void* stream) {
  return tdp::dispatch_site<AtVvl<Launch, V, P>::template Launch>(site, V, io, stream);
}
template <int V>
int ensemble(int site, const tdp::EnsembleIO& e, void* stream) {
  return tdp::dispatch_site<AtVvl<EnsembleLaunch, V>::template Launch>(site, V, e,
                                                                       stream);
}
extern template int soa<1, float>(int, const tdp::FieldIO&, void*);
extern template int soa<2, float>(int, const tdp::FieldIO&, void*);
extern template int soa<4, float>(int, const tdp::FieldIO&, void*);
extern template int soa<8, float>(int, const tdp::FieldIO&, void*);
extern template int soa<1, tdp::bf16, 0>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
extern template int soa<2, tdp::bf16, 0>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
extern template int soa<4, tdp::bf16, 0>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
extern template int soa<8, tdp::bf16, 0>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
extern template int soa<1, tdp::bf16, 1>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
extern template int soa<2, tdp::bf16, 1>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
extern template int soa<4, tdp::bf16, 1>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
extern template int soa<8, tdp::bf16, 1>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
extern template int ensemble<1>(int, const tdp::EnsembleIO&, void*);
extern template int ensemble<2>(int, const tdp::EnsembleIO&, void*);
extern template int ensemble<4>(int, const tdp::EnsembleIO&, void*);
extern template int ensemble<8>(int, const tdp::EnsembleIO&, void*);
#if TDP_UNIT_HAS(1)
template int soa<1, float>(int, const tdp::FieldIO&, void*);
#endif
#if TDP_UNIT_HAS(2)
template int soa<2, float>(int, const tdp::FieldIO&, void*);
#endif
#if TDP_UNIT_HAS(3)
template int soa<4, float>(int, const tdp::FieldIO&, void*);
#endif
#if TDP_UNIT_HAS(4)
template int soa<8, float>(int, const tdp::FieldIO&, void*);
#endif
#if TDP_UNIT_HAS(10)
template int soa<1, tdp::bf16, 0>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
#endif
#if TDP_UNIT_HAS(11)
template int soa<2, tdp::bf16, 0>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
#endif
#if TDP_UNIT_HAS(12)
template int soa<4, tdp::bf16, 0>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
#endif
#if TDP_UNIT_HAS(13)
template int soa<8, tdp::bf16, 0>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
#endif
#if TDP_UNIT_HAS(14)
template int soa<1, tdp::bf16, 1>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
#endif
#if TDP_UNIT_HAS(15)
template int soa<2, tdp::bf16, 1>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
#endif
#if TDP_UNIT_HAS(16)
template int soa<4, tdp::bf16, 1>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
#endif
#if TDP_UNIT_HAS(17)
template int soa<8, tdp::bf16, 1>(int, const tdp::FieldIOT<tdp::bf16>&, void*);
#endif
#if TDP_UNIT_HAS(6)
template int ensemble<1>(int, const tdp::EnsembleIO&, void*);
#endif
#if TDP_UNIT_HAS(7)
template int ensemble<2>(int, const tdp::EnsembleIO&, void*);
#endif
#if TDP_UNIT_HAS(8)
template int ensemble<4>(int, const tdp::EnsembleIO&, void*);
#endif
#if TDP_UNIT_HAS(9)
template int ensemble<8>(int, const tdp::EnsembleIO&, void*);
#endif
}  // namespace tdp_gathered_units

#if TDP_UNIT_HAS(1)
namespace {
// The SoA launch at part P of the site functions (every one when P < 0).
template <class T, int P>
int soa_launch(int site, int vvl, const tdp::FieldIOT<T>& io, void* stream) {
  switch (vvl) {
    case 1: return tdp_gathered_units::soa<1, T, P>(site, io, stream);
    case 2: return tdp_gathered_units::soa<2, T, P>(site, io, stream);
    case 4: return tdp_gathered_units::soa<4, T, P>(site, io, stream);
    case 8: return tdp_gathered_units::soa<8, T, P>(site, io, stream);
    default: return bad_site_or_vvl(site);
  }
}
}  // namespace

// in[i] / out[k]: device pointers of the site function's fields and outputs
// (contiguous, of the storage type `dtype`, tdp::DtypeId): a stencil field
// (ncomp, X+2hx, Y+2hy, Z+2hz), a pointwise field and an output (ncomp,
// X*Y*Z).  phys: one host tdp::Phys (8 floats; for bfloat16 every one
// rounded to bfloat16).  Returns 0, a cudaError_t, or tdp::ERR_BAD_SITE /
// ERR_BAD_VVL / ERR_GEOMETRY / ERR_BAD_DTYPE.
extern "C" int tdp_gathered_launch(int site, int vvl, int dtype, const void* const* in,
                                   void* const* out, int X, int Y, int Z, int hx, int hy,
                                   int hz, const void* phys, void* stream) {
  switch (dtype) {
    case tdp::DTYPE_F32:
      return soa_launch<float, -1>(
          site, vvl, tdp::make_field_io<float>(in, out, X, Y, Z, hx, hy, hz, phys), stream);
    case tdp::DTYPE_BF16: {
      const tdp::FieldIOT<tdp::bf16> io =
          tdp::make_field_io<tdp::bf16>(in, out, X, Y, Z, hx, hy, hz, phys);
      return site == tdp::SITE_FUSED || site == tdp::SITE_FUSED_TWO
                 ? soa_launch<tdp::bf16, 1>(site, vvl, io, stream)
                 : soa_launch<tdp::bf16, 0>(site, vvl, io, stream);
    }
    default: return tdp::ERR_BAD_DTYPE;
  }
}
#endif  // TDP_UNIT_HAS(1)

#if TDP_UNIT_HAS(5)
// The AoSoA launch: in[i] is field i's AoSoA buffer, blocks of W sites over
// a pointwise field's X*Y*Z sites or a stencil field's flat extended grid
// (x-planes of `plane` sites); out[k] is AoSoA over the interior.  W >= 1.
// Returns 0, a cudaError_t, or tdp::ERR_BAD_SITE / ERR_BAD_VVL (W < 1) /
// ERR_GEOMETRY.
extern "C" int tdp_gathered_aosoa_launch(int site, int W, const void* const* in,
                                         void* const* out, int X, int Y, int Z,
                                         int hx, int hy, int hz, int plane,
                                         float A, float B, float kappa, float tau,
                                         float tau_phi, float gamma, void* stream) {
  if (W < 1) return tdp::ERR_BAD_VVL;
  tdp::AosoaIO a{};
  for (int i = 0; i < tdp::MAX_IN; ++i) a.io.in[i] = static_cast<const float*>(in[i]);
  for (int k = 0; k < tdp::MAX_OUT; ++k) a.io.out[k] = static_cast<float*>(out[k]);
  a.io.X = X;
  a.io.Y = Y;
  a.io.Z = Z;
  a.io.hx = hx;
  a.io.hy = hy;
  a.io.hz = hz;
  a.io.n = (int64_t)X * Y * Z;
  a.io.phys = tdp::make_phys(A, B, kappa, tau, tau_phi, gamma);
  a.map = tdp::make_aosoa_map(W);
  a.plane = plane;
  a.soa_out = false;
  return tdp::dispatch_site_aosoa<AosoaLaunch>(site, a, stream);
}
#endif  // TDP_UNIT_HAS(5)

#if TDP_UNIT_HAS(6)
// The ensemble launch: B members (1 <= B <= 65535) of the single launch's
// operands, member m's at in[i] + m*in_stride[i] and out[k] +
// m*out_stride[k] (elements), its physics row m of `phys` (B tdp::Phys rows
// on the device, from tdp_phys_rows).  Returns 0, a cudaError_t, or
// tdp::ERR_BAD_SITE / ERR_BAD_VVL / ERR_GEOMETRY / ERR_ENSEMBLE.
extern "C" int tdp_gathered_ensemble_launch(int site, int vvl, int B,
                                            const void* const* in, void* const* out,
                                            const long long* in_stride,
                                            const long long* out_stride, int X, int Y,
                                            int Z, int hx, int hy, int hz,
                                            const void* phys, void* stream) {
  if (const int rc = tdp::check_ensemble(B)) return rc;
  const tdp::EnsembleIO e = tdp::make_ensemble_io(B, in, out, in_stride, out_stride, X,
                                                  Y, Z, hx, hy, hz, phys);
  switch (vvl) {
    case 1: return tdp_gathered_units::ensemble<1>(site, e, stream);
    case 2: return tdp_gathered_units::ensemble<2>(site, e, stream);
    case 4: return tdp_gathered_units::ensemble<4>(site, e, stream);
    case 8: return tdp_gathered_units::ensemble<8>(site, e, stream);
    default: return bad_site_or_vvl(site);
  }
}

// The host side of an ensemble's physics table: rows[m] = make_phys of
// consts[6m .. 6m+5] (A, B, kappa, tau, tau_phi, gamma), B rows of 8 floats.
extern "C" void tdp_phys_rows(int B, const float* consts, void* rows) {
  tdp::make_phys_rows(B, consts, static_cast<tdp::Phys*>(rows));
}
#endif  // TDP_UNIT_HAS(6)
