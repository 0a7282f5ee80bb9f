// tdp_windowed.cu — the gather-free targetDP stencil executor on Hopper.
//
// Replaces: src/repro/kernels/tdp_windowed.py:windowed_execute (the Pallas
// executor behind Target("pallas_windowed"): x-plane windows of each
// halo-extended field DMA'd into VMEM, neighbour offsets resolved in the
// kernel).
//
// Design: each stencil field arrives as the caller's own (ncomp, X+2hx,
// Y+2hy, Z+2hz) array; periodic dimensions (h == 0) wrap inside the
// neighbour accessor (FieldNb, lb_sites.cuh), so no halo-extended copy is
// made.  stream, grad6, phi_stream and fused_two run one thread per VVL
// consecutive z-sites of one (x, y) row, as the gathered launcher does.
// fused runs in tiles (fused_tile_kernel): a block of 256/VVL threads
// takes plane_block x-planes by an 8 x 32 (y, z) patch plus a one-site
// rim, sums the streamed phi of tile and rim into shared memory (phase
// 1), then collides each tile site with its 7 grad-star phi from there and
// its pulled f and g (phase 2).  The reference's VMEM window becomes this
// tile: plane_block is its depth, and a tile past the 227 KB a block may
// hold is refused.
//
// Bound on the H100 (3.35 TB/s): device-memory bytes, each input read once
// and each output written once: fused 304, fused_two 308, stream 152,
// phi_stream 80, grad6 20 bytes/site in float32, half of each in bfloat16.
//
// bfloat16 (the dtype code DTYPE_BF16): the SoA entry's kernels
// instantiated for FieldIOT<tdp::bf16> (lb_sites.cuh), fused's tile
// included, whose shared-memory phi stays float32 (the bfloat16 phi
// widened), so plane_block's limit is the float32 one; the AoSoA and
// ensemble entries take float32 only.  The untiled fused read g at 133
// (slot, component) addresses a site; the tile reads it at 19 a site of
// tile and rim ((P+2)·10·34 / (P·8·32) of the tile's sites) plus 19 in
// phase 2, and its rims are shared in L2 by blocks in flight together.
// Loads go through the read-only cache (ldg), 19 independent ones a site
// in each phase; no cp.async or TMA, since the rim wraps and a box copy
// does not.
//
// The AoSoA branch (Target(layout="aosoa"), the reference's :41-56 and
// :102-206): tdp_windowed_aosoa_launch takes each field as AoSoA blocks of W
// sites, every x-plane in whole blocks (a stencil field's halo-widened
// planes zero-padded to a multiple of W), and writes SoA outputs, as the
// reference does.  stream, grad6, phi_stream and fused_two run one thread
// per site through AosoaNb; fused keeps its tile, 256 threads of one site
// each, whose phase 1 reads g from the AoSoA planes into the same
// shared-memory phi array and whose phase 2 reads f and g through AosoaNb.
//
// The ensemble branch (a fleet's stage): tdp_windowed_ensemble_launch runs
// B members in one launch, member on blockIdx.y (EnsembleIO, lb_sites.cuh):
// stream, grad6, phi_stream and fused_two as above, fused in the same tiles
// (fused_tile_ensemble_kernel), each member with its own physics row.
// Bound: B times the single launch's bytes.
#include <cuda_runtime.h>

#include <type_traits>

#include "lb_sites.cuh"

// The library is built as seven translation units compiled in parallel
// (kernels/_build.py UNITS) and linked: TDP_UNIT 1 compiles the SoA
// entry and its float32 kernels, 2 the AoSoA entry, 3 the ensemble
// entries, 4-7 the SoA entry's bfloat16 kernels at VVL 1, 2, 4 and 8;
// unset, all of them.  Each unit instantiates only the kernels it
// launches.
#ifndef TDP_UNIT
#define TDP_UNIT_HAS(k) 1
#else
#define TDP_UNIT_HAS(k) (TDP_UNIT == (k))
#endif

namespace {

constexpr int kBlock = 128;

template <class T>
struct WindowedArgs {
  tdp::FieldIOT<T> io;
  int plane_block;
};

template <class Site, int VVL, class T>
__global__ void __launch_bounds__(kBlock)
    field_kernel(const __grid_constant__ tdp::FieldIOT<T> io) {
  tdp::field_thread<Site, VVL>(io, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

// 16 warps an SM at least: at most 128 registers a thread.
// IO: tdp::FieldIOT<T> (SoA fields, VVL sites a thread) or tdp::AosoaIO
// (VVL 1).
template <int VVL, class IO>
__global__ void __launch_bounds__(tdp::tile_threads<VVL>(), 512 / tdp::tile_threads<VVL>())
    fused_tile_kernel(const __grid_constant__ IO io, int P) {
  extern __shared__ float phi[];
  tdp::fused_tile_phi<VVL>(io, P, blockIdx.x, threadIdx.x, phi);
  __syncthreads();
  tdp::fused_tile_collide<VVL>(io, P, blockIdx.x, threadIdx.x, phi);
}

template <int VVL, class IO>
int launch_tiled(const IO& io, int P, void* stream) {
  if (const int rc = tdp::check_tile(P)) return rc;
  const int64_t smem = tdp::tile_smem_bytes(P);
  const int64_t blocks = tdp::tile_blocks(tdp::field_io(io), P);
  if (blocks == 0) return 0;
  static bool granted = false;  // dynamic shared memory above 48 KB
  if (smem > 48 * 1024 && !granted) {
    const cudaError_t rc = cudaFuncSetAttribute(
        fused_tile_kernel<VVL, IO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tdp::SMEM_LIMIT);
    if (rc != cudaSuccess) return (int)rc;
    granted = true;
  }
  fused_tile_kernel<VVL, IO><<<(unsigned)blocks, tdp::tile_threads<VVL>(), (size_t)smem,
                               (cudaStream_t)stream>>>(io, P);
  return (int)cudaGetLastError();
}

template <class Site, int VVL>
struct Launch {
  template <class T>
  static int run(const WindowedArgs<T>& a, void* stream) {
    if (const int rc = tdp::check_geometry(a.io, Site::RADIUS)) return rc;
    if constexpr (std::is_same_v<Site, tdp::FusedSite>) {
      return launch_tiled<VVL>(a.io, a.plane_block, stream);
    } else {
      const int64_t threads = tdp::field_threads<VVL>(a.io);
      if (threads == 0) return 0;
      const unsigned blocks = (unsigned)((threads + kBlock - 1) / kBlock);
      field_kernel<Site, VVL, T><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(a.io);
      return (int)cudaGetLastError();
    }
  }
};

// Launch<Site, V> at the one VVL V (each bfloat16 unit compiles one VVL).
template <int V>
struct AtVvl {
  template <class Site, int VVL>
  struct At {
    template <class A>
    static int run(const A& a, void* stream) {
      if constexpr (VVL == V) {
        return Launch<Site, VVL>::run(a, stream);
      } else {
        return tdp::ERR_BAD_VVL;
      }
    }
  };
};

struct WindowedEnsembleArgs {
  tdp::EnsembleIO e;
  int plane_block;
};

template <class Site, int VVL>
__global__ void __launch_bounds__(kBlock)
    field_ensemble_kernel(const __grid_constant__ tdp::EnsembleIO e) {
  const tdp::FieldIO io = tdp::member_io(e, (int)blockIdx.y);
  tdp::field_thread<Site, VVL>(io, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <int VVL>
__global__ void __launch_bounds__(tdp::tile_threads<VVL>(), 512 / tdp::tile_threads<VVL>())
    fused_tile_ensemble_kernel(const __grid_constant__ tdp::EnsembleIO e, int P) {
  extern __shared__ float phi[];
  const tdp::FieldIO io = tdp::member_io(e, (int)blockIdx.y);
  tdp::fused_tile_phi<VVL>(io, P, blockIdx.x, threadIdx.x, phi);
  __syncthreads();
  tdp::fused_tile_collide<VVL>(io, P, blockIdx.x, threadIdx.x, phi);
}

template <int VVL>
int launch_tiled_ensemble(const tdp::EnsembleIO& e, int P, void* stream) {
  if (const int rc = tdp::check_tile(P)) return rc;
  const int64_t smem = tdp::tile_smem_bytes(P);
  const int64_t blocks = tdp::tile_blocks(e.io, P);
  if (blocks == 0) return 0;
  static bool granted = false;  // dynamic shared memory above 48 KB
  if (smem > 48 * 1024 && !granted) {
    const cudaError_t rc = cudaFuncSetAttribute(fused_tile_ensemble_kernel<VVL>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                (int)tdp::SMEM_LIMIT);
    if (rc != cudaSuccess) return (int)rc;
    granted = true;
  }
  const dim3 grid((unsigned)blocks, (unsigned)e.B);
  fused_tile_ensemble_kernel<VVL><<<grid, tdp::tile_threads<VVL>(), (size_t)smem,
                                    (cudaStream_t)stream>>>(e, P);
  return (int)cudaGetLastError();
}

template <class Site, int VVL>
struct EnsembleLaunch {
  static int run(const WindowedEnsembleArgs& a, void* stream) {
    if (const int rc = tdp::check_geometry(a.e.io, Site::RADIUS)) return rc;
    if constexpr (std::is_same_v<Site, tdp::FusedSite>) {
      return launch_tiled_ensemble<VVL>(a.e, a.plane_block, stream);
    } else {
      const int64_t threads = tdp::field_threads<VVL>(a.e.io);
      if (threads == 0) return 0;
      const dim3 grid((unsigned)((threads + kBlock - 1) / kBlock), (unsigned)a.e.B);
      field_ensemble_kernel<Site, VVL><<<grid, kBlock, 0, (cudaStream_t)stream>>>(a.e);
      return (int)cudaGetLastError();
    }
  }
};

struct WindowedAosoaArgs {
  tdp::AosoaIO a;
  int plane_block;
};

template <class Site>
__global__ void __launch_bounds__(kBlock)
    aosoa_kernel(const __grid_constant__ tdp::AosoaIO a) {
  tdp::aosoa_thread<Site>(a, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <class Site>
struct AosoaLaunch {
  static int run(const WindowedAosoaArgs& w, void* stream) {
    if (const int rc = tdp::check_geometry(w.a.io, Site::RADIUS)) return rc;
    if constexpr (std::is_same_v<Site, tdp::FusedSite>) {
      return launch_tiled<1>(w.a, w.plane_block, stream);
    } else {
      if (w.a.io.n == 0) return 0;
      const unsigned blocks = (unsigned)((w.a.io.n + kBlock - 1) / kBlock);
      aosoa_kernel<Site><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(w.a);
      return (int)cudaGetLastError();
    }
  }
};

}  // namespace

// The SoA launches: float32 at every VVL, bfloat16 at one VVL V.  Every
// unit declares them, and one unit alone instantiates each (extern
// template: no other unit compiles their kernels).
namespace tdp_windowed_units {
template <class T>
int soa(int site, int vvl, int plane_block, const tdp::FieldIOT<T>& io, void* stream) {
  return tdp::dispatch_site<Launch>(site, vvl, WindowedArgs<T>{io, plane_block}, stream);
}
template <int V>
int soa_bf16(int site, int plane_block, const tdp::FieldIOT<tdp::bf16>& io, void* stream) {
  return tdp::dispatch_site<AtVvl<V>::template At>(
      site, V, WindowedArgs<tdp::bf16>{io, plane_block}, stream);
}
extern template int soa<float>(int, int, int, const tdp::FieldIO&, void*);
extern template int soa_bf16<1>(int, int, const tdp::FieldIOT<tdp::bf16>&, void*);
extern template int soa_bf16<2>(int, int, const tdp::FieldIOT<tdp::bf16>&, void*);
extern template int soa_bf16<4>(int, int, const tdp::FieldIOT<tdp::bf16>&, void*);
extern template int soa_bf16<8>(int, int, const tdp::FieldIOT<tdp::bf16>&, void*);
#if TDP_UNIT_HAS(1)
template int soa<float>(int, int, int, const tdp::FieldIO&, void*);
#endif
#if TDP_UNIT_HAS(4)
template int soa_bf16<1>(int, int, const tdp::FieldIOT<tdp::bf16>&, void*);
#endif
#if TDP_UNIT_HAS(5)
template int soa_bf16<2>(int, int, const tdp::FieldIOT<tdp::bf16>&, void*);
#endif
#if TDP_UNIT_HAS(6)
template int soa_bf16<4>(int, int, const tdp::FieldIOT<tdp::bf16>&, void*);
#endif
#if TDP_UNIT_HAS(7)
template int soa_bf16<8>(int, int, const tdp::FieldIOT<tdp::bf16>&, void*);
#endif
}  // namespace tdp_windowed_units

#if TDP_UNIT_HAS(1)
// in[i]: the (ncomp, X+2hx, Y+2hy, Z+2hz) array of stencil field i or the
// (ncomp, X*Y*Z) array of a pointwise one; out[k]: (ncomp, X*Y*Z);
// contiguous, of the storage type `dtype` (tdp::DtypeId).  plane_block:
// the x-depth of fused's tiles.  phys: one host tdp::Phys (bfloat16: every
// value rounded to bfloat16).  Returns 0, a cudaError_t, or
// tdp::ERR_BAD_SITE / ERR_BAD_VVL / ERR_GEOMETRY / ERR_PLANE_BLOCK /
// ERR_BAD_DTYPE.
extern "C" int tdp_windowed_launch(int site, int vvl, int plane_block, int dtype,
                                   const void* const* in, void* const* out, int X, int Y,
                                   int Z, int hx, int hy, int hz, const void* phys,
                                   void* stream) {
  switch (dtype) {
    case tdp::DTYPE_F32:
      return tdp_windowed_units::soa<float>(
          site, vvl, plane_block,
          tdp::make_field_io<float>(in, out, X, Y, Z, hx, hy, hz, phys), stream);
    case tdp::DTYPE_BF16: {
      const tdp::FieldIOT<tdp::bf16> io =
          tdp::make_field_io<tdp::bf16>(in, out, X, Y, Z, hx, hy, hz, phys);
      switch (vvl) {
        case 1: return tdp_windowed_units::soa_bf16<1>(site, plane_block, io, stream);
        case 2: return tdp_windowed_units::soa_bf16<2>(site, plane_block, io, stream);
        case 4: return tdp_windowed_units::soa_bf16<4>(site, plane_block, io, stream);
        case 8: return tdp_windowed_units::soa_bf16<8>(site, plane_block, io, stream);
        default:
          return site < tdp::SITE_STREAM || site > tdp::SITE_FUSED_TWO ? tdp::ERR_BAD_SITE
                                                                       : tdp::ERR_BAD_VVL;
      }
    }
    default: return tdp::ERR_BAD_DTYPE;
  }
}
#endif  // TDP_UNIT_HAS(1)

#if TDP_UNIT_HAS(2)
// The AoSoA launch: in[i] is field i's AoSoA buffer, blocks of W sites, each
// x-plane in whole blocks: a pointwise field's planes of Y*Z sites (W must
// divide Y*Z), a stencil field's extended planes padded to `plane` sites (a
// multiple of W).  out[k]: SoA (ncomp, X*Y*Z).  Returns 0, a cudaError_t, or
// tdp::ERR_BAD_SITE / ERR_BAD_VVL (W < 1, or W not dividing Y*Z or `plane`)
// / ERR_GEOMETRY / ERR_PLANE_BLOCK.
extern "C" int tdp_windowed_aosoa_launch(int site, int W, int plane_block,
                                         const void* const* in, void* const* out,
                                         int X, int Y, int Z, int hx, int hy, int hz,
                                         int plane, float A, float B, float kappa,
                                         float tau, float tau_phi, float gamma,
                                         void* stream) {
  if (W < 1 || ((int64_t)Y * Z) % W || plane % W) return tdp::ERR_BAD_VVL;
  WindowedAosoaArgs w{};
  tdp::FieldIO& io = w.a.io;
  for (int i = 0; i < tdp::MAX_IN; ++i) io.in[i] = static_cast<const float*>(in[i]);
  for (int k = 0; k < tdp::MAX_OUT; ++k) io.out[k] = static_cast<float*>(out[k]);
  io.X = X;
  io.Y = Y;
  io.Z = Z;
  io.hx = hx;
  io.hy = hy;
  io.hz = hz;
  io.n = (int64_t)X * Y * Z;
  io.phys = tdp::make_phys(A, B, kappa, tau, tau_phi, gamma);
  w.a.map = tdp::make_aosoa_map(W);
  w.a.plane = plane;
  w.a.soa_out = true;
  w.plane_block = plane_block;
  return tdp::dispatch_site_aosoa<AosoaLaunch>(site, w, stream);
}
#endif  // TDP_UNIT_HAS(2)

#if TDP_UNIT_HAS(3)
// The ensemble launch: B members (1 <= B <= 65535) of the single launch's
// operands, member m's at in[i] + m*in_stride[i] and out[k] +
// m*out_stride[k] (elements), its physics row m of `phys` (B tdp::Phys rows
// on the device).  Returns 0, a cudaError_t, or tdp::ERR_BAD_SITE /
// ERR_BAD_VVL / ERR_GEOMETRY / ERR_PLANE_BLOCK / ERR_ENSEMBLE.
extern "C" int tdp_windowed_ensemble_launch(int site, int vvl, int plane_block, int B,
                                            const void* const* in, void* const* out,
                                            const long long* in_stride,
                                            const long long* out_stride, int X, int Y,
                                            int Z, int hx, int hy, int hz,
                                            const void* phys, void* stream) {
  if (const int rc = tdp::check_ensemble(B)) return rc;
  const WindowedEnsembleArgs a{tdp::make_ensemble_io(B, in, out, in_stride, out_stride,
                                                     X, Y, Z, hx, hy, hz, phys),
                               plane_block};
  return tdp::dispatch_site<EnsembleLaunch>(site, vvl, a, stream);
}
#endif  // TDP_UNIT_HAS(3)
