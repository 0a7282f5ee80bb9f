// lb_collision.cu — the D3Q19 binary-fluid collision kernel (paper Fig. 1).
//
// Replaces: src/repro/kernels/lb_collision.py:lb_collision_pallas
// (_collision_body: (19, VVL) blocks of f and g plus phi, grad(phi),
// lap(phi) per grid step, chemical potential fused in).
//
// Design: a dedicated entry over SoA arrays — f, g (19, n), phi (1, n),
// grad(phi) (3, n), lap(phi) (1, n) in; f', g' (19, n) out — that runs the
// shared collide_core() of lb_sites.cuh.  One thread per strip of VVL
// consecutive sites, VVL in {1, 2, 4, 8}; the ragged last strip is masked
// in the kernel, so none of the reference's pad-with-1.0 trick is needed.
// Each site's 43 inputs are read once into registers and its 38 outputs
// written once: consecutive threads touch consecutive addresses of each
// component row.
//
// Bound on the H100 (3.35 TB/s): device-memory bytes, 324 per site
// (81 float32 values); its ~600 float32 operations per site take about a
// tenth of the byte time at the card's 67 TFLOP/s float32 rate.
//
// bfloat16 (the dtype code DTYPE_BF16): every operand and output bfloat16,
// 162 bytes a site, collide_core on tdp::rbf values (each operation
// rounded to bfloat16 as the reference's body rounds it, bf16.cuh), so
// each of the ~600 operations also costs its rounding.
#include <cuda_runtime.h>

#include "lb_sites.cuh"

namespace {

constexpr int kBlock = 128;

template <class T>
struct CollisionIO {
  const T* f;
  const T* g;
  const T* phi;
  const T* gradphi;
  const T* del2phi;
  T* f_out;
  T* g_out;
  int64_t n;
  tdp::Phys phys;
};

template <int VVL, class T>
__global__ void __launch_bounds__(kBlock)
    lb_collision_kernel(const __grid_constant__ CollisionIO<T> io) {
  using V = tdp::value_t<T>;
  const int64_t site0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * VVL;
  if (site0 >= io.n) return;
  const int64_t n = io.n;
#pragma unroll
  for (int l = 0; l < VVL; ++l) {
    const int64_t s = site0 + l;
    if (s >= n) break;
    V f[tdp::NVEL], g[tdp::NVEL], grad[3], fo[tdp::NVEL], go[tdp::NVEL];
#pragma unroll
    for (int q = 0; q < tdp::NVEL; ++q) {
      f[q] = tdp::load_value(io.f + q * n + s);
      g[q] = tdp::load_value(io.g + q * n + s);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) grad[d] = tdp::load_value(io.gradphi + d * n + s);
    tdp::collide_core(f, g, tdp::load_value(io.phi + s), grad,
                      tdp::load_value(io.del2phi + s), io.phys, fo, go);
#pragma unroll
    for (int q = 0; q < tdp::NVEL; ++q) {
      tdp::store_value(io.f_out + q * n + s, fo[q]);
      tdp::store_value(io.g_out + q * n + s, go[q]);
    }
  }
}

template <int VVL, class T>
int launch(const CollisionIO<T>& io, cudaStream_t stream) {
  const int64_t threads = (io.n + VVL - 1) / VVL;
  if (threads == 0) return 0;
  const unsigned blocks = (unsigned)((threads + kBlock - 1) / kBlock);
  lb_collision_kernel<VVL, T><<<blocks, kBlock, 0, stream>>>(io);
  return (int)cudaGetLastError();
}

template <class T>
int launch_vvl(const void* f, const void* g, const void* phi, const void* gradphi,
               const void* del2phi, void* f_out, void* g_out, long long n, int vvl,
               const void* phys, cudaStream_t s) {
  const CollisionIO<T> io{static_cast<const T*>(f),       static_cast<const T*>(g),
                          static_cast<const T*>(phi),     static_cast<const T*>(gradphi),
                          static_cast<const T*>(del2phi), static_cast<T*>(f_out),
                          static_cast<T*>(g_out),         n,
                          *static_cast<const tdp::Phys*>(phys)};
  switch (vvl) {
    case 1: return launch<1>(io, s);
    case 2: return launch<2>(io, s);
    case 4: return launch<4>(io, s);
    case 8: return launch<8>(io, s);
    default: return tdp::ERR_BAD_VVL;
  }
}

}  // namespace

// Device pointers, contiguous, of the storage type `dtype` (tdp::DtypeId);
// phys: one host tdp::Phys (bfloat16: every value rounded to bfloat16).
// Returns 0, a cudaError_t, or tdp::ERR_BAD_VVL / ERR_BAD_DTYPE.
extern "C" int lb_collision_launch(const void* f, const void* g, const void* phi,
                                   const void* gradphi, const void* del2phi, void* f_out,
                                   void* g_out, long long n, int vvl, int dtype,
                                   const void* phys, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tdp::DTYPE_F32:
      return launch_vvl<float>(f, g, phi, gradphi, del2phi, f_out, g_out, n, vvl, phys, s);
    case tdp::DTYPE_BF16:
      return launch_vvl<tdp::bf16>(f, g, phi, gradphi, del2phi, f_out, g_out, n, vvl, phys,
                                   s);
    default: return tdp::ERR_BAD_DTYPE;
  }
}
