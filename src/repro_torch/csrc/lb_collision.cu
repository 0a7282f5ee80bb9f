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
#include <cuda_runtime.h>

#include "lb_sites.cuh"

namespace {

constexpr int kBlock = 128;

struct CollisionIO {
  const float* f;
  const float* g;
  const float* phi;
  const float* gradphi;
  const float* del2phi;
  float* f_out;
  float* g_out;
  int64_t n;
  tdp::Phys phys;
};

template <int VVL>
__global__ void __launch_bounds__(kBlock)
    lb_collision_kernel(const __grid_constant__ CollisionIO io) {
  const int64_t site0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * VVL;
  if (site0 >= io.n) return;
  const int64_t n = io.n;
#pragma unroll
  for (int l = 0; l < VVL; ++l) {
    const int64_t s = site0 + l;
    if (s >= n) break;
    float f[tdp::NVEL], g[tdp::NVEL], grad[3], fo[tdp::NVEL], go[tdp::NVEL];
#pragma unroll
    for (int q = 0; q < tdp::NVEL; ++q) {
      f[q] = __ldg(io.f + q * n + s);
      g[q] = __ldg(io.g + q * n + s);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) grad[d] = __ldg(io.gradphi + d * n + s);
    tdp::collide_core(f, g, __ldg(io.phi + s), grad, __ldg(io.del2phi + s), io.phys, fo, go);
#pragma unroll
    for (int q = 0; q < tdp::NVEL; ++q) {
      io.f_out[q * n + s] = fo[q];
      io.g_out[q * n + s] = go[q];
    }
  }
}

template <int VVL>
int launch(const CollisionIO& io, cudaStream_t stream) {
  const int64_t threads = (io.n + VVL - 1) / VVL;
  if (threads == 0) return 0;
  const unsigned blocks = (unsigned)((threads + kBlock - 1) / kBlock);
  lb_collision_kernel<VVL><<<blocks, kBlock, 0, stream>>>(io);
  return (int)cudaGetLastError();
}

}  // namespace

// Device pointers, float32, contiguous.  Returns 0, a cudaError_t, or
// tdp::ERR_BAD_VVL.
extern "C" int lb_collision_launch(const void* f, const void* g,
                                   const void* phi, const void* gradphi,
                                   const void* del2phi, void* f_out,
                                   void* g_out, long long n, int vvl, float A,
                                   float B, float kappa, float tau,
                                   float tau_phi, float gamma, void* stream) {
  CollisionIO io{static_cast<const float*>(f),       static_cast<const float*>(g),
                 static_cast<const float*>(phi),     static_cast<const float*>(gradphi),
                 static_cast<const float*>(del2phi), static_cast<float*>(f_out),
                 static_cast<float*>(g_out),         n,
                 tdp::make_phys(A, B, kappa, tau, tau_phi, gamma)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vvl) {
    case 1: return launch<1>(io, s);
    case 2: return launch<2>(io, s);
    case 4: return launch<4>(io, s);
    case 8: return launch<8>(io, s);
    default: return tdp::ERR_BAD_VVL;
  }
}
