// tdp_windowed.cu — the gather-free targetDP stencil executor on Hopper.
//
// Replaces: src/repro/kernels/tdp_windowed.py:windowed_execute (the Pallas
// executor behind Target("pallas_windowed"): x-plane windows of each
// halo-extended field DMA'd into VMEM, neighbour offsets resolved in the
// kernel).
//
// Design: each stencil field arrives once, halo-extended by its stencil
// radius (the PyTorch prologue's circular pad); one thread covers VVL
// consecutive z-sites of one (x, y) row, VVL in {1, 2, 4, 8}, and resolves
// every neighbour offset at compile time from the site function's stencil
// tables — the (noffsets, ncomp, n) stack never exists in device memory.
// Neighbouring threads read neighbouring addresses, so each of the
// noffsets*ncomp reads of a warp is one coalesced line; reuse between
// neighbouring sites is left to L1/L2 (no shared-memory window, no y/z
// tiles yet).
//
// Bound on the H100 (3.35 TB/s): device-memory bytes.  The function's
// minimum per site is its inputs read once and outputs written once: fused
// 304, fused_two 308, stream 152, phi_stream 80, grad6 20 bytes.  The
// kernel issues noffsets reads per input component (19 per population for
// stream, 7*19 for the fused g-field); they reach device memory only as
// often as L1/L2 miss, which is what keeps this executor near the byte
// bound where the gathered one pays the noffsets-fold stack.
#include <cuda_runtime.h>

#include "lb_sites.cuh"

namespace {

constexpr int kBlock = 128;

template <class Site, int VVL>
__global__ void __launch_bounds__(kBlock)
    windowed_kernel(const __grid_constant__ tdp::WindowedIO io) {
  tdp::windowed_thread<Site, VVL>(io, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <class Site, int VVL>
struct Launch {
  static int run(const tdp::WindowedIO& io, void* stream) {
    const int64_t threads = tdp::windowed_threads<VVL>(io);
    if (threads == 0) return 0;
    const unsigned blocks = (unsigned)((threads + kBlock - 1) / kBlock);
    windowed_kernel<Site, VVL><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(io);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// in[i]: halo-extended (ncomp, X+2r, Y+2r, Z+2r) grid of stencil field i or
// (ncomp, X*Y*Z) pointwise array; out[k]: (ncomp, X*Y*Z).  float32,
// contiguous.  Returns 0, a cudaError_t, or tdp::ERR_BAD_SITE /
// tdp::ERR_BAD_VVL.
extern "C" int tdp_windowed_launch(int site, int vvl, const void* const* in,
                                   void* const* out, int X, int Y, int Z,
                                   float A, float B, float kappa, float tau,
                                   float tau_phi, float gamma, void* stream) {
  tdp::WindowedIO io{};
  for (int i = 0; i < tdp::MAX_IN; ++i) io.in[i] = static_cast<const float*>(in[i]);
  for (int k = 0; k < tdp::MAX_OUT; ++k) io.out[k] = static_cast<float*>(out[k]);
  io.X = X;
  io.Y = Y;
  io.Z = Z;
  io.n = (int64_t)X * Y * Z;
  io.phys = tdp::make_phys(A, B, kappa, tau, tau_phi, gamma);
  return tdp::dispatch_site<Launch>(site, vvl, io, stream);
}
