// tdp_gathered.cu — the gathered targetDP executor on Hopper.
//
// Replaces: src/repro/kernels/tdp_pointwise.py:_run_pallas (the Pallas
// executor behind Target("pallas"): one grid step per VVL chunk of sites,
// (ncomp, VVL) pointwise and (noffsets, ncomp, VVL) gathered blocks).
//
// Design: one thread per strip of VVL consecutive sites (the paper's CUDA
// TARGET_TLP/TARGET_ILP mapping), VVL in {1, 2, 4, 8} as a template
// parameter; the ragged last strip is masked, nothing is padded.  Inputs are
// the (noffsets, ncomp, n) stacks the PyTorch gather prologue built, read
// once each straight from device memory; no shared memory.
//
// Bound on the H100 (3.35 TB/s): device-memory bytes.  The kernel reads
// only the stack rows its site function names and writes each output once:
// collide 324, moment 80, stream 152 (19 of the 361 rows), phi_stream 80,
// grad6 44 (7 rows), fused_two 332, fused 760 (19 + 133 of 361 + 1083 rows)
// bytes/site, against the function's own minimum of collide 324, moment 80,
// stream 152, phi_stream 80, grad6 20, fused_two 308, fused 304.  The price
// of this executor is upstream of it: the PyTorch gather prologue writes
// every row of every stack (1444 bytes/site for a streamed 19-component
// field).  It stays the path of the pointwise stages, which have no stack.
#include <cuda_runtime.h>

#include "lb_sites.cuh"

namespace {

constexpr int kBlock = 128;

template <class Site, int VVL>
__global__ void __launch_bounds__(kBlock)
    gathered_kernel(const __grid_constant__ tdp::GatheredIO io) {
  tdp::gathered_thread<Site, VVL>(io, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <class Site, int VVL>
struct Launch {
  static int run(const tdp::GatheredIO& io, void* stream) {
    const int64_t threads = tdp::gathered_threads<VVL>(io);
    if (threads == 0) return 0;
    const unsigned blocks = (unsigned)((threads + kBlock - 1) / kBlock);
    gathered_kernel<Site, VVL><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(io);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// in[i] / out[k]: device pointers of the site function's fields and outputs
// (float32, contiguous); n: interior sites.  Returns 0, a cudaError_t, or
// tdp::ERR_BAD_SITE / tdp::ERR_BAD_VVL.
extern "C" int tdp_gathered_launch(int site, int vvl, const void* const* in,
                                   void* const* out, long long n, float A,
                                   float B, float kappa, float tau,
                                   float tau_phi, float gamma, void* stream) {
  tdp::GatheredIO io{};
  for (int i = 0; i < tdp::MAX_IN; ++i) io.in[i] = static_cast<const float*>(in[i]);
  for (int k = 0; k < tdp::MAX_OUT; ++k) io.out[k] = static_cast<float*>(out[k]);
  io.n = n;
  io.phys = tdp::make_phys(A, B, kappa, tau, tau_phi, gamma);
  return tdp::dispatch_site<Launch>(site, vvl, io, stream);
}
