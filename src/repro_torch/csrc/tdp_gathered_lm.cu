// tdp_gathered_lm.cu — the gathered targetDP executor's LM site functions.
//
// Replaces: the Pallas executor src/repro/kernels/tdp_pointwise.py:_run_pallas
// running the LM site bodies of src/repro/kernels/lm.py (rmsnorm_site :54,
// gated_site :89, act_site :95) — the sites kernel 2 runs on the serving path.
//
// Design: the thread mapping of tdp_gathered.cu (one thread per strip of VVL
// consecutive sites, VVL in {1, 2, 4, 8} as a template parameter, the ragged
// last strip masked, no shared memory), with an entry of its own because the
// LM sites take what the LB entry cannot: a runtime component count (d_model),
// a weight pointer and (eps, scale_offset) instead of six LB physics floats.
//
// Bound on the H100 (3.35 TB/s): device-memory bytes.  rmsnorm moves 8 bytes
// per element at best (x read once, y written once); this kernel reads each
// token's x twice (sum of squares, then scale), and the second read hits L2
// only while a warp's 32 tokens x d_model floats stay resident there.  gated
// moves 12 bytes per element (u, v read, out written), act 8.
#include <cuda_runtime.h>

#include "lm_sites.cuh"

namespace {

constexpr int kBlock = 128;

template <class Site, int VVL>
__global__ void __launch_bounds__(kBlock)
    lm_kernel(const __grid_constant__ tdp::lm::LmIO io) {
  tdp::lm::lm_thread<Site, VVL>(io, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <class Site, int VVL>
struct Launch {
  static int run(const tdp::lm::LmIO& io, void* stream) {
    const int64_t threads = tdp::lm::lm_threads<VVL>(io);
    if (threads == 0) return 0;
    const unsigned blocks = (unsigned)((threads + kBlock - 1) / kBlock);
    lm_kernel<Site, VVL><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(io);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// x (and v for the gated site), out: device pointers, float32, contiguous
// (ncomp, n); weight: ncomp floats (rmsnorm) or null.  Returns 0, a
// cudaError_t, or tdp::ERR_BAD_SITE / tdp::ERR_BAD_VVL.
extern "C" int tdp_gathered_lm_launch(int site, int act, int vvl, const void* x,
                                      const void* v, const void* weight,
                                      void* out, long long n, int ncomp,
                                      float eps, float scale_offset,
                                      void* stream) {
  tdp::lm::LmIO io{};
  io.in[0] = static_cast<const float*>(x);
  io.in[1] = static_cast<const float*>(v);
  io.out = static_cast<float*>(out);
  io.weight = static_cast<const float*>(weight);
  io.n = n;
  io.ncomp = ncomp;
  io.eps = eps;
  io.scale_offset = scale_offset;
  return tdp::lm::dispatch_site<Launch>(site, act, vvl, io, stream);
}
