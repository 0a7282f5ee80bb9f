// tdp_gathered_lm.cu — the gathered targetDP executor's LM site functions.
//
// Replaces: the Pallas executor src/repro/kernels/tdp_pointwise.py:_run_pallas
// running the LM site bodies of src/repro/kernels/lm.py (rmsnorm_site :54,
// gated_site :89, act_site :95, mamba_site :120) — the sites kernel 2 runs
// on the serving paths.
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
//
// mamba (entry tdp_gathered_mamba_launch, one launch per batch row): x and dt
// read once and y written once, 12 bytes per (step, channel); L·n·N
// exponentials on the SFU.  At falcon-mamba-7b's full width (L 4096, n 8192,
// N 16) that is 403 MB (0.120 ms at 3.35 TB/s) and 5.4e8 exp.  But the
// recurrence is sequential in L and parallel only over the n = 8192
// channels: at VVL 1, 64 blocks of 128 threads on 132 SMs, each thread
// walking a 4096-step chain, so the simple design is latency-bound.  b[t] and
// c[t] are warp-uniform loads that L1 serves as broadcasts.
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
__global__ void __launch_bounds__(kBlock)
    mamba_kernel(const __grid_constant__ tdp::lm::MambaIO io) {
  tdp::lm::mamba_thread<Site, VVL>(io, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <class Site, int VVL>
struct MambaLaunch {
  static int run(const tdp::lm::MambaIO& io, void* stream) {
    const int64_t threads = tdp::lm::lm_threads<VVL>(io);
    if (threads == 0 || io.L == 0) return 0;
    const unsigned blocks = (unsigned)((threads + kBlock - 1) / kBlock);
    mamba_kernel<Site, VVL><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(io);
    return (int)cudaGetLastError();
  }
};

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

// The selective scan of one batch row.  x, dt, y: (L, n); a: (N, n); d: (1,
// n); b, c: (L, N); h: (N, n) — device pointers, float32, contiguous.
// Returns 0, a cudaError_t, tdp::ERR_BAD_VVL or tdp::lm::ERR_BAD_NSTATE (N
// not in {8, 16}).
extern "C" int tdp_gathered_mamba_launch(int nstate, int vvl, const void* x,
                                         const void* dt, const void* a,
                                         const void* d, const void* b,
                                         const void* c, void* y, void* h,
                                         long long L, long long n,
                                         void* stream) {
  tdp::lm::MambaIO io{};
  io.x = static_cast<const float*>(x);
  io.dt = static_cast<const float*>(dt);
  io.a = static_cast<const float*>(a);
  io.d = static_cast<const float*>(d);
  io.b = static_cast<const float*>(b);
  io.c = static_cast<const float*>(c);
  io.y = static_cast<float*>(y);
  io.h = static_cast<float*>(h);
  io.L = L;
  io.n = n;
  return tdp::lm::dispatch_mamba<MambaLaunch>(nstate, vvl, io, stream);
}
