// tdp_gathered_example.cu — the gathered targetDP executor's example sites.
//
// Replaces: the Pallas executor src/repro/kernels/tdp_pointwise.py:_run_pallas
// running the paper's example site kernels (the §III-C scale, saxpy, and a
// site-index kernel: examples/quickstart.py, tests/test_tdp_core.py:20-27,
// :164) — its `with_site_index` branch (:122-125) included.
//
// Mapping (example_sites.cuh): one thread per VVL consecutive sites, every
// component, VVL in {1, 2, 4, 8} a template parameter, the ragged end
// masked; blocks of 256 threads over ceil(n / VVL) threads.  No shared
// memory.
//
// Bound on the H100 (3.35 TB/s): bytes, each input read once and each
// output written once: scale and site_pos 8 bytes per (site, component),
// saxpy 12; one or two float32 operations per element are far below the
// bytes' time.  At VVL 1 a warp's load of one component is 128 contiguous
// bytes; at VVL > 1 a warp's v-th load strides by VVL floats and the
// neighbouring lines come from L1.  Made simple and right first; vector
// loads are left for later.
//
// The AoSoA branch (tdp_gathered_example_aosoa_launch; the reference's
// _run_pallas :96-170): operands and output in blocks of W sites, one
// thread per site, every component (example_aosoa_thread).  A warp's load
// of one component is ceil(32 / W) runs of W contiguous floats; the bytes
// are the SoA launch's.
#include <cuda_runtime.h>

#include "example_sites.cuh"

namespace {

constexpr int kBlock = 256;

template <class Site, int VVL>
__global__ void __launch_bounds__(kBlock)
    example_kernel(const __grid_constant__ tdp::ex::ExampleIO io) {
  tdp::ex::example_thread<Site, VVL>(io, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <class Site, int VVL>
struct Launch {
  static int run(const tdp::ex::ExampleIO& io, void* stream) {
    const int64_t threads = tdp::ex::example_threads<VVL>(io);
    if (threads == 0 || io.ncomp <= 0) return 0;
    const unsigned blocks = (unsigned)((threads + kBlock - 1) / kBlock);
    example_kernel<Site, VVL><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(io);
    return (int)cudaGetLastError();
  }
};

template <class Site>
__global__ void __launch_bounds__(kBlock)
    example_aosoa_kernel(const __grid_constant__ tdp::ex::ExampleAosoaIO a) {
  tdp::ex::example_aosoa_thread<Site>(a, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <class Site>
struct AosoaLaunch {
  static int run(const tdp::ex::ExampleAosoaIO& a, void* stream) {
    if (a.io.n <= 0 || a.io.ncomp <= 0) return 0;
    const unsigned blocks = (unsigned)(((int64_t)a.io.n + kBlock - 1) / kBlock);
    example_aosoa_kernel<Site><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// x, y (saxpy only; null otherwise), out: device pointers, float32,
// contiguous (ncomp, n).  Returns 0, a cudaError_t, or tdp::ERR_BAD_SITE /
// tdp::ERR_BAD_VVL.
extern "C" int tdp_gathered_example_launch(int site, int vvl, const void* x,
                                           const void* y, void* out, int n,
                                           int ncomp, float a, void* stream) {
  tdp::ex::ExampleIO io{};
  io.in[0] = static_cast<const float*>(x);
  io.in[1] = static_cast<const float*>(y);
  io.out = static_cast<float*>(out);
  io.n = n;
  io.ncomp = ncomp;
  io.a = a;
  return tdp::ex::dispatch_site<Launch>(site, vvl, io, stream);
}

// The AoSoA launch: x, y, out are (ceil(n / W), ncomp, W) blocks of W >= 1
// sites.  Returns 0, a cudaError_t, or tdp::ERR_BAD_SITE / ERR_BAD_VVL (W <
// 1).
extern "C" int tdp_gathered_example_aosoa_launch(int site, int W, const void* x,
                                                 const void* y, void* out, int n,
                                                 int ncomp, float a, void* stream) {
  if (W < 1) return tdp::ERR_BAD_VVL;
  tdp::ex::ExampleAosoaIO io{};
  io.io.in[0] = static_cast<const float*>(x);
  io.io.in[1] = static_cast<const float*>(y);
  io.io.out = static_cast<float*>(out);
  io.io.n = n;
  io.io.ncomp = ncomp;
  io.io.a = a;
  io.map = tdp::make_aosoa_map(W);
  return tdp::ex::dispatch_site_aosoa<AosoaLaunch>(site, io, stream);
}
