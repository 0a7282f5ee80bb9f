// tdp_gathered_example.cu — the gathered targetDP executor's example sites.
//
// Replaces: the Pallas executor src/repro/kernels/tdp_pointwise.py:_run_pallas
// running the paper's example site kernels (the §III-C scale, saxpy, and a
// site-index kernel: examples/quickstart.py, tests/test_tdp_core.py:20-27,
// :164) — its `with_site_index` branch (:122-125) included — and the
// reduction the reference runs after it (src/repro/core/execute.py:reduce,
// jnp.sum / max / min over the mapped sites).
//
// Mapping (example_sites.cuh): one thread per VVL consecutive sites, every
// component, VVL in {1, 2, 4, 8} a template parameter and the width of
// each access (float2, float4, two float4) where the operands' rows are
// aligned to it, scalars otherwise (chosen once per launch); at VVL 1 a
// thread of scale or site_pos takes a second, grid-strided site; every
// load of a thread before
// its first store; the ragged end masked; blocks of EX_BLOCK threads.  No
// shared memory.
//
// Bound on the H100 (3.35 TB/s): bytes, each input read once and each
// output written once: scale and site_pos 8 bytes per (site, component),
// saxpy 12; one or two float32 operations per element are far below the
// bytes' time.  What bounds the kernel is the bytes a thread keeps in
// flight: a thread that stored component c before it loaded c + 1 had one
// access in flight; here it has every component's, one vector access each.
//
// bfloat16 (the dtype code DTYPE_BF16 of the SoA and reduce entries):
// the same kernels on ExampleIOT<tdp::bf16>, 4 bytes per (site, component)
// for scale and site_pos, 6 for saxpy, and the reduce's 2 or 4; each
// operation rounded as the reference's bfloat16 body rounds it
// (example_sites.cuh).
//
// The AoSoA branch (tdp_gathered_example_aosoa_launch; the reference's
// _run_pallas :96-170): operands and output in blocks of W sites, 4 lanes
// of a block a thread (one float4 per component) where W is a multiple of
// 32, one site a thread otherwise (example_aosoa_thread).  The bytes are
// the SoA launch's.
//
// The reduce (tdp_gathered_example_reduce_launch): map and reduce in one
// kernel, reading each input once and writing only the (ncomp,) result —
// 4 bytes per (site, component) for scale and site_pos, 8 for saxpy, where
// the map and a torch reduction after it moved 12 (write and read back the
// (ncomp, n) intermediate).  One resident wave of blocks, each thread
// EX_RED_SITES sites of each component in flight a round; the blocks'
// partials meet in the last block to finish, in block order (a counter the
// launch leaves at 0), so every call gives the same bits.
#include <cuda_runtime.h>

#include "example_sites.cuh"

namespace {

using tdp::ex::EX_BLOCK;
using tdp::ex::EX_CG;
using tdp::ex::EX_WARPS;

template <class Site, int VVL, class T>
__global__ void __launch_bounds__(EX_BLOCK)
    example_kernel(const __grid_constant__ tdp::ex::ExampleIOT<T> io) {
  tdp::ex::example_thread<Site, VVL>(io, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <class Site, int VVL>
struct Launch {
  template <class T>
  static int run(const tdp::ex::ExampleIOT<T>& io, void* stream) {
    const int64_t threads = tdp::ex::example_threads<Site, VVL>(io);
    if (threads == 0 || io.ncomp <= 0) return 0;
    tdp::ex::ExampleIOT<T> k = io;
    k.vec = tdp::ex::example_vec<VVL>(io);
    const unsigned blocks = (unsigned)((threads + EX_BLOCK - 1) / EX_BLOCK);
    example_kernel<Site, VVL, T><<<blocks, EX_BLOCK, 0, (cudaStream_t)stream>>>(k);
    return (int)cudaGetLastError();
  }
};

template <class Site, int L>
__global__ void __launch_bounds__(EX_BLOCK)
    example_aosoa_kernel(const __grid_constant__ tdp::ex::ExampleAosoaIO a) {
  tdp::ex::example_aosoa_thread<Site, L>(a, (int64_t)blockIdx.x * blockDim.x + threadIdx.x);
}

template <class Site>
struct AosoaLaunch {
  template <int L>
  static int go(const tdp::ex::ExampleAosoaIO& a, void* stream) {
    const int64_t threads = ((int64_t)a.io.n + L - 1) / L;
    const unsigned blocks = (unsigned)((threads + EX_BLOCK - 1) / EX_BLOCK);
    example_aosoa_kernel<Site, L><<<blocks, EX_BLOCK, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }

  static int run(const tdp::ex::ExampleAosoaIO& a, void* stream) {
    if (a.io.n <= 0 || a.io.ncomp <= 0) return 0;
    return tdp::ex::example_aosoa_lanes(a) == 4 ? go<4>(a, stream) : go<1>(a, stream);
  }
};

template <class Op>
__device__ __forceinline__ typename Op::T warp_reduce(typename Op::T v) {
#pragma unroll
  for (int i = 0; i < 5; ++i)
    v = Op::f(v, __shfl_xor_sync(0xffffffffu, v, tdp::ex::red_xor(i)));
  return v;
}

// Grid (blocks, component groups).  Each block: its threads' partials, the
// warps' by shuffles, the block's in warp order, stored; the last block to
// finish combines every block's partials of each component in block order
// and writes the result.
template <class Site, class Op, int VVL, class S>
__global__ void __launch_bounds__(EX_BLOCK)
    example_reduce_kernel(const __grid_constant__ tdp::ex::ReduceIOT<S> r) {
  using T = typename Op::T;
  __shared__ T red[EX_CG * EX_WARPS];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.y * EX_CG;
  T acc[EX_CG];
  tdp::ex::reduce_thread<Site, Op, VVL>(r, blockIdx.x, blockIdx.y, tid, acc);
#pragma unroll
  for (int k = 0; k < EX_CG; ++k) {
    const T v = warp_reduce<Op>(acc[k]);
    if (lane == 0) red[k * EX_WARPS + warp] = v;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < EX_CG && c0 + k < r.io.ncomp; ++k)
      r.partial[(int64_t)(c0 + k) * r.blocks + blockIdx.x] =
          (double)tdp::ex::block_combine<Op>(red, k);
    __threadfence();
    last = atomicAdd(r.count, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = 0; c < r.io.ncomp; ++c) {
    const T v = warp_reduce<Op>(tdp::ex::final_thread<Op>(r, c, tid));
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (tid == 0) tdp::store_f32(r.io.out + c, (float)tdp::ex::block_combine<Op>(red, 0));
    __syncthreads();
  }
  if (tid == 0) *r.count = 0;
}

template <class Site, int VVL>
struct ReduceLaunch {
  template <class Op, class S>
  static int go(const tdp::ex::ReduceIOT<S>& r, void* stream) {
    static int per_sm = -1;  // resident blocks an SM holds of this kernel
    if (per_sm < 0) {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, example_reduce_kernel<Site, Op, VVL, S>, EX_BLOCK, 0);
      if (e != cudaSuccess) return (int)e;
    }
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    tdp::ex::ReduceIOT<S> k = r;
    k.io.vec = tdp::ex::example_vec<VVL>(r.io);
    k.blocks = tdp::ex::reduce_blocks<VVL>(r.io.n, r.io.ncomp, sms * per_sm);
    const dim3 grid(k.blocks, tdp::ex::reduce_groups(r.io.ncomp));
    example_reduce_kernel<Site, Op, VVL, S><<<grid, EX_BLOCK, 0, (cudaStream_t)stream>>>(k);
    return (int)cudaGetLastError();
  }

  template <class S>
  static int run(const tdp::ex::ReduceIOT<S>& r, void* stream) {
    if (r.io.ncomp <= 0) return 0;
    return tdp::ex::dispatch_op<ReduceLaunch>(r, stream);
  }
};

template <class T = float>
tdp::ex::ExampleIOT<T> example_io(const void* x, const void* y, void* out, int n,
                                  int ncomp, float a) {
  tdp::ex::ExampleIOT<T> io{};
  io.in[0] = static_cast<const T*>(x);
  io.in[1] = static_cast<const T*>(y);
  io.out = static_cast<T*>(out);
  io.n = n;
  io.ncomp = ncomp;
  io.a = a;
  return io;
}

template <class T>
tdp::ex::ReduceIOT<T> reduce_io(int op, const void* x, const void* y, void* out,
                                void* partial, void* count, int n, int ncomp, float a) {
  tdp::ex::ReduceIOT<T> r{};
  r.io = example_io<T>(x, y, out, n, ncomp, a);
  r.partial = static_cast<double*>(partial);
  r.count = static_cast<unsigned*>(count);
  r.op = op;
  return r;
}

}  // namespace

// x, y (saxpy only; null otherwise), out: device pointers, contiguous (ncomp,
// n), of the storage type `dtype` (tdp::DtypeId); a: for bfloat16 rounded
// to bfloat16 by the caller.  Returns 0, a cudaError_t, or
// tdp::ERR_BAD_SITE / ERR_BAD_VVL / ERR_BAD_DTYPE.
extern "C" int tdp_gathered_example_launch(int site, int vvl, int dtype, const void* x,
                                           const void* y, void* out, int n, int ncomp,
                                           float a, void* stream) {
  switch (dtype) {
    case tdp::DTYPE_F32:
      return tdp::ex::dispatch_site<Launch>(site, vvl,
                                            example_io<float>(x, y, out, n, ncomp, a), stream);
    case tdp::DTYPE_BF16:
      return tdp::ex::dispatch_site<Launch>(
          site, vvl, example_io<tdp::bf16>(x, y, out, n, ncomp, a), stream);
    default: return tdp::ERR_BAD_DTYPE;
  }
}

// The AoSoA launch: x, y, out are (ceil(n / W), ncomp, W) blocks of W >= 1
// sites.  Returns 0, a cudaError_t, or tdp::ERR_BAD_SITE / ERR_BAD_VVL (W <
// 1).
extern "C" int tdp_gathered_example_aosoa_launch(int site, int W, const void* x,
                                                 const void* y, void* out, int n,
                                                 int ncomp, float a, void* stream) {
  if (W < 1) return tdp::ERR_BAD_VVL;
  tdp::ex::ExampleAosoaIO io{};
  io.io = example_io(x, y, out, n, ncomp, a);
  io.map = tdp::make_aosoa_map(W);
  return tdp::ex::dispatch_site_aosoa<AosoaLaunch>(site, io, stream);
}

// The reduce: op (tdp::ex::ReduceOpId) over the n sites of the site function
// on x, y (as above) into out, ncomp values of the storage type `dtype`.
// partial: ncomp · EX_RED_MAX_BLOCKS doubles of scratch; count: one
// unsigned at 0, left at 0.  Returns 0, a cudaError_t, or
// tdp::ERR_BAD_SITE / ERR_BAD_VVL / ERR_BAD_OP / ERR_BAD_DTYPE.
extern "C" int tdp_gathered_example_reduce_launch(int site, int op, int vvl, int dtype,
                                                  const void* x, const void* y,
                                                  void* out, void* partial,
                                                  void* count, int n, int ncomp,
                                                  float a, void* stream) {
  switch (dtype) {
    case tdp::DTYPE_F32:
      return tdp::ex::dispatch_site<ReduceLaunch>(
          site, vvl, reduce_io<float>(op, x, y, out, partial, count, n, ncomp, a), stream);
    case tdp::DTYPE_BF16:
      return tdp::ex::dispatch_site<ReduceLaunch>(
          site, vvl, reduce_io<tdp::bf16>(op, x, y, out, partial, count, n, ncomp, a),
          stream);
    default: return tdp::ERR_BAD_DTYPE;
  }
}
