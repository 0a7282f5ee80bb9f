// tdp_gathered_lm.cu — the gathered targetDP executor's LM site functions.
//
// Replaces: the Pallas executor src/repro/kernels/tdp_pointwise.py:_run_pallas
// running the LM site bodies of src/repro/kernels/lm.py (rmsnorm_site :54,
// gated_site :89, act_site :95, mamba_site :120) — the sites kernel 2 runs
// on the serving paths.
//
// One entry, tdp_gathered_lm_launch, takes what the LB entry cannot: a
// runtime component count (d_model), a weight pointer and (eps,
// scale_offset).  Behind it, three kernels (mappings in lm_sites.cuh):
//
// ew_kernel (gated, act): bound by bytes on the H100 (3.35 TB/s): gated
// moves 12 bytes per element (u, v read, out written), act 8; gelu's tanhf
// is ~30 float32 operations, under a tenth of the time the bytes take.  A
// grid that covers the work, 16-byte loads and stores where u, v and out
// are aligned (scalars in the same thread otherwise), 32-bit offsets in a
// block: the mapping of calibrate.cu's stream_add, which reached 3.07 TB/s.
// One scalar per thread over 64-bit indices ran act at 0.405 ms for 84.9 M
// elements, twice its bound.
//
// rms_tiled_kernel (rmsnorm, n >= 32 tokens): bound by bytes, 8 per element
// (x read once, y written once).  A block of 16 warps covers 32·VVL tokens:
// coalesced rows, the d components split over the warps, the sum of squares
// combined in shared memory, then a second read of x to scale it, which
// comes from L2 while the block's tile (32·VVL·d·4 bytes: 295 KB at VVL 1
// and d 2304) stays resident.  rms_few_kernel (rmsnorm, n < 32 tokens,
// decode): one block of up to 1024 threads sweeps the whole (d, n) array
// and meets in a shared-memory tree; at 2 tokens the work is 16–32 KB, so
// launch latency bounds it.  One thread per token ran 115–206 µs per decode
// launch.
//
// mamba (entry tdp_gathered_mamba_launch, one launch for all batch rows):
// x and dt read once and y written once, 12 bytes per (step, channel); L·n·N
// exponentials on the SFUs (16 a clock per SM).  At falcon-mamba-7b's full
// width (L 4096, n 8192, N 16) that is 403 MB a row (0.120 ms at 3.35 TB/s)
// and 5.4e8 exp (0.128 ms): the bound, per row, is the SFUs'.  The first
// port gave each thread one channel and all 16 of its states, so
// a row was 64 blocks of 128 threads on 132 SMs, and each thread's 4096-step
// chain waited on fresh global loads of x[t], dt[t], b[t], c[t] every step:
// 4.768 ms a row, ~2300 cycles a step, memory latency exposed once a step.
// The recurrence's only true dependency is one FMA a state a step (h =
// h·decay + u; decay and u depend on no earlier step), so this design
// (mapping in lm_sites.cuh) fills the card and takes the loads off the
// chain: a channel's states over a group of 4 lanes (4× the warps; both
// rows in one launch, grid.y), chunks of steps staged into shared memory by
// cp.async one chunk ahead, the decay by one MUFU.EX2, y summed over the
// group by two shuffles.  Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md
// §6): a layer, both rows, 0.849 ms at VVL 1 and 0.646 ms at VVL 2
// (3.3x and 2.5x its 0.257 ms bound), against 2 x 4.768 ms before; 2 or 8
// lanes a channel were slower at their best VVL (0.778 and 0.755 ms).
//
// Storage: rmsnorm, gated and act take float32 or bfloat16 (the entry's
// dtype code, one type for every operand); a bfloat16 launch loads each
// value as float32, runs the float32 arithmetic and rounds each result to
// bfloat16 once (lm_sites.cuh).  Its bytes are half the float32 launch's:
// rmsnorm and act 4 an element, gated 6.  The mamba entry takes a dtype code
// too: x, dt, b, c and y in it, a, d and h float32 (the reference's site
// widens every operand and returns h_final in float32).  A bfloat16 scan
// stages its chunks raw by cp.async, one chunk ahead as the float32 scan
// does, and widens each value as a lane reads it: x and dt are 6 bytes a
// (step, channel) against 12, but the bound stays the SFUs' (L·n·N
// exponentials), so the bfloat16 scan is expected at about the float32
// time.  Widening as the chunk is staged (as kernel 4's bfloat16 route
// does) would make the staging loads synchronous, a memory latency a
// chunk on the chain.  The AoSoA entries take the same dtype codes: the
// AoSoA rmsnorm and scan are templated on the storage type as their SoA
// twins are, and a bfloat16 AoSoA scan stages a block's 4 channels by one
// 8-byte cp.async (16 bytes in float32), so W % 4 stays the only rule on
// the width.
//
// The AoSoA branch (Target(layout="aosoa"), W = Target.vvl; mappings in
// lm_sites.cuh): tdp_gathered_rmsnorm_aosoa_launch (rms_aosoa_kernel, one
// block per W tokens or per 512 of them) and tdp_gathered_mamba_aosoa_launch
// (mamba_kernel at MAMBA_AOSOA_VVL channels a lane group, its stage reading
// the blocks through the index map).  gated and act under AoSoA are
// ew_kernel over the padded blocks, launched by the wrapper through
// tdp_gathered_lm_launch: every operand shares one layout, so no other
// kernel is needed.  The bytes are the SoA launches'.
#include <cuda_runtime.h>

#include <type_traits>

#include "lm_sites.cuh"

namespace {

using tdp::lm::LmIOT;

template <class Site, int VVL, class T>
__global__ void __launch_bounds__(tdp::lm::EW_BLOCK)
    ew_kernel(const __grid_constant__ LmIOT<T> io) {
  tdp::lm::ew_thread<Site, VVL>(io, blockIdx.x, threadIdx.x);
}

template <class Site, int VVL, class T>
__global__ void __launch_bounds__(tdp::lm::RMS_THREADS)
    rms_tiled_kernel(const __grid_constant__ LmIOT<T> io) {
  __shared__ float red[tdp::lm::RMS_WARPS * 32 * VVL];
  __shared__ float inv[32 * VVL];
  tdp::lm::rms_tiled_partial<VVL>(io, blockIdx.x, threadIdx.x, red);
  __syncthreads();
  tdp::lm::rms_tiled_combine<VVL>(io, threadIdx.x, red, inv);
  __syncthreads();
  tdp::lm::rms_tiled_scale<VVL>(io, blockIdx.x, threadIdx.x, inv);
}

template <class T>
__global__ void __launch_bounds__(tdp::lm::RMS_FEW_THREADS)
    rms_few_kernel(const __grid_constant__ LmIOT<T> io, int group) {
  __shared__ float red[tdp::lm::RMS_FEW_THREADS];
  tdp::lm::rms_few_partial(io, group, threadIdx.x, red);
  __syncthreads();
  for (int h = group / 2; h > 0; h >>= 1) {
    tdp::lm::rms_few_tree(io, h, threadIdx.x, red);
    __syncthreads();
  }
  tdp::lm::rms_few_scale(io, group, threadIdx.x, red);
}

template <class T>
__global__ void __launch_bounds__(tdp::lm::RMS_THREADS)
    rms_aosoa_kernel(const __grid_constant__ LmIOT<T> io, const tdp::AosoaMap m) {
  __shared__ float red[tdp::lm::RMS_THREADS];
  __shared__ float inv[tdp::lm::RMS_THREADS];
  tdp::lm::rms_aosoa_partial(io, m, blockIdx.x, threadIdx.x, red);
  __syncthreads();
  tdp::lm::rms_aosoa_combine(io, m, threadIdx.x, red, inv);
  __syncthreads();
  tdp::lm::rms_aosoa_scale(io, m, blockIdx.x, threadIdx.x, inv);
}

// Block (blockIdx.x, row blockIdx.y): the lanes' states in registers, the
// chunks of the row's steps through two stages of shared memory, in the
// storage type T.
template <class Site, int VVL, bool AOSOA = false, class T = float>
__global__ void __launch_bounds__(tdp::lm::MAMBA_THREADS)
    mamba_kernel(const __grid_constant__ tdp::lm::MambaIOT<T> io) {
  using namespace tdp::lm;
  constexpr int N = Site::kN;
  using Tl = MambaTile<N, VVL>;
  __shared__ __align__(16) T smem[2][Tl::ELEMS];
  const int row = blockIdx.y, tid = threadIdx.x;
  const int64_t blk = blockIdx.x;
  MambaLane<N, VVL> ln;
  mamba_lane_init<N, VVL, AOSOA>(io, blk, tid, ln);
  const int64_t nq = mamba_chunks<N, VVL>(io.L);
  mamba_stage<N, VVL, AOSOA>(io, row, blk, 0, tid, smem[0]);
  tdp::cp_async_commit();
  for (int64_t q = 0; q < nq; ++q) {
    // stage (q + 1) & 1 was last read for chunk q - 1, before its barrier
    if (q + 1 < nq) mamba_stage<N, VVL, AOSOA>(io, row, blk, q + 1, tid, smem[(q + 1) & 1]);
    tdp::cp_async_commit();
    tdp::cp_async_wait<1>();  // chunk q has landed (this thread's copies)
    __syncthreads();          // ... and every thread's
    const T* buf = smem[q & 1];
    const int steps = io.L - q * Tl::T < Tl::T ? (int)(io.L - q * Tl::T) : Tl::T;
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int v = 0; v < VVL; ++v) {
        float p = mamba_partial<N, VVL>(buf, s, v, tid, ln);
#pragma unroll
        for (int r = 0; r < MAMBA_ROUNDS; ++r)
          p += __shfl_xor_sync(0xffffffffu, p, mamba_xor(r));
        mamba_out<N, VVL, AOSOA>(io, buf, row, blk, q, s, v, tid, ln, p);
      }
    }
    __syncthreads();  // every lane is done with stage q & 1
  }
  mamba_final<N, VVL, AOSOA>(io, row, blk, tid, ln);
}

template <class Site, int VVL>
struct MambaLaunch {
  template <class T>
  static int run(const tdp::lm::MambaIOT<T>& io, void* stream) {
    if (io.n == 0 || io.L == 0 || io.rows == 0) return 0;
    const dim3 grid((unsigned)tdp::lm::mamba_blocks<Site::kN, VVL>(io.n),
                    (unsigned)io.rows);
    mamba_kernel<Site, VVL, false, T>
        <<<grid, tdp::lm::MAMBA_THREADS, 0, (cudaStream_t)stream>>>(io);
    return (int)cudaGetLastError();
  }
};

template <class Site>
struct MambaAosoaLaunch {
  template <class T>
  static int run(const tdp::lm::MambaIOT<T>& io, void* stream) {
    constexpr int V = tdp::lm::MAMBA_AOSOA_VVL;
    if (io.n == 0 || io.L == 0 || io.rows == 0) return 0;
    const dim3 grid((unsigned)tdp::lm::mamba_blocks<Site::kN, V>(io.n), (unsigned)io.rows);
    mamba_kernel<Site, V, true, T>
        <<<grid, tdp::lm::MAMBA_THREADS, 0, (cudaStream_t)stream>>>(io);
    return (int)cudaGetLastError();
  }
};

// rmsnorm: the few-token or the tiled kernel, chosen by n; gated and act:
// the elementwise kernel.
template <class Site, int VVL>
struct Launch {
  template <class T>
  static int run(const LmIOT<T>& io, void* stream) {
    if (io.n <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if constexpr (std::is_same<Site, tdp::lm::RmsnormSite>::value) {
      if (io.n < tdp::lm::RMS_FEW) {
        const int group = tdp::lm::rms_few_group(io.n);
        rms_few_kernel<T><<<1, (unsigned)(io.n * group), 0, s>>>(io, group);
      } else {
        rms_tiled_kernel<Site, VVL, T>
            <<<(unsigned)tdp::lm::rms_tiled_blocks<VVL>(io.n), tdp::lm::RMS_THREADS,
               0, s>>>(io);
      }
    } else {
      ew_kernel<Site, VVL, T>
          <<<(unsigned)tdp::lm::ew_blocks<VVL>(io.n), tdp::lm::EW_BLOCK, 0, s>>>(io);
    }
    return (int)cudaGetLastError();
  }
};

template <class T>
int lm_launch(int site, int act, int vvl, const void* x, const void* v,
              const void* weight, void* out, long long n, int ncomp, float eps,
              float scale_offset, void* stream) {
  LmIOT<T> io{};
  io.in[0] = static_cast<const T*>(x);
  io.in[1] = static_cast<const T*>(v);
  io.out = static_cast<T*>(out);
  io.weight = static_cast<const T*>(weight);
  io.n = n;
  io.ncomp = ncomp;
  io.eps = eps;
  io.scale_offset = scale_offset;
  return tdp::lm::dispatch_site<Launch>(site, act, vvl, io, stream);
}

}  // namespace

// x (and v for the gated site), out: device pointers, contiguous (ncomp, n),
// of the storage type `dtype` (tdp::DTYPE_F32 or DTYPE_BF16); weight: ncomp
// values of the same type (rmsnorm) or null.  Returns 0, a cudaError_t, or
// tdp::ERR_BAD_SITE / ERR_BAD_VVL / ERR_BAD_DTYPE.
extern "C" int tdp_gathered_lm_launch(int site, int act, int vvl, int dtype,
                                      const void* x, const void* v,
                                      const void* weight, void* out, long long n,
                                      int ncomp, float eps, float scale_offset,
                                      void* stream) {
  switch (dtype) {
    case tdp::DTYPE_F32:
      return lm_launch<float>(site, act, vvl, x, v, weight, out, n, ncomp, eps,
                              scale_offset, stream);
    case tdp::DTYPE_BF16:
      return lm_launch<tdp::bf16>(site, act, vvl, x, v, weight, out, n, ncomp, eps,
                                  scale_offset, stream);
    default: return tdp::ERR_BAD_DTYPE;
  }
}

namespace {

template <class T>
int mamba_launch(int nstate, int vvl, const void* x, const void* dt, const void* a,
                 const void* d, const void* b, const void* c, void* y, void* h,
                 long long L, long long n, int rows, void* stream) {
  tdp::lm::MambaIOT<T> io{};
  io.x = static_cast<const T*>(x);
  io.dt = static_cast<const T*>(dt);
  io.a = static_cast<const float*>(a);
  io.d = static_cast<const float*>(d);
  io.b = static_cast<const T*>(b);
  io.c = static_cast<const T*>(c);
  io.y = static_cast<T*>(y);
  io.h = static_cast<float*>(h);
  io.L = L;
  io.n = n;
  io.rows = rows;
  return tdp::lm::dispatch_mamba<MambaLaunch>(nstate, vvl, io, stream);
}

}  // namespace

// The selective scan of `rows` batch rows.  x, dt, y: (rows·L, n); b, c:
// (rows·L, N), of the storage type `dtype` (tdp::DTYPE_F32 or DTYPE_BF16);
// a: (N, n), d: (1, n), h: (rows·N, n), float32 — device pointers,
// contiguous.  Returns 0, a cudaError_t, tdp::ERR_BAD_VVL,
// tdp::lm::ERR_BAD_NSTATE (N not in {8, 16}) or tdp::ERR_BAD_DTYPE.
extern "C" int tdp_gathered_mamba_launch(int nstate, int vvl, int dtype, const void* x,
                                         const void* dt, const void* a,
                                         const void* d, const void* b,
                                         const void* c, void* y, void* h,
                                         long long L, long long n, int rows,
                                         void* stream) {
  switch (dtype) {
    case tdp::DTYPE_F32:
      return mamba_launch<float>(nstate, vvl, x, dt, a, d, b, c, y, h, L, n, rows,
                                 stream);
    case tdp::DTYPE_BF16:
      return mamba_launch<tdp::bf16>(nstate, vvl, x, dt, a, d, b, c, y, h, L, n, rows,
                                     stream);
    default: return tdp::ERR_BAD_DTYPE;
  }
}

namespace {

template <class T>
int rmsnorm_aosoa_launch(int W, const void* x, const void* weight, void* out,
                         long long n, int ncomp, float eps, float scale_offset,
                         void* stream) {
  LmIOT<T> io{};
  io.in[0] = static_cast<const T*>(x);
  io.out = static_cast<T*>(out);
  io.weight = static_cast<const T*>(weight);
  io.n = n;
  io.ncomp = ncomp;
  io.eps = eps;
  io.scale_offset = scale_offset;
  if (n <= 0) return 0;
  const tdp::AosoaMap m = tdp::make_aosoa_map(W);
  rms_aosoa_kernel<T><<<(unsigned)tdp::lm::rms_aosoa_blocks(io, m), tdp::lm::RMS_THREADS,
                        0, (cudaStream_t)stream>>>(io, m);
  return (int)cudaGetLastError();
}

template <class T>
int mamba_aosoa_launch(int nstate, int W, const void* x, const void* dt, const void* a,
                       const void* d, const void* b, const void* c, void* y, void* h,
                       long long L, long long n, int rows, void* stream) {
  tdp::lm::MambaIOT<T> io{};
  io.x = static_cast<const T*>(x);
  io.dt = static_cast<const T*>(dt);
  io.a = static_cast<const float*>(a);
  io.d = static_cast<const float*>(d);
  io.b = static_cast<const T*>(b);
  io.c = static_cast<const T*>(c);
  io.y = static_cast<T*>(y);
  io.h = static_cast<float*>(h);
  io.L = L;
  io.n = n;
  io.rows = rows;
  io.map = tdp::make_aosoa_map(W);
  return tdp::lm::dispatch_mamba_aosoa<MambaAosoaLaunch>(nstate, io, stream);
}

}  // namespace

// rmsnorm over AoSoA: x, out (ceil(n / W), ncomp, W) blocks of W >= 1 tokens,
// weight ncomp values, all of the storage type `dtype` (tdp::DTYPE_F32 or
// DTYPE_BF16).  Returns 0, a cudaError_t, tdp::ERR_BAD_VVL (W < 1) or
// tdp::ERR_BAD_DTYPE.
extern "C" int tdp_gathered_rmsnorm_aosoa_launch(int W, int dtype, const void* x,
                                                 const void* weight, void* out,
                                                 long long n, int ncomp, float eps,
                                                 float scale_offset, void* stream) {
  if (W < 1) return tdp::ERR_BAD_VVL;
  switch (dtype) {
    case tdp::DTYPE_F32:
      return rmsnorm_aosoa_launch<float>(W, x, weight, out, n, ncomp, eps, scale_offset,
                                         stream);
    case tdp::DTYPE_BF16:
      return rmsnorm_aosoa_launch<tdp::bf16>(W, x, weight, out, n, ncomp, eps,
                                             scale_offset, stream);
    default: return tdp::ERR_BAD_DTYPE;
  }
}

// The selective scan over AoSoA: x, dt, y (ceil(n / W), rows·L, W); a (.., N,
// W); d (.., 1, W); h (.., rows·N, W); b, c (rows·L, N) as under SoA.  x, dt,
// b, c and y of the storage type `dtype`, a, d and h float32, as under SoA.
// Returns 0, a cudaError_t, tdp::ERR_BAD_VVL (W not a positive multiple of
// 4), tdp::lm::ERR_BAD_NSTATE or tdp::ERR_BAD_DTYPE.
extern "C" int tdp_gathered_mamba_aosoa_launch(int nstate, int W, int dtype,
                                               const void* x, const void* dt,
                                               const void* a, const void* d,
                                               const void* b, const void* c, void* y,
                                               void* h, long long L, long long n,
                                               int rows, void* stream) {
  if (W < 1 || W % tdp::lm::MAMBA_AOSOA_ALIGN) return tdp::ERR_BAD_VVL;
  switch (dtype) {
    case tdp::DTYPE_F32:
      return mamba_aosoa_launch<float>(nstate, W, x, dt, a, d, b, c, y, h, L, n, rows,
                                       stream);
    case tdp::DTYPE_BF16:
      return mamba_aosoa_launch<tdp::bf16>(nstate, W, x, dt, a, d, b, c, y, h, L, n,
                                           rows, stream);
    default: return tdp::ERR_BAD_DTYPE;
  }
}
