// calibrate.cu — the two micro-kernels that calibrate a MachineProfile.
//
// Replaces: src/repro/core/costmodel.py:_calibrate_interpret, whose nested
// Pallas kernels time the interpreter:
//   add_kernel (:190, call :193)  o = x + y over (16384,) f32  -> hbm_bw
//   fma_kernel (:202, call :209)  k = 8 rungs of acc = acc*v + v -> peak_flops
//
// stream_add: o = x + y.  A grid-stride loop over a grid that covers the
// work (one float4 per thread) as far as the grid limit allows; float4
// loads and stores where all three pointers are 16-byte aligned, a scalar
// loop over the tail (and over everything when they are not).  A grid of
// one wave (8 blocks of 256 threads per SM) looping over the array
// measured 2.86 TB/s on the H100 against 3.04 TB/s for the covering grid
// and for torch.add (64 Mi elements).  Bound on the H100: bytes, 12 per element (two reads,
// one write) at 3.35 TB/s.  The calibration runs it over two distinct
// operands of 64 Mi elements each (768 MiB moved), far past the 50 MB L2,
// so the rate is device memory's; the reference's 4 Mi-element x + x would
// sit in L2.
//
// fma_chain: k rungs of acc = fmaf(acc, v, v) from acc = v, k at run time.
// Each thread carries 4 independent elements, so four chains of dependent
// FFMAs hide the pipe's latency; the rung loop is unrolled so the loop
// counter costs a small share of the instruction slots.  Bound: operations,
// 2·k flop per element at 67 TFLOP/s (float32 outside the tensor cores);
// bytes are 8 per element.  At k = 8 that is 2 flop per byte, under the
// card's ~20 flop/byte ridge, so the chain would measure bandwidth: the
// calibration runs k = 1024 over 16 Mi elements (4 Mi threads, many waves
// over 132 SMs).
//
// fma_rung() is __host__ __device__, so the host compiler runs the same
// rung in the tests.  It rounds once (fmaf); the plain PyTorch version
// computes acc * v + v with two roundings.
#include <math.h>
#include <stdint.h>

#if !defined(__CUDACC__)
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace tdp {
namespace cal {

__host__ __device__ __forceinline__ float fma_rung(float acc, float v) {
  return fmaf(acc, v, v);
}

// k rungs from acc = v: what one element of fma_chain computes.
__host__ __device__ __forceinline__ float fma_chain_value(float v, int k) {
  float acc = v;
  for (int r = 0; r < k; ++r) acc = fma_rung(acc, v);
  return acc;
}

}  // namespace cal
}  // namespace tdp

#if defined(__CUDACC__)
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kChains = 4;
constexpr int64_t kMaxBlocks = int64_t(1) << 30;

__global__ void __launch_bounds__(kBlock)
    stream_add_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      float* __restrict__ o, int64_t n, int64_t n4) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* o4 = reinterpret_cast<float4*>(o);
  for (int64_t i = t; i < n4; i += stride) {
    const float4 a = x4[i];
    const float4 b = y4[i];
    o4[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  for (int64_t i = 4 * n4 + t; i < n; i += stride) o[i] = x[i] + y[i];
}

// Thread t of a pass covers elements base + t + j·T, j < kChains, where T
// is the number of threads in the grid: each of the kChains loads and
// stores is coalesced across the warp.
__global__ void __launch_bounds__(kBlock)
    fma_chain_kernel(const float* __restrict__ x, float* __restrict__ o,
                     int64_t n, int k) {
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t base = 0; base < n; base += kChains * threads) {
    float v[kChains], acc[kChains];
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      const int64_t i = base + t + j * threads;
      v[j] = i < n ? x[i] : 0.0f;
      acc[j] = v[j];
    }
#pragma unroll 16
    for (int r = 0; r < k; ++r) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) acc[j] = tdp::cal::fma_rung(acc[j], v[j]);
    }
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      const int64_t i = base + t + j * threads;
      if (i < n) o[i] = acc[j];
    }
  }
}

// Blocks of kBlock threads for one thread per work item, at most kMaxBlocks
// (the kernels loop over what a capped grid leaves).
unsigned blocks_for(int64_t work) {
  const int64_t want = (work + kBlock - 1) / kBlock;
  return (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

// Device pointers, float32, contiguous, n elements each.  Returns 0 or a
// cudaError_t.
extern "C" int calibrate_stream_add(const void* x, const void* y, void* o,
                                    long long n, void* stream) {
  if (n <= 0) return 0;
  const bool aligned =
      (((uintptr_t)x | (uintptr_t)y | (uintptr_t)o) & (uintptr_t)15) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  const int64_t tail = n - 4 * n4;
  stream_add_kernel<<<blocks_for(n4 > tail ? n4 : tail), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(o), n, n4);
  return (int)cudaGetLastError();
}

// k >= 0 rungs over n elements.  The grid covers every element in one pass
// when it can (one thread per kChains elements), else loops.
extern "C" int calibrate_fma_chain(const void* x, void* o, long long n, int k,
                                   void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = blocks_for((n + kChains - 1) / kChains);
  fma_chain_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n, k);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
