// flash_attention.cu — blocked (flash) attention forward on Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas (the
// Pallas kernel, body _attn_body): q (B, Hq, Sq, Dh), k/v (B, Hkv, Sk, Dh),
// float32, GQA by h // (Hq / Hkv), logits scaled then soft-capped before the
// mask (k < Sk, causal k <= q, window k > q - W), online softmax with float32
// running max, sum and accumulator, zero output for a row with no live key.
//
// Design (simple first version; tensor cores, TMA and bf16 are later work):
// one block of 8 warps per (b*Hq + h, tile of BQ = 32 query rows); each warp
// owns 4 rows.  The block walks the key tiles of BK = 32 keys that can hold a
// live key for its rows — tiles wholly dead under the causal mask or the
// window are never loaded — staging each K and V tile in shared memory
// (K rows padded by 4 floats so lane j's float4 reads of row j hit distinct
// banks).  Scores: lane j forms the dot products of key j with the warp's 4
// query rows (Q tile broadcast from shared memory), on the CUDA cores in
// float32.  The online-softmax update of each row is flash_attention.cuh's,
// with the tile's max and sum taken by warp shuffles.  P.V: lane l owns
// dimensions l, l+32, ... of each of its warp's rows, p_j broadcast from
// lane j by shuffle.  The ragged tail of Sq and Sk is masked in the kernel,
// not padded; every offset is 64-bit.
//
// Bound on the H100: float32 operations.  4*Dh flops per live (q, k) pair
// (q.k and p.v) against 67 TFLOP/s, versus q, k, v read and o written once
// against 3.35 TB/s; at the gemma2 prefill shape (S 4608, Dh 256) the flops
// bound is ~20x the bytes bound.  Shared memory per block: (32*Dh + 32*(Dh+4)
// + 32*Dh) * 4 bytes, 97.5 KB at Dh 256, so two blocks fit on an SM.
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_attention.cuh"

namespace {

using tdp::attn::Params;
using tdp::attn::RowState;

constexpr int kWarps = 8;
constexpr int kRows = 4;                // query rows per warp
constexpr int kBQ = kWarps * kRows;     // query rows per block
constexpr int kBK = 32;                 // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// Error codes besides cudaError_t values (all positive).
constexpr int ERR_BAD_HEAD_DIM = -3;
constexpr int ERR_BAD_GROUP = -4;

struct AttnIO {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, Hq, Hkv, Sq, Sk;
  Params p;
};

template <int DH>
struct Tile {
  static constexpr int D4 = DH / 4;            // float4s per row
  static constexpr int KSTRIDE = DH + 4;       // padded K row, in floats
  static constexpr int NDL = (DH + 31) / 32;   // P.V dimensions per lane
  static constexpr size_t SMEM =
      (size_t)(kBQ * DH + kBK * KSTRIDE + kBK * DH) * sizeof(float);
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __grid_constant__ AttnIO io) {
  using T = Tile<DH>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // (kBQ, DH)
  float* Ks = Qs + kBQ * DH;                      // (kBK, KSTRIDE)
  float* Vs = Ks + kBK * T::KSTRIDE;              // (kBK, DH)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / io.Hq, h = bh % io.Hq;
  const int hk = h / (io.Hq / io.Hkv);
  const int q0 = blockIdx.x * kBQ;
  const float* qg = io.q + (int64_t)bh * io.Sq * DH;
  const float* kg = io.k + (int64_t)(b * io.Hkv + hk) * io.Sk * DH;
  const float* vg = io.v + (int64_t)(b * io.Hkv + hk) * io.Sk * DH;

  for (int i = tid; i < kBQ * T::D4; i += kThreads) {
    const int r = i / T::D4, c = i % T::D4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < io.Sq) x = ldg4(qg + (int64_t)(q0 + r) * DH + 4 * c);
    reinterpret_cast<float4*>(Qs)[i] = x;
  }

  int k_lo, k_hi;
  tdp::attn::key_range(io.p, q0, min(q0 + kBQ, io.Sq) - 1, kBK, k_lo, k_hi);

  const int r0 = warp * kRows;
  RowState st[kRows];
  float acc[kRows][T::NDL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    st[r] = tdp::attn::row_init();
#pragma unroll
    for (int i = 0; i < T::NDL; ++i) acc[r][i] = 0.0f;
  }

  for (int kt = k_lo; kt < k_hi; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * T::D4; i += kThreads) {
      const int r = i / T::D4, c = i % T::D4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kt + r < io.Sk) {
        kx = ldg4(kg + (int64_t)(kt + r) * DH + 4 * c);
        vx = ldg4(vg + (int64_t)(kt + r) * DH + 4 * c);
      }
      *reinterpret_cast<float4*>(Ks + r * T::KSTRIDE + 4 * c) = kx;
      reinterpret_cast<float4*>(Vs)[i] = vx;
    }
    __syncthreads();

    // q.k_j for the warp's rows, key j = kt + lane
    float dot[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) dot[r] = 0.0f;
    const float4* krow = reinterpret_cast<const float4*>(Ks + lane * T::KSTRIDE);
#pragma unroll 4
    for (int c = 0; c < T::D4; ++c) {
      const float4 kx = krow[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qx = reinterpret_cast<const float4*>(Qs + (r0 + r) * DH)[c];
        dot[r] = fmaf(qx.x, kx.x, dot[r]);
        dot[r] = fmaf(qx.y, kx.y, dot[r]);
        dot[r] = fmaf(qx.z, kx.z, dot[r]);
        dot[r] = fmaf(qx.w, kx.w, dot[r]);
      }
    }

    float pw[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool lv = tdp::attn::live(io.p, q0 + r0 + r, kt + lane);
      const float s = tdp::attn::logit(io.p, dot[r]);
      const float alpha = tdp::attn::row_rescale(st[r], warp_max(lv ? s : -INFINITY));
      pw[r] = tdp::attn::row_weight(st[r], s, lv);
      tdp::attn::row_sum(st[r], alpha, warp_sum(pw[r]));
#pragma unroll
      for (int i = 0; i < T::NDL; ++i) acc[r][i] *= alpha;
    }

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vd[T::NDL];
#pragma unroll
      for (int i = 0; i < T::NDL; ++i) {
        const int d = lane + 32 * i;
        vd[i] = d < DH ? Vs[j * DH + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, pw[r], j);
#pragma unroll
        for (int i = 0; i < T::NDL; ++i) acc[r][i] = fmaf(pj, vd[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int q = q0 + r0 + r;
    if (q >= io.Sq) continue;
    float* orow = io.o + ((int64_t)bh * io.Sq + q) * DH;
#pragma unroll
    for (int i = 0; i < T::NDL; ++i) {
      const int d = lane + 32 * i;
      if (d < DH) orow[d] = tdp::attn::row_out(st[r], acc[r][i]);
    }
  }
}

template <int DH>
int launch(const AttnIO& io, void* stream) {
  if (io.Sq == 0 || io.B * io.Hq == 0) return 0;
  // above 48 KB of shared memory only after opting in (per device, so per call)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile<DH>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((io.Sq + kBQ - 1) / kBQ), (unsigned)(io.B * io.Hq));
  flash_fwd_kernel<DH><<<grid, kThreads, Tile<DH>::SMEM, (cudaStream_t)stream>>>(io);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, Sq, Dh), k/v (B, Hkv, Sk, Dh), o (B, Hq, Sq, Dh): device pointers,
// float32, contiguous, 16-byte aligned.  Returns 0, a cudaError_t,
// ERR_BAD_HEAD_DIM (Dh not in {16, 32, 64, 128, 256}) or ERR_BAD_GROUP
// (Hq not a multiple of Hkv).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int Hq, int Hkv, int Sq,
                                      int Sk, int Dh, float scale, float softcap,
                                      int causal, int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return ERR_BAD_GROUP;
  AttnIO io{static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(o),
            B, Hq, Hkv, Sq, Sk, Params{scale, softcap, causal, window, Sk}};
  switch (Dh) {
    case 16: return launch<16>(io, stream);
    case 32: return launch<32>(io, stream);
    case 64: return launch<64>(io, stream);
    case 128: return launch<128>(io, stream);
    case 256: return launch<256>(io, stream);
    default: return ERR_BAD_HEAD_DIM;
  }
}
