// flash_attention.cu — blocked (flash) attention forward on Hopper's tensor
// cores.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas (the
// Pallas kernel, body _attn_body): q (B, Hq, Sq, Dh), k/v (B, Hkv, Sk, Dh),
// float32, GQA by h // (Hq / Hkv), logits scaled then soft-capped before the
// mask (k < Sk, causal k <= q, window k > q - W), online softmax with float32
// running max, sum and accumulator, zero output for a row with no live key.
//
// Bound on the H100: the products.  4·Dh flops per live (q, k) pair (q·k and
// p·v); q, k, v read and o written once are ~20x less time at the gemma2
// prefill shape (S 4608, Dh 256).  On the CUDA cores (fp32, 67 TFLOP/s) the
// local layer's 1.7e11 flops take 2.565 ms; the first port of this kernel, scalar
// fp32 FMAs with each 32-key tile loaded synchronously between two barriers,
// took 8.664 ms (local) and 8.786 ms (global layer), 0.30 of that bound.
// The TF32 tensor cores do the same products at 495 TFLOP/s: 0.35 ms in one
// TF32 product, 1.04 ms in the three of 3xTF32.
//
// Design.  A block of 8 warps takes 128 query rows of one (batch, head), a
// warp 16 of them.  S = Q·Kᵀ and O += P·V run as mma.sync.m16n8k8 with TF32
// operands and fp32 accumulators.  One TF32 product per product misses the
// reference's bar of 2e-4 (measured once on the card: error up to 1.4e-3,
// 3.38 ms for the local layer; PERF.md §6), so each operand is split into
// a TF32 high part and the rest (3xTF32: within 5.2e-6 of the plain
// version at gemma2-2b's prefill).  The tensor core rounds its fp32
// accumulation toward zero, so O takes each key tile's P·V from a fresh
// fragment by a rounded add: chained into O over 1500 keys, the output
// drifted 1.0e-5 toward zero against float64, 1.2e-6 so (whisper's
// encoder shape; PERF.md §6).  The online softmax runs on the
// accumulator fragments (flash_attention.cuh: a row's max and sum over its
// quad of lanes by two shuffles).  P·V runs transposed,
// Oᵀ += Vᵀ·Pᵀ, so S's C fragment is Pᵀ's B fragment as it is and P never
// leaves registers.  The data behind each k slot and row of the fragments
// is chosen so that a lane's Q, K and Vᵀ operands sit side by side: one
// 16-byte shared-memory load for four of them, conflict-free (rows padded
// to ≡ 16 floats mod 32 for Q and K, ≡ 4 for V).  The fp32 O accumulator
// is Dh/2 registers a lane (128 at Dh 256), so Q lives in shared memory,
// staged once.  One stage each of K and V (BK keys: 32 at Dh >= 128, 64
// below) by 16-byte cp.async: K of tile j + 1 lands while the block works
// on the softmax and P·V of tile j, V of tile j + 1 while it works on S of
// tile j + 1.  Tiles wholly dead under the causal mask or the window are
// never loaded (key_range); the ragged tails of Sq and Sk are masked
// (zero-filled rows, live()), not padded.  Query tiles run last first, so
// the longest causal rows start first.  Shared memory at Dh 256: 207 KB
// (one block, two warps a scheduler, 246 registers, no spill); at Dh 80
// (zamba2: V pairs of 16 dimensions, see FlashTile) 82 944 B; at Dh 192
// (deepseek-v3's MLA: q·k over 128 + 64 dimensions, V zero-padded from 128
// by the caller) BK 32, Q and K rows of 208 floats, V rows of 196, six V
// pairs of 32, 158 208 B, and 96 O registers a lane.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): 4.99 ms local,
// 5.17 ms global at gemma2-2b's prefill, ~5x its 3xTF32 bound; scratch
// variants point at latency (~0.2 instructions a cycle a scheduler) as
// what holds it there, not L2 or the masks (PERF.md §7).
//
// For the backward pass the kernel can also store each row's log-sum-exp,
// m + log(l) from the running max and sum it holds at the end (one store a
// row; a null pointer skips it, so serving does not pay for it).
//
// Each operand is addressed by (batch, head, row) strides in elements with
// rows of Dh contiguous elements, 16-byte aligned, so the model's (B, S, H,
// Dh) projections come in as transposed views, and o goes out in q's layout.
//
// bfloat16 (A7.1 at Dh 128 and 256, A7.1b at every other head dim of the
// float32 kernel; one instantiation a head dim and type): q, k, v and o in
// bfloat16, the tile, the softmax state and lse in float32, as the
// reference's kernel computes (its operands cast to float32, p kept in
// float32 for P·V: src/repro/kernels/flash_attention.py:57-59, :80).  A
// bfloat16 value is exact in TF32, so S = Q·Kᵀ is one TF32 product with
// float32 accumulation (3xTF32's small terms are 0) and P·V two (P's high
// and low parts against V), where float32 takes three each; P is never
// rounded to bfloat16 (SDPA and FlashAttention round it: another
// function).  A bfloat16 row is staged by 16-byte loads widened into the
// float32 tile (stage16), synchronously: the float32 kernel's cp.async
// overlap of the next tile is lost, the simple first version.  Bound: the
// same live pairs at 3 TF32 products a pair-dimension where float32 takes
// 6; q, k, v, o move half the bytes.
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_attention.cuh"

namespace {

using tdp::attn::Params;
using tdp::attn::Tf32;

constexpr int kThreads = tdp::attn::FLASH_THREADS;
constexpr int kBQ = tdp::attn::FLASH_BQ;  // query rows of a block
constexpr unsigned kFull = 0xffffffffu;

// Error codes besides cudaError_t values (all positive).
constexpr int ERR_BAD_HEAD_DIM = -3;
constexpr int ERR_BAD_GROUP = -4;

template <class T>
struct AttnIO {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* lse;  // (B, Hq, Sq) contiguous, or null: no store
  int64_t sq[3], sk[3], sv[3], so[3];  // (batch, head, row) strides, elements
  int B, Hq, Hkv, Sq, Sk;
  Params p;
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The kernel's operands: 3xTF32 (flash_attention.cuh: tf32_split).
using Op = Tf32<3>;

__device__ __forceinline__ Op split(float x) { return tdp::attn::tf32_split<3>(x); }

// d += a·b in 3xTF32: the small terms first, then hi·hi.  A_EXACT /
// B_EXACT: that operand holds bfloat16 values, exact in TF32 (lo = 0), and
// its small term, a product with 0, is skipped.
template <bool A_EXACT = false, bool B_EXACT = false>
__device__ __forceinline__ void mma(float (&d)[4], const Op (&a)[4], const Op (&b)[2]) {
  if (!A_EXACT) mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  if (!B_EXACT) mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

template <int DH, class Store>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __grid_constant__ AttnIO<Store> io) {
  // bfloat16 operands (Q, K, V) are exact in TF32; P is float32
  constexpr bool kExact = sizeof(Store) == 2;
  using T = tdp::attn::FlashTile<DH>;
  using namespace tdp::attn;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (kBQ, SQK)
  float* Ks = Qs + T::K;                         // (BK, SQK)
  float* Vs = Qs + T::V;                         // (BK, SV)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / io.Hq, h = bh % io.Hq;
  const int hk = h / (io.Hq / io.Hkv);
  const int q0 = (int)(gridDim.x - 1 - blockIdx.x) * kBQ;
  const Store* qg = io.q + b * io.sq[0] + h * io.sq[1];
  const Store* kg = io.k + b * io.sk[0] + hk * io.sk[1];
  const Store* vg = io.v + b * io.sv[0] + hk * io.sv[1];
  Store* og = io.o + b * io.so[0] + h * io.so[1];

  // copy groups, in order: Q with K of the first tile, V of the first tile;
  // then per tile K, V of the next (empty past the last), so "all but the
  // newest group landed" is the tile's K before S and its V before P·V.  A
  // query tile with no live key copies nothing: its rows are zero, and no
  // copy is left in flight when the block exits
  int k_lo, k_hi;
  key_range(io.p, q0, min(q0 + kBQ, io.Sq) - 1, T::BK, k_lo, k_hi);
  if (k_lo < k_hi) {
    stage_rows<DH>(Qs, T::SQK, qg, io.sq[2], q0, kBQ, io.Sq, tid, kThreads);
    stage_rows<DH>(Ks, T::SQK, kg, io.sk[2], k_lo, T::BK, io.Sk, tid, kThreads);
  }
  tdp::cp_async_commit();
  if (k_lo < k_hi)
    stage_rows<DH>(Vs, T::SV, vg, io.sv[2], k_lo, T::BK, io.Sk, tid, kThreads);
  tdp::cp_async_commit();

  const int r0 = 16 * warp;
  float o[T::NP][T::NT][2][4];  // Oᵀ fragments (query rows 2·tig + ..., see .cuh)
#pragma unroll
  for (int p = 0; p < T::NP; ++p)
#pragma unroll
    for (int t = 0; t < T::NT; ++t)
#pragma unroll
      for (int nr = 0; nr < 2; ++nr)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[p][t][nr][i] = 0.0f;
  RowState st[2] = {row_init(), row_init()};

  for (int kt = k_lo; kt < k_hi; kt += T::BK) {
    const bool more = kt + T::BK < k_hi;
    tdp::cp_async_wait<1>();  // this tile's K (and Q) landed: this thread's copies
    __syncthreads();          // ... every thread's

    // S = Q·Kᵀ: one accumulator per fragment and k-step parity, so 2·NJ
    // chains of products are in flight
    float s2[2][T::NJ][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < T::NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s2[hh][j][i] = 0.0f;
#pragma unroll 2
    for (int kp = 0; kp < T::NKP; ++kp) {
      float af[2][4];
      load_a_q(Qs, T::SQK, r0, kp, lane, af);
      Op a[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[hh][i] = split(af[hh][i]);
#pragma unroll
      for (int j = 0; j < T::NJ; ++j) {
        float bf[2][2];
        load_b_k(Ks, T::SQK, j, kp, lane, bf);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const Op bb[2] = {split(bf[hh][0]), split(bf[hh][1])};
          mma<kExact, kExact>(s2[hh][j], a[hh], bb);
        }
      }
    }
    float s[T::NJ][4];
#pragma unroll
    for (int j = 0; j < T::NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = s2[0][j][i] + s2[1][j][i];
    __syncthreads();  // every warp is done with this tile's K
    if (more) stage_rows<DH>(Ks, T::SQK, kg, io.sk[2], kt + T::BK, T::BK, io.Sk, tid, kThreads);
    tdp::cp_async_commit();

    float mx[2], alpha[2], sum[2];
    frag_logits<T::NJ>(io.p, q0 + r0, kt, lane, s, mx);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFull, mx[hh], quad_xor(r)));
    frag_weights<T::NJ>(st, mx, s, alpha, sum);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        sum[hh] += __shfl_xor_sync(kFull, sum[hh], quad_xor(r));
    frag_rows(st, alpha, sum);
    // O's rows only move when some row's running max moved (x 1.0 is exact)
    if (__any_sync(kFull, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
      float f[2][2];
#pragma unroll
      for (int nr = 0; nr < 2; ++nr)
#pragma unroll
        for (int e = 0; e < 2; ++e) f[nr][e] = __shfl_sync(kFull, alpha[nr], o_src(lane, e));
      frag_rescale<T::NP, T::NT>(o, f);
    }

    tdp::cp_async_wait<1>();  // this tile's V landed
    __syncthreads();
    // Oᵀ += Vᵀ·Pᵀ (Pᵀ's B fragments are S's C fragments as they are), a V
    // pair at a time: the tile's products accumulate in a fresh fragment,
    // which O then takes by one rounded add.  The tensor core rounds its
    // fp32 accumulation toward zero, so a chain of mma into O itself over
    // every key tile (3·Sk/8 of them a row) drifts O toward zero; this
    // keeps each chain at the tile's 3·BK/8.
#pragma unroll
    for (int p = 0; p < T::NP; ++p) {
      float c[T::NT][2][4];
#pragma unroll
      for (int t = 0; t < T::NT; ++t)
#pragma unroll
        for (int nr = 0; nr < 2; ++nr)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[t][nr][i] = 0.0f;
#pragma unroll
      for (int j = 0; j < T::NJ; ++j) {
        Op pb[2][2];
#pragma unroll
        for (int nr = 0; nr < 2; ++nr)
#pragma unroll
          for (int i = 0; i < 2; ++i) pb[nr][i] = split(s[j][2 * nr + i]);
        float vf[T::NT][4];
        load_a_v<T::W>(Vs, T::SV, j, p, lane, vf);
#pragma unroll
        for (int t = 0; t < T::NT; ++t) {
          Op va[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) va[i] = split(vf[t][i]);
#pragma unroll
          for (int nr = 0; nr < 2; ++nr) mma<kExact, false>(c[t][nr], va, pb[nr]);
        }
      }
#pragma unroll
      for (int t = 0; t < T::NT; ++t)
#pragma unroll
        for (int nr = 0; nr < 2; ++nr)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[p][t][nr][i] += c[t][nr][i];
    }
    __syncthreads();  // every warp is done with this tile's V
    if (more) stage_rows<DH>(Vs, T::SV, vg, io.sv[2], kt + T::BK, T::BK, io.Sk, tid, kThreads);
    tdp::cp_async_commit();
  }

  // row 8·nr + 2·tig + e: its sum from o_src
#pragma unroll
  for (int nr = 0; nr < 2; ++nr)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      RowState rs = row_init();
      rs.l = __shfl_sync(kFull, st[nr].l, o_src(lane, e));
      const int q = q0 + r0 + 8 * nr + 2 * (lane & 3) + e;
      if (q < io.Sq)
        store_o_row<T::NP, T::NT, T::W>(og + (int64_t)q * io.so[2], lane, o, nr, e, rs);
    }
  // the quad of lanes 4·grp .. 4·grp + 3 holds the state of rows grp and
  // grp + 8 (st[0], st[1]); its first lane stores their log-sum-exp
  if (io.lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int nr = 0; nr < 2; ++nr) {
      const int q = q0 + r0 + (lane >> 2) + 8 * nr;
      if (q < io.Sq) io.lse[(int64_t)bh * io.Sq + q] = row_lse(st[nr]);
    }
  }
}

template <int DH, class T>
int launch(const AttnIO<T>& io, void* stream) {
  if (io.Sq == 0 || io.B * io.Hq == 0) return 0;
  // above 48 KB of shared memory only after opting in (per device, so per call)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tdp::attn::FlashTile<DH>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((io.Sq + kBQ - 1) / kBQ), (unsigned)(io.B * io.Hq));
  flash_fwd_kernel<DH, T>
      <<<grid, kThreads, tdp::attn::FlashTile<DH>::SMEM, (cudaStream_t)stream>>>(io);
  return (int)cudaGetLastError();
}

template <class T>
AttnIO<T> attn_io(const void* q, const void* k, const void* v, void* o, void* lse,
                  const long long* strides, int B, int Hq, int Hkv, int Sq, int Sk,
                  float scale, float softcap, int causal, int window) {
  AttnIO<T> io{};
  io.q = static_cast<const T*>(q);
  io.k = static_cast<const T*>(k);
  io.v = static_cast<const T*>(v);
  io.o = static_cast<T*>(o);
  io.lse = static_cast<float*>(lse);
  for (int i = 0; i < 3; ++i) {
    io.sq[i] = strides[i];
    io.sk[i] = strides[3 + i];
    io.sv[i] = strides[6 + i];
    io.so[i] = strides[9 + i];
  }
  io.B = B, io.Hq = Hq, io.Hkv = Hkv, io.Sq = Sq, io.Sk = Sk;
  io.p = Params{scale, softcap, causal, window, Sk};
  return io;
}

// (head dim) -> launch<DH>(io, stream), io in either storage type
template <class T>
int dispatch_head_dim(int Dh, const AttnIO<T>& io, void* stream) {
  switch (Dh) {
    case 16: return launch<16>(io, stream);
    case 32: return launch<32>(io, stream);
    case 64: return launch<64>(io, stream);
    case 80: return launch<80>(io, stream);
    case 128: return launch<128>(io, stream);
    case 192: return launch<192>(io, stream);
    case 256: return launch<256>(io, stream);
    default: return ERR_BAD_HEAD_DIM;
  }
}

}  // namespace

// q (B, Hq, Sq, Dh), k/v (B, Hkv, Sk, Dh), o (B, Hq, Sq, Dh): device pointers
// of the storage type `dtype` (tdp::DTYPE_F32 or DTYPE_BF16); strides[12] the (batch, head, row) strides of q, k, v and o in
// elements, each a multiple of 16 bytes, rows of Dh contiguous elements,
// every pointer 16-byte aligned.  lse: null, or a contiguous (B, Hq, Sq)
// float32 array that receives each row's log-sum-exp (row_lse).  Returns 0,
// a cudaError_t, ERR_BAD_HEAD_DIM (Dh not in {16, 32, 64, 80, 128, 192,
// 256}), ERR_BAD_GROUP (Hq not a multiple of Hkv) or tdp::ERR_BAD_DTYPE.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      const long long* strides, int B, int Hq, int Hkv,
                                      int Sq, int Sk, int Dh, float scale, float softcap,
                                      int causal, int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return ERR_BAD_GROUP;
  switch (dtype) {
    case tdp::DTYPE_F32:
      return dispatch_head_dim(Dh, attn_io<float>(q, k, v, o, lse, strides, B, Hq, Hkv,
                                                  Sq, Sk, scale, softcap, causal, window),
                               stream);
    case tdp::DTYPE_BF16:
      return dispatch_head_dim(Dh, attn_io<tdp::bf16>(q, k, v, o, lse, strides, B, Hq,
                                                      Hkv, Sq, Sk, scale, softcap, causal,
                                                      window),
                               stream);
    default: return tdp::ERR_BAD_DTYPE;
  }
}
