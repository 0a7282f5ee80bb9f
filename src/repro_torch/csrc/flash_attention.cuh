// flash_attention.cuh — the per-row online-softmax update of flash attention.
//
// What one query row does with one tile of keys, written once as
// __host__ __device__ functions: flash_attention.cu runs them with warp
// reductions across the tile, and the host C++ harness of the tests runs
// them in a plain loop against the plain PyTorch version.
//
// For a row with running max m and running sum l, a tile of dot products
// q.k_j becomes
//   s_j   = logit(dot_j)                 scale, then softcap c*tanh(s/c)
//   live_j                               k < Sk, causal k <= q, window k > q - W
//   m'    = max(m, max_{live j} s_j)     row_rescale: returns a = exp(m - m')
//   p_j   = live_j ? exp(s_j - m') : 0   row_weight
//   l'    = l*a + sum_j p_j              row_sum
//   acc'  = acc*a + sum_j p_j v_j        (the caller's accumulator)
// and at the end out = acc / l, or 0 for a row with no live key (row_out),
// and the row's log-sum-exp m + log(l) (row_lse).
// The softcap comes before the mask, as in the reference; masked keys never
// enter the max, so a row stays at m = -inf until its first live key.
//
// The second half is the tensor-core tile of flash_attention.cu: the
// fragment maps of mma.sync.m16n8k8 with TF32 operands, TF32 rounding and
// the 3xTF32 split, the fragment loads from shared memory and the same row
// update applied to a warp's S fragment.  All are __host__ __device__, so
// the tests' harness runs a tile lane by lane through a host emulation of
// the mma.
//
// Storage: q, k, v and o are float32 or bfloat16 (bf16.cuh), one type for
// the four.  The tile always holds float32: a bfloat16 row is widened as it
// is staged (stage_rows), so every fragment load and product below is the
// float32 code's, and o is rounded to bfloat16 once, as it is stored
// (st_row).  A bfloat16 value is exact in TF32, so 3xTF32's small term of a
// bfloat16 operand is 0 (flash_attention.cu skips those products).
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "async_copy.cuh"  // tdp::copy16, zero16, ld_shared
#include "bf16.cuh"         // tdp::bf16, pack_bf16x2, unpack_bf16x2

#if !defined(__CUDACC__)
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace tdp {
namespace attn {

struct Params {
  float scale;    // softmax scale (head_dim^-1/2 unless given)
  float softcap;  // 0: off
  int causal;     // 1: k <= q
  int window;     // 0: off; else k > q - window
  int sk;         // keys k >= sk are masked (the ragged tail)
};

__host__ __device__ __forceinline__ float logit(const Params& p, float dot) {
  float s = dot * p.scale;
  if (p.softcap > 0.0f) s = p.softcap * tanhf(s / p.softcap);
  return s;
}

__host__ __device__ __forceinline__ bool live(const Params& p, int q, int k) {
  return k < p.sk && (!p.causal || k <= q) && (p.window <= 0 || k > q - p.window);
}

// The key range [lo, hi), lo a multiple of the tile width bk, whose tiles
// can hold a live key for query rows q0 .. q_last: under the causal mask no
// key past q_last is live, under the window none before q0 - window + 1.
// Tiles outside it are wholly dead and are skipped.
__host__ __device__ __forceinline__ void key_range(const Params& p, int q0, int q_last,
                                                   int bk, int& lo, int& hi) {
  hi = p.sk;
  if (p.causal && q_last + 1 < hi) hi = q_last + 1;
  lo = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0) lo = q0 - p.window + 1;
  lo = lo / bk * bk;
}

struct RowState {
  float m;  // running max of the live logits (-inf: none yet)
  float l;  // running sum of exp(s - m)
};

__host__ __device__ __forceinline__ RowState row_init() { return RowState{-INFINITY, 0.0f}; }

// Fold a tile whose live logits peak at tile_max (-inf: no live key) into
// the running max; returns the factor that rescales l and the accumulator.
__host__ __device__ __forceinline__ float row_rescale(RowState& st, float tile_max) {
  const float m_new = fmaxf(st.m, tile_max);
  const float alpha = m_new == -INFINITY ? 1.0f : expf(st.m - m_new);
  st.m = m_new;
  return alpha;
}

__host__ __device__ __forceinline__ float row_weight(const RowState& st, float s, bool is_live) {
  return is_live ? expf(s - st.m) : 0.0f;
}

__host__ __device__ __forceinline__ void row_sum(RowState& st, float alpha, float tile_sum) {
  st.l = st.l * alpha + tile_sum;
}

__host__ __device__ __forceinline__ float row_out(const RowState& st, float acc) {
  return st.l > 0.0f ? acc / st.l : 0.0f;
}

// The row's log-sum-exp of its live logits, m + log(l), for the backward
// pass; -1e30 for a row with no live key (the plain version's convention).
__host__ __device__ __forceinline__ float row_lse(const RowState& st) {
  return st.l > 0.0f ? st.m + logf(st.l) : -1e30f;
}

// ---------------------------------------------------------------------------
// the tensor-core tile: mma.sync.m16n8k8, TF32 operands, fp32 accumulators
// ---------------------------------------------------------------------------
//
// Lane = 4·grp + tig (grp 0..7, tig 0..3).  The fragment maps of
// mma.m16n8k8 with .tf32 (PTX ISA), for D = A·B + C:
//   A (16 × 8, row-major)  a_i at row grp + 8·(i & 1), col tig + 4·(i >> 1)
//   B (8 × 8, k × n)       b_i at k tig + 4·i,         n grp
//   C (16 × 8)             c_i at row grp + 8·(i >> 1), col 2·tig + (i & 1)
// Which data each of those rows, columns and k slots stands for is free
// wherever a product sums over it, and is chosen so that a lane's operands
// lie side by side in shared memory (one 16-byte load for four of them):
//
// S = Q·Kᵀ (a warp's 16 query rows × BK keys, BK/8 C fragments): k slot
//   kslot of k-step 2·kp + h is dimension qk_dim(kp, h, kslot) =
//   16·kp + 4·(kslot % 4) + 2·h + kslot / 4, so a lane reads Q (and K) at
//   dimensions 16·kp + 4·tig .. + 3 for both steps of a pair; S's column n
//   of fragment j is key 8·j + n.
// O += P·V runs transposed, Oᵀ += Vᵀ·Pᵀ: A = Vᵀ (16 dimension slots × 8
//   keys), B = Pᵀ (8 keys × 8 query rows), C = Oᵀ.  B's k slot tig is key
//   8·j + 2·tig and tig + 4 is 8·j + 2·tig + 1 (pv_key), so Pᵀ's B fragment
//   of rows 8·nr .. 8·nr + 7 is S's C fragment as it is (b_i = c_{2·nr+i});
//   A's row s of m-tile t of pair p is dimension pv_dim(p, t, s) = W·p +
//   (W/8)·(s % 8) + 2·t + s / 8 (W dimensions a pair: 32 where 32 divides
//   Dh, else 16, so the pairs cover Dh exactly: Dh 80 is five pairs of
//   16), so a lane reads V at dimensions W·p + (W/8)·grp .. + W/8 - 1 of
//   its two keys.
//   A lane's Oᵀ registers then hold query rows 8·nr + 2·tig + (i & 1), not
//   its softmax rows grp and grp + 8: the factors of those rows come from
//   lane o_src(lane, e) = 4·(2·tig + e) by a shuffle.
// Row strides: Q and K rows ≡ 16 floats mod 32 and V rows Dh + 4 floats,
// so each quarter-warp's 16-byte loads hit 32 distinct banks.

// A block of FLASH_WARPS warps takes FLASH_BQ query rows; a tile holds BK
// keys (32 at Dh >= 128, 64 below).  One stage of K and one of V: K of tile
// j + 1 lands while the block works on P·V of tile j, V of tile j + 1 while
// it works on S of tile j + 1.
constexpr int FLASH_WARPS = 8;
constexpr int FLASH_THREADS = 32 * FLASH_WARPS;
constexpr int FLASH_BQ = 16 * FLASH_WARPS;

template <int DH>
struct FlashTile {
  static constexpr int BK = DH >= 128 ? 32 : 64;           // keys of a tile
  static constexpr int SQK = DH + (DH % 32 == 16 ? 0 : 16);  // Q, K row stride
  static constexpr int SV = DH + 4;                        // V row stride
  static constexpr int NJ = BK / 8;                        // S fragments
  static constexpr int NKP = DH / 16;                      // Q·Kᵀ k-step pairs
  static constexpr int W = DH % 32 == 0 ? 32 : 16;         // dims of a V pair
  static constexpr int NP = DH / W;                        // V pairs
  static constexpr int NT = W / 16;                        // m-tiles a pair
  // the k-step pairs and the V pairs cover every dimension (Dh 80: W 16,
  // NP 5; a W of 32 there would leave O's last 16 dimensions unwritten)
  static_assert(DH % 16 == 0 && DH % W == 0, "head_dim: a multiple of 16");
  static constexpr int K = FLASH_BQ * SQK;                 // K's offset (Q first)
  static constexpr int V = K + BK * SQK;                   // V's offset
  static constexpr size_t SMEM = (size_t)(V + BK * SV) * sizeof(float);
};

__host__ __device__ __forceinline__ void frag_a(int lane, int i, int& row, int& col) {
  row = lane / 4 + 8 * (i & 1);
  col = lane % 4 + 4 * (i >> 1);
}

__host__ __device__ __forceinline__ void frag_b(int lane, int i, int& k, int& n) {
  k = lane % 4 + 4 * i;
  n = lane / 4;
}

__host__ __device__ __forceinline__ void frag_c(int lane, int i, int& row, int& col) {
  row = lane / 4 + 8 * (i >> 1);
  col = 2 * (lane % 4) + (i & 1);
}

__host__ __device__ __forceinline__ int qk_dim(int kp, int h, int kslot) {
  return 16 * kp + 4 * (kslot % 4) + 2 * h + kslot / 4;
}

__host__ __device__ __forceinline__ int pv_key(int kslot) { return 2 * (kslot % 4) + kslot / 4; }

template <int W>
__host__ __device__ __forceinline__ int pv_dim(int p, int t, int s) {
  return W * p + (W / 8) * (s % 8) + 2 * t + s / 8;
}

// The lane whose softmax rows include Oᵀ's rows 8·nr + 2·tig + e (as its row
// half nr).
__host__ __device__ __forceinline__ int o_src(int lane, int e) { return 4 * (2 * (lane % 4) + e); }

// Shuffle round r of a quad's reduction: xor 1, then xor 2.
__host__ __device__ __forceinline__ int quad_xor(int r) { return 1 << r; }

__host__ __device__ __forceinline__ float bits_float(uint32_t u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

__host__ __device__ __forceinline__ uint32_t float_bits(float f) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
#endif
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero:
// cvt.rna.tf32.f32 on the card; the same rule on the bits on the host.
__host__ __device__ __forceinline__ uint32_t tf32_rna(float x) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
#else
  uint32_t u = float_bits(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return u;
#endif
}

// The operand of a product.  SPLIT 1: hi = tf32_rna(x), one product (what
// the tests' harness holds 3xTF32 against; the kernel runs SPLIT 3).
// SPLIT 3 (3xTF32): hi = x with its low 13 bits cleared, lo = x - hi (exact
// in fp32), and a·b is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi; the tensor core
// reads a TF32 operand's top 19 bits, so lo enters truncated: ~2^-20
// relative error a product, against 2^-11 for one TF32 product.
template <int SPLIT>
struct Tf32 {
  uint32_t hi, lo;
};

template <int SPLIT>
__host__ __device__ __forceinline__ Tf32<SPLIT> tf32_split(float x) {
  Tf32<SPLIT> r;
  if (SPLIT == 3) {
    r.hi = float_bits(x) & 0xffffe000u;
    r.lo = float_bits(x - bits_float(r.hi));
  } else {
    r.hi = tf32_rna(x);
    r.lo = 0u;
  }
  return r;
}

// p[0, N) = v (global memory, aligned to 4·N bytes).
template <int N>
__host__ __device__ __forceinline__ void st_row(float* p, const float (&v)[N]) {
#if defined(__CUDA_ARCH__)
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
#else
  for (int i = 0; i < N; ++i) p[i] = v[i];
#endif
}

// p[0, N) = v rounded to bfloat16 (global memory, aligned to 2·N bytes).
template <int N>
__host__ __device__ __forceinline__ void st_row(bf16* p, const float (&v)[N]) {
#if defined(__CUDA_ARCH__)
  if constexpr (N == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]),
                                              pack_bf16x2(v[2], v[3]));
  else
    *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v[0], v[1]);
#else
  for (int i = 0; i < N; ++i) p[i] = from_f32<bf16>(v[i]);
#endif
}

// dst (shared) = 16 bytes of src as floats: a float32 row's 4 by cp.async
// (copy16); a bfloat16 row's 8 by one 16-byte load, widened and stored as
// two float4, synchronously.
__host__ __device__ __forceinline__ void stage16(float* dst, const float* src) {
  copy16(dst, src);
}

__host__ __device__ __forceinline__ void stage16(float* dst, const bf16* src) {
#if defined(__CUDA_ARCH__)
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(src));
  float4 a, b;
  unpack_bf16x2(w.x, a.x, a.y);
  unpack_bf16x2(w.y, a.z, a.w);
  unpack_bf16x2(w.z, b.x, b.y);
  unpack_bf16x2(w.w, b.z, b.w);
  reinterpret_cast<float4*>(dst)[0] = a;
  reinterpret_cast<float4*>(dst)[1] = b;
#else
  for (int i = 0; i < 8; ++i) dst[i] = to_f32(src[i]);
#endif
}

// Thread tid of nthreads stages rows r_begin .. r_begin + nrows - 1 of a
// matrix whose rows (DH contiguous values of type T, 16-byte aligned) lie
// ld values apart into dst (float32, row stride st) by 16-byte pieces
// (stage16); rows from `limit` on (the ragged tail of Sq or Sk) are
// zero-filled, so a dead key's V row adds 0·0 and never NaN.
template <int DH, class T>
__host__ __device__ __forceinline__ void stage_rows(float* dst, int st, const T* src,
                                                    int64_t ld, int r_begin, int nrows,
                                                    int limit, int tid, int nthreads) {
  constexpr int E = 16 / (int)sizeof(T);  // values of a 16-byte piece
  constexpr int DE = DH / E;
  for (int i = tid; i < nrows * DE; i += nthreads) {
    const int r = i / DE, c = E * (i % DE);
    if (r_begin + r < limit) {
      stage16(dst + r * st + c, src + (int64_t)(r_begin + r) * ld + c);
    } else {
      zero16(dst + r * st + c);
      if constexpr (E == 8) zero16(dst + r * st + c + 4);
    }
  }
}

// Q's A fragments of k-steps 2·kp and 2·kp + 1 for the warp's rows r0 ..
// r0 + 15: a[h][i] (row grp + 8·(i & 1), dimension qk_dim(kp, h, tig +
// 4·(i >> 1))); the four dimensions of a row lie side by side from
// qk_dim(kp, 0, tig).
__host__ __device__ __forceinline__ void load_a_q(const float* Qs, int st, int r0, int kp,
                                                  int lane, float (&a)[2][4]) {
  const int grp = lane / 4, col = qk_dim(kp, 0, lane % 4);
  float x[4], y[4];
  ld_shared<4>(Qs + (r0 + grp) * st + col, x);
  ld_shared<4>(Qs + (r0 + grp + 8) * st + col, y);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[h][0] = x[2 * h];
    a[h][1] = y[2 * h];
    a[h][2] = x[2 * h + 1];
    a[h][3] = y[2 * h + 1];
  }
}

// K's B fragments of the same k-steps for S's fragment j: b[h][i] (key
// 8·j + grp, dimension qk_dim(kp, h, tig + 4·i)).
__host__ __device__ __forceinline__ void load_b_k(const float* Ks, int st, int j, int kp,
                                                  int lane, float (&b)[2][2]) {
  float z[4];
  ld_shared<4>(Ks + (8 * j + lane / 4) * st + qk_dim(kp, 0, lane % 4), z);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    b[h][0] = z[2 * h];
    b[h][1] = z[2 * h + 1];
  }
}

// Vᵀ's A fragments of pair p, key step j: a[t][i] (dimension pv_dim(p, t,
// grp + 8·(i & 1)), key 8·j + pv_key(tig + 4·(i >> 1))); a key's W/8
// dimensions lie side by side from pv_dim(p, 0, grp).
template <int W>
__host__ __device__ __forceinline__ void load_a_v(const float* Vs, int st, int j, int p,
                                                  int lane, float (&a)[W / 16][4]) {
  const int tig = lane % 4, col = pv_dim<W>(p, 0, lane / 4);
  float u[W / 8], w[W / 8];
  ld_shared<W / 8>(Vs + (8 * j + pv_key(tig)) * st + col, u);
  ld_shared<W / 8>(Vs + (8 * j + pv_key(tig + 4)) * st + col, w);
#pragma unroll
  for (int t = 0; t < W / 16; ++t) {
    a[t][0] = u[2 * t];
    a[t][1] = u[2 * t + 1];
    a[t][2] = w[2 * t];
    a[t][3] = w[2 * t + 1];
  }
}

// The row update on a warp's S fragments s[NJ][4] (keys key0 .. key0 +
// 8·NJ - 1; this lane's rows q_row0 + grp and q_row0 + grp + 8), in three
// steps around the quad's two reductions:
//   frag_logits: logit() in place, a masked key set to -inf; mx[h] is the
//     lane's max over the live logits of its row h (-inf: none);
//   frag_weights (mx now the quad's): row_rescale, then each logit becomes
//     its weight row_weight() and sum[h] the lane's sum of them;
//   frag_rows (sum now the quad's): row_sum.
// Then every Oᵀ register is scaled by its row's factor (frag_rescale, the
// factors shuffled from o_src).
template <int NJ>
__host__ __device__ __forceinline__ void frag_logits(const Params& p, int q_row0,
                                                     int key0, int lane,
                                                     float (&s)[NJ][4], float (&mx)[2]) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r, c;
      frag_c(lane, i, r, c);
      const bool lv = live(p, q_row0 + r, key0 + 8 * j + c);
      const float v = logit(p, s[j][i]);
      s[j][i] = lv ? v : -INFINITY;
      if (lv) mx[i >> 1] = fmaxf(mx[i >> 1], v);
    }
}

template <int NJ>
__host__ __device__ __forceinline__ void frag_weights(RowState (&st)[2],
                                                      const float (&mx)[2],
                                                      float (&s)[NJ][4],
                                                      float (&alpha)[2],
                                                      float (&sum)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    alpha[h] = row_rescale(st[h], mx[h]);
    sum[h] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = row_weight(st[i >> 1], s[j][i], s[j][i] != -INFINITY);
      sum[i >> 1] += s[j][i];
    }
}

__host__ __device__ __forceinline__ void frag_rows(RowState (&st)[2], const float (&alpha)[2],
                                                   const float (&sum)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) row_sum(st[h], alpha[h], sum[h]);
}

// o[p][t][nr][i] holds query row 8·nr + 2·tig + (i & 1); f[nr][e] is the
// factor of row 8·nr + 2·tig + e.
template <int NP, int NT>
__host__ __device__ __forceinline__ void frag_rescale(float (&o)[NP][NT][2][4],
                                                      const float (&f)[2][2]) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int nr = 0; nr < 2; ++nr)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[p][t][nr][i] *= f[nr][i & 1];
}

// Query row 8·nr + 2·tig + e of a warp's Oᵀ registers, divided by the row's
// sum (rs, from o_src): dimensions pv_dim(p, t, grp) and pv_dim(p, t, grp +
// 8) — W·p + (W/8)·grp + 0 .. W/8 - 1 — of every pair p in one store each.
template <int NP, int NT, int W, class T>
__host__ __device__ __forceinline__ void store_o_row(T* orow, int lane,
                                                     const float (&o)[NP][NT][2][4],
                                                     int nr, int e, const RowState& rs) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float v[W / 8];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      v[2 * t] = row_out(rs, o[p][t][nr][e]);
      v[2 * t + 1] = row_out(rs, o[p][t][nr][e + 2]);
    }
    st_row<W / 8>(orow + pv_dim<W>(p, 0, lane / 4), v);
  }
}

}  // namespace attn
}  // namespace tdp
