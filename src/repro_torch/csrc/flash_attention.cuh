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
// and at the end out = acc / l, or 0 for a row with no live key (row_out).
// The softcap comes before the mask, as in the reference; masked keys never
// enter the max, so a row stays at m = -inf until its first live key.
#pragma once

#include <math.h>

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

}  // namespace attn
}  // namespace tdp
