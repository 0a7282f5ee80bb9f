"""The LM site functions and the attention kernel, checked without a card.

``csrc/lm_sites.cuh`` (the elementwise ``gated``/``act`` thread, the tiled
and few-token ``rmsnorm`` phases and the ``mamba`` lane-group scan) and
``csrc/flash_attention.cuh`` (the per-row online-softmax update, the
dead-tile key range and the tensor-core tile's fragment maps, loads and
fragment-level row update) are ``__host__ __device__``, so the host C++
compiler builds them into a small library.  Its ``host_lm`` and
``host_mamba`` entries have the signatures of ``tdp_gathered_lm_launch``
and ``tdp_gathered_mamba_launch`` and run each launch's own
decomposition: the same choice of mapping and grid as
``csrc/tdp_gathered_lm.cu``, block by block, and inside a block each phase
thread by thread (warp by warp, lane by lane) with the kernel's barriers
between phases, on shared memory filled with NaN, so rmsnorm's partial sums
meet in the kernel's combine order and mamba's lane shares in its shuffle
order; the vector and scalar paths are chosen from the pointers as on the
card.  ``host_flash`` has the signature of ``flash_attention_launch``, plus
the TF32 split it emulates (the kernel's 3, or one TF32 product to compare
with), and runs ``flash_fwd_kernel``'s tile loop the same way, each
``mma.sync.m16n8k8`` emulated on the host from the lanes' registers through
the fragment maps (a TF32 operand's top 19 bits, 3xTF32's split as the
kernel splits).  ``host_attention`` runs the first kernel's row update
(query tiles of 32 rows, key tiles of 32 keys from ``key_range``, the lane
reductions done in order) through the same row functions.  All are held to
the plain PyTorch twins at the tests' bar, ``rtol=2e-4, atol=2e-4`` (one
TF32 product at a TF32 tolerance), at every VVL, on ragged extents and on
unaligned views.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core.layout import aosoa_offsets, aosoa_to_soa, soa_to_aosoa
from repro_torch.kernels import _build
from repro_torch.kernels import lm as tlm
from repro_torch.kernels import tdp_pointwise as tpw
from repro_torch.kernels import ref as tref

TOL = dict(rtol=2e-4, atol=2e-4)

HARNESS = r"""
#include <algorithm>
#include <cmath>
#include <type_traits>
#include <vector>

#include "flash_attention.cuh"
#include "lm_sites.cuh"

namespace {
using namespace tdp::lm;

// Launch<Site, VVL> of tdp_gathered_lm.cu, one block after another; a
// barrier of the kernel is the end of a loop over the block's threads.
template <class Site, int VVL>
struct LmLoop {
  template <class T>
  static int run(const LmIOT<T>& io, void*) {
    if (io.n <= 0) return 0;
    if constexpr (std::is_same<Site, RmsnormSite>::value) {
      if (io.n < RMS_FEW) {
        const int group = rms_few_group(io.n), threads = (int)io.n * group;
        std::vector<float> red(threads);
        for (int t = 0; t < threads; ++t) rms_few_partial(io, group, t, red.data());
        for (int h = group / 2; h > 0; h >>= 1)
          for (int t = 0; t < threads; ++t) rms_few_tree(io, h, t, red.data());
        for (int t = 0; t < threads; ++t) rms_few_scale(io, group, t, red.data());
        return 0;
      }
      std::vector<float> red(RMS_WARPS * 32 * VVL), inv(32 * VVL);
      for (int64_t b = 0, nb = rms_tiled_blocks<VVL>(io.n); b < nb; ++b) {
        for (int t = 0; t < RMS_THREADS; ++t) rms_tiled_partial<VVL>(io, b, t, red.data());
        for (int t = 0; t < RMS_THREADS; ++t)
          rms_tiled_combine<VVL>(io, t, red.data(), inv.data());
        for (int t = 0; t < RMS_THREADS; ++t) rms_tiled_scale<VVL>(io, b, t, inv.data());
      }
    } else {
      for (int64_t b = 0, nb = ew_blocks<VVL>(io.n); b < nb; ++b)
        for (int t = 0; t < EW_BLOCK; ++t) ew_thread<Site, VVL>(io, b, t);
    }
    return 0;
  }
};
}  // namespace

template <class T>
int host_lm_t(int site, int act, int vvl, const void* x, const void* v,
              const void* weight, void* out, long long n, int ncomp, float eps,
              float scale_offset, void* stream) {
  tdp::lm::LmIOT<T> io{};
  io.in[0] = static_cast<const T*>(x);
  io.in[1] = static_cast<const T*>(v);
  io.out = static_cast<T*>(out);
  io.weight = static_cast<const T*>(weight);
  io.n = n;
  io.ncomp = ncomp;
  io.eps = eps;
  io.scale_offset = scale_offset;
  return tdp::lm::dispatch_site<LmLoop>(site, act, vvl, io, stream);
}

// tdp_gathered_lm_launch's signature, dtype code and all.
extern "C" int host_lm(int site, int act, int vvl, int dtype, const void* x,
                       const void* v, const void* weight, void* out, long long n,
                       int ncomp, float eps, float scale_offset, void* stream) {
  switch (dtype) {
    case tdp::DTYPE_F32:
      return host_lm_t<float>(site, act, vvl, x, v, weight, out, n, ncomp, eps,
                              scale_offset, stream);
    case tdp::DTYPE_BF16:
      return host_lm_t<tdp::bf16>(site, act, vvl, x, v, weight, out, n, ncomp, eps,
                                  scale_offset, stream);
    default: return tdp::ERR_BAD_DTYPE;
  }
}

namespace {
// MambaLaunch of tdp_gathered_lm.cu: block by block over (channel block,
// row); in a block, each phase over all its threads before the next (the
// kernel's barriers), on two stages of shared memory filled with NaN; per
// step and channel slot, the lanes' shares of y summed in the kernel's
// shuffle rounds, each lane adding its partner's value of the round before.
template <class T>
T nan_of();
template <>
float nan_of<float>() { return NAN; }
template <>
tdp::bf16 nan_of<tdp::bf16>() { return tdp::bf16{0x7fc0}; }

template <class Site, int VVL, bool AOSOA>
struct MambaLoopT {
  template <class T>
  static int run(const MambaIOT<T>& io, void*) {
    constexpr int N = Site::kN;
    using Tl = MambaTile<N, VVL>;
    if (io.n == 0 || io.L == 0 || io.rows == 0) return 0;
    const int64_t nq = mamba_chunks<N, VVL>(io.L);
    std::vector<T> smem(2 * Tl::ELEMS);
    std::vector<MambaLane<N, VVL>> lanes(MAMBA_THREADS);
    float p[MAMBA_THREADS], sum[MAMBA_THREADS];
    for (int row = 0; row < io.rows; ++row)
      for (int64_t blk = 0, nb = mamba_blocks<N, VVL>(io.n); blk < nb; ++blk) {
        std::fill(smem.begin(), smem.end(), nan_of<T>());
        T* stage[2] = {smem.data(), smem.data() + Tl::ELEMS};
        for (int t = 0; t < MAMBA_THREADS; ++t)
          mamba_lane_init<N, VVL, AOSOA>(io, blk, t, lanes[t]);
        for (int t = 0; t < MAMBA_THREADS; ++t)
          mamba_stage<N, VVL, AOSOA>(io, row, blk, 0, t, stage[0]);
        for (int64_t q = 0; q < nq; ++q) {
          if (q + 1 < nq)
            for (int t = 0; t < MAMBA_THREADS; ++t)
              mamba_stage<N, VVL, AOSOA>(io, row, blk, q + 1, t, stage[(q + 1) & 1]);
          const T* buf = stage[q & 1];
          const int steps = io.L - q * Tl::T < Tl::T ? (int)(io.L - q * Tl::T) : Tl::T;
          for (int s = 0; s < steps; ++s)
            for (int v = 0; v < VVL; ++v) {
              for (int t = 0; t < MAMBA_THREADS; ++t)
                p[t] = mamba_partial<N, VVL>(buf, s, v, t, lanes[t]);
              for (int r = 0; r < MAMBA_ROUNDS; ++r) {
                for (int t = 0; t < MAMBA_THREADS; ++t) sum[t] = p[t] + p[t ^ mamba_xor(r)];
                std::copy(sum, sum + MAMBA_THREADS, p);
              }
              for (int t = 0; t < MAMBA_THREADS; ++t)
                mamba_out<N, VVL, AOSOA>(io, buf, row, blk, q, s, v, t, lanes[t], p[t]);
            }
        }
        for (int t = 0; t < MAMBA_THREADS; ++t)
          mamba_final<N, VVL, AOSOA>(io, row, blk, t, lanes[t]);
      }
    return 0;
  }
};

template <class Site, int VVL>
struct MambaLoop : MambaLoopT<Site, VVL, false> {};

// MambaAosoaLaunch of tdp_gathered_lm.cu
template <class Site>
struct MambaAosoaLoop : MambaLoopT<Site, MAMBA_AOSOA_VVL, true> {};
}  // namespace

// tdp_gathered_rmsnorm_aosoa_launch: block by block, each phase over all
// the block's threads before the next, on NaN-filled shared arrays.
template <class T>
int host_rmsnorm_aosoa_t(int W, const void* x, const void* weight, void* out,
                         long long n, int ncomp, float eps, float scale_offset) {
  tdp::lm::LmIOT<T> io{};
  io.in[0] = static_cast<const T*>(x);
  io.out = static_cast<T*>(out);
  io.weight = static_cast<const T*>(weight);
  io.n = n;
  io.ncomp = ncomp;
  io.eps = eps;
  io.scale_offset = scale_offset;
  if (n <= 0) return 0;
  const tdp::AosoaMap m = tdp::make_aosoa_map(W);
  std::vector<float> red(RMS_THREADS), inv(RMS_THREADS);
  for (int64_t b = 0, nb = rms_aosoa_blocks(io, m); b < nb; ++b) {
    std::fill(red.begin(), red.end(), NAN);
    std::fill(inv.begin(), inv.end(), NAN);
    for (int t = 0; t < RMS_THREADS; ++t) rms_aosoa_partial(io, m, b, t, red.data());
    for (int t = 0; t < RMS_THREADS; ++t) rms_aosoa_combine(io, m, t, red.data(), inv.data());
    for (int t = 0; t < RMS_THREADS; ++t) rms_aosoa_scale(io, m, b, t, inv.data());
  }
  return 0;
}

// tdp_gathered_rmsnorm_aosoa_launch's signature, dtype code and all.
extern "C" int host_rmsnorm_aosoa(int W, int dtype, const void* x, const void* weight,
                                  void* out, long long n, int ncomp, float eps,
                                  float scale_offset) {
  if (W < 1) return tdp::ERR_BAD_VVL;
  switch (dtype) {
    case tdp::DTYPE_F32:
      return host_rmsnorm_aosoa_t<float>(W, x, weight, out, n, ncomp, eps, scale_offset);
    case tdp::DTYPE_BF16:
      return host_rmsnorm_aosoa_t<tdp::bf16>(W, x, weight, out, n, ncomp, eps,
                                             scale_offset);
    default: return tdp::ERR_BAD_DTYPE;
  }
}

template <class T>
int host_mamba_aosoa_t(int nstate, int W, const void* x, const void* dt, const void* a,
                       const void* d, const void* b, const void* c, void* y, void* h,
                       long long L, long long n, int rows) {
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
  return tdp::lm::dispatch_mamba_aosoa<MambaAosoaLoop>(nstate, io, nullptr);
}

// tdp_gathered_mamba_aosoa_launch's signature (without the stream), dtype
// code and all.
extern "C" int host_mamba_aosoa(int nstate, int W, int dtype, const void* x,
                                const void* dt, const void* a, const void* d,
                                const void* b, const void* c, void* y, void* h,
                                long long L, long long n, int rows) {
  if (W < 1 || W % MAMBA_AOSOA_ALIGN) return tdp::ERR_BAD_VVL;
  switch (dtype) {
    case tdp::DTYPE_F32:
      return host_mamba_aosoa_t<float>(nstate, W, x, dt, a, d, b, c, y, h, L, n, rows);
    case tdp::DTYPE_BF16:
      return host_mamba_aosoa_t<tdp::bf16>(nstate, W, x, dt, a, d, b, c, y, h, L, n,
                                           rows);
    default: return tdp::ERR_BAD_DTYPE;
  }
}

template <class T>
int host_mamba_t(int nstate, int vvl, const void* x, const void* dt, const void* a,
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
  return tdp::lm::dispatch_mamba<MambaLoop>(nstate, vvl, io, stream);
}

// tdp_gathered_mamba_launch's signature, dtype code and all.
extern "C" int host_mamba(int nstate, int vvl, int dtype, const void* x, const void* dt,
                          const void* a, const void* d, const void* b,
                          const void* c, void* y, void* h, long long L,
                          long long n, int rows, void* stream) {
  switch (dtype) {
    case tdp::DTYPE_F32:
      return host_mamba_t<float>(nstate, vvl, x, dt, a, d, b, c, y, h, L, n, rows, stream);
    case tdp::DTYPE_BF16:
      return host_mamba_t<tdp::bf16>(nstate, vvl, x, dt, a, d, b, c, y, h, L, n, rows,
                                     stream);
    default: return tdp::ERR_BAD_DTYPE;
  }
}

extern "C" void host_attention(const float* q, const float* k, const float* v,
                               float* o, int B, int Hq, int Hkv, int Sq, int Sk,
                               int Dh, float scale, float softcap, int causal,
                               int window) {
  using namespace tdp::attn;
  const int BQ = 32, BK = 32;
  const Params p{scale, softcap, causal, window, Sk};
  for (int b = 0; b < B; ++b)
    for (int h = 0; h < Hq; ++h) {
      const int hk = h / (Hq / Hkv);
      const float* kg = k + (long)(b * Hkv + hk) * Sk * Dh;
      const float* vg = v + (long)(b * Hkv + hk) * Sk * Dh;
      for (int q0 = 0; q0 < Sq; q0 += BQ) {
        int lo, hi;
        key_range(p, q0, (q0 + BQ < Sq ? q0 + BQ : Sq) - 1, BK, lo, hi);
        for (int qi = q0; qi < q0 + BQ && qi < Sq; ++qi) {
          const float* qr = q + ((long)(b * Hq + h) * Sq + qi) * Dh;
          RowState st = row_init();
          std::vector<float> acc(Dh, 0.0f);
          for (int kt = lo; kt < hi; kt += BK) {
            float s[BK], pw[BK];
            bool lv[BK];
            float tmax = -INFINITY, tsum = 0.0f;
            for (int j = 0; j < BK; ++j) {
              float dot = 0.0f;
              if (kt + j < Sk)
                for (int d = 0; d < Dh; ++d) dot += qr[d] * kg[(long)(kt + j) * Dh + d];
              s[j] = logit(p, dot);
              lv[j] = live(p, qi, kt + j);
              if (lv[j]) tmax = s[j] > tmax ? s[j] : tmax;
            }
            const float alpha = row_rescale(st, tmax);
            for (int j = 0; j < BK; ++j) {
              pw[j] = row_weight(st, s[j], lv[j]);
              tsum += pw[j];
            }
            row_sum(st, alpha, tsum);
            for (int d = 0; d < Dh; ++d) {
              acc[d] *= alpha;
              for (int j = 0; j < BK && kt + j < Sk; ++j)
                acc[d] += pw[j] * vg[(long)(kt + j) * Dh + d];
            }
          }
          float* orow = o + ((long)(b * Hq + h) * Sq + qi) * Dh;
          for (int d = 0; d < Dh; ++d) orow[d] = row_out(st, acc[d]);
        }
      }
    }
}

namespace {
using namespace tdp::attn;

// x rounded to float toward zero, as the tensor core rounds its fp32
// accumulation (it truncates where an FPU rounds to nearest).
float round_toward_zero(double x) {
  const float f = (float)x;
  return std::fabs((double)f) > std::fabs(x) ? std::nextafter(f, 0.0f) : f;
}

// One warp's mma.sync.m16n8k8, emulated: each lane's registers placed by the
// fragment maps, each operand's top 19 bits (what the tensor core reads of
// a TF32 operand), the products summed in double onto the accumulator,
// rounded to float once, toward zero.
void emu_mma(float (&d)[32][4], const uint32_t (&a)[32][4], const uint32_t (&b)[32][2]) {
  double A[16][8], B[8][8];
  for (int l = 0; l < 32; ++l) {
    for (int i = 0; i < 4; ++i) {
      int r, c;
      frag_a(l, i, r, c);
      A[r][c] = bits_float(a[l][i] & 0xffffe000u);
    }
    for (int i = 0; i < 2; ++i) {
      int k, n;
      frag_b(l, i, k, n);
      B[k][n] = bits_float(b[l][i] & 0xffffe000u);
    }
  }
  for (int l = 0; l < 32; ++l)
    for (int i = 0; i < 4; ++i) {
      int r, c;
      frag_c(l, i, r, c);
      double acc = d[l][i];
      for (int k = 0; k < 8; ++k) acc += A[r][k] * B[k][c];
      d[l][i] = round_toward_zero(acc);
    }
}

// The kernel's mma<SPLIT> on a warp's float operands: split as the kernel
// splits them; 3xTF32's small terms first, then hi·hi.
template <int SPLIT>
void emu_mma_split(float (&d)[32][4], const float (&af)[32][4], const float (&bf)[32][2]) {
  uint32_t ah[32][4], al[32][4], bh[32][2], bl[32][2];
  for (int l = 0; l < 32; ++l) {
    for (int i = 0; i < 4; ++i) {
      const Tf32<SPLIT> t = tf32_split<SPLIT>(af[l][i]);
      ah[l][i] = t.hi, al[l][i] = t.lo;
    }
    for (int i = 0; i < 2; ++i) {
      const Tf32<SPLIT> t = tf32_split<SPLIT>(bf[l][i]);
      bh[l][i] = t.hi, bl[l][i] = t.lo;
    }
  }
  if (SPLIT == 3) {
    emu_mma(d, al, bh);
    emu_mma(d, ah, bl);
  }
  emu_mma(d, ah, bh);
}

// The quad reduction of a value per lane and row half: round r, each lane
// combines its own with its xor-partner's value of the round before.
template <class Op>
void quad_reduce(float (&x)[32][2], Op op) {
  for (int r = 0; r < 2; ++r) {
    float y[32][2];
    for (int l = 0; l < 32; ++l)
      for (int h = 0; h < 2; ++h) y[l][h] = op(x[l][h], x[l ^ quad_xor(r)][h]);
    std::copy(&y[0][0], &y[0][0] + 64, &x[0][0]);
  }
}

template <class Store>
struct FlashArgs {
  const Store *q, *k, *v;
  Store* o;
  float* lse;
  long long s[12];
  int B, Hq, Hkv, Sq, Sk;
  Params p;
};

// flash_fwd_kernel<DH, Store> of flash_attention.cu at a TF32 split of
// SPLIT, block by block (query tiles last first, as the grid runs them),
// each phase over all the block's threads or a warp's lanes (shuffles read
// the partner's value of the step before), shared memory filled with NaN.
// A bfloat16 operand's small term is 0 (exact in TF32), so emulating the
// three products of 3xTF32 gives the kernel's skipped-product result.
template <int DH, int SPLIT, class Store>
int flash_host(const FlashArgs<Store>& a) {
  using T = FlashTile<DH>;
  constexpr int NT = FLASH_THREADS;
  std::vector<float> smem(T::V + T::BK * T::SV);
  float* Qs = smem.data();
  float* Ks = Qs + T::K;
  float* Vs = Qs + T::V;
  const int nqt = (a.Sq + FLASH_BQ - 1) / FLASH_BQ;
  static float o[FLASH_WARPS][32][T::NP][T::NT][2][4];
  static RowState st[FLASH_WARPS][32][2];
  static float s[FLASH_WARPS][32][T::NJ][4];
  for (int bh = 0; bh < a.B * a.Hq; ++bh)
    for (int bx = 0; bx < nqt; ++bx) {
      const int b = bh / a.Hq, h = bh % a.Hq, hk = h / (a.Hq / a.Hkv);
      const int q0 = (nqt - 1 - bx) * FLASH_BQ;
      const Store* qg = a.q + b * a.s[0] + h * a.s[1];
      const Store* kg = a.k + b * a.s[3] + hk * a.s[4];
      const Store* vg = a.v + b * a.s[6] + hk * a.s[7];
      Store* og = a.o + b * a.s[9] + h * a.s[10];
      std::fill(smem.begin(), smem.end(), NAN);
      int lo, hi;
      key_range(a.p, q0, std::min(q0 + FLASH_BQ, a.Sq) - 1, T::BK, lo, hi);
      for (int t = 0; t < NT && lo < hi; ++t) {  // no live key: no copy
        stage_rows<DH>(Qs, T::SQK, qg, a.s[2], q0, FLASH_BQ, a.Sq, t, NT);
        stage_rows<DH>(Ks, T::SQK, kg, a.s[5], lo, T::BK, a.Sk, t, NT);
        stage_rows<DH>(Vs, T::SV, vg, a.s[8], lo, T::BK, a.Sk, t, NT);
      }
      for (int w = 0; w < FLASH_WARPS; ++w)
        for (int l = 0; l < 32; ++l) {
          std::fill(&o[w][l][0][0][0][0], &o[w][l][0][0][0][0] + T::NP * T::NT * 8, 0.0f);
          st[w][l][0] = st[w][l][1] = row_init();
        }
      for (int kt = lo; kt < hi; kt += T::BK) {
        const bool more = kt + T::BK < hi;
        for (int w = 0; w < FLASH_WARPS; ++w) {  // S = Q·Kᵀ
          float s2[2][T::NJ][32][4] = {};
          for (int kp = 0; kp < T::NKP; ++kp) {
            float af[32][2][4], bf[32][2][2], a1[32][4], b1[32][2];
            for (int l = 0; l < 32; ++l) load_a_q(Qs, T::SQK, 16 * w, kp, l, af[l]);
            for (int j = 0; j < T::NJ; ++j) {
              for (int l = 0; l < 32; ++l) load_b_k(Ks, T::SQK, j, kp, l, bf[l]);
              for (int hh = 0; hh < 2; ++hh) {
                for (int l = 0; l < 32; ++l) {
                  std::copy(af[l][hh], af[l][hh] + 4, a1[l]);
                  std::copy(bf[l][hh], bf[l][hh] + 2, b1[l]);
                }
                emu_mma_split<SPLIT>(s2[hh][j], a1, b1);
              }
            }
          }
          for (int l = 0; l < 32; ++l)
            for (int j = 0; j < T::NJ; ++j)
              for (int i = 0; i < 4; ++i) s[w][l][j][i] = s2[0][j][l][i] + s2[1][j][l][i];
        }
        if (more)  // every warp is done with K: the next tile's K
          for (int t = 0; t < NT; ++t)
            stage_rows<DH>(Ks, T::SQK, kg, a.s[5], kt + T::BK, T::BK, a.Sk, t, NT);
        for (int w = 0; w < FLASH_WARPS; ++w) {  // the row update
          float mx[32][2], alpha[32][2], sum[32][2];
          for (int l = 0; l < 32; ++l) frag_logits<T::NJ>(a.p, q0 + 16 * w, kt, l, s[w][l], mx[l]);
          quad_reduce(mx, [](float x, float y) { return fmaxf(x, y); });
          for (int l = 0; l < 32; ++l)
            frag_weights<T::NJ>(st[w][l], mx[l], s[w][l], alpha[l], sum[l]);
          quad_reduce(sum, [](float x, float y) { return x + y; });
          for (int l = 0; l < 32; ++l) {
            frag_rows(st[w][l], alpha[l], sum[l]);
            float f[2][2];
            for (int nr = 0; nr < 2; ++nr)
              for (int e = 0; e < 2; ++e) f[nr][e] = alpha[o_src(l, e)][nr];
            frag_rescale<T::NP, T::NT>(o[w][l], f);
          }
        }
        for (int w = 0; w < FLASH_WARPS; ++w)  // Oᵀ += Vᵀ·Pᵀ, a pair at a time
          for (int p = 0; p < T::NP; ++p) {
            // the tile's products in a fresh fragment, then one add into O
            float c[T::NT][2][32][4] = {};
            for (int j = 0; j < T::NJ; ++j) {
              float pb[2][32][2];
              for (int l = 0; l < 32; ++l)
                for (int nr = 0; nr < 2; ++nr)
                  for (int i = 0; i < 2; ++i) pb[nr][l][i] = s[w][l][j][2 * nr + i];
              float vf[32][T::NT][4];
              for (int l = 0; l < 32; ++l) load_a_v<T::W>(Vs, T::SV, j, p, l, vf[l]);
              for (int t = 0; t < T::NT; ++t) {
                float va[32][4];
                for (int l = 0; l < 32; ++l) std::copy(vf[l][t], vf[l][t] + 4, va[l]);
                for (int nr = 0; nr < 2; ++nr) emu_mma_split<SPLIT>(c[t][nr], va, pb[nr]);
              }
            }
            for (int t = 0; t < T::NT; ++t)
              for (int nr = 0; nr < 2; ++nr)
                for (int l = 0; l < 32; ++l)
                  for (int i = 0; i < 4; ++i) o[w][l][p][t][nr][i] += c[t][nr][l][i];
          }
        if (more)  // every warp is done with V: the next tile's V
          for (int t = 0; t < NT; ++t)
            stage_rows<DH>(Vs, T::SV, vg, a.s[8], kt + T::BK, T::BK, a.Sk, t, NT);
      }
      for (int w = 0; w < FLASH_WARPS; ++w)
        for (int l = 0; l < 32; ++l)
          for (int nr = 0; nr < 2; ++nr)
            for (int e = 0; e < 2; ++e) {
              const int qi = q0 + 16 * w + 8 * nr + 2 * (l % 4) + e;
              if (qi < a.Sq)
                store_o_row<T::NP, T::NT, T::W>(og + (long long)qi * a.s[11], l, o[w][l],
                                                nr, e, st[w][o_src(l, e)][nr]);
            }
      for (int w = 0; w < FLASH_WARPS && a.lse; ++w)  // lanes 4·grp: rows grp, grp + 8
        for (int l = 0; l < 32; l += 4)
          for (int nr = 0; nr < 2; ++nr) {
            const int qi = q0 + 16 * w + l / 4 + 8 * nr;
            if (qi < a.Sq) a.lse[(long long)bh * a.Sq + qi] = row_lse(st[w][l][nr]);
          }
    }
  return 0;
}

template <int DH, class Store>
int flash_split(const FlashArgs<Store>& a, int split) {
  return split == 1 ? flash_host<DH, 1>(a) : flash_host<DH, 3>(a);
}

template <class Store>
FlashArgs<Store> flash_args(const void* q, const void* k, const void* v, void* o,
                            float* lse, const long long* strides, int B, int Hq,
                            int Hkv, int Sq, int Sk, float scale, float softcap,
                            int causal, int window) {
  FlashArgs<Store> a{static_cast<const Store*>(q), static_cast<const Store*>(k),
                     static_cast<const Store*>(v), static_cast<Store*>(o), lse, {},
                     B, Hq, Hkv, Sq, Sk, Params{scale, softcap, causal, window, Sk}};
  std::copy(strides, strides + 12, a.s);
  return a;
}
template <class Store>
int flash_head_dim(int Dh, const FlashArgs<Store>& a, int split) {
  switch (Dh) {
    case 16: return flash_split<16>(a, split);
    case 32: return flash_split<32>(a, split);
    case 64: return flash_split<64>(a, split);
    case 80: return flash_split<80>(a, split);
    case 128: return flash_split<128>(a, split);
    case 192: return flash_split<192>(a, split);
    case 256: return flash_split<256>(a, split);
    default: return -3;
  }
}

}  // namespace

// The signature of flash_attention_launch, on host pointers, and the TF32
// split to emulate: 1, or the kernel's 3 (any other value).
extern "C" int host_flash(int dtype, const void* q, const void* k, const void* v, void* o,
                          float* lse, const long long* strides, int B, int Hq, int Hkv, int Sq,
                          int Sk, int Dh, float scale, float softcap, int causal,
                          int window, int split) {
  if (Hkv <= 0 || Hq % Hkv != 0) return -4;
  switch (dtype) {
    case tdp::DTYPE_F32:
      return flash_head_dim(Dh, flash_args<float>(q, k, v, o, lse, strides, B, Hq, Hkv,
                                                  Sq, Sk, scale, softcap, causal, window),
                            split);
    case tdp::DTYPE_BF16:
      return flash_head_dim(Dh, flash_args<tdp::bf16>(q, k, v, o, lse, strides, B, Hq,
                                                      Hkv, Sq, Sk, scale, softcap, causal,
                                                      window),
                            split);
    default: return tdp::ERR_BAD_DTYPE;
  }
}

// Which (row, col) register i of lane l holds in fragment `which` (0 A, 1 B,
// 2 C), and P·V's key order.
extern "C" void host_frag(int which, int lane, int i, int* row, int* col) {
  if (which == 0) frag_a(lane, i, *row, *col);
  else if (which == 1) frag_b(lane, i, *row, *col);
  else frag_c(lane, i, *row, *col);
}

extern "C" int host_qk_dim(int kp, int h, int kslot) { return qk_dim(kp, h, kslot); }
extern "C" int host_pv_key(int kslot) { return pv_key(kslot); }
extern "C" int host_pv_dim(int w, int p, int t, int s) {
  return w == 16 ? pv_dim<16>(p, t, s) : pv_dim<32>(p, t, s);
}
extern "C" int host_o_src(int lane, int e) { return o_src(lane, e); }

extern "C" void host_key_range(int sk, int causal, int window, int q0, int q_last,
                               int bk, int* lo, int* hi) {
  const tdp::attn::Params p{1.0f, 0.0f, causal, window, sk};
  tdp::attn::key_range(p, q0, q_last, bk, *lo, *hi);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the site functions with")
    d = tmp_path_factory.mktemp("lm_csrc_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    lib = d / "libharness.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{_build.CSRC}", "-o",
                    str(lib), str(src)], check=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    so.host_lm.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                           + [ctypes.c_longlong, ctypes.c_int]
                           + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    so.host_lm.restype = ctypes.c_int
    so.host_mamba.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                              + [ctypes.c_longlong] * 2
                              + [ctypes.c_int, ctypes.c_void_p])
    so.host_mamba.restype = ctypes.c_int
    so.host_rmsnorm_aosoa.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                                      + [ctypes.c_longlong, ctypes.c_int]
                                      + [ctypes.c_float] * 2)
    so.host_rmsnorm_aosoa.restype = ctypes.c_int
    so.host_mamba_aosoa.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                                    + [ctypes.c_longlong] * 2 + [ctypes.c_int])
    so.host_mamba_aosoa.restype = ctypes.c_int
    so.host_attention.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                  + [ctypes.c_float] * 2 + [ctypes.c_int] * 2)
    so.host_attention.restype = None
    so.host_key_range.argtypes = ([ctypes.c_int] * 6
                                  + [ctypes.POINTER(ctypes.c_int)] * 2)
    so.host_flash.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                              + [ctypes.c_int] * 6
                              + [ctypes.c_float] * 2 + [ctypes.c_int] * 3)
    so.host_flash.restype = ctypes.c_int
    so.host_frag.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    so.host_frag.restype = None
    return so


def _rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _lm(so, site, act, vvl, x, v, w, out, eps=1e-6, scale_offset=0.0):
    ncomp, n = x.shape
    return so.host_lm(_build.LM_SITE_ID[site], act, vvl,
                      _build.dtype_id(x.dtype), x.data_ptr(),
                      None if v is None else v.data_ptr(),
                      None if w is None else w.data_ptr(), out.data_ptr(), n,
                      ncomp, eps, scale_offset, None)


def _at_offset(t, offset):
    """``t`` copied into a buffer at a storage offset of ``offset``
    elements: a view whose data pointer is only 4-byte aligned."""
    buf = torch.zeros(t.numel() + offset)
    buf[offset:] = t.reshape(-1)
    return buf[offset:].reshape(t.shape)


#: (d, n): both mappings (few tokens below 32, tiled from 32), n ragged for
#: every VVL > 1 and a multiple of 8 (the vector rows), d = 100 not a
#: multiple of the 16 warps, d = 2304 gemma2's width.
RMS_CASES = [(d, n) for d in (64, 100, 2304) for n in (1, 2, 3, 37, 64, 130)]


#: the dense archs' widths: qwen2-vl 1536, phi3 5120, gemma3 5376
DENSE_RMS_CASES = [(d, n) for d in (1536, 5120, 5376) for n in (3, 37)]


@pytest.mark.parametrize("d,n", RMS_CASES + [(2304, 9)] + DENSE_RMS_CASES)
def test_rmsnorm_site_matches_plain(host_lib, d, n):
    x, w = _rand(0, (d, n)), _rand(1, (d,))
    want = tref.rmsnorm_ref(x.T, w, scale_offset=1.0).T
    for vvl in (1, 2, 4, 8):
        # then x and out at a storage offset of one element: scalar rows
        for offset in (0, 1):
            out = _at_offset(torch.full((d, n), float("nan")), offset)
            assert _lm(host_lib, "rmsnorm", 0, vvl, _at_offset(x, offset),
                       None, w, out, scale_offset=1.0) == 0
            torch.testing.assert_close(out, want, **TOL)


@pytest.mark.parametrize("kind", tlm.GATED_KINDS)
@pytest.mark.parametrize("gated", [True, False])
def test_gated_and_act_sites_match_plain(host_lib, kind, gated):
    """Every VVL over: 8·37 + 5 elements (ragged for every VVL > 1, not a
    multiple of 4), several blocks of 16-byte groups with a 3-element tail,
    and n = 1; each with every operand aligned, then with u, v or out at a
    storage offset of one element (the scalar path)."""
    act = _build.LM_ACT_ID[tlm.ACT_OF_KIND[kind]]
    site = "gated" if gated else "act"
    for n in (8 * 37 + 5, 3 * 8192 + 4 * 5 + 3, 1):
        u = _rand(2, (1, n), 3.0)
        v = _rand(3, (1, n)) if gated else None
        want = tref.gated_act_ref(u, v, kind=kind)
        for moved in (None, "u", "v", "out"):
            if moved == "v" and not gated:
                continue
            uu = _at_offset(u, 1) if moved == "u" else u
            vv = _at_offset(v, 1) if moved == "v" else v
            for vvl in (1, 2, 4, 8):
                out = _at_offset(torch.full((1, n), float("nan")),
                                 1 if moved == "out" else 0)
                assert _lm(host_lib, site, act, vvl, uu, vv, None, out) == 0
                torch.testing.assert_close(out, want, **TOL)


@pytest.mark.parametrize("kind,gated,n", [
    ("swiglu", True, 2 * 8960 + 3),      # qwen2-vl's FFN, ragged
    ("swiglu", True, 17920 + 1),         # phi3's
    ("relu2", False, 24576 + 5),         # nemotron's, ungated
    ("geglu", True, 21504 + 7)])         # gemma3's
def test_dense_arch_mlp_widths(host_lib, kind, gated, n):
    """The dense archs' MLP activations at their FFN widths plus a ragged
    tail, every VVL, aligned and with ``out`` at a storage offset of one
    element."""
    act = _build.LM_ACT_ID[tlm.ACT_OF_KIND[kind]]
    u = _rand(20, (1, n), 3.0)
    v = _rand(21, (1, n)) if gated else None
    want = tref.gated_act_ref(u, v, kind=kind)
    for offset in (0, 1):
        for vvl in (1, 2, 4, 8):
            out = _at_offset(torch.full((1, n), float("nan")), offset)
            assert _lm(host_lib, "gated" if gated else "act", act, vvl, u, v,
                       None, out) == 0
            torch.testing.assert_close(out, want, **TOL)


def _mamba(so, nstate, vvl, fields, b, c, y, h, rows=1, dtype=None):
    """``host_mamba`` on torch tensors; ``dtype`` a storage name to pass
    in place of x's code (an unknown one: its error)."""
    x, dt, a, d = fields
    length, n = x.shape[0] // rows, x.shape[1]
    code = (_build.DTYPE_ID.get(dtype, 7) if dtype is not None
            else _build.dtype_id(x.dtype))
    return so.host_mamba(nstate, vvl, code,
                         *[t.data_ptr() for t in (x, dt, a, d, b, c, y, h)],
                         length, n, rows, None)


@pytest.mark.parametrize("nstate", _build.MAMBA_NSTATES)
def test_mamba_site_matches_plain(host_lib, nstate):
    """``MambaSite<N>`` on the host at every VVL, 8·37 + 5 channels (ragged
    for every VVL > 1) over 50 steps, against the plain body with the
    reference test's inputs: dt = softplus(·), a = −exp(·)."""
    length, n = 50, 8 * 37 + 5
    x = _rand(7, (length, n))
    dt = torch.nn.functional.softplus(_rand(8, (length, n)))
    a = -torch.exp(_rand(9, (nstate, n)))
    d = _rand(10, (1, n))
    b, c = _rand(11, (length, nstate)), _rand(12, (length, nstate))
    want_y, want_h = tlm.mamba_scan_spec(length, nstate).fn(x, dt, a, d, b=b,
                                                             c=c)
    for vvl in (1, 2, 4, 8):
        y = torch.full((length, n), float("nan"))
        h = torch.full((nstate, n), float("nan"))
        assert _mamba(host_lib, nstate, vvl, (x, dt, a, d), b, c, y, h) == 0
        torch.testing.assert_close(y, want_y, **TOL)
        torch.testing.assert_close(h, want_h, **TOL)


def test_bad_mamba_nstate_and_vvl_codes(host_lib):
    f = [torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(4, 8),
         torch.zeros(1, 8)]
    bc = torch.zeros(4, 4)
    out = [torch.zeros(4, 8), torch.zeros(4, 8)]
    assert _mamba(host_lib, 4, 1, f, bc, bc, *out) == -5
    f[2] = torch.zeros(8, 8)
    bc = torch.zeros(4, 8)
    out[1] = torch.zeros(8, 8)
    assert _mamba(host_lib, 8, 3, f, bc, bc, *out) == -2
    assert _mamba(host_lib, 8, 2, f, bc, bc, *out) == 0


def test_bad_lm_site_act_and_vvl_codes(host_lib):
    x = torch.zeros(1, 8)
    assert _lm(host_lib, "gated", 7, 1, x, x, None, x) == -1
    assert _lm(host_lib, "rmsnorm", 0, 3, x, None, torch.zeros(1), x) == -2
    assert host_lib.host_lm(9, 0, 1, 0, x.data_ptr(), None, None, x.data_ptr(),
                            8, 1, 0.0, 0.0, None) == -1


_ATTN = {
    "gqa_causal": ((2, 4, 2, 70, 70, 32), dict(causal=True)),
    "mqa_window_softcap": ((1, 4, 1, 100, 100, 16), dict(causal=True, window=40,
                                                         softcap=5.0)),
    "noncausal": ((1, 2, 2, 45, 45, 32), dict(causal=False)),
    "masked_rows": ((1, 2, 2, 40, 20, 16), dict(causal=False, window=5)),
    "scale": ((1, 2, 1, 33, 33, 64), dict(causal=True, scale=0.07)),
}


@pytest.mark.parametrize("case", sorted(_ATTN))
def test_attention_row_update_matches_plain(host_lib, case):
    (b, hq, hkv, sq, sk, dh), kw = _ATTN[case]
    q, k, v = _rand(4, (b, hq, sq, dh)), _rand(5, (b, hkv, sk, dh)), _rand(
        6, (b, hkv, sk, dh))
    scale = kw.get("scale", dh ** -0.5)
    o = torch.full_like(q, float("nan"))
    host_lib.host_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), b, hq, hkv, sq, sk, dh, scale,
                            kw.get("softcap", 0.0), int(kw["causal"]),
                            kw.get("window", 0))
    want = tref.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(o, want, **TOL)


def test_key_range_skips_only_dead_tiles(host_lib):
    """Every live key of the query rows lies in [lo, hi); the tiles before
    lo and from hi on hold none; lo is tile-aligned."""
    lo, hi = ctypes.c_int(), ctypes.c_int()
    for sk, causal, window, q0 in [(4608, 1, 4096, 4576), (4608, 1, 0, 64),
                                   (100, 0, 5, 32), (20, 0, 5, 32),
                                   (1000, 1, 100, 960)]:
        q_last = min(q0 + 32, 4608) - 1
        host_lib.host_key_range(sk, causal, window, q0, q_last, 32,
                                ctypes.byref(lo), ctypes.byref(hi))
        ks = np.arange(sk)
        live = np.zeros(sk, bool)
        for q in range(q0, q_last + 1):
            m = np.ones(sk, bool)
            if causal:
                m &= ks <= q
            if window:
                m &= ks > q - window
            live |= m
        assert lo.value % 32 == 0
        assert not live[:lo.value].any() and not live[max(hi.value, 0):].any()
        if live.any():
            first = int(np.argmax(live))
            assert lo.value > first - 32


def test_error_codes_match_the_sources():
    """The C entries' error codes are the ones ``_build.check`` names."""
    lb = (_build.CSRC / "lb_sites.cuh").read_text()
    lm = (_build.CSRC / "lm_sites.cuh").read_text()
    fa = (_build.CSRC / "flash_attention.cu").read_text()
    assert "ERR_BAD_SITE = -1" in lb and "ERR_BAD_VVL = -2" in lb
    assert "ERR_BAD_NSTATE = -5" in lm
    assert re.findall(r"case (\d+): return tdp::dispatch_vvl<Launch, "
                      r"MambaSite<", lm) == [str(n) for n in _build.MAMBA_NSTATES]
    assert "ERR_BAD_HEAD_DIM = -3" in fa and "ERR_BAD_GROUP = -4" in fa
    assert re.findall(r"SITE_(\w+) = (\d+)", lm) == [
        (s.upper(), str(i)) for s, i in _build.LM_SITE_ID.items()]
    assert re.findall(r"ACT_(\w+) = (\d+)", lm) == [
        (a.upper(), str(i)) for a, i in _build.LM_ACT_ID.items()]
    heads = re.findall(r"case (\d+): return launch<", fa)
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    assert tuple(int(h) for h in heads) == HEAD_DIMS
    for code in (-3, -4, -5):
        with pytest.raises(ValueError):
            _build.check(code, "x")


@pytest.mark.parametrize("nstate", _build.MAMBA_NSTATES)
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("n", [300, 301])
def test_mamba_launch_rows_and_copy_paths(host_lib, nstate, rows, n):
    """The launch over ``rows`` batch rows at every VVL against the plain
    body of ``mamba_scan_spec(L, N, rows)``: L = 45 leaves a ragged last
    chunk at every VVL (chunks of 32, 16, 8, 4 steps), both n leave a
    ragged last block; n = 300 stages x and dt by 16-byte copies, n = 301
    (not a multiple of 4) by 4-byte ones."""
    length = 45
    x = _rand(20, (rows * length, n))
    dt = torch.nn.functional.softplus(_rand(21, (rows * length, n)))
    a = -torch.exp(_rand(22, (nstate, n)))
    d = _rand(23, (1, n))
    b, c = _rand(24, (rows * length, nstate)), _rand(25, (rows * length, nstate))
    want_y, want_h = tlm.mamba_scan_spec(length, nstate, rows).fn(
        x, dt, a, d, b=b, c=c)
    for vvl in (1, 2, 4, 8):
        y = torch.full((rows * length, n), float("nan"))
        h = torch.full((rows * nstate, n), float("nan"))
        assert _mamba(host_lib, nstate, vvl, (x, dt, a, d), b, c, y, h,
                      rows=rows) == 0
        torch.testing.assert_close(y, want_y, **TOL)
        torch.testing.assert_close(h, want_h, **TOL)


@pytest.mark.parametrize("nstate", _build.MAMBA_NSTATES)
def test_mamba_y_sums_lane_shares_in_shuffle_order(host_lib, nstate):
    """y, bit for bit, in the kernel's order: lane g of a group sums h·c over
    its states g·N/4 ... in state order, then the shares meet by xor 1, then
    xor 2: (p0 + p1) + (p2 + p3).  With a = 0, dt = x = c = 1 and d = 0
    every step is exact but for those sums, h_t = h_{t-1} + b_t, and b's
    magnitudes (1e-4 to 1e8) make any other order or lane split round
    differently."""
    length, n = 40, 70
    rng = np.random.default_rng(30)
    b = (rng.standard_normal((length, nstate))
         * 10.0 ** rng.uniform(-4, 8, (length, nstate))).astype(np.float32)
    h = np.cumsum(b, axis=0, dtype=np.float32)        # sequential, float32
    s = nstate // 4
    shares = []
    for g in range(4):
        p = np.zeros(length, np.float32)
        for k in range(g * s, (g + 1) * s):
            p = (p + h[:, k]).astype(np.float32)
        shares.append(p)
    want = (shares[0] + shares[1]) + (shares[2] + shares[3])
    ones = torch.ones(length, n)
    fields = (ones, ones, torch.zeros(nstate, n), torch.zeros(1, n))
    for vvl in (1, 2, 4, 8):
        y = torch.full((length, n), float("nan"))
        hh = torch.full((nstate, n), float("nan"))
        assert _mamba(host_lib, nstate, vvl, fields, torch.from_numpy(b),
                      torch.ones(length, nstate), y, hh) == 0
        assert torch.equal(y, torch.from_numpy(want)[:, None].expand(length, n))
        assert torch.equal(hh, torch.from_numpy(h[-1])[:, None].expand(nstate, n))


def _flash(so, q, k, v, o, split, causal=True, window=0, softcap=0.0,
           scale=None, lse=None):
    """``host_flash`` on torch tensors of any row-contiguous layout; ``lse``
    a contiguous (B, Hq, Sq) tensor, or None (no store)."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*[x.stride(i) for x in (q, k, v, o)
                                         for i in range(3)])
    return so.host_flash(_build.dtype_id(q.dtype), q.data_ptr(), k.data_ptr(),
                         v.data_ptr(),
                         o.data_ptr(), None if lse is None else lse.data_ptr(),
                         strides, b, hq, hkv, sq, sk, dh,
                         dh ** -0.5 if scale is None else scale, softcap,
                         int(causal), window, split)


#: The tensor-core tile's cases: every head dim (tiles of 64 keys below Dh
#: 128, 32 from it), Sq and Sk not multiples of the 128 query rows or the key
#: tile, GQA and MQA, softcap, windows, a custom scale and rows with no live
#: key, and a whole query tile with none.
_FLASH = {
    "gqa_causal_dh32": ((2, 4, 2, 70, 70, 32), dict(causal=True)),
    "mqa_window_softcap_dh16": ((1, 4, 1, 100, 100, 16),
                                dict(causal=True, window=40, softcap=5.0)),
    "noncausal_ragged_dh64": ((1, 2, 2, 45, 77, 64), dict(causal=False)),
    "masked_rows_dh16": ((1, 2, 2, 40, 20, 16), dict(causal=False, window=5)),
    # query rows 128.. (the second tile) see no key: k > q - 30 >= 98, k < 40
    "dead_query_tile_dh32": ((1, 2, 2, 200, 40, 32),
                             dict(causal=False, window=30)),
    "scale_dh64": ((1, 2, 1, 130, 130, 64), dict(causal=True, scale=0.07)),
    "window_softcap_dh128": ((1, 2, 1, 100, 100, 128),
                             dict(causal=True, window=33, softcap=50.0)),
    "gqa_dh256": ((1, 4, 2, 70, 70, 256), dict(causal=True, softcap=50.0)),
    # the dense archs' head mapping and masks at Dh 128 with no softcap:
    # GQA group 6 (qwen2-vl 12/2, nemotron 48/8) over ragged query and key
    # tiles, and a window far narrower than the keys (gemma3's local
    # layers: most key tiles of a row dead)
    "gqa6_causal_dh128": ((1, 12, 2, 140, 140, 128), dict(causal=True)),
    "gqa6_noncausal_dh128": ((1, 6, 1, 70, 45, 128), dict(causal=False)),
    "narrow_window_dh128": ((1, 4, 2, 200, 200, 128),
                            dict(causal=True, window=40)),
    # zamba2's shared block at Dh 80 (V pairs of 16 dimensions): Hq = Hkv
    # over ragged query and key tiles, and a window with a softcap
    "causal_ragged_dh80": ((1, 3, 3, 150, 150, 80), dict(causal=True)),
    "noncausal_ragged_dh80": ((1, 2, 2, 77, 140, 80), dict(causal=False)),
    "window_softcap_dh80": ((1, 4, 2, 130, 130, 80),
                            dict(causal=True, window=37, softcap=30.0)),
    # deepseek-v3's MLA at Dh 192 (six V pairs of 32, 158 208 B of shared
    # memory): Hq = Hkv over ragged query and key tiles, and V zero-padded
    # from 128 to 192 dimensions as the model hands it (the padded
    # dimensions of O exactly 0)
    "causal_ragged_dh192": ((1, 2, 2, 150, 150, 192), dict(causal=True)),
    "noncausal_ragged_dh192": ((1, 2, 2, 77, 140, 192), dict(causal=False)),
    "v_padded_dh192": ((1, 2, 2, 140, 140, 192),
                       dict(causal=True, scale=192 ** -0.5)),
    # whisper-medium's shapes at Dh 64 (64-key tiles), scaled down in the
    # heads: non-causal, Sq ≠ Sk, the keys 1500 or ≡ 1500 mod 64 (a tail
    # of 28 keys), the queries 1500 (a last tile of 92 rows) or 92 (the
    # decoder's prompt against the encoder's frames: one partial tile)
    "whisper_frames_dh64": ((1, 2, 2, 1500, 348, 64), dict(causal=False)),
    "whisper_cross_dh64": ((2, 2, 2, 92, 1500, 64), dict(causal=False)),
}
#: the cases whose V carries data in its first ``V_PADDED`` dimensions only
V_PADDED = {"v_padded_dh192": 128}


def _flash_inputs(case, seeds):
    """q, k, v of a ``_FLASH`` case from ``seeds``; V zero past its first
    ``V_PADDED[case]`` dimensions where the case pads it."""
    (b, hq, hkv, sq, sk, dh), _ = _FLASH[case]
    q, k, v = (_rand(seeds[0], (b, hq, sq, dh)), _rand(seeds[1], (b, hkv, sk, dh)),
               _rand(seeds[2], (b, hkv, sk, dh)))
    if case in V_PADDED:
        v[..., V_PADDED[case]:] = 0.0
    return q, k, v


#: |signed drift| of the tile's output toward zero against float64 over
#: 1500 keys, relative to Σ|o|: a few roundings of the last tile's chain;
#: chaining P·V into O over every tile drifts 10× that and more
DRIFT_BAR = 3e-6


@pytest.mark.parametrize("case", sorted(_FLASH))
def test_flash_tile_matches_plain(host_lib, case):
    """The kernel's tile, 3xTF32 (its default), run lane by lane through the
    emulated mma against ``attention_ref`` at the reference's bar."""
    from repro_torch.kernels.flash_attention import TF32_SPLIT
    _, kw = _FLASH[case]
    q, k, v = _flash_inputs(case, (40, 41, 42))
    o = torch.full_like(q, float("nan"))
    assert _flash(host_lib, q, k, v, o, TF32_SPLIT, **kw) == 0
    torch.testing.assert_close(o, tref.attention_ref(q, k, v, **kw), **TOL)
    if case in V_PADDED:
        assert torch.equal(o[..., V_PADDED[case]:],
                           torch.zeros_like(o[..., V_PADDED[case]:]))


@pytest.mark.parametrize("case", sorted(_FLASH))
def test_flash_tile_lse_matches_plain(host_lib, case):
    """The kernel's log-sum-exp store: every row's m + log(l) against the
    plain ``logsumexp`` of its live logits, -1e30 for a row with no live
    key; the output is the one without the store, bit for bit."""
    from repro_torch.kernels.flash_attention import TF32_SPLIT
    (b, hq, _, sq, _, _), kw = _FLASH[case]
    q, k, v = _flash_inputs(case, (40, 41, 42))
    o, o2 = (torch.full_like(q, float("nan")) for _ in range(2))
    lse = torch.full((b, hq, sq), float("nan"))
    assert _flash(host_lib, q, k, v, o, TF32_SPLIT, lse=lse, **kw) == 0
    assert _flash(host_lib, q, k, v, o2, TF32_SPLIT, **kw) == 0
    assert torch.equal(o, o2)
    _, want = tref.attention_ref(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, want, **TOL)


def test_flash_tile_does_not_drift_over_long_keys(host_lib):
    """Over 1500 keys (whisper's frames: 24 key tiles, 562 mma a row of
    P·V) the tile's output does not drift toward zero against attention
    in float64, though the emulated tensor core rounds every accumulation
    toward zero as the card's does: each key tile's P·V sums in a fresh
    fragment (24 mma a chain) and O takes it by a rounded add.  Chained
    into O over every tile, the drift was 1.0e-5 on the card (PERF.md
    §6)."""
    from repro_torch.kernels.flash_attention import TF32_SPLIT
    b, h, sq, sk, dh = 1, 2, 128, 1500, 64
    q, k, v = (_rand(60, (b, h, sq, dh)), _rand(61, (b, h, sk, dh)),
               _rand(62, (b, h, sk, dh)))
    o = torch.full_like(q, float("nan"))
    assert _flash(host_lib, q, k, v, o, TF32_SPLIT, causal=False) == 0
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * dh ** -0.5
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.double())
    drift = float(((o.double() - want) * want.sign()).sum()
                  / want.abs().sum())
    assert abs(drift) < DRIFT_BAR, drift


def test_flash_tile_takes_transposed_views(host_lib):
    """q, k, v as (B, H, S, Dh) views of (B, S, H, Dh) tensors, o in q's
    layout: the strides the model hands the kernel."""
    b, hq, hkv, s, dh = 2, 4, 2, 70, 32
    q = _rand(43, (b, s, hq, dh)).transpose(1, 2)
    k = _rand(44, (b, s, hkv, dh)).transpose(1, 2)
    v = _rand(45, (b, s, hkv, dh)).transpose(1, 2)
    o = torch.full((b, s, hq, dh), float("nan")).transpose(1, 2)
    assert _flash(host_lib, q, k, v, o, 3, causal=True, softcap=30.0) == 0
    torch.testing.assert_close(o, tref.attention_ref(q, k, v, causal=True,
                                                     softcap=30.0), **TOL)


#: One TF32 product keeps 10 mantissa bits (2^-11 ≈ 4.9e-4 relative per
#: operand), so the single-product tile is held at a TF32 tolerance.
TF32_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("case", ["gqa_causal_dh32", "window_softcap_dh128",
                                  "gqa_dh256"])
def test_flash_tile_single_tf32(host_lib, case):
    """One TF32 product (SPLIT 1) at the TF32 tolerance, and 3xTF32 closer
    to the plain version than it on the same inputs."""
    (b, hq, hkv, sq, sk, dh), kw = _FLASH[case]
    q, k, v = (_rand(46, (b, hq, sq, dh)), _rand(47, (b, hkv, sk, dh)),
               _rand(48, (b, hkv, sk, dh)))
    want = tref.attention_ref(q, k, v, **kw)
    err = {}
    for split in (1, 3):
        o = torch.full_like(q, float("nan"))
        assert _flash(host_lib, q, k, v, o, split, **kw) == 0
        torch.testing.assert_close(o, want, **(TF32_TOL if split == 1 else TOL))
        err[split] = float((o - want).abs().max())
    assert err[3] < err[1] / 10


def test_flash_fragment_maps(host_lib):
    """Each fragment map puts the 32 lanes' registers on every element of
    its tile once; the data each register stands for is the element the
    kernel's 16-byte loads give it: Q and K at dimension 16·kp + 4·tig +
    2·h + c for k slot tig + 4·c of step h, Vᵀ's A register i at key 2·tig
    + (i >> 1) and dimension W·p + (W/8)·grp + 2·t + (i & 1); Pᵀ's B
    register i of rows 8·nr .. is S's C register 2·nr + i (same row, same
    key); o_src names a lane holding the Oᵀ row's softmax row."""
    r, c = ctypes.c_int(), ctypes.c_int()

    def frag(which, lane, i):
        host_lib.host_frag(which, lane, i, ctypes.byref(r), ctypes.byref(c))
        return r.value, c.value

    for which, (rows, cols, regs) in enumerate([(16, 8, 4), (8, 8, 2),
                                                (16, 8, 4)]):
        seen = {frag(which, lane, i) for lane in range(32) for i in range(regs)}
        assert len(seen) == rows * cols
        assert all(0 <= a < rows and 0 <= b < cols for a, b in seen)
    for kp in range(3):
        assert sorted(host_lib.host_qk_dim(kp, h, k) for h in (0, 1)
                      for k in range(8)) == list(range(16 * kp, 16 * kp + 16))
    assert sorted(host_lib.host_pv_key(k) for k in range(8)) == list(range(8))
    for w in (16, 32):
        assert sorted(host_lib.host_pv_dim(w, 1, t, s) for t in range(w // 16)
                      for s in range(16)) == list(range(w, 2 * w))
    for lane in range(32):
        grp, tig = divmod(lane, 4)
        for i in range(4):                      # Q's A: row, then dimension
            row, kslot = frag(0, lane, i)
            assert row == grp + 8 * (i & 1)
            for h in (0, 1):
                assert host_lib.host_qk_dim(2, h, kslot) == 32 + 4 * tig + 2 * h + (i >> 1)
        for i in range(2):                      # K's B
            kslot, n = frag(1, lane, i)
            assert n == grp
            for h in (0, 1):
                assert host_lib.host_qk_dim(2, h, kslot) == 32 + 4 * tig + 2 * h + i
        for w in (16, 32):                      # Vᵀ's A
            for t in range(w // 16):
                for i in range(4):
                    mslot, kslot = frag(0, lane, i)
                    assert host_lib.host_pv_key(kslot) == 2 * tig + (i >> 1)
                    assert host_lib.host_pv_dim(w, 1, t, mslot) == (
                        w + (w // 8) * grp + 2 * t + (i & 1))
        for nr in (0, 1):                       # Pᵀ's B is S's C
            for i in range(2):
                kslot, n = frag(1, lane, i)
                row, col = frag(2, lane, 2 * nr + i)
                assert (n + 8 * nr, host_lib.host_pv_key(kslot)) == (row, col)
        for e in (0, 1):                        # Oᵀ's rows
            assert host_lib.host_o_src(lane, e) // 4 == 2 * tig + e


def test_flash_row_strides():
    """The strides the kernel takes: (batch, head, row) in floats, rows
    contiguous and 16-byte aligned, an extent-1 dimension's stride 0; any
    other layout raises ``ValueError`` before a launch."""
    from repro_torch.kernels.flash_attention import row_strides
    cpu = torch.device("cpu")
    q = torch.zeros(2, 3, 5, 16)
    assert row_strides("q", q, cpu) == [240, 80, 16]
    view = torch.zeros(2, 5, 3, 16).transpose(1, 2)       # (B, S, H, Dh) seen
    assert row_strides("q", view, cpu) == [240, 16, 48]   # as (B, H, S, Dh)
    assert row_strides("q", torch.zeros(1, 1, 5, 16), cpu) == [0, 0, 16]
    bad = [torch.zeros(2, 3, 16, 5).transpose(2, 3),      # rows not contiguous
           torch.zeros(2, 3, 5, 18)[..., :16],           # rows 18 floats apart
           _at_offset(torch.zeros(2, 3, 5, 16), 1),       # 4-byte aligned
           torch.zeros(2, 3, 5, 16, dtype=torch.float64)]
    for x in bad:
        with pytest.raises(ValueError, match="16-byte aligned"):
            row_strides("q", x, cpu)


# ---------------------------------------------------------------------------
# the AoSoA layout (lm_sites.cuh: rms_aosoa_*, mamba_* with AOSOA)
# ---------------------------------------------------------------------------

def _blocks(x, W):
    """``x`` in AoSoA blocks of ``W`` sites, the pad lanes NaN."""
    n = x.shape[-1]
    y = soa_to_aosoa(x, W)
    y.reshape(-1)[aosoa_offsets(torch.arange(n, y.shape[0] * W),
                                x.shape[0], W)] = float("nan")
    return y


def _nan_blocks(ncomp, n, W, dtype=torch.float32):
    return torch.full((-(-n // W), ncomp, W), float("nan"), dtype=dtype)


def _pads_untouched(o, n):
    nblk, ncomp, W = o.shape
    pad = torch.arange(n, nblk * W)
    return bool(o.reshape(-1)[aosoa_offsets(pad, ncomp, W)].isnan().all())


@pytest.mark.parametrize("d,n", [(64, 1), (64, 37), (100, 130), (2304, 64)])
def test_rmsnorm_aosoa_matches_plain(host_lib, d, n):
    """Over AoSoA blocks of any width (W above the 512 threads of a block
    splits it), pad lanes NaN in and untouched out; at W = 32 bit-equal to
    the tiled SoA kernel at VVL 1, whose sums it repeats."""
    x, w = _rand(40, (d, n)), _rand(41, (d,))
    want = tref.rmsnorm_ref(x.T, w, scale_offset=1.0).T
    soa = torch.full((d, n), float("nan"))
    assert _lm(host_lib, "rmsnorm", 0, 1, x, None, w, soa,
               scale_offset=1.0) == 0
    for W in (1, 7, 32, 96, 600):
        xb, out = _blocks(x, W), _nan_blocks(d, n, W)
        assert host_lib.host_rmsnorm_aosoa(W, 0, xb.data_ptr(), w.data_ptr(),
                                           out.data_ptr(), n, d, 1e-6,
                                           1.0) == 0
        got = aosoa_to_soa(out, n)
        torch.testing.assert_close(got, want, **TOL)
        assert _pads_untouched(out, n), W
        if W == 32 and n >= 32:
            assert torch.equal(got, soa)


@pytest.mark.parametrize("gated", [True, False])
def test_gated_act_over_aosoa_blocks(host_lib, gated):
    """Under AoSoA ``gated``/``act`` are the elementwise kernel over the
    padded blocks: bit-equal to the SoA launch on the live lanes."""
    n, W = 8 * 37 + 5, 96
    u, v = _rand(42, (1, n), 3.0), _rand(43, (1, n)) if gated else None
    site = "gated" if gated else "act"
    soa = torch.full((1, n), float("nan"))
    assert _lm(host_lib, site, 1, 1, u, v, None, soa) == 0
    ub = soa_to_aosoa(u, W).reshape(1, -1)
    vb = None if v is None else soa_to_aosoa(v, W).reshape(1, -1)
    out = torch.full_like(ub, float("nan"))
    assert _lm(host_lib, site, 1, 1, ub, vb, None, out) == 0
    assert torch.equal(aosoa_to_soa(out.reshape(-1, 1, W), n), soa)


@pytest.mark.parametrize("nstate", _build.MAMBA_NSTATES)
@pytest.mark.parametrize("rows", [1, 3])
def test_mamba_aosoa_matches_plain(host_lib, nstate, rows):
    """The AoSoA scan (lane groups of ``MAMBA_AOSOA_VVL`` channels) over
    blocks of W = 4, 16, 64 channels, 301 channels (a ragged last block),
    45 steps a row (a ragged last chunk); pad lanes NaN in and untouched
    out.  Held to the plain body, and bit-equal to the SoA scan at the same
    VVL: only the addresses differ."""
    length, n = 45, 301
    x = _rand(44, (rows * length, n))
    dt = torch.nn.functional.softplus(_rand(45, (rows * length, n)))
    a = -torch.exp(_rand(46, (nstate, n)))
    d = _rand(47, (1, n))
    b, c = _rand(48, (rows * length, nstate)), _rand(49, (rows * length, nstate))
    want_y, want_h = tlm.mamba_scan_spec(length, nstate, rows).fn(
        x, dt, a, d, b=b, c=c)
    y0 = torch.full((rows * length, n), float("nan"))
    h0 = torch.full((rows * nstate, n), float("nan"))
    assert _mamba(host_lib, nstate, tpw.MAMBA_AOSOA_VVL, (x, dt, a, d), b, c,
                  y0, h0, rows=rows) == 0
    for W in (4, 16, 64):
        ops = [_blocks(t, W) for t in (x, dt, a, d)]
        y, h = _nan_blocks(rows * length, n, W), _nan_blocks(rows * nstate, n, W)
        assert host_lib.host_mamba_aosoa(
            nstate, W, 0, *[t.data_ptr() for t in (*ops, b, c, y, h)], length,
            n, rows) == 0
        assert _pads_untouched(y, n) and _pads_untouched(h, n), W
        ys, hs = aosoa_to_soa(y, n), aosoa_to_soa(h, n)
        torch.testing.assert_close(ys, want_y, **TOL)
        torch.testing.assert_close(hs, want_h, **TOL)
        assert torch.equal(ys, y0) and torch.equal(hs, h0), W


def test_aosoa_lm_codes(host_lib):
    x = torch.zeros(64)
    assert host_lib.host_rmsnorm_aosoa(0, 0, x.data_ptr(), x.data_ptr(),
                                       x.data_ptr(), 4, 4, 1e-6, 0.0) == -2
    ptrs = [x.data_ptr()] * 8
    for W in (0, 6):
        assert host_lib.host_mamba_aosoa(8, W, 0, *ptrs, 1, 4, 1) == -2
    assert host_lib.host_mamba_aosoa(4, 8, 0, *ptrs, 1, 4, 1) == -5
    text = (_build.CSRC / "lm_sites.cuh").read_text()
    assert (f"constexpr int MAMBA_AOSOA_ALIGN = {tpw.MAMBA_AOSOA_ALIGN};"
            in text)
    assert f"constexpr int MAMBA_AOSOA_VVL = {tpw.MAMBA_AOSOA_VVL};" in text


# ---------------------------------------------------------------------------
# bfloat16 storage (bf16.cuh; rmsnorm, gated, act and the attention tile)
# ---------------------------------------------------------------------------

#: below this, outputs are held absolutely: float32's own error where a
#: result cancels (gelu's tail, 0.5·u·(1 + tanh(·)) at u ≪ 0) is ~1e-7·|u|
BF16_ATOL = 1e-5


def assert_within_bf16_step(got, want):
    """``got`` within one bfloat16 step of ``want`` (both bfloat16), or
    :data:`BF16_ATOL`: the kernel and the plain version round float32
    results that differ in their last bits, so a result near a rounding
    boundary may land one step (2^-8 relative, the spacing at ``want``)
    apart, never more."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    exp = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    bar = torch.exp2(exp - 7).clamp_min(BF16_ATOL)
    diff = (g - w).abs()
    assert bool((diff <= bar).all()), float((diff / bar).max())


def _bf16(seed, shape, scale=1.0):
    return _rand(seed, shape, scale).to(torch.bfloat16)


def _at_offset_like(t, offset):
    """:func:`_at_offset` in ``t``'s dtype."""
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype)
    buf[offset:] = t.reshape(-1)
    return buf[offset:].reshape(t.shape)


@pytest.mark.parametrize("d,n", [(64, 1), (100, 3), (2304, 2), (2304, 37),
                                 (2304, 130), (5376, 37)])
def test_rmsnorm_site_bf16(host_lib, d, n):
    """bfloat16 x and weight through both mappings (few tokens below 32,
    tiled from 32) at every VVL, aligned and at a storage offset of one
    element (the scalar rows), against the plain bfloat16 version: within
    one bfloat16 step of its output (the sum of squares runs in another
    order, then both round once)."""
    x, w = _bf16(0, (d, n), 2.0), _bf16(1, (d,), 0.5)
    want = tref.rmsnorm_ref(x.T, w, scale_offset=1.0).T
    for vvl in (1, 2, 4, 8):
        for offset in (0, 1):
            out = _at_offset_like(torch.full((d, n), float("nan"),
                                             dtype=torch.bfloat16), offset)
            assert _lm(host_lib, "rmsnorm", 0, vvl, _at_offset_like(x, offset),
                       None, w, out, scale_offset=1.0) == 0
            assert_within_bf16_step(out, want)


def test_rmsnorm_bf16_adds_offset_to_the_float_weight(host_lib):
    """The weight enters as float32 before ``scale_offset`` is added, as the
    reference's body does, never as a bfloat16-rounded ``1 + w``.  With
    small weights (~2^-9) the two round to other bfloat16 outputs at many
    elements; the kernel's output is the first's wherever they part (but
    for the rare last-bit ties of its own sum order), in both mappings."""
    d, n = 256, 40
    x = _bf16(5, (d, n))
    w = (_rand(6, (d,)) * 2.0 ** -9).to(torch.bfloat16)
    want = tref.rmsnorm_ref(x.T, w, scale_offset=1.0).T
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(0, keepdim=True) + 1e-6)
    rounded = (xf * inv * (w.float() + 1.0).to(torch.bfloat16).float()[:, None]
               ).to(torch.bfloat16)
    parted = want != rounded
    assert int(parted.sum()) > 100
    for n_ in (3, n):                     # few-token and tiled
        out = torch.full((d, n_), float("nan"), dtype=torch.bfloat16)
        assert _lm(host_lib, "rmsnorm", 0, 1, x[:, :n_].contiguous(), None, w,
                   out, scale_offset=1.0) == 0
        p = parted[:, :n_]
        assert int((out[p] != want[:, :n_][p]).sum()) <= int(p.sum()) // 20


@pytest.mark.parametrize("kind", tlm.GATED_KINDS)
@pytest.mark.parametrize("gated", [True, False])
def test_gated_and_act_sites_bf16(host_lib, kind, gated):
    """Every activation in bfloat16 at every VVL over a ragged extent and
    several blocks, aligned (8-byte groups of 4) and with each operand at a
    storage offset of one element (scalars): within one bfloat16 step of
    the plain bfloat16 version."""
    act = _build.LM_ACT_ID[tlm.ACT_OF_KIND[kind]]
    site = "gated" if gated else "act"
    for n in (8 * 37 + 5, 3 * 8192 + 4 * 5 + 3):
        u = _bf16(2, (1, n), 3.0)
        v = _bf16(3, (1, n)) if gated else None
        want = tref.gated_act_ref(u, v, kind=kind)
        for moved in (None, "u", "v", "out"):
            if moved == "v" and not gated:
                continue
            uu = _at_offset_like(u, 1) if moved == "u" else u
            vv = _at_offset_like(v, 1) if moved == "v" else v
            for vvl in (1, 2, 4, 8):
                out = _at_offset_like(torch.full((1, n), float("nan"),
                                                 dtype=torch.bfloat16),
                                      1 if moved == "out" else 0)
                assert _lm(host_lib, site, act, vvl, uu, vv, None, out) == 0
                assert_within_bf16_step(out, want)


def test_bad_dtype_codes(host_lib):
    """A storage code outside ``_build.DTYPES`` is ``ERR_BAD_DTYPE`` (-10)
    at the three entries that take one, and bfloat16 attention at a head
    dim outside ``HEAD_DIMS`` (48) is ``ERR_BAD_HEAD_DIM``: the bfloat16
    launch dispatches on the float32 launch's head dims; the codes are the
    sources'."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    x = torch.zeros(1, 8)
    assert host_lib.host_lm(1, 0, 1, 2, x.data_ptr(), x.data_ptr(), None,
                            x.data_ptr(), 8, 1, 0.0, 0.0, None) == -10
    f = [torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(8, 8),
         torch.zeros(1, 8)]
    bc, out = torch.zeros(4, 8), [torch.zeros(4, 8), torch.zeros(8, 8)]
    assert _mamba(host_lib, 8, 1, f, bc, bc, *out, dtype="int8") == -10
    assert 48 not in HEAD_DIMS
    q = torch.zeros(1, 1, 4, 48, dtype=torch.bfloat16)
    assert _flash(host_lib, q, q, q, q.clone(), 3) == -3
    src = (_build.CSRC / "bf16.cuh").read_text()
    assert re.findall(r"DTYPE_(\w+) = (\d+)", src) == [
        ("F32", "0"), ("BF16", "1")] and tuple(_build.DTYPES) == (
            "float32", "bfloat16")
    assert "ERR_BAD_DTYPE = -10" in src
    fa = (_build.CSRC / "flash_attention.cu").read_text()
    assert "dispatch_head_dim(Dh, attn_io<float>" in fa
    assert "dispatch_head_dim(Dh, attn_io<tdp::bf16>" in fa
    lm = (_build.CSRC / "tdp_gathered_lm.cu").read_text()
    assert "mamba_launch<tdp::bf16>(" in lm
    with pytest.raises(ValueError, match="storage type"):
        _build.check(-10, "x")


def test_unported_bf16_launches_raise():
    """The bfloat16 refusals that remain (ROADMAP A7.1c.4, A5), by the rule
    the card's executor applies to its operands: an LB site function under
    AoSoA and an ensemble launch raise a named ``NotImplementedError``; the
    LB and example site functions under SoA, the LM site functions under
    SoA and AoSoA (``mamba`` and ``rmsnorm`` here), and float32 anywhere,
    pass."""
    from repro_torch.core import Target
    from repro_torch.core.api import Ensemble, launch_plan
    bf = torch.bfloat16
    spec = tlm.mamba_scan_spec(4, 8)
    xs = [torch.zeros(4, 16, dtype=bf), torch.zeros(4, 16, dtype=bf),
          torch.zeros(8, 16), torch.zeros(1, 16)]
    consts = {"b": torch.zeros(4, 8, dtype=bf), "c": torch.zeros(4, 8, dtype=bf)}
    aosoa = launch_plan(spec, Target("cuda", layout="aosoa", vvl=8),
                        consts=consts)
    with pytest.raises(NotImplementedError, match="A7.1c.4"):
        tpw.refuse_unported_bf16(aosoa, "collide", [torch.zeros(3, dtype=bf)])
    with pytest.raises(NotImplementedError, match="A7.1c.4"):
        tpw.refuse_unported_bf16(aosoa, "scale", [torch.zeros(1, 4, dtype=bf)])
    soa = launch_plan(spec, Target("cuda"), consts=consts)
    tpw.refuse_unported_bf16(soa, "scale", [torch.zeros(1, 4, dtype=bf)])
    tpw.refuse_unported_bf16(soa, "collide", [torch.zeros(3, dtype=bf)])
    rms = launch_plan(tlm.rmsnorm_spec(16), Target("cuda", layout="aosoa",
                                                   vvl=8),
                      consts={"weight": torch.zeros(16, dtype=bf)})
    fleet = rms.with_consts(rms.consts, ensemble=Ensemble(2, {}))
    with pytest.raises(NotImplementedError, match="A5"):
        tpw.refuse_unported_bf16(fleet, "rmsnorm",
                                 [torch.zeros(2, 16, 4, dtype=bf)])
    tpw.refuse_unported_bf16(aosoa, "mamba", [*xs, *consts.values()])
    tpw.refuse_unported_bf16(rms, "rmsnorm", [torch.zeros(16, 4, dtype=bf)])
    tpw.refuse_unported_bf16(soa, "mamba", [*xs, *consts.values()])
    tpw.refuse_unported_bf16(aosoa, "collide", [torch.zeros(3)])


#: kernel 4 in bfloat16: gemma3's local and global layers (Dh 128: GQA 2,
#: a window narrower than the keys) and gemma2's (Dh 256, softcap 50),
#: scaled down in the rows, over ragged query and key tiles
_FLASH_BF16 = {
    "gemma3_local_dh128": ((1, 4, 2, 200, 200, 128),
                           dict(causal=True, window=40)),
    "gemma3_global_dh128": ((2, 4, 2, 140, 140, 128), dict(causal=True)),
    "gemma2_softcap_dh256": ((1, 4, 2, 150, 150, 256),
                             dict(causal=True, window=64, softcap=50.0)),
    "noncausal_ragged_dh256": ((1, 2, 1, 77, 140, 256), dict(causal=False)),
    # the other head dims (A7.1b): the smoke models' Dh 16 and 32 with a
    # window and softcap, granite's Dh 64 (GQA 2) and whisper's three
    # attentions at Dh 64 (non-causal Sq ≠ Sk, a tail of 28 keys), zamba2's
    # Dh 80 (V pairs of 16) and deepseek's Dh 192, ragged
    "mqa_window_softcap_dh16": ((1, 4, 1, 100, 100, 16),
                                dict(causal=True, window=40, softcap=5.0)),
    "gqa_causal_dh32": ((2, 4, 2, 70, 70, 32), dict(causal=True)),
    "granite_gqa_dh64": ((1, 4, 2, 140, 140, 64), dict(causal=True)),
    "whisper_frames_dh64": ((1, 2, 2, 150, 92, 64), dict(causal=False)),
    "whisper_cross_dh64": ((1, 2, 2, 92, 348, 64), dict(causal=False)),
    "zamba2_causal_dh80": ((1, 3, 3, 150, 150, 80), dict(causal=True)),
    "deepseek_causal_dh192": ((1, 2, 2, 150, 150, 192), dict(causal=True)),
}


@pytest.mark.parametrize("case", sorted(_FLASH_BF16))
def test_flash_tile_bf16(host_lib, case):
    """bfloat16 q, k, v through the kernel's tile (staged to float32, the
    products and the softmax in float32, o rounded once) against the plain
    version on the same bfloat16 inputs: within one bfloat16 step of its
    output; the log-sum-exp (float32) at the float32 bar."""
    (b, hq, hkv, sq, sk, dh), kw = _FLASH_BF16[case]
    q, k, v = (_bf16(70, (b, hq, sq, dh)), _bf16(71, (b, hkv, sk, dh)),
               _bf16(72, (b, hkv, sk, dh)))
    o = torch.full_like(q, float("nan"))
    lse = torch.full((b, hq, sq), float("nan"))
    assert _flash(host_lib, q, k, v, o, 3, lse=lse, **kw) == 0
    want, want_lse = tref.attention_ref(q, k, v, return_lse=True, **kw)
    assert_within_bf16_step(o, want)
    torch.testing.assert_close(lse, want_lse, **TOL)


def test_flash_tile_bf16_v_padded_dh192(host_lib):
    """deepseek's MLA in bfloat16: V zero-padded from 128 to 192 in
    bfloat16, as ``models/mla.py`` pads it; O's padded dimensions exactly
    0, its first 128 within one bfloat16 step of the plain version."""
    b, h, s_, dh = 1, 2, 140, 192
    q, k, v = (_bf16(76, (b, h, s_, dh)), _bf16(77, (b, h, s_, dh)),
               _bf16(78, (b, h, s_, dh)))
    v[..., 128:] = 0
    o = torch.full_like(q, float("nan"))
    assert _flash(host_lib, q, k, v, o, 3, causal=True) == 0
    assert torch.equal(o[..., 128:], torch.zeros_like(o[..., 128:]))
    assert_within_bf16_step(o, tref.attention_ref(q, k, v, causal=True))


def _mamba_bf16_inputs(seed, rows, length, n, nstate):
    """The scan's operands as the model hands them in bfloat16: x, dt (after
    the softplus, rounded), b and c bfloat16; a (negative) and d float32."""
    x = _bf16(seed, (rows * length, n))
    dt = torch.nn.functional.softplus(_rand(seed + 1, (rows * length, n)))
    a = -torch.exp(_rand(seed + 2, (nstate, n)))
    b = _bf16(seed + 4, (rows * length, nstate))
    c = _bf16(seed + 5, (rows * length, nstate))
    return x, dt.to(torch.bfloat16), a, _rand(seed + 3, (1, n)), b, c


@pytest.mark.parametrize("nstate", _build.MAMBA_NSTATES)
@pytest.mark.parametrize("n", [304, 300])
def test_mamba_site_bf16(host_lib, nstate, n):
    """The scan in bfloat16 (x, dt, b, c and y bfloat16; a, d and h
    float32) over 2 rows of 45 steps (a ragged last chunk at every VVL),
    n = 304 staging x and dt by 16-byte copies of 8 values, n = 300 (not a
    multiple of 8) one value at a time, and b, c at a storage offset of one
    element (their scalar path).  Staged raw and widened as read, the scan
    is the float32 scan of the widened values with y rounded once: bit for
    bit against the float32 launch, y within one bfloat16 step of the plain
    body on the bfloat16 inputs and h at the float32 bar."""
    rows, length = 2, 45
    x, dt, a, d, b, c = _mamba_bf16_inputs(60, rows, length, n, nstate)
    want_y, want_h = tlm.mamba_scan_spec(length, nstate, rows).fn(
        x, dt, a, d, b=b, c=c)
    assert want_y.dtype == torch.bfloat16 and want_h.dtype == torch.float32
    for vvl in (1, 2, 4, 8):
        y32 = torch.full((rows * length, n), float("nan"))
        h32 = torch.full((rows * nstate, n), float("nan"))
        assert _mamba(host_lib, nstate, vvl, (x.float(), dt.float(), a, d),
                      b.float(), c.float(), y32, h32, rows=rows) == 0
        for bb, cc in ((b, c), (_at_offset_like(b, 1), _at_offset_like(c, 1))):
            y = torch.full((rows * length, n), float("nan"),
                           dtype=torch.bfloat16)
            h = torch.full((rows * nstate, n), float("nan"))
            assert _mamba(host_lib, nstate, vvl, (x, dt, a, d), bb, cc, y, h,
                          rows=rows) == 0
            assert torch.equal(y, y32.to(torch.bfloat16)), vvl
            assert torch.equal(h, h32), vvl
            assert_within_bf16_step(y, want_y)
            torch.testing.assert_close(h, want_h, **TOL)


def test_flash_tile_bf16_takes_transposed_views(host_lib):
    """bfloat16 (B, S, H, Dh) projections seen as (B, H, S, Dh), o in q's
    layout: strides in elements, as the wrapper hands them."""
    b, hq, hkv, s, dh = 2, 4, 2, 70, 128
    q = _bf16(73, (b, s, hq, dh)).transpose(1, 2)
    k = _bf16(74, (b, s, hkv, dh)).transpose(1, 2)
    v = _bf16(75, (b, s, hkv, dh)).transpose(1, 2)
    o = torch.full((b, s, hq, dh), float("nan"),
                   dtype=torch.bfloat16).transpose(1, 2)
    assert _flash(host_lib, q, k, v, o, 3, causal=True, softcap=30.0) == 0
    assert_within_bf16_step(o, tref.attention_ref(q, k, v, causal=True,
                                                  softcap=30.0))


def test_flash_row_strides_bf16():
    """bfloat16 strides in elements, multiples of 8 (16 bytes); a float32
    tensor where bfloat16 is asked for, or rows 4 elements apart, raise."""
    from repro_torch.kernels.flash_attention import row_strides
    cpu, bf = torch.device("cpu"), torch.bfloat16
    q = torch.zeros(2, 3, 5, 16, dtype=bf)
    assert row_strides("q", q, cpu, bf) == [240, 80, 16]
    for x in (torch.zeros(2, 3, 5, 16),
              torch.zeros(2, 3, 5, 20, dtype=bf)[..., :16]):
        with pytest.raises(ValueError, match="16-byte aligned"):
            row_strides("q", x, cpu, bf)
