"""The LM site functions and the attention row update, checked without a card.

``csrc/lm_sites.cuh`` (the elementwise ``gated``/``act`` thread, the tiled
and few-token ``rmsnorm`` phases and the ``mamba`` strip) and
``csrc/flash_attention.cuh`` (the per-row online-softmax update and the
dead-tile key range) are ``__host__ __device__``, so the host C++ compiler
builds them into a small library.  Its ``host_lm`` and ``host_mamba``
entries have the signatures of ``tdp_gathered_lm_launch`` and
``tdp_gathered_mamba_launch`` and run each launch's own decomposition:
the same choice of mapping and grid as ``csrc/tdp_gathered_lm.cu``, block by
block, and inside a block each phase thread by thread (warp by warp, lane
by lane) with the kernel's barriers between phases, so rmsnorm's partial
sums meet in the kernel's combine order; the vector and scalar paths are
chosen from the pointers as on the card.  ``host_attention`` runs the
kernel's tile loop — query tiles of 32 rows, key tiles of 32 keys from
``key_range``, the lane reductions done in order — through the same row
functions.  All are held to the plain PyTorch twins at the tests' bar,
``rtol=2e-4, atol=2e-4``, at every VVL, on ragged extents and on
unaligned views.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import lm as tlm
from repro_torch.kernels import ref as tref

TOL = dict(rtol=2e-4, atol=2e-4)

HARNESS = r"""
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
  static int run(const LmIO& io, void*) {
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

extern "C" int host_lm(int site, int act, int vvl, const void* x, const void* v,
                       const void* weight, void* out, long long n, int ncomp,
                       float eps, float scale_offset, void* stream) {
  tdp::lm::LmIO io{};
  io.in[0] = static_cast<const float*>(x);
  io.in[1] = static_cast<const float*>(v);
  io.out = static_cast<float*>(out);
  io.weight = static_cast<const float*>(weight);
  io.n = n;
  io.ncomp = ncomp;
  io.eps = eps;
  io.scale_offset = scale_offset;
  return tdp::lm::dispatch_site<LmLoop>(site, act, vvl, io, stream);
}

namespace {
template <class Site, int VVL>
struct MambaLoop {
  static int run(const tdp::lm::MambaIO& io, void*) {
    for (int64_t t = 0, nt = tdp::lm::lm_threads<VVL>(io); t < nt; ++t)
      tdp::lm::mamba_thread<Site, VVL>(io, t);
    return 0;
  }
};
}  // namespace

extern "C" int host_mamba(int nstate, int vvl, const void* x, const void* dt,
                          const void* a, const void* d, const void* b,
                          const void* c, void* y, void* h, long long L,
                          long long n, void* stream) {
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
  return tdp::lm::dispatch_mamba<MambaLoop>(nstate, vvl, io, stream);
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
    so.host_lm.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                           + [ctypes.c_longlong, ctypes.c_int]
                           + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    so.host_lm.restype = ctypes.c_int
    so.host_mamba.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                              + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    so.host_mamba.restype = ctypes.c_int
    so.host_attention.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                  + [ctypes.c_float] * 2 + [ctypes.c_int] * 2)
    so.host_attention.restype = None
    so.host_key_range.argtypes = ([ctypes.c_int] * 6
                                  + [ctypes.POINTER(ctypes.c_int)] * 2)
    return so


def _rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _lm(so, site, act, vvl, x, v, w, out, eps=1e-6, scale_offset=0.0):
    ncomp, n = x.shape
    return so.host_lm(_build.LM_SITE_ID[site], act, vvl, x.data_ptr(),
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


@pytest.mark.parametrize("d,n", RMS_CASES + [(2304, 9)])
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


def _mamba(so, nstate, vvl, fields, b, c, y, h):
    x, dt, a, d = fields
    length, n = x.shape
    return so.host_mamba(nstate, vvl, *[t.data_ptr() for t in (x, dt, a, d, b,
                                                                c, y, h)],
                         length, n, None)


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
    assert host_lib.host_lm(9, 0, 1, x.data_ptr(), None, None, x.data_ptr(), 8,
                            1, 0.0, 0.0, None) == -1


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
