"""The CUDA site functions, checked without a card.

``csrc/lb_sites.cuh`` keeps every site function, the neighbour accessor
(``FieldNb``), the per-thread body (``field_thread``) and the two phases of
the tiled ``fused`` kernel (``fused_tile_phi``, ``fused_tile_collide``)
``__host__ __device__``, so the host C++ compiler builds them into a small
library whose C entries have the signatures of the ``.cu`` launchers:
``host_gathered`` loops over the threads one by one, ``host_windowed`` runs
``fused`` as ``tdp_windowed.cu`` does, block by block, each phase over all
the block's threads before the next (the kernel's barrier), on a shared
array that starts as NaN.  That library runs through the port's own
pointer marshalling and is held to the plain PyTorch versions at every
VVL: on ragged sizes whose tiles are cut, on extents of 2 and 3 against a
stencil radius of 2 (the wrap), and with caller ghost planes in one and in
two dimensions.  The bar is the card's: ``STREAM`` bit-exact, the rest
``rtol=1e-5, atol=1e-6``; the tiled ``fused`` is bit-equal to the untiled
one.  The kernels' compile-time tables are held to the port's descriptors
exactly.  ``csrc/example_sites.cuh`` (``scale``, ``saxpy``, ``site_pos``)
builds into a harness of its own, ``host_example``, which runs
``tdp_gathered_example.cu``'s mapping thread by thread; it is bit-equal to
the plain bodies.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import Lattice, Target
from repro_torch.core import launch as tdp_launch
from repro_torch.core import lattice as tlat
from repro_torch.core.api import launch_plan
from repro_torch.kernels import _build, tdp_windowed
from repro_torch.kernels.lb_collision import CV
from repro_torch.core.layout import aosoa_offsets, aosoa_to_soa, soa_to_aosoa
from repro_torch.kernels.tdp_pointwise import (aosoa_operands,
                                               aosoa_plane_sites,
                                               fields_plain, phys_args,
                                               pointer_arrays)
from repro_torch.lb import programs as tprog
from repro_torch.lb import stencil as tst

HEADER = _build.CSRC / "lb_sites.cuh"
SHAPE = (6, 5, 7)          # 210 sites: ragged for VVL 4 and 8, Z ragged too
RAGGED = (7, 11, 37)       # two (y, z) tiles of 8 x 32 each way, cut; and
                           # x cut by plane_block 2-4
PHYS = dict(A=0.125, B=0.11, kappa=0.02, tau=0.8, tau_phi=1.2, gamma=0.9)
VVLS = (1, 2, 4, 8)
STENCIL_SITES = tuple(n for n in _build.SITES if tst.SPECS[n].has_stencil)

HARNESS = r"""
#include "lb_sites.cuh"

#include <algorithm>
#include <cmath>
#include <type_traits>
#include <vector>

namespace {
template <class Site, int VVL>
struct FieldLoop {
  static int run(const tdp::FieldIO& io, void*) {
    if (const int rc = tdp::check_geometry(io, Site::RADIUS)) return rc;
    for (int64_t t = 0, nt = tdp::field_threads<VVL>(io); t < nt; ++t)
      tdp::field_thread<Site, VVL>(io, t);
    return 0;
  }
};

struct WindowedArgs {
  tdp::FieldIO io;
  int plane_block;
};

// tdp_windowed.cu's Launch: fused in tiles, each phase of a block over all
// its threads before the next; the shared array starts as NaN.
template <class Site, int VVL>
struct WindowedLoop {
  static int run(const WindowedArgs& a, void* stream) {
    if (const int rc = tdp::check_geometry(a.io, Site::RADIUS)) return rc;
    if constexpr (std::is_same_v<Site, tdp::FusedSite>) {
      const int P = a.plane_block;
      if (const int rc = tdp::check_tile(P)) return rc;
      std::vector<float> phi(tdp::tile_smem_bytes(P) / sizeof(float));
      for (int64_t b = 0, nb = tdp::tile_blocks(a.io, P); b < nb; ++b) {
        std::fill(phi.begin(), phi.end(), NAN);
        for (int t = 0; t < tdp::tile_threads<VVL>(); ++t)
          tdp::fused_tile_phi<VVL>(a.io, P, b, t, phi.data());
        for (int t = 0; t < tdp::tile_threads<VVL>(); ++t)
          tdp::fused_tile_collide<VVL>(a.io, P, b, t, phi.data());
      }
      return 0;
    } else {
      return FieldLoop<Site, VVL>::run(a.io, stream);
    }
  }
};

tdp::FieldIO make_io(const void* const* in, void* const* out, int X, int Y,
                     int Z, int hx, int hy, int hz, float A, float B,
                     float kappa, float tau, float tau_phi, float gamma) {
  tdp::FieldIO io{};
  for (int i = 0; i < tdp::MAX_IN; ++i) io.in[i] = static_cast<const float*>(in[i]);
  for (int k = 0; k < tdp::MAX_OUT; ++k) io.out[k] = static_cast<float*>(out[k]);
  io.X = X;
  io.Y = Y;
  io.Z = Z;
  io.hx = hx;
  io.hy = hy;
  io.hz = hz;
  io.n = (int64_t)X * Y * Z;
  io.phys = tdp::make_phys(A, B, kappa, tau, tau_phi, gamma);
  return io;
}
}  // namespace

extern "C" int host_gathered(int site, int vvl, const void* const* in,
                             void* const* out, int X, int Y, int Z, int hx,
                             int hy, int hz, float A, float B, float kappa,
                             float tau, float tau_phi, float gamma,
                             void* stream) {
  const tdp::FieldIO io = make_io(in, out, X, Y, Z, hx, hy, hz, A, B, kappa,
                                  tau, tau_phi, gamma);
  return tdp::dispatch_site<FieldLoop>(site, vvl, io, stream);
}

extern "C" int host_windowed(int site, int vvl, int plane_block,
                             const void* const* in, void* const* out, int X,
                             int Y, int Z, int hx, int hy, int hz, float A,
                             float B, float kappa, float tau, float tau_phi,
                             float gamma, void* stream) {
  const WindowedArgs a{make_io(in, out, X, Y, Z, hx, hy, hz, A, B, kappa, tau,
                               tau_phi, gamma),
                       plane_block};
  return tdp::dispatch_site<WindowedLoop>(site, vvl, a, stream);
}

extern "C" long long host_tile_smem(int plane_block) {
  return tdp::tile_smem_bytes(plane_block);
}

// The AoSoA launchers: tdp_gathered.cu's AosoaLaunch thread by thread, and
// tdp_windowed.cu's, whose fused runs in tiles of one site a thread.
namespace {
template <class Site>
struct AosoaLoop {
  static int run(const tdp::AosoaIO& a, void*) {
    if (const int rc = tdp::check_geometry(a.io, Site::RADIUS)) return rc;
    for (int64_t t = 0; t < a.io.n; ++t) tdp::aosoa_thread<Site>(a, t);
    return 0;
  }
};

struct WindowedAosoaArgs {
  tdp::AosoaIO a;
  int plane_block;
};

template <class Site>
struct WindowedAosoaLoop {
  static int run(const WindowedAosoaArgs& w, void* stream) {
    if (const int rc = tdp::check_geometry(w.a.io, Site::RADIUS)) return rc;
    if constexpr (std::is_same_v<Site, tdp::FusedSite>) {
      const int P = w.plane_block;
      if (const int rc = tdp::check_tile(P)) return rc;
      std::vector<float> phi(tdp::tile_smem_bytes(P) / sizeof(float));
      for (int64_t b = 0, nb = tdp::tile_blocks(w.a.io, P); b < nb; ++b) {
        std::fill(phi.begin(), phi.end(), NAN);
        for (int t = 0; t < tdp::tile_threads<1>(); ++t)
          tdp::fused_tile_phi<1>(w.a, P, b, t, phi.data());
        for (int t = 0; t < tdp::tile_threads<1>(); ++t)
          tdp::fused_tile_collide<1>(w.a, P, b, t, phi.data());
      }
      return 0;
    } else {
      return AosoaLoop<Site>::run(w.a, stream);
    }
  }
};

tdp::AosoaIO make_aosoa(const tdp::FieldIO& io, int W, int plane, bool soa_out) {
  tdp::AosoaIO a{};
  a.io = io;
  a.map = tdp::make_aosoa_map(W);
  a.plane = plane;
  a.soa_out = soa_out;
  return a;
}
}  // namespace

extern "C" long long host_aosoa_index(int W, int e, int ncomp, int c) {
  return tdp::aosoa_index(tdp::make_aosoa_map(W), e, ncomp, c);
}

extern "C" int host_gathered_aosoa(int site, int W, const void* const* in,
                                   void* const* out, int X, int Y, int Z, int hx,
                                   int hy, int hz, int plane, float A, float B,
                                   float kappa, float tau, float tau_phi,
                                   float gamma, void* stream) {
  if (W < 1) return tdp::ERR_BAD_VVL;
  const tdp::AosoaIO a = make_aosoa(make_io(in, out, X, Y, Z, hx, hy, hz, A, B,
                                            kappa, tau, tau_phi, gamma),
                                    W, plane, false);
  return tdp::dispatch_site_aosoa<AosoaLoop>(site, a, stream);
}

extern "C" int host_windowed_aosoa(int site, int W, int plane_block,
                                   const void* const* in, void* const* out, int X,
                                   int Y, int Z, int hx, int hy, int hz, int plane,
                                   float A, float B, float kappa, float tau,
                                   float tau_phi, float gamma, void* stream) {
  if (W < 1 || ((int64_t)Y * Z) % W || plane % W) return tdp::ERR_BAD_VVL;
  const WindowedAosoaArgs w{make_aosoa(make_io(in, out, X, Y, Z, hx, hy, hz, A, B,
                                               kappa, tau, tau_phi, gamma),
                                       W, plane, true),
                            plane_block};
  return tdp::dispatch_site_aosoa<WindowedAosoaLoop>(site, w, stream);
}

// The ensemble launchers (a fleet's stage): tdp_gathered.cu's
// EnsembleLaunch member by member (blockIdx.y), thread by thread, and
// tdp_windowed.cu's, whose fused runs in tiles, block by block.
namespace {
template <class Site, int VVL>
struct EnsembleLoop {
  static int run(const tdp::EnsembleIO& e, void*) {
    if (const int rc = tdp::check_geometry(e.io, Site::RADIUS)) return rc;
    for (int m = 0; m < e.B; ++m) {
      const tdp::FieldIO io = tdp::member_io(e, m);
      for (int64_t t = 0, nt = tdp::field_threads<VVL>(io); t < nt; ++t)
        tdp::field_thread<Site, VVL>(io, t);
    }
    return 0;
  }
};

struct WindowedEnsembleArgs {
  tdp::EnsembleIO e;
  int plane_block;
};

template <class Site, int VVL>
struct WindowedEnsembleLoop {
  static int run(const WindowedEnsembleArgs& a, void* stream) {
    if (const int rc = tdp::check_geometry(a.e.io, Site::RADIUS)) return rc;
    if constexpr (std::is_same_v<Site, tdp::FusedSite>) {
      const int P = a.plane_block;
      if (const int rc = tdp::check_tile(P)) return rc;
      std::vector<float> phi(tdp::tile_smem_bytes(P) / sizeof(float));
      for (int m = 0; m < a.e.B; ++m) {
        const tdp::FieldIO io = tdp::member_io(a.e, m);
        for (int64_t b = 0, nb = tdp::tile_blocks(io, P); b < nb; ++b) {
          std::fill(phi.begin(), phi.end(), NAN);
          for (int t = 0; t < tdp::tile_threads<VVL>(); ++t)
            tdp::fused_tile_phi<VVL>(io, P, b, t, phi.data());
          for (int t = 0; t < tdp::tile_threads<VVL>(); ++t)
            tdp::fused_tile_collide<VVL>(io, P, b, t, phi.data());
        }
      }
      return 0;
    } else {
      return EnsembleLoop<Site, VVL>::run(a.e, stream);
    }
  }
};
}  // namespace

extern "C" int host_gathered_ensemble(int site, int vvl, int B, const void* const* in,
                                      void* const* out, const long long* in_stride,
                                      const long long* out_stride, int X, int Y, int Z,
                                      int hx, int hy, int hz, const void* phys,
                                      void* stream) {
  if (const int rc = tdp::check_ensemble(B)) return rc;
  const tdp::EnsembleIO e = tdp::make_ensemble_io(B, in, out, in_stride, out_stride, X,
                                                  Y, Z, hx, hy, hz, phys);
  return tdp::dispatch_site<EnsembleLoop>(site, vvl, e, stream);
}

extern "C" int host_windowed_ensemble(int site, int vvl, int plane_block, int B,
                                      const void* const* in, void* const* out,
                                      const long long* in_stride,
                                      const long long* out_stride, int X, int Y, int Z,
                                      int hx, int hy, int hz, const void* phys,
                                      void* stream) {
  if (const int rc = tdp::check_ensemble(B)) return rc;
  const WindowedEnsembleArgs a{tdp::make_ensemble_io(B, in, out, in_stride, out_stride,
                                                     X, Y, Z, hx, hy, hz, phys),
                               plane_block};
  return tdp::dispatch_site<WindowedEnsembleLoop>(site, vvl, a, stream);
}

// tdp_gathered.cu's tdp_phys_rows, and one make_phys row as a single launch
// builds it from its float arguments
extern "C" void host_phys_rows(int B, const float* consts, void* rows) {
  tdp::make_phys_rows(B, consts, static_cast<tdp::Phys*>(rows));
}

extern "C" void host_make_phys(float A, float B, float kappa, float tau,
                               float tau_phi, float gamma, void* row) {
  *static_cast<tdp::Phys*>(row) = tdp::make_phys(A, B, kappa, tau, tau_phi, gamma);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the site functions with")
    d = tmp_path_factory.mktemp("csrc_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    lib = d / "libharness.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{_build.CSRC}", "-o",
                    str(lib), str(src)], check=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    so.host_gathered.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                                 + [ctypes.c_int] * 6 + [ctypes.c_float] * 6
                                 + [ctypes.c_void_p])
    so.host_windowed.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                                 + [ctypes.c_int] * 6 + [ctypes.c_float] * 6
                                 + [ctypes.c_void_p])
    so.host_gathered.restype = so.host_windowed.restype = ctypes.c_int
    so.host_tile_smem.argtypes = [ctypes.c_int]
    so.host_tile_smem.restype = ctypes.c_longlong
    so.host_gathered_aosoa.argtypes = ([ctypes.c_int] * 2
                                       + [ctypes.c_void_p] * 2
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_float] * 6
                                       + [ctypes.c_void_p])
    so.host_windowed_aosoa.argtypes = ([ctypes.c_int] * 3
                                       + [ctypes.c_void_p] * 2
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_float] * 6
                                       + [ctypes.c_void_p])
    so.host_gathered_aosoa.restype = ctypes.c_int
    so.host_aosoa_index.argtypes = [ctypes.c_int] * 4
    so.host_aosoa_index.restype = ctypes.c_longlong
    so.host_windowed_aosoa.restype = ctypes.c_int
    so.host_gathered_ensemble.argtypes = ([ctypes.c_int] * 3
                                          + [ctypes.c_void_p] * 4
                                          + [ctypes.c_int] * 6
                                          + [ctypes.c_void_p] * 2)
    so.host_windowed_ensemble.argtypes = ([ctypes.c_int] * 4
                                          + [ctypes.c_void_p] * 4
                                          + [ctypes.c_int] * 6
                                          + [ctypes.c_void_p] * 2)
    so.host_gathered_ensemble.restype = ctypes.c_int
    so.host_windowed_ensemble.restype = ctypes.c_int
    so.host_phys_rows.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2
    so.host_phys_rows.restype = None
    so.host_make_phys.argtypes = [ctypes.c_float] * 6 + [ctypes.c_void_p]
    so.host_make_phys.restype = None
    return so


def _fields(spec, shape, halo, seed):
    """The kernels' operands: a stencil field as its ``(ncomp, *(shape +
    2·halo))`` array (ghost planes random too), a pointwise one as
    ``(ncomp, n)``."""
    rng = np.random.default_rng(seed)
    ext = tuple(s + 2 * h for s, h in zip(shape, halo))
    xs = []
    for fs in spec.fields:
        dims = ext if fs.stencil is not None else (int(np.prod(shape)),)
        x = 0.05 * rng.normal(size=(fs.ncomp, *dims))
        if fs.name == "f":
            x = x + 1.0 / 19.0
        xs.append(torch.tensor(x, dtype=torch.float32))
    return xs


def _plan(name, windowed, shape, halo, vvl=1, plane_block=None,
          layout="soa"):
    spec = tst.SPECS[name]
    consts = tprog.collision_consts(**PHYS) if spec.consts else {}
    tuning = {} if plane_block is None else {"plane_block": plane_block}
    tgt = Target("cuda_windowed" if windowed else "cuda", vvl=vvl,
                 tuning=tuning, layout=layout)
    return launch_plan(spec, tgt, lattice=Lattice(shape), halo=halo,
                       consts=consts)


def _host_run(host_lib, name, windowed, shape, halo, xs, vvl,
              plane_block=tdp_windowed.DEFAULT_PLANE_BLOCK):
    """(rc, outputs) of the host harness on ``xs``; outputs start as NaN."""
    spec = tst.SPECS[name]
    n = int(np.prod(shape))
    outs = tuple(torch.full((c, n), float("nan")) for c in spec.out)
    ins, outp = pointer_arrays(xs, outs)
    consts = tprog.collision_consts(**PHYS) if spec.consts else {}
    geom = ((*shape, *halo) if spec.has_stencil else (1, 1, n, 0, 0, 0))
    if windowed:
        rc = host_lib.host_windowed(_build.SITE_ID[name], vvl, plane_block,
                                    ins, outp, *geom, *phys_args(consts), None)
    else:
        rc = host_lib.host_gathered(_build.SITE_ID[name], vvl, ins, outp,
                                    *geom, *phys_args(consts), None)
    return rc, outs


def _assert_matches(name, got, want, what):
    for o, w in zip(got, want):
        if name == "stream":
            assert torch.equal(o, w), what
        else:
            torch.testing.assert_close(o, w, rtol=1e-5, atol=1e-6, msg=what)


def _check_all_vvls(host_lib, name, windowed, shape, halo, seed,
                    plane_blocks=(None,)):
    spec = tst.SPECS[name]
    xs = _fields(spec, shape, halo, seed)
    want = fields_plain(_plan(name, windowed, shape, halo), xs)
    for vvl in VVLS:
        for p in plane_blocks:
            kw = {} if p is None else {"plane_block": p}
            rc, got = _host_run(host_lib, name, windowed, shape, halo, xs,
                                vvl, **kw)
            assert rc == 0
            _assert_matches(name, got, want,
                            f"{name} {shape} halo={halo} vvl={vvl} P={p}")


_CASES = [(name, windowed) for name in _build.SITES
          for windowed in (False, True)
          if not windowed or tst.SPECS[name].has_stencil]


@pytest.mark.parametrize("name,windowed", _CASES)
def test_site_function_matches_plain(host_lib, name, windowed):
    _check_all_vvls(host_lib, name, windowed, SHAPE, (0, 0, 0),
                    _build.SITE_ID[name])


@pytest.mark.parametrize("plane_block", [1, 2, 3, 4, 8])
def test_tiled_fused_on_ragged_tiles(host_lib, plane_block):
    """At 7 x 11 x 37 the last tile in y and in z is cut, and in x unless
    plane_block is 1 or 7+; the tiled kernel equals the plain version
    and, bit for bit, the untiled fused site function."""
    xs = _fields(tst.FUSED_SPEC, RAGGED, (0, 0, 0), 21)
    want = fields_plain(_plan("fused", True, RAGGED, (0, 0, 0)), xs)
    for vvl in VVLS:
        rc, untiled = _host_run(host_lib, "fused", False, RAGGED, (0, 0, 0),
                                xs, vvl)
        assert rc == 0
        rc, tiled = _host_run(host_lib, "fused", True, RAGGED, (0, 0, 0), xs,
                              vvl, plane_block)
        assert rc == 0
        _assert_matches("fused", tiled, want, f"vvl={vvl}")
        for a, b in zip(tiled, untiled):
            assert torch.equal(a, b), vvl


_THIN = [(2, 3, 5), (3, 2, 2), (5, 3, 2)]


@pytest.mark.parametrize("shape", _THIN, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", STENCIL_SITES)
@pytest.mark.parametrize("windowed", [False, True])
def test_thin_periodic_extents(host_lib, name, windowed, shape):
    """Extents of 2 and 3 against the radius-2 fused g stencil and the
    radius-1 ones: the accessor's wrap and the tile rim's."""
    _check_all_vvls(host_lib, name, windowed, shape, (0, 0, 0), 5,
                    plane_blocks=(1, 2) if windowed and name == "fused"
                    else (None,))


_HALOS = [(2, 0, 0), (0, 2, 3), (1, 1, 1), (2, 2, 2)]


def _covers(name, halo) -> bool:
    """Whether ``halo`` holds the stencil radius of site ``name`` in each
    dimension with ghost planes (the launch refuses it otherwise)."""
    radius = [max(r) for r in zip(*(s.radius_per_dim()
                                    for s in tst.SPECS[name].stencils
                                    if s is not None))]
    return all(h == 0 or h >= r for h, r in zip(halo, radius))


#: every stencil site under every ghost geometry that covers its radius
#: (ghost planes in all three dims, as a block decomposition has them,
#: among them); ``fused`` reads g at radius 2, so not at (1, 1, 1)
_GHOST_CASES = [(n, h) for n in STENCIL_SITES for h in _HALOS
                if _covers(n, h)]
_GHOST_IDS = [f"{n}-h{''.join(map(str, h))}" for n, h in _GHOST_CASES]


@pytest.mark.parametrize("name,halo", _GHOST_CASES, ids=_GHOST_IDS)
@pytest.mark.parametrize("windowed", [False, True])
def test_caller_ghost_planes(host_lib, name, windowed, halo):
    """Ghost planes of the caller (random values) in one, two and three
    dimensions, the others wrapping: read where the plain version's
    ``gather_neighbors`` reads them."""
    _check_all_vvls(host_lib, name, windowed, RAGGED, halo, 9,
                    plane_blocks=(1, 3) if windowed and name == "fused"
                    else (None,))


# ---------------------------------------------------------------------------
# the AoSoA layout: AosoaNb, aosoa_thread and the tile phases over AoSoA
# ---------------------------------------------------------------------------

def _aosoa_host_run(host_lib, name, windowed, shape, halo, xs, W,
                    plane_block=tdp_windowed.DEFAULT_PLANE_BLOCK):
    """(rc, SoA outputs) of the AoSoA harness.  The operands go through the
    executor's own boundary transform (``aosoa_operands``) and their pad
    lanes are set to NaN; the outputs start as NaN, and the pad lanes of
    AoSoA outputs must stay NaN (no thread writes them)."""
    spec = tst.SPECS[name]
    n = int(np.prod(shape))
    plan = _plan(name, windowed, shape, halo, vvl=W, layout="aosoa")
    ext = tuple(s + 2 * h for s, h in zip(shape, halo))
    views = [x if s is None else x.view(x.shape[0], *ext)
             for x, s in zip(xs, spec.stencils)]
    ops = aosoa_operands(plan, views, windowed)
    live = aosoa_operands(plan, [torch.ones_like(v) for v in views], windowed)
    for o, m in zip(ops, live):
        o[m == 0] = float("nan")
    if windowed:
        outs = tuple(torch.full((c, n), float("nan")) for c in spec.out)
    else:
        nblk = -(-n // W)
        outs = tuple(torch.full((nblk, c, W), float("nan")) for c in spec.out)
    ins, outp = pointer_arrays(ops, outs)
    consts = tprog.collision_consts(**PHYS) if spec.consts else {}
    geom = ((*shape, *halo) if spec.has_stencil else (1, 1, n, 0, 0, 0))
    plane = aosoa_plane_sites(plan, windowed) if spec.has_stencil else 1
    if windowed:
        rc = host_lib.host_windowed_aosoa(
            _build.SITE_ID[name], W, plane_block, ins, outp, *geom, plane,
            *phys_args(consts), None)
        return rc, outs
    rc = host_lib.host_gathered_aosoa(_build.SITE_ID[name], W, ins, outp,
                                      *geom, plane, *phys_args(consts), None)
    pad = torch.arange(n, -(-n // W) * W)
    for o in outs:
        assert o.reshape(-1)[aosoa_offsets(pad, o.shape[1], W)].isnan().all()
    return rc, tuple(aosoa_to_soa(o, n) for o in outs)


def _check_aosoa(host_lib, name, windowed, shape, halo, seed, widths,
                 plane_blocks=(None,)):
    """Every width and plane_block: bit-equal to the SoA harness at VVL 1
    (the same site arithmetic, other addresses) and held to the plain
    version."""
    spec = tst.SPECS[name]
    xs = _fields(spec, shape, halo, seed)
    want = fields_plain(_plan(name, windowed, shape, halo), xs)
    rc, soa = _host_run(host_lib, name, windowed, shape, halo, xs, 1)
    assert rc == 0
    for W in widths:
        for p in plane_blocks:
            kw = {} if p is None else {"plane_block": p}
            rc, got = _aosoa_host_run(host_lib, name, windowed, shape, halo,
                                      xs, W, **kw)
            what = f"{name} {shape} halo={halo} W={W} P={p}"
            assert rc == 0, what
            for a, b in zip(got, soa):
                assert torch.equal(a, b), what
            _assert_matches(name, got, want, what)


@pytest.mark.parametrize("name,windowed", _CASES)
def test_aosoa_site_function_matches_soa(host_lib, name, windowed):
    """Gathered: any width, one block wider than the lattice included;
    windowed: the divisors of the 32-site plane, ``fused`` at three tile
    depths."""
    if windowed:
        _check_aosoa(host_lib, name, True, (6, 4, 8), (0, 0, 0),
                     _build.SITE_ID[name], (1, 4, 8, 32),
                     (1, 2, 4) if name == "fused" else (None,))
    else:
        _check_aosoa(host_lib, name, False, SHAPE, (0, 0, 0),
                     _build.SITE_ID[name], (1, 3, 8, 32, 256))


@pytest.mark.parametrize("shape,widths", [((2, 3, 5), (3, 15)),
                                          ((5, 3, 2), (2, 6))],
                         ids=["2x3x5", "5x3x2"])
@pytest.mark.parametrize("name", STENCIL_SITES)
@pytest.mark.parametrize("windowed", [False, True])
def test_aosoa_thin_periodic_extents(host_lib, name, windowed, shape, widths):
    """The wrap of AosoaNb and of the tile rim over AoSoA planes."""
    _check_aosoa(host_lib, name, windowed, shape, (0, 0, 0), 5, widths,
                 (1, 2) if windowed and name == "fused" else (None,))


@pytest.mark.parametrize("name,halo", _GHOST_CASES, ids=_GHOST_IDS)
@pytest.mark.parametrize("windowed", [False, True])
def test_aosoa_caller_ghost_planes(host_lib, name, windowed, halo):
    """Ghost planes under AoSoA: the windowed executor's halo-widened
    planes are padded to whole blocks (NaN in the pad lanes here)."""
    _check_aosoa(host_lib, name, windowed, RAGGED, halo, 9,
                 (11, 37) if windowed else (5, 16),
                 (1, 3) if windowed and name == "fused" else (None,))


def test_aosoa_index_map_divides_exactly(host_lib):
    """The kernels' branch-free division by W (a multiply and a shift) over
    every W to 4096 and the extremes of the 31-bit site range, wherever the
    buffer's rows of W fit in 31 bits (the wrappers' bound)."""
    rng = np.random.default_rng(12)
    widths = list(range(1, 4097)) + [8191, 8192, 65535, 2 ** 20, 2 ** 30 - 1,
                                     2 ** 30, 2 ** 31 - 1]
    for W in widths:
        top = (2 ** 31 - 1) // W * W
        es = {0, 1, W - 1, W, 2 ** 31 - 1, top, top - 1,
              *map(int, rng.integers(0, 2 ** 31, 4))}
        for e in es:
            for ncomp, c in ((1, 0), (19, 18)):
                if (e // W + 1) * ncomp > 2 ** 31:
                    continue
                want = ((e // W) * ncomp + c) * W + e % W
                assert host_lib.host_aosoa_index(W, e, ncomp, c) == want, (
                    W, e, ncomp, c)


def test_aosoa_codes(host_lib):
    x = torch.zeros(19 * 64)
    ins, outs = pointer_arrays([x, x], [x, x])
    args = (4, 4, 4, 0, 0, 0, 16, *[1.0] * 6, None)
    assert host_lib.host_gathered_aosoa(0, 0, ins, outs, *args) == -2
    assert host_lib.host_gathered_aosoa(99, 8, ins, outs, *args) == -1
    for W in (0, 3):        # W must divide the 16-site plane
        assert host_lib.host_windowed_aosoa(0, W, 1, ins, outs, *args) == -2
    assert host_lib.host_windowed_aosoa(4, 8, 0, ins, outs, *args) == -7
    assert host_lib.host_gathered_aosoa(
        4, 8, ins, outs, 1, 4, 4, 0, 0, 0, 16, *[1.0] * 6, None) == -6


def test_geometry_and_plane_block_codes(host_lib):
    xs = _fields(tst.FUSED_SPEC, (1, 4, 4), (0, 0, 0), 0)
    for windowed in (False, True):
        # radius 2 over a periodic extent of 1
        assert _host_run(host_lib, "fused", windowed, (1, 4, 4), (0, 0, 0),
                         xs, 1)[0] == -6
    xs = _fields(tst.FUSED_SPEC, (4, 4, 4), (1, 0, 0), 0)
    # one ghost plane against a radius of 2
    assert _host_run(host_lib, "fused", True, (4, 4, 4), (1, 0, 0), xs,
                     1)[0] == -6
    xs = _fields(tst.FUSED_SPEC, (4, 4, 4), (0, 0, 0), 0)
    for p in (0, -1, 169):
        assert _host_run(host_lib, "fused", True, (4, 4, 4), (0, 0, 0), xs,
                         1, p)[0] == -7
    assert _host_run(host_lib, "fused", True, (4, 4, 4), (0, 0, 0), xs,
                     1, 168)[0] == 0
    with pytest.raises(ValueError, match="periodic extent"):
        _build.check(-6, "x")
    with pytest.raises(ValueError, match="plane_block"):
        _build.check(-7, "x")


@pytest.mark.parametrize("plane_block", [1, 4, 168, 169])
def test_tile_smem_estimate_is_the_kernels(host_lib, plane_block):
    plan = _plan("fused", True, (8, 8, 8), (0, 0, 0), plane_block=plane_block)
    assert (tdp_windowed.tile_smem_bytes(plan)
            == host_lib.host_tile_smem(plane_block))
    assert tdp_windowed.tile_smem_bytes(
        _plan("fused_two", True, (8, 8, 8), (0, 0, 0),
              plane_block=plane_block)) == 0


def test_bad_site_and_vvl_codes(host_lib):
    x = torch.zeros(8)
    ins, outs = pointer_arrays([x], [x])
    geom = (1, 1, 8, 0, 0, 0)
    assert host_lib.host_gathered(99, 1, ins, outs, *geom, *[1.0] * 6,
                                  None) == -1
    assert host_lib.host_gathered(0, 3, ins, outs, *geom, *[1.0] * 6,
                                  None) == -2
    with pytest.raises(ValueError, match="unknown site"):
        _build.check(-1, "x")
    with pytest.raises(ValueError, match="VVL"):
        _build.check(-2, "x")


def _table(fn_name):
    """The integer rows of the ``constexpr`` table inside ``fn_name``."""
    text = HEADER.read_text()
    body = text[text.index(fn_name):]
    body = body[body.index("= {") + 3:body.index("};")]
    return [tuple(int(v) for v in row.split(","))
            for row in re.findall(r"\{([^{}]*)\}", body)]


class TestCompiledTables:
    def test_velocity_table(self):
        assert _table("int cv(") == [tuple(int(c) for c in row) for row in CV]
        assert tuple(map(tuple, CV.astype(int))) == tlat.D3Q19_VELOCITIES

    def test_fused_g_offsets(self):
        assert tuple(_table("int fused_g_off(")) == tst.STENCIL_FUSED_G.offsets

    def test_fused_g_slots(self):
        assert tuple(_table("int fused_g_idx(")) == tst._FUSED_G_IDX

    def test_pull_slots_are_identity(self):
        assert tst._PULL_IDX == tuple(range(19))
        assert "int pull_idx(int q) { return q; }" in HEADER.read_text()

    def test_site_enum_order(self):
        text = HEADER.read_text()
        enum = re.findall(r"SITE_(\w+) = (\d+),", text)
        assert [(n.lower(), int(i)) for n, i in enum] == [
            (n, _build.SITE_ID[n]) for n in _build.SITES]

    def test_tile_shape(self):
        m = re.search(r"constexpr int TILE_Y = (\d+), TILE_Z = (\d+);",
                      HEADER.read_text())
        assert tuple(map(int, m.groups())) == tdp_windowed.TILE_YZ

    def test_site_radii(self):
        text = HEADER.read_text()
        for name in _build.SITES:
            cls = "".join(w.title() for w in name.split("_")) + "Site"
            m = re.search(rf"struct {cls} \{{[^}}]*?RADIUS = (\d+);", text)
            spec = tst.SPECS[name]
            want = max((max(s.radius_per_dim()) for s in spec.stencils
                        if s is not None), default=0)
            assert int(m.group(1)) == want, name


# ---------------------------------------------------------------------------
# the paper's example site functions (csrc/example_sites.cuh)
# ---------------------------------------------------------------------------

EX_HEADER = _build.CSRC / "example_sites.cuh"
EX_HARNESS = r"""
#include "example_sites.cuh"

#include <algorithm>
#include <cmath>
#include <vector>

using namespace tdp::ex;

namespace {
// tdp_gathered_example.cu's Launch, thread by thread.
template <class Site, int VVL>
struct ExampleLoop {
  static int run(const ExampleIO& io0, void*) {
    if (io0.ncomp <= 0) return 0;
    ExampleIO io = io0;
    io.vec = example_vec<VVL>(io0);
    for (int64_t t = 0, nt = example_threads<Site, VVL>(io); t < nt; ++t)
      example_thread<Site, VVL>(io, t);
    return 0;
  }
};

// tdp_gathered_example.cu's AosoaLaunch, thread by thread.
template <class Site>
struct ExampleAosoaLoop {
  template <int L>
  static int go(const ExampleAosoaIO& a) {
    for (int64_t t = 0, nt = ((int64_t)a.io.n + L - 1) / L; t < nt; ++t)
      example_aosoa_thread<Site, L>(a, t);
    return 0;
  }

  static int run(const ExampleAosoaIO& a, void*) {
    if (a.io.n <= 0 || a.io.ncomp <= 0) return 0;
    return example_aosoa_lanes(a) == 4 ? go<4>(a) : go<1>(a);
  }
};

// The kernel's shuffle rounds over a block's lanes: in round i each lane
// combines its value with its partner's (lane ^ red_xor(i)) of the round
// before.
template <class Op>
void host_warps(std::vector<typename Op::T>& v) {
  for (int i = 0; i < 5; ++i) {
    const std::vector<typename Op::T> prev = v;
    for (int t = 0; t < EX_BLOCK; ++t)
      v[t] = Op::f(prev[t], prev[(t & ~31) | ((t & 31) ^ red_xor(i))]);
  }
}

// tdp_gathered_example.cu's ReduceLaunch and example_reduce_kernel, block by
// block, each phase over all a block's threads before the next (the
// kernel's barriers), the shared array NaN at the start of each block; the
// blocks in grid order, the last of them the last to count itself.
// r.blocks comes in as the resident blocks of the card.
template <class Site, int VVL>
struct ReduceLoop {
  template <class Op>
  static int go(const ReduceIO& r0, void*) {
    using T = typename Op::T;
    ReduceIO r = r0;
    r.io.vec = example_vec<VVL>(r0.io);
    r.blocks = reduce_blocks<VVL>(r0.io.n, r0.io.ncomp, r0.blocks);
    const int groups = reduce_groups(r.io.ncomp);
    const T nan = (T)NAN;
    std::vector<T> red(EX_CG * EX_WARPS), v(EX_BLOCK);
    std::vector<T> acc(EX_BLOCK * EX_CG);
    for (int gy = 0; gy < groups; ++gy) {
      for (int b = 0; b < r.blocks; ++b) {
        std::fill(red.begin(), red.end(), nan);
        for (int t = 0; t < EX_BLOCK; ++t)
          reduce_thread<Site, Op, VVL>(
              r, b, gy, t, *reinterpret_cast<T(*)[EX_CG]>(&acc[t * EX_CG]));
        for (int k = 0; k < EX_CG; ++k) {
          for (int t = 0; t < EX_BLOCK; ++t) v[t] = acc[t * EX_CG + k];
          host_warps<Op>(v);
          for (int w = 0; w < EX_WARPS; ++w) red[k * EX_WARPS + w] = v[32 * w];
        }
        for (int k = 0; k < EX_CG && gy * EX_CG + k < r.io.ncomp; ++k)
          r.partial[(int64_t)(gy * EX_CG + k) * r.blocks + b] =
              (double)block_combine<Op>(red.data(), k);
        if ((*r.count)++ != (unsigned)(r.blocks * groups - 1)) continue;
        for (int c = 0; c < r.io.ncomp; ++c) {
          for (int t = 0; t < EX_BLOCK; ++t) v[t] = final_thread<Op>(r, c, t);
          host_warps<Op>(v);
          std::fill(red.begin(), red.end(), nan);
          for (int w = 0; w < EX_WARPS; ++w) red[w] = v[32 * w];
          r.io.out[c] = (float)block_combine<Op>(red.data(), 0);
        }
        *r.count = 0;
      }
    }
    return 0;
  }

  static int run(const ReduceIO& r, void*) {
    if (r.io.ncomp <= 0) return 0;
    return dispatch_op<ReduceLoop>(r, nullptr);
  }
};

ExampleIO io_of(const void* x, const void* y, void* out, int n, int ncomp, float a) {
  ExampleIO io{};
  io.in[0] = static_cast<const float*>(x);
  io.in[1] = static_cast<const float*>(y);
  io.out = static_cast<float*>(out);
  io.n = n;
  io.ncomp = ncomp;
  io.a = a;
  return io;
}
}  // namespace

extern "C" int host_example_aosoa(int site, int W, const void* x, const void* y,
                                  void* out, int n, int ncomp, float a) {
  if (W < 1) return tdp::ERR_BAD_VVL;
  ExampleAosoaIO io{};
  io.io = io_of(x, y, out, n, ncomp, a);
  io.map = tdp::make_aosoa_map(W);
  return dispatch_site_aosoa<ExampleAosoaLoop>(site, io, nullptr);
}

extern "C" int host_example(int site, int vvl, const void* x, const void* y,
                            void* out, int n, int ncomp, float a) {
  return dispatch_site<ExampleLoop>(site, vvl, io_of(x, y, out, n, ncomp, a),
                                    nullptr);
}

extern "C" int host_example_reduce(int site, int op, int vvl, const void* x,
                                   const void* y, void* out, void* partial,
                                   void* count, int n, int ncomp, float a,
                                   int resident) {
  ReduceIO r{};
  r.io = io_of(x, y, out, n, ncomp, a);
  r.partial = static_cast<double*>(partial);
  r.count = static_cast<unsigned*>(count);
  r.blocks = resident;
  r.op = op;
  return dispatch_site<ReduceLoop>(site, vvl, r, nullptr);
}

// The example threads' vector path and the reduce's blocks, as the
// launchers choose them.
extern "C" int host_example_vec(int vvl, const void* x, const void* y,
                                const void* out, int n) {
  const ExampleIO io = io_of(x, y, const_cast<void*>(out), n, 1, 1.0f);
  switch (vvl) {
    case 1: return example_vec<1>(io);
    case 2: return example_vec<2>(io);
    case 4: return example_vec<4>(io);
    case 8: return example_vec<8>(io);
    default: return -1;
  }
}

extern "C" int host_aosoa_lanes(int W, const void* x, const void* y,
                                const void* out) {
  ExampleAosoaIO a{};
  a.io = io_of(x, y, const_cast<void*>(out), 1, 1, 1.0f);
  a.map = tdp::make_aosoa_map(W);
  return example_aosoa_lanes(a);
}

extern "C" int host_reduce_blocks(int vvl, int n, int ncomp, int resident) {
  switch (vvl) {
    case 1: return reduce_blocks<1>(n, ncomp, resident);
    case 2: return reduce_blocks<2>(n, ncomp, resident);
    case 4: return reduce_blocks<4>(n, ncomp, resident);
    case 8: return reduce_blocks<8>(n, ncomp, resident);
    default: return -1;
  }
}
"""


@pytest.fixture(scope="module")
def example_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the site functions with")
    d = tmp_path_factory.mktemp("csrc_example")
    src = d / "harness.cpp"
    src.write_text(EX_HARNESS)
    lib = d / "libexample.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{_build.CSRC}", "-o",
                    str(lib), str(src)], check=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    so.host_example.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                                + [ctypes.c_int] * 2 + [ctypes.c_float])
    so.host_example.restype = ctypes.c_int
    so.host_example_aosoa.argtypes = so.host_example.argtypes
    so.host_example_aosoa.restype = ctypes.c_int
    so.host_example_reduce.argtypes = ([ctypes.c_int] * 3
                                       + [ctypes.c_void_p] * 5
                                       + [ctypes.c_int] * 2
                                       + [ctypes.c_float, ctypes.c_int])
    so.host_example_reduce.restype = ctypes.c_int
    so.host_example_vec.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                    + [ctypes.c_int])
    so.host_example_vec.restype = ctypes.c_int
    so.host_aosoa_lanes.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    so.host_aosoa_lanes.restype = ctypes.c_int
    so.host_reduce_blocks.argtypes = [ctypes.c_int] * 4
    so.host_reduce_blocks.restype = ctypes.c_int
    return so


def _example_run(lib, site, vvl, xs, a):
    """(rc, output) of the host harness; the output starts as NaN, so a
    site the mapping misses stays NaN."""
    ncomp, n = xs[0].shape
    out = torch.full((ncomp, n), float("nan"))
    rc = lib.host_example(_build.EXAMPLE_SITE_ID[site], vvl,
                          xs[0].data_ptr(),
                          xs[1].data_ptr() if len(xs) > 1 else None,
                          out.data_ptr(), n, ncomp, a)
    return rc, out


@pytest.mark.parametrize("site", _build.EXAMPLE_SITES)
@pytest.mark.parametrize("vvl", VVLS)
@pytest.mark.parametrize("ncomp,n", [(3, 42), (1, 1), (2, 9)])
def test_example_site_matches_plain(example_lib, site, vvl, ncomp, n):
    """Each example site function, thread by thread, bit-equal to its plain
    body through the ``"torch"`` executor, the ragged end at every VVL."""
    from repro_torch.kernels import example_sites as ex

    rng = np.random.default_rng(_build.EXAMPLE_SITE_ID[site] + 10 * vvl)
    spec = ex.SPECS[site]
    xs = [torch.tensor(rng.normal(size=(ncomp, n)), dtype=torch.float32)
          for _ in spec.fields]
    consts = {} if site == "site_pos" else {"a": -1.7}
    want = tdp_launch(spec, Target("torch"), *xs, **consts)
    rc, got = _example_run(example_lib, site, vvl, xs, consts.get("a", 1.0))
    assert rc == 0
    assert torch.equal(got, want), (site, vvl, ncomp, n)


def test_example_codes_and_enum(example_lib):
    x = torch.zeros(1, 8)
    assert example_lib.host_example(7, 1, x.data_ptr(), None, x.data_ptr(),
                                    8, 1, 1.0) == -1
    assert example_lib.host_example(0, 16, x.data_ptr(), None, x.data_ptr(),
                                    8, 1, 1.0) == -2
    enum = re.findall(r"SITE_(\w+) = (\d+)", EX_HEADER.read_text())
    assert [(n.lower(), int(i)) for n, i in enum] == [
        (n, _build.EXAMPLE_SITE_ID[n]) for n in _build.EXAMPLE_SITES]
    assert "tdp_gathered_example" in _build.SOURCES


@pytest.mark.parametrize("site", _build.EXAMPLE_SITES)
@pytest.mark.parametrize("W", [1, 5, 32, 64])
@pytest.mark.parametrize("ncomp,n", [(3, 42), (2, 9)])
def test_example_aosoa_matches_plain(example_lib, site, W, ncomp, n):
    """Each example site function over AoSoA blocks (pad lanes NaN),
    thread by thread: bit-equal to its plain body, ``site_pos`` with the
    SoA index, and the output's pad lanes never written."""
    from repro_torch.kernels import example_sites as ex

    rng = np.random.default_rng(_build.EXAMPLE_SITE_ID[site] + 10 * W)
    spec = ex.SPECS[site]
    xs = [torch.tensor(rng.normal(size=(ncomp, n)), dtype=torch.float32)
          for _ in spec.fields]
    consts = {} if site == "site_pos" else {"a": -1.7}
    want = tdp_launch(spec, Target("torch"), *xs, **consts)
    nblk = -(-n // W)
    pad = torch.arange(n, nblk * W)
    ops = [soa_to_aosoa(x, W) for x in xs]
    for o in ops:
        o.reshape(-1)[aosoa_offsets(pad, ncomp, W)] = float("nan")
    out = torch.full((nblk, ncomp, W), float("nan"))
    rc = example_lib.host_example_aosoa(
        _build.EXAMPLE_SITE_ID[site], W, ops[0].data_ptr(),
        ops[1].data_ptr() if len(ops) > 1 else None, out.data_ptr(), n,
        ncomp, consts.get("a", 1.0))
    assert rc == 0
    assert torch.equal(aosoa_to_soa(out, n), want), (site, W, ncomp, n)
    assert out.reshape(-1)[aosoa_offsets(pad, ncomp, W)].isnan().all()
    assert example_lib.host_example_aosoa(0, 0, ops[0].data_ptr(), None,
                                          out.data_ptr(), n, ncomp, 1.0) == -2


# ---------------------------------------------------------------------------
# the example launchers' vector and scalar paths, and the one-pass reduce
# ---------------------------------------------------------------------------

def _offset(x, k):
    """``x``'s values in a contiguous tensor at a storage offset of ``k``
    floats (a view, as a slice of a larger buffer is)."""
    buf = torch.full((x.numel() + k,), float("nan"))
    view = buf[k:].view(x.shape)
    view.copy_(x)
    return view


def _example_inputs(site, ncomp, n, seed):
    from repro_torch.kernels import example_sites as ex

    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(ncomp, n)), dtype=torch.float32)
            for _ in ex.SPECS[site].fields]


def _example_plain(site, xs, a):
    from repro_torch.kernels import example_sites as ex

    consts = {} if site == "site_pos" else {"a": a}
    return tdp_launch(ex.SPECS[site], Target("torch"), *xs, **consts)


@pytest.mark.parametrize("site", _build.EXAMPLE_SITES)
@pytest.mark.parametrize("vvl", VVLS)
@pytest.mark.parametrize("ncomp,n,offset", [
    (5, 64, 0), (3, 16, 0), (5, 64, 1), (3, 42, 1), (2, 3, 0), (6, 40, 2)])
def test_example_vector_and_scalar_paths(example_lib, site, vvl, ncomp, n,
                                         offset):
    """The launcher's path choice (the vector path exactly where every
    operand's rows start on a VVL-float boundary) and both paths,
    thread by thread, bit-equal to the plain body: more components than a
    thread holds at once, n a multiple of VVL or not, n < VVL, operands at
    a storage offset of one and two floats."""
    xs = [_offset(x, offset) for x in
          _example_inputs(site, ncomp, n, 7 * vvl + n)]
    want = _example_plain(site, xs, -1.3)
    out = _offset(torch.full((ncomp, n), float("nan")), offset)
    vec = example_lib.host_example_vec(
        vvl, xs[0].data_ptr(), xs[1].data_ptr() if len(xs) > 1 else None,
        out.data_ptr(), n)
    aligned = offset % (4 if vvl >= 4 else vvl) == 0
    assert vec == int(n % vvl == 0 and aligned), (vvl, n, offset)
    rc = example_lib.host_example(
        _build.EXAMPLE_SITE_ID[site], vvl, xs[0].data_ptr(),
        xs[1].data_ptr() if len(xs) > 1 else None, out.data_ptr(), n, ncomp,
        -1.3)
    assert rc == 0
    assert torch.equal(out, want), (site, vvl, ncomp, n, offset)


@pytest.mark.parametrize("site", _build.EXAMPLE_SITES)
@pytest.mark.parametrize("W", [1, 8, 32, 64])
@pytest.mark.parametrize("ncomp,n,offset", [(5, 70, 0), (3, 64, 0),
                                            (5, 70, 1), (2, 3, 0)])
def test_example_aosoa_vector_and_scalar_paths(example_lib, site, W, ncomp,
                                               n, offset):
    """The AoSoA launcher at W 1, 8, 32 and 64: 4 lanes a thread (W a
    multiple of 32, operands 16-byte aligned) or one, the last group of 4
    ragged, a block's operand at a storage offset of one float; bit-equal
    to the plain body, pad lanes neither read (NaN in) nor written."""
    xs = _example_inputs(site, ncomp, n, 11 * W + n)
    want = _example_plain(site, xs, 0.7)
    nblk = -(-n // W)
    pad = torch.arange(n, nblk * W)
    ops = []
    for x in xs:
        o = soa_to_aosoa(x, W)
        o.reshape(-1)[aosoa_offsets(pad, ncomp, W)] = float("nan")
        ops.append(_offset(o, offset))
    out = _offset(torch.full((nblk, ncomp, W), float("nan")), offset)
    lanes = example_lib.host_aosoa_lanes(
        W, ops[0].data_ptr(), ops[1].data_ptr() if len(ops) > 1 else None,
        out.data_ptr())
    assert lanes == (4 if W % 32 == 0 and offset % 4 == 0 else 1)
    rc = example_lib.host_example_aosoa(
        _build.EXAMPLE_SITE_ID[site], W, ops[0].data_ptr(),
        ops[1].data_ptr() if len(ops) > 1 else None, out.data_ptr(), n,
        ncomp, 0.7)
    assert rc == 0
    assert torch.equal(aosoa_to_soa(out, n), want), (site, W, ncomp, n)
    assert out.reshape(-1)[aosoa_offsets(pad, ncomp, W)].isnan().all()


#: sites one reduce block covers in a round at every VVL (EX_BLOCK threads ×
#: EX_RED_SITES sites)
RED_BLOCK_SITES = 256 * 8


def _reduce_run(lib, site, op, vvl, xs, a, resident):
    """(rc, result, partial scratch, counter) of the host reduce; the
    scratch starts as NaN."""
    ncomp, n = xs[0].shape
    out = torch.full((ncomp,), float("nan"))
    partial = torch.full((ncomp * _build.REDUCE_MAX_BLOCKS,), float("nan"),
                         dtype=torch.float64)
    count = torch.zeros(1, dtype=torch.int32)
    rc = lib.host_example_reduce(
        _build.EXAMPLE_SITE_ID[site], _build.REDUCE_OP_ID[op], vvl,
        xs[0].data_ptr(), xs[1].data_ptr() if len(xs) > 1 else None,
        out.data_ptr(), partial.data_ptr(), count.data_ptr(), n, ncomp, a,
        resident)
    return rc, out, partial, int(count)


def _hold_reduce(site, op, got, xs, a):
    """max and min exact against the plain body's; the sum within
    1e-5·Σ|y| of the float64 sum of the plain body's values."""
    y = _example_plain(site, xs, a)
    if op == "sum":
        y64 = y.double()
        err = (got.double() - y64.sum(-1)).abs()
        assert (err <= 1e-5 * y64.abs().sum(-1)).all(), (err, site)
    else:
        want = y.amax(-1) if op == "max" else y.amin(-1)
        assert torch.equal(got, want), (op, got, want)


@pytest.mark.parametrize("site", _build.EXAMPLE_SITES)
@pytest.mark.parametrize("op", _build.REDUCE_OPS)
@pytest.mark.parametrize("vvl", VVLS)
@pytest.mark.parametrize("ncomp,n,offset,resident", [
    (3, 42, 0, 132), (1, 1, 0, 132), (5, RED_BLOCK_SITES + 1, 0, 3),
    (2, 3 * RED_BLOCK_SITES + 9, 1, 4), (6, 5000, 0, 1),
    (1, 300 * RED_BLOCK_SITES - 5, 0, 1056)])
def test_example_reduce_matches_plain(example_lib, site, op, vvl, ncomp, n,
                                      offset, resident):
    """The reduce's phases, block by block on NaN-filled shared arrays and
    scratch, in the kernel's combine order: more components than a block
    holds (two groups), n one past a block's sites, several rounds a thread
    (a small grid), more blocks than a block has threads (the last block's
    threads take several partials each), an operand at a storage offset
    (the scalar path).  The
    counter is back at 0 and no block's partial is left unwritten."""
    xs = [_offset(x, offset) for x in
          _example_inputs(site, ncomp, n, 3 * vvl + n)]
    rc, got, partial, count = _reduce_run(example_lib, site, op, vvl, xs,
                                          1.9, resident)
    assert rc == 0 and count == 0
    _hold_reduce(site, op, got, xs, 1.9)
    blocks = example_lib.host_reduce_blocks(vvl, n, ncomp, resident)
    used = partial[:ncomp * blocks]
    assert not used.isnan().any() and partial[ncomp * blocks:].isnan().all()


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("vvl", VVLS)
@pytest.mark.parametrize("n", [1, 7, RED_BLOCK_SITES + 1])
def test_example_reduce_identity_ends(example_lib, op, vvl, n):
    """Sites past n and threads with no site contribute the op's identity:
    the max of an all-negative field and the min of an all-positive one
    are the field's own, not 0, at n = 1, n ragged against VVL and n one
    past a block (a second block with one site)."""
    rng = np.random.default_rng(n + vvl)
    x = torch.tensor(1.0 + np.abs(rng.normal(size=(2, n))),
                     dtype=torch.float32)
    x = -x if op == "max" else x
    rc, got, _, count = _reduce_run(example_lib, "scale", op, vvl, [x], 1.0,
                                    132)
    assert rc == 0 and count == 0
    want = x.amax(-1) if op == "max" else x.amin(-1)
    assert torch.equal(got, want), (op, vvl, n)


def test_example_reduce_nan_and_blocks(example_lib):
    """max and min propagate a NaN site, as ``torch.amax`` does; the grid
    is one resident wave, at least one block a component group, at most
    ``REDUCE_MAX_BLOCKS``; a bad op is ``ERR_BAD_OP``."""
    x = torch.arange(40, dtype=torch.float32).reshape(2, 20)
    x[1, 13] = float("nan")
    for op in ("max", "min"):
        rc, got, _, _ = _reduce_run(example_lib, "scale", op, 1, [x], 1.0, 8)
        assert rc == 0 and not got[0].isnan() and got[1].isnan()
    for vvl in VVLS:
        assert example_lib.host_reduce_blocks(vvl, 2 ** 31 - 1, 3, 10 ** 6) \
            == _build.REDUCE_MAX_BLOCKS
        assert example_lib.host_reduce_blocks(vvl, 2 ** 24, 9, 1056) == 352
        assert example_lib.host_reduce_blocks(vvl, 5, 9, 2) == 1
    out = torch.zeros(2)
    assert example_lib.host_example_reduce(
        0, 3, 1, x.data_ptr(), None, out.data_ptr(), None, None, 20, 2, 1.0,
        8) == -8
    assert "ERR_BAD_OP = -8" in HEADER.read_text()
    assert -8 in _build._ERRORS
    text = EX_HEADER.read_text()
    enum = re.findall(r"\bRED_(\w+) = (\d+)", text)
    assert [(n.lower(), int(i)) for n, i in enum] == [
        (n, _build.REDUCE_OP_ID[n]) for n in _build.REDUCE_OPS]
    m = re.search(r"constexpr int EX_RED_MAX_BLOCKS = (\d+);", text)
    assert int(m.group(1)) == _build.REDUCE_MAX_BLOCKS
    m = re.search(r"constexpr int EX_BLOCK = (\d+);.*?EX_RED_SITES = (\d+);",
                  text, re.S)
    assert int(m.group(1)) * int(m.group(2)) == RED_BLOCK_SITES


# ---------------------------------------------------------------------------
# ensembles: EnsembleIO, member_io and the ensemble launchers
# ---------------------------------------------------------------------------

#: each member's (tau, tau_phi): a sweep of both, so every member's physics
#: row differs
ENSEMBLE_TAUS = ((0.8, 1.2), (0.9, 0.933), (1.0, 1.067))
GAP = 13                   # floats of NaN between members


def _member_plan(name, windowed, shape, halo, taus, vvl=1):
    spec = tst.SPECS[name]
    phys = dict(PHYS, tau=taus[0], tau_phi=taus[1])
    tgt = Target("cuda_windowed" if windowed else "cuda", vvl=vvl)
    return launch_plan(spec, tgt, lattice=Lattice(shape), halo=halo,
                       consts=tprog.collision_consts(**phys)
                       if spec.consts else {})


def _ensemble_plan(name, windowed, shape, halo, vvl=1):
    from repro_torch.core.api import Ensemble
    spec = tst.SPECS[name]
    plan = _plan(name, windowed, shape, halo, vvl)
    if not spec.consts:
        return plan.with_consts(plan.consts, ensemble=Ensemble(
            len(ENSEMBLE_TAUS), {}))
    taus = np.array(ENSEMBLE_TAUS, np.float32)
    return plan.with_consts(plan.consts, ensemble=Ensemble(
        len(taus), {"tau": taus[:, 0], "tau_phi": taus[:, 1]}))


def _gapped(tensors):
    """``(B, ncomp, *dims)`` views of buffers with ``GAP`` NaN floats after
    each member, holding ``tensors`` (or NaN when ``tensors`` are shapes)."""
    out = []
    for t in tensors:
        shape = tuple(t.shape) if isinstance(t, torch.Tensor) else tuple(t)
        per = int(np.prod(shape[1:]))
        buf = torch.full((shape[0], per + GAP), float("nan"))
        view = buf[:, :per].view(shape)
        if isinstance(t, torch.Tensor):
            view.copy_(t)
        out.append((buf, view))
    return out


def _ensemble_host_run(host_lib, name, windowed, shape, halo, members_xs,
                       vvl, plane_block=tdp_windowed.DEFAULT_PLANE_BLOCK):
    """(rc, outputs (B, ncomp, n), output buffers) of the ensemble harness;
    operands and outputs gapped with NaN, the physics table from
    ``tdp_pointwise.phys_table`` through the harness's make_phys_rows."""
    from repro_torch.kernels import tdp_pointwise as tpw
    spec = tst.SPECS[name]
    B = len(members_xs)
    n = int(np.prod(shape))
    ins = [v for _, v in _gapped([torch.stack(list(xs))
                                  for xs in zip(*members_xs)])]
    obufs = _gapped([(B, c, n) for c in spec.out])
    outs = [v for _, v in obufs]
    plan = _ensemble_plan(name, windowed, shape, halo, vvl)
    orig = tpw._phys_rows_lib
    tpw._phys_rows_lib = lambda: host_lib.host_phys_rows
    try:
        table = tpw.phys_table(plan, "cpu")
    finally:
        tpw._phys_rows_lib = orig
    in_arr, out_arr = pointer_arrays(ins, outs)
    in_s, out_s = tpw.stride_arrays(ins, outs)
    geom = ((*shape, *halo) if spec.has_stencil else (1, 1, n, 0, 0, 0))
    site = _build.SITE_ID[name]
    if windowed:
        rc = host_lib.host_windowed_ensemble(site, vvl, plane_block, B,
                                             in_arr, out_arr, in_s, out_s,
                                             *geom, table.data_ptr(), None)
    else:
        rc = host_lib.host_gathered_ensemble(site, vvl, B, in_arr, out_arr,
                                             in_s, out_s, *geom,
                                             table.data_ptr(), None)
    return rc, outs, [b for b, _ in obufs]


def _check_ensemble(host_lib, name, windowed, shape, halo, seed, vvls,
                    plane_blocks=(None,)):
    """Each member bit-equal to the single harness at its own physics, the
    gaps between output members untouched, each member held to its plain
    version."""
    spec = tst.SPECS[name]
    B = len(ENSEMBLE_TAUS)
    members_xs = [_fields(spec, shape, halo, seed + m) for m in range(B)]
    for vvl in vvls:
        for p in plane_blocks:
            kw = {} if p is None else {"plane_block": p}
            rc, outs, bufs = _ensemble_host_run(host_lib, name, windowed,
                                                shape, halo, members_xs, vvl,
                                                **kw)
            what = f"{name} {shape} halo={halo} vvl={vvl} P={p}"
            assert rc == 0, what
            for b in bufs:
                per = b.shape[1] - GAP
                assert b[:, per:].isnan().all(), what
            for m, xs in enumerate(members_xs):
                taus = ENSEMBLE_TAUS[m] if spec.consts else (PHYS["tau"],
                                                             PHYS["tau_phi"])
                mplan = _member_plan(name, windowed, shape, halo, taus, vvl)
                single = tuple(torch.full((c, int(np.prod(shape))),
                                          float("nan")) for c in spec.out)
                ins, outp = pointer_arrays(xs, single)
                geom = ((*shape, *halo) if spec.has_stencil
                        else (1, 1, int(np.prod(shape)), 0, 0, 0))
                args = (*geom, *phys_args(mplan.consts), None)
                if windowed:
                    rc1 = host_lib.host_windowed(
                        _build.SITE_ID[name], vvl,
                        p or tdp_windowed.DEFAULT_PLANE_BLOCK, ins, outp,
                        *args)
                else:
                    rc1 = host_lib.host_gathered(_build.SITE_ID[name], vvl,
                                                 ins, outp, *args)
                assert rc1 == 0
                for got, want in zip(outs, single):
                    assert torch.equal(got[m], want), f"{what} member {m}"
                _assert_matches(name, tuple(o[m] for o in outs),
                                fields_plain(mplan, xs), f"{what} member {m}")


@pytest.mark.parametrize("name,windowed", _CASES)
def test_ensemble_members_match_single_launches(host_lib, name, windowed):
    """host_gathered_ensemble / host_windowed_ensemble: three members laid
    out with NaN gaps, a distinct physics row each, every VVL — each member
    the single harness's bits."""
    _check_ensemble(host_lib, name, windowed, SHAPE, (0, 0, 0),
                    _build.SITE_ID[name], VVLS,
                    plane_blocks=(1, 3) if windowed and name == "fused"
                    else (None,))


@pytest.mark.parametrize("name,windowed", [("fused", True), ("fused", False),
                                           ("fused_two", True),
                                           ("stream", False)])
def test_ensemble_on_ragged_tiles_and_ghost_planes(host_lib, name, windowed):
    """A size that cuts every tile, and caller ghost planes."""
    _check_ensemble(host_lib, name, windowed, RAGGED, (0, 0, 0), 5, (1, 4))
    _check_ensemble(host_lib, name, windowed, RAGGED, (2, 0, 2), 6, (2,))


def test_phys_rows_are_the_single_launchs_bits(host_lib):
    """The table the wrapper builds for a sweep (``phys_table``, through
    make_phys_rows) holds, row by row, the bits make_phys gives a single
    launch from its float arguments: fcoef and g3 included."""
    from repro_torch.core.api import Ensemble
    from repro_torch.kernels import tdp_pointwise as tpw
    taus = np.array([0.8, 0.933, 1.067, 1.2, 0.7001, 1.9999], np.float32)
    plan = _plan("collide", False, SHAPE, (0, 0, 0))
    plan = plan.with_consts(plan.consts, ensemble=Ensemble(
        len(taus), {"tau": taus[::-1].copy(), "tau_phi": taus}))
    orig = tpw._phys_rows_lib
    tpw._phys_rows_lib = lambda: host_lib.host_phys_rows
    try:
        table = tpw.phys_table(plan, "cpu")
        assert tpw.phys_table(plan, "cpu") is table   # cached by content
    finally:
        tpw._phys_rows_lib = orig
    for m in range(len(taus)):
        row = np.empty(8, np.float32)
        host_lib.host_make_phys(*phys_args(plan.member_plan(m).consts),
                                row.ctypes.data)
        assert table[m].numpy().tobytes() == row.tobytes(), m


def test_ensemble_codes(host_lib):
    null = (ctypes.c_void_p * 5)()
    outs = (ctypes.c_void_p * 2)()
    strides = (ctypes.c_longlong * 5)()
    for B in (0, 65536):
        rc = host_lib.host_gathered_ensemble(0, 1, B, null, outs, strides,
                                             strides, *SHAPE, 0, 0, 0, None,
                                             None)
        assert rc == -9
    assert "65535" in _build._ERRORS[-9]
