"""The CUDA site functions, checked without a card.

``csrc/lb_sites.cuh`` keeps every site function and both per-thread bodies
(``gathered_thread``, ``windowed_thread``) ``__host__ __device__``, so the
host C++ compiler builds them into a small library whose C entries have the
signatures of the ``.cu`` launchers and loop over the threads one by one.
That library runs through the port's own pointer marshalling and is held to
the plain PyTorch versions at every VVL and on ragged extents — the same
bar as the card: ``STREAM`` bit-exact, the rest ``rtol=1e-5, atol=1e-6``.
The kernels' compile-time tables are held to the port's descriptors
exactly.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import Lattice, Target, gather_neighbors, halo_extend
from repro_torch.core import lattice as tlat
from repro_torch.core.api import launch_plan, torch_executor
from repro_torch.kernels import _build
from repro_torch.kernels.lb_collision import CV
from repro_torch.kernels.tdp_pointwise import phys_args, pointer_arrays
from repro_torch.lb import programs as tprog
from repro_torch.lb import stencil as tst

HEADER = _build.CSRC / "lb_sites.cuh"
SHAPE = (6, 5, 7)          # 210 sites: ragged for VVL 4 and 8, Z ragged too
PHYS = dict(A=0.125, B=0.11, kappa=0.02, tau=0.8, tau_phi=1.2, gamma=0.9)

HARNESS = r"""
#include "lb_sites.cuh"

namespace {
template <class Site, int VVL>
struct GatheredLoop {
  static int run(const tdp::GatheredIO& io, void*) {
    for (int64_t t = 0, nt = tdp::gathered_threads<VVL>(io); t < nt; ++t)
      tdp::gathered_thread<Site, VVL>(io, t);
    return 0;
  }
};
template <class Site, int VVL>
struct WindowedLoop {
  static int run(const tdp::WindowedIO& io, void*) {
    for (int64_t t = 0, nt = tdp::windowed_threads<VVL>(io); t < nt; ++t)
      tdp::windowed_thread<Site, VVL>(io, t);
    return 0;
  }
};
}  // namespace

extern "C" int host_gathered(int site, int vvl, const void* const* in,
                             void* const* out, long long n, float A, float B,
                             float kappa, float tau, float tau_phi,
                             float gamma, void* stream) {
  tdp::GatheredIO io{};
  for (int i = 0; i < tdp::MAX_IN; ++i) io.in[i] = static_cast<const float*>(in[i]);
  for (int k = 0; k < tdp::MAX_OUT; ++k) io.out[k] = static_cast<float*>(out[k]);
  io.n = n;
  io.phys = tdp::make_phys(A, B, kappa, tau, tau_phi, gamma);
  return tdp::dispatch_site<GatheredLoop>(site, vvl, io, stream);
}

extern "C" int host_windowed(int site, int vvl, const void* const* in,
                             void* const* out, int X, int Y, int Z, float A,
                             float B, float kappa, float tau, float tau_phi,
                             float gamma, void* stream) {
  tdp::WindowedIO io{};
  for (int i = 0; i < tdp::MAX_IN; ++i) io.in[i] = static_cast<const float*>(in[i]);
  for (int k = 0; k < tdp::MAX_OUT; ++k) io.out[k] = static_cast<float*>(out[k]);
  io.X = X;
  io.Y = Y;
  io.Z = Z;
  io.n = (int64_t)X * Y * Z;
  io.phys = tdp::make_phys(A, B, kappa, tau, tau_phi, gamma);
  return tdp::dispatch_site<WindowedLoop>(site, vvl, io, stream);
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
                                 + [ctypes.c_longlong] + [ctypes.c_float] * 6
                                 + [ctypes.c_void_p])
    so.host_windowed.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                                 + [ctypes.c_int] * 3 + [ctypes.c_float] * 6
                                 + [ctypes.c_void_p])
    so.host_gathered.restype = so.host_windowed.restype = ctypes.c_int
    return so


def _inputs(spec, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(SHAPE))
    xs = []
    for fs in spec.fields:
        x = 0.05 * rng.normal(size=(fs.ncomp, n))
        if fs.name == "f":
            x = x + 1.0 / 19.0
        xs.append(torch.tensor(x, dtype=torch.float32))
    return xs


_CASES = [(name, windowed) for name in _build.SITES
          for windowed in (False, True)
          if not windowed or tst.SPECS[name].has_stencil]


@pytest.mark.parametrize("name,windowed", _CASES)
def test_site_function_matches_plain(host_lib, name, windowed):
    spec = tst.SPECS[name]
    consts = tprog.collision_consts(**PHYS) if spec.consts else {}
    lat = Lattice(SHAPE)
    plan = launch_plan(spec, Target("cuda_windowed" if windowed else "cuda"),
                       lattice=lat, consts=consts)
    xs = _inputs(spec, _build.SITE_ID[name])
    halo = (0, 0, 0)
    gathered = tuple(x if s is None else gather_neighbors(x, SHAPE, halo, s)
                     for x, s in zip(xs, spec.stencils))
    prepared = (tuple(x if s is None else halo_extend(x, SHAPE, halo, s)
                      for x, s in zip(xs, spec.stencils))
                if windowed else gathered)
    want = torch_executor(plan, gathered)
    for vvl in (1, 2, 4, 8):
        outs = tuple(torch.full((c, lat.nsites), float("nan"))
                     for c in spec.out)
        ins, outp = pointer_arrays(prepared, outs)
        if windowed:
            rc = host_lib.host_windowed(_build.SITE_ID[name], vvl, ins, outp,
                                        *SHAPE, *phys_args(consts), None)
        else:
            rc = host_lib.host_gathered(_build.SITE_ID[name], vvl, ins, outp,
                                        lat.nsites, *phys_args(consts), None)
        assert rc == 0
        for o, w in zip(outs, want):
            if name == "stream":
                assert torch.equal(o, w), vvl
            else:
                torch.testing.assert_close(o, w, rtol=1e-5, atol=1e-6)


def test_bad_site_and_vvl_codes(host_lib):
    x = torch.zeros(8)
    ins, outs = pointer_arrays([x], [x])
    assert host_lib.host_gathered(99, 1, ins, outs, 8, *[1.0] * 6, None) == -1
    assert host_lib.host_gathered(0, 3, ins, outs, 8, *[1.0] * 6, None) == -2
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
