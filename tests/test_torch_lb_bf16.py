"""bfloat16 in the paper's LB step and example kernels (ROADMAP A7.1c.3),
the port against the JAX package on the CPU.

The reference runs its site bodies in the operands' dtype: in bfloat16
every op rounds, its Python scalars are weak (rounded to bfloat16 first),
its ``jnp.sum``s and contractions sum in float32 and round once.  The
port's plain bodies round at the same points (``repro_torch.kernels.
bf16``), and the CUDA site functions (``csrc/lb_sites.cuh``,
``csrc/example_sites.cuh`` on ``tdp::rbf`` values) round as the plain
bodies do.  Non-default physics (``PHYS``) makes every scalar's rounding
show.

(a) every LB site function, ``collision_site_kernel`` and the three
    example sites: the port's plain body bit for bit against the
    reference's body run op by op (``jax.disable_jit()``), and the port's
    ``"torch"`` launch against the reference's ``pallas_interpret`` launch
    within the bfloat16 bar (``LAUNCH_BAR``: at most 1 % of the elements
    on another value; the jitted Pallas body fuses some roundings away,
    measured 0.06-0.07 % on the collision).  The control, float32
    arithmetic rounded once at the store, must fail the bar.
(b) the bfloat16 site functions of ``lb_sites.cuh`` and
    ``example_sites.cuh`` compiled by the host ``g++`` (the harness mirrors
    the launchers of ``tdp_gathered.cu``, ``tdp_windowed.cu``,
    ``lb_collision.cu`` and ``tdp_gathered_example.cu``), bit for bit
    against (a)'s plain versions at VVL 1, 2, 4 and 8, on a ragged lattice
    with caller ghost planes.
(c) ``BinaryFluidSim(dtype=torch.bfloat16)`` at 12³ in the three regimes:
    the initial state bit-equal to the reference's; 10 steps against the
    reference's ``pallas_interpret`` bfloat16 run of the regime within
    ``TRAJ_BAR`` (f measured bit-equal; g differs from the reference's
    jitted body, whose fused roundings move its rest population g₀ on
    11.5 % of the sites in the first step from rest at 8³, and the
    differences spread through φ); the control fails it; Σf and Σg drift
    no more than the reference's own bfloat16 drift plus ``DRIFT_MARGIN``.
(d) a 2-rank gloo slab lane in bfloat16, bit-equal to the one-device run.
(e) the reference's ``"xla"`` executor promotes the collision's f to
    float32 on bfloat16 operands (its Pallas launch keeps bfloat16).
(f) the bfloat16 launches still to port raise a named
    ``NotImplementedError``: AoSoA (A7.1c.4) and ensembles (A5).
"""
import ctypes
import dataclasses
import shutil
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import repro.core as jcore
import repro.kernels.lb_collision as jlb
import repro.lb.params as jparams
import repro.lb.sim as jsim
from repro.core.api import launch as jlaunch
from repro.lb import programs as jprog
from repro.lb import stencil as jst
from repro_torch.core import Lattice, Target
from repro_torch.core.api import (Ensemble, gather_neighbors, launch,
                                  launch_plan, torch_executor)
from repro_torch.core.registry import register_executor, unregister_executor
from repro_torch.kernels import _build, bf16, example_sites, ops
from repro_torch.kernels import lb_collision as tlb
from repro_torch.kernels import tdp_pointwise as tpw
from repro_torch.kernels.tdp_pointwise import fields_plain, pointer_arrays
from repro_torch.lb import programs as tprog
from repro_torch.lb import stencil as tst
from repro_torch.lb.params import LBParams
from repro_torch.lb.sim import BinaryFluidSim, from_reference

import torch_lb_bf16_lanes as lanes

BF = torch.bfloat16
PHYS = lanes.PHYS
SIM_PHYS = {k: v for k, v in PHYS.items()}
#: (a) the launch bar: share of elements on another value
LAUNCH_BAR = 0.01
#: (c) the trajectory bar: f's share of elements on another value, and the
#: mean |Δφ| of φ = Σ_q g_q (float64) against the reference's run
#: (measured at 12³ and 16³: f 0, mean |Δφ| 3.4e-5 unfused, 4.4e-5 to
#: 4.6e-5 fused; the control: f 1.0, mean |Δφ| 5.4e-5 to 1.1e-4)
TRAJ_BAR = dict(f_share=0.01, phi_mean=6e-5)
#: (c) Σf and Σg may drift past the reference's own drift by this share of
#: Σ|f| and Σ|g| (measured: f drifts 0 in both; g 5.2e-3 against the
#: reference's 5.8e-4 at 16³ unfused, of Σ|g| ≈ 160)
DRIFT_MARGIN = 1e-4
GRID = (12, 12, 12)
STEPS = 10
REGIMES = (False, "one_launch", "two_launch")
VVLS = (1, 2, 4, 8)
LAT = (6, 5, 7)
SITES = _build.SITES

#: the reference's specs by the port's site names
JSPECS = {"stream": jst.STREAM_SPEC, "grad6": jst.GRAD6_SPEC,
          "moment": jst.MOMENT_SPEC, "collide": jst.COLLIDE_SPEC,
          "fused": jst.FUSED_SPEC, "phi_stream": jst.PHI_STREAM_SPEC,
          "fused_two": jst.FUSED_TWO_SPEC}


def to_jnp(x: torch.Tensor):
    """A bfloat16 tensor as the reference's bfloat16 array, bit for bit."""
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def to_np(x) -> np.ndarray:
    """Either side's array as float32 numpy (exact for bfloat16)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def share(a, b) -> float:
    """The share of elements on another value."""
    return float(np.mean(to_np(a) != to_np(b)))


def lb_fields(name, shape=LAT, halo=(0, 0, 0), seed=0):
    """bfloat16 operands of site function ``name``: f near rest (1/19 +
    0.01·N), the rest 0.05·N; a stencil field over the lattice and its
    ghost planes, a pointwise one over the interior; each ``(ncomp,
    sites)``."""
    rng = np.random.default_rng(seed)
    ext = int(np.prod([s + 2 * h for s, h in zip(shape, halo)]))
    xs = []
    for fs in tst.SPECS[name].fields:
        n = ext if fs.stencil is not None else int(np.prod(shape))
        x = 0.05 * rng.standard_normal((fs.ncomp, n))
        if fs.name == "f":
            x = 1.0 / 19.0 + 0.2 * x
        xs.append(torch.from_numpy(x).to(BF))
    return xs


def body_args(name, xs, shape, halo=(0, 0, 0)):
    """The site body's operands: each stencil field's neighbour stack."""
    return [x if s is None else gather_neighbors(x, shape, halo, s)
            for x, s in zip(xs, tst.SPECS[name].stencils)]


def port_consts(spec, dtype=BF):
    return (tprog.collision_consts(dtype=dtype, **PHYS) if spec.consts
            else {})


def ref_body_consts(jspec):
    """The consts the reference's Pallas body gets: w, c as bfloat16
    arrays, the scalars as weak Python floats."""
    if not jspec.consts:
        return {}
    return dict(w=jnp.asarray(jlb.WEIGHTS, jnp.bfloat16),
                c=jnp.asarray(jlb.CV, jnp.bfloat16), **PHYS)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def control_body(fn, args, consts):
    """The control: the body in float32 on the widened operands, each
    output rounded once to bfloat16."""
    c = {k: (np.asarray(v.value if hasattr(v, "value") else v, np.float64)
             if k in ("w", "c") else v) for k, v in consts.items()}
    outs = as_tuple(fn(*[a.float() if a.is_floating_point() else a
                         for a in args], **c))
    return tuple(o.to(BF) for o in outs)


# ---------------------------------------------------------------------------
# (a) the plain bodies against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def site_runs():
    """Per LB site: (port body outputs, reference op-by-op outputs, port
    "torch" launch, reference pallas_interpret launch, control outputs)."""
    out = {}
    lat = Lattice(LAT)
    for name in SITES:
        spec, jspec = tst.SPECS[name], JSPECS[name]
        xs = lb_fields(name, seed=_build.SITE_ID[name])
        args = body_args(name, xs, LAT)
        consts = port_consts(spec)
        body = as_tuple(spec.fn(*args, **{k: getattr(v, "value", v)
                                          for k, v in consts.items()}))
        with jax.disable_jit():
            ref = as_tuple(jspec.fn(*map(to_jnp, args),
                                    **ref_body_consts(jspec)))
        got = as_tuple(launch(spec, Target("torch"), *xs, lattice=lat,
                              consts=consts))
        jconsts = (jprog.collision_consts(dtype=jnp.bfloat16, **PHYS)
                   if jspec.consts else {})
        jgot = as_tuple(jlaunch(jspec, jcore.Target("pallas", interpret=True,
                                                    vvl=128),
                                *map(to_jnp, xs), lattice=jcore.Lattice(LAT),
                                consts=jconsts))
        ctrl = control_body(spec.fn, args, consts)
        out[name] = (body, ref, got, jgot, ctrl)
    return out


@pytest.mark.parametrize("name", SITES)
def test_site_body_is_the_references_op_by_op(site_runs, name):
    """Each LB site body in bfloat16, bit for bit the reference's body run
    op by op on the same neighbour stacks and consts."""
    body, ref, *_ = site_runs[name]
    assert len(body) == len(ref)
    for b, r in zip(body, ref):
        assert b.dtype == BF and r.dtype == jnp.bfloat16
        assert share(b, r) == 0.0, name


@pytest.mark.parametrize("name", SITES)
def test_site_launch_within_the_bar_of_pallas(site_runs, name):
    """The port's ``"torch"`` launch against the reference's Pallas launch
    in interpret mode: bfloat16 out, at most ``LAUNCH_BAR`` of the
    elements on another value."""
    _, _, got, jgot, _ = site_runs[name]
    for g, j in zip(got, jgot):
        assert g.dtype == BF and j.dtype == jnp.bfloat16
        assert share(g, j) <= LAUNCH_BAR, (name, share(g, j))


@pytest.mark.parametrize("name", ["grad6", "collide", "fused", "phi_stream",
                                  "fused_two"])
def test_float32_control_fails_the_bar(site_runs, name):
    """float32 arithmetic rounded once at the store misses the reference's
    bfloat16 launch by more than ``LAUNCH_BAR`` (``stream`` copies and
    ``moment`` sums in float32 in both, so their control is the body)."""
    _, _, _, jgot, ctrl = site_runs[name]
    assert max(share(c, j) for c, j in zip(ctrl, jgot)) > LAUNCH_BAR, name


def test_collision_site_kernel_and_ops_in_bf16():
    """``collision_site_kernel``, ``ops.lb_collision`` (both executors on
    the CPU, and the oracle ``ref.lb_collision_ref``) on 1000 ragged
    sites: bit for bit the reference's body op by op."""
    rng = np.random.default_rng(5)
    n = 1000
    f = torch.from_numpy(1 / 19 + 0.01 * rng.standard_normal((19, n))).to(BF)
    g = torch.from_numpy(0.05 * rng.standard_normal((19, n))).to(BF)
    phi = bf16.sum0(g, keepdim=True)
    gp = torch.from_numpy(0.05 * rng.standard_normal((3, n))).to(BF)
    d2 = torch.from_numpy(0.05 * rng.standard_normal((1, n))).to(BF)
    ins = (f, g, phi, gp, d2)
    with jax.disable_jit():
        jf, jg = jlb.collision_site_kernel(
            *map(to_jnp, ins), w=jnp.asarray(jlb.WEIGHTS, jnp.bfloat16),
            c=jnp.asarray(jlb.CV, jnp.bfloat16), **PHYS)
    runs = {"body": tlb.collision_site_kernel(*ins, w=tlb.WEIGHTS, c=tlb.CV,
                                              **PHYS)}
    for target in ("torch", "cuda"):
        runs[target] = ops.lb_collision(*ins, target=target, device="cpu",
                                        **PHYS)
    for what, (tf, tg) in runs.items():
        assert tf.dtype == tg.dtype == BF, what
        assert share(tf, jf) == 0.0 and share(tg, jg) == 0.0, what


#: the reference's example bodies (``tests/test_tdp_core.py``'s)
J_EXAMPLES = {"scale": lambda x, a=1.0: a * x,
              "saxpy": lambda x, y, a=1.0: a * x + y,
              "site_pos": lambda x, idx: x + idx}


def _example_inputs(name, n=600, ncomp=3, seed=7):
    rng = np.random.default_rng(seed)
    nin = 2 if name == "saxpy" else 1
    return [torch.from_numpy(rng.standard_normal((ncomp, n))).to(BF)
            for _ in range(nin)]


def _j_example_spec(name):
    nin = 2 if name == "saxpy" else 1
    return jcore.KernelSpec(
        J_EXAMPLES[name], fields=(3,) * nin,
        consts=() if name == "site_pos" else ("a",),
        site_index=name == "site_pos", name=name)


@pytest.mark.parametrize("name,a", [
    ("scale", 0.1), ("saxpy", 0.1), ("site_pos", None),
    ("scale", np.float32(0.1)), ("saxpy", np.float32(0.1))],
    ids=["scale-weak", "saxpy-weak", "site_pos", "scale-array",
         "saxpy-array"])
def test_example_sites_in_bf16(name, a):
    """``scale``, ``saxpy`` and ``site_pos`` in bfloat16: the plain body
    bit for bit the reference's op by op (a weak ``a`` rounded to bfloat16
    first, saxpy rounded twice; an array ``a`` a float32 operand, rounded
    once at the store; the int32 site index rounded to bfloat16 before the
    add), the ``"torch"`` launch against the reference's Pallas launch
    within ``LAUNCH_BAR``, and the float32 control outside it."""
    xs = _example_inputs(name)
    n = xs[0].shape[1]
    ex = example_sites.SPECS[name]
    consts = {} if name == "site_pos" else {
        "a": a if isinstance(a, float) else np.asarray([a])}
    jconsts = consts
    idx = torch.arange(n, dtype=torch.int32)
    body_in = xs + ([idx] if name == "site_pos" else [])
    body = ex.fn(*body_in, **consts)
    with jax.disable_jit():
        jin = [to_jnp(x) for x in xs] + (
            [jnp.arange(n, dtype=jnp.int32)] if name == "site_pos" else [])
        ref = J_EXAMPLES[name](*jin, **{k: v if isinstance(v, float)
                                         else jnp.asarray(v)
                                         for k, v in consts.items()})
    assert body.dtype == BF
    assert share(body, ref.astype(jnp.bfloat16)) == 0.0
    got = launch(ex, Target("torch"), *xs, consts=consts)
    jgot = jlaunch(_j_example_spec(name), jcore.Target(
        "pallas", interpret=True, vvl=128), *map(to_jnp, xs), consts=jconsts)
    assert got.dtype == BF and jgot.dtype == jnp.bfloat16
    assert share(got, jgot) <= LAUNCH_BAR
    if not isinstance(a, np.floating):
        ctrl = ex.fn(*[x.float() if x.is_floating_point() else x
                       for x in body_in], **consts).to(BF)
        assert share(ctrl, jgot) > LAUNCH_BAR


def test_bf16_helpers():
    """``round_f64`` rounds a double as the reference's bfloat16
    (``ml_dtypes``) does, through float32 (a case where that differs from
    one rounding); ``weak`` leaves float32 scalars alone."""
    import ml_dtypes
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=20000) * 10.0 ** rng.integers(
        -30, 30, 20000), [0.0, -0.0, 1 / 3, 0.04, 7935623376.008081]])
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    assert np.array_equal(bf16.round_f64(x), want)
    assert bf16.round_f64(7935623376.008081) == 236 * 2.0 ** 25
    assert bf16.weak(0.04, BF) == 0.0400390625
    assert bf16.weak(0.04, torch.float32) == 0.04
    assert tlb.phys_row(PHYS, BF).tolist() == bf16.round_f64(
        [0.07, 0.0625, 0.037, 0.8, 1.2, 0.9, 1 - 0.5 / 0.8, 2.7]).tolist()


# ---------------------------------------------------------------------------
# (b) the CUDA site functions in bfloat16, compiled for the host
# ---------------------------------------------------------------------------

HARNESS = r"""
#include "example_sites.cuh"

#include <algorithm>
#include <cmath>
#include <type_traits>
#include <vector>

namespace {
// tdp_gathered.cu's Launch thread by thread, and tdp_windowed.cu's, whose
// fused runs in tiles, each phase of a block over all its threads before
// the next, on a shared array that starts as NaN.
template <class Site, int VVL>
struct FieldLoop {
  template <class T>
  static int run(const tdp::FieldIOT<T>& io, void*) {
    if (const int rc = tdp::check_geometry(io, Site::RADIUS)) return rc;
    for (int64_t t = 0, nt = tdp::field_threads<VVL>(io); t < nt; ++t)
      tdp::field_thread<Site, VVL>(io, t);
    return 0;
  }
};

template <class T>
struct WindowedArgs {
  tdp::FieldIOT<T> io;
  int plane_block;
};

template <class Site, int VVL>
struct WindowedLoop {
  template <class T>
  static int run(const WindowedArgs<T>& a, void* stream) {
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

template <class T>
int lb(int site, int vvl, int windowed, int plane_block, const void* const* in,
       void* const* out, int X, int Y, int Z, int hx, int hy, int hz, const void* phys) {
  const tdp::FieldIOT<T> io = tdp::make_field_io<T>(in, out, X, Y, Z, hx, hy, hz, phys);
  if (windowed)
    return tdp::dispatch_site<WindowedLoop>(site, vvl, WindowedArgs<T>{io, plane_block},
                                            nullptr);
  return tdp::dispatch_site<FieldLoop>(site, vvl, io, nullptr);
}

// lb_collision.cu's kernel, strip by strip.
template <class T>
void collision(const T* f, const T* g, const T* phi, const T* gp, const T* d2, T* fo,
               T* go, int64_t n, int vvl, const tdp::Phys& p) {
  using V = tdp::value_t<T>;
  for (int64_t site0 = 0; site0 < n; site0 += vvl) {
    for (int l = 0; l < vvl && site0 + l < n; ++l) {
      const int64_t s = site0 + l;
      V fv[tdp::NVEL], gv[tdp::NVEL], grad[3], fov[tdp::NVEL], gov[tdp::NVEL];
      for (int q = 0; q < tdp::NVEL; ++q) {
        fv[q] = tdp::load_value(f + q * n + s);
        gv[q] = tdp::load_value(g + q * n + s);
      }
      for (int d = 0; d < 3; ++d) grad[d] = tdp::load_value(gp + d * n + s);
      tdp::collide_core(fv, gv, tdp::load_value(phi + s), grad, tdp::load_value(d2 + s), p,
                        fov, gov);
      for (int q = 0; q < tdp::NVEL; ++q) {
        tdp::store_value(fo + q * n + s, fov[q]);
        tdp::store_value(go + q * n + s, gov[q]);
      }
    }
  }
}

// tdp_gathered_example.cu's Launch, thread by thread.
template <class Site, int VVL>
struct ExampleLoop {
  template <class T>
  static int run(const tdp::ex::ExampleIOT<T>& io0, void*) {
    if (io0.ncomp <= 0) return 0;
    tdp::ex::ExampleIOT<T> io = io0;
    io.vec = tdp::ex::example_vec<VVL>(io0);
    for (int64_t t = 0, nt = tdp::ex::example_threads<Site, VVL>(io); t < nt; ++t)
      tdp::ex::example_thread<Site, VVL>(io, t);
    return 0;
  }
};

template <class T>
int example(int site, int vvl, const void* x, const void* y, void* out, int n, int ncomp,
            float a) {
  tdp::ex::ExampleIOT<T> io{};
  io.in[0] = static_cast<const T*>(x);
  io.in[1] = static_cast<const T*>(y);
  io.out = static_cast<T*>(out);
  io.n = n;
  io.ncomp = ncomp;
  io.a = a;
  return tdp::ex::dispatch_site<ExampleLoop>(site, vvl, io, nullptr);
}
}  // namespace

extern "C" int host_lb(int site, int vvl, int dtype, int windowed, int plane_block,
                       const void* const* in, void* const* out, int X, int Y, int Z,
                       int hx, int hy, int hz, const void* phys) {
  switch (dtype) {
    case tdp::DTYPE_F32:
      return lb<float>(site, vvl, windowed, plane_block, in, out, X, Y, Z, hx, hy, hz, phys);
    case tdp::DTYPE_BF16:
      return lb<tdp::bf16>(site, vvl, windowed, plane_block, in, out, X, Y, Z, hx, hy, hz,
                           phys);
    default: return tdp::ERR_BAD_DTYPE;
  }
}

extern "C" int host_collision(const void* f, const void* g, const void* phi,
                              const void* gp, const void* d2, void* fo, void* go,
                              long long n, int vvl, int dtype, const void* phys) {
  const tdp::Phys& p = *static_cast<const tdp::Phys*>(phys);
  using B = tdp::bf16;
  if (dtype != tdp::DTYPE_BF16) return tdp::ERR_BAD_DTYPE;
  collision<B>(static_cast<const B*>(f), static_cast<const B*>(g),
               static_cast<const B*>(phi), static_cast<const B*>(gp),
               static_cast<const B*>(d2), static_cast<B*>(fo), static_cast<B*>(go), n, vvl,
               p);
  return 0;
}

extern "C" int host_example(int site, int vvl, int dtype, const void* x, const void* y,
                            void* out, int n, int ncomp, float a) {
  switch (dtype) {
    case tdp::DTYPE_F32: return example<float>(site, vvl, x, y, out, n, ncomp, a);
    case tdp::DTYPE_BF16: return example<tdp::bf16>(site, vvl, x, y, out, n, ncomp, a);
    default: return tdp::ERR_BAD_DTYPE;
  }
}

extern "C" void host_make_phys(float A, float B, float kappa, float tau, float tau_phi,
                               float gamma, void* row) {
  *static_cast<tdp::Phys*>(row) = tdp::make_phys(A, B, kappa, tau, tau_phi, gamma);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the site functions with")
    d = tmp_path_factory.mktemp("lb_bf16_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    lib = d / "libharness.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{_build.CSRC}", "-o",
                    str(lib), str(src)], check=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    so.host_lb.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    so.host_collision.argtypes = ([ctypes.c_void_p] * 7
                                  + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p])
    so.host_example.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                                + [ctypes.c_int] * 2 + [ctypes.c_float])
    so.host_make_phys.argtypes = [ctypes.c_float] * 6 + [ctypes.c_void_p]
    for fn in (so.host_lb, so.host_collision, so.host_example):
        fn.restype = ctypes.c_int
    so.host_make_phys.restype = None
    return so


def _host_lb(host_lib, name, xs, shape, halo, vvl, windowed=False,
             plane_block=2):
    spec = tst.SPECS[name]
    n = int(np.prod(shape))
    outs = tuple(torch.full((c, n), float("nan"), dtype=BF)
                 for c in spec.out)
    ins, outp = pointer_arrays(xs, outs)
    geom = (*shape, *halo) if spec.has_stencil else (1, 1, n, 0, 0, 0)
    row = tlb.phys_row(PHYS if spec.consts else {}, BF)
    rc = host_lib.host_lb(_build.SITE_ID[name], vvl,
                          _build.DTYPE_ID["bfloat16"], int(windowed),
                          plane_block, ins, outp, *geom, row.ctypes.data)
    return rc, outs


#: (shape, halo) of each stencil radius: a ragged lattice, caller ghost
#: planes in two dimensions, the third periodic
HALOS = {1: (1, 0, 1), 2: (2, 2, 0)}


@pytest.mark.parametrize("vvl", VVLS)
@pytest.mark.parametrize("name", SITES)
def test_host_site_functions_bit_equal_plain(host_lib, name, vvl):
    """Each LB site function in bfloat16, thread by thread under ``g++``,
    bit for bit the plain body (``fields_plain``: the neighbour stacks,
    then the bfloat16 body), with caller ghost planes; the windowed
    launcher's ``fused`` in its tiles at plane_block 2 and 3 too."""
    spec = tst.SPECS[name]
    radius = 2 if name == "fused" else 1
    halo = HALOS[radius] if spec.has_stencil else (0, 0, 0)
    xs = lb_fields(name, LAT, halo, seed=10 + _build.SITE_ID[name])
    plan = launch_plan(spec, Target("cuda", vvl=vvl),
                       lattice=Lattice(LAT) if spec.has_stencil else None,
                       halo=halo if spec.has_stencil else None,
                       consts=port_consts(spec))
    fields = [x if s is None else x.reshape(x.shape[0], *(
        sz + 2 * h for sz, h in zip(LAT, halo)))
        for x, s in zip(xs, spec.stencils)]
    want = fields_plain(plan, fields)
    runs = [(False, 2)] + ([(True, 2), (True, 3)] if spec.has_stencil
                           else [])
    for windowed, pb in runs:
        rc, got = _host_lb(host_lib, name, fields, LAT, halo, vvl,
                           windowed, pb)
        assert rc == 0
        for g, w in zip(got, want):
            assert w.dtype == BF
            assert torch.equal(g.view(torch.int16), w.view(torch.int16)), (
                name, windowed, pb, share(g, w))


@pytest.mark.parametrize("vvl", VVLS)
def test_host_collision_bit_equal_plain(host_lib, vvl):
    """``lb_collision.cu``'s kernel body in bfloat16 on 483 sites (ragged
    at every VVL), bit for bit ``collision_site_kernel``."""
    xs = lb_fields("collide", (483,), seed=3)
    want = tlb.collision_site_kernel(*xs, w=tlb.WEIGHTS, c=tlb.CV, **PHYS)
    n = 483
    fo, go = (torch.full((19, n), float("nan"), dtype=BF) for _ in range(2))
    row = tlb.phys_row(PHYS, BF)
    assert host_lib.host_collision(*(x.data_ptr() for x in xs),
                                   fo.data_ptr(), go.data_ptr(), n, vvl,
                                   _build.DTYPE_ID["bfloat16"],
                                   row.ctypes.data) == 0
    assert torch.equal(fo.view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(go.view(torch.int16), want[1].view(torch.int16))


@pytest.mark.parametrize("vvl", VVLS)
@pytest.mark.parametrize("n", [42, 64, 1000])
@pytest.mark.parametrize("name", _build.EXAMPLE_SITES)
def test_host_example_sites_bit_equal_plain(host_lib, name, n, vvl):
    """Each example site function in bfloat16 under ``g++`` (the vector
    path where n is a multiple of the VVL), bit for bit its plain body
    through the ``"torch"`` executor, a = 0.1 rounded as a weak scalar."""
    xs = _example_inputs(name, n=n, seed=n)
    spec = example_sites.SPECS[name]
    consts = {} if name == "site_pos" else {"a": 0.1}
    want = launch(spec, Target("torch"), *xs, consts=consts)
    out = torch.full_like(xs[0], float("nan"))
    plan = launch_plan(dataclasses.replace(spec, out=xs[0].shape[0]),
                       Target("cuda", vvl=vvl), consts=consts)
    rc = host_lib.host_example(
        _build.EXAMPLE_SITE_ID[name], vvl, _build.DTYPE_ID["bfloat16"],
        xs[0].data_ptr(), xs[1].data_ptr() if len(xs) > 1 else None,
        out.data_ptr(), n, xs[0].shape[0], tpw.example_a(plan, BF))
    assert rc == 0
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))


def test_float32_phys_row_is_make_phys(host_lib):
    """The float32 ``tdp::Phys`` the SoA entries now take from the host is
    the one the C ``make_phys`` built from the six scalars: the float32
    launches compute with the bits they had."""
    for p in (PHYS, tlb.PHYS_DEFAULTS, dict(A=0.125, B=0.11, kappa=0.02,
                                             tau=0.9, tau_phi=1.1,
                                             gamma=0.8)):
        row = np.empty(8, np.float32)
        host_lib.host_make_phys(*(float(np.float32(p[k]))
                                  for k in tlb.PHYS_DEFAULTS),
                                row.ctypes.data)
        assert row.tobytes() == tlb.phys_row(p, torch.float32).tobytes()


def test_csrc_takes_the_dtype_code():
    """The SoA C entries of kernels 1, 2 and 3 take the dtype code and a
    host ``tdp::Phys``; the bfloat16 SoA kernels are units of their own."""
    for src, entry in (("tdp_gathered.cu", "tdp_gathered_launch(int site, "
                        "int vvl, int dtype"),
                       ("tdp_windowed.cu", "tdp_windowed_launch(int site, "
                        "int vvl, int plane_block, int dtype"),
                       ("tdp_gathered_example.cu",
                        "tdp_gathered_example_launch(int site, int vvl, "
                        "int dtype")):
        assert entry in (_build.CSRC / src).read_text(), src
    assert "int vvl, int dtype,\n" in (_build.CSRC / "lb_collision.cu"
                                       ).read_text()
    assert _build.UNITS == {"tdp_gathered": 17, "tdp_windowed": 7}


# ---------------------------------------------------------------------------
# (c) BinaryFluidSim in bfloat16 against the reference's
# ---------------------------------------------------------------------------

def _control_executor(plan, gathered, out=None):
    """float32 arithmetic on the widened operands, each output rounded once
    to bfloat16 at the store."""
    outs = torch_executor(plan, tuple(x.float() if x.is_floating_point()
                                      else x for x in gathered))
    return tuple(o.to(BF) for o in outs)


@pytest.fixture(scope="module")
def trajectories():
    """Per regime: (reference initial state, reference state after STEPS,
    port initial state, port state after STEPS, control state)."""
    register_executor("bf16_control", _control_executor)
    out = {}
    try:
        for regime in REGIMES:
            js = jsim.BinaryFluidSim(GRID, jparams.LBParams(**SIM_PHYS),
                                     backend="pallas_interpret", vvl=128,
                                     fused=regime, dtype=jnp.bfloat16)
            j0 = js.init_spinodal(seed=1)
            j1 = js.step(j0, STEPS)
            ts = BinaryFluidSim(GRID, LBParams(**SIM_PHYS), device="cpu",
                                fused=regime, dtype=BF)
            t0 = ts.init_spinodal(seed=1)
            t1 = ts.step(t0, STEPS)
            cs = BinaryFluidSim(GRID, LBParams(**SIM_PHYS), device="cpu",
                                fused=regime, dtype=BF,
                                backend="bf16_control")
            c1 = cs.step(t0, STEPS)
            out[regime] = (j0, j1, t0, t1, c1)
    finally:
        unregister_executor("bf16_control")
    return out


def _traj_readings(state, ref) -> dict:
    jf, jg = to_np(ref.f), to_np(ref.g)
    f, g = to_np(state.f), to_np(state.g)
    return {"f_share": float(np.mean(f != jf)),
            "phi_mean": float(np.mean(np.abs(
                g.astype(np.float64).sum(0) - jg.astype(np.float64).sum(0))))}


def _within(readings) -> bool:
    return all(readings[k] <= v for k, v in TRAJ_BAR.items())


@pytest.mark.parametrize("regime", REGIMES)
def test_initial_state_bit_equal_reference(trajectories, regime):
    j0, _, t0, *_ = trajectories[regime]
    assert t0.f.dtype == t0.g.dtype == BF
    assert share(t0.f, j0.f) == 0.0 and share(t0.g, j0.g) == 0.0


@pytest.mark.parametrize("regime", REGIMES)
def test_trajectory_within_the_bar_and_control_outside(trajectories, regime):
    """10 bfloat16 steps against the reference's ``pallas_interpret`` run
    of the same regime within ``TRAJ_BAR``; the control (float32 math
    rounded at each store) outside it."""
    _, j1, _, t1, c1 = trajectories[regime]
    assert t1.f.dtype == t1.g.dtype == BF and c1.f.dtype == BF
    got = _traj_readings(t1, j1)
    assert _within(got), got
    ctrl = _traj_readings(c1, j1)
    assert not _within(ctrl), ctrl


@pytest.mark.parametrize("regime", REGIMES)
def test_mass_drift_within_the_references(trajectories, regime):
    """Σf and Σg (float64) drift no more than the reference's own bfloat16
    drift plus ``DRIFT_MARGIN`` of Σ|f| and Σ|g|."""
    j0, j1, t0, t1, _ = trajectories[regime]
    for fld in ("f", "g"):
        def total(s):
            return float(to_np(getattr(s, fld)).astype(np.float64).sum())
        scale = float(np.abs(to_np(getattr(t0, fld))).astype(
            np.float64).sum())
        ref_drift = abs(total(j1) - total(j0))
        assert abs(total(t1) - total(t0)) <= ref_drift + DRIFT_MARGIN * scale


def test_sim_dtype_rules_and_entry_points():
    """A dtype other than float32 and bfloat16 raises ``ValueError``;
    ``from_reference`` keeps a bfloat16 state's bits; ``ops.lb_fused_step``
    in bfloat16 is the bfloat16 fused program's step."""
    with pytest.raises(ValueError, match="float16"):
        BinaryFluidSim((4, 4, 4), device="cpu", dtype=torch.float16)
    js = jsim.BinaryFluidSim((4, 4, 4), jparams.LBParams(**SIM_PHYS),
                             dtype=jnp.bfloat16)
    j0 = js.init_spinodal(seed=2)
    st, params = from_reference(np.asarray(j0.f), np.asarray(j0.g),
                                dataclasses.asdict(js.params), device="cpu")
    assert st.f.dtype == BF and share(st.f, j0.f) == 0.0
    assert share(st.g, j0.g) == 0.0
    sim = BinaryFluidSim((4, 4, 4), params, device="cpu", fused="two_launch",
                         dtype=BF)
    w = sim.programs["collide"].step({"f": st.f, "g": st.g})
    want = sim.programs["fused"].step(w)
    f, g = ops.lb_fused_step(w["f"].reshape(19, -1), w["g"].reshape(19, -1),
                             grid_shape=(4, 4, 4), mode="two_launch",
                             device="cpu", **params.as_kwargs())
    assert f.dtype == BF
    assert torch.equal(f, want["f"].reshape(19, -1))
    assert torch.equal(g, want["g"].reshape(19, -1))


# ---------------------------------------------------------------------------
# (d) a 2-rank gloo slab lane in bfloat16
# ---------------------------------------------------------------------------

def test_gloo_slab_lane_bit_equal_one_device(tmp_path):
    """Two gloo ranks on a slab: each rank's bfloat16 planes exchanged as
    they are; the gathered state of the unfused and two_launch runs
    bit-equal to the one-device run (in bfloat16 every op of the plain
    path is elementwise, so the launch shape does not change a bit)."""
    ctx = mp.start_processes(lanes.lane, args=(2, str(tmp_path)), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the bfloat16 gloo lane ran past 240 s")
    got = torch.load(tmp_path / "result.pt", weights_only=False)
    for regime in lanes.REGIMES:
        f, g = got[str(regime)]
        wf, wg = lanes.run(regime)
        assert f.dtype == BF
        assert torch.equal(f, wf) and torch.equal(g, wg), regime


# ---------------------------------------------------------------------------
# (e) the reference's "xla" promotion, (f) the refusals left
# ---------------------------------------------------------------------------

def test_reference_xla_collide_promotes_f_in_bf16():
    """A quirk of the reference (ROADMAP §C): its ``"xla"`` executor returns
    the collision's f in float32 on bfloat16 operands (g stays bfloat16);
    its Pallas kernels, which the port ports, keep both in bfloat16."""
    xs = [to_jnp(x) for x in lb_fields("collide", (300,), seed=9)]
    consts = jprog.collision_consts(dtype=jnp.bfloat16, **PHYS)
    f, g = jlaunch(jst.COLLIDE_SPEC, "xla", *xs, consts=consts)
    assert f.dtype == jnp.float32 and g.dtype == jnp.bfloat16
    f, g = jlaunch(jst.COLLIDE_SPEC, jcore.Target("pallas", interpret=True,
                                                  vvl=128), *xs,
                   consts=consts)
    assert f.dtype == g.dtype == jnp.bfloat16


@pytest.mark.parametrize("executor,name", [
    ("cuda", "collide"), ("cuda", "fused"), ("cuda", "scale"),
    ("cuda_windowed", "fused"), ("cuda_windowed", "stream")])
def test_unported_bf16_routes_raise(executor, name):
    """On the card a bfloat16 launch of an LB or example site function
    under AoSoA raises ``NotImplementedError`` naming A7.1c.4, and under an
    ensemble naming A5; its SoA launch passes the rule."""
    if name == "scale":
        spec, site, kw = dataclasses.replace(example_sites.SCALE_SPEC,
                                             out=3), "scale", {}
        x = [torch.zeros(3, 64, dtype=BF)]
    else:
        spec, site = tst.SPECS[name], name
        kw = dict(lattice=Lattice((4, 4, 4)))
        x = [torch.zeros(3, dtype=BF)]
    consts = port_consts(spec) if spec.consts else (
        {"a": 2.0} if name == "scale" else {})
    aosoa = launch_plan(spec, Target(executor, layout="aosoa", vvl=8),
                        consts=consts, **kw)
    with pytest.raises(NotImplementedError, match="A7.1c.4"):
        tpw.refuse_unported_bf16(aosoa, site, x)
    soa = launch_plan(spec, Target(executor), consts=consts, **kw)
    tpw.refuse_unported_bf16(soa, site, x)
    fleet = soa.with_consts(soa.consts, ensemble=Ensemble(2, {}))
    with pytest.raises(NotImplementedError, match="A5"):
        tpw.refuse_unported_bf16(fleet, site, x)
