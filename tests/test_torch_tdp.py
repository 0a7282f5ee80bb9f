"""The port's paper-facing surface (``repro_torch.tdp``) against the JAX package.

Counterparts of ``tests/test_tdp_core.py`` (lattice, fields, the memory
model, execution, reductions) and ``tests/test_tdp_api.py`` (targets,
launch errors, VVL staleness, the deprecated shims), plus the port's own:
the site index, the ``"cuda"`` executor's example site functions on CPU
tensors (their plain bodies), the Ludwig configs and both examples.  The
same seeded numpy inputs go through ``repro`` and ``repro_torch``; the
tolerances are the reference tests' own.  Import hygiene: ``repro_torch.tdp``
imports with ``jax`` unimportable.
"""
import dataclasses
import inspect
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import tdp as jtdp
from repro.configs import ludwig_lb as jludwig
from repro.lb import params as jparams
from repro.lb import programs as jlbp
from repro.lb import sim as jsim
from repro.lb import stencil as jst
from repro_torch import tdp
from repro_torch.configs import ludwig_lb
from repro_torch.core import api as tapi
from repro_torch.core import execute as texe
from repro_torch.examples import lb_spinodal, quickstart
from repro_torch.kernels import example_sites as ex
from repro_torch.kernels import tdp_pointwise
from repro_torch.lb import programs as tlbp
from repro_torch.lb import stencil as tst
from repro_torch.lb.params import LBParams
from repro_torch.lb.sim import BinaryFluidSim, from_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
BACKENDS = ("torch", "cuda")          # "cuda" on CPU tensors: the plain body
VVLS = (1, 2, 4, 8)

#: the reference's ensemble and resilience names (ROADMAP A5, the last of
#: its surface to be ported)
FLEET_NAMES = ("fleet", "FleetProgram", "FleetDriver", "Ticket", "health",
               "faults", "HealthPolicy", "HealthError", "Diagnosis",
               "InjectedFault", "ProgramState", "BatchedConst")


@jcore.site_kernel
def jscale(field, a=1.0):
    return a * field


@jcore.site_kernel
def jsaxpy(x, y, a=1.0):
    return a * x + y


@jcore.site_kernel
def jtwo_out(x):
    return 2.0 * x, x * x


@tdp.site_kernel
def two_out(x):
    return 2.0 * x, x * x


def _both(rng, shape, dtype=np.float32):
    """The same seeded values as a jax array and a CPU tensor."""
    x = rng.normal(size=shape).astype(dtype)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _legacy(fn, *args, **kw):
    with pytest.warns(DeprecationWarning):
        return fn(*args, **kw)


# ---------------------------------------------------------------------------
# lattice and fields
# ---------------------------------------------------------------------------

class TestLattice:
    def test_basic_and_halo(self):
        assert tdp.Lattice((4, 6, 8)).nsites == 192
        lat = tdp.Lattice((4, 4, 4), halo=1)
        assert lat.halo_shape == (6, 6, 6) and lat.nsites_with_halo == 216

    def test_vvl_padding(self):
        lat, jlat = tdp.Lattice((10,)), jcore.Lattice((10,))
        for v in (4, 10, 3):
            assert lat.padded_nsites(v) == jlat.padded_nsites(v)
            assert lat.nchunks(v) == jlat.nchunks(v)

    def test_token_lattice(self):
        lat, jlat = tdp.token_lattice(8, 128), jcore.token_lattice(8, 128)
        assert (lat.shape, lat.halo) == (jlat.shape, jlat.halo)
        assert lat.nsites == 1024

    def test_interior_slices(self):
        for halo in (0, 2):
            assert (tdp.Lattice((3, 5), halo).interior_slices()
                    == jcore.Lattice((3, 5), halo).interior_slices())

    def test_validation(self):
        for bad in ((), (0, 4)):
            with pytest.raises(ValueError):
                tdp.Lattice(bad)
        with pytest.raises(ValueError):
            tdp.Lattice((4,), halo=-1)


class TestField:
    def test_layouts_roundtrip(self, rng):
        f = tdp.Field(tdp.Lattice((4, 4)), ncomp=3, dtype=np.float32)
        f.data[...] = rng.normal(size=f.array_shape)
        g = f.to_layout("aos")
        assert g.array_shape == (16, 3)
        np.testing.assert_array_equal(g.to_layout("soa").data, f.data)

    def test_views_match_reference(self, rng):
        data = rng.normal(size=(2, 36))
        for layout in ("soa", "aos"):
            d = data if layout == "soa" else data.T.copy()
            a = tdp.Field(tdp.Lattice((4, 4), 1), 2, layout=layout, data=d)
            b = jcore.Field(jcore.Lattice((4, 4), 1), 2, layout=layout,
                            data=d)
            for view in ("grid_view", "interior"):
                np.testing.assert_array_equal(getattr(a, view)(),
                                              getattr(b, view)())
            np.testing.assert_array_equal(a.site(1, 2), b.site(1, 2))
            assert a.dtype == b.dtype == np.float64

    def test_interior_view_and_like(self):
        f = tdp.Field(tdp.Lattice((2, 2), halo=1), ncomp=1)
        f.grid_view()[0, 1:3, 1:3] = 7.0
        assert (f.interior() == 7.0).all() and f.data.sum() == 28.0
        g = tdp.field_like(f)
        assert g.array_shape == f.array_shape and not g.data.any()
        with pytest.raises(ValueError):
            tdp.Field(tdp.Lattice((2,)), 1, data=np.zeros((1, 3)))
        with pytest.raises(ValueError):
            tdp.Field(tdp.Lattice((2,)), 0)


# ---------------------------------------------------------------------------
# the memory model
# ---------------------------------------------------------------------------

def _face_mask(n):
    """The six boundary faces of an n³ grid, flattened."""
    m = np.zeros((n,) * 3, bool)
    for d in range(3):
        idx = [slice(None)] * 3
        for end in (0, n - 1):
            idx[d] = end
            m[tuple(idx)] = True
    return m.reshape(-1)


class TestMemoryModel:
    def test_malloc_and_free(self):
        t = tdp.target_malloc((3, 64), device="cpu")
        assert t.shape == (3, 64) and t.dtype == torch.float32
        assert float(t.sum()) == 0.0
        tdp.target_free(t)
        # the storage is released; every memory-model call now raises
        assert t.shape == (0,) and t.untyped_storage().nbytes() == 0
        for call in (lambda: tdp.copy_from_target(t),
                     lambda: tdp.copy_from_target_masked(t, np.ones(64)),
                     lambda: tdp.copy_to_target_masked(
                         t, np.ones((3, 64)), np.ones(64)),
                     lambda: tdp.sync_target(t),
                     lambda: tdp.target_free(t)):
            with pytest.raises(RuntimeError, match="target_free"):
                call()

    def test_malloc_validation_and_dtypes(self):
        with pytest.raises(ValueError):
            tdp.target_malloc((3, 0), device="cpu")
        for dt, want in ((np.float64, torch.float64),
                         (torch.float16, torch.float16),
                         ("float32", torch.float32)):
            assert tdp.target_malloc((2,), dt, device="cpu").dtype == want
        f = tdp.Field(tdp.Lattice((4,)), 2)
        assert tdp.target_malloc_like(f, device="cpu").dtype == torch.float64
        assert tdp.target_malloc_like(
            f, device="cpu", dtype=np.float32).shape == (2, 4)

    def test_copy_roundtrip(self, rng):
        lat = tdp.Lattice((8, 8))
        f = tdp.Field(lat, 3, np.float32)
        f.data[...] = rng.normal(size=f.array_shape)
        t = tdp.copy_to_target(f, device="cpu")
        back = tdp.copy_from_target(t, tdp.Field(lat, 3, np.float32))
        np.testing.assert_array_equal(back.data, f.data)
        with pytest.raises(ValueError, match="shape"):
            tdp.copy_from_target(t, tdp.Field(lat, 2, np.float32))

    def test_host_and_target_copies_are_distinct(self, rng):
        """The paper keeps two copies even when the target is the host."""
        host = rng.normal(size=(2, 5)).astype(np.float32)
        t = tdp.copy_to_target(host, device="cpu")
        host[...] = 0.0
        assert float(t.abs().sum()) > 0
        out = tdp.copy_from_target(t)
        out[...] = 0.0
        assert float(t.abs().sum()) > 0

    def test_dtype_is_the_callers_or_the_fields(self, rng):
        f = tdp.Field(tdp.Lattice((4,)), 2)          # float64 by default
        f.data[...] = rng.normal(size=f.array_shape)
        jt = jcore.copy_to_target(jcore.Field(jcore.Lattice((4,)), 2,
                                              data=f.data), dtype=np.float32)
        assert tdp.copy_to_target(f, device="cpu").dtype == torch.float64
        t32 = tdp.copy_to_target(f, device="cpu", dtype=np.float32)
        np.testing.assert_array_equal(t32.numpy(), np.asarray(jt))

    def test_float64_target_is_refused_by_the_kernel_wrapper(self):
        """A float64 target under "cuda" meets the named dtype error of the
        kernels' wrapper, never a silent cast (checked before any pointer
        reaches the card)."""
        x = tdp.copy_to_target(tdp.Field(tdp.Lattice((8,)), 3), device="cpu")
        plan = tdp.launch_plan(dataclasses.replace(ex.SCALE_SPEC, out=3),
                               tdp.Target("cuda"), consts={"a": 2.0})
        with pytest.raises(ValueError, match="float32"):
            tdp_pointwise._example_execute(plan, "scale", 1, (x,), None)

    def test_masked_roundtrip_matches_reference(self, rng):
        """pack → copy → unpack == direct subset copy (paper §III-B), as the
        reference does it on the same mask."""
        lat, jlat = tdp.Lattice((16,)), jcore.Lattice((16,))
        data = rng.normal(size=(2, 16)).astype(np.float32)
        mask = np.zeros(16, bool)
        mask[[1, 5, 6, 11]] = True
        t = tdp.copy_to_target(tdp.Field(lat, 2, np.float32, data=data),
                               device="cpu")
        jt = jcore.copy_to_target(jcore.Field(jlat, 2, np.float32, data=data))

        got = tdp.copy_from_target_masked(t, mask, tdp.Field(lat, 2,
                                                             np.float32))
        want = jcore.copy_from_target_masked(jt, mask,
                                             jcore.Field(jlat, 2, np.float32))
        np.testing.assert_array_equal(got.data, want.data)
        assert (got.data[:, ~mask] == 0).all()
        np.testing.assert_array_equal(tdp.copy_from_target_masked(t, mask),
                                      jcore.copy_from_target_masked(jt, mask))

        new = data.copy()
        new[:, mask] = -1.0
        t2 = tdp.copy_to_target_masked(t, new, mask)
        jt2 = jcore.copy_to_target_masked(jt, new, mask)
        np.testing.assert_array_equal(tdp.copy_from_target(t2),
                                      np.asarray(jt2))

    def test_masked_face_mask_of_a_field(self, rng):
        """The halo-transfer use: the six faces of a 6³ grid, 19 components,
        against the selected columns of a full copy; unselected sites of
        the target stay as they were."""
        n, mask = 6, _face_mask(6)
        data = rng.normal(size=(19, n ** 3)).astype(np.float32)
        t = tdp.copy_to_target(data, device="cpu")
        packed = tdp.copy_from_target_masked(t, mask)
        assert packed.shape == (19, n ** 3 - (n - 2) ** 3)
        np.testing.assert_array_equal(packed,
                                      tdp.copy_from_target(t)[:, mask])
        upd = rng.normal(size=data.shape).astype(np.float32)
        tdp.copy_to_target_masked(t, upd, mask)
        got = tdp.copy_from_target(t)
        np.testing.assert_array_equal(got[:, mask], upd[:, mask])
        np.testing.assert_array_equal(got[:, ~mask], data[:, ~mask])

    def test_masked_copy_to_target_is_in_place(self, rng):
        """The port scatters into the target and returns it (the paper's
        semantics); the reference returns a new array (ROADMAP §C)."""
        t = tdp.copy_to_target(rng.normal(size=(2, 8)).astype(np.float32),
                               device="cpu")
        mask = np.arange(8) % 3 == 0
        out = tdp.copy_to_target_masked(t, np.full((2, 8), 5.0), mask)
        assert out is t
        assert (t[:, torch.from_numpy(mask)] == 5.0).all()
        assert tdp.copy_to_target_masked(t, np.zeros((2, 8)),
                                         np.zeros(8, bool)) is t

    def test_masked_empty(self):
        t = tdp.target_malloc((1, 4), device="cpu")
        out = tdp.copy_from_target_masked(t, np.zeros(4, bool))
        assert out.shape == (1, 0) and out.dtype == np.float32
        host = tdp.Field(tdp.Lattice((4,)), 1)
        assert tdp.copy_from_target_masked(t, np.zeros(4), host) is host

    def test_target_const_hashing(self):
        a = tdp.copy_constant_to_target(np.arange(3.0))
        b = tdp.TargetConst(np.arange(3.0))
        c = tdp.TargetConst(np.arange(4.0))
        assert a == b and hash(a) == hash(b) and a != c

    def test_sync(self):
        tdp.sync_target(torch.ones(4))        # a CPU tensor needs nothing
        if torch.cuda.is_available():
            tdp.sync_target()
            return
        with pytest.raises(RuntimeError, match="CUDA"):
            tdp.sync_target()

    def test_no_device_means_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: no device means it")
        with pytest.raises(RuntimeError, match="CUDA"):
            tdp.target_malloc((2, 2))
        with pytest.raises(RuntimeError, match="CUDA"):
            tdp.copy_to_target(np.zeros((2, 2), np.float32))


# ---------------------------------------------------------------------------
# targets, specs, registry
# ---------------------------------------------------------------------------

class TestTargetSpecRegistry:
    def test_target_tuning(self):
        a = tdp.Target("cuda_windowed", tuning={"plane_block": 2, "x": 1})
        b = tdp.Target("cuda_windowed", tuning={"x": 1, "plane_block": 2})
        assert a == b and hash(a) == hash(b)
        assert a.tune("plane_block") == 2 and a.tune("missing", 7) == 7
        j = jtdp.Target("pallas_windowed", tuning={"plane_block": 2, "x": 1})
        assert a.tuning_dict() == j.tuning_dict() == {"plane_block": 2, "x": 1}
        assert a.tune("x") == j.tune("x")
        assert a.replace(vvl=2) == a.with_(vvl=2)
        assert a.replace(vvl=2).vvl == j.replace(vvl=2).vvl == 2

    def test_set_default_vvl(self):
        old = tdp.default_vvl()
        try:
            tdp.set_default_vvl(64)
            assert tdp.default_vvl() == 64
            assert tdp.Target("torch").resolve_vvl() == 64
            for bad in (0, -1):
                with pytest.raises(ValueError):
                    tdp.set_default_vvl(bad)
        finally:
            tdp.set_default_vvl(old)

    def test_site_index_spec(self):
        @tdp.kernel(fields=[tdp.field(2)], site_index=True)
        def pos(x, idx):
            return x + idx

        assert pos.site_index and not ex.SCALE_SPEC.site_index
        assert tdp.launch_plan(pos, "torch").site_index
        assert not tdp.launch_plan(dataclasses.replace(pos, site_index=False),
                                   "torch").site_index
        assert tdp.KernelSpec(pos.fn, fields=(2,)).site_index is False

    def test_registry_lookups(self):
        assert tdp.get_executor("torch") is tapi.torch_executor
        assert {"torch", "cuda", "cuda_windowed"} <= set(tdp.list_executors())
        assert tdp.list_executors() == tuple(sorted(tdp.list_executors()))
        with pytest.raises(ValueError, match="unknown executor"):
            tdp.get_executor("xla")


@tdp.kernel(fields=[tdp.field(1)], out=1)
def chunk_width(x):
    return x


def _probe(plan, prepared, out=None):
    """Reports the VVL its plan was built with."""
    return (torch.full_like(prepared[0], float(plan.vvl)),)


@pytest.fixture
def vvl_probe():
    tdp.register_executor("vvl_probe", _probe)
    old = tdp.default_vvl()
    yield
    tdp.set_default_vvl(old)
    tdp.unregister_executor("vvl_probe")


class TestVVLStaleness:
    """Two launches under different *default* VVLs never share a plan; an
    explicit VVL wins; the CUDA executors ignore the default."""

    def test_set_default_vvl_rebuilds_plan(self, vvl_probe):
        x = torch.zeros(1, 256)
        tdp.set_default_vvl(32)
        assert float(tdp.launch(chunk_width, "vvl_probe", x)[0, 0]) == 32.0
        tdp.set_default_vvl(64)
        assert float(tdp.launch(chunk_width, "vvl_probe", x)[0, 0]) == 64.0

    def test_explicit_vvl_wins_over_default(self, vvl_probe):
        tdp.set_default_vvl(32)
        y = tdp.launch(chunk_width, tdp.Target("vvl_probe", vvl=128),
                       torch.zeros(1, 256))
        assert float(y[0, 0]) == 128.0

    def test_legacy_shim_also_tracks_default(self, vvl_probe):
        x = torch.zeros(1, 256)
        tdp.set_default_vvl(32)
        a = _legacy(texe.launch, chunk_width.fn, None, [x],
                    backend="vvl_probe")
        tdp.set_default_vvl(64)
        b = _legacy(texe.launch, chunk_width.fn, None, [x],
                    backend="vvl_probe")
        assert float(a[0, 0]) == 32.0 and float(b[0, 0]) == 64.0

    def test_cuda_launch_ignores_the_default(self, vvl_probe):
        """A default outside CUDA_VVLS does not break a vvl=None "cuda"
        launch; an explicit one outside them is refused."""
        x = torch.ones(3, 10)
        tdp.set_default_vvl(3)
        assert torch.equal(tdp.launch(ex.SCALE_SPEC, "cuda", x, a=2.0),
                           2 * x)
        with pytest.raises(ValueError, match="vvl"):
            tdp.launch(ex.SCALE_SPEC, tdp.Target("cuda", vvl=3), x, a=2.0)


# ---------------------------------------------------------------------------
# execution, the site index, reductions
# ---------------------------------------------------------------------------

class TestExecution:
    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("vvl", VVLS)
    def test_scale_all_backends_vvls(self, backend, vvl, rng):
        """Single source × executors × VVLs against the reference's
        launch; 42 sites are ragged for VVL 4 and 8."""
        lat = tdp.Lattice((6, 7))
        jx, x = _both(rng, (3, lat.nsites))
        want = _legacy(jcore.launch, jscale, jcore.Lattice((6, 7)), [jx],
                       consts={"a": 2.5}, vvl=8)
        got = tdp.launch(ex.SCALE_SPEC, tdp.Target(backend, vvl=vvl), x,
                         lattice=lat, a=tdp.copy_constant_to_target(2.5))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_saxpy_multi_input(self, backend, rng):
        jx, x = _both(rng, (2, 32))
        jy, y = _both(rng, (2, 32))
        want = _legacy(jcore.launch, jsaxpy, jcore.Lattice((32,)), [jx, jy],
                       consts={"a": 3.0}, vvl=8)
        got = tdp.launch(ex.SAXPY_SPEC, tdp.Target(backend, vvl=2), x, y,
                         a=3.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)

    def test_multi_output(self, rng):
        jx, x = _both(rng, (1, 16))
        ja, jb = _legacy(jcore.launch, jtwo_out, jcore.Lattice((16,)), [jx],
                         out_ncomp=(1, 1), vvl=8)
        a, b = _legacy(texe.launch, two_out, tdp.Lattice((16,)), [x],
                       out_ncomp=(1, 1))
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6)

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("vvl", VVLS)
    def test_site_index_kernel(self, backend, vvl, rng):
        """``site_pos`` against the reference's ``with_site_index`` launch
        on the same input, 10 sites (ragged for VVL 4 and 8)."""
        @jcore.site_kernel
        def jpos(x, site_idx):
            return x + site_idx[None, :].astype(jnp.float32)

        jx, x = _both(rng, (2, 10))
        want = _legacy(jcore.launch, jpos, jcore.Lattice((10,)), [jx], vvl=4,
                       with_site_index=True)
        got = tdp.launch(ex.SITE_POS_SPEC, tdp.Target(backend, vvl=vvl), x)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        shim = _legacy(texe.launch, ex.site_pos_site, None, [x],
                       backend=backend, vvl=vvl, with_site_index=True)
        assert torch.equal(shim, got)

    def test_site_index_of_a_stencil_launch(self, rng):
        """Under "torch" a stencil spec with a site index gets the interior
        sites' indices."""
        spec = tdp.KernelSpec(lambda p, idx: p[0] + idx,
                              fields=(tdp.field(1, stencil=tdp.STENCIL_GRAD_6PT),),
                              out=1, site_index=True, name="grad_pos")
        phi = torch.zeros(1, 60)
        got = tdp.launch(spec, "torch", phi, lattice=tdp.Lattice((3, 4, 5)))
        assert torch.equal(got[0], torch.arange(60, dtype=torch.float32))

    def test_site_index_is_refused_where_the_kernel_has_none(self, rng):
        spec = tdp.KernelSpec(tst.stream_site_kernel,
                              fields=(tst.STREAM_SPEC.fields[0],), out=19,
                              site_index=True, name="stream_pos")
        f = torch.zeros(19, 27)
        with pytest.raises(ValueError, match="site index"):
            tdp.launch(spec, "cuda", f, lattice=tdp.Lattice((3, 3, 3)))
        no_idx = dataclasses.replace(ex.SITE_POS_SPEC, site_index=False)
        with pytest.raises(ValueError, match="needs a site index"):
            tdp.launch(no_idx, "cuda", torch.zeros(1, 4))

    def test_site_indices_are_32_bit(self):
        assert tapi.site_indices(5, "cpu").dtype == torch.int32
        with pytest.raises(ValueError, match="2\\^31"):
            tapi.site_indices(2 ** 31, "cpu")

    def test_target_const_array(self, rng):
        @tdp.site_kernel
        def project(x, w):
            return (torch.as_tensor(w)[:, None] * x).sum(0, keepdim=True)

        x = torch.from_numpy(rng.normal(size=(3, 12)).astype(np.float32))
        w = tdp.TargetConst(np.array([1.0, -1.0, 0.5], np.float32))
        y = _legacy(texe.launch, project, tdp.Lattice((12,)), [x],
                    out_ncomp=1, consts={"w": w})
        np.testing.assert_allclose(
            y[0].numpy(), (x.numpy() * np.array([1, -1, .5])[:, None]).sum(0),
            rtol=1e-6)

    def test_validation_errors(self):
        lat, x = tdp.Lattice((8,)), torch.zeros(1, 8)
        with pytest.raises(ValueError):
            _legacy(texe.launch, ex.scale_site, lat, [])
        with pytest.raises(ValueError):
            _legacy(texe.launch, ex.scale_site, lat, [torch.zeros(1, 9)])
        with pytest.raises(ValueError, match="unknown executor"):
            _legacy(texe.launch, ex.scale_site, lat, [x], backend="xla")
        with pytest.raises(ValueError, match="rank"):
            _legacy(texe.launch, ex.scale_site, None, [torch.zeros(8)])
        with pytest.raises(ValueError, match="scalar"):
            tdp.launch(ex.SCALE_SPEC, "cuda", x, a=torch.ones(1))
        with pytest.raises(NotImplementedError, match="__cuda_site__"):
            tdp.launch(tdp.KernelSpec(lambda x: x, fields=(1,)), "cuda", x)

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("op", ["sum", "max", "min"])
    def test_reduce(self, backend, op, rng):
        """35 sites against ``repro.core.execute.reduce`` (whose padding
        must not pollute the result) on the same input."""
        jx, x = _both(rng, (2, 35))
        want = jcore.reduce(jscale, jcore.Lattice((5, 7)), [jx],
                            consts={"a": 2.0}, op=op, vvl=16)
        got = tdp.reduce(ex.SCALE_SPEC, tdp.Lattice((5, 7)), [x],
                         consts={"a": 2.0}, op=op, target=backend)
        assert got.shape == (2,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
        plain = tdp.reduce(ex.scale_site, None, [x], consts={"a": 2.0},
                           op=op, backend=backend, vvl=4)
        np.testing.assert_allclose(plain.numpy(), np.asarray(want),
                                   rtol=1e-5)

    def test_reduce_multi_output_and_errors(self, rng):
        jx, x = _both(rng, (1, 33))
        ja, jb = jcore.reduce(jtwo_out, None, [jx], op="sum",
                              out_ncomp=(1, 1))
        a, b = tdp.reduce(two_out, None, [x], op="sum", out_ncomp=(1, 1))
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5)
        with pytest.raises(ValueError, match="op must be"):
            tdp.reduce(two_out, None, [x], op="mean")

    def test_reduce_on_cuda_launches_the_site_function(self, rng):
        """The spec's own body keeps its ``__cuda_site__``: on CPU tensors
        the "cuda" executor runs it, and no launch is counted."""
        before = dict(tdp_pointwise.launches)
        x = torch.from_numpy(rng.normal(size=(3, 40)).astype(np.float32))
        got = tdp.reduce(ex.SCALE_SPEC, None, [x], consts={"a": 2.0},
                         op="max", target=tdp.Target("cuda"))
        assert torch.equal(got, (2.0 * x).amax(-1))
        assert tdp_pointwise.launches == before

    @pytest.mark.parametrize("site", ["scale", "saxpy"])
    @pytest.mark.parametrize("op", ["sum", "max", "min"])
    def test_reduce_cuda_target_on_cpu_matches_reference(self, site, op,
                                                         rng):
        """``reduce`` under ``Target("cuda")`` on CPU tensors, and the
        one-pass reduce's plain version (``reduce(..., target="torch")``,
        the map plus a torch reduction), against
        ``repro.core.execute.reduce`` on 2053 sites: ragged against every
        block the kernel uses (256 threads × 8 sites a round) and every
        VVL.  The fields are all negative for max and all positive for
        min, so an identity of 0 at the ragged end would show.  The
        one-pass kernel itself takes only CUDA tensors."""
        n, sign = 2053, {"sum": 0.0, "max": -1.0, "min": 1.0}[op]
        pairs = []
        for _ in range(2 if site == "saxpy" else 1):
            x = rng.normal(size=(3, n)).astype(np.float32)
            if sign:
                x = sign * (1.0 + np.abs(x))
            pairs.append((jnp.asarray(x), torch.from_numpy(x.copy())))
        jxs, xs = [p[0] for p in pairs], [p[1] for p in pairs]
        jfn = jscale if site == "scale" else jsaxpy
        want = np.asarray(jcore.reduce(jfn, None, jxs, consts={"a": 0.5},
                                       op=op, vvl=16))
        spec = ex.SPECS[site]
        got = tdp.reduce(spec, None, xs, consts={"a": 0.5}, op=op,
                         target=tdp.Target("cuda", vvl=4))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
        plain = tdp.reduce(spec, None, xs, consts={"a": 0.5}, op=op,
                           target="torch")
        mapped = texe._map_reduce(spec, tdp.Target("cuda", vvl=2), xs, None,
                                  {"a": 0.5}, op)[0]
        for p in (plain, mapped):
            np.testing.assert_allclose(p.numpy(), want, rtol=1e-5)
        if op != "sum":
            assert torch.equal(got, plain) and torch.equal(mapped, plain)
            assert (got * sign > 0).all()
        plan = tapi.launch_plan(dataclasses.replace(spec, out=3),
                                tdp.Target("cuda"), consts={"a": 0.5})
        with pytest.raises(ValueError, match="CUDA tensors"):
            tdp_pointwise.example_reduce(plan, op, xs)

    def test_reduce_route_follows_the_rule(self):
        """The one-pass kernel exactly under a ``"cuda"`` target, SoA, on
        CUDA tensors, for an example site function; map plus a torch
        reduction for every other case (no card needed: the route is
        chosen from the device's type)."""
        cuda, cpu = torch.device("cuda"), torch.device("cpu")
        fused, mapped = texe._fused_reduce, texe._map_reduce
        route = texe.reduce_route
        for spec in ex.SPECS.values():
            assert route(spec, tdp.Target("cuda"), cuda) is fused
            assert route(spec, tdp.Target("cuda", vvl=8), "cuda:0") is fused
            assert route(spec, tdp.Target("cuda"), cpu) is mapped
            assert route(spec, tdp.Target("torch"), cuda) is mapped
            assert route(spec, tdp.Target("cuda", vvl=32, layout="aosoa"),
                         cuda) is mapped
        plain_body = tdp.KernelSpec(ex.scale_site, fields=(3,))
        assert route(plain_body, tdp.Target("cuda"), cuda) is fused
        for spec in (tst.STREAM_SPEC, tst.GRAD6_SPEC,
                     tdp.KernelSpec(lambda x: x, fields=(1,))):
            assert route(spec, tdp.Target("cuda"), cuda) is mapped
        assert route(tst.STREAM_SPEC, tdp.Target("cuda_windowed"),
                     cuda) is mapped


# ---------------------------------------------------------------------------
# the deprecated shims
# ---------------------------------------------------------------------------

class TestShimEquivalence:
    """launch / launch_stencil warn, then delegate — bit-identical."""

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_pointwise_bit_identical(self, backend, rng):
        lat = tdp.Lattice((6, 7))
        x = torch.from_numpy(rng.normal(size=(2, 42)).astype(np.float32))
        a = tdp.TargetConst(np.float32(1.5))
        new = tdp.launch(ex.SCALE_SPEC, tdp.Target(backend, vvl=2), x,
                         lattice=lat, a=a)
        old = _legacy(texe.launch, ex.SCALE_SPEC.fn, lat, [x],
                      consts={"a": a}, vvl=2, backend=backend)
        assert torch.equal(new, old)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_stencil_bit_identical(self, backend, rng):
        lat = tdp.Lattice((3, 4, 5))
        jphi, phi = _both(rng, (1, lat.nsites))
        gn, ln = tdp.launch(tst.GRAD6_SPEC, tdp.Target(backend, vvl=2), phi,
                            lattice=lat)
        go, lo = _legacy(texe.launch_stencil, tst.grad6_site_kernel, lat,
                         [phi], stencil=tdp.STENCIL_GRAD_6PT,
                         out_ncomp=(3, 1), vvl=2, backend=backend)
        assert torch.equal(gn, go) and torch.equal(ln, lo)
        jg, jl = _legacy(jcore.launch_stencil, jst.grad6_site_kernel,
                         jcore.Lattice((3, 4, 5)), [jphi],
                         stencil=jcore.STENCIL_GRAD_6PT, out_ncomp=(3, 1))
        np.testing.assert_allclose(go.numpy(), np.asarray(jg), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(lo.numpy(), np.asarray(jl), rtol=1e-6,
                                   atol=1e-7)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_stream_through_launch_stencil(self, backend, rng):
        """The D3Q19 pull stream, the reference's shim and the port's, with
        caller ghost planes in x (halo 1)."""
        lat = tdp.Lattice((4, 3, 5))
        n_ext = 6 * 3 * 5
        jf, f = _both(rng, (19, n_ext))
        want = _legacy(jcore.launch_stencil, jst.stream_site_kernel,
                       jcore.Lattice((4, 3, 5)), [jf],
                       stencil=jcore.STENCIL_D3Q19_PULL, out_ncomp=19,
                       halo=(1, 0, 0))
        got = _legacy(texe.launch_stencil, tst.stream_site_kernel, lat, [f],
                      stencil=tdp.STENCIL_D3Q19_PULL, out_ncomp=19,
                      halo=(1, 0, 0), backend=backend)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_shim_errors(self):
        lat = tdp.Lattice((2, 2, 2))
        x = torch.zeros(1, 8)
        with pytest.raises(ValueError, match="at least one input"):
            _legacy(texe.launch_stencil, ex.scale_site, lat, [],
                    stencil=tdp.STENCIL_GRAD_6PT)
        with pytest.raises(ValueError, match="lattice"):
            _legacy(texe.launch_stencil, ex.scale_site, None, [x],
                    stencil=tdp.STENCIL_GRAD_6PT)
        with pytest.raises(ValueError, match="stencils for"):
            _legacy(texe.launch_stencil, ex.scale_site, lat, [x],
                    stencil=[tdp.STENCIL_GRAD_6PT] * 2)
        with pytest.raises(ValueError, match="needs at least one Stencil"):
            _legacy(texe.launch_stencil, ex.scale_site, lat, [x],
                    stencil=[None])

    def test_shims_are_thin(self):
        for fn in (texe.launch, texe.launch_stencil):
            body = inspect.getsource(fn).split("stacklevel=2)", 1)[1]
            stmts = [ln for ln in body.splitlines()
                     if ln.strip() and not ln.strip().startswith("#")]
            assert len(stmts) <= 15, f"{fn.__name__} is not a thin shim"


# ---------------------------------------------------------------------------
# the surface, the configs, the examples
# ---------------------------------------------------------------------------

class TestSurface:
    def test_exports_and_what_waits(self):
        for name in tdp.__all__:
            assert hasattr(tdp, name), name
        for name in FLEET_NAMES:
            assert name in tdp.__all__ and name in tdp.__doc__, name
        for mod in ("fleet", "health", "faults"):
            assert getattr(tdp, mod).__name__ == f"repro_torch.core.{mod}"
        assert "Not ported yet" not in tdp.__doc__
        missing = set(jtdp.__all__) - set(tdp.__all__)
        assert missing == {"xla_executor"}
        # the plane_block axis of a windowed launch: the divisors of its
        # x-plane count, the reference's candidates where both tiles fit
        phys = dict(A=0.125, B=0.11, kappa=0.02, tau=0.9, tau_phi=1.1,
                    gamma=0.8)
        for spec, jspec in ((tst.STREAM_SPEC, jst.STREAM_SPEC),
                            (tst.FUSED_SPEC, jst.FUSED_SPEC)):
            consts = tlbp.collision_consts(**phys) if spec.consts else None
            jconsts = jlbp.collision_consts(**phys) if jspec.consts else None
            got = tdp.plane_block_candidates(
                spec, "cuda_windowed", tdp.Lattice((12, 4, 4)),
                consts=consts)
            want = jtdp.plane_block_candidates(
                jspec, "pallas_windowed", jtdp.Lattice((12, 4, 4)),
                consts=jconsts)
            assert got == want == ([1, 2, 3, 4, 6, 12], [])

    def test_core_exports_the_references_names(self):
        from repro_torch import core
        missing = set(jcore.__all__) - set(core.__all__)
        assert missing == set(), missing
        for name in FLEET_NAMES:
            assert getattr(core, name) is getattr(tdp, name), name
        assert core.tdp_launch is tdp.launch
        assert core.plane_block_candidates is tdp.plane_block_candidates
        for name in ("exchange_ghosts", "exchange_stats"):
            assert getattr(core, name) is getattr(tdp, name)

    @pytest.mark.parametrize("jax_state", ["unimportable", "importable"])
    def test_imports_leave_jax_out(self, jax_state):
        """With ``jax`` unimportable the surface still imports; with it
        importable, importing the surface leaves it out of
        ``sys.modules``."""
        poison = ("sys.modules['jax'] = None; sys.modules['repro'] = None; "
                  if jax_state == "unimportable" else "")
        code = ("import sys; " + poison +
                "from repro_torch import tdp; import repro_torch.core.memory; "
                "import repro_torch.examples.quickstart, "
                "repro_torch.examples.lb_spinodal, repro_torch.lb.baseline, "
                "repro_torch.examples.lb_fleet, repro_torch.checkpoint, "
                "repro_torch.configs.ludwig_lb, "
                "repro_torch.kernels.example_sites; "
                "assert sys.modules.get('jax') is None, 'jax imported'; "
                "assert sys.modules.get('repro') is None, 'repro imported'")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr


class TestLudwigConfigs:
    @pytest.mark.parametrize("name", ["BENCH", "SMOKE", "PRODUCTION"])
    def test_grids_and_params_are_the_references(self, name):
        a, b = getattr(ludwig_lb, name), getattr(jludwig, name)
        assert a.grid_shape == b.grid_shape
        assert dataclasses.asdict(a.params) == dataclasses.asdict(b.params)
        assert a.backend == "cuda" and a.vvl in tdp.CUDA_VVLS

    def test_vvl_is_one_the_kernels_take(self):
        with pytest.raises(ValueError, match="vvl"):
            ludwig_lb.LudwigConfig((8, 8, 8), vvl=128)


class TestExamples:
    def test_quickstart_on_the_cpu(self, capsys):
        r = quickstart.main(["--device", "cpu", "--grid", "8"])
        data = np.random.default_rng(0).normal(size=(3, 512))
        np.testing.assert_allclose(r["sum"],
                                   data.astype(np.float32).sum(-1),
                                   rtol=1e-5)
        assert r["backend"] == "torch" and "toy" in r["executors"]
        assert "toy" not in tdp.list_executors()
        assert "single source ran on every executor" in capsys.readouterr().out

    def test_quickstart_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            quickstart.main(["--grid", "4"])

    def test_spinodal_matches_the_reference(self):
        """20 steps at 8³ on the CPU, the reference's state carried across
        by ``from_reference``: the same start bits, mass to 1e-5, the end
        state at the port's trajectory bar."""
        jp = jparams.LBParams(A=0.125, B=0.125, kappa=0.02)
        jsm = jsim.BinaryFluidSim((8, 8, 8), params=jp)
        j0 = jsm.init_spinodal(seed=0, noise=0.05)
        st0, params = from_reference(np.asarray(j0.f), np.asarray(j0.g),
                                     dataclasses.asdict(jp), device="cpu")
        own0 = BinaryFluidSim((8, 8, 8), params, device="cpu").init_spinodal(
            seed=0, noise=0.05)
        assert torch.equal(st0.f, own0.f) and torch.equal(st0.g, own0.g)
        r = lb_spinodal.main(["--device", "cpu", "--grid", "8", "--steps",
                              "20", "--chunk", "10"])
        j20 = jsm.run(j0, 20)
        assert r["mass_drift"] <= 1e-5 and r["state"].step == 20
        np.testing.assert_allclose(r["state"].f.numpy(), np.asarray(j20.f),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["state"].g.numpy(), np.asarray(j20.g),
                                   rtol=2e-4, atol=2e-5)
        assert r["last"]["phi_var"] > r["first"]["phi_var"]

    @pytest.mark.parametrize("fused", ["one_launch", "two_launch"])
    def test_spinodal_fused_on_the_windowed_executor(self, fused):
        """``--backend cuda_windowed --fused`` on CPU tensors (the plain
        versions) agrees with the unfused ``"torch"`` run."""
        base = lb_spinodal.main(["--device", "cpu", "--grid", "8",
                                 "--steps", "20", "--chunk", "10"])
        r = lb_spinodal.main(["--device", "cpu", "--grid", "8", "--steps",
                              "20", "--chunk", "10", "--backend",
                              "cuda_windowed", "--fused", fused])
        assert "cuda_windowed" in r["executors"]
        assert r["mass_drift"] <= 1e-5
        for fld in ("f", "g"):
            torch.testing.assert_close(getattr(r["state"], fld),
                                       getattr(base["state"], fld),
                                       rtol=2e-4, atol=2e-5)

    def test_spinodal_help_names_what_waits(self, capsys):
        with pytest.raises(SystemExit):
            lb_spinodal.parse_args(["--help"])
        out = " ".join(capsys.readouterr().out.split())
        assert "--donate has no PyTorch" in out
        assert "--mesh NxM[xK]" in out and "--overlap" in out
        args = lb_spinodal.parse_args(["--mesh", "2x2", "--overlap"])
        assert (args.mesh, args.overlap) == ("2x2", True)

    def test_ludwig_smoke_runs_as_configured(self):
        cfg = ludwig_lb.SMOKE
        sim = BinaryFluidSim(cfg.grid_shape, cfg.params,
                             target=tdp.Target(cfg.backend, vvl=cfg.vvl),
                             device="cpu")
        st = sim.run(sim.init_spinodal(seed=1), 2)
        assert not sim.observables(st)["nan"]
        assert isinstance(LBParams(), type(cfg.params))
