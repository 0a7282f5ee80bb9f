"""Per-spec launch parity: the port's executors against the JAX package.

Each of the seven LB specs is launched at 8³ from the same numpy inputs
through the port (``"torch"``, ``"cuda"`` and, for stencil specs,
``"cuda_windowed"`` — on CPU tensors the CUDA executors run their plain
version behind their own prologue) and through the reference (``"xla"``,
and ``"pallas_windowed_interpret"`` for the stencil specs).

Tolerances: ``STREAM_SPEC`` is a pure copy and must be bit-exact; the
others are held at ``rtol=1e-5, atol=1e-6`` because the two packages'
einsum implementations contract the (19, 3) products in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.api as japi
import repro.lb.programs as jprog
import repro.lb.stencil as jst
import repro_torch.lb.programs as tprog
import repro_torch.lb.stencil as tst
from repro_torch.core import (
    KernelSpec,
    Lattice,
    Target,
    field,
    launch,
    launch_plan,
)
from repro_torch.kernels import tdp_pointwise, tdp_windowed

SHAPE = (8, 8, 8)
NAMES = ("stream", "grad6", "moment", "collide", "fused", "phi_stream",
         "fused_two")
STENCIL_NAMES = tuple(n for n in NAMES if tst.SPECS[n].has_stencil)
PHYS = dict(A=0.125, B=0.11, kappa=0.02, tau=0.9, tau_phi=1.1, gamma=0.8)

_REF_CACHE = {}


def _inputs(name):
    """Numpy inputs for spec ``name``: populations near equilibrium, small
    order parameter and gradients."""
    rng = np.random.default_rng(NAMES.index(name))
    n = int(np.prod(SHAPE))
    out = []
    for fs in tst.SPECS[name].fields:
        x = 0.05 * rng.normal(size=(fs.ncomp, n))
        if fs.name == "f":
            x = x + 1.0 / 19.0
        out.append(x.astype(np.float32))
    return out


def _reference(name, ref_target):
    key = (name, ref_target)
    if key not in _REF_CACHE:
        spec = _JAX_SPECS[name]
        consts = jprog.collision_consts(**PHYS) if spec.consts else {}
        tgt = (jcore.Target("xla", vvl=64) if ref_target == "xla"
               else jcore.Target(ref_target))
        outs = japi.launch(spec, tgt, *map(jnp.asarray, _inputs(name)),
                           lattice=jcore.Lattice(SHAPE), consts=consts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        _REF_CACHE[key] = [np.asarray(o) for o in outs]
    return _REF_CACHE[key]


_JAX_SPECS = {"stream": jst.STREAM_SPEC, "grad6": jst.GRAD6_SPEC,
              "moment": jst.MOMENT_SPEC, "collide": jst.COLLIDE_SPEC,
              "fused": jst.FUSED_SPEC, "phi_stream": jst.PHI_STREAM_SPEC,
              "fused_two": jst.FUSED_TWO_SPEC}


def _port(name, target):
    spec = tst.SPECS[name]
    consts = tprog.collision_consts(**PHYS) if spec.consts else {}
    outs = launch(spec, target, *map(torch.from_numpy, _inputs(name)),
                  lattice=Lattice(SHAPE), consts=consts)
    return outs if isinstance(outs, tuple) else (outs,)


def _compare(name, port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert tuple(a.shape) == b.shape
        if name == "stream":
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


_CASES = ([(n, t, "xla") for n in NAMES for t in ("torch", "cuda")]
          + [(n, "cuda_windowed", "xla") for n in STENCIL_NAMES]
          + [(n, t, "pallas_windowed_interpret") for n in STENCIL_NAMES
             for t in ("torch", "cuda", "cuda_windowed")])


@pytest.mark.parametrize("name,port_target,ref_target", _CASES)
def test_spec_matches_reference(name, port_target, ref_target):
    _compare(name, _port(name, port_target), _reference(name, ref_target))


def test_jax_spec_table_matches():
    for name, spec in _JAX_SPECS.items():
        assert spec.fn.__name__ == tst.SPECS[name].fn.__name__
        assert spec.out == tst.SPECS[name].out


@pytest.mark.parametrize("name", ("stream", "fused_two"))
def test_caller_ghosts_match_reference(name):
    """Stencil launches over caller-filled ghost planes (halo 1 in x)."""
    spec_t, spec_j = tst.SPECS[name], _JAX_SPECS[name]
    rng = np.random.default_rng(7)
    halo = (1, 0, 0)
    n_ext = (SHAPE[0] + 2) * SHAPE[1] * SHAPE[2]
    xs = [(0.05 * rng.normal(size=(fs.ncomp, n_ext)) + 0.05).astype(np.float32)
          for fs in spec_t.fields]
    cj = jprog.collision_consts(**PHYS) if spec_j.consts else {}
    ct = tprog.collision_consts(**PHYS) if spec_t.consts else {}
    ref = japi.launch(spec_j, jcore.Target("xla", vvl=64),
                      *map(jnp.asarray, xs), lattice=jcore.Lattice(SHAPE),
                      halo=halo, consts=cj)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for tgt in ("torch", "cuda", "cuda_windowed"):
        out = launch(spec_t, tgt, *map(torch.from_numpy, xs),
                     lattice=Lattice(SHAPE), halo=halo, consts=ct)
        out = out if isinstance(out, tuple) else (out,)
        _compare(name, out, [np.asarray(r) for r in ref])


class TestLaunchSurface:
    def test_out_buffers_are_written(self):
        x = torch.from_numpy(_inputs("moment")[0])
        buf = torch.empty((1, x.shape[1]))
        for tgt in ("torch", "cuda"):
            got = launch(tst.MOMENT_SPEC, tgt, x, out=buf)
            assert got.data_ptr() == buf.data_ptr()
            torch.testing.assert_close(buf, x.sum(0, keepdim=True))
        with pytest.raises(ValueError, match="out buffer"):
            launch(tst.MOMENT_SPEC, "torch", x, out=torch.empty((2, 5)))

    def test_validation_errors(self):
        x = torch.zeros((19, 512))
        with pytest.raises(ValueError, match="missing a lattice"):
            launch(tst.STREAM_SPEC, "torch", x)
        with pytest.raises(ValueError, match="ncomp=19"):
            launch(tst.STREAM_SPEC, "torch", torch.zeros((3, 512)),
                   lattice=Lattice(SHAPE))
        xs = [torch.from_numpy(a) for a in _inputs("collide")]
        with pytest.raises(ValueError, match="does not declare const"):
            launch(tst.COLLIDE_SPEC, "torch", *xs, bogus=1.0)
        with pytest.raises(ValueError, match="halo_extended"):
            launch(tst.MOMENT_SPEC, "cuda_windowed", x)
        with pytest.raises(ValueError, match="unknown executor"):
            launch(tst.MOMENT_SPEC, "nope", x)
        with pytest.raises(TypeError, match="torch.Tensor"):
            launch(tst.MOMENT_SPEC, "torch", np.zeros((19, 4), np.float32))

    def test_hbm_estimate_drops_the_gather(self):
        lat = Lattice(SHAPE)
        g = launch_plan(tst.FUSED_SPEC, "cuda", lattice=lat)
        w = launch_plan(tst.FUSED_SPEC, "cuda_windowed", lattice=lat)
        n = lat.nsites
        assert g.hbm_bytes_estimate() == (19 * 19 + 57 * 19 + 38) * n * 4
        assert w.hbm_bytes_estimate() == (19 * 10 ** 3 + 19 * 12 ** 3
                                          + 38 * n) * 4


class TestNoFallback:
    """The CUDA executors raise where they have no kernel — never a quiet
    detour through the plain version."""

    def test_spec_without_cuda_site_raises(self):
        spec = KernelSpec(lambda x: 2.0 * x, fields=(field(1),), out=1,
                          name="double")
        x = torch.ones((1, 16))
        torch.testing.assert_close(launch(spec, "torch", x), 2.0 * x)
        with pytest.raises(NotImplementedError, match="double"):
            launch(spec, "cuda", x)

    @pytest.mark.parametrize("backend", ["cuda", "cuda_windowed"])
    def test_vvl_outside_kernel_set_raises(self, backend):
        with pytest.raises(ValueError, match="vvl"):
            launch(tst.STREAM_SPEC, Target(backend, vvl=16),
                   torch.zeros((19, 512)), lattice=Lattice(SHAPE))

    def test_foreign_collision_tables_raise(self):
        consts = tprog.collision_consts(**PHYS)
        consts["w"] = np.full(19, 1.0 / 19.0, np.float32)
        xs = [torch.from_numpy(x) for x in _inputs("collide")]
        launch(tst.COLLIDE_SPEC, "torch", *xs, consts=consts)
        with pytest.raises(ValueError, match="D3Q19"):
            launch(tst.COLLIDE_SPEC, "cuda", *xs, consts=consts)

    def test_launch_counters_untouched_on_cpu(self):
        before = (dict(tdp_pointwise.launches), dict(tdp_windowed.launches))
        _port("stream", "cuda")
        _port("stream", "cuda_windowed")
        assert (tdp_pointwise.launches, tdp_windowed.launches) == before


class TestFieldContract:
    """The card's executors (``takes_fields=True``) get the caller's own
    stencil fields, viewed over the lattice and its ghost planes: no
    gather, no padded copy, and the same periodic-extent guard as
    ``halo_extend``."""

    @pytest.mark.parametrize("halo", [(0, 0, 0), (2, 0, 3)])
    def test_executor_sees_the_callers_storage(self, halo):
        from repro_torch.core import register_executor, unregister_executor

        seen = []

        def spy(plan, fields, out=None):
            seen.append(fields)
            return tdp_pointwise.fields_plain(plan, fields, out)

        register_executor("_spy_fields", spy, takes_fields=True)
        try:
            ext = tuple(s + 2 * h for s, h in zip(SHAPE, halo))
            rng = np.random.default_rng(3)
            xs = [torch.tensor(rng.normal(size=(19, int(np.prod(ext)))),
                               dtype=torch.float32) for _ in range(2)]
            got = launch(tst.FUSED_SPEC, "_spy_fields", *xs,
                         lattice=Lattice(SHAPE), halo=halo,
                         consts=tprog.collision_consts(**PHYS))
            want = launch(tst.FUSED_SPEC, "torch", *xs,
                          lattice=Lattice(SHAPE), halo=halo,
                          consts=tprog.collision_consts(**PHYS))
        finally:
            unregister_executor("_spy_fields")
        (fields,) = seen
        for x, f in zip(xs, fields):
            assert f.shape == (19, *ext)
            assert f.data_ptr() == x.data_ptr()
        for a, b in zip(got, want):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("backend", ["cuda", "cuda_windowed"])
    def test_radius_past_a_periodic_extent_raises(self, backend):
        xs = [torch.zeros((19, 4 * 1 * 4)) for _ in range(2)]
        with pytest.raises(ValueError, match="exceeds the periodic extent"):
            launch(tst.FUSED_SPEC, backend, *xs, lattice=Lattice((4, 1, 4)),
                   consts=tprog.collision_consts(**PHYS))

    def test_tile_past_the_block_raises_window_vmem_error(self):
        from repro_torch.core import WindowVmemError
        from repro_torch.core.costmodel import DEFAULT_VMEM_LIMIT

        lat = Lattice((200, 8, 8))
        consts = tprog.collision_consts(**PHYS)
        tgt = Target("cuda_windowed", tuning={"plane_block": 169})
        plan = launch_plan(tst.FUSED_SPEC, tgt, lattice=lat, consts=consts)
        assert plan.vmem_bytes_estimate() == 4 * 171 * 10 * 34
        assert plan.vmem_bytes_estimate() > DEFAULT_VMEM_LIMIT
        xs = [torch.zeros((19, lat.nsites)) for _ in range(2)]
        with pytest.raises(WindowVmemError, match="plane_block=169"):
            launch(tst.FUSED_SPEC, tgt, *xs, lattice=lat, consts=consts)
        ok = tgt.with_tuning(plane_block=168)
        assert launch_plan(tst.FUSED_SPEC, ok, lattice=lat,
                           consts=consts).vmem_bytes_estimate() \
            <= DEFAULT_VMEM_LIMIT
        # the other site functions stage nothing, whatever plane_block says
        assert launch_plan(tst.STREAM_SPEC, tgt,
                           lattice=lat).vmem_bytes_estimate() == 0
        assert launch_plan(tst.FUSED_SPEC, "cuda", lattice=lat,
                           consts=consts).vmem_bytes_estimate() == 0

    @pytest.mark.parametrize("bad", [0, -2, 2.5, True])
    def test_plane_block_must_be_a_positive_int(self, bad):
        tgt = Target("cuda_windowed", tuning={"plane_block": bad})
        xs = [torch.zeros((19, 512)) for _ in range(2)]
        with pytest.raises(ValueError, match="plane_block"):
            launch(tst.FUSED_SPEC, tgt, *xs, lattice=Lattice(SHAPE),
                   consts=tprog.collision_consts(**PHYS))

    def test_plane_block_is_a_declared_tunable(self):
        from repro_torch.core import executor_tunables

        assert executor_tunables("cuda_windowed") == ("plane_block",)
        assert executor_tunables("cuda") == ()
