"""The AoSoA layout of the port (``Target(layout="aosoa")``), held to the
reference's ``tests/test_layout.py`` and to ``repro.core.layout``.

Pinned here, on the CPU (inputs from numpy with a seed):

* the transforms equal the reference's, round-trip exactly for every
  extent and zero their pad lanes; the index map the kernels apply reads
  the same values;
* the mixed stencil + pointwise + ``site_index`` + two-output spec is bit-
  identical across layouts on ``"torch"`` and on the plain versions of
  ``"cuda"`` and ``"cuda_windowed"`` (the AoSoA operands read through the
  index map), at every valid width, ``plane_block`` and with padded
  halo-widened planes, and within float32 rounding of the reference's
  ``"xla"`` executor under AoSoA;
* a 16³ ``one_launch`` trajectory of 10 steps under AoSoA is held to the
  reference's at ``rtol=2e-4, atol=2e-5``, and every LB regime is bit-
  identical across layouts;
* ``rmsnorm``, ``gated_act`` and ``mamba_scan`` are bit-identical across
  layouts and held to ``repro.kernels.ref``, in float32 and in bfloat16
  (there held to the reference's Pallas executor under AoSoA in interpret
  mode, within one bfloat16 step);
* the named ``ValueError``s, the doubled ``hbm_bytes_estimate`` and its
  byte term in ``costmodel.predict``, and the tuner's layout axis.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import layout as jlayout
from repro.core.api import launch as jlaunch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import (FieldSpec, KernelSpec, Lattice, Stencil, Target,
                              aosoa_nblocks, aosoa_to_soa, as_target,
                              costmodel, launch, launch_plan, soa_to_aosoa)
from repro_torch.core.autotune import (Candidate, _vvl_values, autotune,
                                       default_space)
from repro_torch.core.layout import (LAYOUTS, aosoa_gather, plane_from_aosoa,
                                     plane_to_aosoa)
from repro_torch.kernels import ops
from repro_torch.kernels.tdp_pointwise import (aosoa_operands, aosoa_plain,
                                               fields_plain)

D3Q7_OFFSETS = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                (0, 0, 1), (0, 0, -1))
D3Q7 = Stencil("d3q7", D3Q7_OFFSETS)
PROFILE = costmodel.MachineProfile.default("cpu:cpu")


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

class TestTransforms:
    @pytest.mark.parametrize("shape", [(1, 7), (3, 100), (2, 128),
                                       (5, 3, 100), (19, 1, 31)])
    @pytest.mark.parametrize("vvl", [1, 4, 7, 128])
    def test_round_trip_exact_and_the_references(self, shape, vvl):
        x = _f32(_rng(7), shape)
        y = soa_to_aosoa(torch.from_numpy(x), vvl)
        assert y.shape[0] == aosoa_nblocks(shape[-1], vvl)
        assert y.shape[-1] == vvl and y.is_contiguous()
        np.testing.assert_array_equal(
            y.numpy(), np.asarray(jlayout.soa_to_aosoa(jnp.asarray(x), vvl)))
        np.testing.assert_array_equal(aosoa_to_soa(y, shape[-1]).numpy(), x)

    def test_remainder_lanes_zero_padded(self):
        y = soa_to_aosoa(torch.from_numpy(_f32(_rng(1), (2, 5))), 4)
        assert tuple(y.shape) == (2, 2, 4)
        assert torch.equal(y[1, :, 1:], torch.zeros(2, 3))

    def test_aosoa_block_is_contiguous_tile(self):
        """y[b, c, l] == x[c, b·vvl + l]: [site-block][component][lane]."""
        x = torch.from_numpy(_f32(_rng(2), (3, 12)))
        y = soa_to_aosoa(x, 4)
        for b in range(3):
            for c in range(3):
                assert torch.equal(y[b, c], x[c, b * 4:(b + 1) * 4])

    def test_plane_round_trip_and_divisibility(self):
        x = _f32(_rng(3), (3, 6, 4, 8))
        y = plane_to_aosoa(torch.from_numpy(x), 8)
        assert tuple(y.shape) == (6, 4, 3, 8)
        np.testing.assert_array_equal(
            y.numpy(), np.asarray(jlayout.plane_to_aosoa(jnp.asarray(x), 8)))
        np.testing.assert_array_equal(plane_from_aosoa(y, (4, 8)).numpy(), x)
        with pytest.raises(ValueError, match="not divisible"):
            plane_to_aosoa(torch.from_numpy(x), 7)

    @pytest.mark.parametrize("vvl", [1, 3, 16, 64])
    def test_index_map_reads_what_the_transform_wrote(self, vvl):
        """``aosoa_gather`` (the kernels' map) reads every site of every
        component back, pad lanes never."""
        x = torch.from_numpy(_f32(_rng(4), (5, 50)))
        y = soa_to_aosoa(x, vvl)
        assert torch.equal(aosoa_gather(y, torch.arange(50)), x)
        e = torch.tensor([[49, 0], [7, 13]])
        assert torch.equal(aosoa_gather(y, e), x[:, e])

    def test_layout_validated_on_target(self):
        assert LAYOUTS == jlayout.LAYOUTS
        with pytest.raises(ValueError, match="layout"):
            Target("cuda", layout="aos")
        assert as_target("cuda", layout="aosoa").layout == "aosoa"
        assert Target("cuda").layout == "soa"
        t = Target("cuda", vvl=32, layout="aosoa", tuning={"plane_block": 2})
        assert t.with_(vvl=16).layout == "aosoa"
        assert t.replace(backend="torch").layout == "aosoa"
        assert t.with_tuning(plane_block=4).tune("plane_block") == 4


# ---------------------------------------------------------------------------
# executor bit-identity
# ---------------------------------------------------------------------------

def _mixed_spec():
    def body(f_nb, rho, idx, *, alpha, w):
        # stencil (7, 2, n), pointwise (1, n), site index (n,)
        acc = (f_nb * torch.as_tensor(w).reshape(-1, 1, 1)).sum(0)
        return alpha * acc + rho + (idx % 3).to(acc.dtype), acc[:1] - rho

    return KernelSpec(body, fields=(FieldSpec(2, stencil=D3Q7, name="f"),
                                    FieldSpec(1, name="rho")),
                      out=(2, 1), site_index=True, consts=("alpha", "w"),
                      name="mixed_layout")


def _jmixed_spec():
    def body(f_nb, rho, idx, *, alpha, w):
        acc = (f_nb * w.reshape(-1, 1, 1)).sum(axis=0)
        return (alpha * acc + rho + (idx % 3).astype(acc.dtype),
                acc[:1] - rho)

    return jcore.KernelSpec(
        body, fields=(jcore.FieldSpec(2, stencil=jcore.Stencil(
            "d3q7", D3Q7_OFFSETS), name="f"), jcore.FieldSpec(1, name="rho")),
        out=(2, 1), site_index=True, consts=("alpha", "w"),
        name="mixed_layout")


def _mixed_inputs(shape, halo=(0, 0, 0), seed=5):
    rng = _rng(seed)
    n = int(np.prod(shape))
    n_ext = int(np.prod([s + 2 * h for s, h in zip(shape, halo)]))
    return (_f32(rng, (2, n_ext)), _f32(rng, (1, n)), _f32(rng, (7,)))


def _plain(windowed, shape, halo, W, plane_block=None):
    """The plain version of a CUDA executor on the mixed spec, SoA and
    AoSoA, from the operands the kernels get."""
    f, r, w = _mixed_inputs(shape, halo)
    spec = _mixed_spec()
    ext = tuple(s + 2 * h for s, h in zip(shape, halo))
    fields = (torch.from_numpy(f).view(2, *ext), torch.from_numpy(r))
    backend = "cuda_windowed" if windowed else "cuda"
    tuning = {} if plane_block is None else {"plane_block": plane_block}
    kw = dict(lattice=Lattice(shape), halo=halo,
              consts={"alpha": 1.5, "w": w})
    soa = fields_plain(launch_plan(spec, Target(backend, tuning=tuning),
                                   **kw), fields)
    plan = launch_plan(spec, Target(backend, vvl=W, layout="aosoa",
                                    tuning=tuning), **kw)
    got = aosoa_plain(plan, aosoa_operands(plan, fields, windowed),
                      int(np.prod(shape)), windowed)
    return soa, got


class TestExecutorBitIdentity:
    @pytest.mark.parametrize("vvl", [32, 60, 128])
    def test_torch_layouts_identical(self, vvl):
        """Any width (remainder blocks padded): mixed stencil + pointwise +
        consts + site index + two outputs."""
        lat = Lattice((4, 6, 5))
        f, r, w = _mixed_inputs(lat.shape)
        outs = {lay: launch(_mixed_spec(), Target("torch", vvl=vvl,
                                                  layout=lay),
                            torch.from_numpy(f), torch.from_numpy(r),
                            lattice=lat, consts={"alpha": 1.5, "w": w})
                for lay in LAYOUTS}
        for a, b in zip(outs["soa"], outs["aosoa"]):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("vvl", [32, 60, 128])
    def test_cuda_plain_layouts_identical(self, vvl):
        soa, got = _plain(False, (4, 6, 5), (0, 0, 0), vvl)
        for a, b in zip(soa, got):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("vvl", [8, 16, 32])
    @pytest.mark.parametrize("plane_block", [1, 2, 4])
    def test_windowed_plain_layouts_identical(self, vvl, plane_block):
        """Every width dividing the 32-site interior plane, every tile
        depth."""
        soa, got = _plain(True, (8, 8, 4), (0, 0, 0), vvl, plane_block)
        for a, b in zip(soa, got):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("windowed,vvl", [(True, 8), (False, 7)])
    def test_ghost_planes_padded_to_whole_blocks(self, windowed, vvl):
        """Caller ghost planes: the windowed operand's 6 x 10 = 60-site
        extended planes pad to 64 at vvl 8; the gathered one's flat grid
        pads its last block."""
        soa, got = _plain(windowed, (6, 4, 8), (0, 1, 1), vvl)
        for a, b in zip(soa, got):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("backend,vvl", [("torch", 60),
                                             ("cuda_windowed", 16)])
    def test_matches_reference_xla_under_aosoa(self, backend, vvl):
        """Against the reference's ``"xla"`` executor under AoSoA, within
        float32 rounding (the two frameworks sum the 7 offsets in their own
        order)."""
        lat = Lattice((6, 4, 8))
        f, r, w = _mixed_inputs(lat.shape)
        want = jlaunch(_jmixed_spec(), jcore.Target(
            "xla", vvl=64, layout="aosoa"), jnp.asarray(f), jnp.asarray(r),
            lattice=jcore.Lattice((6, 4, 8)),
            consts={"alpha": 1.5, "w": jnp.asarray(w)})
        if backend == "torch":
            got = launch(_mixed_spec(), Target(backend, vvl=vvl,
                                               layout="aosoa"),
                         torch.from_numpy(f), torch.from_numpy(r),
                         lattice=lat, consts={"alpha": 1.5, "w": w})
        else:
            _, got = _plain(True, (6, 4, 8), (0, 0, 0), vvl)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# the LB trajectory
# ---------------------------------------------------------------------------

PARAMS = dict(A=0.125, B=0.125, kappa=0.02)
_REF = {}


def _ref_one_launch():
    """The reference's 16³ one_launch trajectory, 10 steps (computed once
    per module)."""
    if not _REF:
        import repro.lb.params as jparams
        import repro.lb.sim as jsim
        sim = jsim.BinaryFluidSim((16, 16, 16),
                                  params=jparams.LBParams(**PARAMS),
                                  fused="one_launch")
        st = sim.step(sim.init_spinodal(seed=3, noise=0.05), 10)
        _REF["one_launch"] = (np.asarray(st.f), np.asarray(st.g))
    return _REF["one_launch"]


def _sim(fused, target=None):
    from repro_torch.lb.params import LBParams
    from repro_torch.lb.sim import BinaryFluidSim
    return BinaryFluidSim((16, 16, 16), LBParams(**PARAMS), fused=fused,
                          target=target, device="cpu")


class TestLBTrajectory:
    @pytest.mark.parametrize("target", [
        Target("cuda_windowed", vvl=32, layout="aosoa"),
        Target("cuda", vvl=64, layout="aosoa"),
        Target("torch", vvl=100, layout="aosoa")], ids=lambda t: t.backend)
    def test_one_launch_matches_reference(self, target):
        sim = _sim("one_launch", target)
        st = sim.step(sim.init_spinodal(seed=3, noise=0.05), 10)
        rf, rg = _ref_one_launch()
        np.testing.assert_allclose(st.f.numpy(), rf, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(st.g.numpy(), rg, rtol=2e-4, atol=2e-5)

    @pytest.mark.parametrize("fused,backend", [
        (False, "cuda"), ("one_launch", "cuda_windowed"),
        ("two_launch", "cuda_windowed")])
    def test_regimes_identical_across_layouts(self, fused, backend):
        st0 = _sim(fused).init_spinodal(seed=3, noise=0.05)
        a = _sim(fused, Target(backend)).run(st0, 5)
        b = _sim(fused, Target(backend, vvl=32, layout="aosoa")).run(st0, 5)
        assert torch.equal(a.f, b.f) and torch.equal(a.g, b.g)


# ---------------------------------------------------------------------------
# the LM site functions
# ---------------------------------------------------------------------------

BACKENDS = ("torch", "cuda")     # "cuda" on CPU tensors: the plain version


def _targets(backend, vvl):
    """The SoA target (the executor's default VVL) and the AoSoA one."""
    return Target(backend), Target(backend, vvl=vvl, layout="aosoa")


#: below this, bfloat16 outputs are held absolutely (float32's own error
#: where a result cancels: gelu's tail)
BF16_ATOL = 1e-5
BF = torch.bfloat16


def assert_within_bf16_step(got, want):
    """``got`` within one bfloat16 step of ``want`` (the spacing at
    ``want``, 2^-8 relative) or :data:`BF16_ATOL`: two float32 results a
    few ulps apart round to neighbouring bfloat16 values at most."""
    g = torch.as_tensor(np.asarray(got, np.float32))
    w = torch.as_tensor(np.asarray(want, np.float32))
    assert torch.isfinite(g).all()
    exp = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    bar = torch.exp2(exp - 7).clamp_min(BF16_ATOL)
    assert bool(((g - w).abs() <= bar).all()), float(((g - w).abs() / bar).max())


def _bf16(rng, shape, scale=1.0):
    """Seeded values rounded to bfloat16 once: (torch, jax) twins."""
    t = torch.from_numpy(_f32(rng, shape, scale)).to(BF)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _jtarget(vvl):
    """The reference's Pallas executor in interpret mode under AoSoA."""
    return jcore.Target("pallas_interpret", vvl=vvl, layout="aosoa")


class TestLMKernels:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_rmsnorm_layouts_identical(self, backend):
        rng = _rng(7)
        x, w = _f32(rng, (100, 64)), _f32(rng, (64,))
        outs = [ops.rmsnorm(x, w, target=t, device="cpu")
                for t in _targets(backend, 32)]
        assert torch.equal(outs[0], outs[1])
        np.testing.assert_allclose(
            outs[1].numpy(), np.asarray(jref.rmsnorm_ref(jnp.asarray(x),
                                                          jnp.asarray(w))),
            rtol=2e-4, atol=2e-5)

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2"])
    def test_gated_act_layouts_identical(self, backend, kind):
        rng = _rng(8)
        u = _f32(rng, (33, 48))
        v = None if kind == "relu2" else _f32(rng, (33, 48))
        outs = [ops.gated_act(u, v, kind=kind, device="cpu", target=t)
                for t in _targets(backend, 96)]
        assert torch.equal(outs[0], outs[1])
        want = jref.gated_act_ref(jnp.asarray(u), None if v is None
                                  else jnp.asarray(v), kind=kind)
        np.testing.assert_allclose(outs[1].numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_mamba_scan_layouts_identical(self, backend):
        rng = _rng(9)
        batch, length, d_inner, n = 2, 24, 48, 8
        x = _f32(rng, (batch, length, d_inner))
        dt = np.abs(_f32(rng, (batch, length, d_inner), 0.1))
        b, c = _f32(rng, (batch, length, n)), _f32(rng, (batch, length, n))
        a = -np.abs(_f32(rng, (d_inner, n)))
        d = _f32(rng, (d_inner,))
        got = {t.layout: ops.mamba_scan(x, dt, b, c, a, d, device="cpu",
                                        target=t)
               for t in _targets(backend, 16)}
        for u, v in zip(got["soa"], got["aosoa"]):
            assert torch.equal(u, v)
        y_ref, h_ref = jref.mamba_scan_ref(*(jnp.asarray(t) for t in
                                             (x, dt, b, c, a, d)))
        np.testing.assert_allclose(got["aosoa"][0].numpy(), np.asarray(y_ref),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got["aosoa"][1].numpy(), np.asarray(h_ref),
                                   rtol=2e-4, atol=2e-4)

    # bfloat16 under AoSoA: bit for bit the bfloat16 SoA launch (the AoSoA
    # plain version reads the same values through the index map) and within
    # one bfloat16 step of the reference's Pallas executor under AoSoA in
    # interpret mode (its mamba h is bfloat16 there, the port's float32:
    # ROADMAP §C)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_rmsnorm_bf16_layouts_identical(self, backend):
        rng = _rng(17)
        (x, xj), (w, wj) = _bf16(rng, (100, 64), 2.0), _bf16(rng, (64,), 0.5)
        outs = [ops.rmsnorm(x, w, scale_offset=1.0, target=t, device="cpu")
                for t in _targets(backend, 32)]
        assert outs[1].dtype == BF and torch.equal(outs[0], outs[1])
        want = jops.rmsnorm(xj, wj, scale_offset=1.0, target=_jtarget(32))
        assert_within_bf16_step(outs[1].float(), want)

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2"])
    @pytest.mark.parametrize("gated", [True, False])
    def test_gated_act_bf16_layouts_identical(self, backend, kind, gated):
        rng = _rng(18)
        u, uj = _bf16(rng, (33, 48), 3.0)
        v, vj = _bf16(rng, (33, 48)) if gated else (None, None)
        outs = [ops.gated_act(u, v, kind=kind, device="cpu", target=t)
                for t in _targets(backend, 96)]
        assert outs[1].dtype == BF and torch.equal(outs[0], outs[1])
        want = jops.gated_act(uj, vj, kind=kind, target=_jtarget(96))
        assert_within_bf16_step(outs[1].float(), want)

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("W", [16, 12])
    def test_mamba_scan_bf16_layouts_identical(self, backend, W):
        """x, dt, b, c bfloat16, a and d float32; W 12 puts a bfloat16
        block's channels at 8-byte (not 16-byte) offsets, as the card's
        stage copies them."""
        rng = _rng(19)
        batch, length, d_inner, n = 2, 24, 48, 8
        x, xj = _bf16(rng, (batch, length, d_inner))
        dt = torch.nn.functional.softplus(
            torch.from_numpy(_f32(rng, (batch, length, d_inner)))).to(BF)
        dtj = jnp.asarray(dt.float().numpy()).astype(jnp.bfloat16)
        (b, bj), (c, cj) = (_bf16(rng, (batch, length, n)),
                            _bf16(rng, (batch, length, n)))
        a = -np.exp(_f32(rng, (d_inner, n)))
        d = _f32(rng, (d_inner,))
        got = {t.layout: ops.mamba_scan(x, dt, b, c, torch.from_numpy(a),
                                        torch.from_numpy(d), device="cpu",
                                        target=t)
               for t in _targets(backend, W)}
        y, h = got["aosoa"]
        assert y.dtype == BF and h.dtype == torch.float32
        for u, v in zip(got["soa"], got["aosoa"]):
            assert torch.equal(u, v)
        yj, hj = jops.mamba_scan(xj, dtj, bj, cj, jnp.asarray(a),
                                 jnp.asarray(d), target=_jtarget(W))
        assert_within_bf16_step(y.float(), yj)
        assert_within_bf16_step(h, hj)


# ---------------------------------------------------------------------------
# plan-build validation and the plan model
# ---------------------------------------------------------------------------

class TestValidation:
    @pytest.mark.parametrize("entry", ["launch", "launch_plan"])
    def test_windowed_indivisible_vvl_named_error(self, entry):
        lat = Lattice((8, 8, 8))
        t = Target("cuda_windowed", vvl=7, layout="aosoa")
        consts = {"alpha": 1.0, "w": np.ones(7, np.float32)}
        with pytest.raises(ValueError) as ei:
            if entry == "launch":
                launch(_mixed_spec(), t, torch.zeros(2, lat.nsites),
                       torch.zeros(1, lat.nsites), lattice=lat, consts=consts)
            else:
                launch_plan(_mixed_spec(), t, lattice=lat, consts=consts)
        msg = str(ei.value)
        assert "mixed_layout" in msg and "vvl=7" in msg and "64" in msg

    def test_gathered_any_vvl_valid(self):
        """Remainder sites pad on the gathered executors: vvl 7 is fine."""
        lat = Lattice((8, 8, 8))
        f, r, w = _mixed_inputs(lat.shape)
        out = launch(_mixed_spec(), Target("torch", vvl=7, layout="aosoa"),
                     torch.from_numpy(f), torch.from_numpy(r), lattice=lat,
                     consts={"alpha": 1.0, "w": w})
        assert tuple(out[0].shape) == (2, lat.nsites)
        soa, got = _plain(False, (8, 8, 8), (0, 0, 0), 7)
        assert all(torch.equal(a, b) for a, b in zip(soa, got))

    def test_mamba_width_not_a_multiple_of_4_named_error(self):
        rng = _rng(10)
        x = _f32(rng, (1, 8, 16))
        bc = _f32(rng, (1, 8, 8))
        with pytest.raises(ValueError, match="multiple of 4"):
            ops.mamba_scan(x, np.abs(x), bc, bc, -np.ones((16, 8), np.float32),
                           np.ones(16, np.float32), device="cpu",
                           target=Target("cuda", vvl=6, layout="aosoa"))

    @pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_windowed"])
    def test_aosoa_hbm_estimate_doubles(self, backend):
        lat = Lattice((8, 8, 8))
        consts = {"alpha": 1.0, "w": np.ones(7, np.float32)}
        soa = launch_plan(_mixed_spec(), Target(backend, vvl=8),
                          lattice=lat, consts=consts)
        aos = launch_plan(_mixed_spec(), Target(backend, vvl=8,
                                                layout="aosoa"),
                          lattice=lat, consts=consts)
        assert aos.layout == "aosoa" and soa.layout == "soa"
        assert aos.hbm_bytes_estimate() == 2 * soa.hbm_bytes_estimate()

    @pytest.mark.parametrize("backend", ["cuda", "cuda_windowed"])
    def test_predict_sees_the_layout(self, backend):
        """``costmodel.predict``'s byte term of an AoSoA plan is twice the
        SoA plan's; its operations are the same."""
        from repro_torch.lb import stencil as tst
        from repro_torch.lb import programs as tprog
        lat = Lattice((16, 16, 16))
        consts = tprog.collision_consts(**PARAMS)
        p = {lay: costmodel.predict(launch_plan(
            tst.FUSED_SPEC, Target(backend, vvl=16, layout=lay),
            lattice=lat, consts=consts), profile=PROFILE) for lay in LAYOUTS}
        assert p["aosoa"].hbm_bytes == 2 * p["soa"].hbm_bytes
        assert p["aosoa"].t_hbm == pytest.approx(2 * p["soa"].t_hbm)
        assert p["aosoa"].flops == p["soa"].flops


# ---------------------------------------------------------------------------
# the tuner's layout axis
# ---------------------------------------------------------------------------

@pytest.fixture
def no_cache(tmp_path):
    return str(tmp_path)


class TestAutotuneLayoutAxis:
    def test_vvl_values_are_the_references(self):
        from repro.core.autotune import _vvl_values as jvals
        for n in (1, 5, 64, 512, 4096, 2 ** 21, 16384, 9216, 97):
            assert _vvl_values(n) == jvals(n), n

    def test_gathered_space_grows_the_layout_axis(self):
        def body(a):
            return 2.0 * a
        spec = KernelSpec(body, fields=(FieldSpec(3),), out=(3,), name="s")
        cands, _ = default_space(spec, Target("cuda"), site_count=1024)
        aos = [c for c in cands if c.layout == "aosoa"]
        assert {c.backend for c in aos} == {"cuda", "torch"}
        assert sorted({c.vvl for c in aos}) == _vvl_values(1024)
        assert any(c.vvl is not None and c.layout is None for c in cands)

    def test_windowed_space_layout_vvls_divide_plane(self):
        from repro_torch.lb import programs as tprog
        prog = tprog.fused_program("one_launch",
                                   tprog.collision_consts(**PARAMS))
        cands, pruned = default_space(prog, Target("cuda_windowed"),
                                      executors=["cuda_windowed"],
                                      grid_shape=(8, 8, 12))
        aos = [c for c in cands if c.layout == "aosoa"]
        assert aos and all(96 % c.vvl == 0 for c in aos)
        assert [c.vvl for c in aos] == _vvl_values(96)
        assert pruned == []

    def test_windowed_vmem_limit_prunes_aosoa_points(self):
        from repro_torch.lb import programs as tprog
        prog = tprog.fused_program("one_launch",
                                   tprog.collision_consts(**PARAMS))
        _, pruned = default_space(prog, Target("cuda_windowed"),
                                  executors=["cuda_windowed"],
                                  grid_shape=(8, 8, 8), vmem_limit=1000)
        assert any("layout=aosoa" in label and "vmem estimate" in why
                   for label, why in pruned)

    def test_candidate_zero_wins_ties(self, no_cache):
        lat = Lattice((8, 8, 8))
        f, r, w = _mixed_inputs(lat.shape)
        tgt, report = autotune(
            _mixed_spec(), Target("torch"),
            [torch.from_numpy(f), torch.from_numpy(r)], lattice=lat,
            consts={"alpha": 1.0, "w": w}, timer=lambda t, run: 1.0,
            reps=1, warmup=0, cache_dir=no_cache)
        assert any(r_.candidate.layout == "aosoa" for r_ in report.results)
        assert report.best == report.results[0].candidate
        assert tgt.executor == "torch" and tgt.layout == "soa"

    def test_aosoa_candidates_are_bit_identical(self, no_cache):
        """``check_identical`` keeps every AoSoA point of the space, and a
        timer that prefers one picks it."""
        lat = Lattice((8, 8, 8))
        f, r, w = _mixed_inputs(lat.shape)
        tgt, report = autotune(
            _mixed_spec(), Target("torch"),
            [torch.from_numpy(f), torch.from_numpy(r)], lattice=lat,
            consts={"alpha": 1.0, "w": w},
            timer=lambda t, run: 0.5 if t.layout == "aosoa" else 1.0,
            check_identical=True, reps=1, warmup=0, cache_dir=no_cache)
        assert not [why for _, why in report.pruned
                    if "bit-identical" in why]
        assert tgt.layout == "aosoa" and tgt.vvl in _vvl_values(512)

    def test_candidate_round_trips_layout_fields(self):
        c = Candidate("cuda_windowed", (("plane_block", 2),), 64, "aosoa")
        c2 = Candidate.from_dict(c.as_dict())
        assert c2 == c and c2.vvl == 64 and c2.layout == "aosoa"
        assert "layout=aosoa" in c.label and "vvl=64" in c.label
        t = c2.target_from(Target("cuda"))
        assert t.layout == "aosoa" and t.vvl == 64

    def test_vvl_invalid_candidate_pruned_not_fatal(self, no_cache):
        """An explicit-space windowed AoSoA width that does not divide the
        plane is pruned during measurement: the named error, not a
        crash."""
        from repro_torch.lb import stencil as tst
        lat = Lattice((8, 8, 8))
        f = torch.from_numpy(_f32(_rng(11), (19, lat.nsites)))
        bad = Candidate("cuda_windowed", vvl=7, layout="aosoa")
        good = Candidate("cuda_windowed", vvl=16, layout="aosoa")
        tgt, report = autotune(
            tst.STREAM_SPEC, Target("torch"), [f], lattice=lat,
            space=[bad, good], timer=lambda t, run: 0.5 if t.vvl == 16
            else 1.0, check_identical=True, reps=1, warmup=0,
            cache_dir=no_cache)
        assert "vvl=7 does not divide" in dict(report.pruned)[bad.label]
        assert [r_.candidate for r_ in report.results] == [
            Candidate("torch"), good]
        assert tgt == good.target_from(Target("torch"))
