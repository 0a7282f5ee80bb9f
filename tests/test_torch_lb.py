"""The port's lattice-Boltzmann slice against the JAX package.

* ``ops.lb_collision`` on a ragged site count against the reference's
  Pallas kernel (interpret mode) and its oracle, at the reference's own bar
  (``rtol=2e-5, atol=2e-5``, ``tests/test_lb.py``);
* ``BinaryFluidSim`` unfused / one_launch / two_launch, 10 steps at 16³
  from the same spinodal state, against the reference's ``"xla"``
  trajectory at its cross-path tolerance (``rtol=2e-4, atol=2e-5``);
* conservation, ``step`` == ``run``, ``from_reference``, and the
  no-fallback rules of the entry points.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
import repro.kernels.ref as jref
import repro.lb.params as jparams
import repro.lb.sim as jsim
from repro_torch.core import register_executor, unregister_executor
from repro_torch.kernels import lb_collision as tlb
from repro_torch.kernels import tdp_windowed as tlw
from repro_torch.kernels import ops
from repro_torch.lb import programs as tprog
from repro_torch.lb.params import LBParams
from repro_torch.lb.sim import BinaryFluidSim, from_reference

PARAMS = dict(A=0.125, B=0.125, kappa=0.02)
REGIMES = (False, "one_launch", "two_launch")
_REF_TRAJ = {}


def _ref_trajectory(fused):
    if fused not in _REF_TRAJ:
        sim = jsim.BinaryFluidSim((16, 16, 16),
                                  params=jparams.LBParams(**PARAMS),
                                  fused=fused)
        st = sim.step(sim.init_spinodal(seed=3, noise=0.05), 10)
        _REF_TRAJ[fused] = (np.asarray(st.f), np.asarray(st.g))
    return _REF_TRAJ[fused]


def _collision_inputs(n=1000):
    rng = np.random.default_rng(11)
    f = (0.05 * rng.normal(size=(19, n)) + 1 / 19.).astype(np.float32)
    g = (0.05 * rng.normal(size=(19, n))).astype(np.float32)
    phi = g.sum(0, keepdims=True)
    gp = (0.01 * rng.normal(size=(3, n))).astype(np.float32)
    d2 = (0.01 * rng.normal(size=(1, n))).astype(np.float32)
    return f, g, phi, gp, d2


class TestCollision:
    PHYS = dict(A=0.0625, B=0.07, kappa=0.04, tau=0.8, tau_phi=1.2, gamma=0.9)

    @pytest.mark.parametrize("reference", ["pallas_interpret", "oracle"])
    @pytest.mark.parametrize("target", ["torch", "cuda"])
    def test_ragged_collision_matches(self, target, reference):
        ins = _collision_inputs()
        if reference == "oracle":
            ref = jref.lb_collision_ref(*map(jnp.asarray, ins), **self.PHYS)
        else:
            ref = jops.lb_collision(*map(jnp.asarray, ins),
                                    target="pallas_interpret", vvl=64,
                                    **self.PHYS)
        got = ops.lb_collision(*ins, target=target, device="cpu", **self.PHYS)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=2e-5, atol=2e-5)

    def test_mass_and_phi_conserved_per_site(self):
        f, g, phi, gp, d2 = map(torch.from_numpy, _collision_inputs())
        fo, go = tlb.lb_collision(f, g, phi, gp, d2)
        torch.testing.assert_close(fo.sum(0), f.sum(0), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(go.sum(0), g.sum(0), rtol=1e-6, atol=1e-6)

    def test_unknown_physics_parameter_raises(self):
        ins = map(torch.from_numpy, _collision_inputs(8))
        with pytest.raises(TypeError, match="kapa"):
            tlb.lb_collision(*ins, kapa=0.1)


class TestTrajectory:
    @pytest.mark.parametrize("fused,backend", [
        (False, "torch"), (False, "cuda"),
        ("one_launch", "torch"), ("one_launch", "cuda_windowed"),
        ("two_launch", "torch"), ("two_launch", "cuda_windowed")])
    def test_matches_reference_xla(self, fused, backend):
        sim = BinaryFluidSim((16, 16, 16), LBParams(**PARAMS), fused=fused,
                             backend=backend, device="cpu")
        st = sim.step(sim.init_spinodal(seed=3, noise=0.05), 10)
        rf, rg = _ref_trajectory(fused)
        np.testing.assert_allclose(st.f.numpy(), rf, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(st.g.numpy(), rg, rtol=2e-4, atol=2e-5)

    @pytest.mark.parametrize("fused", REGIMES)
    def test_conserves(self, fused):
        sim = BinaryFluidSim((8, 8, 8), fused=fused, device="cpu")
        st = sim.init_spinodal(seed=1, noise=0.05)
        obs0 = sim.observables(st)
        obs1 = sim.observables(sim.step(st, 10))
        assert not obs1["nan"]
        np.testing.assert_allclose(obs1["mass"], obs0["mass"], rtol=1e-5)
        np.testing.assert_allclose(obs1["phi_total"], obs0["phi_total"],
                                   rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("fused", REGIMES)
    def test_step_equals_run(self, fused):
        sim = BinaryFluidSim((8, 8, 8), fused=fused, device="cpu")
        st = sim.init_spinodal(seed=4)
        a, b = sim.step(st, 6), sim.run(st, 6)
        assert torch.equal(a.f, b.f) and torch.equal(a.g, b.g)
        assert a.step == b.step == 6

    def test_run_leaves_input_state_untouched(self):
        sim = BinaryFluidSim((8, 8, 8), device="cpu")
        st = sim.init_spinodal(seed=5)
        f0, g0 = st.f.clone(), st.g.clone()
        sim.run(st, 3)
        assert torch.equal(st.f, f0) and torch.equal(st.g, g0)

    def test_droplet_stays_a_droplet(self):
        sim = BinaryFluidSim((12, 12, 12), fused="two_launch", device="cpu")
        obs = sim.observables(sim.step(sim.init_droplet(), 20))
        assert not obs["nan"]
        assert -1.2 < obs["phi_min"] < -0.5 and 0.5 < obs["phi_max"] < 1.2


class TestFromReference:
    def test_initial_state_is_the_same_bits(self):
        jp = jparams.LBParams(**PARAMS)
        jstate = jsim.BinaryFluidSim((8, 8, 8), params=jp).init_spinodal(
            seed=3, noise=0.05)
        st, params = from_reference(np.asarray(jstate.f),
                                    np.asarray(jstate.g),
                                    dataclasses.asdict(jp), device="cpu")
        assert params == LBParams(**PARAMS)
        own = BinaryFluidSim((8, 8, 8), params, device="cpu").init_spinodal(
            seed=3, noise=0.05)
        np.testing.assert_array_equal(st.f.numpy(), np.asarray(jstate.f))
        assert torch.equal(st.f, own.f) and torch.equal(st.g, own.g)

    def test_round_trip(self):
        rng = np.random.default_rng(0)
        f = rng.normal(size=(19, 4, 3, 2)).astype(np.float32)
        g = rng.normal(size=(19, 4, 3, 2)).astype(np.float32)
        st, params = from_reference(f, g, dataclasses.asdict(LBParams()),
                                    device="cpu")
        np.testing.assert_array_equal(st.f.numpy(), f)
        np.testing.assert_array_equal(st.g.numpy(), g)
        assert dataclasses.asdict(params) == dataclasses.asdict(LBParams())


class TestFusedStepOp:
    @pytest.mark.parametrize("mode", ["one_launch", "two_launch"])
    def test_lb_fused_step_matches_reference(self, mode):
        rng = np.random.default_rng(3)
        n = 8 ** 3
        f = (0.05 * rng.normal(size=(19, n)) + 1 / 19.).astype(np.float32)
        g = (0.05 * rng.normal(size=(19, n))).astype(np.float32)
        ref = jops.lb_fused_step(jnp.asarray(f), jnp.asarray(g),
                                 grid_shape=(8, 8, 8), mode=mode,
                                 backend="xla", vvl=64, **PARAMS)
        for target in ("torch", "cuda_windowed"):
            got = ops.lb_fused_step(f, g, grid_shape=(8, 8, 8), mode=mode,
                                    target=target, device="cpu", **PARAMS)
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-6)


class TestEntryPointGuards:
    def _require_no_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the no-card guard "
                        "cannot trigger")

    def test_sim_without_device_raises_without_card(self):
        self._require_no_card()
        with pytest.raises(RuntimeError, match="CUDA"):
            BinaryFluidSim((8, 8, 8))

    def test_ops_without_device_raise_without_card(self):
        self._require_no_card()
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.lb_collision(*_collision_inputs(8))

    def test_mesh_compile_raises(self):
        """A mesh compile needs a mesh with named axes, one of them the
        shard axis (the decompositions themselves: test_torch_decomp.py)."""
        prog = tprog.stream_program()
        with pytest.raises(ValueError, match="named axes"):
            prog.compile("torch", grid_shape=(8, 8, 8), mesh=object())

        class Mesh:
            shape = {"px": 2}
        with pytest.raises(ValueError, match="not a mesh axis"):
            prog.compile("torch", grid_shape=(8, 8, 8), mesh=Mesh())

    def test_stencil_only_backend_refused_unfused(self):
        with pytest.raises(ValueError, match="stencil-only"):
            BinaryFluidSim((8, 8, 8), backend="cuda_windowed", device="cpu")

    def test_fused_mode_validation(self):
        with pytest.raises(ValueError, match="fused"):
            BinaryFluidSim((8, 8, 8), fused="three_launch", device="cpu")

    def test_default_backends_follow_device(self):
        cpu = BinaryFluidSim((8, 8, 8), device="cpu")
        assert (cpu.backend, cpu.vvl) == ("torch", 128)
        fused = BinaryFluidSim((8, 8, 8), fused=True, device="cpu",
                               backend="cuda_windowed")
        assert fused.vvl == 1
        # the fused prologue's pointwise stages route to the gathered CUDA
        # executor, not to the plain one
        routed = [t.executor for t in
                  fused.programs["collide"].stage_targets]
        assert routed == ["cuda", "cuda_windowed", "cuda"]

    def test_stencil_only_executor_without_partner_raises(self):
        register_executor("_dummy_windowed", tlw.windowed_plain,
                          wants="halo_extended")
        try:
            with pytest.raises(NotImplementedError, match="pointwise"):
                tprog.collide_program(tprog.collision_consts(**PARAMS)) \
                    .compile("_dummy_windowed", grid_shape=(8, 8, 8))
            with pytest.raises(NotImplementedError, match="pointwise"):
                BinaryFluidSim((8, 8, 8), fused=True, device="cpu",
                               backend="_dummy_windowed")
        finally:
            unregister_executor("_dummy_windowed")

    def test_unregistered_executor_raises(self):
        with pytest.raises(ValueError, match="unknown executor"):
            BinaryFluidSim((8, 8, 8), fused=True, device="cpu",
                           backend="not_registered")
