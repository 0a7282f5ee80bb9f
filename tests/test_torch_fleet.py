"""``tdp.fleet`` in the port against the JAX package's.

Counterparts of ``tests/test_fleet.py``: ``ProgramState``, ``BatchedConst``,
fleet members bit-equal to solo and batch-1 runs (the reference holds a
sweep to batch-1 fleets only: its static-const solo compile folds a baked
scalar; the port's members run exactly their solo launches, so a sweep
member is also bit-equal to the solo run with that value static), the
windowed executor's fleets, the driver, durability and the sharded fleet
(which waits: ROADMAP A5).  Then the port's own: the same seeded numpy
inputs through ``repro``'s fleet (``"xla"``) and the port's (``"torch"``,
and the ``"cuda"`` executors' ensemble branches on CPU tensors) at the
port's bar (``rtol=2e-4, atol=2e-5``, 4 steps at 8³); the ensemble branches'
errors; and aliasing — a streamed snapshot or a retry rollback point never
changes after a later pump, though the bucket's tensors are written in
place.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tdp as jtdp
from repro.lb import programs as jlbp
from repro.lb.params import LBParams as JLBParams
from repro.lb.sim import BinaryFluidSim as JSim
from repro_torch import tdp
from repro_torch.core import faults, launch_ensemble
from repro_torch.kernels import tdp_pointwise
from repro_torch.lb import programs as lbp
from repro_torch.lb.params import LBParams
from repro_torch.lb.sim import BinaryFluidSim
from torch_fleet_common import GRID, TAUS, _mix, _relax, make_prog, members

LB_GRID = (8, 8, 8)
TOL = dict(rtol=2e-4, atol=2e-5)
#: the executors a fleet runs under on CPU tensors: the plain executor and
#: the card's, whose ensemble branches run their plain versions here
EXECUTORS = [tdp.Target("torch"), tdp.Target("cuda")]


def _eq(a, b):
    assert torch.equal(a, b), float((a - b).abs().max())


# ---------------------------------------------------------------------------
# ProgramState
# ---------------------------------------------------------------------------

class TestProgramState:
    def test_mapping_protocol(self):
        m = members(1)[0]
        s = tdp.ProgramState(m)
        assert list(s) == ["a"] and len(s) == 1 and s.fields == ("a",)
        assert s["a"] is m["a"] and dict(s)["a"] is m["a"]
        assert s.ensemble is None
        with pytest.raises(KeyError, match="no field 'b'.*fields: \\['a'\\]"):
            s["b"]
        with pytest.raises(ValueError, match="ensemble extent must be"):
            tdp.ProgramState(m, ensemble=0)

    def test_stack_member_unstack(self):
        ms = members(4)
        s = tdp.ProgramState.stack(ms)
        assert s.ensemble == 4 and s["a"].shape == (4, 2) + GRID
        for i, m in enumerate(ms):
            _eq(s.member(i)["a"], m["a"])
        parts = s.unstack()
        assert len(parts) == 4 and all(p.ensemble is None for p in parts)
        with pytest.raises(ValueError, match="already carries an ensemble"):
            tdp.ProgramState.stack([s, s])
        with pytest.raises(IndexError):
            s.member(4)

    def test_member_is_a_view(self):
        """``member(i)`` is a view, as its docstring says: an in-place write
        to the ensemble shows through it (and a clone does not)."""
        s = tdp.ProgramState.stack(members(2))
        view, copy = s.member(1), s.member(1)["a"].clone()
        s["a"][1].zero_()
        assert float(view["a"].abs().max()) == 0.0
        assert float(copy.abs().max()) > 0.0
        assert "view" in tdp.ProgramState.member.__doc__

    def test_replace(self):
        s = tdp.ProgramState(members(1)[0])
        z = torch.zeros((2,) + GRID)
        s2 = s.replace(a=z)
        assert s2["a"] is z and s["a"] is not z
        with pytest.raises(ValueError, match="unknown field"):
            s.replace(b=z)

    def test_validation_names_field_and_dim(self):
        with pytest.raises(ValueError, match="field 'a'.*dim 0 \\(ncomp\\) "
                                             "is 3.*expected ncomp 2"):
            tdp.ProgramState({"a": torch.zeros((3,) + GRID)}).validate(
                {"a": 2}, GRID)
        with pytest.raises(ValueError, match="dim 2 \\(grid dim 1\\) is 7.*"
                                             "expected grid extent 5"):
            tdp.ProgramState({"a": torch.zeros((2, 6, 7))}).validate(
                {"a": 2}, GRID)
        ens = tdp.ProgramState.stack(members(3))
        with pytest.raises(ValueError, match="dim 0 \\(ensemble\\) is 3.*"
                                             "expected ensemble extent 4"):
            tdp.validate_field("a", ens["a"], ncomp=2, grid_shape=GRID,
                               ensemble=4)

    def test_messages_match_the_reference(self):
        """The same bad shape raises the same message in both packages."""
        bad = np.zeros((3, 2, 6, 7), np.float32)
        msgs = []
        for vf, arr in ((jtdp.validate_field, jnp.asarray(bad)),
                        (tdp.validate_field, torch.tensor(bad))):
            with pytest.raises(ValueError) as ei:
                vf("a", arr, ncomp=2, grid_shape=GRID, ensemble=3,
                   program="demo")
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]

    def test_compiled_program_accepts_program_state(self):
        cp = make_prog(tdp.TargetConst(np.float32(0.9))).compile(
            "torch", grid_shape=GRID)
        m = members(1)[0]
        out_dict = cp.run(dict(m), 3)
        out_ps = cp.run(tdp.ProgramState(m), 3)
        assert isinstance(out_dict, dict)
        assert isinstance(out_ps, tdp.ProgramState)
        _eq(out_dict["a"], out_ps["a"])
        assert isinstance(cp.step(tdp.ProgramState(m)), tdp.ProgramState)
        with pytest.raises(ValueError, match="fleet|member"):
            cp.step(tdp.ProgramState.stack(members(2)))


# ---------------------------------------------------------------------------
# BatchedConst
# ---------------------------------------------------------------------------

class TestBatchedConst:
    def test_needs_leading_axis(self):
        with pytest.raises(ValueError, match="leading ensemble axis"):
            tdp.BatchedConst(3.0)
        bc = tdp.BatchedConst(np.arange(4.0))
        assert bc.batch == 4 and bc.member_shape() == ()
        assert bc == tdp.BatchedConst(np.arange(4.0))
        assert isinstance(bc, tdp.TargetConst)

    def test_bare_launch_rejected(self):
        prog = make_prog(tdp.BatchedConst(np.ones(4, np.float32)))
        cp = prog.compile("torch", grid_shape=GRID)
        with pytest.raises(ValueError, match="vmap\\(batch\\)"):
            cp.run(members(1)[0], 1)
        with pytest.raises(ValueError, match="vmap\\(batch\\)"):
            cp.step(members(1)[0])
        msgs = []
        for launch, kern, x in (
                (tdp.launch, _relax, members(1)[0]["a"].reshape(2, -1)),):
            with pytest.raises(ValueError, match="fleet") as ei:
                launch(kern, "torch", x,
                       tau=tdp.BatchedConst(np.ones(4, np.float32)),
                       w=tdp.TargetConst(np.ones(2, np.float32)))
            msgs.append(str(ei.value))
        # the reference's message
        assert "a bare launch has no ensemble axis" in msgs[0]

    def test_conflicting_sweeps_rejected(self):
        b1 = tdp.BatchedConst(np.arange(4.0))
        b2 = tdp.BatchedConst(np.arange(4.0) + 1)
        w = tdp.TargetConst(np.ones(2, np.float32))
        prog = tdp.Program("x", [
            tdp.stage(_relax, ["a"], ["tmp"], consts={"tau": b1, "w": w}),
            tdp.stage(_relax, ["tmp"], ["a"], consts={"tau": b2, "w": w}),
        ], fields=["a"])
        with pytest.raises(ValueError, match="two different BatchedConst"):
            prog.batched_consts()

    def test_batch_mismatch_names_const(self):
        prog = make_prog(tdp.BatchedConst(np.ones(4, np.float32)))
        cp = prog.compile("torch", grid_shape=GRID)
        assert cp.dyn_names == ("tau",)
        with pytest.raises(ValueError, match="'tau' sweeps 4.*batch is 3"):
            cp.vmap(3)


# ---------------------------------------------------------------------------
# FleetProgram bit-identity
# ---------------------------------------------------------------------------

class TestFleetBitIdentity:
    @pytest.mark.parametrize("batch", [1, 4])
    def test_static_consts_match_single_runs(self, batch):
        prog = make_prog(tdp.TargetConst(np.float32(0.9)))
        cp = prog.compile("torch", grid_shape=GRID)
        fleet = cp.vmap(batch)
        ms = members(batch)
        out = fleet.run(tdp.ProgramState.stack(ms), 5)
        assert isinstance(out, tdp.ProgramState) and out.ensemble == batch
        for i in range(batch):
            _eq(out["a"][i], cp.run(dict(ms[i]), 5)["a"])

    def test_sweep_matches_batch1_fleets_and_solo_runs(self):
        B = 4
        taus = np.linspace(0.6, 1.4, B).astype(np.float32)
        fleet = make_prog(tdp.BatchedConst(taus)).compile(
            "torch", grid_shape=GRID).vmap(B)
        ms = members(B)
        out = fleet.run(tdp.ProgramState.stack(ms), 6)
        for i in range(B):
            f1 = make_prog(tdp.BatchedConst(taus[i:i + 1])).compile(
                "torch", grid_shape=GRID).vmap(1)
            _eq(out["a"][i], f1.run({"a": ms[i]["a"][None]}, 6)["a"][0])
            solo = make_prog(tdp.TargetConst(taus[i])).compile(
                "torch", grid_shape=GRID).run(dict(ms[i]), 6)
            _eq(out["a"][i], solo["a"])

    def test_step_equals_run_chunks_and_donate(self):
        fleet = make_prog(tdp.TargetConst(np.float32(0.8))).compile(
            "torch", grid_shape=GRID).vmap(2)
        s = tdp.ProgramState.stack(members(2))
        a = fleet.run(s, 4)
        b = s
        for _ in range(4):
            b = fleet.step(b)
        _eq(a["a"], b["a"])
        keep = s["a"].clone()
        c = fleet.run(tdp.ProgramState({"a": s["a"].clone()}, ensemble=2), 4,
                      donate=True)
        _eq(a["a"], c["a"])
        _eq(s["a"], keep)                    # never written without donate

    def test_const_override(self):
        B = 3
        fleet = make_prog(tdp.BatchedConst(np.ones(B, np.float32))).compile(
            "torch", grid_shape=GRID).vmap(B)
        s = tdp.ProgramState.stack(members(B))
        over = fleet.run(s, 2, consts={"tau": np.full(B, 0.7, np.float32)})
        f2 = make_prog(tdp.BatchedConst(np.full(B, 0.7, np.float32))).compile(
            "torch", grid_shape=GRID).vmap(B)
        _eq(over["a"], f2.run(s, 2)["a"])
        with pytest.raises(ValueError, match="binds no batched const"):
            fleet.run(s, 1, consts={"nope": np.ones(B)})
        with pytest.raises(ValueError, match="'tau'.*expected the fleet"):
            fleet.run(s, 1, consts={"tau": np.ones(B + 1, np.float32)})

    def test_state_validation_messages(self):
        fleet = make_prog(tdp.TargetConst(np.float32(0.9))).compile(
            "torch", grid_shape=GRID).vmap(2)
        with pytest.raises(ValueError, match="must carry an ensemble axis"):
            fleet.step(tdp.ProgramState(members(1)[0]))
        with pytest.raises(ValueError, match="ensemble extent 3 != fleet"):
            fleet.step(tdp.ProgramState.stack(members(3)))
        with pytest.raises(ValueError,
                           match="field 'a'.*dim 0 \\(ensemble\\)"):
            fleet.step({"a": torch.zeros((3, 2) + GRID)})

    @pytest.mark.parametrize("target", EXECUTORS, ids=["torch", "cuda"])
    def test_lb_fleet_matches_single_sims(self, target):
        """A fleet of two_launch trajectories is bit-equal to independent
        single runs."""
        sim = BinaryFluidSim(LB_GRID, fused="two_launch", target=target,
                             device="cpu")
        fused = sim.programs["fused"]
        states = []
        for seed in range(3):
            st = sim.init_spinodal(seed=seed)
            states.append(sim.programs["collide"].run({"f": st.f, "g": st.g},
                                                      1))
        out = fused.vmap(3).run(tdp.ProgramState.stack(states), 4)
        for i in range(3):
            ref = fused.run(dict(states[i]), 4)
            for f in ("f", "g"):
                _eq(out[f][i], ref[f])

    @pytest.mark.parametrize("target", EXECUTORS, ids=["torch", "cuda"])
    def test_lb_mobility_sweep(self, target):
        """Per-member tau_phi through a BatchedConst: each member equals
        its batch-1 fleet and its solo run with tau_phi static."""
        tau_phis = np.array([0.8, 1.0, 1.2], np.float32)
        p = LBParams()

        def build(tp):
            phys = p.as_kwargs()
            phys["tau_phi"] = tp
            return lbp.unfused_step_program(
                lbp.collision_consts(np.float32, **phys))

        sim = BinaryFluidSim(LB_GRID, p, device="cpu")
        ms = [{"f": s.f, "g": s.g}
              for s in (sim.init_spinodal(seed=k) for k in range(3))]
        out = build(tdp.BatchedConst(tau_phis)).compile(
            target, grid_shape=LB_GRID).vmap(3).run(
            tdp.ProgramState.stack(ms), 3)
        for i in range(3):
            f1 = build(tdp.BatchedConst(tau_phis[i:i + 1])).compile(
                target, grid_shape=LB_GRID).vmap(1)
            ref = f1.run({k: v[None] for k, v in ms[i].items()}, 3)
            solo = build(tdp.TargetConst(tau_phis[i])).compile(
                target, grid_shape=LB_GRID).run(dict(ms[i]), 3)
            for f in ("f", "g"):
                _eq(out[f][i], ref[f][0])
                _eq(out[f][i], solo[f])


class TestFleetWindowed:
    def test_windowed_fleet_matches_windowed_singles(self):
        sim = BinaryFluidSim(LB_GRID, fused="one_launch", device="cpu")
        ms = []
        for seed in (0, 1):
            st = sim.init_spinodal(seed=seed)
            ms.append(sim.programs["collide"].run({"f": st.f, "g": st.g}, 1))
        consts = lbp.collision_consts(np.float32, **LBParams().as_kwargs())
        for mode in ("one_launch", "two_launch"):
            cp = lbp.fused_program(mode, consts).compile(
                tdp.Target("cuda_windowed"), grid_shape=LB_GRID)
            out = cp.vmap(2).run(tdp.ProgramState.stack(ms), 2)
            for i, m in enumerate(ms):
                ref = cp.run(dict(m), 2)
                for f in ("f", "g"):
                    _eq(out[f][i], ref[f])


# ---------------------------------------------------------------------------
# FleetDriver
# ---------------------------------------------------------------------------

class TestFleetDriver:
    def test_submit_poll_stream_drain_static(self):
        prog = make_prog(tdp.TargetConst(np.float32(0.9)))
        cp = prog.compile("torch", grid_shape=GRID)
        drv = tdp.FleetDriver("torch", batch=3)
        ms = members(4)
        ts = [drv.submit(prog, {"state": ms[i]}, 5 + i) for i in range(4)]
        marks = [s for s, _ in drv.stream(ts[0], every=2)]
        assert marks == [2, 4, 5]
        final = drv.drain()
        for i, t in enumerate(ts):
            _eq(final[t.id]["a"], cp.run(dict(ms[i]), 5 + i)["a"])
            p = drv.poll(t)
            assert p["done"] and p["step"] == 5 + i
        # 4 tickets > 3 slots still used exactly one bucket
        assert len(drv._buckets) == 1

    def test_sweep_bucket_one_fleet(self):
        prog = make_prog(tdp.TargetConst(np.float32(1.0)))
        B = 3
        drv = tdp.FleetDriver("torch", batch=B)
        ms = members(B)
        ts = [drv.submit(prog, {"state": ms[i], "consts": {"tau": TAUS[i]}},
                         6) for i in range(B)]
        final = drv.drain()
        assert len(drv._buckets) == 1
        for i, t in enumerate(ts):
            f1 = make_prog(tdp.BatchedConst(TAUS[i:i + 1])).compile(
                "torch", grid_shape=GRID).vmap(1)
            _eq(final[t.id]["a"], f1.run({"a": ms[i]["a"][None]}, 6)["a"][0])

    def test_fallback_warns_once_and_completes(self):
        prog = make_prog(tdp.TargetConst(np.float32(0.9)))
        drv = tdp.FleetDriver("torch", batch=2, grid_shapes=[GRID])
        odd = (4, 4)
        with warnings.catch_warnings(record=True) as wlist:
            warnings.simplefilter("always")
            t1 = drv.submit(prog, {"state": {"a": torch.ones((2,) + odd)}}, 3)
            t2 = drv.submit(prog, {"state": {"a": torch.zeros((2,) + odd)}},
                            3)
        msgs = [x for x in wlist if "per-member" in str(x.message)]
        assert len(msgs) == 1 and "(4, 4)" in str(msgs[0].message)
        final = drv.drain()
        ref = prog.compile("torch", grid_shape=odd).run(
            {"a": torch.ones((2,) + odd)}, 3)
        _eq(final[t1.id]["a"], ref["a"])
        assert t1.bucket_id == "" and t2.done
        t3 = drv.submit(prog, {"state": members(1)[0]}, 2)
        drv.drain()
        assert t3.bucket_id != ""

    def test_background_thread(self):
        prog = make_prog(tdp.TargetConst(np.float32(0.9)))
        cp = prog.compile("torch", grid_shape=GRID)
        drv = tdp.FleetDriver("torch", batch=2)
        drv.start()
        try:
            m = members(1)[0]
            t = drv.submit(prog, {"state": m}, 12)
            final = drv.drain()
        finally:
            drv.stop()
        assert drv._thread is None
        _eq(final[t.id]["a"], cp.run(dict(m), 12)["a"])

    def test_submit_validation(self):
        prog = make_prog(tdp.TargetConst(np.float32(0.9)))
        drv = tdp.FleetDriver("torch", batch=2)
        with pytest.raises(ValueError, match="one member per ticket"):
            drv.submit(prog, {"state": tdp.ProgramState.stack(members(2))}, 3)
        with pytest.raises(ValueError, match="nsteps"):
            drv.submit(prog, {"state": members(1)[0]}, 0)
        with pytest.raises(ValueError, match="no stage binds const"):
            drv.submit(prog, {"state": members(1)[0],
                              "consts": {"zeta": 1.0}}, 3)

    def test_submit_copies_the_callers_state(self):
        prog = make_prog(tdp.TargetConst(np.float32(0.9)))
        m = members(1)[0]
        keep = m["a"].clone()
        drv = tdp.FleetDriver("torch", batch=2)
        drv.submit(prog, {"state": m}, 3)
        drv.drain()
        _eq(m["a"], keep)


class TestFleetDurability:
    def test_kill_and_resume_matches_uninterrupted(self, tmp_path):
        prog = make_prog(tdp.TargetConst(np.float32(1.0)))
        taus = np.array([0.7, 1.1], np.float32)
        ms = members(2)
        ck = str(tmp_path / "ck")
        drv = tdp.FleetDriver("torch", batch=2, checkpoint_dir=ck)
        key = np.array([0, 3], np.uint32)
        tA = drv.submit(prog, {"state": ms[0], "consts": {"tau": taus[0]},
                               "rng": key}, 9)
        tB = drv.submit(prog, {"state": ms[1], "consts": {"tau": taus[1]}}, 4)
        drv.pump(3)
        drv.checkpoint()
        del drv

        drv2 = tdp.FleetDriver.restore(ck, {"demo": prog}, device="cpu",
                                       target="torch")
        rA, rB = drv2._tickets[tA.id], drv2._tickets[tB.id]
        assert rA.step == 3 and not rA.done and rB.step == 3 and not rB.done
        assert rA.rng.tolist() == key.tolist()
        final = drv2.drain()
        assert drv2._tickets[tA.id].step == 9

        ref = tdp.FleetDriver("torch", batch=2)
        uA = ref.submit(prog, {"state": ms[0], "consts": {"tau": taus[0]}}, 9)
        uB = ref.submit(prog, {"state": ms[1], "consts": {"tau": taus[1]}}, 4)
        rfinal = ref.drain()
        _eq(final[tA.id]["a"], rfinal[uA.id]["a"])
        _eq(final[tB.id]["a"], rfinal[uB.id]["a"])

    def test_completed_tickets_restore_completed(self, tmp_path):
        prog = make_prog(tdp.TargetConst(np.float32(1.0)))
        ck = str(tmp_path / "ck")
        drv = tdp.FleetDriver("torch", batch=2, checkpoint_dir=ck)
        t = drv.submit(prog, {"state": members(1)[0]}, 2)
        drv.drain()
        drv.checkpoint()
        drv2 = tdp.FleetDriver.restore(ck, prog, device="cpu", target="torch")
        assert drv2._tickets[t.id].done
        assert drv2.drain()[t.id]["a"].shape == (2,) + GRID

    def test_periodic_checkpoint_cadence(self, tmp_path):
        from repro_torch.checkpoint import latest_step
        prog = make_prog(tdp.TargetConst(np.float32(1.0)))
        ck = str(tmp_path / "ck")
        drv = tdp.FleetDriver("torch", batch=2, checkpoint_dir=ck,
                              checkpoint_every=2)
        drv.submit(prog, {"state": members(1)[0]}, 5)
        drv.drain()
        assert latest_step(ck) is not None


class TestShardedFleet:
    def test_sharded_and_aosoa_fleets_name_the_roadmap_item(self):
        """The reference composes vmap outside shard_map; the port's
        sharded fleets wait (ROADMAP A5), and so do AoSoA fleets and
        executors that take no ensemble — each raises, none loops."""
        class Mesh:
            shape = {"x": 1}
        prog = make_prog(tdp.TargetConst(np.float32(1.0)))
        cp = prog.compile("torch", grid_shape=GRID, mesh=Mesh(),
                          shard_axis="x")
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            cp.vmap(2)
        cp = prog.compile(tdp.Target("torch", layout="aosoa", vvl=4),
                          grid_shape=GRID)
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            cp.vmap(2)
        tdp.register_executor("solo_only", tdp.torch_executor)
        try:
            cp = prog.compile("solo_only", grid_shape=GRID)
            with pytest.raises(NotImplementedError, match="takes_ensemble"):
                cp.vmap(2)
        finally:
            tdp.unregister_executor("solo_only")


# ---------------------------------------------------------------------------
# the port's fleet against the reference's
# ---------------------------------------------------------------------------

def _jstates(n):
    sim = JSim(grid_shape=LB_GRID, backend="xla", params=JLBParams())
    return [sim.init_spinodal(seed=s) for s in range(n)]


class TestParityWithReference:
    @pytest.mark.parametrize("target", EXECUTORS, ids=["torch", "cuda"])
    def test_unfused_tau_phi_sweep(self, target):
        tau_phis = np.array([0.8, 1.0, 1.2], np.float32)

        def build(mod, tdp_mod, params):
            phys = params.as_kwargs()
            phys["tau_phi"] = tdp_mod.BatchedConst(tau_phis)
            return mod.unfused_step_program(
                mod.collision_consts(np.float32, **phys))

        js = _jstates(3)
        jout = build(jlbp, jtdp, JLBParams()).compile(
            "xla", grid_shape=LB_GRID).vmap(3).run(
            jtdp.ProgramState.stack([{"f": s.f, "g": s.g} for s in js]), 4)
        ms = [{"f": torch.tensor(np.asarray(s.f)),
               "g": torch.tensor(np.asarray(s.g))} for s in js]
        out = build(lbp, tdp, LBParams()).compile(
            target, grid_shape=LB_GRID).vmap(3).run(
            tdp.ProgramState.stack(ms), 4)
        for f in ("f", "g"):
            np.testing.assert_allclose(out[f].numpy(), np.asarray(jout[f]),
                                       **TOL)

    @pytest.mark.parametrize("backend", ["torch", "cuda_windowed"])
    def test_two_launch_static(self, backend):
        consts = dict(A=0.125, B=0.11, kappa=0.02, tau=0.9, tau_phi=1.1,
                      gamma=0.8)
        js = _jstates(2)
        jp = jlbp.fused_program("two_launch",
                                jlbp.collision_consts(np.float32, **consts))
        jout = jp.compile("xla", grid_shape=LB_GRID).vmap(2).run(
            jtdp.ProgramState.stack([{"f": s.f, "g": s.g} for s in js]), 4)
        tp = lbp.fused_program("two_launch",
                               lbp.collision_consts(np.float32, **consts))
        out = tp.compile(tdp.Target(backend), grid_shape=LB_GRID).vmap(2).run(
            tdp.ProgramState.stack(
                [{"f": torch.tensor(np.asarray(s.f)),
                  "g": torch.tensor(np.asarray(s.g))} for s in js]), 4)
        for f in ("f", "g"):
            np.testing.assert_allclose(out[f].numpy(), np.asarray(jout[f]),
                                       **TOL)


# ---------------------------------------------------------------------------
# the ensemble branches of the card's executors, on CPU tensors
# ---------------------------------------------------------------------------

class TestEnsembleBranches:
    def _launch(self, spec, target, xs, **kw):
        return launch_ensemble(spec, target, *xs, batch=xs[0].shape[0],
                               **kw)

    def test_counts_nothing_on_the_cpu_and_refuses_w_and_c_sweeps(self):
        from repro_torch.lb import stencil as tst
        from repro_torch.core import Lattice
        rng = np.random.default_rng(0)
        x = torch.tensor(rng.normal(size=(3, 19, 512)).astype(np.float32))
        before = dict(tdp_pointwise.ensemble_launches)
        out = self._launch(tst.STREAM_SPEC, "cuda", [x],
                           lattice=Lattice(LB_GRID))
        assert out.shape == (3, 19, 512)
        assert tdp_pointwise.ensemble_launches == before
        consts = lbp.collision_consts(np.float32, **LBParams().as_kwargs())
        f = torch.tensor(rng.normal(size=(2, 19, 512)).astype(np.float32))
        g = f.clone()
        w = np.stack([np.asarray(consts.pop("w").value)] * 2)
        with pytest.raises(ValueError, match="compile D3Q19"):
            self._launch(tst.FUSED_SPEC, "cuda", [f, g],
                         lattice=Lattice(LB_GRID), consts=consts,
                         member_consts={"w": w})

    def test_member_values_reach_the_physics_table(self):
        """The table a launch reads: each member's six scalars, a swept
        one's row or the shared value (the C make_phys turns them into
        rows; tests/test_torch_csrc.py holds those bits)."""
        from repro_torch.core.api import Ensemble, launch_plan
        from repro_torch.lb import stencil as tst
        phys = dict(A=0.125, B=0.11, kappa=0.02, tau=0.9, tau_phi=1.1,
                    gamma=0.8)
        plan = launch_plan(tst.COLLIDE_SPEC, "cuda",
                           consts=lbp.collision_consts(**phys))
        plan = plan.with_consts(plan.consts, ensemble=Ensemble(
            2, {"tau_phi": np.array([0.8, 1.2], np.float32)}))
        vals = tdp_pointwise.member_phys(plan)
        want = np.array([[0.125, 0.11, 0.02, 0.9, 0.8, 0.8],
                         [0.125, 0.11, 0.02, 0.9, 1.2, 0.8]], np.float32)
        np.testing.assert_array_equal(vals, want)

    def test_lm_sites_have_no_ensemble_branch_yet(self):
        from repro_torch.kernels import lm
        x = torch.ones(2, 1, 64)
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            self._launch(lm.gated_act_spec("gelu", False), "cuda", [x])

    def test_non_ensemble_executor_refuses_the_launch(self):
        tdp.register_executor("solo_only", tdp.torch_executor)
        try:
            with pytest.raises(NotImplementedError, match="takes_ensemble"):
                self._launch(_mix, "solo_only",
                             [torch.ones(2, 2, 30), torch.ones(2, 2, 30)])
        finally:
            tdp.unregister_executor("solo_only")

    def test_failing_executor_counts_launches(self):
        """``fail_on`` counts launches: a 2-stage fleet step is 2 calls,
        whatever the batch (ROADMAP §C: the reference counts traces)."""
        h = faults.register_failing_executor("flaky_count", base="torch",
                                             fail_on=3, times=1)
        try:
            fleet = make_prog(tdp.TargetConst(np.float32(1.0))).compile(
                "flaky_count", grid_shape=GRID).vmap(4)
            s = tdp.ProgramState.stack(members(4))
            fleet.step(s)
            assert h.calls == 2
            with pytest.raises(faults.InjectedFault, match="call 3"):
                fleet.step(s)
        finally:
            faults.unregister_failing_executor("flaky_count")


# ---------------------------------------------------------------------------
# aliasing: what outlives a pump is a copy
# ---------------------------------------------------------------------------

class TestAliasing:
    def test_streamed_snapshots_and_rollback_never_change(self, tmp_path):
        prog = make_prog(tdp.TargetConst(np.float32(1.0)))
        drv = tdp.FleetDriver("torch", batch=2,
                              checkpoint_dir=str(tmp_path / "ck"),
                              checkpoint_every=2,
                              health=tdp.HealthPolicy(every=1), max_retries=1)
        ts = [drv.submit(prog, {"state": m, "consts": {"tau": TAUS[i]}}, 10)
              for i, m in enumerate(members(2))]
        gen = drv.stream(ts[0], every=2)
        step, snap = next(gen)
        kept = snap["a"].clone()
        drv.pump(2)                   # the cadence refreshes the rollback
        rb_step, rb_state = ts[1]._retry_ckpt
        rb_kept = rb_state["a"].clone()
        polled = drv.poll(ts[1])["state"]["a"]
        polled_kept = polled.clone()
        drv.inject(faults.nan_at_step(ts[1].id, "a", rb_step))
        drv.pump(3)                   # NaN in ts[1]'s slot, written in place
        _eq(snap["a"], kept)
        _eq(rb_state["a"], rb_kept)
        _eq(polled, polled_kept)
        assert ts[1].retries == 1     # the rollback point was used
        final = drv.drain()
        for s, sn in gen:             # later snapshots are copies too
            pass
        assert torch.isfinite(final[ts[1].id]["a"]).all()
        assert step == 2

    def test_retired_ticket_keeps_its_state_when_the_slot_is_reused(self):
        prog = make_prog(tdp.TargetConst(np.float32(1.0)))
        cp = prog.compile("torch", grid_shape=GRID)
        ms = members(3)
        drv = tdp.FleetDriver("torch", batch=1)
        t0 = drv.submit(prog, {"state": ms[0]}, 2)
        t1 = drv.submit(prog, {"state": ms[1]}, 5)   # takes t0's slot
        drv.drain()
        _eq(drv.poll(t0)["state"]["a"], cp.run(dict(ms[0]), 2)["a"])
        _eq(drv.poll(t1)["state"]["a"], cp.run(dict(ms[1]), 5)["a"])
