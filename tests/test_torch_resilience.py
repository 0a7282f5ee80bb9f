"""``tdp.health`` and ``tdp.faults`` in the port: the chaos suite of the
reference's ``tests/test_resilience.py``, seeded fault schedules against
the fleet service.

Every fault is deterministic (:mod:`repro_torch.core.faults`), so each test
proves one recovery contract: the diagnosis names field, kind, member and
step range (and equals the reference's on the same poisoned ensemble); a
quarantined member leaves the others bit-equal to a fault-free run; a
fault while pumping a bucket fails only the offending ticket(s); retries
roll back and finish exactly; background pump-thread crashes surface; and
restore falls back past a damaged newest snapshot.  The port's executors
run at every launch, so a failing executor's schedule counts launches (the
reference's counts traces; ROADMAP §C).  No test sleeps more than 0.1 s;
background threads are joined with a timeout.
"""
import time
import warnings

import numpy as np
import pytest
import torch

from repro import tdp as jtdp
from repro.core import health as jhealth
from repro_torch import tdp
from repro_torch.checkpoint import checkpoint_steps, latest_step
from repro_torch.core import faults
from repro_torch.core.health import check, diagnose
from torch_fleet_common import (GRID, PROG, TAUS, fault_free_reference,
                                members)


def _eq(a, b):
    assert torch.equal(a, b), float((a - b).abs().max())


def _wait_for(cond, timeout=10.0):
    deadline = time.perf_counter() + timeout
    while not cond():
        assert time.perf_counter() < deadline, "condition never held"
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# HealthPolicy / diagnose / guarded runs
# ---------------------------------------------------------------------------

class TestHealthPolicy:
    def test_validation(self):
        with pytest.raises(ValueError, match="every must be >= 1"):
            tdp.HealthPolicy(every=0)
        with pytest.raises(ValueError, match="max_norm must be positive"):
            tdp.HealthPolicy(max_norm=-1.0)
        with pytest.raises(ValueError, match="enables no checks"):
            tdp.HealthPolicy(nan=False, inf=False)
        with pytest.raises(ValueError, match="'b'.*does not carry"):
            tdp.HealthPolicy(fields=("b",)).select_fields(["a"])

    def test_diagnose_kinds_and_members(self):
        pol = tdp.HealthPolicy(max_norm=10.0)
        st = {"a": np.array([[1.0, 2.0], [np.nan, 1.0],
                             [np.inf, 1.0], [99.0, 1.0]], np.float32)}
        diag = diagnose(pol, st, ensemble=4)
        assert set(diag) == {1, 2, 3}
        assert diag[1].kind == "nan" and diag[2].kind == "inf"
        assert diag[3].kind == "norm" and diag[3].value == 99.0
        assert diagnose(pol, {"a": np.float32([np.nan])})[0].kind == "nan"
        assert diagnose(pol, {"a": np.float32([1.0])}) == {}
        with pytest.raises(ValueError, match="leading extent"):
            diagnose(pol, st, ensemble=3)

    @pytest.mark.parametrize("policy", [
        dict(), dict(max_norm=2.5), dict(fields=("g",), inf=False),
        dict(nan=False, max_norm=1.0)])
    def test_diagnose_equals_the_reference(self, policy):
        """The same poisoned ensemble, the same policy: the same
        diagnoses, values bit for bit."""
        rng = np.random.default_rng(3)
        st = {f: rng.normal(size=(5, 19, 4, 4, 4)).astype(np.float32)
              for f in ("f", "g")}
        st["f"][1, 3, 0, 0, 0] = np.nan
        st["g"][1, 0, 1, 1, 1] = np.inf
        st["g"][2, 5, 2, 2, 2] = -np.inf
        st["f"][3, 0, 3, 3, 3] = 7.5
        st["g"][4, 1, 0, 0, 0] = np.nan
        got = diagnose(tdp.HealthPolicy(**policy),
                       {k: torch.tensor(v) for k, v in st.items()},
                       ensemble=5)
        want = jhealth.diagnose(jtdp.HealthPolicy(**policy), st, ensemble=5)
        assert got == want and got

    def test_error_carries_diagnosis(self):
        pol = tdp.HealthPolicy(every=2)
        with pytest.raises(tdp.HealthError) as ei:
            check(pol, {"g": torch.tensor([[np.nan]])}, ensemble=1,
                  step_range=(4, 6), where="unit")
        e = ei.value
        assert (e.field, e.kind, e.member, e.step_range) == \
            ("g", "nan", 0, (4, 6))
        assert "field 'g' contains NaN" in str(e)
        assert "steps [4, 6)" in str(e)
        with pytest.raises(jtdp.HealthError) as ej:
            jhealth.check(jtdp.HealthPolicy(every=2),
                          {"g": np.float32([[np.nan]])}, ensemble=1,
                          step_range=(4, 6), where="unit")
        assert str(e) == str(ej.value)

    def test_guarded_run_bit_identical_and_raises(self):
        cp = PROG.compile("torch", grid_shape=GRID)
        m = members(1)[0]
        pol = tdp.HealthPolicy(every=3)
        _eq(cp.run(dict(m), 8, health=pol)["a"], cp.run(dict(m), 8)["a"])
        bad = m["a"].clone()
        bad[(0,) * 3] = np.nan
        with pytest.raises(tdp.HealthError, match="steps \\[0, 3\\)"):
            cp.run({"a": bad}, 8, health=pol)
        with pytest.raises(ValueError, match="does not carry"):
            cp.run(dict(m), 2, health=tdp.HealthPolicy(fields=("nope",)))

    def test_guarded_fleet_run_attributes_member(self):
        fleet = PROG.compile("torch", grid_shape=GRID).vmap(3)
        s = tdp.ProgramState.stack(members(3))
        pol = tdp.HealthPolicy(every=2)
        _eq(fleet.run(s, 6, health=pol)["a"], fleet.run(s, 6)["a"])
        a = s["a"].clone()
        a[(1,) + (0,) * 3] = np.inf
        with pytest.raises(tdp.HealthError) as ei:
            fleet.run(s.replace(a=a), 6, health=pol)
        assert ei.value.member == 1 and ei.value.kind in ("nan", "inf")
        assert ei.value.step_range == (0, 2)


# ---------------------------------------------------------------------------
# ticket lifecycle + NaN quarantine
# ---------------------------------------------------------------------------

class TestQuarantine:
    def test_status_walk_and_poll_keys(self):
        drv = tdp.FleetDriver("torch", batch=2)
        t = drv.submit(PROG, {"state": members(1)[0]}, 3)
        assert t.status == "running" and not t.finished
        drv.drain()
        p = drv.poll(t)
        assert p["status"] == "done" and p["retries"] == 0
        assert p["error"] is None and p["traceback"] is None
        assert "status='done'" in repr(t)

    def test_nan_member_quarantined_healthy_members_exact(self):
        ms = members(3)
        refs = fault_free_reference(ms, 8)
        drv = tdp.FleetDriver("torch", batch=3,
                              health=tdp.HealthPolicy(every=2))
        ts = [drv.submit(PROG, {"state": ms[i], "consts": {"tau": TAUS[i]}},
                         8) for i in range(3)]
        drv.inject(faults.nan_at_step(ts[1].id, "a", 4))
        final = drv.drain()
        p = drv.poll(ts[1])
        assert p["status"] == "failed"
        err = p["error"]
        assert isinstance(err, tdp.HealthError)
        assert err.ticket == ts[1].id and err.field == "a"
        assert err.kind == "nan" and err.step_range is not None
        assert "HealthError" in p["traceback"]
        for i in (0, 2):
            assert drv.poll(ts[i])["status"] == "done"
            _eq(final[ts[i].id]["a"], refs[i])
        t_new = drv.submit(PROG, {"state": ms[0], "consts": {"tau": TAUS[0]}},
                           8)
        _eq(drv.drain()[t_new.id]["a"], refs[0])

    def test_every1_failed_state_stays_healthy(self):
        drv = tdp.FleetDriver("torch", batch=2,
                              health=tdp.HealthPolicy(every=1))
        t = drv.submit(PROG, {"state": members(1)[0]}, 8)
        drv.inject(faults.nan_at_step(t.id, "a", 4))
        final = drv.drain()
        assert drv.poll(t)["status"] == "failed" and t.step == 4
        assert torch.isfinite(final[t.id]["a"]).all()

    def test_stream_raises_failed_tickets_cause(self):
        drv = tdp.FleetDriver("torch", batch=2,
                              health=tdp.HealthPolicy(every=1))
        t = drv.submit(PROG, {"state": members(1)[0]}, 10)
        drv.inject(faults.nan_at_step(t.id, "a", 2))
        with pytest.raises(tdp.HealthError):
            for _ in drv.stream(t, every=2):
                pass

    def test_driver_health_validates_fields_at_submit(self):
        drv = tdp.FleetDriver("torch", batch=2,
                              health=tdp.HealthPolicy(fields=("ghost",)))
        with pytest.raises(ValueError, match="'ghost'.*does not step"):
            drv.submit(PROG, {"state": members(1)[0]}, 2)

    def test_solo_fallback_quarantine(self):
        drv = tdp.FleetDriver("torch", batch=2, grid_shapes=[GRID],
                              health=tdp.HealthPolicy(every=1))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t = drv.submit(PROG, {"state": {"a": torch.ones((2, 4, 4))}}, 6)
        drv.inject(faults.nan_at_step(t.id, "a", 2))
        drv.drain()
        assert drv.poll(t)["status"] == "failed"
        assert isinstance(t.error, tdp.HealthError)

    def test_nan_write_touches_its_slot_only(self):
        """``nan_at_step`` writes in place, in its ticket's slot row; the
        other slot's tensor is untouched."""
        drv = tdp.FleetDriver("torch", batch=2)
        ts = [drv.submit(PROG, {"state": m}, 6) for m in members(2)]
        drv.pump(1)
        b = ts[0]._bucket
        before = b.state["a"].clone()
        drv.inject(faults.nan_at_step(ts[0].id, "a", 1))
        drv._run_chaos()
        assert torch.isnan(b.state["a"][0]).sum() == 1
        _eq(b.state["a"][1], before[1])


# ---------------------------------------------------------------------------
# executor faults: blame attribution via batch-1 replays
# ---------------------------------------------------------------------------

class TestExecutorFaults:
    def test_one_shot_fault_recovers_every_ticket(self):
        ms = members(3)
        refs = fault_free_reference(ms, 8)
        handle = faults.register_failing_executor("flaky1", base="torch",
                                                  fail_on=1, times=1)
        try:
            drv = tdp.FleetDriver("flaky1", batch=3)
            ts = [drv.submit(PROG, {"state": ms[i],
                                    "consts": {"tau": TAUS[i]}}, 8)
                  for i in range(3)]
            final = drv.drain()
            assert handle.calls > 1
            for i in range(3):
                assert drv.poll(ts[i])["status"] == "done"
                _eq(final[ts[i].id]["a"], refs[i])
        finally:
            faults.unregister_failing_executor("flaky1")

    def test_mid_run_fault_recovers_every_ticket(self):
        """A fault at a later launch (the second stage of the fourth
        pump): the chunk's input is intact, the replays give every ticket
        its fault-free bits."""
        ms = members(3)
        refs = fault_free_reference(ms, 8)
        faults.register_failing_executor("flaky8", base="torch", fail_on=8,
                                         times=1)
        try:
            drv = tdp.FleetDriver("flaky8", batch=3)
            ts = [drv.submit(PROG, {"state": ms[i],
                                    "consts": {"tau": TAUS[i]}}, 8)
                  for i in range(3)]
            final = drv.drain()
            for i in range(3):
                _eq(final[ts[i].id]["a"], refs[i])
        finally:
            faults.unregister_failing_executor("flaky8")

    def test_persistent_fault_fails_with_cause(self):
        faults.register_failing_executor("dead1", base="torch", fail_on=1,
                                         times=float("inf"))
        try:
            drv = tdp.FleetDriver("dead1", batch=2)
            t = drv.submit(PROG, {"state": members(1)[0]}, 4)
            final = drv.drain()
            p = drv.poll(t)
            assert p["status"] == "failed"
            assert isinstance(p["error"], tdp.InjectedFault)
            assert "InjectedFault" in p["traceback"]
            assert t.id in final
        finally:
            faults.unregister_failing_executor("dead1")

    def test_failing_executor_schedule_validation(self):
        with pytest.raises(ValueError, match="1-based"):
            faults.register_failing_executor("x", fail_on=0)
        with pytest.raises(ValueError, match="times"):
            faults.register_failing_executor("x", times=0)


# ---------------------------------------------------------------------------
# retry with rollback
# ---------------------------------------------------------------------------

class TestRetry:
    def test_one_shot_nan_retries_bit_exact(self):
        ms = members(3)
        refs = fault_free_reference(ms, 8)
        drv = tdp.FleetDriver("torch", batch=3,
                              health=tdp.HealthPolicy(every=1), max_retries=1)
        ts = [drv.submit(PROG, {"state": ms[i], "consts": {"tau": TAUS[i]}},
                         8) for i in range(3)]
        drv.inject(faults.nan_at_step(ts[1].id, "a", 3))
        final = drv.drain()
        p = drv.poll(ts[1])
        assert p["status"] == "done" and p["retries"] == 1
        assert p["error"] is not None
        for i in range(3):
            _eq(final[ts[i].id]["a"], refs[i])

    def test_retry_resumes_from_last_checkpoint(self, tmp_path):
        ms = members(2)
        refs = fault_free_reference(ms, 10)
        drv = tdp.FleetDriver("torch", batch=2,
                              checkpoint_dir=str(tmp_path / "ck"),
                              checkpoint_every=2,
                              health=tdp.HealthPolicy(every=1), max_retries=1)
        ts = [drv.submit(PROG, {"state": ms[i], "consts": {"tau": TAUS[i]}},
                         10) for i in range(2)]
        drv.pump(6)
        assert ts[0]._retry_ckpt[0] == 6
        drv.inject(faults.nan_at_step(ts[0].id, "a", 8))
        final = drv.drain()
        assert drv.poll(ts[0])["status"] == "done"
        assert drv.poll(ts[0])["retries"] == 1
        for i in range(2):
            _eq(final[ts[i].id]["a"], refs[i])

    def test_persistent_divergence_exhausts_retries(self):
        drv = tdp.FleetDriver("torch", batch=2,
                              health=tdp.HealthPolicy(every=1), max_retries=2)
        bad = members(1)[0]["a"].clone()
        bad[(0,) * 3] = np.nan
        t = drv.submit(PROG, {"state": {"a": bad}}, 4)
        drv.drain()
        p = drv.poll(t)
        assert p["status"] == "failed" and p["retries"] == 2

    def test_retry_backoff_gates_and_completes(self):
        drv = tdp.FleetDriver("torch", batch=2,
                              health=tdp.HealthPolicy(every=1),
                              max_retries=1, retry_backoff=0.05)
        t = drv.submit(PROG, {"state": members(1)[0]}, 6)
        drv.inject(faults.nan_at_step(t.id, "a", 2))
        t0 = time.perf_counter()
        drv.drain()
        assert drv.poll(t)["status"] == "done"
        assert time.perf_counter() - t0 >= 0.05


# ---------------------------------------------------------------------------
# background-thread error surfacing
# ---------------------------------------------------------------------------

class TestLoopErrorSurfacing:
    def test_drain_reraises_pump_thread_crash(self):
        drv = tdp.FleetDriver("torch", batch=2)
        drv.submit(PROG, {"state": members(1)[0]}, 1000)
        drv.inject(faults.raise_in_pump(at_pump=2))
        drv.start()
        with pytest.raises(tdp.InjectedFault, match="pump round 2"):
            drv.drain()
        drv.stop()                            # already surfaced: no raise
        assert drv._thread is None

    def test_poll_reports_driver_error_nonraising(self):
        drv = tdp.FleetDriver("torch", batch=2)
        t = drv.submit(PROG, {"state": members(1)[0]}, 1000)
        drv.inject(faults.raise_in_pump(at_pump=1))
        drv.start()
        _wait_for(lambda: "driver_error" in drv.poll(t))
        assert isinstance(drv.poll(t)["driver_error"], tdp.InjectedFault)
        with pytest.raises(tdp.InjectedFault):
            drv.stop()
        drv.stop()                            # idempotent after surfacing

    def test_inline_pump_chaos_raises_to_caller(self):
        drv = tdp.FleetDriver("torch", batch=2)
        drv.submit(PROG, {"state": members(1)[0]}, 4)
        drv.inject(faults.raise_in_pump(at_pump=1))
        with pytest.raises(tdp.InjectedFault):
            drv.drain()


# ---------------------------------------------------------------------------
# checkpoint integrity: verify-on-load, retention, restore fallback
# ---------------------------------------------------------------------------

class TestRestoreFallback:
    def _two_snapshots(self, tmp_path, ms):
        drv = tdp.FleetDriver("torch", batch=2,
                              checkpoint_dir=str(tmp_path / "ck"),
                              checkpoint_keep=5)
        ts = [drv.submit(PROG, {"state": ms[i], "consts": {"tau": TAUS[i]}},
                         10) for i in range(2)]
        drv.pump(4)
        drv.checkpoint()                      # valid snapshot @ step 4
        drv.pump(2)
        drv.checkpoint()                      # newest snapshot @ step 6
        return str(tmp_path / "ck"), ts

    @pytest.mark.parametrize("mode", ["flip", "truncate", "manifest"])
    def test_corrupt_newest_falls_back_to_valid(self, tmp_path, mode):
        ms = members(2)
        refs = fault_free_reference(ms, 10)
        ck, ts = self._two_snapshots(tmp_path, ms)
        assert len(checkpoint_steps(ck)) == 2
        faults.corrupt_checkpoint(ck, mode=mode)
        with pytest.warns(RuntimeWarning, match="integrity"):
            drv2 = tdp.FleetDriver.restore(ck, PROG, device="cpu",
                                           target="torch")
        assert drv2._tickets[ts[0].id].step == 4
        final = drv2.drain()
        for i in range(2):
            _eq(final[ts[i].id]["a"], refs[i])

    def test_all_corrupt_raises_ioerror(self, tmp_path):
        ck, _ = self._two_snapshots(tmp_path, members(2))
        for step in checkpoint_steps(ck):
            faults.corrupt_checkpoint(ck, step=step, mode="flip")
        with pytest.raises(IOError, match="failed integrity"):
            tdp.FleetDriver.restore(ck, PROG, device="cpu", target="torch")

    def test_restore_checkpoint_verifies_by_default(self, tmp_path):
        from repro_torch.checkpoint import (restore_checkpoint,
                                            save_checkpoint)
        tree = {"w": torch.arange(8.0)}
        save_checkpoint(str(tmp_path), 1, tree)
        faults.corrupt_checkpoint(str(tmp_path), mode="flip")
        with pytest.raises(IOError, match="integrity"):
            restore_checkpoint(str(tmp_path), tree, device="cpu")
        got, _, _ = restore_checkpoint(str(tmp_path), tree, verify=False,
                                       device="cpu")
        assert got["w"].shape == (8,)
        with pytest.raises(ValueError, match="unknown corruption mode"):
            faults.corrupt_checkpoint(str(tmp_path), mode="melt")

    def test_failed_ticket_restores_failed(self, tmp_path):
        ck = str(tmp_path / "ck")
        drv = tdp.FleetDriver("torch", batch=2, checkpoint_dir=ck,
                              health=tdp.HealthPolicy(every=1))
        t_ok = drv.submit(PROG, {"state": members(1)[0]}, 4)
        bad = members(1, seed=1)[0]["a"].clone()
        bad[(0,) * 3] = np.nan
        t_bad = drv.submit(PROG, {"state": {"a": bad}}, 4)
        drv.drain()
        drv.checkpoint()
        drv2 = tdp.FleetDriver.restore(ck, PROG, device="cpu", target="torch")
        assert drv2._tickets[t_ok.id].status == "done"
        rbad = drv2._tickets[t_bad.id]
        assert rbad.status == "failed"
        assert "health check failed" in str(rbad.error)
        drv2.drain()

    def test_kill_pump_thread_then_restore_resumes(self, tmp_path):
        ck = str(tmp_path / "ck")
        drv = tdp.FleetDriver("torch", batch=2, checkpoint_dir=ck,
                              checkpoint_every=2)
        t = drv.submit(PROG, {"state": members(1)[0]}, 5000)
        drv.start()
        _wait_for(lambda: latest_step(ck) is not None, timeout=60)
        faults.kill_pump_thread(drv)
        assert drv._thread is None
        drv._ckpt.wait()
        drv2 = tdp.FleetDriver.restore(ck, PROG, device="cpu", target="torch")
        r = drv2._tickets[t.id]
        assert not r.finished and 0 < r.step < 5000
