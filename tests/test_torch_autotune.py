"""The port's autotuner, mirroring the reference's ``tests/test_autotune.py``.

Deterministic: measurement runs under an injected fake timer (scripted
costs per candidate label), on the ``"torch"`` executor (and the CUDA
executors, whose wrappers run the plain versions on CPU tensors) at 8³–16³.

* the space: base first, the executor axis, the CUDA VVL axis (1, 2, 4,
  8), one point for ``"torch"`` (which ignores the VVL), no AoSoA and no
  ``plane_block`` points;
* selection, budget, explicit spaces, unrunnable candidates;
* the cache (miss, hit, corrupt, interrupted and concurrent writes, the
  schema gate) and replay of the reference's entries (an interpreted one
  is a miss);
* predictor-guided search (``top_k``, rank correlation);
* correctness decoupling: ``check_identical`` and a tuned target's 16³
  trajectory against the default's;
* the FMA rung of ``csrc/calibrate.cu``, built with the host compiler.
"""
import ctypes
import importlib
import json
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch

from repro import tdp
from repro.lb import programs as jlbp
from repro.lb.params import LBParams as JParams
from repro_torch.core import (
    Candidate,
    costmodel,
    Target,
    TuneReport,
    autotune,
    default_space,
    executor_vvls,
    field,
    kernel,
    program,
    register_executor,
    stage,
    unregister_executor,
)
from repro_torch.core.api import torch_executor
from repro_torch.core.autotune import (
    SCHEMA_VERSION,
    CandidateResult,
    _rank_correlation,
    cache_key,
    load_cached,
    store_cached,
)
from repro_torch.kernels import _build, ops
from repro_torch.kernels.calibrate import FMA_RTOL, fma_chain
from repro_torch.kernels.lb_collision import cuda_vvl
from repro_torch.lb import programs as lbp
from repro_torch.lb.stencil import FUSED_SPEC
from repro_torch.lb.params import LBParams
from repro_torch.lb.sim import BinaryFluidSim

jat = importlib.import_module("repro.core.autotune")
ROOT = pathlib.Path(__file__).resolve().parents[1]
GRID = (8, 8, 8)
PARAMS = dict(A=0.125, B=0.125, kappa=0.02)
BASE = Target("torch")
#: a base whose executor has a VVL axis: "cuda", "cuda[vvl=2|4|8]", "torch"
SWEEP = Target("cuda", vvl=1)


def fused_prog(mode="two_launch"):
    return lbp.fused_program(mode, lbp.collision_consts(
        **LBParams(**PARAMS).as_kwargs()))


def lb_state(grid=GRID, seed=0):
    rng = np.random.default_rng(seed)
    f = 0.05 * rng.normal(size=(19,) + grid) + 1 / 19.
    g = 0.05 * rng.normal(size=(19,) + grid)
    return {"f": torch.tensor(f, dtype=torch.float32),
            "g": torch.tensor(g, dtype=torch.float32)}


class ScriptedTimer:
    """Fake timer: cost per label substring, call log kept."""

    def __init__(self, costs, default=1.0):
        self.costs = dict(costs)
        self.default = default
        self.calls = []

    def __call__(self, target, run):
        label = Candidate(target.backend, vvl=target.vvl,
                          tuning=target.tuning,
                          layout=target.layout if target.layout == "aosoa"
                          else None).label
        self.calls.append(label)
        for key, cost in self.costs.items():
            if key in label:
                return cost
        return self.default


def tune(tmp_path, timer=None, **kw):
    kw.setdefault("reps", 1)
    kw.setdefault("warmup", 0)
    kw.setdefault("measure_steps", 1)
    return autotune(kw.pop("program", None) or fused_prog(),
                    kw.pop("target", BASE), kw.pop("state", None) or lb_state(),
                    timer=timer or ScriptedTimer({}), cache_dir=str(tmp_path),
                    **kw)


@kernel(fields=[field(2)], out=2)
def double2(x):
    return 2.0 * x


# ---------------------------------------------------------------------------
# the space
# ---------------------------------------------------------------------------

class TestSpace:
    def test_program_space_base_torch_and_vvl_axes(self):
        cands, pruned = default_space(fused_prog(), Target("cuda_windowed"))
        assert [c.label for c in cands] == [
            "cuda_windowed", "cuda_windowed[vvl=2]", "cuda_windowed[vvl=4]",
            "cuda_windowed[vvl=8]", "torch"]
        assert pruned == []

    @pytest.mark.parametrize("exe", ["cuda", "cuda_windowed"])
    def test_cuda_vvl_axis_is_1_2_4_8(self, exe):
        assert executor_vvls(exe) == (1, 2, 4, 8)
        for v in (1, 2, 4, 8):
            assert cuda_vvl(v) == v
        with pytest.raises(ValueError):
            cuda_vvl(16)
        cands, _ = default_space(fused_prog(), Target(exe, vvl=4),
                                 executors=[exe])
        assert sorted(c.vvl or 4 for c in cands) == [1, 2, 4, 8]

    @pytest.mark.parametrize("exe", ["torch", "cuda", "cuda_windowed"])
    def test_no_plane_block_points(self, exe):
        cands, pruned = default_space(fused_prog(), Target(exe),
                                      executors=[exe])
        knobs = {k for c in cands for k, _ in c.tuning}
        assert "plane_block" not in knobs
        assert not any("plane_block" in label for label, _ in pruned)

    def test_fused_tile_brings_the_plane_block_axis(self):
        """One-launch programs hold ``fused``'s shared-memory tile, so
        ``"cuda_windowed"`` sweeps its depth: the divisors of the x extent
        at the base VVL, the default's own value excepted.  The AoSoA
        widths (divisors of the 64-site plane from 8) come before it."""
        cands, pruned = default_space(fused_prog("one_launch"),
                                      Target("cuda_windowed"),
                                      executors=["cuda_windowed"],
                                      grid_shape=GRID)
        labels = [c.label for c in cands]
        assert labels == [
            "cuda_windowed", "cuda_windowed[vvl=2]", "cuda_windowed[vvl=4]",
            "cuda_windowed[vvl=8]"] + [
            f"cuda_windowed[layout=aosoa,vvl={w}]" for w in (8, 16, 32, 64)
        ] + ["cuda_windowed[plane_block=1]",
             "cuda_windowed[plane_block=4]", "cuda_windowed[plane_block=8]"]
        assert pruned == []

    def test_vmem_limit_prunes_deep_tiles(self):
        cands, pruned = default_space(fused_prog("one_launch"),
                                      Target("cuda_windowed"),
                                      executors=["cuda_windowed"],
                                      grid_shape=GRID,
                                      vmem_limit=4 * 5 * 10 * 34)
        assert [c.label for c in cands][-1] == "cuda_windowed[plane_block=1]"
        assert pruned == [(f"cuda_windowed[plane_block={p}]",
                           f"vmem estimate {4 * (p + 2) * 10 * 34} > limit "
                           f"{4 * 5 * 10 * 34}") for p in (4, 8)]

    def test_torch_executor_is_one_point(self):
        """The plain executor ignores the VVL, so it gets no VVL sweep."""
        assert executor_vvls("torch") is None
        cands, _ = default_space(fused_prog(), Target("torch", vvl=64))
        assert [c.label for c in cands] == ["torch"]

    def test_declared_vvls_are_the_axis(self):
        register_executor("vvl35", torch_executor, vvls=(3, 5))
        try:
            cands, _ = default_space(double2, Target("vvl35"),
                                     executors=("vvl35",))
            assert [c.label for c in cands] == ["vvl35", "vvl35[vvl=5]"]
        finally:
            unregister_executor("vvl35")

    def test_pointwise_spec_excludes_halo_extended_executors(self):
        cands, pruned = default_space(double2, BASE,
                                      executors=("torch", "cuda_windowed",
                                                 "nosuch"))
        labels = [c.label for c in cands]
        assert "cuda_windowed" not in labels
        reasons = dict(pruned)
        assert "halo_extended" in reasons["cuda_windowed"]
        assert reasons["nosuch"] == "not registered"

    def test_rejects_other_subjects(self):
        with pytest.raises(TypeError, match="Program or KernelSpec"):
            default_space(object(), BASE)


def two_tile_prog():
    """Two one-launch steps in one Program: two windowed stages that each
    hold ``fused``'s tile (``two_launch``'s two windowed stages hold none)."""
    consts = lbp.collision_consts(**LBParams(**PARAMS).as_kwargs())
    return program("lb_fused_twice", [
        stage(FUSED_SPEC, reads=("f", "g"), writes=("f1", "g1"),
                  consts=consts, name="first"),
        stage(FUSED_SPEC, reads=("f1", "g1"), writes=("f", "g"),
                  consts=consts, name="second"),
    ], fields=("f", "g"))


class TestPerStage:
    """The reserved ``"stage:<name>"`` tuning keys (the reference's
    ``TestPerStage``): a per-stage ``plane_block`` axis over the windowed
    stages that hold a tile."""

    def test_space_gains_stage_candidates(self):
        cands, pruned = default_space(two_tile_prog(),
                                      Target("cuda_windowed"),
                                      executors=["cuda_windowed"],
                                      grid_shape=GRID, per_stage=True)
        stage = [c for c in cands if any(k.startswith("stage:")
                                         for k, _ in c.tuning)]
        assert {k for c in stage for k, _ in c.tuning} == {
            "stage:first", "stage:second"}
        # the divisors of each stage's 8 planes but the default's 2
        assert sorted(c.label for c in stage) == sorted(
            f"cuda_windowed[stage:{n}{{plane_block={p}}}]"
            for n in ("first", "second") for p in (1, 4, 8))
        assert pruned == []
        plain, _ = default_space(two_tile_prog(), Target("cuda_windowed"),
                                 executors=["cuda_windowed"],
                                 grid_shape=GRID)
        assert len(cands) == len(plain) + len(stage)

    @pytest.mark.parametrize("mode", ["one_launch", "two_launch"])
    def test_no_axis_without_two_tiled_stages(self, mode):
        """One tiled stage makes per-stage the global sweep; ``two_launch``
        has two windowed stages but no tile."""
        cands, _ = default_space(fused_prog(mode), Target("cuda_windowed"),
                                 executors=["cuda_windowed"],
                                 grid_shape=GRID, per_stage=True)
        assert not any(k.startswith("stage:")
                       for c in cands for k, _ in c.tuning)

    def test_vmem_limit_prunes_stage_points(self):
        limit = 4 * 5 * 10 * 34            # a tile 3 planes deep
        _, pruned = default_space(two_tile_prog(), Target("cuda_windowed"),
                                  executors=["cuda_windowed"],
                                  grid_shape=GRID, per_stage=True,
                                  vmem_limit=limit)
        stage = sorted(label for label, _ in pruned if "stage:" in label)
        assert stage == sorted(f"cuda_windowed[stage:{n}{{plane_block={p}}}]"
                               for n in ("first", "second") for p in (4, 8))

    def test_stage_key_reaches_only_its_stage(self):
        from repro_torch.core.program import resolve_stage_target
        tgt = Target("cuda_windowed").with_tuning(
            {"stage:second": (("plane_block", 4),), "plane_block": 1})
        plan = two_tile_prog().plan(tgt, grid_shape=GRID)
        by_stage = {n: dict(p.target.tuning) for n, p in plan.stages}
        assert by_stage == {"first": {"plane_block": 1},
                            "second": {"plane_block": 4}}
        assert resolve_stage_target(tgt, FUSED_SPEC).tuning == (
            ("plane_block", 1),)

    def test_per_stage_candidates_run_bit_identical(self):
        state = lb_state()
        base = two_tile_prog().compile("cuda_windowed", grid_shape=GRID)
        ref = base.run(dict(state), 2)
        for skey in ("stage:first", "stage:second"):
            tgt = Target("cuda_windowed").with_tuning(
                {skey: (("plane_block", 4),)})
            out = two_tile_prog().compile(tgt, grid_shape=GRID).run(
                dict(state), 2)
            for k in ref:
                assert torch.equal(ref[k], out[k]), (skey, k)

    def test_autotune_round_trips_nested_tuning(self, tmp_path):
        label = "stage:second{plane_block=4}"
        tuned, rep = tune(tmp_path, ScriptedTimer({label: 0.01}),
                          program=two_tile_prog(),
                          target=Target("cuda_windowed"),
                          executors=["cuda_windowed"], per_stage=True)
        assert rep.best.label == f"cuda_windowed[{label}]"
        assert dict(tuned.tuning)["stage:second"] == (("plane_block", 4),)
        timer = ScriptedTimer({})
        tuned2, rep2 = tune(tmp_path, timer, program=two_tile_prog(),
                            target=Target("cuda_windowed"),
                            executors=["cuda_windowed"], per_stage=True)
        assert rep2.cache_hit and timer.calls == []
        assert dict(tuned2.tuning)["stage:second"] == (("plane_block", 4),)


# ---------------------------------------------------------------------------
# selection with a fake timer
# ---------------------------------------------------------------------------

class TestSelection:
    def test_best_candidate_wins(self, tmp_path):
        timer = ScriptedTimer({"torch[vvl=32]": 0.01, "cuda": 0.5})
        tuned, rep = tune(tmp_path, timer, space=[
            Candidate("torch", vvl=32), Candidate("cuda", vvl=2)])
        assert rep.best.label == "torch[vvl=32]"
        assert tuned == Target("torch", vvl=32)
        assert rep.best_median_s == pytest.approx(0.01)
        assert rep.default_median_s == pytest.approx(1.0)

    def test_base_target_always_candidate_zero(self, tmp_path):
        tuned, rep = tune(tmp_path, target=SWEEP)
        # cuda at 4 VVLs, torch, and 6 AoSoA widths of the 512 sites each
        assert len(rep.results) == 5 + 2 * 6
        assert rep.results[0].candidate.label == "cuda"
        assert tuned == SWEEP                    # flat costs: ties go to 0

    def test_budget_keeps_base_and_prunes_tail(self, tmp_path):
        _, rep = tune(tmp_path, target=SWEEP, budget=2)
        assert len(rep.results) == 2
        assert rep.results[0].candidate.label == "cuda"
        assert any("over budget" in why for _, why in rep.pruned)

    def test_explicit_space_listing_base_elsewhere_keeps_it_first(
            self, tmp_path):
        timer = ScriptedTimer({"cuda": 0.1})
        tuned, rep = tune(tmp_path, timer, space=["cuda", BASE])
        labels = [r.candidate.label for r in rep.results]
        assert labels == ["torch", "cuda"]
        assert tuned.executor == "cuda"
        assert rep.default_median_s == pytest.approx(1.0)

    def test_program_autotune_convenience(self, tmp_path):
        tuned, rep = fused_prog().autotune(
            BASE, lb_state(), timer=ScriptedTimer({}), cache_dir=str(tmp_path),
            reps=1, warmup=0, space=["cuda"])
        assert isinstance(rep, TuneReport) and tuned == BASE

    def test_compiled_program_reuses_target_and_grid(self, tmp_path):
        exe = fused_prog().compile(Target("cuda_windowed", vvl=1),
                                   grid_shape=GRID)
        tuned, rep = autotune(exe, example_state=lb_state(),
                              timer=ScriptedTimer({"vvl=4": 0.1}), reps=1,
                              warmup=0, executors=["cuda_windowed"],
                              cache_dir=str(tmp_path))
        assert rep.grid == GRID
        assert tuned == Target("cuda_windowed", vvl=4)

    def test_unrunnable_candidate_is_pruned_but_base_must_run(self, tmp_path):
        def exploding(target, run):
            if target.executor == "cuda":
                raise RuntimeError("boom")
            return 1.0

        _, rep = tune(tmp_path, exploding, space=["cuda"])
        assert dict(rep.pruned)["cuda"] == "error: RuntimeError: boom"
        with pytest.raises(RuntimeError, match="boom"):
            tune(tmp_path / "b", exploding, target=Target("cuda"),
                 space=["torch"])

    def test_measures_for_real_without_a_timer(self, tmp_path):
        tuned, rep = autotune(fused_prog("one_launch"), BASE, lb_state(),
                              space=["cuda"], reps=2, warmup=1,
                              measure_steps=1, cache_dir=str(tmp_path))
        assert [len(r.times_s) for r in rep.results] == [2, 2]
        assert all(r.median_s > 0 for r in rep.results)
        assert tuned.executor in ("torch", "cuda")


# ---------------------------------------------------------------------------
# the on-disk cache
# ---------------------------------------------------------------------------

class TestCache:
    def test_miss_writes_then_hit_skips_measurement(self, tmp_path):
        timer = ScriptedTimer({"vvl=8]": 0.01})
        tuned1, rep1 = tune(tmp_path, timer, target=SWEEP)
        assert not rep1.cache_hit
        assert os.path.exists(tmp_path / f"{rep1.cache_key}.json")
        n = len(timer.calls)
        tuned2, rep2 = tune(tmp_path, timer, target=SWEEP)
        assert rep2.cache_hit and len(timer.calls) == n
        assert tuned2 == tuned1 == Target("cuda", vvl=8)
        assert rep2.best == rep1.best

    def test_cache_key_discriminates_grid_backend_graph_device(self):
        prog = fused_prog()
        k = cache_key(prog, BASE, (8, 8, 8), "cpu")
        assert k != cache_key(prog, BASE, (16, 8, 8), "cpu")
        assert k != cache_key(prog, Target("cuda"), (8, 8, 8), "cpu")
        assert k != cache_key(fused_prog("one_launch"), BASE, (8, 8, 8), "cpu")
        assert k != cache_key(prog, BASE, (8, 8, 8), "meta")
        assert k == cache_key(fused_prog(), BASE, (8, 8, 8), "cpu")
        assert k.endswith("-torch-cpu:cpu")

    def test_cache_key_without_a_device_is_the_card(self, monkeypatch):
        """``device=None`` names the card, and raises where none is
        present instead of keying the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cache_key(fused_prog(), BASE, (8, 8, 8))

    def test_corrupt_cache_entry_is_a_miss(self, tmp_path):
        _, rep = tune(tmp_path)
        path = tmp_path / f"{rep.cache_key}.json"
        path.write_text("{not json")
        _, rep2 = tune(tmp_path)
        assert not rep2.cache_hit
        assert json.loads(path.read_text())["cache_key"] == rep.cache_key

    def test_interrupted_write_preserves_previous_entry(self, tmp_path,
                                                        monkeypatch):
        _, rep1 = tune(tmp_path, ScriptedTimer({"vvl=8]": 0.01}))
        path = tmp_path / f"{rep1.cache_key}.json"
        before = path.read_text()

        def dying_dump(obj, fh, **kw):
            fh.write('{"cache_key": "half-writ')
            fh.flush()
            raise KeyboardInterrupt("killed mid-write")

        monkeypatch.setattr(json, "dump", dying_dump)
        with pytest.raises(KeyboardInterrupt):
            store_cached(str(tmp_path), TuneReport.from_dict(rep1.as_dict()))
        monkeypatch.undo()
        assert path.read_text() == before
        assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
        assert tune(tmp_path)[1].cache_hit

    def test_concurrent_writers_leave_valid_entry(self, tmp_path):
        _, rep = tune(tmp_path)
        errs = []

        def write():
            try:
                for _ in range(20):
                    store_cached(str(tmp_path),
                                 TuneReport.from_dict(rep.as_dict()))
            except Exception as e:       # pragma: no cover - failure path
                errs.append(e)

        threads = [threading.Thread(target=write) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errs == []
        path = tmp_path / f"{rep.cache_key}.json"
        assert json.loads(path.read_text())["cache_key"] == rep.cache_key
        assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]

    def test_cache_dir_none_disables(self, tmp_path):
        _, rep = autotune(fused_prog(), BASE, lb_state(),
                          timer=ScriptedTimer({}), cache_dir=None, reps=1,
                          warmup=0, space=["cuda"])
        assert not rep.cache_hit and os.listdir(tmp_path) == []

    def test_report_round_trips_through_json(self, tmp_path):
        _, rep = tune(tmp_path, ScriptedTimer({"cuda": 0.25}), reps=2,
                      space=["cuda"])
        back = TuneReport.from_dict(json.loads(json.dumps(rep.as_dict())),
                                    cache_hit=True)
        assert back.best == rep.best and back.results == rep.results
        assert back.cache_key == rep.cache_key and back.cache_hit


class TestCacheSchema:
    def _entry(self, tmp_path):
        _, rep = tune(tmp_path, ScriptedTimer({"vvl=8]": 0.25}))
        return rep, tmp_path / f"{rep.cache_key}.json"

    def test_entries_carry_current_schema(self, tmp_path):
        rep, path = self._entry(tmp_path)
        assert rep.schema == SCHEMA_VERSION == 3
        assert json.loads(path.read_text())["schema"] == 3

    def test_v1_entry_still_replays(self, tmp_path):
        rep, path = self._entry(tmp_path)
        d = json.loads(path.read_text())
        del d["schema"], d["rank_correlation"]
        for r in d["candidates"]:
            r.pop("predicted_s")
            r.pop("predicted_vs_measured")
        path.write_text(json.dumps(d))
        timer = ScriptedTimer({})
        _, rep2 = tune(tmp_path, timer)
        assert rep2.cache_hit and timer.calls == []
        assert rep2.best == rep.best
        assert all(r.predicted_s is None for r in rep2.results)

    def test_future_schema_is_a_miss(self, tmp_path):
        _, path = self._entry(tmp_path)
        d = json.loads(path.read_text())
        d["schema"] = 99
        path.write_text(json.dumps(d))
        timer = ScriptedTimer({})
        _, rep2 = tune(tmp_path, timer)
        assert not rep2.cache_hit and timer.calls


class TestReferenceReplay:
    """The reference's cache entries replay through the port field for
    field (the port reads the same schema-v3 JSON)."""

    def test_entry_written_by_the_reference(self, tmp_path):
        import jax.numpy as jnp
        rng = np.random.default_rng(0)
        state = {k: jnp.asarray(0.05 * rng.normal(size=(19,) + GRID),
                                jnp.float32) for k in ("f", "g")}
        prog = jlbp.fused_program("two_launch", jlbp.collision_consts(
            **JParams(**PARAMS).as_kwargs()))
        _, jrep = jat.autotune(
            prog, tdp.Target("xla"), state, space=[tdp.Target("xla", vvl=64)],
            timer=lambda t, run: 0.5 if t.vvl == 64 else 1.0,
            scorer=lambda t: 0.1, reps=2, warmup=0,
            cache_dir=str(tmp_path))
        got = load_cached(str(tmp_path), jrep.cache_key)
        want = jat.load_cached(str(tmp_path), jrep.cache_key)
        assert got is not None and got.cache_hit
        assert got.as_dict() == want.as_dict()

    @pytest.mark.parametrize("path", sorted(
        (ROOT / "results" / "tuning").glob("rmsnorm_d1024-*.json")),
        ids=lambda p: p.name)
    def test_committed_rmsnorm_entries(self, path):
        key = path.stem
        got = load_cached(str(path.parent), key)
        want = jat.load_cached(str(path.parent), key)
        assert got is not None and want is not None
        assert got.as_dict() == want.as_dict()
        assert got.best.layout == "aosoa"
        # the reference's "xla" is the port's "torch": the entry replays to
        # an AoSoA target that runs here and computes what SoA does
        tgt = got.best.target_from(BASE).with_(backend="torch")
        assert tgt.layout == "aosoa" and tgt.vvl == got.best.vvl
        x = torch.randn(300, 1024, generator=torch.Generator().manual_seed(0))
        w = torch.randn(1024, generator=torch.Generator().manual_seed(1))
        want = ops.rmsnorm(x, w, target="torch", device="cpu")
        for backend in ("torch", "cuda"):
            assert torch.equal(ops.rmsnorm(x, w, target=tgt.with_(
                backend=backend), device="cpu"), want)

    def test_interpreted_reference_entry_is_a_miss(self):
        """The reference's committed windowed entry was measured under its
        Pallas interpreter: the port has nothing to replay it on."""
        path, = (ROOT / "results" / "tuning").glob(
            "lb_fused_one-*-pallas_windowed_interpret-*.json")
        assert jat.load_cached(str(path.parent), path.stem) is not None
        assert load_cached(str(path.parent), path.stem) is None
        with pytest.raises(ValueError, match="interpreter"):
            Candidate.from_dict(json.loads(path.read_text())["best"])

    def test_port_entries_say_not_interpreted(self, tmp_path):
        _, rep = tune(tmp_path, target=SWEEP)
        d = json.loads((tmp_path / f"{rep.cache_key}.json").read_text())
        assert all(c["interpret"] is False for c in d["candidates"])
        assert jat.TuneReport.from_dict(d).best.label == rep.best.label


# ---------------------------------------------------------------------------
# predictor-guided search
# ---------------------------------------------------------------------------

def scripted_scorer(costs, default=0.05):
    def scorer(target):
        label = Candidate(target.backend, vvl=target.vvl,
                          layout=target.layout if target.layout == "aosoa"
                          else None).label
        for key, cost in costs.items():
            if key in label:
                return cost
        return default
    return scorer


class TestPredictorGuided:
    def test_top_k_measures_at_most_k_plus_one(self, tmp_path):
        scorer = scripted_scorer({"[vvl=8]": 0.001, "[vvl=4]": 0.002})
        _, rep = tune(tmp_path, target=SWEEP, scorer=scorer, top_k=2)
        measured = [r.candidate.label for r in rep.results]
        assert measured == ["cuda", "cuda[vvl=4]", "cuda[vvl=8]"]

    def test_candidate_zero_never_model_pruned(self, tmp_path):
        def worst_for_base(target):
            return 99.0 if target == SWEEP else 0.001

        _, rep = tune(tmp_path, target=SWEEP, scorer=worst_for_base, top_k=1)
        assert rep.results[0].candidate.label == "cuda"
        assert "cuda" not in dict(rep.pruned)

    def test_model_pruned_candidates_recorded_with_reason(self, tmp_path):
        _, rep = tune(tmp_path, target=SWEEP,
                      scorer=scripted_scorer({"[vvl=8]": 0.001}), top_k=1)
        mp = [why for _, why in rep.pruned if why.startswith("model-pruned")]
        cands, _ = default_space(fused_prog(), SWEEP, grid_shape=GRID)
        # every candidate but the base and the one kept
        assert len(mp) == len(cands) - 2 == 15
        assert all("predicted rank" in why for why in mp)

    def test_unscored_candidates_pruned_not_crashed(self, tmp_path):
        def flaky(target):
            if target.executor == "torch":
                raise RuntimeError("no estimate for you")
            return 0.01

        _, rep = tune(tmp_path, target=SWEEP, scorer=flaky, top_k=2)
        assert dict(rep.pruned)["torch"] == ("model-pruned: scorer returned "
                                             "no estimate")
        assert rep.results

    def test_predictions_annotate_results_and_round_trip(self, tmp_path):
        timer = ScriptedTimer({"vvl=8]": 0.01}, default=0.1)
        scorer = scripted_scorer({"vvl=8]": 0.005}, default=0.2)
        _, rep = tune(tmp_path, timer, target=SWEEP, scorer=scorer)
        for r in rep.results:
            assert r.predicted_vs_measured == pytest.approx(
                (r.predicted_s - r.median_s) / r.median_s)
        assert rep.rank_correlation is not None
        back = TuneReport.from_dict(rep.as_dict(), cache_hit=True)
        assert back.results == rep.results
        assert back.rank_correlation == pytest.approx(rep.rank_correlation)

    @pytest.mark.parametrize("steps", [1, 3, 10])
    def test_prediction_is_held_to_the_median_per_step(self, tmp_path, steps):
        """A model exact per step reads 0.0 whatever ``measure_steps`` is:
        each timed call runs ``steps`` steps of 2 ms."""
        timer = lambda tgt, run: steps * 0.002  # noqa: E731
        _, rep = tune(tmp_path, timer, target=SWEEP, measure_steps=steps,
                      scorer=lambda tgt: 0.002)
        assert rep.measure_steps == steps
        for r in rep.results:
            assert r.median_s == pytest.approx(steps * 0.002)
            assert r.predicted_vs_measured == pytest.approx(0.0, abs=1e-12)

    def test_perfect_scorer_gives_rank_correlation_one(self, tmp_path):
        costs = {"vvl=8]": 0.01, "vvl=4]": 0.02, "vvl=2]": 0.5}
        scorer = scripted_scorer({k: v / 10 for k, v in costs.items()},
                                 default=0.1)
        _, rep = tune(tmp_path, ScriptedTimer(costs), target=SWEEP,
                      scorer=scorer)
        assert rep.rank_correlation == pytest.approx(1.0)

    def test_tied_predictions_rank_nothing(self):
        """A model that predicts every candidate alike ranks nothing, even
        when the candidates were measured fastest first (the reference's
        ranking, by position among ties, gives 1.0 here)."""
        results = [CandidateResult(Candidate("torch", vvl=v), m, (m,), 0.1)
                   for v, m in ((8, 0.01), (16, 0.02), (32, 0.5))]
        assert _rank_correlation(results) is None
        assert jat._rank_correlation(results) == pytest.approx(1.0)
        results[0] = results[0]._replace(predicted_s=0.05)
        assert _rank_correlation(results) == pytest.approx(0.8660254)

    def test_default_costmodel_scorer_scores_everything(self, tmp_path):
        _, rep = tune(tmp_path, target=Target("cuda_windowed", vvl=1),
                      top_k=2)
        assert len(rep.results) <= 3
        assert all(r.predicted_s is not None and r.predicted_s > 0
                   for r in rep.results)
        # Where the step is bound by bytes, as on the card, the model cannot
        # tell the VVLs apart: equal predictions, no rank.  (The calibrated
        # CPU profile may make the 8³ step compute-bound, and the traced
        # FLOPs carry a per-chunk term that depends on the VVL.)
        h100 = costmodel.MachineProfile.default("cuda:NVIDIA H100 80GB HBM3")
        _, rep = tune(tmp_path / "h100", target=Target("cuda_windowed", vvl=1),
                      top_k=2, profile=h100)
        preds = {r.candidate.label: r.predicted_s for r in rep.results}
        assert len(preds) == 3 and len(set(preds.values())) == 1
        assert rep.rank_correlation is None


# ---------------------------------------------------------------------------
# correctness is decoupled from tuning
# ---------------------------------------------------------------------------

class TestCorrectnessDecoupling:
    def test_check_identical_accepts_honest_candidates(self, tmp_path):
        _, rep = tune(tmp_path, target=Target("cuda_windowed", vvl=1),
                      check_identical=True, measure_steps=2,
                      executors=["cuda_windowed", "cuda"])
        assert {r.candidate.label for r in rep.results} >= {
            "cuda_windowed", "cuda", "cuda_windowed[vvl=8]"}
        assert not any("bit-identical" in why for _, why in rep.pruned)

    def test_check_identical_prunes_a_lying_executor(self, tmp_path):
        def lying(plan, prepared, out=None):
            outs = torch_executor(plan, prepared)
            return tuple(o + 1e-3 for o in outs)

        register_executor("lying_torch", lying)
        try:
            tuned, rep = tune(tmp_path, ScriptedTimer({"lying": 0.001}),
                              space=["lying_torch"], check_identical=True)
            assert "bit-identical" in dict(rep.pruned)["lying_torch"]
            assert tuned == BASE
        finally:
            unregister_executor("lying_torch")

    @pytest.mark.parametrize("mode", ["one_launch", "two_launch"])
    def test_tuned_trajectory_matches_default(self, tmp_path, mode):
        """A tuned target steps the 16³ quench as the default does, at the
        port's trajectory bar."""
        grid = (16,) * 3
        params = LBParams(**PARAMS)
        base = BinaryFluidSim(grid, params, fused=mode,
                              target=Target("cuda_windowed", vvl=1),
                              device="cpu")
        st0 = base.init_spinodal(seed=3, noise=0.05)
        tuned, rep = autotune(
            base.programs["fused"], example_state={"f": st0.f, "g": st0.g},
            timer=ScriptedTimer({"cuda_windowed[vvl=4]": 0.01}), reps=1,
            warmup=0, cache_dir=str(tmp_path))
        assert tuned == Target("cuda_windowed", vvl=4)
        sim = BinaryFluidSim(grid, params, fused=mode, target=tuned,
                             device="cpu")
        a, b = base.run(st0, 10), sim.run(st0, 10)
        for x, y in ((a.f, b.f), (a.g, b.g)):
            torch.testing.assert_close(y, x, rtol=2e-4, atol=2e-5)
        mass = [float(s.f.double().sum()) for s in (a, b)]
        assert mass[1] == pytest.approx(mass[0], rel=1e-5)


# ---------------------------------------------------------------------------
# the FMA rung of csrc/calibrate.cu on the host compiler
# ---------------------------------------------------------------------------

HARNESS = r"""
#include "calibrate.cu"

extern "C" void host_fma_chain(const float* x, float* o, long long n, int k) {
  for (long long i = 0; i < n; ++i) o[i] = tdp::cal::fma_chain_value(x[i], k);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the FMA rung with")
    d = tmp_path_factory.mktemp("calibrate_host")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libharness.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{_build.CSRC}", "-o", str(lib), str(d / "harness.cpp")],
                   check=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    so.host_fma_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_int]
    return so


def fma_chain_rounded(x, k):
    """k rungs of fmaf in numpy: acc·v + v in float64, then one rounding to
    float32.  The float64 sum is exact for the inputs below (a 48-bit
    product plus a v whose bits lie inside its span: at most 50 bits), so
    this is fmaf bit for bit."""
    acc = x.copy()
    v = x.astype(np.float64)
    for _ in range(k):
        acc = (acc.astype(np.float64) * v + v).astype(np.float32)
    return acc


@pytest.mark.parametrize("k", [0, 1, 8, 1024])
def test_fma_rung_rounds_once(host_lib, k):
    """Each rung is one correctly rounded fmaf: numpy computes acc·v + v in
    float64, exact here (acc ∈ [1/4, 3), v ∈ [1/4, 3/4): a 48-bit product
    plus v spans at most 51 bits), then rounds once to float32.  The plain
    version (two roundings) stays within ``FMA_RTOL``."""
    x = np.random.default_rng(k).uniform(0.25, 0.75, 4099).astype(np.float32)
    out = np.empty_like(x)
    host_lib.host_fma_chain(x.ctypes.data, out.ctypes.data, x.size, k)
    np.testing.assert_array_equal(out, fma_chain_rounded(x, k))
    np.testing.assert_allclose(fma_chain(torch.from_numpy(x), k).numpy(), out,
                               rtol=FMA_RTOL, atol=0)


@pytest.mark.parametrize("k", [8, 1024])
def test_fma_rung_count_is_visible_near_one(host_lib, k):
    """For v in [1 - 2⁻¹⁰, 1) the chain has not converged by k = 1024
    (v^k ≥ e⁻¹), so one rung fewer moves every element by more than
    ``FMA_RTOL``: a result equal to the k-rung chain proves k rungs ran.
    (On ``[0.25, 0.75)`` the chain reaches its fixed point within ~100
    rungs and could not tell.)"""
    x = np.random.default_rng(k).uniform(1 - 2.0 ** -10, 1.0,
                                         4099).astype(np.float32)
    out = np.empty_like(x)
    host_lib.host_fma_chain(x.ctypes.data, out.ctypes.data, x.size, k)
    np.testing.assert_array_equal(out, fma_chain_rounded(x, k))
    fewer = fma_chain_rounded(x, k - 1)
    assert (np.abs(out - fewer) > FMA_RTOL * np.abs(out)).all()
