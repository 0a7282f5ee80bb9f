"""The port's cost model against the JAX package's.

* the roofline (``roofline_seconds``) equals the reference's, field for
  field, on the reference tests' inputs and on seeded sweeps;
* ``kernel_flops`` — the plain body traced on ``meta`` tensors — agrees
  with the reference's jaxpr count within 10 % on every LB spec and the
  LM site functions, and exactly on the reference's pointwise cases;
* the memory models and ``predict(...).hbm_bytes`` equal the reference's
  for the 16³ LB stages, and the port's shared-memory model keeps the
  windowed 128³ plans unspilled;
* the calibration kernels' plain versions agree with the reference's two
  Pallas kernels (rebuilt here in interpret mode): exactly for the add, at
  ``FMA_RTOL`` for the FMA chain;
* profiles: the cache, the data-sheet H100 row, the reference's committed
  profiles (the interpreter's is refused by ``predict``), and CPU
  calibration.
"""
import dataclasses
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import repro.kernels.lm as jlm
import repro.lb.stencil as jst
from repro import tdp
from repro.core import costmodel as jcm
from repro.lb import programs as jlbp
from repro.lb.params import LBParams as JParams
from repro_torch.core import Lattice, Target, costmodel as tcm, field, kernel
from repro_torch.core.api import launch_plan
from repro_torch.kernels import calibrate as tcal
from repro_torch.kernels import lm as tlm
from repro_torch.lb import programs as tlbp
from repro_torch.lb import stencil as tst
from repro_torch.lb.params import LBParams as TParams

ROOT = pathlib.Path(__file__).resolve().parents[1]
TUNING = ROOT / "results" / "tuning"
GRID = (16, 16, 16)
PHYS = dict(A=0.125, B=0.125, kappa=0.02)
H100 = "cuda:NVIDIA H100 80GB HBM3"

#: fixed rates (the reference tests'), so every expectation is hand-computable
RATES = dict(device="test", peak_flops=1e9, hbm_bw=1e8, vmem_bytes=1024,
             link_bw=1e7, source="test")
TPROF = tcm.MachineProfile(**RATES)
JPROF = jcm.MachineProfile(**RATES)
JIPROF = dataclasses.replace(JPROF, interpret=True)


def _programs(lbp, params):
    consts = lbp.collision_consts(**params(**PHYS).as_kwargs())
    return {"step": lbp.unfused_step_program(consts),
            "collide": lbp.collide_program(consts),
            "stream": lbp.stream_program(),
            "one_launch": lbp.fused_program("one_launch", consts),
            "two_launch": lbp.fused_program("two_launch", consts)}


TPROGS = _programs(tlbp, TParams)
JPROGS = _programs(jlbp, JParams)


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

#: (flops, hbm_bytes, vmem_bytes, comm_bytes): the reference tests' cases
#: (tests/test_costmodel.py:72-110) and a seeded sweep
ROOFLINE_CASES = [(1e9, 1e8, 0, 0), (1e10, 1e6, 0, 0), (1e3, 1e8, 0, 0),
                  (1e3, 1e8, 4096, 0), (1e3, 1e3, 0, 1e8), (0, 1e8, 0, 0),
                  (0, 1e8, 2048, 0), (1e6, 1e6, 0, 0)] + [
    tuple(float(v) for v in np.random.default_rng(i).uniform(
        0, [1e12, 1e10, 1e7, 1e9])) for i in range(8)]


class TestRoofline:
    @pytest.mark.parametrize("case", ROOFLINE_CASES)
    def test_equals_reference(self, case):
        f, h, v, c = case
        got = tcm.roofline_seconds(f, h, vmem_bytes=v, comm_bytes=c,
                                   profile=TPROF)
        want = jcm.roofline_seconds(f, h, vmem_bytes=v, comm_bytes=c,
                                    profile=JPROF)
        assert got.as_dict() == want.as_dict()
        json.dumps(got.as_dict())

    def test_hand_computed_terms_and_bottlenecks(self):
        est = tcm.roofline_seconds(1e9, 1e8, profile=TPROF)
        assert (est.t_compute, est.t_hbm, est.seconds) == (1.0, 1.0, 1.0)
        assert est.bottleneck == "compute"          # ties go to compute
        assert tcm.roofline_seconds(1e3, 1e8, profile=TPROF).bottleneck == "hbm"
        assert tcm.roofline_seconds(1e3, 1e8, vmem_bytes=4096,
                                    profile=TPROF).bottleneck == "vmem-spill"
        assert tcm.roofline_seconds(1e3, 1e3, comm_bytes=1e8,
                                    profile=TPROF).bottleneck == "comm"
        spilled = tcm.roofline_seconds(0, 1e8, vmem_bytes=2048, profile=TPROF)
        assert spilled.t_hbm == pytest.approx(2.0)

    @pytest.mark.parametrize("axis", [0, 1, 2, 3])
    def test_monotone_in_each_input(self, axis):
        rng = np.random.default_rng(axis)
        for _ in range(50):
            lo = [float(x) for x in rng.uniform(0, [1e12, 1e10, 1e7, 1e9])]
            hi = list(lo)
            hi[axis] *= 1 + float(rng.uniform(0, 3))
            a, b = (tcm.roofline_seconds(p[0], p[1], vmem_bytes=p[2],
                                         comm_bytes=p[3], profile=TPROF)
                    for p in (lo, hi))
            assert b.seconds >= a.seconds


# ---------------------------------------------------------------------------
# FLOP counting
# ---------------------------------------------------------------------------

@kernel(fields=[field(2)], out=2)
def double2(x):
    return x + x


@kernel(fields=[field(1)], out=1)
def three_ops(x):
    return (x + x) * x + x


class TestKernelFlops:
    @pytest.mark.parametrize("body,per_site", [("double2", 2),
                                               ("three_ops", 3)])
    def test_pointwise_exact(self, body, per_site):
        """The reference's hand-countable cases (tests/test_costmodel.py:
        183-200), exactly, and equal to its count."""
        nsites = int(np.prod(GRID))
        got = tcm.kernel_flops(launch_plan(
            globals()[body], Target("torch", vvl=64), lattice=Lattice(GRID)))
        jspec = tdp.kernel(fields=[tdp.field(2 if body == "double2" else 1)],
                           out=2 if body == "double2" else 1)(
            (lambda x: x + x) if body == "double2"
            else (lambda x: (x + x) * x + x))
        want = jcm.kernel_flops(tdp.launch_plan(
            jspec, tdp.Target("xla", vvl=64), lattice=tdp.Lattice(GRID)))
        assert got == per_site * nsites == want

    # Per-op gaps (16³, VVL 64): einsum lowers to bmm, charged 2·M·N·K as
    # the reference's dot_general, and sums count their input, as
    # reduce_sum.  collide, fused, fused_two: +19 flop per chunk (+0.297
    # per site of 913-1052) — (1 - 1/2τ)·w multiplies a (19, 1) tensor
    # here, numpy constants folded at trace time there.  rmsnorm: 262
    # against 264 per token — jnp.mean is reduce_sum + div, torch's mean
    # one reduction.  gelu/silu: one ATen op each, charged as the
    # reference's decomposition (15 and 9), so the gated counts are equal.
    @pytest.mark.parametrize("name", sorted(tst.SPECS))
    def test_lb_specs_match_reference(self, name):
        tspec = tst.SPECS[name]
        jspec = getattr(jst, f"{name.upper()}_SPEC")
        consts = (tlbp.collision_consts(**TParams(**PHYS).as_kwargs())
                  if tspec.consts else {})
        jconsts = (jlbp.collision_consts(**JParams(**PHYS).as_kwargs())
                   if jspec.consts else {})
        got = tcm.kernel_flops(launch_plan(tspec, Target("torch", vvl=64),
                                           lattice=Lattice(GRID),
                                           consts=consts))
        want = jcm.kernel_flops(tdp.launch_plan(
            jspec, tdp.Target("xla", vvl=64), lattice=tdp.Lattice(GRID),
            consts=jconsts))
        assert want > 0 or name == "stream"
        assert got == pytest.approx(want, rel=0.10)

    @pytest.mark.parametrize("which", ["rmsnorm"] + [
        f"{k}-{g}" for k in tlm.GATED_KINDS for g in ("gated", "act")])
    def test_lm_sites_match_reference(self, which):
        n, d = 512, 64
        lat_t, lat_j = Lattice((n,)), tdp.Lattice((n,))
        if which == "rmsnorm":
            w = np.linspace(-1, 1, d, dtype=np.float32)
            tplan = launch_plan(tlm.rmsnorm_spec(d), Target("torch", vvl=64),
                                lattice=lat_t, consts=dict(
                                    weight=torch.from_numpy(w), eps=1e-6,
                                    scale_offset=1.0))
            jplan = tdp.launch_plan(jlm.rmsnorm_spec(d),
                                    tdp.Target("xla", vvl=64), lattice=lat_j,
                                    consts=dict(weight=jnp.asarray(w),
                                                eps=1e-6, scale_offset=1.0))
        else:
            kind, g = which.split("-")
            tplan = launch_plan(tlm.gated_act_spec(kind, g == "gated"),
                                Target("torch", vvl=64), lattice=lat_t)
            jplan = tdp.launch_plan(jlm.gated_act_spec(kind, g == "gated"),
                                    tdp.Target("xla", vvl=64), lattice=lat_j)
        want = jcm.kernel_flops(jplan)
        assert want > 0
        assert tcm.kernel_flops(tplan) == pytest.approx(want, rel=0.10)

    def test_untraceable_body_counts_zero(self):
        @kernel(fields=[field(1)], out=1)
        def host_bound(x):
            return x * float(x.sum())          # a value the meta trace lacks

        plan = launch_plan(host_bound, Target("torch"), lattice=Lattice(GRID))
        assert tcm.kernel_flops(plan) == 0.0
        assert tcm.kernel_flops(launch_plan(double2, Target("torch"))) == 0.0


# ---------------------------------------------------------------------------
# memory models and predict
# ---------------------------------------------------------------------------

EXEC_PAIRS = [("torch", tdp.Target("xla")),
              ("cuda_windowed", tdp.Target("pallas_windowed", interpret=True))]


class TestMemoryModels:
    @pytest.mark.parametrize("prog", sorted(TPROGS))
    @pytest.mark.parametrize("pair", range(len(EXEC_PAIRS)))
    def test_hbm_estimates_equal_reference(self, prog, pair):
        texe, jtgt = EXEC_PAIRS[pair]
        tplan = TPROGS[prog].plan(texe, grid_shape=GRID)
        jplan = JPROGS[prog].plan(jtgt, grid_shape=GRID)
        assert ([n for n, _ in tplan.stages] == [n for n, _ in jplan.stages])
        for (_, tp), (_, jp) in zip(tplan.stages, jplan.stages):
            assert tp.wants == jp.wants
            assert tp.hbm_bytes_estimate() == jp.hbm_bytes_estimate()
        assert tplan.hbm_bytes_estimate() == jplan.hbm_bytes_estimate()
        got = tcm.predict(tplan, profile=TPROF)
        want = jcm.predict(jplan, profile=JIPROF if jtgt.interpret else JPROF)
        assert got.hbm_bytes == want.hbm_bytes
        assert ([r["hbm_bytes"] for r in got.per_stage]
                == [r["hbm_bytes"] for r in want.per_stage])

    @pytest.mark.parametrize("mode", ["one_launch", "two_launch"])
    def test_windowed_128_cubed_is_not_spilled(self, mode):
        """The reference charges its windowed executor a (plane_block +
        2r)-plane window of the extended grid — megabytes at 128³, which
        against a block's 227 KB would multiply the HBM term.  The port's
        kernels stage nothing, so the term is bytes over bandwidth."""
        grid = (128,) * 3
        prof = tcm.MachineProfile.default(H100)
        plan = TPROGS[mode].plan("cuda_windowed", grid_shape=grid)
        est = tcm.predict(plan, profile=prof)
        assert est.bottleneck == "hbm" and est.vmem_bytes == 0
        assert all(r["bottleneck"] != "vmem-spill" for r in est.per_stage)
        assert est.t_hbm == pytest.approx(plan.hbm_bytes_estimate()
                                          / prof.hbm_bw)
        jplan = JPROGS[mode].plan(tdp.Target("pallas_windowed"),
                                  grid_shape=grid)
        assert jplan.vmem_bytes_estimate() > prof.vmem_bytes


class TestPredict:
    def test_launch_plan(self):
        plan = launch_plan(double2, Target("torch", vvl=64),
                           lattice=Lattice(GRID))
        est = tcm.predict(plan, profile=TPROF)
        assert est.seconds > 0 and est.source == "analytic"
        assert len(est.per_stage) == 1

    def test_program_plan_and_compiled_agree(self):
        prog = TPROGS["two_launch"]
        a = tcm.predict(prog, "cuda_windowed", TPROF, grid_shape=GRID)
        b = tcm.predict(prog.plan("cuda_windowed", grid_shape=GRID),
                        profile=TPROF)
        c = tcm.predict(prog.compile("cuda_windowed", grid_shape=GRID),
                        profile=TPROF)
        assert a == b == c
        assert [r["stage"] for r in a.per_stage] == ["phi_stream", "fused_two"]
        assert a.seconds == pytest.approx(
            sum(r["seconds"] for r in a.per_stage) + a.t_comm)

    def test_sources(self):
        prog = TPROGS["one_launch"]
        with pytest.raises(NotImplementedError, match="item 8"):
            tcm.predict(prog.compile("torch", grid_shape=GRID),
                        profile=TPROF, source="hlo")
        with pytest.raises(ValueError, match="source"):
            tcm.predict(prog, "torch", TPROF, grid_shape=GRID,
                        source="vibes")
        with pytest.raises(ValueError, match="grid_shape"):
            tcm.predict(prog, "torch", TPROF)
        with pytest.raises(TypeError):
            tcm.predict(object(), profile=TPROF)

    @pytest.mark.parametrize("prog", sorted(TPROGS))
    def test_no_comm_or_spill_term(self, prog):
        """One device and no shared-memory window: the step is the sum of
        its stages' rooflines, each flops/peak against bytes/bandwidth."""
        est = tcm.predict(TPROGS[prog], "cuda_windowed", TPROF,
                          grid_shape=GRID)
        assert est.t_comm == est.comm_bytes == est.vmem_bytes == 0
        assert est.seconds == pytest.approx(
            sum(max(r["flops"] / TPROF.peak_flops,
                    r["hbm_bytes"] / TPROF.hbm_bw) for r in est.per_stage))
        assert est.bottleneck in ("compute", "hbm")


# ---------------------------------------------------------------------------
# the calibration kernels
# ---------------------------------------------------------------------------

N_REF = 1 << 14            # the reference's calibration shape


def _ref_add(x, y):
    def add_kernel(x_ref, y_ref, o_ref):           # core/costmodel.py:190
        o_ref[...] = x_ref[...] + y_ref[...]

    return pl.pallas_call(
        add_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(x, y)


def _ref_fma(x, k):
    def fma_kernel(x_ref, o_ref):                  # core/costmodel.py:202
        v = x_ref[...]
        acc = v
        for _ in range(k):
            acc = acc * v + v
        o_ref[...] = acc

    return pl.pallas_call(
        fma_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(x)


def _draw(seed, n=N_REF):
    return np.random.default_rng(seed).uniform(0.25, 0.75, n).astype(
        np.float32)


class TestCalibrationKernels:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_stream_add_matches_reference_exactly(self, seed):
        x, y = _draw(seed), _draw(seed + 10)
        want = np.asarray(_ref_add(jnp.asarray(x), jnp.asarray(y)))
        before = dict(tcal.launches)
        got = tcal.stream_add(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_array_equal(got.numpy(), want)
        assert tcal.launches == before          # CPU tensors: no kernel

    @pytest.mark.parametrize("k", [0, 1, 8])
    def test_fma_chain_matches_reference(self, k):
        x = _draw(k)
        want = np.asarray(_ref_fma(jnp.asarray(x), k))
        got = tcal.fma_chain(torch.from_numpy(x), k).numpy()
        np.testing.assert_allclose(got, want, rtol=tcal.FMA_RTOL, atol=0)

    def test_wrappers_refuse_what_no_kernel_takes(self):
        x = torch.empty(8, device="meta")
        with pytest.raises(ValueError):
            tcal.stream_add(x, x)
        with pytest.raises(ValueError):
            tcal.fma_chain(x, 2)
        with pytest.raises(ValueError, match="k"):
            tcal.fma_chain(torch.ones(4), -1)
        with pytest.raises(ValueError, match="operand 1"):
            tcal.stream_add(torch.ones(4, device="meta"),
                            torch.ones(5, device="meta"))


# ---------------------------------------------------------------------------
# machine profiles
# ---------------------------------------------------------------------------

class TestMachineProfile:
    def test_cache_round_trip(self, tmp_path):
        p = tcm.store_profile(str(tmp_path), TPROF)
        assert p == tcm.profile_path(str(tmp_path), "test")
        back = tcm.load_profile(str(tmp_path), "test")
        assert dataclasses.replace(back, source="test") == TPROF
        assert back.source == "cached"
        assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]

    def test_corrupt_or_foreign_file_is_a_miss(self, tmp_path):
        path = tcm.profile_path(str(tmp_path), "test")
        with open(path, "w") as fh:
            fh.write("{not json")
        assert tcm.load_profile(str(tmp_path), "test") is None
        tcm.store_profile(str(tmp_path), TPROF)
        d = json.load(open(path))
        d["device"] = "other"
        json.dump(d, open(path, "w"))
        assert tcm.load_profile(str(tmp_path), "test") is None
        assert tcm.load_profile(str(tmp_path), "test", interpret=True) is None

    def test_machine_profile_memo_and_table(self, tmp_path):
        got = tcm.machine_profile("cpu", cache_dir=str(tmp_path),
                                  calibrate_if_missing=False)
        assert got.source == "default" and got.device == "cpu:cpu"
        assert not os.listdir(tmp_path)         # store=False never writes
        assert tcm.machine_profile("cpu", cache_dir=str(tmp_path)) is got
        other = tmp_path / "other"
        tcm.store_profile(str(other), dataclasses.replace(TPROF,
                                                          device="cpu:cpu"))
        hit = tcm.machine_profile("cpu", cache_dir=str(other))
        assert hit.source == "cached" and hit.peak_flops == TPROF.peak_flops
        stored = tmp_path / "stored"
        fresh = tcm.machine_profile("cpu", cache_dir=str(stored), store=True)
        assert fresh.source == "calibrated"
        assert (tcm.load_profile(str(stored), "cpu:cpu").peak_flops
                == fresh.peak_flops)

    def test_h100_row_is_the_data_sheet(self):
        p = tcm.MachineProfile.default(H100)
        assert (p.peak_flops, p.hbm_bw, p.hbm_bytes, p.vmem_bytes,
                p.link_bw) == (67e12, 3.35e12, 80 * 10 ** 9, 232_448, 450e9)
        assert tcm.MachineProfile.default("cuda:NVIDIA A100").peak_flops \
            == jcm.MachineProfile.default("gpu:A100").peak_flops
        assert tcm.MachineProfile.default("cpu:cpu").hbm_bw \
            == jcm.MachineProfile.default("cpu:cpu").hbm_bw

    def test_reference_profile_loads_with_equal_fields(self):
        got = tcm.load_profile(str(TUNING), "cpu:cpu")
        want = jcm.load_profile(str(TUNING), "cpu:cpu", False)
        assert got is not None and got.as_dict() == dataclasses.asdict(want)
        plan = TPROGS["one_launch"].plan("torch", grid_shape=GRID)
        assert tcm.predict(plan, profile=got).seconds > 0

    def test_interpreter_profile_is_refused(self):
        prof = tcm.load_profile(str(TUNING), "cpu:cpu", interpret=True)
        want = jcm.load_profile(str(TUNING), "cpu:cpu", True)
        assert prof.as_dict() == dataclasses.asdict(want)
        plan = TPROGS["one_launch"].plan("torch", grid_shape=GRID)
        with pytest.raises(ValueError, match="interpret"):
            tcm.predict(plan, profile=prof)

    def test_calibrate_cpu(self):
        prof = tcm.calibrate(device="cpu", reps=2)
        assert prof.source == "calibrated" and prof.device == "cpu:cpu"
        assert prof.peak_flops > 0 and prof.hbm_bw > 0
        assert prof.vmem_bytes == tcm.MachineProfile.default("cpu:cpu").vmem_bytes

    def test_calibrate_without_a_card_raises(self, monkeypatch):
        """``device=None`` is the card; with none present ``calibrate``
        raises instead of measuring the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcm.calibrate()

    @pytest.mark.parametrize("entry", ["machine_profile", "default",
                                       "predict"])
    def test_no_device_means_the_card(self, monkeypatch, tmp_path, entry):
        """``machine_profile()``, ``MachineProfile.default()`` and
        ``predict`` without a profile resolve ``None`` to the card, and
        raise where none is present."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        plan = TPROGS["one_launch"].plan("torch", grid_shape=GRID)
        call = {"machine_profile": lambda: tcm.machine_profile(
                    cache_dir=str(tmp_path)),
                "default": tcm.MachineProfile.default,
                "predict": lambda: tcm.predict(plan)}[entry]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
