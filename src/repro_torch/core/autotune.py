"""Close the paper's tuning loop over the executor, VVL and ``Target.tuning``.

Port of the reference's ``core/autotune.py``.  The paper's claim is *tuned*
portability: one source, with per-platform knobs (the TLP/ILP split, the
virtual vector length) chosen to fit the hardware, and its sequel ("A
Lightweight Approach to Performance Portability with targetDP",
arXiv:1609.01479) says those knobs must be re-chosen on each device.
:func:`autotune`:

1. **enumerates** a space of :class:`Candidate` assignments
   (:func:`default_space`): the base target first, the executor axis
   (:func:`repro_torch.core.registry.compatible_executors`), the VVLs
   each executor's kernels are built for, the AoSoA layout at the
   reference's block widths and, where a kernel of the subject holds a
   shared-memory tile, the ``plane_block`` sweep;
2. **prunes** the points whose tile exceeds ``vmem_limit`` and, with
   ``top_k``, all but the K points the roofline model
   (:mod:`repro_torch.core.costmodel`) ranks best;
3. **measures** each survivor with a pluggable ``timer`` (median of
   ``reps`` calls of a ``measure_steps``-step run);
4. **returns** the tuned :class:`~repro_torch.core.target.Target` and a
   :class:`TuneReport`, cached on disk under a key of (subject digest,
   grid, base executor, device).

Candidates change how the same launches run, never what they compute;
``check_identical=True`` prunes any candidate whose output is not equal,
bit for bit, to the base target's.  The base target is always candidate 0,
so the tuned median never exceeds the default median.

``predicted_vs_measured`` compares the prediction, which is for one step
or launch, with the measured median over ``measure_steps`` of them, divided
by ``measure_steps``.  The reference divides by the whole median
(``repro/core/autotune.py``), which reads −(1 − 1/measure_steps) for a
model exact per launch; a report replayed from a cache keeps the ratio it
was stored with.

**Per-stage tuning** (``per_stage=True``): program-level candidates may
assign a distinct ``plane_block`` to each windowed stage that holds a
shared-memory tile, through the reserved ``Target.tuning`` keys
``"stage:<name>"`` (a frozen tuple of ``(knob, value)`` pairs, merged over
the flat tuning by
:func:`repro_torch.core.program.resolve_stage_target`).  The axis needs
two such stages: with one, per-stage is the global sweep.  Of the LB
programs only ``one_launch``'s ``fused`` holds a tile (``two_launch``'s two
windowed stages, ``phi_stream`` and ``fused_two``, hold none), so it
emits no candidate for them.

Not ported: the pointwise block knobs; no kernel of this package has one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from . import costmodel as _costmodel
from .api import launch as _launch
from .api import launch_plan as _launch_plan
from .costmodel import DEFAULT_CACHE_DIR, DEFAULT_VMEM_LIMIT
from .lattice import Lattice
from .program import CompiledProgram, Program
from .registry import (compatible_executors, executor_tunables,
                       executor_vvls, executor_wants)
from .spec import KernelSpec
from .target import Target, as_target

#: on-disk cache entry schema (the reference's): v1 entries have no
#: predictor fields, v2 add them, v3 add the per-candidate ``vvl`` and
#: ``layout`` axes.  Older entries replay with defaults; an entry from a
#: newer schema is a miss.
SCHEMA_VERSION = 3


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

def _freeze_value(v):
    """Hashable, canonical form of one tuning value: mappings (and JSON
    lists of pairs) become sorted tuples of pairs."""
    if isinstance(v, Mapping):
        return tuple(sorted((str(k), _freeze_value(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        if v and all(isinstance(x, (list, tuple)) and len(x) == 2
                     and isinstance(x[0], str) for x in v):
            return tuple(sorted((str(k), _freeze_value(x)) for k, x in v))
        return tuple(_freeze_value(x) for x in v)
    return v


def _freeze_items(mapping) -> tuple[tuple[str, Any], ...]:
    if not mapping:
        return ()
    items = (mapping.items() if isinstance(mapping, Mapping)
             else (tuple(kv) for kv in mapping))
    return tuple(sorted((str(k), _freeze_value(v)) for k, v in items))


def _is_pairs(v) -> bool:
    return (isinstance(v, tuple) and len(v) > 0
            and all(isinstance(x, tuple) and len(x) == 2
                    and isinstance(x[0], str) for x in v))


def _json_value(v):
    """The JSON form of a frozen tuning value."""
    if _is_pairs(v):
        return {k: _json_value(x) for k, x in v}
    if isinstance(v, tuple):
        return [_json_value(x) for x in v]
    return v


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the tuning space: an executor plus the ``Target``
    knobs to set.

    ``tuning`` is merged into the base target's tuning; ``vvl`` and
    ``layout`` override the base target's when set (``None`` inherits)."""

    backend: str
    tuning: tuple[tuple[str, Any], ...] = ()
    vvl: int | None = None
    layout: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "tuning", _freeze_items(self.tuning))
        if self.vvl is not None:
            object.__setattr__(self, "vvl", int(self.vvl))
        if self.layout is not None and self.layout not in ("soa", "aosoa"):
            raise ValueError(f"layout must be 'soa', 'aosoa' or None "
                             f"(inherit), got {self.layout!r}")

    def target_from(self, base: Target) -> Target:
        t = base.with_(backend=self.backend)
        if self.vvl is not None:
            t = t.with_(vvl=self.vvl)
        if self.layout is not None:
            t = t.with_(layout=self.layout)
        return t.with_tuning(dict(self.tuning)) if self.tuning else t

    @property
    def label(self) -> str:
        knobs = []
        if self.layout is not None:
            knobs.append(f"layout={self.layout}")
        if self.vvl is not None:
            knobs.append(f"vvl={self.vvl}")
        knobs += [(f"{k}{{{','.join(f'{ik}={iv}' for ik, iv in v)}}}"
                   if _is_pairs(v) else f"{k}={v}")
                  for k, v in self.tuning]
        return (f"{self.backend}[{','.join(knobs)}]" if knobs
                else self.backend)

    def as_dict(self) -> dict:
        # ``interpret`` is a field of the reference's schema: this package
        # has no interpreter, so it is always False here
        return {"backend": self.backend, "interpret": False,
                "tuning": {k: _json_value(v) for k, v in self.tuning},
                "vvl": self.vvl, "layout": self.layout}

    @classmethod
    def from_dict(cls, d: Mapping) -> "Candidate":
        """Raises ``ValueError`` for a reference entry measured under its
        Pallas interpreter, which this package cannot replay."""
        if d.get("interpret", False):
            raise ValueError(f"candidate {d['backend']!r} ran under the "
                             f"reference's Pallas interpreter")
        vvl = d.get("vvl")
        return cls(d["backend"], _freeze_items(d.get("tuning") or {}),
                   None if vvl is None else int(vvl), d.get("layout"))

    @classmethod
    def of(cls, target: Target) -> "Candidate":
        """The candidate that dispatches exactly as ``target`` does (``vvl``
        and ``layout`` inherit, so a ``vvl=None`` target keeps resolving
        its executor's default)."""
        return cls(target.backend, target.tuning)


def _effective_vvl(target: Target) -> int:
    """The VVL ``target`` launches with: under SoA an executor with
    declared VVLs resolves ``None`` to its first; the AoSoA block width is
    the process default."""
    declared = executor_vvls(target.executor)
    if target.vvl is None and declared is not None and target.layout == "soa":
        return declared[0]
    return target.resolve_vvl()


def _divisors(n: int) -> list[int]:
    n = int(n)
    small, large = [], []
    for d in range(1, math.isqrt(n) + 1):
        if n % d == 0:
            small.append(d)
            if d != n // d:
                large.append(n // d)
    return small + large[::-1]


def _vvl_values(n: int, *, lo: int = 8, hi: int = 8192,
                max_values: int = 6) -> list[int]:
    """The AoSoA block widths for a launch over ``n`` sites (or, for the
    windowed executor, ``n`` sites an x-plane): the reference's rule —
    divisors of ``n`` in ``[lo, hi]``, thinned to at most ``max_values``
    evenly spaced points (the extremes kept); ``[n]`` when ``n < lo``."""
    n = int(n)
    if n <= 0:
        return []
    vals = [d for d in _divisors(n) if lo <= d <= hi]
    if not vals:
        return [n] if n < lo else []
    if len(vals) > max_values:
        idx = np.linspace(0, len(vals) - 1, max_values).round().astype(int)
        vals = sorted({vals[i] for i in idx})
    return vals


def plane_block_candidates(spec: KernelSpec, target: Target | str | None,
                           lattice: Lattice, *, halo=None, consts=None,
                           vmem_limit: int = DEFAULT_VMEM_LIMIT):
    """The ``plane_block`` axis for one ``wants="halo_extended"`` launch.

    Emits the divisors of the launch's x-plane count (``plan.shape[0]`` —
    for a Program stage that is the *extended* plane count, interior plus
    recompute ring, as under a decomposition) whose shared-memory tile fits
    ``vmem_limit``.  Divisors, not every integer: the last tile of a
    non-divisor is cut, wasting part of a block's planes.

    Returns ``(feasible, pruned)`` — ``feasible`` the surviving
    ``plane_block`` values, ``pruned`` a list of ``(value, reason)``.
    """
    tgt = as_target(target)
    feasible: list[int] = []
    pruned: list[tuple[int, str]] = []
    base_plan = _launch_plan(spec, tgt, lattice=lattice, halo=halo,
                             consts=consts)
    for p in _divisors(base_plan.shape[0]):
        vmem = _launch_plan(spec, tgt.with_tuning(plane_block=p),
                            lattice=lattice, halo=halo,
                            consts=consts).vmem_bytes_estimate()
        if vmem <= vmem_limit:
            feasible.append(p)
        else:
            pruned.append((p, f"vmem estimate {vmem} > limit {vmem_limit}"))
    return feasible, pruned


def default_space(program_or_spec, target: Target | str | None = None, *,
                  executors: Sequence[str] | None = None,
                  grid_shape: Sequence[int] | None = None,
                  lattice: Lattice | None = None, halo=None, consts=None,
                  site_count: int | None = None,
                  vmem_limit: int = DEFAULT_VMEM_LIMIT,
                  per_stage: bool = False):
    """The default candidate space for :func:`autotune`.

    Axes:

    * the **base target** — always candidate 0;
    * the **executor axis** — ``executors`` if given, else the base
      executor and ``"torch"``, intersected with
      :func:`~repro_torch.core.registry.compatible_executors` (a pointwise
      spec never meets a ``halo_extended`` executor);
    * per executor, the **VVL axis**: the VVLs its kernels are built for
      (:func:`~repro_torch.core.registry.executor_vvls`; the CUDA
      executors: 1, 2, 4, 8 sites per thread).  An executor that declares
      none (``"torch"`` ignores the VVL) is one point;
    * per executor, the **layout axis** (the reference's rule): one
      ``layout="aosoa"`` point per block width of :func:`_vvl_values` —
      over the launch's sites (``grid_shape`` for a Program, ``lattice``
      or ``site_count`` for a spec) for a gathered executor, over the gcd
      of the windowed stages' interior plane site counts for a
      ``halo_extended`` one, whose width must divide them; a point whose
      plan cannot be built or whose tile exceeds ``vmem_limit`` is
      pruned;
    * per executor that declares the ``plane_block`` tunable, when the
      geometry is given (``grid_shape`` for a Program, ``lattice`` for a
      spec) and a kernel of the subject holds a shared-memory tile under
      it (:meth:`~repro_torch.core.api.LaunchPlan.vmem_bytes_estimate`
      > 0), the **plane_block axis**: the divisors of the x extent, at the
      base VVL.  A point whose tile exceeds ``vmem_limit`` bytes is pruned
      ("vmem estimate ... > limit ...");
    * with ``per_stage=True``, for a Program with **more than one** windowed
      stage holding a tile, a per-stage ``plane_block`` sweep: one
      candidate per (stage, divisor of that stage's extended plane count)
      under the reserved tuning key ``"stage:<name>"``, VMEM-filtered, the
      default plane_block left out.

    Returns ``(candidates, pruned)``; ``pruned`` lists ``(label, reason)``
    for the executors the launch cannot take and the tiles that do not
    fit.
    """
    base = as_target(target)
    if isinstance(program_or_spec, Program):
        has_stencil = any(st.spec.has_stencil for st in program_or_spec.stages)
    elif isinstance(program_or_spec, KernelSpec):
        has_stencil = program_or_spec.has_stencil
    else:
        raise TypeError(f"expected a Program or KernelSpec, got "
                        f"{type(program_or_spec).__name__}")

    ok = set(compatible_executors(stencil=has_stencil))
    names = ([base.executor, "torch"] if executors is None
             else [str(n) for n in executors])
    pruned: list[tuple[str, str]] = []
    candidates: list[Candidate] = [Candidate.of(base)]
    seen = {candidates[0].label}

    def add(c: Candidate):
        if c.label not in seen:
            seen.add(c.label)
            candidates.append(c)

    def vmem(tgt: Target) -> int:
        if isinstance(program_or_spec, Program):
            return program_or_spec.plan(
                tgt, grid_shape=grid_shape).vmem_bytes_estimate()
        return _launch_plan(program_or_spec, tgt, lattice=lattice, halo=halo,
                            consts=consts).vmem_bytes_estimate()

    x_extent = (grid_shape[0] if grid_shape is not None
                else lattice.shape[0] if lattice is not None else None)
    geometry = (tuple(grid_shape) if grid_shape is not None
                else lattice.shape if lattice is not None else None)
    nsites = (math.prod(int(s) for s in geometry) if geometry is not None
              else None if site_count is None else int(site_count))

    def plane_counts(tgt: Target) -> list[int]:
        """Interior site counts of an x-plane of each windowed launch."""
        if geometry is None:
            return []
        if isinstance(program_or_spec, Program):
            pplan = program_or_spec.plan(tgt, grid_shape=grid_shape)
            shapes = [p.shape for _, p in pplan.stages
                      if p.wants == "halo_extended" and p.shape is not None]
        else:
            shapes = [lattice.shape] if lattice is not None else []
        return [math.prod(int(s) for s in sh[1:]) for sh in shapes]
    for n in dict.fromkeys(names):
        if n not in ok:
            reason = ("not registered"
                      if n not in set(compatible_executors(stencil=True))
                      else "wants='halo_extended' but the launch has no "
                           "stencil field")
            pruned.append((n, reason))
            continue
        add(Candidate(n))
        probe = base.with_(backend=n)
        eff = _effective_vvl(probe)
        soa = None if base.layout == "soa" else "soa"
        for v in executor_vvls(n) or ():
            if soa is not None or v != eff:  # ≡ the bare executor candidate
                add(Candidate(n, vvl=v, layout=soa))
        if executor_wants(n) == "halo_extended":
            counts = [c for c in plane_counts(probe) if c > 0]
            widths = _vvl_values(math.gcd(*counts)) if counts else []
        else:
            widths = _vvl_values(nsites) if nsites is not None else []
        for v in widths:
            c = Candidate(n, vvl=v, layout="aosoa")
            try:
                need = vmem(c.target_from(base))
            except ValueError as e:         # an unplannable width
                pruned.append((c.label, f"error: {e}"))
                continue
            if need > vmem_limit:
                pruned.append((c.label, f"vmem estimate {need} > limit "
                                        f"{vmem_limit}"))
            else:
                add(c)
        if "plane_block" not in executor_tunables(n) or x_extent is None:
            continue
        own = vmem(probe)
        if own == 0:
            continue                           # no kernel holds a tile
        for p in _divisors(x_extent):
            need = vmem(probe.with_tuning(plane_block=p))
            if need == own:
                continue                       # ≡ the bare candidate
            c = Candidate(n, tuning=(("plane_block", p),))
            if need > vmem_limit:
                pruned.append((c.label, f"vmem estimate {need} > limit "
                                        f"{vmem_limit}"))
            else:
                add(c)
        if per_stage and isinstance(program_or_spec, Program):
            for c, need in _stage_candidates(program_or_spec, probe,
                                             grid_shape):
                if need > vmem_limit:
                    pruned.append((c.label, f"vmem estimate {need} > "
                                            f"limit {vmem_limit}"))
                else:
                    add(c)
    return candidates, pruned


def _stage_candidates(program: Program, probe: Target, grid_shape):
    """``(candidate, vmem)`` of the per-stage ``plane_block`` axis: every
    divisor of each tiled windowed stage's extended plane count under its
    ``"stage:<name>"`` key, but the default plane_block; none unless two
    stages or more hold a tile."""
    tiled = [(name, p.shape[0], p.vmem_bytes_estimate())
             for name, p in program.plan(probe, grid_shape=grid_shape).stages
             if p.wants == "halo_extended" and p.vmem_bytes_estimate() > 0]
    if len(tiled) < 2:
        return []
    out = []
    for name, count, own in tiled:
        key = f"stage:{name}"
        for v in _divisors(count):
            nested = (("plane_block", int(v)),)
            pplan = program.plan(probe.with_tuning({key: nested}),
                                 grid_shape=grid_shape)
            stage_vmem = dict(pplan.stages)[name].vmem_bytes_estimate()
            if stage_vmem != own:              # ≡ the default plane_block
                out.append((Candidate(probe.backend, tuning=((key, nested),)),
                            pplan.vmem_bytes_estimate()))
    return out


# ---------------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------------

def _leaves(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, Mapping):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    return []


def wall_clock_timer(candidate: Target, run: Callable[[], Any]) -> float:
    """The default timer: wall-clock seconds of one ``run()``.  Work already
    queued on the card is drained first, and the clock stops after the
    card has finished when a result lies on it.  Any ``(target, run) ->
    seconds`` callable can stand in (a fake for deterministic tests)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    if any(t.is_cuda for t in _leaves(out)):
        torch.cuda.synchronize()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

class CandidateResult(NamedTuple):
    """One measured point: its median, the raw samples and, when a scorer
    ran, the model's prediction with ``predicted_vs_measured`` =
    (predicted − measured) / measured, where measured is the median per
    step (``median_s / measure_steps``)."""

    candidate: Candidate
    median_s: float
    times_s: tuple[float, ...]
    predicted_s: float | None = None
    predicted_vs_measured: float | None = None

    def as_dict(self) -> dict:
        return {**self.candidate.as_dict(), "label": self.candidate.label,
                "median_s": self.median_s, "times_s": list(self.times_s),
                "predicted_s": self.predicted_s,
                "predicted_vs_measured": self.predicted_vs_measured}


@dataclasses.dataclass(frozen=True)
class TuneReport:
    """What :func:`autotune` measured and chose: one result per measured
    candidate (the base first), the pruned ``(label, reason)`` pairs, the
    winner, and whether it was replayed from the cache."""

    name: str
    grid: tuple[int, ...]
    device: str
    results: tuple[CandidateResult, ...]
    pruned: tuple[tuple[str, str], ...]
    best: Candidate
    default_median_s: float
    cache_key: str
    cache_hit: bool = False
    measure_steps: int = 1
    rank_correlation: float | None = None
    schema: int = SCHEMA_VERSION

    @property
    def best_median_s(self) -> float:
        for r in self.results:
            if r.candidate == self.best:
                return r.median_s
        raise ValueError(f"best candidate {self.best.label!r} has no "
                         f"measurement")

    def as_dict(self) -> dict:
        return {
            "schema": self.schema, "name": self.name,
            "grid": list(self.grid), "device": self.device,
            "measure_steps": self.measure_steps,
            "cache_key": self.cache_key, "cache_hit": self.cache_hit,
            "best": {**self.best.as_dict(), "label": self.best.label,
                     "median_s": self.best_median_s},
            "default_median_s": self.default_median_s,
            "rank_correlation": self.rank_correlation,
            "candidates": [r.as_dict() for r in self.results],
            "pruned": [{"label": l, "reason": r} for l, r in self.pruned],
        }

    @classmethod
    def from_dict(cls, d: Mapping, *, cache_hit: bool = False):
        def _opt(v):
            return None if v is None else float(v)

        return cls(
            name=d["name"], grid=tuple(d["grid"]), device=d["device"],
            results=tuple(
                CandidateResult(Candidate.from_dict(c), float(c["median_s"]),
                                tuple(float(t) for t in c["times_s"]),
                                _opt(c.get("predicted_s")),
                                _opt(c.get("predicted_vs_measured")))
                for c in d["candidates"]),
            pruned=tuple((p["label"], p["reason"]) for p in d["pruned"]),
            best=Candidate.from_dict(d["best"]),
            default_median_s=float(d["default_median_s"]),
            cache_key=d["cache_key"], cache_hit=cache_hit,
            measure_steps=int(d.get("measure_steps", 1)),
            rank_correlation=_opt(d.get("rank_correlation")),
            schema=int(d.get("schema", 1)))


class TuneResult(NamedTuple):
    """``(target, report)`` — tuple-unpackable."""

    target: Target
    report: TuneReport


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def _stencil_sig(s) -> str:
    return "-" if s is None else f"{s.name}:{s.offsets}"


def _spec_digest(spec: KernelSpec) -> str:
    """Cross-process identity of a spec's launch shape (roles, stencil
    geometry, outputs, const names); the body is identified by name."""
    parts = [spec.name, repr(spec.out), repr(spec.consts)]
    if spec.site_index:
        parts.append("site_index")
    for fs in spec.fields:
        parts.append(f"{fs.ncomp}|{fs.halo}|{_stencil_sig(fs.stencil)}")
    return hashlib.sha256("&".join(parts).encode()).hexdigest()[:16]


def _subject_digest(program_or_spec) -> tuple[str, str]:
    if isinstance(program_or_spec, Program):
        parts = [program_or_spec.name]
        for st in program_or_spec.stages:
            parts.append(f"{st.name}|{_spec_digest(st.spec)}|"
                         f"{st.reads}|{st.writes}")
        digest = hashlib.sha256("&".join(parts).encode()).hexdigest()[:16]
        return program_or_spec.name, digest
    return program_or_spec.name, _spec_digest(program_or_spec)


def cache_key(program_or_spec, target: Target, grid: tuple[int, ...],
              device=None) -> str:
    """``<name>-<subject digest>-g<grid>-<base executor>-<device kind>``,
    filesystem-safe; ``device`` is the torch device measured on (``None``:
    the card, ``RuntimeError`` where none is present).  The tuning values searched are not in the
    key: the key names the question, the file holds the answer."""
    name, digest = _subject_digest(program_or_spec)
    grid_s = "x".join(str(int(s)) for s in grid)
    dev = _costmodel._device_kind(device).replace(" ", "_").replace("/", "_")
    return f"{name}-{digest}-g{grid_s}-{target.backend}-{dev}"


def _cache_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"{key}.json")


def load_cached(cache_dir: str, key: str) -> TuneReport | None:
    """The stored report for ``key``, or ``None`` on a miss; a corrupt
    entry, another key's entry or a newer schema is a miss."""
    try:
        with open(_cache_path(cache_dir, key)) as fh:
            data = json.load(fh)
        if data.get("cache_key") != key:
            return None
        if int(data.get("schema", 1)) > SCHEMA_VERSION:
            return None
        return TuneReport.from_dict(data, cache_hit=True)
    except (OSError, ValueError, KeyError, TypeError):
        return None


def store_cached(cache_dir: str, report: TuneReport) -> str:
    """Persist ``report`` under its key, atomically (a private tempfile in
    ``cache_dir`` and ``os.replace``): an interrupted write never leaves a
    truncated entry, and concurrent writers each land a whole file."""
    path = _cache_path(cache_dir, report.cache_key)
    _costmodel._atomic_json(cache_dir, path, f".{report.cache_key}-",
                            report.as_dict())
    return path


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

def _as_candidates(space) -> list[Candidate]:
    out = []
    for c in space:
        if isinstance(c, Candidate):
            out.append(c)
        elif isinstance(c, (Target, str)):
            out.append(Candidate.of(as_target(c)))
        else:
            raise TypeError(f"space entries must be Candidate, Target or "
                            f"backend string; got {type(c).__name__}")
    return out


def _ranks(values) -> np.ndarray:
    """Ranks from 0, ties sharing the mean of their positions."""
    x = np.asarray(values, dtype=float)
    ranks = np.empty(len(x))
    ranks[np.argsort(x, kind="stable")] = np.arange(len(x))
    for v in np.unique(x):
        ranks[x == v] = ranks[x == v].mean()
    return ranks


def _rank_correlation(results: Sequence[CandidateResult]) -> float | None:
    """Spearman rank correlation between predicted and measured seconds
    over the measured set (``None`` with fewer than 2 scored points or a
    ranking without spread).  Tied predictions share a rank: the
    reference ranks ties by their order in the space, so a model that
    cannot tell candidates apart scores 1.0 whenever the space happens to
    list them fastest first."""
    pts = [(r.predicted_s, r.median_s) for r in results
           if r.predicted_s is not None]
    if len(pts) < 2:
        return None
    rp = _ranks([p for p, _ in pts])
    rm = _ranks([m for _, m in pts])
    if rp.std() == 0 or rm.std() == 0:
        return None
    return float(np.corrcoef(rp, rm)[0, 1])


def _default_scorer(program_or_spec, is_program: bool, grid, *, lattice,
                    halo, consts, profile) -> Callable[[Target], float | None]:
    """Plan the subject under a candidate target and predict the plan with
    :func:`repro_torch.core.costmodel.predict`; ``None`` where the model
    cannot score."""

    def scorer(tgt: Target) -> float | None:
        try:
            if is_program:
                plan = program_or_spec.plan(tgt, grid_shape=grid)
            else:
                plan = _launch_plan(program_or_spec, tgt, lattice=lattice,
                                    halo=halo, consts=consts)
            return float(_costmodel.predict(plan, profile=profile).seconds)
        except Exception:  # noqa: BLE001 — unscoreable, not fatal
            return None

    return scorer


def autotune(program_or_spec, target: Target | str | None = None,
             example_state=None, *,
             space: Sequence | None = None,
             budget: int | None = None,
             measure_steps: int = 3,
             reps: int = 3, warmup: int = 1,
             timer: Callable[[Target, Callable[[], Any]], float] | None = None,
             grid_shape: Sequence[int] | None = None,
             lattice: Lattice | None = None, halo=None, consts=None,
             executors: Sequence[str] | None = None,
             check_identical: bool = False,
             scorer: Callable[[Target], float | None] | None = None,
             top_k: int | None = None,
             profile=None,
             vmem_limit: int = DEFAULT_VMEM_LIMIT,
             per_stage: bool = False,
             cache_dir: str | None = DEFAULT_CACHE_DIR) -> TuneResult:
    """Choose the executor, VVL and ``Target.tuning`` by measurement.

    Args:
      program_or_spec: a :class:`Program`, a :class:`CompiledProgram` (its
        program, target and grid are reused) or a :class:`KernelSpec`.
      target: the base target, always measured as candidate 0.
      example_state: what a measurement runs on — ``{field: (ncomp,
        *grid)}`` tensors for programs, a sequence of ``(ncomp, nsites)``
        tensors for specs.  Its device is the one tuned for.
      space: an explicit list of :class:`Candidate`\\ s, ``Target``\\ s or
        backend names; ``None`` derives :func:`default_space`.
      budget: measure at most this many candidates (the base is kept).
      measure_steps: steps (programs) or launches (specs) per timed call.
      reps / warmup: timed calls per candidate (median taken) / discarded
        leading calls.
      timer: ``(candidate_target, run) -> seconds``; default
        :func:`wall_clock_timer`.
      grid_shape / lattice / halo / consts: launch geometry (programs take
        ``grid_shape`` from ``example_state``).
      executors / vmem_limit / per_stage: forwarded to
        :func:`default_space` (a ``plane_block`` point whose tile needs more
        than ``vmem_limit`` bytes of shared memory is pruned before any
        measurement; ``per_stage`` adds the ``"stage:<name>"`` axis).
      check_identical: run every candidate once more and prune any whose
        outputs are not equal (``torch.equal``) to the base target's.
      scorer: ``(candidate_target) -> predicted seconds | None``; defaults
        to the roofline model.  Measured candidates record their
        prediction and the report the Spearman ``rank_correlation``.
      top_k: measure only the base and the ``top_k`` best-predicted
        candidates; the rest land in ``report.pruned`` ("model-pruned").
      profile: the :class:`~repro_torch.core.costmodel.MachineProfile` of
        the default scorer (``None``: :func:`~repro_torch.core.costmodel.
        machine_profile` of the state's device).
      cache_dir: the on-disk cache (``None`` disables it); a hit replays
        the stored choice without measuring.

    Returns a :class:`TuneResult` ``(tuned_target, report)``.
    """
    if isinstance(program_or_spec, CompiledProgram):
        if target is None:
            target = program_or_spec.target
        if grid_shape is None:
            grid_shape = program_or_spec.grid_shape
        program_or_spec = program_or_spec.program
    base = as_target(target)

    is_program = isinstance(program_or_spec, Program)
    if is_program:
        if example_state is None:
            raise ValueError("autotune over a Program needs example_state "
                             "({field: (ncomp, *grid) tensor})")
        state = {f: example_state[f] for f in program_or_spec.fields}
        if grid_shape is None:
            grid_shape = next(iter(state.values())).shape[1:]
        grid = tuple(int(s) for s in grid_shape)
        device = next(iter(state.values())).device
    elif isinstance(program_or_spec, KernelSpec):
        if example_state is None:
            raise ValueError("autotune over a KernelSpec needs example_state "
                             "(the launch tensors)")
        arrays = tuple(example_state)
        if program_or_spec.has_stencil and lattice is None:
            raise ValueError("autotune over a stencil KernelSpec needs the "
                             "lattice")
        grid = (tuple(lattice.shape) if lattice is not None
                else (int(arrays[0].shape[-1]),))
        device = arrays[0].device
    else:
        raise TypeError(f"autotune expects a Program, CompiledProgram or "
                        f"KernelSpec; got {type(program_or_spec).__name__}")

    key = cache_key(program_or_spec, base, grid, device)
    if cache_dir is not None:
        cached = load_cached(cache_dir, key)
        if cached is not None:
            return TuneResult(cached.best.target_from(base), cached)

    if space is None:
        candidates, pruned = default_space(
            program_or_spec, base, executors=executors,
            grid_shape=grid if is_program else None, lattice=lattice,
            halo=halo, consts=consts,
            site_count=None if is_program or lattice is not None else grid[0],
            vmem_limit=vmem_limit, per_stage=per_stage)
    else:
        pruned = []
        base_cand = Candidate.of(base)
        candidates = [base_cand] + [c for c in _as_candidates(space)
                                    if c != base_cand]
    if budget is not None and len(candidates) > max(1, int(budget)):
        kept = candidates[:max(1, int(budget))]
        pruned += [(c.label, f"over budget={budget}")
                   for c in candidates[len(kept):]]
        candidates = kept

    # the predictor pass: every candidate scored (None where it cannot be)
    if scorer is None:
        if profile is None:
            profile = _costmodel.machine_profile(device)
        scorer = _default_scorer(program_or_spec, is_program, grid,
                                 lattice=lattice, halo=halo, consts=consts,
                                 profile=profile)
    scores: dict[str, float | None] = {}
    for c in candidates:
        try:
            s = scorer(c.target_from(base))
        except Exception:  # noqa: BLE001 — a scorer failure never blocks
            s = None
        scores[c.label] = None if s is None else float(s)

    if top_k is not None:
        k = max(0, int(top_k))
        rest = candidates[1:]            # candidate 0 is never model-pruned
        ranked = sorted((c for c in rest if scores[c.label] is not None),
                        key=lambda c: scores[c.label])
        keep = {c.label for c in ranked[:k]}
        for rank, c in enumerate(ranked[k:], start=k + 1):
            pruned.append((c.label, f"model-pruned: predicted rank {rank} > "
                                    f"top_k={k} ({scores[c.label]:.3g}s)"))
        pruned += [(c.label, "model-pruned: scorer returned no estimate")
                   for c in rest if scores[c.label] is None]
        candidates = [candidates[0]] + [c for c in rest if c.label in keep]

    timer = timer if timer is not None else wall_clock_timer
    n_steps = max(1, int(measure_steps))

    def runner(tgt: Target) -> Callable[[], Any]:
        if is_program:
            exe = program_or_spec.compile(tgt, grid_shape=grid)
            return lambda: exe.run(state, n_steps)

        def run():
            out = None
            for _ in range(n_steps):
                out = _launch(program_or_spec, tgt, *arrays, lattice=lattice,
                              halo=halo, consts=dict(consts or {}))
            return out
        return run

    ref_out = None
    results: list[CandidateResult] = []
    default_median = None
    for i, cand in enumerate(candidates):
        try:
            tgt = cand.target_from(base)
            run = runner(tgt)
            if check_identical:
                flat = _leaves(run())
                if i == 0:
                    ref_out = flat
                elif (len(flat) != len(ref_out)
                      or not all(torch.equal(a, b)
                                 for a, b in zip(ref_out, flat))):
                    pruned.append((cand.label, "output not bit-identical to "
                                               "the default target"))
                    continue
            for _ in range(max(0, int(warmup))):
                timer(tgt, run)
            times = tuple(float(timer(tgt, run))
                          for _ in range(max(1, int(reps))))
        except Exception as e:  # noqa: BLE001 — an unrunnable candidate...
            if i == 0:
                raise           # ...is pruned, but the base must run
            pruned.append((cand.label, f"error: {type(e).__name__}: {e}"))
            continue
        median = float(np.median(times))
        if i == 0:
            default_median = median
        predicted = scores.get(cand.label)
        # the model predicts one step (or launch); a timed call runs n_steps
        per_step = median / n_steps
        pvm = ((predicted - per_step) / per_step
               if predicted is not None and median > 0 else None)
        results.append(CandidateResult(cand, median, times, predicted, pvm))

    # min() keeps the first minimum and the base is measured first: an
    # exact tie goes to the default dispatch
    best = min(results, key=lambda r: r.median_s).candidate
    report = TuneReport(
        name=_subject_digest(program_or_spec)[0], grid=grid,
        device=_costmodel._device_kind(device), results=tuple(results),
        pruned=tuple(pruned), best=best,
        default_median_s=float(default_median), cache_key=key,
        cache_hit=False, measure_steps=n_steps,
        rank_correlation=_rank_correlation(results))
    if cache_dir is not None:
        store_cached(cache_dir, report)
    return TuneResult(best.target_from(base), report)
