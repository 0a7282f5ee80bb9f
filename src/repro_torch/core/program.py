"""``Program`` — declarative multi-launch step graphs (single device).

A real lattice application step (the Ludwig binary fluid,
:class:`repro_torch.lb.sim.BinaryFluidSim`) is a short *pipeline* of
launches plus host-side glue.  A :class:`Program` is that graph,
declaratively:

* a **Stage** binds one :class:`~repro_torch.core.spec.KernelSpec` to named
  values — ``reads`` (one name per declared field, in order) and ``writes``
  (one name per declared output) — plus its ``TARGET_CONST`` bindings;
* a **Program** is an ordered tuple of stages over two kinds of names:
  **fields** (persistent step state — what ``step``/``run`` carry from one
  step to the next) and **intermediates** (step-local values, written
  before read, never kept across steps).

Compiling a Program (:meth:`Program.compile`) binds it to one target and
grid, adding the glue applications used to hand-write:

a. **per-stage target routing** — each stage dispatches to the requested
   target, except pointwise stages under a stencil-only
   (``wants="halo_extended"``) executor, which route to that executor's
   pointwise partner: ``"cuda"`` under ``"cuda_windowed"``; a
   stencil-only executor with no partner raises
   (:func:`resolve_stage_target`);
b. **the halo schedule** — ghost requirements back-propagated through the
   stage graph (:meth:`Program.schedule`); on one device every dimension
   wraps inside each launch, and :meth:`Program.execute` uses the schedule
   to check caller-supplied ghost planes;
c. **ping-pong buffers** — :meth:`CompiledProgram.run` steps ``nsteps``
   times in a Python loop over two preallocated state buffers: each
   field's final writer launches straight into the idle buffer (the
   reference's ``lax.scan`` with donated buffers);
d. **aggregated memory models** — :meth:`Program.plan` builds one
   :class:`~repro_torch.core.api.LaunchPlan` per stage, sums their
   ``hbm_bytes_estimate`` and takes the largest ``vmem_bytes_estimate``.

Domain decompositions (a ``mesh``) are not ported yet: see ROADMAP,
queue A, "Decompositions".
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Mapping, Sequence

import torch

from .api import _normalize_halo
from .api import launch as _launch
from .api import launch_plan as _launch_plan
from .lattice import Lattice
from .registry import executor_wants
from .spec import KernelSpec
from .state import validate_field
from .target import Target, as_target

#: Pointwise partner of each stencil-only executor (``wants="halo_extended"``):
#: the gathered executor a pointwise stage routes to under it.  A pointwise
#: stage under a stencil-only executor missing here raises.
_POINTWISE_PARTNER = {"cuda_windowed": "cuda"}


# ---------------------------------------------------------------------------
# Stage — one KernelSpec bound to named values
# ---------------------------------------------------------------------------

def _as_names(x, what: str) -> tuple[str, ...]:
    if isinstance(x, str):
        x = (x,)
    names = tuple(str(n) for n in x)
    if not names:
        raise ValueError(f"a stage needs at least one {what} name")
    return names


def _freeze_consts(consts) -> tuple[tuple[str, Any], ...]:
    if not consts:
        return ()
    items = (sorted(consts.items()) if isinstance(consts, Mapping)
             else sorted(tuple(kv) for kv in consts))
    for k, _ in items:
        if not isinstance(k, str):
            raise TypeError(f"const names must be strings, got {k!r}")
    return tuple((k, v) for k, v in items)


@dataclass(frozen=True)
class Stage:
    """One launch of the step graph: a :class:`KernelSpec` bound to named
    program values.

    Args:
      spec: the kernel.  Its output counts must be declared (``out=``).
      reads: one name per declared field, in declaration order.
      writes: one name per declared output.  Writing a *field* name
        defines that field's next-step value; writing an *intermediate*
        name binds a step-local value for later stages.
      consts: ``TARGET_CONST`` bindings for this stage.
      name: display name (defaults to the spec's).
    """

    spec: KernelSpec
    reads: tuple[str, ...]
    writes: tuple[str, ...]
    consts: tuple[tuple[str, Any], ...] = dc_field(default=())
    name: str = ""

    def __post_init__(self):
        if not isinstance(self.spec, KernelSpec):
            raise TypeError(f"stage spec must be a KernelSpec, got "
                            f"{type(self.spec).__name__}")
        object.__setattr__(self, "reads", _as_names(self.reads, "read"))
        object.__setattr__(self, "writes", _as_names(self.writes, "write"))
        object.__setattr__(self, "consts", _freeze_consts(self.consts))
        if not self.name:
            object.__setattr__(self, "name", self.spec.name)
        if len(self.reads) != len(self.spec.fields):
            raise ValueError(
                f"stage {self.name!r} binds {len(self.reads)} read(s) but "
                f"kernel {self.spec.name!r} declares "
                f"{len(self.spec.fields)} field(s)")
        if self.spec.out is None:
            raise ValueError(
                f"stage {self.name!r}: kernel {self.spec.name!r} must "
                f"declare out= to participate in a Program (outputs are "
                f"wired to names)")
        if len(self.writes) != len(self.spec.out):
            raise ValueError(
                f"stage {self.name!r} binds {len(self.writes)} write(s) "
                f"but kernel {self.spec.name!r} declares "
                f"{len(self.spec.out)} output(s)")

    def consts_dict(self) -> dict:
        return dict(self.consts)


def stage(spec: KernelSpec, reads, writes, *, consts=None,
          name: str | None = None) -> Stage:
    """Ergonomic :class:`Stage` constructor (accepts bare-string names and
    dict consts)."""
    return Stage(spec, reads, writes, consts=_freeze_consts(consts),
                 name=name or "")


# ---------------------------------------------------------------------------
# Program — the ordered stage graph
# ---------------------------------------------------------------------------

def _grid_trim(arr: torch.Tensor, shape: tuple[int, ...],
               ext: tuple[int, ...], want: tuple[int, ...]) -> torch.Tensor:
    """Trim a ghost-extended grid ``(ncomp, *(shape + 2·ext))`` down to
    ``want`` ghost layers per dimension (``want <= ext`` everywhere)."""
    if ext == want:
        return arr
    for d, (e, w) in enumerate(zip(ext, want)):
        if e < w:
            raise ValueError(
                f"cannot widen ghost extent in dim {d}: have {e}, "
                f"need {w}")
        if e > w:
            arr = arr.narrow(d + 1, e - w, shape[d] + 2 * w)
    return arr


def resolve_stage_target(target: Target | str | None,
                         spec: KernelSpec) -> Target:
    """Per-stage target routing: stencil stages keep the requested target;
    pointwise stages under a stencil-only (``wants="halo_extended"``)
    executor route to its pointwise partner at the same VVL — ``"cuda"``
    under ``"cuda_windowed"``, so the fused regime's prologue runs the
    gathered CUDA kernel on the card and not the plain version.

    Raises ``ValueError`` for an unregistered executor and
    ``NotImplementedError`` for a stencil-only executor with no pointwise
    partner — never a quiet detour through the plain version."""
    tgt = as_target(target)
    if spec.has_stencil or executor_wants(tgt.executor) != "halo_extended":
        return tgt
    partner = _POINTWISE_PARTNER.get(tgt.executor)
    if partner is None:
        raise NotImplementedError(
            f"stencil-only executor {tgt.executor!r} has no pointwise "
            f"partner to run pointwise stage {spec.name!r}; add it to "
            f"repro_torch.core.program._POINTWISE_PARTNER")
    return tgt.with_(backend=partner)


class Program:
    """An ordered graph of :class:`Stage`\\ s over named fields and
    intermediates — one application *step* as a declarative object.

    Args:
      name: display name.
      stages: the launches, in execution order.
      fields: persistent state names (ordered).  A field's pre-step value
        is read until a stage writes it; the last write is the next-step
        value; unwritten fields pass through unchanged.
      intermediates: step-local names.  ``None`` infers them (every
        written name that is not a field); passing them explicitly
        validates the set exactly.
    """

    def __init__(self, name: str, stages: Sequence[Stage], *,
                 fields: Sequence[str],
                 intermediates: Sequence[str] | None = None):
        self.name = str(name)
        self.stages = tuple(stages)
        if not self.stages:
            raise ValueError(f"program {name!r} needs at least one stage")
        for st in self.stages:
            if not isinstance(st, Stage):
                raise TypeError(f"program {name!r}: stages must be Stage "
                                f"objects, got {type(st).__name__}")
        self.fields = _as_names(fields, "field")
        if len(set(self.fields)) != len(self.fields):
            raise ValueError(f"duplicate field names: {self.fields}")

        written = [w for st in self.stages for w in st.writes]
        inferred = tuple(dict.fromkeys(w for w in written
                                       if w not in self.fields))
        if intermediates is None:
            self.intermediates = inferred
        else:
            self.intermediates = tuple(str(n) for n in intermediates)
            if set(self.intermediates) != set(inferred):
                raise ValueError(
                    f"program {name!r}: declared intermediates "
                    f"{sorted(self.intermediates)} != written non-field "
                    f"names {sorted(inferred)}")
        overlap = set(self.fields) & set(self.intermediates)
        if overlap:
            raise ValueError(f"names {sorted(overlap)} are both fields "
                             f"and intermediates")

        # dataflow validation: reads resolve to fields or already-written
        # intermediates; every intermediate is consumed.
        known = set(self.fields) | set(self.intermediates)
        bound = set(self.fields)
        read_ever: set[str] = set()
        for st in self.stages:
            for r in st.reads:
                if r not in known:
                    raise ValueError(
                        f"stage {st.name!r} reads unknown name {r!r} "
                        f"(fields: {sorted(self.fields)}, intermediates: "
                        f"{sorted(self.intermediates)})")
                if r not in bound:
                    raise ValueError(
                        f"stage {st.name!r} reads intermediate {r!r} "
                        f"before any stage writes it")
                read_ever.add(r)
            bound.update(st.writes)
        dead = sorted(set(self.intermediates) - read_ever)
        if dead:
            raise ValueError(
                f"program {name!r}: intermediate(s) {dead} are written "
                f"but never read — drop them or make them fields")

        # per-name component counts (consistency across all bindings)
        self.ncomp: dict[str, int | None] = {n: None for n in known}

        def _record(n, c, where):
            if c is None:
                return
            c = int(c)
            if self.ncomp[n] is None:
                self.ncomp[n] = c
            elif self.ncomp[n] != c:
                raise ValueError(
                    f"name {n!r} has inconsistent ncomp: {self.ncomp[n]} "
                    f"vs {c} at {where}")

        for st in self.stages:
            for r, fs in zip(st.reads, st.spec.fields):
                _record(r, fs.ncomp, f"stage {st.name!r} read")
            for w, oc in zip(st.writes, st.spec.out):
                _record(w, oc, f"stage {st.name!r} write")

        # stages that may launch straight into the next-step buffers:
        # every write is a field and this stage is that field's last writer
        last = {}
        for i, st in enumerate(self.stages):
            for w in st.writes:
                last[w] = i
        self._final_writers = frozenset(
            i for i, st in enumerate(self.stages)
            if all(w in self.fields and last[w] == i for w in st.writes))

    def __repr__(self):
        return (f"Program({self.name!r}, stages="
                f"{[st.name for st in self.stages]}, "
                f"fields={list(self.fields)}, "
                f"intermediates={list(self.intermediates)})")

    # -- the halo schedule -------------------------------------------------

    def schedule(self, ndim: int, open_dims: Sequence[bool]):
        """Back-propagate per-dimension ghost requirements through the
        stage graph.

        ``open_dims[d]`` marks dimensions whose ghosts are caller-managed
        (pre-filled ghost planes); closed dimensions wrap periodically
        inside each launch and need nothing.

        Returns ``(field_widths, stage_geo)``:

        * ``field_widths[name]`` — ghost layers each *field* must carry at
          the start of the step (the max requirement over every stage that
          consumes its pre-step value);
        * ``stage_geo[i] = (ext_out, halo)`` — stage *i* computes its
          outputs on the interior extended by ``ext_out`` ghost layers
          (recompute-in-ghost for step-local intermediates read through
          stencils downstream) and launches with ``halo`` ghost width.
        """
        open_mask = tuple(bool(b) for b in open_dims)
        if len(open_mask) != ndim:
            raise ValueError(f"open_dims {open_mask} does not match "
                             f"ndim {ndim}")
        zeros = (0,) * ndim
        need: dict[str, tuple[int, ...]] = {f: zeros for f in self.fields}
        geo: list[tuple[tuple[int, ...], tuple[int, ...]]] = []
        for st in reversed(self.stages):
            outs = [need.pop(w, zeros) for w in st.writes]
            e_out = tuple(max(o[d] for o in outs) if open_mask[d] else 0
                          for d in range(ndim))
            radii = [s.radius_per_dim() for s in st.spec.stencils
                     if s is not None]
            h = tuple(max(r[d] for r in radii)
                      if radii and open_mask[d] else 0
                      for d in range(ndim))
            geo.append((e_out, h))
            for rname, s in zip(st.reads, st.spec.stencils):
                req = (e_out if s is None
                       else tuple(e + hh for e, hh in zip(e_out, h)))
                prev = need.get(rname, zeros)
                need[rname] = tuple(max(p, q) for p, q in zip(prev, req))
        geo.reverse()
        widths = {f: need.get(f, zeros) for f in self.fields}
        return widths, geo

    # -- stage execution core (shared by execute / compile) ----------------

    def _run_stages(self, stage_targets, shape: tuple[int, ...], geo,
                    env: dict, out: Mapping[str, torch.Tensor] | None = None
                    ) -> dict:
        """Run all stages over ``env`` (name → ``(grid_tensor, ext)``),
        mutating and returning it.  ``geo`` is :meth:`schedule`'s
        per-stage ``(ext_out, halo)`` list.  ``out`` optionally maps every
        field to a preallocated interior grid its final writer launches
        into."""
        for i, (st, tgt, (e_out, h)) in enumerate(
                zip(self.stages, stage_targets, geo)):
            lat_shape = tuple(s + 2 * e for s, e in zip(shape, e_out))
            lat = Lattice(lat_shape)
            arrays = []
            for rname, s in zip(st.reads, st.spec.stencils):
                arr, ext = env[rname]
                want = (e_out if s is None
                        else tuple(e + hh for e, hh in zip(e_out, h)))
                arr = _grid_trim(arr, shape, ext, want)
                arrays.append(arr.reshape(arr.shape[0], -1))
            bufs = None
            if out is not None and i in self._final_writers and not any(e_out):
                bufs = tuple(out[w].view(out[w].shape[0], -1)
                             for w in st.writes)
            outs = _launch(st.spec, tgt, *arrays, lattice=lat,
                           halo=h if any(h) else None,
                           consts=st.consts_dict(), out=bufs)
            outs = (outs,) if not isinstance(outs, tuple) else outs
            for w, o in zip(st.writes, outs):
                env[w] = (o.reshape(o.shape[0], *lat_shape), e_out)
        return env

    # -- eager execution with caller-managed ghosts ------------------------

    def execute(self, target: Target | str | None,
                state: Mapping[str, torch.Tensor], *,
                grid_shape: Sequence[int],
                halo: int | Sequence[int] | None = 0) -> dict:
        """Run one step over grid tensors, ghosts managed by the caller.

        ``state[name]`` is ``(ncomp, *(grid_shape + 2·halo))`` for every
        field; dimensions with ``halo[d] > 0`` carry caller-filled ghost
        planes, dimensions with ``halo[d] == 0`` wrap periodically.
        Returns the next-step field grids over the interior.
        """
        shape = tuple(int(s) for s in grid_shape)
        ndim = len(shape)
        h0 = _normalize_halo(halo, ndim)
        open_mask = tuple(hh > 0 for hh in h0)
        widths, geo = self.schedule(ndim, open_mask)
        stage_targets = tuple(resolve_stage_target(target, st.spec)
                              for st in self.stages)
        env = {}
        for f in self.fields:
            if f not in state:
                raise ValueError(f"program {self.name!r}: state is "
                                 f"missing field {f!r}")
            short = [d for d in range(ndim) if h0[d] < widths[f][d]]
            if short:
                raise ValueError(
                    f"program {self.name!r}: field {f!r} needs "
                    f"{widths[f]} ghost layer(s) but the caller supplied "
                    f"halo={h0} (short in dim(s) {short})")
            env[f] = (state[f], h0)
        env = self._run_stages(stage_targets, shape, geo, env)
        zeros = (0,) * ndim
        return {f: _grid_trim(env[f][0], shape, env[f][1], zeros)
                for f in self.fields}

    # -- binding -------------------------------------------------------------

    def compile(self, target: Target | str | None = None, *,
                grid_shape: Sequence[int], mesh=None) -> "CompiledProgram":
        """Bind to one target and grid (see :class:`CompiledProgram`).
        ``mesh`` is reserved for domain decompositions, which are not
        ported yet."""
        if mesh is not None:
            raise NotImplementedError(
                f"program {self.name!r}: a mesh= compile needs the domain "
                f"decompositions, which are not ported yet (ROADMAP, "
                f"queue A, 'Decompositions')")
        return CompiledProgram(self, target, grid_shape)

    def autotune(self, target: Target | str | None,
                 example_state: Mapping[str, torch.Tensor], **kw):
        """Tune the executor, VVL and ``Target.tuning`` for this program —
        the front end of :func:`repro_torch.core.autotune.autotune` (which
        see for the keywords).  Returns ``(tuned_target, report)``."""
        from .autotune import autotune as _autotune
        return _autotune(self, target, example_state, **kw)

    def plan(self, target: Target | str | None = None, *,
             grid_shape: Sequence[int]) -> "ProgramPlan":
        """Aggregate the per-launch memory models across the step without
        launching (single-device periodic geometry)."""
        shape = tuple(int(s) for s in grid_shape)
        _, geo = self.schedule(len(shape), (False,) * len(shape))
        stage_targets = tuple(resolve_stage_target(target, st.spec)
                              for st in self.stages)
        return _build_program_plan(self, stage_targets, shape, geo)


# ---------------------------------------------------------------------------
# the compiled step
# ---------------------------------------------------------------------------

def _validate_decomposition(program: Program, grid_shape):
    """Every stencil-read dimension wraps periodically inside each launch,
    which is only meaningful while the extent covers the stencil radius —
    a too-thin grid must fail at compile time, not inside a launch."""
    for st in program.stages:
        for s in st.spec.stencils:
            if s is None:
                continue
            for d, r in enumerate(s.radius_per_dim()):
                if r > grid_shape[d]:
                    raise ValueError(
                        f"program {program.name!r} stage {st.name!r}: "
                        f"stencil {s.name!r} radius {r} in dim {d} "
                        f"exceeds the periodic extent {grid_shape[d]} — "
                        f"enlarge the grid")


class CompiledProgram:
    """A :class:`Program` bound to one target + grid (single device).

    * :meth:`step` — one step over the field mapping, fresh output tensors;
    * :meth:`run` — ``nsteps`` steps over two preallocated ping-pong state
      buffers;
    * :meth:`plan` — the aggregated :class:`ProgramPlan`;
    * ``stage_targets`` — the per-stage routed targets.
    """

    def __init__(self, program: Program, target: Target | str | None,
                 grid_shape: Sequence[int]):
        self.program = program
        self.target = as_target(target)
        self.grid_shape = tuple(int(s) for s in grid_shape)
        ndim = len(self.grid_shape)
        self.stage_targets = tuple(resolve_stage_target(self.target, st.spec)
                                   for st in program.stages)
        _validate_decomposition(program, self.grid_shape)
        _, self._geo = program.schedule(ndim, (False,) * ndim)

    def _core(self, arrays, out=None) -> tuple[torch.Tensor, ...]:
        fields = self.program.fields
        zeros = (0,) * len(self.grid_shape)
        env = {f: (a, zeros) for f, a in zip(fields, arrays)}
        bufs = dict(zip(fields, out)) if out is not None else None
        env = self.program._run_stages(self.stage_targets, self.grid_shape,
                                       self._geo, env, out=bufs)
        res = tuple(env[f][0] for f in fields)
        if out is None:
            return res
        for o, r in zip(out, res):
            if o.data_ptr() != r.data_ptr():     # pass-through field
                o.copy_(r)
        return tuple(out)

    def _as_tuple(self, state: Mapping[str, torch.Tensor]):
        arrays = []
        for f in self.program.fields:
            if f not in state:
                raise ValueError(
                    f"state for program {self.program.name!r} is missing "
                    f"field {f!r}; present: {sorted(state)}")
            a = state[f]
            validate_field(f, a, ncomp=self.program.ncomp.get(f),
                           grid_shape=self.grid_shape,
                           program=self.program.name)
            arrays.append(a)
        return tuple(arrays)

    def step(self, state: Mapping[str, torch.Tensor]) -> dict:
        """One step: field mapping in, ``{name: tensor}`` out."""
        return dict(zip(self.program.fields,
                        self._core(self._as_tuple(state))))

    def run(self, state: Mapping[str, torch.Tensor], nsteps: int) -> dict:
        """``nsteps`` steps over two preallocated ping-pong buffers.

        Step *i* reads one buffer set and its final-writer stages launch
        straight into the other; the caller's tensors are read by the
        first step and never written.  The arithmetic is that of
        :meth:`step`, so the two agree bit for bit.
        """
        arrays = self._as_tuple(state)
        if nsteps <= 0:
            return dict(zip(self.program.fields, arrays))
        bufs = [tuple(torch.empty_like(a, memory_format=torch.contiguous_format)
                      for a in arrays) for _ in range(2)]
        src = arrays
        for i in range(int(nsteps)):
            src = self._core(src, bufs[i % 2])
        return dict(zip(self.program.fields, src))

    def plan(self) -> "ProgramPlan":
        """Aggregated memory models for this compile's geometry."""
        return _build_program_plan(self.program, self.stage_targets,
                                   self.grid_shape, self._geo)

    def __repr__(self):
        return (f"CompiledProgram({self.program.name!r}, "
                f"target={self.target.executor!r}, "
                f"grid={self.grid_shape})")


# ---------------------------------------------------------------------------
# aggregated memory models
# ---------------------------------------------------------------------------

class ProgramPlan:
    """Per-stage :class:`~repro_torch.core.api.LaunchPlan`\\ s plus the
    step-level aggregate: ``hbm_bytes_estimate`` **sums** the stage models
    — every executor operand and output materialised over one step."""

    __slots__ = ("name", "stages")

    def __init__(self, name: str, stages):
        self.name = name
        self.stages = tuple(stages)          # (stage_name, LaunchPlan)

    def hbm_bytes_estimate(self, itemsize: int = 4) -> int:
        return sum(p.hbm_bytes_estimate(itemsize) for _, p in self.stages)

    def vmem_bytes_estimate(self) -> int:
        """The largest shared-memory tile any stage's kernel holds (stages
        run one after another)."""
        return max((p.vmem_bytes_estimate() for _, p in self.stages),
                   default=0)

    def per_stage(self, itemsize: int = 4) -> list[dict]:
        """One row per stage — executor, capability, memory models."""
        return [{"stage": name, "executor": p.target.executor,
                 "wants": p.wants,
                 "hbm_bytes_estimate": p.hbm_bytes_estimate(itemsize),
                 "vmem_bytes_estimate": p.vmem_bytes_estimate()}
                for name, p in self.stages]

    def __repr__(self):
        return (f"ProgramPlan({self.name!r}, "
                f"stages={[n for n, _ in self.stages]}, "
                f"hbm={self.hbm_bytes_estimate()})")


def _build_program_plan(program: Program, stage_targets,
                        shape: tuple[int, ...], geo) -> ProgramPlan:
    plans = []
    for st, tgt, (e_out, h) in zip(program.stages, stage_targets, geo):
        lat = Lattice(tuple(s + 2 * e for s, e in zip(shape, e_out)))
        lp = _launch_plan(st.spec, tgt, lattice=lat,
                          halo=h if any(h) else None,
                          consts=st.consts_dict())
        plans.append((st.name, lp))
    return ProgramPlan(program.name, plans)


# ---------------------------------------------------------------------------
# facade constructor
# ---------------------------------------------------------------------------

def program(name: str, stages: Sequence[Stage], *, fields: Sequence[str],
            intermediates: Sequence[str] | None = None) -> Program:
    """Build a :class:`Program`::

        prog = program(
            "lb_fused",
            [stage(FUSED_SPEC, reads=("f", "g"), writes=("f", "g"),
                   consts=collision_consts)],
            fields=("f", "g"))
        exe = prog.compile(Target("cuda_windowed"), grid_shape=(128,) * 3)
        state = exe.run(state, 100)
    """
    return Program(name, stages, fields=fields, intermediates=intermediates)
