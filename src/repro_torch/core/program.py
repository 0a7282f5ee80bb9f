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
   ``hbm_bytes_estimate`` and takes the largest ``vmem_bytes_estimate``;
e. **slab, pencil and block decompositions with comm/compute overlap** —
   a ``mesh`` (:func:`repro_torch.launch.mesh.make_mesh`) may shard up to
   ``ndim`` grid dimensions (mesh axis *k* ↔ grid dim *k*; one axis = slab,
   two = pencil, three = block).  Each rank steps its own block of the
   grid: every field is copied once a step into a buffer with room for its
   ghost planes, which the exchange fills in **ordered per-dimension
   sweeps** (dim 0 first): the dim-1 exchange transfers planes that span
   the dim-0 ghosts already received, so edge and corner ghosts arrive
   through the orthogonal neighbour, with no diagonal transfer.  Each of
   the reference's ``ppermute``\\ s is one ``all_to_all_single`` over the
   mesh axis's process group (one non-zero split each way; self pairs
   included, so a one-rank mesh runs the same collectives), counted in
   :data:`collectives`.  The in-place executors then read the ghost planes
   where a periodic launch wraps.  With ``overlap=True`` the first swept
   dimension's exchanges are posted asynchronously, the **interior**
   region (:func:`_overlap_regions`) launches on the raw local fields
   while they are in flight, and the **boundary** slabs launch on the
   exchanged fields after the wait (:func:`_run_region`).
   :meth:`CompiledProgram.comm_stats` reports the analytic exchange budget
   per step;
f. **ensembles** — a stage may bind a
   :class:`~repro_torch.core.memory.BatchedConst` (a per-member sweep);
   :meth:`CompiledProgram.vmap` lifts the compiled step to a
   :class:`~repro_torch.core.fleet.FleetProgram` whose every stage is one
   ensemble launch (:func:`~repro_torch.core.api.launch_ensemble`) over a
   leading member axis.  ``step``/``run`` of a single compile refuse a
   program with a sweep.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

from .api import _normalize_halo
from .api import launch as _launch
from .api import launch_ensemble as _launch_ensemble
from .api import launch_plan as _launch_plan
from .lattice import Lattice
from .memory import BatchedConst
from .registry import executor_wants
from .spec import KernelSpec
from .state import ProgramState, validate_field
from .target import Target, as_target

#: Pointwise partner of each stencil-only executor (``wants="halo_extended"``):
#: the gathered executor a pointwise stage routes to under it.  A pointwise
#: stage under a stencil-only executor missing here raises.
_POINTWISE_PARTNER = {"cuda_windowed": "cuda"}

#: collectives the compiled steps' ghost exchanges issue: one
#: ``all_to_all_single`` per reference ``ppermute``, counted where it is
#: posted
collectives = {"all_to_all_single": 0}


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


def resolve_stage_target(target: Target | str | None, spec: KernelSpec,
                         stage_name: str | None = None) -> Target:
    """Per-stage target routing: stencil stages keep the requested target;
    pointwise stages under a stencil-only (``wants="halo_extended"``)
    executor route to its pointwise partner at the same VVL — ``"cuda"``
    under ``"cuda_windowed"``, so the fused regime's prologue runs the
    gathered CUDA kernel on the card and not the plain version.

    Per-stage tuning: ``Target.tuning`` keys of the reserved form
    ``"stage:<name>"`` hold a nested ``((knob, value), ...)`` assignment for
    that stage only (:func:`repro_torch.core.autotune.default_space` with
    ``per_stage=True`` emits them).  Every ``stage:*`` key is stripped from
    the flat tuning, then the entry of ``stage_name`` is merged over it, so
    a stage never sees another stage's knobs and its own value overrides
    the program-wide one.

    Raises ``ValueError`` for an unregistered executor and
    ``NotImplementedError`` for a stencil-only executor with no pointwise
    partner — never a quiet detour through the plain version."""
    tgt = as_target(target)
    if any(k.startswith("stage:") for k, _ in tgt.tuning):
        flat = {k: v for k, v in tgt.tuning if not k.startswith("stage:")}
        if stage_name is not None:
            flat.update(dict(dict(tgt.tuning).get(f"stage:{stage_name}",
                                                  ())))
        tgt = tgt.with_(tuning=flat)
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

    def batched_consts(self) -> dict:
        """The program's per-member ensemble sweeps: ordered mapping of
        const name → :class:`~repro_torch.core.memory.BatchedConst` over
        every stage binding one.  A name bound by several stages must bind
        the *same* sweep (content equality): the fleet carries one value
        per name through the whole step."""
        out: dict[str, BatchedConst] = {}
        for st in self.stages:
            for k, v in st.consts:
                if not isinstance(v, BatchedConst):
                    continue
                prev = out.get(k)
                if prev is not None and prev != v:
                    raise ValueError(
                        f"program {self.name!r}: const {k!r} is bound to "
                        f"two different BatchedConst sweeps (stage "
                        f"{st.name!r} disagrees with an earlier stage); "
                        f"every stage must share one sweep per name")
                out[k] = v
        return out

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
                    env: dict, out: Mapping[str, torch.Tensor] | None = None,
                    *, batch: int | None = None,
                    dyn: Mapping[str, Any] | None = None) -> dict:
        """Run all stages over ``env`` (name → ``(grid_tensor, ext)``),
        mutating and returning it.  ``geo`` is :meth:`schedule`'s
        per-stage ``(ext_out, halo)`` list.  ``out`` optionally maps every
        field to a preallocated interior grid its final writer launches
        into.

        With ``batch``, every tensor carries a leading member axis (no
        ghost planes: fleets run on one device) and each stage is one
        ensemble launch; ``dyn`` maps a swept const's name to its ``(batch,
        ...)`` host values (default: the ``BatchedConst``'s own)."""
        lead = () if batch is None else (batch,)
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
                # a trimmed field is a strided view and the executors take
                # contiguous fields: staged here, where a decomposed step
                # reads a field at less than its exchange width
                arrays.append(arr.contiguous().view(
                    *lead, arr.shape[len(lead)], -1))
            bufs = None
            if out is not None and i in self._final_writers and not any(e_out):
                bufs = tuple(out[w].view(*lead, out[w].shape[len(lead)], -1)
                             for w in st.writes)
            consts = st.consts_dict()
            if batch is None:
                outs = _launch(st.spec, tgt, *arrays, lattice=lat,
                               halo=h if any(h) else None, consts=consts,
                               out=bufs)
            else:
                member = {k: (dyn or {}).get(k, v.value)
                          for k, v in consts.items()
                          if isinstance(v, BatchedConst)}
                outs = _launch_ensemble(
                    st.spec, tgt, *arrays, batch=batch, lattice=lat,
                    consts={k: v for k, v in consts.items()
                            if k not in member},
                    member_consts=member, out=bufs)
            outs = (outs,) if not isinstance(outs, tuple) else outs
            for w, o in zip(st.writes, outs):
                env[w] = (o.reshape(*lead, o.shape[len(lead)], *lat_shape),
                          e_out)
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
        stage_targets = tuple(resolve_stage_target(target, st.spec, st.name)
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
                grid_shape: Sequence[int], mesh=None,
                shard_axis: str | Sequence[str] | None = None,
                overlap: bool | None = None) -> "CompiledProgram":
        """Bind to one target and grid (see :class:`CompiledProgram`).
        ``mesh``/``shard_axis`` default to the target's hints; with a mesh,
        mesh axis *k* shards grid dim *k* (one name = slab, two = pencil,
        three = block), each rank steps its own block of ``grid_shape``,
        and every field exchanges its ghost planes once a step per sharded
        dim.  ``overlap=True`` opts into the comm/compute overlap schedule
        (the interior launched while the first exchanges are in flight)."""
        return CompiledProgram(self, target, grid_shape, mesh=mesh,
                               shard_axis=shard_axis, overlap=overlap)

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
        launching (single-device periodic geometry; for a decomposition's
        local geometry use :meth:`CompiledProgram.plan`)."""
        shape = tuple(int(s) for s in grid_shape)
        _, geo = self.schedule(len(shape), (False,) * len(shape))
        stage_targets = tuple(resolve_stage_target(target, st.spec, st.name)
                              for st in self.stages)
        return _build_program_plan(self, stage_targets, shape, geo)


# ---------------------------------------------------------------------------
# the ghost exchange
# ---------------------------------------------------------------------------

def _shard_axes(shard_axis) -> tuple[str, ...]:
    """Normalise a ``shard_axis`` argument (name or sequence of names) to
    the ordered tuple of mesh axis names; axis *k* shards grid dim *k*."""
    if shard_axis is None:
        return ()
    if isinstance(shard_axis, str):
        return (shard_axis,)
    return tuple(str(a) for a in shard_axis)


def _mesh_axis_sizes(mesh) -> dict[str, int]:
    """Axis name → size: a ``DeviceMesh`` (``mesh_dim_names`` beside its
    ``shape`` tuple) or any object whose ``shape`` maps names to sizes, as
    the reference's ``Mesh.shape`` does."""
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return {str(k): int(v) for k, v in shape.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if shape is None or not names:
        raise ValueError(f"expected a mesh with named axes "
                         f"(repro_torch.launch.mesh.make_mesh(shape, axes)), "
                         f"got {type(mesh).__name__}")
    return dict(zip(names, (int(s) for s in shape)))


def _exchange_hops(width: int, local_extent: int) -> list[tuple[int, int]]:
    """Hop plan for a ``width``-plane ghost exchange across shards of
    ``local_extent`` planes: ``[(hop, take), ...]`` — hop *j* transfers
    the ``take`` boundary planes of the rank ``±j`` neighbour.  One hop
    when the neighbour covers the width; one extra hop per additional
    shard when ``width > local_extent`` (a 1-plane slab feeding a radius-2
    schedule reads from ranks ±2)."""
    hops = -(-width // local_extent)         # ceil: shards per side
    return [(j, min(local_extent, width - (j - 1) * local_extent))
            for j in range(1, hops + 1)]


def _hop_pairs(hop: int, nranks: int) -> list[tuple[int, int]]:
    """``(src, dst)`` pairs of a ``ppermute`` shifting by ``hop`` ranks."""
    return [(i, (i + hop) % nranks) for i in range(nranks)]


def _ghost_moves(ext: torch.Tensor, dim: int, width: int):
    """The transfers of one ``width``-plane exchange along grid dim ``dim``
    of ``ext`` (``(ncomp, ...)`` with ``width`` planes of room on each side
    of the shard's own in that dim): ``[(source, ghost, hop), ...]``,
    views of ``ext``.  Hop *j*'s left ghosts come from rank −j's last planes
    (a shift by +j) and sit left of hop *j*−1's; the right ghosts mirror
    them (a shift by −j).  Sources are own planes and ghosts are not, so
    the moves never overlap."""
    ax = dim + 1                             # grid dim d is tensor axis d+1
    xl = ext.shape[ax] - 2 * width
    lo, hi = width, width + xl
    moves = []
    for j, t in _exchange_hops(width, xl):
        moves.append((ext.narrow(ax, width + xl - t, t),
                      ext.narrow(ax, lo - t, t), j))
        moves.append((ext.narrow(ax, width, t), ext.narrow(ax, hi, t), -j))
        lo, hi = lo - t, hi + t
    return moves


def exchange_ghosts(arr: torch.Tensor, dim: int, width: int, nranks: int,
                    permute) -> torch.Tensor:
    """Extend a local shard ``(ncomp, *local)`` by ``width`` exchanged
    ghost planes on each side of grid dimension ``dim``.

    The transfer set is exactly the boundary planes (the paper's
    masked-copy idea), placed in global-coordinate order: the hop-j left
    ghosts sit left of the hop-(j-1) ones, mirroring on the right.
    ``permute(x, pairs)`` is the rank-permutation primitive — the
    ``all_to_all_single`` of a mesh axis in a compiled step; tests inject a
    stacked-shard fake to hold the hop plan to a global roll.
    """
    ax = dim + 1
    shape = list(arr.shape)
    shape[ax] += 2 * width
    ext = arr.new_empty(shape)
    ext.narrow(ax, width, arr.shape[ax]).copy_(arr)
    for src, ghost, hop in _ghost_moves(ext, dim, width):
        ghost.copy_(permute(src, _hop_pairs(hop, nranks)))
    return ext


class _AxisPermute:
    """The ``ppermute`` of one mesh axis: one ``all_to_all_single`` over the
    axis's process group, with one non-zero split each way.  The planes
    are staged contiguously (a ghost slab of a multi-component field is
    not) and received into a buffer of their own."""

    def __init__(self, mesh, axis_name: str):
        self.group = mesh.get_group(axis_name)
        self.nranks = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def post(self, x: torch.Tensor, pairs, *, async_op: bool):
        """Send ``x`` along ``pairs``; returns ``(work, received)``, the
        latter valid once ``work`` is waited on (``None`` when not async)."""
        dst = next(d for s, d in pairs if s == self.rank)
        src = next(s for s, d in pairs if d == self.rank)
        send = x.contiguous()
        recv = torch.empty_like(send)
        n = send.numel()
        ins, outs = [0] * self.nranks, [0] * self.nranks
        ins[dst], outs[src] = n, n
        work = dist.all_to_all_single(recv.view(-1), send.view(-1), outs,
                                      ins, group=self.group,
                                      async_op=async_op)
        collectives["all_to_all_single"] += 1
        return work, recv

    def __call__(self, x: torch.Tensor, pairs) -> torch.Tensor:
        return self.post(x, pairs, async_op=False)[1]


def _exchange_dim(arr: torch.Tensor, axis_name: str, width: int, dim: int,
                  *, mesh) -> torch.Tensor:
    """:func:`exchange_ghosts` over ``mesh``: its axis ``axis_name`` shards
    grid dim ``dim``."""
    permute = _AxisPermute(mesh, axis_name)
    return exchange_ghosts(arr, dim, width, permute.nranks, permute)


def exchange_stats(widths: Mapping[str, Sequence[int]],
                   ncomp: Mapping[str, int | None],
                   local: Sequence[int], shard_dims: Sequence[int],
                   itemsize: int = 4) -> dict:
    """Analytic per-rank cost of one step's exchange round.

    Mirrors the compiled sweep exactly: fields exchange dim by dim in
    ``shard_dims`` order, and a later dim's planes span the earlier dims'
    already-extended extents (that is how corner and edge ghosts travel),
    so its per-plane byte count grows accordingly.  Returns ``per_field``
    rows plus the step totals ``exchanged_bytes_per_step`` (bytes each rank
    sends, each way counted) and ``ppermutes_per_step`` (the collectives a
    compiled step posts: :data:`collectives` counts them).
    """
    per_field = {}
    total_bytes = total_pp = 0
    for f, w in widths.items():
        c = int(ncomp.get(f) or 1)
        ext = list(int(s) for s in local)
        fbytes = fpp = 0
        sched = {}
        for d in shard_dims:
            wd = int(w[d])
            if not wd:
                continue
            plane = 1
            for dd, e in enumerate(ext):
                if dd != d:
                    plane *= e
            fbytes += 2 * wd * plane * c * itemsize
            fpp += 2 * len(_exchange_hops(wd, int(local[d])))
            sched[d] = wd
            ext[d] += 2 * wd
        per_field[f] = {"widths": sched, "bytes": fbytes, "ppermutes": fpp}
        total_bytes += fbytes
        total_pp += fpp
    return {"per_field": per_field,
            "exchanged_bytes_per_step": total_bytes,
            "ppermutes_per_step": total_pp}


def _overlap_regions(local: Sequence[int], W: Sequence[int],
                     shard_dims: Sequence[int]):
    """The comm/compute-overlap partition of the local domain.

    ``W[d]`` is the step's largest exchange width in dim ``d``.  Returns
    ``(interior, boundaries)`` where every region is ``(start, shape)`` in
    local interior coordinates:

    * ``interior`` — the block at distance ≥ ``W[d]`` from every exchanged
      face: computable from local data alone, so it launches while the
      exchanges are in flight;
    * ``boundaries`` — ``[(dim, lo_region, hi_region), ...]``, two
      ``W[d]``-thick slabs per exchanged dim, launched on the exchanged
      fields.  The dim-*d* slabs span the *interior* extent in exchanged
      dims < *d* and the full local extent in dims > *d*, so the regions
      tile the local domain exactly once (corners belong to the lowest
      exchanged dim's slabs).
    """
    ndim = len(local)
    active = [d for d in shard_dims if W[d] > 0]
    i_start = tuple(W[d] if d in active else 0 for d in range(ndim))
    i_shape = tuple(local[d] - 2 * W[d] if d in active else local[d]
                    for d in range(ndim))
    bounds = []
    for d in active:
        start = tuple(W[dd] if (dd in active and dd < d) else 0
                      for dd in range(ndim))
        shape = tuple(W[d] if dd == d
                      else (local[dd] - 2 * W[dd]
                            if (dd in active and dd < d) else local[dd])
                      for dd in range(ndim))
        hi_start = tuple(local[d] - W[d] if dd == d else start[dd]
                         for dd in range(ndim))
        bounds.append((d, (start, shape), (hi_start, shape)))
    return (i_start, i_shape), bounds


def _region(arr: torch.Tensor, start: Sequence[int],
            shape: Sequence[int]) -> torch.Tensor:
    """The view of ``arr`` (``(ncomp, *grid)``) over one region."""
    for d, (lo, n) in enumerate(zip(start, shape)):
        if lo != 0 or n != arr.shape[d + 1]:
            arr = arr.narrow(d + 1, lo, n)
    return arr


def _run_region(program: Program, stage_targets, geo, widths, fields,
                sources: Mapping[str, tuple[torch.Tensor, tuple[int, ...]]],
                start: tuple[int, ...], shape: tuple[int, ...],
                zeros: tuple[int, ...]) -> dict:
    """Run the whole stage pipeline over one region of the local domain.

    ``sources[f] = (tensor, src_ext)`` covers interior coordinates
    ``[-src_ext[d], local[d] + src_ext[d])`` — raw local fields
    (``src_ext = 0``, the interior region) or exchanged fields
    (``src_ext = widths[f]``, boundary regions).  Each field is cut to the
    region plus its own schedule width, so the region's launches see
    exactly the ghost geometry of the whole-domain pipeline.  The cut is a
    strided view and the executors take contiguous fields: it is staged
    once here, explicitly, rather than at every stage that reads it.
    """
    env = {}
    for f in fields:
        a, src_ext = sources[f]
        w = widths[f]
        cut = _region(a, [lo - ww + e for lo, ww, e in zip(start, w, src_ext)],
                      [n + 2 * ww for n, ww in zip(shape, w)])
        env[f] = (cut if cut is a else cut.contiguous(), w)
    env = program._run_stages(stage_targets, shape, geo, env)
    return {f: _grid_trim(env[f][0], shape, env[f][1], zeros)
            for f in fields}


# ---------------------------------------------------------------------------
# the compiled step
# ---------------------------------------------------------------------------

def _validate_decomposition(program: Program, grid_shape, open_mask):
    """Compile-time guard: every stencil-read dimension left *unsharded*
    wraps periodically inside each launch, which is only meaningful while
    the extent covers the stencil radius — a pencil misconfiguration (a
    radius-2 stencil on an unsharded extent-1 dim) must fail here, not
    inside a launch."""
    for st in program.stages:
        for s in st.spec.stencils:
            if s is None:
                continue
            for d, r in enumerate(s.radius_per_dim()):
                if r and not open_mask[d] and r > grid_shape[d]:
                    sharded = [i for i, o in enumerate(open_mask) if o]
                    raise ValueError(
                        f"program {program.name!r} stage {st.name!r}: "
                        f"stencil {s.name!r} radius {r} in dim {d} "
                        f"exceeds the unsharded (periodic) extent "
                        f"{grid_shape[d]} — this decomposition (sharded "
                        f"dims {sharded}) leaves dim {d} too thin to "
                        f"wrap; shard dim {d} with a mesh axis or "
                        f"enlarge the grid")


def ping_pong(core, arrays, nsteps: int, donate: bool = False, **kw):
    """``nsteps`` applications of ``core(src, out, **kw)`` over two buffer
    sets: step *i* reads one and writes the other.  The caller's ``arrays``
    are never written unless ``donate``, when they are the second set.
    Returns the final tensors (``arrays`` themselves when ``nsteps <= 0``)."""
    if nsteps <= 0:
        return tuple(arrays)

    def fresh():
        return tuple(torch.empty_like(a, memory_format=torch.contiguous_format)
                     for a in arrays)

    first = fresh()
    second = (tuple(arrays) if donate and all(a.is_contiguous()
                                              for a in arrays)
              else (fresh() if nsteps > 1 else None))
    bufs = (first, second)
    src = tuple(arrays)
    for i in range(nsteps):
        src = core(src, bufs[i % 2], **kw)
    return src


class CompiledProgram:
    """A :class:`Program` bound to one target + geometry.

    * :meth:`step` — one step over the field mapping, fresh output tensors;
    * :meth:`run` — ``nsteps`` steps over two preallocated ping-pong state
      buffers;
    * :meth:`exchange` — one ghost-exchange round (decomposed compiles);
    * :meth:`plan` — the aggregated :class:`ProgramPlan` of the local
      geometry;
    * :meth:`comm_stats` — the analytic exchange budget per step;
    * ``local_shape`` — the block of the grid each rank steps (the grid on
      one device); the state's fields are ``(ncomp, *local_shape)``;
    * ``halo_schedule`` — field → dim-0 exchange width (decomposed compiles
      only; the slab view of ``exchange_schedule``);
    * ``exchange_schedule`` — field → ``{dim: width}`` over the sharded
      dims with a non-zero width (one exchange round each per step);
    * ``overlap`` — whether the step uses the interior/boundary split;
    * ``stage_targets`` — the per-stage routed targets.
    """

    def __init__(self, program: Program, target: Target | str | None,
                 grid_shape: Sequence[int], *, mesh=None,
                 shard_axis: str | Sequence[str] | None = None,
                 overlap: bool | None = None):
        self.program = program
        tgt = as_target(target)
        self.target = tgt
        self.grid_shape = tuple(int(s) for s in grid_shape)
        ndim = len(self.grid_shape)
        self.mesh = mesh if mesh is not None else tgt.mesh
        self.shard_axis = (shard_axis if shard_axis is not None
                           else (tgt.shard_axis or "data"))
        self.shard_axes = (_shard_axes(self.shard_axis)
                           if self.mesh is not None else ())
        self.stage_targets = tuple(resolve_stage_target(tgt, st.spec,
                                                        st.name)
                                   for st in program.stages)
        fields = program.fields
        # per-member ensemble sweeps: a fleet (.vmap) carries their values
        self.batched_consts = program.batched_consts()
        self.dyn_names = tuple(self.batched_consts)
        self.halo_schedule: dict[str, int] = {}
        self.exchange_schedule: dict[str, dict[int, int]] = {}
        self._shard_dims: tuple[int, ...] = ()
        self.overlap = False
        if self.mesh is None:
            self.local_shape = self.grid_shape
            open_mask = (False,) * ndim
            _validate_decomposition(program, self.grid_shape, open_mask)
            self._widths, self._geo = program.schedule(ndim, open_mask)
            self._interior_shape = self.grid_shape
            return

        axes = self.shard_axes
        if not axes:
            raise ValueError(
                f"program {program.name!r}: a mesh was given but "
                f"shard_axis is empty — name the mesh axis(es) that shard "
                f"grid dims 0..k")
        if len(axes) != len(set(axes)):
            raise ValueError(f"duplicate shard axes {axes}")
        if len(axes) > ndim:
            raise ValueError(
                f"{len(axes)} shard axes {axes} for a {ndim}-D grid; mesh "
                f"axis k shards grid dim k, so at most {ndim} axes apply")
        sizes = _mesh_axis_sizes(self.mesh)
        local = list(self.grid_shape)
        for d, ax in enumerate(axes):
            if ax not in sizes:
                raise ValueError(f"shard axis {ax!r} is not a mesh axis "
                                 f"(mesh has {tuple(sizes)})")
            nsh = sizes[ax]
            if self.grid_shape[d] % nsh != 0:
                raise ValueError(
                    f"{'XYZ'[d] if d < 3 else f'dim-{d}'} extent "
                    f"{self.grid_shape[d]} not divisible by mesh axis "
                    f"{ax}={nsh}")
            local[d] = self.grid_shape[d] // nsh
        self.local_shape = local = tuple(local)
        self._mesh_sizes = tuple(sizes[a] for a in axes)
        shard_dims = self._shard_dims = tuple(range(len(axes)))
        open_mask = tuple(d < len(axes) for d in range(ndim))
        widths, self._geo = program.schedule(ndim, open_mask)
        self._widths = widths
        self.halo_schedule = {f: widths[f][0] for f in fields}
        self.exchange_schedule = {
            f: {d: widths[f][d] for d in shard_dims if widths[f][d]}
            for f in fields}
        for d in shard_dims:
            w_max = max((widths[f][d] for f in fields), default=0)
            if w_max >= self.grid_shape[d]:
                raise ValueError(
                    f"program {program.name!r} needs a {w_max}-plane ghost "
                    f"exchange in dim {d} but the global extent is only "
                    f"{self.grid_shape[d]} plane(s)")
        _validate_decomposition(program, self.grid_shape, open_mask)
        # the interior must be non-empty in every exchanged dim (thin
        # pencils where the exchange width swallows the shard stay unsplit)
        W = tuple(max((widths[f][d] for f in fields), default=0)
                  if open_mask[d] else 0 for d in range(ndim))
        self._regions = _overlap_regions(local, W, shard_dims)
        i_shape = self._regions[0][1]
        self.overlap = bool(overlap) and any(W) and all(s > 0
                                                        for s in i_shape)
        self._interior_shape = i_shape if self.overlap else local
        self._permutes = None          # built at the first exchange

    # -- the exchange round ------------------------------------------------

    def _check_device(self, arrays):
        dev = arrays[0].device
        if dev.type != self.mesh.device_type:
            raise ValueError(
                f"program {self.program.name!r}: the mesh is on "
                f"{self.mesh.device_type!r} but the fields are on {dev}; "
                f"build the mesh for the fields' device (fields are never "
                f"staged through another device for an exchange)")

    def _sweep_view(self, ext: torch.Tensor, f: str, d: int) -> torch.Tensor:
        """``ext`` narrowed to what dim ``d``'s sweep exchanges: the ghost
        room of dims ≤ d, the own planes of the dims after it."""
        w = self._widths[f]
        for dd in self._shard_dims:
            if dd > d and w[dd]:
                ext = ext.narrow(dd + 1, w[dd], self.local_shape[dd])
        return ext

    def _post(self, exts: dict, d: int, *, async_op: bool) -> list:
        """Post every field's dim-``d`` transfers; returns the pending
        ``(work, received, ghost)`` list for :meth:`_land`."""
        if self._permutes is None:
            self._permutes = [_AxisPermute(self.mesh, ax)
                              for ax in self.shard_axes]
        permute = self._permutes[d]
        pending = []
        for f, ext in exts.items():
            w = self._widths[f][d]
            if not w:
                continue
            for src, ghost, hop in _ghost_moves(self._sweep_view(ext, f, d),
                                                d, w):
                work, recv = permute.post(src, _hop_pairs(hop,
                                                          permute.nranks),
                                          async_op=async_op)
                pending.append((work, recv, ghost))
        return pending

    @staticmethod
    def _land(pending: list) -> None:
        for work, recv, ghost in pending:
            if work is not None:
                work.wait()
            ghost.copy_(recv)

    def _exchange_all(self, arrays, *, post_first: bool = False):
        """The ordered per-dim sweep: each field copied into a buffer with
        room for its ghost planes, then its ghosts filled dim by dim, so a
        later dim's planes carry the earlier dims' ghosts (edge and corner
        ghosts arrive through the orthogonal neighbour).  With
        ``post_first`` the first dim's transfers are only posted; returns
        ``(exts, pending)`` and the caller finishes with
        :meth:`_finish_exchange`."""
        self._check_device(arrays)
        exts = {}
        for f, a in zip(self.program.fields, arrays):
            w = self._widths[f]
            ext = a.new_empty((a.shape[0], *(s + 2 * ww for s, ww
                                              in zip(self.local_shape, w))))
            _region(ext, w, self.local_shape).copy_(a)
            exts[f] = ext
        first, *rest = self._shard_dims
        pending = self._post(exts, first, async_op=post_first)
        if post_first:
            return exts, pending
        return self._finish_exchange(exts, pending, rest)

    def _finish_exchange(self, exts, pending, rest=None) -> dict:
        self._land(pending)
        for d in (self._shard_dims[1:] if rest is None else rest):
            self._land(self._post(exts, d, async_op=False))
        return exts

    def exchange(self, state: Mapping[str, torch.Tensor]) -> dict:
        """One exchange round: ``{field: (ncomp, *(local + 2·width))}``,
        each local block with its ghost planes filled from the neighbour
        ranks (a decomposed compile only)."""
        if self.mesh is None:
            raise ValueError(f"program {self.program.name!r} was compiled "
                             f"without a mesh: there is nothing to exchange")
        return self._exchange_all(self._as_tuple(state))

    # -- running -----------------------------------------------------------

    def _core(self, arrays, out=None, *, batch: int | None = None,
              dyn=None) -> tuple[torch.Tensor, ...]:
        """One step of the field tensors ``arrays`` (into ``out`` when
        given).  With ``batch``, one fleet step: every tensor carries a
        leading member axis and ``dyn`` the swept consts' values."""
        fields = self.program.fields
        local = self.local_shape
        zeros = (0,) * len(local)
        bufs = dict(zip(fields, out)) if out is not None else None
        if self.mesh is None:
            env = {f: (a, zeros) for f, a in zip(fields, arrays)}
            env = self.program._run_stages(self.stage_targets, local,
                                           self._geo, env, out=bufs,
                                           batch=batch, dyn=dyn)
            res = {f: env[f][0] for f in fields}
        elif not self.overlap:
            exts = self._exchange_all(arrays)
            env = {f: (exts[f], self._widths[f]) for f in fields}
            env = self.program._run_stages(self.stage_targets, local,
                                           self._geo, env, out=bufs)
            res = {f: _grid_trim(env[f][0], local, env[f][1], zeros)
                   for f in fields}
        else:
            res = self._overlapped(arrays, bufs)
        if out is None:
            return tuple(r.contiguous() for r in (res[f] for f in fields))
        for f in fields:
            if bufs[f].data_ptr() != res[f].data_ptr():   # pass-through
                bufs[f].copy_(res[f])
        return tuple(out)

    def _overlapped(self, arrays, bufs) -> dict:
        """The overlap split: the interior on the raw local fields while
        the first dim's exchanges are in flight, then the boundary slabs
        on the exchanged fields, each region written into the result."""
        fields = self.program.fields
        zeros = (0,) * len(self.local_shape)
        (i_start, i_shape), bounds = self._regions
        exts, pending = self._exchange_all(arrays, post_first=True)
        res = bufs or {f: a.new_empty((a.shape[0], *self.local_shape))
                       for f, a in zip(fields, arrays)}
        regions = [(i_start, i_shape, {f: (a, zeros)
                                       for f, a in zip(fields, arrays)})]
        for _, lo, hi in bounds:
            regions += [(*lo, None), (*hi, None)]
        for i, (start, shape, sources) in enumerate(regions):
            if i == 1:
                self._finish_exchange(exts, pending)
            if sources is None:
                sources = {f: (exts[f], self._widths[f]) for f in fields}
            out = _run_region(self.program, self.stage_targets, self._geo,
                              self._widths, fields, sources, start, shape,
                              zeros)
            for f in fields:
                _region(res[f], start, shape).copy_(out[f])
        return res

    def _as_tuple(self, state: Mapping[str, torch.Tensor]):
        if isinstance(state, ProgramState) and state.ensemble is not None:
            raise ValueError(
                f"program {self.program.name!r}: state carries an ensemble "
                f"axis (ensemble={state.ensemble}) but this is a "
                f"single-member compile — run it through a fleet "
                f"(.vmap({state.ensemble})) or pass state.member(i)")
        arrays = []
        for f in self.program.fields:
            if f not in state:
                raise ValueError(
                    f"state for program {self.program.name!r} is missing "
                    f"field {f!r}; present: {sorted(state)}")
            a = state[f]
            validate_field(f, a, ncomp=self.program.ncomp.get(f),
                           grid_shape=self.local_shape,
                           program=self.program.name)
            arrays.append(a)
        return tuple(arrays)

    def _wrap(self, state, outs):
        out = dict(zip(self.program.fields, outs))
        return ProgramState(out) if isinstance(state, ProgramState) else out

    def _require_unbatched(self, what: str):
        if self.dyn_names:
            raise ValueError(
                f"program {self.program.name!r} binds batched const(s) "
                f"{list(self.dyn_names)} (per-member ensemble sweeps); "
                f"{what} has no ensemble axis — compile a fleet with "
                f".vmap(batch) (tdp.fleet) instead")

    def step(self, state: Mapping[str, torch.Tensor]):
        """One step: field mapping in (a dict or a single-member
        :class:`~repro_torch.core.state.ProgramState`), the same kind out."""
        self._require_unbatched("CompiledProgram.step")
        return self._wrap(state, self._core(self._as_tuple(state)))

    def run(self, state: Mapping[str, torch.Tensor], nsteps: int, *,
            health=None):
        """``nsteps`` steps over two preallocated ping-pong buffers.

        Step *i* reads one buffer set and its final-writer stages launch
        straight into the other; the caller's tensors are read by the first
        step and never written.  The arithmetic is that of :meth:`step`, so
        the two agree bit for bit.  Accepts a plain mapping or a
        :class:`~repro_torch.core.state.ProgramState`; returns the same
        kind.

        ``health``: an optional :class:`~repro_torch.core.health.
        HealthPolicy` — the run splits into ``health.every``-step chunks
        with a NaN/Inf/norm check between them (the trajectory is that of
        an unguarded run); a violation raises
        :class:`~repro_torch.core.health.HealthError` naming the field and
        the step range.
        """
        self._require_unbatched("CompiledProgram.run")
        if health is not None:
            from .health import check
            health.select_fields(self.program.fields)   # fail fast on typos
            done = 0
            while done < nsteps:
                chunk = min(health.every, nsteps - done)
                state = self.run(state, chunk)
                check(health, state, step_range=(done, done + chunk),
                      where=f"program {self.program.name!r}")
                done += chunk
            return state
        arrays = self._as_tuple(state)
        return self._wrap(state, ping_pong(self._core, arrays, int(nsteps)))

    def vmap(self, batch: int):
        """Lift this compiled step over a leading ensemble axis: a
        :class:`~repro_torch.core.fleet.FleetProgram` stepping ``batch``
        independent trajectories, one ensemble launch a stage.  Members
        never interact, so each member's trajectory is that of its single
        run.  A decomposed compile (a mesh) or ``layout="aosoa"`` raises
        ``NotImplementedError`` (ROADMAP A5: sharded and AoSoA fleets)."""
        from .fleet import FleetProgram
        return FleetProgram(self, batch)

    def plan(self) -> "ProgramPlan":
        """Aggregated memory models for this compile's local geometry."""
        return _build_program_plan(self.program, self.stage_targets,
                                   self.local_shape, self._geo)

    def comm_stats(self, itemsize: int = 4) -> dict:
        """The analytic communication budget of one compiled step.

        Per rank, per step: exchanged ghost bytes and collective count
        (:func:`exchange_stats`; :data:`collectives` counts the collectives
        posted), plus the decomposition's shape and the overlap split's
        interior fraction (the share of local sites whose compute does not
        wait on any exchange).  ``itemsize`` defaults to float32 fields.
        """
        if self.mesh is None:
            return {"decomposition": "single", "shard_axes": (),
                    "mesh_axis_sizes": (), "local_shape": self.local_shape,
                    "exchange_schedule": {},
                    "exchanged_bytes_per_step": 0,
                    "ppermutes_per_step": 0, "per_field": {},
                    "overlap": False, "interior_fraction": 1.0}
        stats = exchange_stats(self._widths, self.program.ncomp,
                               self.local_shape, self._shard_dims, itemsize)
        kinds = {1: "slab", 2: "pencil", 3: "block"}
        stats.update(
            decomposition=kinds.get(len(self.shard_axes), "block"),
            shard_axes=self.shard_axes,
            mesh_axis_sizes=self._mesh_sizes,
            local_shape=self.local_shape,
            exchange_schedule=self.exchange_schedule,
            overlap=self.overlap,
            interior_fraction=(math.prod(self._interior_shape)
                               / math.prod(self.local_shape)
                               if self.overlap else 0.0))
        return stats

    def __repr__(self):
        return (f"CompiledProgram({self.program.name!r}, "
                f"target={self.target.executor!r}, "
                f"grid={self.grid_shape}, "
                f"sharded={self.mesh is not None})")


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
