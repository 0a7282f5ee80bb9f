"""``tdp.fleet`` — batched ensemble execution of Programs behind an async
simulation service.

The targetDP layers below this one run *one* lattice simulation well; a
service wants *throughput* — many independent trajectories (parameter
sweeps, per-user simulations) per device.  Three layers, the reference's
(``repro/core/fleet.py``):

1. **Ensemble execution** — :class:`FleetProgram` (built by
   ``compiled.vmap(batch)``): every stage of the compiled step is **one
   ensemble launch** over a leading member axis
   (:func:`~repro_torch.core.api.launch_ensemble`); on the card, the
   ensemble entries of kernels 1 and 2 run every member in one launch, the
   member on ``blockIdx.y``.  State is a
   :class:`~repro_torch.core.state.ProgramState` with ``ensemble=batch``
   (plain mappings of pre-stacked tensors work too).  Per-member
   parameters are :class:`~repro_torch.core.memory.BatchedConst` stage
   bindings; the card's executors read member *i*'s physics from a device
   table built by the kernels' own ``make_phys``, so a member computes
   what its solo launch computes.  ``run`` steps over two ping-pong buffer
   sets, as ``CompiledProgram.run`` does.
2. **The async service driver** — :class:`FleetDriver`:
   ``submit(program, params, nsteps) -> ticket`` / ``poll`` /
   ``stream(ticket, every=k)`` / ``drain()``.  Pending requests batch into
   grid-shape **buckets**; each bucket owns one ``FleetProgram`` and a
   launch loop fills slots, steps the fleet, and scatters results back per
   ticket.  A submitted grid outside the configured buckets warns **once**
   and runs solo.
3. **Durability and resilience** — in-flight trajectories checkpoint
   through :mod:`repro_torch.checkpoint.store` (atomic, checksummed,
   async; the reference's format); a killed driver
   :meth:`FleetDriver.restore`\\ s every ticket at its last saved step and
   finishes it bit-equal to an uninterrupted run.  Tickets carry a failure
   lifecycle; a fault while pumping a bucket is attributed by replaying
   each active ticket through a cached batch-1 fleet; an optional
   :class:`~repro_torch.core.health.HealthPolicy` quarantines diverged
   members; failed tickets retry from their last snapshot with backoff;
   restore falls back to the newest checksum-valid snapshot.

**Aliasing.**  The reference's states are immutable arrays.  Here a
bucket's state is a set of tensors that later pumps replace and that
``_occupy`` and :func:`~repro_torch.core.faults.nan_at_step` write in
place, slot row by slot row.  A running ticket's ``_state`` is a view of
its slot; every state that outlives the pump that made it — a finished or
failed ticket's state, a stream snapshot, the retry rollback point,
``poll``'s and ``drain``'s results — is a ``clone()``.  The pump thread and
the caller share the device's default stream, so a host read after a
pump (``.cpu()``, ``.tolist()``) is ordered after it.
"""
from __future__ import annotations

import collections
import threading
import time
import traceback as traceback_mod
import warnings
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from .health import HealthError, HealthPolicy, diagnose
from .memory import BatchedConst, TargetConst
from .program import CompiledProgram, Program, Stage, ping_pong
from .registry import get_executor_entry
from .state import ProgramState, validate_field
from .target import Target, as_target

__all__ = ["FleetProgram", "FleetDriver", "Ticket"]


# ---------------------------------------------------------------------------
# layer 1 — the ensemble step
# ---------------------------------------------------------------------------

class FleetProgram:
    """``batch`` independent trajectories of one compiled Program, each
    stage one ensemble launch.

    Build with :meth:`CompiledProgram.vmap`::

        fleet = prog.compile(target, grid_shape=(16,) * 3).vmap(8)
        state = ProgramState.stack([member0, member1, ...])   # ensemble=8
        state = fleet.run(state, 100)

    Per-member consts: stages binding a :class:`BatchedConst` give member
    *i* row *i*.  The bound sweep is the default; ``step``/``run`` accept a
    ``consts=`` mapping overriding any swept const with fresh ``(batch,
    ...)`` host values (the driver's slot values).

    Raises ``NotImplementedError`` for a decomposed compile, for
    ``layout="aosoa"`` and for an executor registered without
    ``takes_ensemble`` (ROADMAP A5: sharded and AoSoA fleets wait).
    """

    def __init__(self, compiled: CompiledProgram, batch: int):
        if not isinstance(compiled, CompiledProgram):
            raise TypeError(f"FleetProgram wraps a CompiledProgram, got "
                            f"{type(compiled).__name__}")
        self.compiled = compiled
        self.batch = int(batch)
        if self.batch < 1:
            raise ValueError(f"fleet batch must be >= 1, got {batch}")
        self.program = compiled.program
        self.grid_shape = compiled.grid_shape
        name = self.program.name
        if compiled.mesh is not None:
            raise NotImplementedError(
                f"program {name!r}: a fleet of a decomposed compile (a mesh) "
                f"is not ported yet (ROADMAP A5: sharded fleets, the "
                f"exchange helpers with a leading member axis)")
        for st, tgt in zip(self.program.stages, compiled.stage_targets):
            if tgt.layout != "soa":
                raise NotImplementedError(
                    f"program {name!r} stage {st.name!r}: a fleet under "
                    f"layout={tgt.layout!r} is not ported yet (ROADMAP A5: "
                    f"AoSoA fleets)")
            if not get_executor_entry(tgt.executor).takes_ensemble:
                raise NotImplementedError(
                    f"program {name!r} stage {st.name!r}: executor "
                    f"{tgt.executor!r} takes no ensemble launch (register "
                    f"it with takes_ensemble=True); a fleet never loops "
                    f"over its members behind the executor's back")
        for k, bc in compiled.batched_consts.items():
            if bc.batch != self.batch:
                raise ValueError(
                    f"program {name!r}: batched const {k!r} sweeps "
                    f"{bc.batch} member value(s) but the fleet batch is "
                    f"{self.batch}; the ensemble extents must agree")
        self._defaults = {k: bc.value
                          for k, bc in compiled.batched_consts.items()}

    # -- state plumbing ----------------------------------------------------

    def _as_tuple(self, state: Mapping[str, torch.Tensor]):
        if isinstance(state, ProgramState):
            if state.ensemble is None:
                raise ValueError(
                    f"fleet state for program {self.program.name!r} must "
                    f"carry an ensemble axis; got a single-member "
                    f"ProgramState — build one with ProgramState.stack or "
                    f"ProgramState(arrays, ensemble={self.batch})")
            if state.ensemble != self.batch:
                raise ValueError(
                    f"fleet state ensemble extent {state.ensemble} != "
                    f"fleet batch {self.batch} "
                    f"(program {self.program.name!r})")
        arrays = []
        for f in self.program.fields:
            if f not in state:
                raise ValueError(
                    f"fleet state for program {self.program.name!r} is "
                    f"missing field {f!r}; present: {sorted(state)}")
            a = state[f]
            validate_field(f, a, ncomp=self.program.ncomp.get(f),
                           grid_shape=self.grid_shape, ensemble=self.batch,
                           program=self.program.name)
            arrays.append(a)
        return tuple(arrays)

    def _wrap(self, state, outs):
        out = dict(zip(self.program.fields, outs))
        if isinstance(state, ProgramState):
            return ProgramState(out, ensemble=self.batch)
        return out

    def _dyn_values(self, consts: Mapping[str, Any] | None) -> dict:
        names = self.compiled.dyn_names
        over = dict(consts or {})
        unknown = sorted(set(over) - set(names))
        if unknown:
            raise ValueError(
                f"program {self.program.name!r} binds no batched const(s) "
                f"{unknown}; batched: {list(names)}")
        vals = {}
        for k in names:
            v = over.get(k, self._defaults[k])
            v = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v))
            if v.ndim < 1 or int(v.shape[0]) != self.batch:
                raise ValueError(
                    f"batched const {k!r}: leading (ensemble) extent is "
                    f"{v.shape[0] if v.ndim else '(scalar)'}, expected the "
                    f"fleet batch {self.batch}")
            vals[k] = v
        return vals

    # -- stepping ----------------------------------------------------------

    def stack(self, states: Sequence[Mapping[str, torch.Tensor]]
              ) -> ProgramState:
        """Stack ``batch`` single-member states into fleet state."""
        states = list(states)
        if len(states) != self.batch:
            raise ValueError(f"need exactly {self.batch} member state(s) "
                             f"to fill the fleet, got {len(states)}")
        return ProgramState.stack(states)

    def step(self, state, *, consts: Mapping[str, Any] | None = None):
        """One fleet step: every member advances one program step (fresh
        output tensors)."""
        outs = self.compiled._core(self._as_tuple(state), batch=self.batch,
                                   dyn=self._dyn_values(consts))
        return self._wrap(state, outs)

    def run(self, state, nsteps: int, *,
            consts: Mapping[str, Any] | None = None,
            donate: bool = False, health: HealthPolicy | None = None):
        """``nsteps`` fleet steps over two ping-pong buffer sets, as
        ``CompiledProgram.run``: the caller's tensors are never written
        unless ``donate=True`` (then they are the second set).  Const
        overrides are host values read once a call.

        ``health``: an optional :class:`~repro_torch.core.health.
        HealthPolicy` — check between ``health.every``-step chunks (the
        trajectory is the unguarded one); a violation raises
        :class:`~repro_torch.core.health.HealthError` naming the diverged
        **member** and the step range."""
        if health is not None:
            from .health import check
            health.select_fields(self.program.fields)
            done, n = 0, int(nsteps)
            while done < n:
                chunk = min(health.every, n - done)
                state = self.run(state, chunk, consts=consts,
                                 donate=donate and done > 0)
                check(health, state, ensemble=self.batch,
                      step_range=(done, done + chunk),
                      where=f"fleet {self.program.name!r}")
                done += chunk
            return state
        arrays = self._as_tuple(state)
        outs = ping_pong(self.compiled._core, arrays, int(nsteps), donate,
                         batch=self.batch, dyn=self._dyn_values(consts))
        return self._wrap(state, outs)

    # -- introspection -----------------------------------------------------

    def plan(self):
        """The per-member :class:`ProgramPlan` (multiply HBM by ``batch``
        for the fleet footprint)."""
        return self.compiled.plan()

    def comm_stats(self, itemsize: int = 4) -> dict:
        """Per-member exchange budget (a fleet runs on one device: no
        exchange)."""
        return self.compiled.comm_stats(itemsize)

    def __repr__(self):
        return (f"FleetProgram({self.program.name!r}, batch={self.batch}, "
                f"grid={self.grid_shape}, "
                f"sharded={self.compiled.mesh is not None})")


# ---------------------------------------------------------------------------
# layer 2 — the service driver
# ---------------------------------------------------------------------------

#: the ticket state machine: queued → running → {failed, done}, with a retry
#: edge failed-candidate → queued (rollback) while retries remain.
TICKET_STATUSES = ("queued", "running", "failed", "done")


def _clone(state: Mapping[str, torch.Tensor]) -> dict:
    return {f: a.clone() for f, a in state.items()}


class Ticket:
    """Handle for one submitted trajectory (see :meth:`FleetDriver.submit`).

    ``status`` walks queued → running → done, or → failed: a failed ticket
    carries its cause on ``error`` (the exception instance, or its string
    form after a checkpoint restore) and ``traceback``, and ``retries``
    counts rollback-retries already consumed.
    """

    __slots__ = ("id", "program_name", "nsteps", "step", "grid_shape",
                 "consts", "rng", "bucket_id", "status", "error",
                 "traceback", "retries", "_state", "_slot", "_bucket",
                 "_solo", "_stream_every", "_snapshots", "_not_before",
                 "_retry_ckpt")

    def __init__(self, tid: str, program_name: str, nsteps: int,
                 grid_shape: tuple[int, ...], state: dict, consts: dict,
                 rng, step: int = 0):
        self.id = tid
        self.program_name = program_name
        self.nsteps = int(nsteps)
        self.step = int(step)
        self.grid_shape = grid_shape
        self.consts = dict(consts)
        self.rng = rng
        self.bucket_id = ""          # assigned on placement ("" = solo)
        self.status = "queued"
        self.error: BaseException | str | None = None
        self.traceback: str | None = None
        self.retries = 0
        # the latest member state (f -> tensor): a view of the bucket slot
        # while the ticket runs in a bucket, its own tensors otherwise
        self._state = state
        self._slot: int | None = None
        self._bucket = None
        self._solo: CompiledProgram | None = None
        self._stream_every: int | None = None
        self._snapshots: collections.deque = collections.deque()
        self._not_before = 0.0       # retry-backoff gate (monotonic s)
        # rollback point for retries: (step, state) — the submit state
        # until the driver's checkpoint cadence refreshes it; a copy, as
        # the bucket is written in place
        self._retry_ckpt: tuple[int, dict] = (int(step), _clone(state))

    @property
    def done(self) -> bool:
        return self.status == "done"

    @property
    def failed(self) -> bool:
        return self.status == "failed"

    @property
    def finished(self) -> bool:
        """Terminal — the driver will never step this ticket again."""
        return self.status in ("done", "failed")

    def __repr__(self):
        return (f"Ticket({self.id!r}, step={self.step}/{self.nsteps}, "
                f"status={self.status!r}"
                f"{', error=' + repr(str(self.error)) if self.failed else ''}"
                f")")


class _Bucket:
    """One (program, grid, const-signature) equivalence class: a shared
    :class:`FleetProgram` plus slot bookkeeping."""

    __slots__ = ("key", "label", "fleet", "slots", "pending", "state",
                 "const_rows", "dyn_names", "replay")

    def __init__(self, key, label: str, fleet: FleetProgram,
                 const_shapes: dict):
        self.key = key
        self.label = label
        self.fleet = fleet
        self.slots: list[Ticket | None] = [None] * fleet.batch
        self.pending: collections.deque = collections.deque()
        self.state: dict | None = None     # f -> (B, ncomp, *grid)
        self.dyn_names = fleet.compiled.dyn_names
        # host-side per-slot const rows, mutated on placement
        self.const_rows = {
            k: np.zeros((fleet.batch,) + shape, dtype)
            for k, (shape, dtype) in const_shapes.items()}
        # lazily-built batch-1 fleet for fault-attribution replays
        self.replay: FleetProgram | None = None

    def free_slot(self) -> int | None:
        for i, t in enumerate(self.slots):
            if t is None:
                return i
        return None

    def active(self):
        return [(i, t) for i, t in enumerate(self.slots)
                if t is not None and not t.finished]


def _override_consts(program: Program, overrides: Mapping[str, Any]
                     ) -> Program:
    """Rebuild ``program`` with const ``name`` rebound to ``value`` in every
    stage that binds it (the driver's sweep substitution: a
    ``BatchedConst`` placeholder for bucket compiles, a ``TargetConst`` for
    solo fallbacks)."""
    if not overrides:
        return program
    bound: set[str] = set()
    stages = []
    for st in program.stages:
        cd = st.consts_dict()
        hit = False
        for k, v in overrides.items():
            if k in cd:
                cd[k] = v
                bound.add(k)
                hit = True
        stages.append(Stage(st.spec, st.reads, st.writes, consts=tuple(
            sorted(cd.items())), name=st.name) if hit else st)
    missing = sorted(set(overrides) - bound)
    if missing:
        raise ValueError(
            f"program {program.name!r}: no stage binds const(s) {missing} — "
            f"submitted params['consts'] must name consts the program's "
            f"stages already bind")
    return Program(program.name, stages, fields=program.fields,
                   intermediates=program.intermediates)


def _program_digest(program: Program) -> str:
    from .autotune import _subject_digest
    return _subject_digest(program)[1]


class FleetDriver:
    """The async simulation service: submit trajectories, poll/stream
    progress, drain results — requests batched into fleet steps.

    Args:
      target: the :class:`Target` every bucket compiles under.
      batch: slots per bucket (the fleet/ensemble extent).
      grid_shapes: optional whitelist of bucketable grid shapes.  When
        given, a submitted grid outside it warns **once** (per driver and
        grid) and runs solo (per-member ``CompiledProgram``); when ``None``
        (default) every new grid opens a bucket.
      steps_per_launch: member steps per pump chunk (a chunk never
        overshoots a ticket's ``nsteps`` or stream mark).
      checkpoint_dir / checkpoint_every / checkpoint_keep: durability —
        every ``checkpoint_every`` pump rounds the driver snapshots all
        tickets through :class:`repro_torch.checkpoint.store.
        CheckpointManager` (atomic, checksummed, written off-thread),
        keeping the newest ``checkpoint_keep`` so restore can fall back
        past a torn directory.
      health: optional :class:`~repro_torch.core.health.HealthPolicy` —
        NaN/Inf/norm guards between pump chunks; a diagnosed member is
        quarantined (its ticket fails, or retries) while healthy members
        keep the exact results of the shared ensemble launch.
      max_retries / retry_backoff: failed tickets retry up to
        ``max_retries`` times, rolling back to their last snapshot (the
        submit state until the checkpoint cadence refreshes it);
        ``retry_backoff`` seconds (doubling per retry) gate each attempt.
      mesh / shard_axis / overlap: forwarded to ``Program.compile``; a
        mesh raises ``NotImplementedError`` at the first bucket (ROADMAP
        A5).

    Lifecycle: ``submit`` places tickets; stepping happens inside
    :meth:`pump` — called inline by :meth:`drain`/:meth:`stream`, or
    continuously from the background thread :meth:`start`\\ s.  A fault
    while pumping fails only the offending ticket(s); background-thread
    exceptions are re-raised from ``drain``/``stream``/``stop`` (and
    reported by ``poll``), never swallowed.
    """

    def __init__(self, target: Target | str | None = None, *,
                 batch: int = 8,
                 grid_shapes: Sequence[Sequence[int]] | None = None,
                 steps_per_launch: int = 1,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int | None = None,
                 checkpoint_keep: int = 3,
                 health: HealthPolicy | None = None,
                 max_retries: int = 0,
                 retry_backoff: float = 0.0,
                 mesh=None, shard_axis=None, overlap=None):
        self.target = as_target(target)
        self.batch = int(batch)
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.grid_shapes = (None if grid_shapes is None else
                            {tuple(int(s) for s in g) for g in grid_shapes})
        self.steps_per_launch = max(1, int(steps_per_launch))
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        if health is not None and not isinstance(health, HealthPolicy):
            raise TypeError(f"health expects a HealthPolicy, got "
                            f"{type(health).__name__}")
        self.health = health
        self.max_retries = int(max_retries)
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.retry_backoff = float(retry_backoff)
        if self.retry_backoff < 0:
            raise ValueError(f"retry_backoff must be >= 0, "
                             f"got {retry_backoff}")
        self._mesh, self._shard_axis, self._overlap = mesh, shard_axis, \
            overlap
        self._buckets: dict = {}
        self._solo_cache: dict = {}
        self._solo_active: list[Ticket] = []
        self._tickets: dict[str, Ticket] = {}
        self._programs: dict[str, Program] = {}
        self._counter = 0
        self._pumps = 0
        self._warned_grids: set = set()
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._loop_error: BaseException | None = None
        self._chaos: list[Callable] = []    # fault-injection hooks
        self._ckpt = None
        if checkpoint_dir is not None:
            from repro_torch.checkpoint.store import CheckpointManager
            self._ckpt = CheckpointManager(checkpoint_dir,
                                           keep=int(checkpoint_keep))

    # -- submission --------------------------------------------------------

    def submit(self, program: Program, params: Mapping[str, Any],
               nsteps: int) -> Ticket:
        """Queue one trajectory: ``params = {"state": <field mapping or
        single-member ProgramState>, "consts": {name: value, ...} (optional
        per-member sweep values), "rng": <array> (optional, carried through
        checkpoints)}``.  The state's tensors are copied.  Returns a
        :class:`Ticket`."""
        if not isinstance(program, Program):
            raise TypeError(f"submit expects a Program, got "
                            f"{type(program).__name__}")
        if int(nsteps) < 1:
            raise ValueError(f"nsteps must be >= 1, got {nsteps}")
        state = params["state"]
        if isinstance(state, ProgramState) and state.ensemble is not None:
            raise ValueError(
                "submit takes one member per ticket (no ensemble axis); "
                "submit each member separately — the driver does the "
                "batching")
        if self.health is not None and self.health.fields is not None:
            unknown = sorted(set(self.health.fields) - set(program.fields))
            if unknown:
                raise ValueError(
                    f"driver HealthPolicy guards field(s) {unknown} that "
                    f"program {program.name!r} does not step; fields: "
                    f"{list(program.fields)}")
        member = {f: torch.as_tensor(state[f]).clone()
                  for f in program.fields}
        first = member[program.fields[0]]
        grid = tuple(int(s) for s in first.shape[1:])
        consts = {k: np.asarray(v)
                  for k, v in dict(params.get("consts") or {}).items()}
        with self._lock:
            self._counter += 1
            t = Ticket(f"t{self._counter:04d}", program.name, nsteps,
                       grid, member, consts, params.get("rng"))
            self._tickets[t.id] = t
            self._programs.setdefault(program.name, program)
            self._place(t, program)
            self._cond.notify_all()
        return t

    def _place(self, t: Ticket, program: Program):
        if self.grid_shapes is not None and t.grid_shape not in \
                self.grid_shapes:
            if t.grid_shape not in self._warned_grids:
                self._warned_grids.add(t.grid_shape)
                warnings.warn(
                    f"fleet driver: grid {t.grid_shape} fits no configured "
                    f"bucket {sorted(self.grid_shapes)}; falling back to "
                    f"per-member execution for this grid (one "
                    f"CompiledProgram, stepped solo)", stacklevel=3)
            t._solo = self._solo_program(program, t)
            t.status = "running"
            self._solo_active.append(t)
            return
        bucket = self._bucket_for(t, program)
        t._bucket = bucket
        t.bucket_id = bucket.label
        slot = bucket.free_slot()
        if slot is None:
            bucket.pending.append(t)
        else:
            self._occupy(bucket, slot, t)

    def _const_sig(self, consts: Mapping[str, np.ndarray]):
        return tuple((k, tuple(int(s) for s in consts[k].shape),
                      str(consts[k].dtype)) for k in sorted(consts))

    def _bucket_for(self, t: Ticket, program: Program) -> _Bucket:
        sig = self._const_sig(t.consts)
        static = tuple(
            (st.name, tuple((k, v) for k, v in st.consts
                            if k not in t.consts))
            for st in program.stages)
        key = (program.name, _program_digest(program), t.grid_shape, sig,
               static)
        bucket = self._buckets.get(key)
        if bucket is not None:
            return bucket
        sweeps = {k: BatchedConst(np.zeros((self.batch,) + shape,
                                           np.dtype(dtype)))
                  for k, shape, dtype in sig}
        fleet = _override_consts(program, sweeps).compile(
            self.target, grid_shape=t.grid_shape, mesh=self._mesh,
            shard_axis=self._shard_axis,
            overlap=self._overlap).vmap(self.batch)
        label = (f"{program.name}@{'x'.join(map(str, t.grid_shape))}"
                 f"#{len(self._buckets)}")
        bucket = _Bucket(key, label, fleet,
                         {k: (shape, np.dtype(dtype))
                          for k, shape, dtype in sig})
        self._buckets[key] = bucket
        return bucket

    def _solo_program(self, program: Program, t: Ticket) -> CompiledProgram:
        overrides = {k: TargetConst(v) for k, v in t.consts.items()}
        key = (program.name, _program_digest(program), t.grid_shape,
               tuple((k, TargetConst(v)) for k, v in
                     sorted(t.consts.items())))
        cp = self._solo_cache.get(key)
        if cp is None:
            cp = _override_consts(program, overrides).compile(
                self.target, grid_shape=t.grid_shape, mesh=self._mesh,
                shard_axis=self._shard_axis, overlap=self._overlap)
            self._solo_cache[key] = cp
        return cp

    def _occupy(self, bucket: _Bucket, slot: int, t: Ticket):
        t._slot = slot
        t.status = "running"
        bucket.slots[slot] = t
        fields = bucket.fleet.program.fields
        if bucket.state is None:
            # the first member defines the bucket tensors; idle slots carry
            # a copy of it (valid fields; results of idle slots are never
            # read back)
            bucket.state = {f: torch.stack([t._state[f]] * bucket.fleet.batch)
                            for f in fields}
        else:
            for f in fields:
                bucket.state[f][slot].copy_(t._state[f])
        t._state = {f: bucket.state[f][slot] for f in fields}
        for k in bucket.dyn_names:
            if k in t.consts:
                bucket.const_rows[k][slot] = t.consts[k]

    # -- the step loop -----------------------------------------------------

    def _chunk_for(self, tickets) -> int:
        chunk = self.steps_per_launch
        for t in tickets:
            chunk = min(chunk, t.nsteps - t.step)
            if t._stream_every:
                to_mark = -t.step % t._stream_every
                if to_mark:
                    chunk = min(chunk, to_mark)
            if self.health is not None:
                # land chunk boundaries on the guard cadence so every check
                # happens at a multiple of health.every
                to_check = -t.step % self.health.every
                chunk = min(chunk, to_check or self.health.every)
        return max(1, chunk)

    def _advance_ticket(self, t: Ticket, chunk: int, state: dict):
        t.step += chunk
        t._state = state
        hit_mark = t._stream_every and t.step % t._stream_every == 0
        if t.step >= t.nsteps:
            t.status = "done"
        if t._stream_every and (hit_mark or t.done):
            t._snapshots.append((t.step, _clone(state)))

    def _ready(self, t: Ticket) -> bool:
        return t._not_before <= time.monotonic()

    def _health_due(self, t: Ticket, chunk: int) -> bool:
        # on the guard cadence, and always on the ticket's final chunk (a
        # trailing partial chunk must not finish unchecked)
        return self.health is not None and (
            (t.step + chunk) % self.health.every == 0
            or t.step + chunk >= t.nsteps)

    def _retire(self, bucket: _Bucket, slot: int, t: Ticket):
        """Free a bucket slot (its ticket finished or was quarantined): the
        ticket keeps a copy of its slot's state, and the next pending
        ticket moves in."""
        t._state = _clone(t._state)
        bucket.slots[slot] = None
        t._slot = None
        if bucket.pending:
            self._occupy(bucket, slot, bucket.pending.popleft())

    def _fail_ticket(self, t: Ticket, err: BaseException):
        """Quarantine or retry one ticket.  With retries remaining, the
        ticket rolls back to its last snapshot (step + state), re-queues
        (backoff-gated) and keeps the error for observability; otherwise it
        goes terminal ``failed`` with the captured traceback."""
        t.error = err
        t.traceback = "".join(traceback_mod.format_exception(
            type(err), err, err.__traceback__))
        if t.retries < self.max_retries:
            t.retries += 1
            step0, state0 = t._retry_ckpt
            t.step = int(step0)
            t._state = _clone(state0)
            t.status = "queued"
            if self.retry_backoff > 0:
                t._not_before = time.monotonic() + \
                    self.retry_backoff * (2 ** (t.retries - 1))
            if t._solo is None:
                self._place(t, self._programs[t.program_name])
            # solo tickets stay in _solo_active and re-pump in place
        else:
            t.status = "failed"

    def _replay_fleet(self, bucket: _Bucket) -> FleetProgram:
        """The bucket's batch-1 attribution fleet: same program, same
        per-member const path (a fresh ``BatchedConst`` placeholder per
        sweep), so a replay runs the bucket's ensemble kernels at one
        member and gives its member's bits."""
        if bucket.replay is None:
            program = self._programs[bucket.fleet.program.name]
            sweeps = {
                k: BatchedConst(np.zeros((1,) + row.shape[1:], row.dtype))
                for k, row in bucket.const_rows.items()}
            bucket.replay = _override_consts(program, sweeps).compile(
                self.target, grid_shape=bucket.fleet.grid_shape,
                mesh=self._mesh, shard_axis=self._shard_axis,
                overlap=self._overlap).vmap(1)
        return bucket.replay

    def _attribute_bucket_fault(self, bucket: _Bucket, active, chunk: int,
                                err: BaseException):
        """A fault while stepping the whole bucket: attribute blame by
        replaying each active ticket through the batch-1 fleet.  Tickets
        whose replay raises are failed/retried with *their* exception;
        tickets whose replay succeeds advance exactly as a fault-free pump
        would have (one-shot faults therefore recover every ticket).  The
        failed run wrote only its own buffers, so the bucket's state is
        still the chunk's input."""
        fields = bucket.fleet.program.fields
        try:
            replay = self._replay_fleet(bucket)
        except Exception:
            # cannot even build the replay fleet: blame every active ticket
            # with the original bucket error
            for slot, t in active:
                self._retire(bucket, slot, t)
                self._fail_ticket(t, err)
            return
        for slot, t in active:
            st1 = {f: t._state[f][None] for f in fields}
            c1 = {k: bucket.const_rows[k][slot:slot + 1]
                  for k in bucket.dyn_names}
            try:
                out = replay.run(st1, chunk, consts=c1)
            except Exception as e2:
                self._retire(bucket, slot, t)
                self._fail_ticket(t, e2)
                continue
            for f in fields:
                bucket.state[f][slot].copy_(out[f][0])
            member = {f: bucket.state[f][slot] for f in fields}
            if self._health_due(t, chunk):
                diag = diagnose(self.health, member)
                if diag:
                    e3 = HealthError.of(
                        diag[0], member=slot,
                        step_range=(t.step, t.step + chunk), ticket=t.id)
                    self._retire(bucket, slot, t)
                    self._fail_ticket(t, e3)
                    continue
            self._advance_ticket(t, chunk, member)
            if t.done:
                self._retire(bucket, slot, t)

    def _pump_bucket(self, bucket: _Bucket) -> bool:
        active = [(i, t) for i, t in bucket.active() if self._ready(t)]
        if not active:
            return False
        chunk = self._chunk_for([t for _, t in active])
        for _, t in active:
            t.status = "running"
        try:
            new_state = bucket.fleet.run(bucket.state, chunk,
                                         consts=bucket.const_rows)
        except Exception as err:
            self._attribute_bucket_fault(bucket, active, chunk, err)
            return True
        # the chunk's input stays alive while a ticket's state is a view of
        # it: a diagnosed ticket keeps the state from before the chunk
        bucket.state = dict(new_state)
        fields = bucket.fleet.program.fields
        sick: dict[int, Any] = {}
        if self.health is not None:
            due = {i for i, t in active if self._health_due(t, chunk)}
            if due:
                diag = diagnose(self.health, bucket.state,
                                ensemble=bucket.fleet.batch)
                sick = {i: d for i, d in diag.items() if i in due}
        for slot, t in active:
            if slot in sick:
                err = HealthError.of(
                    sick[slot], member=slot,
                    step_range=(t.step, t.step + chunk), ticket=t.id)
                self._retire(bucket, slot, t)
                self._fail_ticket(t, err)
                continue
            self._advance_ticket(
                t, chunk, {f: bucket.state[f][slot] for f in fields})
            if t.done:
                self._retire(bucket, slot, t)
        return True

    def _pump_solo(self, t: Ticket) -> bool:
        if t.finished or not self._ready(t):
            return False
        chunk = self._chunk_for([t])
        t.status = "running"
        try:
            state = t._solo.run(dict(t._state), chunk)
        except Exception as err:
            self._fail_ticket(t, err)
            return True
        if self._health_due(t, chunk):
            diag = diagnose(self.health, state)
            if diag:
                err = HealthError.of(
                    diag[0], step_range=(t.step, t.step + chunk),
                    ticket=t.id)
                self._fail_ticket(t, err)
                return True
        self._advance_ticket(t, chunk, dict(state))
        return True

    def _run_chaos(self):
        """Run installed fault-injection hooks (see :meth:`inject`); hooks
        returning True retire."""
        if not self._chaos:
            return
        self._chaos = [fn for fn in self._chaos if not fn(self)]

    def inject(self, hook: Callable[["FleetDriver"], bool]) -> None:
        """Install a chaos hook: ``hook(driver) -> retired?`` runs under the
        driver lock at the top of every pump round.  The deterministic
        fault-injection surface — see :mod:`repro_torch.core.faults` for
        ready-made hooks.  Test/drill harness only: hooks may mutate driver
        internals and may raise."""
        with self._lock:
            self._chaos.append(hook)

    def pump(self, rounds: int = 1) -> bool:
        """Advance every bucket (and solo ticket) by up to ``rounds`` launch
        chunks.  Returns whether any ticket progressed — the inline
        spelling of the background loop, and the unit the checkpoint
        cadence counts.  A fault while stepping fails (or retries) only the
        offending ticket(s); pump itself only raises on driver-level errors
        (which the background loop records and re-raises from
        ``drain``/``stream``/``stop``)."""
        progressed_any = False
        with self._lock:
            for _ in range(max(1, int(rounds))):
                self._run_chaos()
                progressed = False
                for bucket in self._buckets.values():
                    progressed |= self._pump_bucket(bucket)
                for t in list(self._solo_active):
                    progressed |= self._pump_solo(t)
                    if t.finished:
                        self._solo_active.remove(t)
                if progressed:
                    self._pumps += 1
                    if (self._ckpt is not None and self.checkpoint_every
                            and self._pumps % self.checkpoint_every == 0):
                        self._checkpoint_locked()
                progressed_any |= progressed
                self._cond.notify_all()
                if not progressed:
                    break
        return progressed_any

    def _unfinished(self):
        return [t for t in self._tickets.values() if not t.finished]

    def _backoff_wait(self) -> float | None:
        """Seconds until the earliest backoff-gated ticket is ready, or
        ``None`` when nothing is waiting on backoff."""
        now = time.monotonic()
        waits = [t._not_before - now for t in self._tickets.values()
                 if not t.finished and t._not_before > now]
        return max(0.0, min(waits)) if waits else None

    # -- service surface ---------------------------------------------------

    def _raise_loop_error(self):
        """Re-raise (once) an exception the background pump thread died
        with — the first ``drain``/``stream``/``stop`` caller gets it."""
        if self._loop_error is not None:
            err, self._loop_error = self._loop_error, None
            raise err

    def poll(self, ticket: Ticket) -> dict:
        """Non-blocking progress: ``{"id", "step", "nsteps", "done",
        "status", "retries", "error", "traceback", "state"}`` (``state`` =
        a copy of the member's latest stepped fields — a diagnosed ticket
        keeps its state from before the chunk that failed it;
        ``error``/``traceback`` the captured cause of a failed or retried
        ticket).  When the background pump thread itself died,
        ``driver_error`` carries its exception (poll never raises)."""
        with self._lock:
            out = {"id": ticket.id, "step": ticket.step,
                   "nsteps": ticket.nsteps, "done": ticket.done,
                   "status": ticket.status, "retries": ticket.retries,
                   "error": ticket.error, "traceback": ticket.traceback,
                   "state": _clone(ticket._state)}
            if self._loop_error is not None:
                out["driver_error"] = self._loop_error
            return out

    def stream(self, ticket: Ticket, every: int = 1):
        """Iterate ``(step, state)`` snapshots (copies) every ``every``
        member steps (plus the final step).  Call before the ticket advances
        past its first mark.  Without a background thread the generator
        pumps the driver inline; with one it blocks on progress.  Raises the
        ticket's captured error when it fails terminally, and re-raises a
        background-thread crash."""
        if int(every) < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        with self._lock:
            ticket._stream_every = int(every)
        while True:
            with self._lock:
                self._raise_loop_error()
                if ticket._snapshots:
                    yield ticket._snapshots.popleft()
                    continue
                if ticket.done:
                    return
                if ticket.failed:
                    raise ticket.error if isinstance(
                        ticket.error, BaseException) else RuntimeError(
                        f"ticket {ticket.id} failed: {ticket.error}")
                if self._thread is not None:
                    self._cond.wait(timeout=1.0)
                    continue
            if not self.pump():
                with self._lock:
                    wait = self._backoff_wait()
                if wait is not None:
                    time.sleep(min(wait, 0.1) + 1e-3)
                    continue
                raise RuntimeError(
                    f"fleet driver made no progress streaming {ticket.id} "
                    f"(step {ticket.step}/{ticket.nsteps})")

    def drain(self) -> dict[str, dict]:
        """Run until every submitted ticket reaches a terminal state
        (``done`` or ``failed``); returns ``{ticket_id: final_state}`` (a
        failed ticket's entry is its state from before the chunk that
        failed it; its cause is on ``poll(t)["error"]``).  Pumps inline
        unless the background loop is running (then it waits on it,
        re-raising any exception that thread died with)."""
        while True:
            with self._lock:
                self._raise_loop_error()
                if not self._unfinished():
                    break
                if self._thread is not None:
                    self._cond.wait(timeout=1.0)
                    continue
            if not self.pump():
                with self._lock:
                    wait = self._backoff_wait()
                if wait is not None:
                    # everything left is gated on retry backoff
                    time.sleep(min(wait, 0.1) + 1e-3)
                    continue
                stuck = [t.id for t in self._unfinished()]
                raise RuntimeError(
                    f"fleet driver made no progress with unfinished "
                    f"ticket(s) {stuck}")
        if self._ckpt is not None:
            self._ckpt.wait()
        with self._lock:
            return {t.id: _clone(t._state) for t in self._tickets.values()}

    # -- background loop ---------------------------------------------------

    def start(self):
        """Run the step loop on a daemon thread until :meth:`stop`.  An
        exception escaping :meth:`pump` is recorded on the driver, every
        waiter is woken, and the error re-raises from
        ``drain``/``stream``/``stop`` (``poll`` reports it) — it is never
        swallowed with the thread."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    progressed = self.pump()
                except BaseException as err:
                    with self._lock:
                        self._loop_error = err
                        self._cond.notify_all()
                    return
                if not progressed:
                    with self._lock:
                        self._cond.wait(timeout=0.05)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-driver")
        self._thread.start()

    def stop(self):
        """Stop the background loop (tickets keep their progress).
        Re-raises an exception the loop died with, after cleanup."""
        if self._thread is None:
            return
        self._stop.set()
        with self._lock:
            self._cond.notify_all()
        self._thread.join()
        self._thread = None
        if self._ckpt is not None:
            self._ckpt.wait()
        self._raise_loop_error()

    # -- durability --------------------------------------------------------

    def _snapshot_tree(self):
        tickets, meta = {}, {}
        for t in self._tickets.values():
            entry = {"state": dict(t._state), "step": int(t.step),
                     "bucket": t.bucket_id}
            if t.rng is not None:
                entry["rng"] = t.rng
            tickets[t.id] = entry
            meta[t.id] = {
                "program": t.program_name, "nsteps": int(t.nsteps),
                "step": int(t.step),
                "grid_shape": list(t.grid_shape),
                "fields": list(t._state),
                "has_rng": t.rng is not None,
                "status": t.status,
                "retries": int(t.retries),
                "error": None if t.error is None else str(t.error),
                "consts": {k: {"value": np.asarray(v).tolist(),
                               "dtype": str(np.asarray(v).dtype)}
                           for k, v in t.consts.items()},
            }
        return {"tickets": tickets}, {"tickets": meta, "batch": self.batch}

    def _checkpoint_locked(self, blocking: bool = False):
        tree, extra = self._snapshot_tree()
        self._ckpt.save(self._pumps, tree, extra=extra, blocking=blocking)
        # everything just snapshotted is durable — retries of a future
        # fault roll back here, not to the submit-time state
        for t in self._tickets.values():
            if not t.finished:
                t._retry_ckpt = (int(t.step), _clone(t._state))

    def checkpoint(self, blocking: bool = True):
        """Snapshot every ticket now (atomic, checksummed)."""
        if self._ckpt is None:
            raise ValueError("driver has no checkpoint_dir configured")
        with self._lock:
            self._checkpoint_locked(blocking=blocking)

    @classmethod
    def restore(cls, checkpoint_dir: str,
                programs: Mapping[str, Program] | Program, *,
                device=None, **driver_kw) -> "FleetDriver":
        """Rebuild a driver from the latest checkpoint under
        ``checkpoint_dir``: every in-flight ticket resumes at its saved step
        (ids, step counters, RNG keys and const sweeps restored; completed
        tickets come back completed, failed ones failed), its state on
        ``device`` (``None``: the card).  ``programs`` maps program name →
        :class:`Program` (or a single Program when only one was served) —
        graphs are code, not data, so the caller re-supplies them.
        Deterministic stepping makes resumed trajectories bit-equal to
        uninterrupted ones.

        Every candidate snapshot is sha256-verified against its manifest; a
        torn or corrupted newest directory is *skipped* (with a warning) in
        favour of the newest valid one under the keep-last-K retention —
        only when no snapshot verifies does restore raise ``IOError``."""
        from repro_torch.checkpoint.store import (_load_manifest, _step_dir,
                                                  checkpoint_steps,
                                                  restore_checkpoint,
                                                  verify_checkpoint)
        steps = checkpoint_steps(checkpoint_dir)
        if not steps:
            raise FileNotFoundError(
                f"no fleet checkpoints under {checkpoint_dir}")
        step, skipped = None, []
        for cand in reversed(steps):
            if verify_checkpoint(_step_dir(checkpoint_dir, cand)):
                step = cand
                break
            skipped.append(cand)
        if step is None:
            raise IOError(
                f"no valid fleet checkpoint under {checkpoint_dir}: all of "
                f"step(s) {skipped} failed integrity verification")
        if skipped:
            warnings.warn(
                f"fleet restore: checkpoint step(s) {skipped} under "
                f"{checkpoint_dir} failed integrity verification; falling "
                f"back to step {step}", RuntimeWarning, stacklevel=2)
        extra = _load_manifest(_step_dir(checkpoint_dir,
                                         step)).get("extra", {})
        meta = extra.get("tickets", {})
        if isinstance(programs, Program):
            programs = {programs.name: programs}
        missing = sorted({m["program"] for m in meta.values()}
                         - set(programs))
        if missing:
            raise ValueError(
                f"checkpoint references program(s) {missing} not in the "
                f"supplied mapping {sorted(programs)}")
        driver_kw.setdefault("batch", int(extra.get("batch", 8)))
        driver_kw.setdefault("checkpoint_dir", checkpoint_dir)
        drv = cls(**driver_kw)

        tree_like = {"tickets": {}}
        for tid, m in meta.items():
            entry = {"state": {f: 0.0 for f in m["fields"]},
                     "step": 0, "bucket": ""}
            if m.get("has_rng"):
                entry["rng"] = 0
            tree_like["tickets"][tid] = entry
        tree, _, _ = restore_checkpoint(checkpoint_dir, tree_like, step=step,
                                        verify=False, device=device)

        with drv._lock:
            for tid in sorted(meta, key=lambda s: int(s[1:])):
                m, saved = meta[tid], tree["tickets"][tid]
                program = programs[m["program"]]
                consts = {k: np.asarray(c["value"], np.dtype(c["dtype"]))
                          for k, c in m["consts"].items()}
                t = Ticket(tid, m["program"], m["nsteps"],
                           tuple(m["grid_shape"]),
                           {f: saved["state"][f] for f in m["fields"]},
                           consts, saved.get("rng"),
                           step=int(saved["step"]))
                t.retries = int(m.get("retries", 0))
                drv._tickets[tid] = t
                drv._programs.setdefault(program.name, program)
                drv._counter = max(drv._counter, int(tid[1:]))
                if m.get("status") == "failed":
                    # terminal at snapshot time — comes back failed (the
                    # live exception object is gone; keep the message)
                    t.status = "failed"
                    t.error = RuntimeError(m.get("error") or
                                           f"ticket {tid} failed before "
                                           f"the checkpoint")
                    t.bucket_id = str(saved["bucket"])
                elif t.step >= t.nsteps:
                    t.status = "done"
                    t.bucket_id = str(saved["bucket"])
                else:
                    drv._place(t, program)
        return drv

    def __repr__(self):
        with self._lock:
            n_done = sum(t.done for t in self._tickets.values())
            return (f"FleetDriver(batch={self.batch}, "
                    f"buckets={len(self._buckets)}, "
                    f"tickets={len(self._tickets)} ({n_done} done), "
                    f"running={self._thread is not None})")
