"""Target descriptors — *where and how* a kernel launch executes.

:class:`Target` is a small frozen value object naming the executor, carrying
the tunable VVL (under SoA: sites per thread on the card, chunk width
elsewhere; under AoSoA: the width of a site block), the memory layout, and an executor-specific ``tuning`` mapping.  Being frozen
and hashable, a Target participates directly in the launch plan cache key.

Executors of this package: ``"torch"`` (plain PyTorch, the oracle and CPU
path), ``"cuda"`` (the CUDA site-kernel executor) and ``"cuda_windowed"``
(its stencil-only partner, ``wants="halo_extended"``, whose fused step runs
in shared-memory tiles ``plane_block`` x-planes deep); both CUDA executors
read stencil fields in place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping

#: Process default VVL for targets with ``vvl=None`` (the chunk width of the
#: reference's default).  The CUDA executors resolve ``None`` to 1 instead:
#: one site per thread is the coalesced mapping on the card.
_DEFAULT_VVL = 128

#: Sites per thread the CUDA kernels are instantiated for; ``None`` resolves
#: to the first.
CUDA_VVLS = (1, 2, 4, 8)


def default_vvl() -> int:
    return _DEFAULT_VVL


def set_default_vvl(vvl: int) -> None:
    """Change the process-wide default VVL.

    Targets with ``vvl=None`` resolve this value *at launch time*, and the
    resolved VVL is part of the plan cache key, so flipping the default
    between two launches always rebuilds the plan.  The default is the
    chunk width of executors that declare no VVLs (``"torch"`` and any
    executor registered without ``vvls=``) and the AoSoA block width of
    every executor.  The CUDA executors' SoA launches do not read it: their
    kernels are built for :data:`CUDA_VVLS` only, and a SoA target with
    ``vvl=None`` launches them at one site a thread whatever the default
    is, so no default can turn such a launch into an error.  An explicit
    ``Target.vvl`` always wins.
    """
    global _DEFAULT_VVL
    if int(vvl) <= 0:
        raise ValueError("vvl must be positive")
    _DEFAULT_VVL = int(vvl)


def _freeze_tuning(tuning) -> tuple[tuple[str, Any], ...]:
    if isinstance(tuning, Mapping):
        items = sorted(tuning.items())
    else:
        items = sorted(tuple(kv) for kv in tuning)
    for k, v in items:
        if not isinstance(k, str):
            raise TypeError(f"tuning keys must be strings, got {k!r}")
        hash(v)  # tuning participates in the plan cache key
    return tuple((k, v) for k, v in items)


@dataclass(frozen=True)
class Target:
    """Execution target descriptor.

    Args:
      backend: executor name in the registry (``"torch"``, ``"cuda"``,
        ``"cuda_windowed"``, or any registered name).
      vvl: virtual vector length.  Under ``layout="soa"`` it is the sites
        per thread of the CUDA executors (one of :data:`CUDA_VVLS`;
        ``None`` → 1) and the chunk width elsewhere.  Under
        ``layout="aosoa"`` it is the width ``W`` of the AoSoA site block
        (``None`` → the process default, :func:`default_vvl`): any ``W >=
        1`` on ``"torch"`` and ``"cuda"`` (remainder sites zero-padded), a
        divisor of the interior x-plane's site count on
        ``"cuda_windowed"``.
      layout: ``"soa"`` (sites contiguous per component) or ``"aosoa"``
        (blocks of ``vvl`` sites outermost, then components, then the
        sites of a block; :mod:`repro_torch.core.layout`).  Outputs are
        SoA under both.
      tuning: executor/op-specific knobs, stored as a sorted tuple of
        pairs so the Target stays hashable.  The reserved keys
        ``"stage:<name>"`` hold a nested ``((knob, value), ...)``
        assignment for one stage of a Program
        (:func:`~repro_torch.core.program.resolve_stage_target`).
      mesh / shard_axis: sharding hints for mesh-aware callers
        (:meth:`~repro_torch.core.program.Program.compile`,
        :class:`~repro_torch.lb.sim.BinaryFluidSim`); a launch does not act
        on them, it only carries them.  ``mesh`` is a ``DeviceMesh``
        (:func:`repro_torch.launch.mesh.make_mesh`) and stays out of the
        Target's equality and hash, so plan and tuning caches never key on
        it; ``shard_axis`` is one mesh axis name (slab) or a tuple of names
        (pencil, block: axis *k* shards grid dim *k*).
    """

    backend: str = "cuda"
    vvl: int | None = None
    layout: str = "soa"
    tuning: tuple[tuple[str, Any], ...] = field(default=())
    mesh: Any = field(default=None, compare=False)
    shard_axis: str | tuple[str, ...] | None = None

    def __post_init__(self):
        if not isinstance(self.backend, str) or not self.backend:
            raise ValueError(f"backend must be a non-empty string, got "
                             f"{self.backend!r}")
        if self.vvl is not None:
            if int(self.vvl) <= 0:
                raise ValueError(f"vvl must be positive, got {self.vvl}")
            object.__setattr__(self, "vvl", int(self.vvl))
        if self.layout not in ("soa", "aosoa"):
            raise ValueError(
                f"layout must be 'soa' or 'aosoa', got {self.layout!r} "
                f"(the AoSoA inner width is the separate vvl field)")
        # one mesh axis name per sharded grid dim; frozen to a tuple so the
        # Target stays hashable
        if isinstance(self.shard_axis, (list, tuple)):
            object.__setattr__(self, "shard_axis",
                               tuple(str(a) for a in self.shard_axis))
        object.__setattr__(self, "tuning", _freeze_tuning(self.tuning))

    @property
    def executor(self) -> str:
        """Registry name this target dispatches to."""
        return self.backend

    def resolve_vvl(self) -> int:
        """The VVL this target launches with (explicit value, else the
        process default)."""
        return self.vvl if self.vvl is not None else _DEFAULT_VVL

    def tuning_dict(self) -> dict[str, Any]:
        return dict(self.tuning)

    def tune(self, key: str, default: Any = None) -> Any:
        """The ``tuning`` value of ``key``, else ``default``."""
        for k, v in self.tuning:
            if k == key:
                return v
        return default

    def with_tuning(self, updates: Mapping[str, Any] | None = None,
                    **kw) -> "Target":
        """Merge knobs into ``tuning``, keeping the unrelated ones (unlike
        ``with_(tuning=...)``, which replaces the whole mapping)."""
        merged = dict(self.tuning)
        merged.update(updates or {})
        merged.update(kw)
        return self.with_(tuning=merged)

    def with_(self, **updates) -> "Target":
        """Functional update (``dataclasses.replace`` with dict-friendly
        ``tuning``)."""
        if "tuning" in updates:
            updates["tuning"] = _freeze_tuning(updates["tuning"])
        return dataclasses.replace(self, **updates)

    # ``with_`` under its dataclasses spelling, as in the reference.
    replace = with_


def as_target(target: "Target | str | None" = None, *,
              vvl: int | None = None,
              layout: str | None = None) -> Target:
    """Coerce the accepted spellings to a :class:`Target`.

    ``None`` → the default (``"cuda"``) target; a string →
    ``Target(backend=string)``; a Target passes through.  ``vvl`` /
    ``layout`` (if given) override the target's.
    """
    if target is None:
        target = Target()
    elif isinstance(target, str):
        target = Target(backend=target)
    elif not isinstance(target, Target):
        raise TypeError(
            f"expected a Target, backend-name string, or None; got "
            f"{type(target).__name__}: {target!r}")
    if vvl is not None:
        target = target.with_(vvl=vvl)
    if layout is not None:
        target = target.with_(layout=layout)
    return target
