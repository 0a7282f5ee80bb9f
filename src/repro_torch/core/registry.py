"""Executor registry — the pluggable backend table behind ``launch``.

An *executor* realises the paper's ``TARGET_TLP``/``TARGET_ILP`` loops for
one architecture.  The core launch path (validation, padding, const
unwrapping, the neighbour prologue, plan caching) is executor-independent;
an executor only maps a prepared plan over prepared site arrays:

    def my_executor(plan, prepared, out=None):
        # plan:     repro_torch.core.api.LaunchPlan (kernel, vvl, out_ncomp,
        #           consts, target, shape, halo,
        #           stencils, wants, memory estimate)
        # prepared: one tensor per input field.  What a stencil field looks
        #           like depends on the executor's declared capability:
        #             wants="gathered"       (default) — the shared gather
        #               prologue ran: (noffsets, ncomp, nsites) neighbour
        #               stack per stencil field, (ncomp, nsites) pointwise.
        #             wants="halo_extended"  — no gather: each stencil
        #               field arrives ONCE as a halo-extended grid
        #               (ncomp, *ext_shape) with exactly
        #               stencil.radius_per_dim() ghost layers per
        #               dimension (periodic dims wrap-padded, caller
        #               ghost planes trimmed to the radius);
        #               the executor resolves offsets itself, in-kernel.
        #             takes_fields=True      — no prologue at all (the
        #               card's executors): each stencil field arrives as
        #               the caller's own array viewed as (ncomp,
        #               *(shape + 2·halo)); the kernel wraps periodic
        #               dimensions (halo 0) and reads the caller's ghost
        #               planes (halo > 0) itself.  ``wants`` then only
        #               says whether the executor takes pointwise
        #               launches ("halo_extended": stencil launches only).
        # out:      None, or one preallocated contiguous (ncomp_o, nsites)
        #           tensor per output to write into (the ping-pong
        #           buffers of CompiledProgram.run)
        # returns:  tuple of (ncomp_o, nsites) outputs, one per
        #           plan.out_ncomp entry (``out`` itself when given)
        # An executor registered with takes_ensemble=True also runs a
        # fleet's ensemble launches: plan.ensemble is set and every
        # operand and output carries a leading (batch,) member axis.
        ...

    register_executor("my_backend", my_executor)                 # gathered
    register_executor("my_windowed", my_win, wants="halo_extended")
    register_executor("my_card", my_card, takes_fields=True)
    launch(spec, Target("my_backend"), *arrays)

Registering a new architecture is *one* ``register_executor`` call — the
gather-free CUDA stencil executor (``"cuda_windowed"``) lands this way,
not as a fork of launch logic.  Registration bumps an internal version
that is part of the plan cache key, so re-registering a name (even with a
different capability) can never serve a stale compiled closure.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

#: Executor input capabilities: what the launch prologue prepares for each
#: stencil-carrying field before dispatch.
EXECUTOR_WANTS = ("gathered", "halo_extended")


class ExecutorEntry(NamedTuple):
    """One registry row: the executor callable plus its declared input
    capability (see ``EXECUTOR_WANTS``), the ``Target.tuning`` keys it
    consults (``tunables`` — the sweep surface), the VVLs it launches
    with (``vvls``; ``None``: any positive VVL), whether it reads stencil
    fields in place (``takes_fields``) and its shared-memory estimate
    (``smem_bytes``: ``plan -> bytes`` a block of its kernel holds;
    ``None``: none) and whether it runs a fleet's ensemble launches
    (``takes_ensemble``)."""

    fn: Callable
    wants: str
    tunables: tuple[str, ...] = ()
    vvls: tuple[int, ...] | None = None
    takes_fields: bool = False
    smem_bytes: Callable | None = None
    takes_ensemble: bool = False


_EXECUTORS: dict[str, ExecutorEntry] = {}
_VERSION = 0


def register_executor(name: str, fn: Callable, *, overwrite: bool = False,
                      wants: str = "gathered",
                      tunables: tuple[str, ...] = (),
                      vvls: tuple[int, ...] | None = None,
                      takes_fields: bool = False,
                      smem_bytes: Callable | None = None,
                      takes_ensemble: bool = False) -> None:
    """Register ``fn`` as the executor behind ``Target(backend=name)``.

    ``wants`` declares the input capability: ``"gathered"`` (default)
    receives pre-gathered ``(noffsets, ncomp, nsites)`` neighbour stacks;
    ``"halo_extended"`` suppresses the gather and receives each stencil
    field once, as a halo-extended ``(ncomp, *ext_shape)`` grid.

    ``tunables`` declares the ``Target.tuning`` keys the executor actually
    consults — the surface a sweep or tuner builds candidate spaces from.
    ``vvls`` lists the VVLs the executor's kernels are built for under
    ``layout="soa"`` (the autotuner's VVL axis; the first is what
    ``vvl=None`` resolves to); ``None`` means any positive VVL.  Under
    ``layout="aosoa"`` the VVL is the AoSoA block width, which the
    declaration does not bound.

    ``takes_fields=True`` skips the prologue: each stencil field reaches
    the executor as the caller's own array viewed as ``(ncomp, *(shape +
    2·halo))``, and its kernel resolves neighbours, periodic wrap
    included, in place.  ``smem_bytes(plan)`` estimates the shared memory
    a block of its kernel holds (:meth:`LaunchPlan.vmem_bytes_estimate`).

    ``takes_ensemble=True`` declares that the executor runs an ensemble
    launch (:func:`repro_torch.core.api.launch_ensemble`): ``plan.ensemble``
    is then set, every operand and output carries a leading member axis,
    and the per-member const values ride on the plan.  A fleet
    (``CompiledProgram.vmap``) refuses a target whose executor does not.

    Raises ``ValueError`` on duplicate names unless ``overwrite=True``.
    """
    global _VERSION
    if not isinstance(name, str) or not name:
        raise ValueError(f"executor name must be a non-empty string, "
                         f"got {name!r}")
    if not callable(fn):
        raise TypeError(f"executor must be callable, got {fn!r}")
    if wants not in EXECUTOR_WANTS:
        raise ValueError(f"executor capability must be one of "
                         f"{EXECUTOR_WANTS}, got {wants!r}")
    tunables = tuple(str(t) for t in tunables)
    if vvls is not None:
        vvls = tuple(int(v) for v in vvls)
    if name in _EXECUTORS and not overwrite:
        raise ValueError(
            f"executor {name!r} is already registered; pass overwrite=True "
            f"to replace it")
    _EXECUTORS[name] = ExecutorEntry(fn, wants, tunables, vvls,
                                     bool(takes_fields), smem_bytes,
                                     bool(takes_ensemble))
    _VERSION += 1


def unregister_executor(name: str) -> None:
    global _VERSION
    if name not in _EXECUTORS:
        raise ValueError(f"executor {name!r} is not registered "
                         f"(have: {sorted(_EXECUTORS)})")
    del _EXECUTORS[name]
    _VERSION += 1


def get_executor(name: str) -> Callable:
    """The executor callable registered under ``name``."""
    return get_executor_entry(name).fn


def get_executor_entry(name: str) -> ExecutorEntry:
    """The full registry row — callable plus declared capability."""
    try:
        return _EXECUTORS[name]
    except KeyError:
        raise ValueError(
            f"unknown executor {name!r}; registered executors: "
            f"{sorted(_EXECUTORS)}") from None


def executor_wants(name: str) -> str:
    """The declared input capability of a registered executor."""
    return get_executor_entry(name).wants


def executor_tunables(name: str) -> tuple[str, ...]:
    """The ``Target.tuning`` keys a registered executor consults."""
    return get_executor_entry(name).tunables


def executor_vvls(name: str) -> tuple[int, ...] | None:
    """The VVLs a registered executor launches with under SoA (``None``:
    any)."""
    return get_executor_entry(name).vvls


def compatible_executors(*, stencil: bool) -> tuple[str, ...]:
    """Registered executor names able to run a launch of the given shape.

    A stencil-carrying spec can run on every capability (the prologue
    adapts: gather vs halo-extend); a pure pointwise spec has nothing to
    window, so ``wants="halo_extended"`` executors are excluded — the same
    rule :func:`repro_torch.core.api.launch` enforces at dispatch.  This is
    the executor axis of the autotuner's candidate space."""
    return tuple(sorted(
        name for name, entry in _EXECUTORS.items()
        if stencil or entry.wants != "halo_extended"))


def list_executors() -> tuple[str, ...]:
    """Every registered executor name, sorted."""
    return tuple(sorted(_EXECUTORS))


def registry_version() -> int:
    """Monotonic counter bumped on every (un)registration — part of the
    launch-plan cache key."""
    return _VERSION
