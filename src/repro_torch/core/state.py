"""``ProgramState`` — the named-field container for Program state.

A :class:`~repro_torch.core.program.Program` steps a set of named fields
(``{"f": (19, X, Y, Z), "g": (19, X, Y, Z)}``).  Fleets
(:mod:`repro_torch.core.fleet`) need a container that also says what the
leading axis means: a ``ProgramState`` is a read-only mapping of field name
→ tensor annotated with an optional ensemble extent.

* ``ProgramState({"f": f, "g": g})`` — single-member state; every field is
  ``(ncomp, *grid_shape)``.
* ``ProgramState({...}, ensemble=B)`` — fleet state; every field is ``(B,
  ncomp, *grid_shape)`` (the ensemble axis leads, so one ensemble launch
  steps every member).
* ``ProgramState.stack([s0, s1, ...])`` ↔ ``state.unstack()`` /
  ``state.member(i)`` move between the two.

``CompiledProgram.step``/``run`` accept a plain mapping or a
``ProgramState`` and return the same kind; ``FleetProgram`` takes the
ensemble form (or a mapping of pre-stacked tensors).  Validation
(:meth:`ProgramState.validate` / :func:`validate_field`) names the
offending field and dimension instead of dumping bare shape tuples.  The
checkpoint store flattens a ``ProgramState`` as the reference's pytree
does: its tensors in field order, keyed by their index.
"""
from __future__ import annotations

from collections.abc import Iterator, Mapping

import torch


def _dim_name(i: int, ensemble: bool) -> str:
    if ensemble and i == 0:
        return "dim 0 (ensemble)"
    j = i - (1 if ensemble else 0)
    return ("dim %d (ncomp)" % i) if j == 0 else (
        "dim %d (grid dim %d)" % (i, j - 1))


def validate_field(name: str, arr, *, ncomp: int | None,
                   grid_shape: tuple[int, ...],
                   ensemble: int | None = None,
                   program: str | None = None) -> None:
    """Shape/ncomp check for one field, raising errors that name the
    offending field and dimension.

    Expected shape: ``(ncomp, *grid_shape)``, with a leading ``ensemble``
    extent prepended when given.  ``ncomp=None`` skips the component check.
    """
    where = f" of program {program!r}" if program else ""
    rank = len(grid_shape) + 1 + (ensemble is not None)
    got = getattr(arr, "shape", None)
    if got is None or getattr(arr, "ndim", None) != rank:
        raise ValueError(
            f"field {name!r}{where} must be rank {rank} "
            f"({'ensemble, ' if ensemble is not None else ''}ncomp, "
            f"{', '.join(map(str, grid_shape))}); got "
            f"{'rank ' + str(arr.ndim) if hasattr(arr, 'ndim') else 'a non-array'}"
            f" with shape {got}")
    off = 1 if ensemble is not None else 0
    if ensemble is not None and int(got[0]) != ensemble:
        raise ValueError(
            f"field {name!r}{where}: {_dim_name(0, True)} is {got[0]}, "
            f"expected ensemble extent {ensemble}")
    if ncomp is not None and int(got[off]) != ncomp:
        raise ValueError(
            f"field {name!r}{where}: {_dim_name(off, ensemble is not None)} "
            f"is {got[off]}, expected ncomp {ncomp}")
    for d, want in enumerate(grid_shape):
        i = off + 1 + d
        if int(got[i]) != int(want):
            raise ValueError(
                f"field {name!r}{where}: "
                f"{_dim_name(i, ensemble is not None)} is {got[i]}, "
                f"expected grid extent {want} "
                f"(grid_shape {tuple(grid_shape)})")


class ProgramState(Mapping):
    """Mapping of field name → tensor, annotated with an optional leading
    ensemble axis.

    Behaves as a read-only mapping (``state["f"]``, ``dict(state)``,
    ``**state``).  The tensors are held, not copied.
    """

    __slots__ = ("_names", "_arrays", "ensemble")

    def __init__(self, arrays: Mapping[str, torch.Tensor], *,
                 ensemble: int | None = None):
        if not isinstance(arrays, Mapping):
            raise TypeError(f"ProgramState expects a mapping of field "
                            f"name -> array, got {type(arrays).__name__}")
        if ensemble is not None and int(ensemble) <= 0:
            raise ValueError(f"ensemble extent must be positive, "
                             f"got {ensemble}")
        self._names = tuple(arrays)
        self._arrays = {str(k): arrays[k] for k in self._names}
        self.ensemble = int(ensemble) if ensemble is not None else None

    # -- mapping protocol --------------------------------------------------

    def __getitem__(self, key: str):
        try:
            return self._arrays[key]
        except KeyError:
            raise KeyError(
                f"ProgramState has no field {key!r}; fields: "
                f"{list(self._names)}") from None

    def __iter__(self) -> Iterator[str]:
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    @property
    def fields(self) -> tuple[str, ...]:
        return self._names

    def replace(self, **arrays) -> "ProgramState":
        """Copy with the named field tensors swapped."""
        unknown = sorted(set(arrays) - set(self._names))
        if unknown:
            raise ValueError(f"ProgramState.replace: unknown field(s) "
                             f"{unknown}; fields: {list(self._names)}")
        return ProgramState({n: arrays.get(n, self._arrays[n])
                             for n in self._names}, ensemble=self.ensemble)

    # -- ensemble axis -----------------------------------------------------

    @classmethod
    def stack(cls, states) -> "ProgramState":
        """Stack single-member states (mappings or ``ProgramState``\\ s) into
        one ensemble state along a new leading axis (a new tensor)."""
        states = list(states)
        if not states:
            raise ValueError("ProgramState.stack needs at least one state")
        names = tuple(states[0])
        for i, s in enumerate(states):
            if tuple(s) != names:
                raise ValueError(
                    f"ProgramState.stack: member {i} has fields "
                    f"{list(s)}, expected {list(names)}")
            if isinstance(s, ProgramState) and s.ensemble is not None:
                raise ValueError(
                    f"ProgramState.stack: member {i} already carries an "
                    f"ensemble axis (ensemble={s.ensemble})")
        return cls({n: torch.stack([torch.as_tensor(s[n]) for s in states])
                    for n in names}, ensemble=len(states))

    def member(self, i: int) -> "ProgramState":
        """Member *i* of an ensemble state (drops the ensemble axis).

        The member's tensors are **views** of the ensemble's: a later
        in-place write to the ensemble (a fleet's ping-pong buffers, a
        driver's slot) shows through them.  ``clone()`` what must outlive
        it."""
        if self.ensemble is None:
            raise ValueError("ProgramState.member: state has no ensemble "
                             "axis")
        if not (-self.ensemble <= int(i) < self.ensemble):
            raise IndexError(f"member {i} out of range for ensemble "
                             f"extent {self.ensemble}")
        return ProgramState({n: self._arrays[n][i] for n in self._names})

    def unstack(self) -> list["ProgramState"]:
        """Split an ensemble state into its members (views, as
        :meth:`member`)."""
        if self.ensemble is None:
            raise ValueError("ProgramState.unstack: state has no ensemble "
                             "axis")
        return [self.member(i) for i in range(self.ensemble)]

    # -- validation --------------------------------------------------------

    def validate(self, ncomp: Mapping[str, int | None],
                 grid_shape, *, fields=None,
                 program: str | None = None) -> None:
        """Check every field's shape against ``(ncomp, *grid_shape)`` (plus
        this state's ensemble extent, if any), raising errors that name the
        offending field and dim.  ``fields`` defaults to this state's own
        field set."""
        grid_shape = tuple(int(s) for s in grid_shape)
        for f in (fields if fields is not None else self._names):
            if f not in self._arrays:
                raise ValueError(
                    f"state{' for program ' + repr(program) if program else ''}"
                    f" is missing field {f!r}; present: "
                    f"{list(self._names)}")
            validate_field(f, self._arrays[f], ncomp=ncomp.get(f),
                           grid_shape=grid_shape, ensemble=self.ensemble,
                           program=program)

    def __repr__(self):
        shapes = {n: tuple(getattr(a, "shape", ()))
                  for n, a in self._arrays.items()}
        ens = f", ensemble={self.ensemble}" if self.ensemble is not None \
            else ""
        return f"ProgramState({shapes}{ens})"
