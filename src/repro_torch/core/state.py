"""Field validation for Program state.

A :class:`~repro_torch.core.program.Program` steps a mapping of named
fields (``{"f": (19, X, Y, Z), "g": (19, X, Y, Z)}``).
:func:`validate_field` names the offending field and dimension instead of
dumping bare shape tuples.  The ensemble container of the targetDP fleet
layer waits for a later slice (ROADMAP, queue A).
"""
from __future__ import annotations


def _dim_name(i: int) -> str:
    return ("dim %d (ncomp)" % i) if i == 0 else (
        "dim %d (grid dim %d)" % (i, i - 1))


def validate_field(name: str, arr, *, ncomp: int | None,
                   grid_shape: tuple[int, ...],
                   program: str | None = None) -> None:
    """Shape/ncomp check for one field: expected ``(ncomp, *grid_shape)``.
    ``ncomp=None`` skips the component check."""
    where = f" of program {program!r}" if program else ""
    rank = 1 + len(grid_shape)
    got = getattr(arr, "shape", None)
    if got is None or getattr(arr, "ndim", None) != rank:
        raise ValueError(
            f"field {name!r}{where} must be rank {rank} "
            f"(ncomp, {', '.join(map(str, grid_shape))}); got "
            f"{'rank ' + str(arr.ndim) if hasattr(arr, 'ndim') else 'a non-array'}"
            f" with shape {got}")
    if ncomp is not None and int(got[0]) != ncomp:
        raise ValueError(
            f"field {name!r}{where}: {_dim_name(0)} is {got[0]}, "
            f"expected ncomp {ncomp}")
    for d, want in enumerate(grid_shape):
        if int(got[d + 1]) != int(want):
            raise ValueError(
                f"field {name!r}{where}: {_dim_name(d + 1)} is {got[d + 1]}, "
                f"expected grid extent {want} "
                f"(grid_shape {tuple(grid_shape)})")
