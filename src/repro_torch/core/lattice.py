"""Lattice descriptors — the structured grids targetDP operates over.

A :class:`Lattice` is a static description of a structured grid of *sites*;
a :class:`Stencil` is the static set of neighbour offsets a site kernel
reads.  Both are plain frozen dataclasses with no tensor state, kept
offset-for-offset equal to the JAX package's descriptors (the port's tests
pin that), so slot tables computed from them agree across the two packages.

Following the paper (§III-C), launched kernels iterate over sites in chunks
of a tunable *virtual vector length* (VVL); :meth:`Lattice.padded_nsites`
gives the padded extent for a given VVL.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import reduce
from operator import mul


def _prod(xs) -> int:
    return reduce(mul, xs, 1)


@dataclass(frozen=True)
class Lattice:
    """A static structured grid of sites.

    Args:
      shape: per-dimension site extents (excluding halo).
      halo: halo width in every dimension.
    """

    shape: tuple[int, ...]
    halo: int = 0

    def __post_init__(self):
        if not self.shape:
            raise ValueError("lattice must have at least one dimension")
        if any(int(s) <= 0 for s in self.shape):
            raise ValueError(f"lattice extents must be positive, got {self.shape}")
        if self.halo < 0:
            raise ValueError("halo must be non-negative")
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nsites(self) -> int:
        """Number of interior (non-halo) sites."""
        return _prod(self.shape)

    @property
    def halo_shape(self) -> tuple[int, ...]:
        """Per-dimension extents including halo."""
        return tuple(s + 2 * self.halo for s in self.shape)

    @property
    def nsites_with_halo(self) -> int:
        return _prod(self.halo_shape)

    def padded_nsites(self, vvl: int) -> int:
        """Site count rounded up to a multiple of ``vvl``."""
        if vvl <= 0:
            raise ValueError("vvl must be positive")
        return math.ceil(self.nsites / vvl) * vvl

    def nchunks(self, vvl: int) -> int:
        """Number of VVL chunks covering the sites."""
        return self.padded_nsites(vvl) // vvl

    def interior_slices(self) -> tuple[slice, ...]:
        """Slices selecting the interior of a halo-padded array."""
        if self.halo == 0:
            return tuple(slice(None) for _ in self.shape)
        return tuple(slice(self.halo, self.halo + s) for s in self.shape)


def token_lattice(batch: int, seq: int) -> Lattice:
    """The LM token lattice: one site per (batch, position) pair."""
    return Lattice(shape=(batch, seq), halo=0)


@dataclass(frozen=True)
class Stencil:
    """A static, ordered set of neighbour offsets a site kernel reads.

    A gathered launch hands the kernel one ``(noffsets, ncomp, nsites)``
    stack per stencil field: slot ``i`` holds the field value at
    ``site + offsets[i]``.  Kernels address slots by :meth:`index`, resolved
    once when a module is imported, so the lookup costs nothing per launch.
    """

    name: str
    offsets: tuple[tuple[int, ...], ...]

    def __post_init__(self):
        offs = tuple(tuple(int(c) for c in o) for o in self.offsets)
        if not offs:
            raise ValueError("stencil needs at least one offset")
        ndims = {len(o) for o in offs}
        if len(ndims) != 1:
            raise ValueError(f"offsets disagree on dimensionality: {offs}")
        if len(set(offs)) != len(offs):
            raise ValueError(f"duplicate offsets in stencil {self.name!r}")
        object.__setattr__(self, "offsets", offs)

    @property
    def ndim(self) -> int:
        return len(self.offsets[0])

    @property
    def noffsets(self) -> int:
        return len(self.offsets)

    @property
    def radius(self) -> int:
        """Max |offset| component — the halo width the stencil needs."""
        return max(abs(c) for o in self.offsets for c in o)

    def radius_per_dim(self) -> tuple[int, ...]:
        return tuple(max(abs(o[d]) for o in self.offsets)
                     for d in range(self.ndim))

    def index(self, offset) -> int:
        """Slot of ``offset`` in the gathered neighbour axis."""
        key = tuple(int(c) for c in offset)
        try:
            return self.offsets.index(key)
        except ValueError:
            raise KeyError(
                f"offset {key} not in stencil {self.name!r}") from None

    def compose(self, other: "Stencil", name: str | None = None) -> "Stencil":
        """Minkowski sum: every ``a + b`` offset, deduplicated, in
        first-seen order (``self`` outer, ``other`` inner).

        A pull stream (offsets ``-c_q``) composed with a gradient star gives
        the neighbourhood of gradient-of-streamed-field in one launch.
        """
        seen, offs = set(), []
        for a in self.offsets:
            for b in other.offsets:
                o = tuple(x + y for x, y in zip(a, b))
                if o not in seen:
                    seen.add(o)
                    offs.append(o)
        return Stencil(name or f"{self.name}*{other.name}", tuple(offs))


def _d3q19_velocities() -> tuple[tuple[int, int, int], ...]:
    """The D3Q19 velocity set (rest, 6 axis vectors, 12 face diagonals)."""
    axis = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
            (0, 0, -1)]
    diag = [(1, 1, 0), (1, -1, 0), (-1, 1, 0), (-1, -1, 0),
            (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
            (0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1)]
    return tuple([(0, 0, 0)] + axis + diag)


D3Q19_VELOCITIES: tuple[tuple[int, int, int], ...] = _d3q19_velocities()

#: Pull-scheme streaming: slot q holds the neighbour at ``-c_q``, i.e. the
#: upstream site whose population arrives here (f_q(x) ← f_q(x - c_q)).
STENCIL_D3Q19_PULL = Stencil(
    "d3q19_pull", tuple(tuple(-c for c in o) for o in D3Q19_VELOCITIES))

#: 6-point nearest-neighbour gradient star (+ centre): slot 0 is the site
#: itself, slots 1.. are (+x, -x, +y, -y, +z, -z).
STENCIL_GRAD_6PT = Stencil("grad_6pt", tuple(D3Q19_VELOCITIES[:7]))

#: 19-point isotropic gradient neighbourhood (centre + 18 D3Q19 neighbours).
STENCIL_GRAD_19PT = Stencil("grad_19pt", D3Q19_VELOCITIES)
