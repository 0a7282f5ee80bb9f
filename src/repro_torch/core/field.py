"""Lattice fields — per-site value sets with an explicit memory layout.

The paper (§III-B) mandates a Structure-of-Arrays (SoA) layout, "where the
consecutive lattice site indices correspond to consecutive memory locations,
to allow chunks of lattice site data to be loaded as vectors for ILP
operations".  The layout is an explicit, testable property:

* ``soa``: array shape ``(ncomp, nsites)`` — sites contiguous.  This is the
  layout every targetDP launch requires.
* ``aos``: array shape ``(nsites, ncomp)`` — the "original code" layout
  whose innermost extent is dictated by the model (19 momenta, 3
  dimensions).  Kept so the paper's Fig. 1 baseline
  (:mod:`repro_torch.lb.baseline`) has its layout.

A :class:`Field` is the *host* copy (NumPy, host RAM).  The *target* copy is
a ``torch.Tensor`` made by :mod:`repro_torch.core.memory`.  Host fields of
stencil lattices are halo-padded.  This module is the port's own copy of the
reference's ``core/field.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Literal

import numpy as np

from .lattice import Lattice

Layout = Literal["soa", "aos"]


@dataclass
class Field:
    """Host-side lattice field: ``ncomp`` double/float values per site.

    Data is stored flat over the (halo-padded) site index so that the same
    container serves both the 3-D fluid lattice and the token lattice.
    """

    lattice: Lattice
    ncomp: int
    dtype: np.dtype = np.dtype(np.float64)
    layout: Layout = "soa"
    data: np.ndarray = dc_field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self):
        if self.ncomp <= 0:
            raise ValueError("ncomp must be positive")
        if self.layout not in ("soa", "aos"):
            raise ValueError(f"unknown layout {self.layout!r}")
        self.dtype = np.dtype(self.dtype)
        if self.data is None:
            self.data = np.zeros(self.array_shape, dtype=self.dtype)
        else:
            self.data = np.asarray(self.data, dtype=self.dtype)
            if self.data.shape != self.array_shape:
                raise ValueError(
                    f"field data shape {self.data.shape} != expected "
                    f"{self.array_shape}")

    # -- shapes ------------------------------------------------------------

    @property
    def nsites(self) -> int:
        return self.lattice.nsites_with_halo

    @property
    def array_shape(self) -> tuple[int, int]:
        if self.layout == "soa":
            return (self.ncomp, self.nsites)
        return (self.nsites, self.ncomp)

    # -- views -------------------------------------------------------------

    def grid_view(self) -> np.ndarray:
        """View shaped ``(ncomp, *halo_shape)`` (soa) / ``(*halo_shape, ncomp)``."""
        hs = self.lattice.halo_shape
        if self.layout == "soa":
            return self.data.reshape((self.ncomp, *hs))
        return self.data.reshape((*hs, self.ncomp))

    def interior(self) -> np.ndarray:
        """Interior (halo-stripped) grid view."""
        sl = self.lattice.interior_slices()
        g = self.grid_view()
        if self.layout == "soa":
            return g[(slice(None), *sl)]
        return g[(*sl, slice(None))]

    def site(self, *idx: int) -> np.ndarray:
        """All components at one (interior) grid index."""
        off = tuple(i + self.lattice.halo for i in idx)
        g = self.grid_view()
        if self.layout == "soa":
            return g[(slice(None), *off)]
        return g[(*off, slice(None))]

    # -- layout conversion -------------------------------------------------

    def to_layout(self, layout: Layout) -> "Field":
        if layout == self.layout:
            return self
        return Field(self.lattice, self.ncomp, self.dtype, layout,
                     self.data.T.copy())

    def copy(self) -> "Field":
        return Field(self.lattice, self.ncomp, self.dtype, self.layout,
                     self.data.copy())


def field_like(f: Field, data: np.ndarray | None = None) -> Field:
    return Field(f.lattice, f.ncomp, f.dtype, f.layout, data)
