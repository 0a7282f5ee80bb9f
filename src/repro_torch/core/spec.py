"""Kernel specifications — *what* a launch computes, declared up front.

A :class:`KernelSpec` is the declarative form of the paper's
``TARGET_ENTRY`` + launch-site annotations: the site-kernel body plus, per
input field, its *role* — pointwise (``(ncomp, nsites)``), or
stencil-carrying (``(noffsets, ncomp, nsites)`` neighbour stacks, with the
:class:`~repro_torch.core.lattice.Stencil` and halo policy) — plus the
output component counts and whether the kernel wants the global site index
(``site_index=True``, the position-dependent-kernel role).

Specs are frozen and hashable: together with the :class:`Target` they key
the launch-plan cache in :mod:`repro_torch.core.api`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

from .lattice import Stencil

#: FieldSpec.halo policies: "auto" accepts both regimes, "periodic"
#: requires a wrap-only gather (halo 0), "ghost" requires caller-filled
#: ghost planes (halo > 0) in every dimension the stencil reaches.
_HALO_POLICIES = ("auto", "periodic", "ghost")


@dataclass(frozen=True)
class FieldSpec:
    """Role declaration for one launch input.

    Args:
      ncomp: expected component count (leading SoA axis); ``None`` skips
        the check.
      stencil: neighbourhood this input is gathered over — ``None`` means
        a pointwise input.
      halo: halo policy for stencil inputs (see ``_HALO_POLICIES``).
      name: optional label used in error messages.
    """

    ncomp: int | None = None
    stencil: Stencil | None = None
    halo: str = "auto"
    name: str | None = None

    def __post_init__(self):
        if self.ncomp is not None and int(self.ncomp) <= 0:
            raise ValueError(f"ncomp must be positive, got {self.ncomp}")
        if self.stencil is not None and not isinstance(self.stencil, Stencil):
            raise TypeError(f"stencil must be a Stencil, got "
                            f"{type(self.stencil).__name__}")
        if self.halo not in _HALO_POLICIES:
            raise ValueError(f"halo policy must be one of {_HALO_POLICIES}, "
                             f"got {self.halo!r}")
        if self.halo == "ghost" and self.stencil is None:
            raise ValueError("halo='ghost' only applies to stencil fields")

    @property
    def role(self) -> str:
        return "pointwise" if self.stencil is None else "stencil"

    def label(self, i: int) -> str:
        return self.name or f"field {i}"


def field(ncomp: int | None = None, *, stencil: Stencil | None = None,
          halo: str = "auto", name: str | None = None) -> FieldSpec:
    """Ergonomic :class:`FieldSpec` constructor for ``@kernel(fields=[...])``."""
    return FieldSpec(ncomp=ncomp, stencil=stencil, halo=halo, name=name)


def _as_field_spec(x) -> FieldSpec:
    if isinstance(x, FieldSpec):
        return x
    if isinstance(x, Stencil):
        return FieldSpec(stencil=x)
    if x is None:
        return FieldSpec()
    if isinstance(x, int):
        return FieldSpec(ncomp=x)
    raise TypeError(f"cannot interpret {x!r} as a FieldSpec "
                    "(expected FieldSpec, Stencil, int ncomp, or None)")


def _normalize_out(out) -> tuple[int, ...] | None:
    if out is None:
        return None
    if isinstance(out, int):
        return (int(out),)
    return tuple(int(c) for c in out)


@dataclass(frozen=True)
class KernelSpec:
    """Declarative description of one targetDP kernel launch.

    Args:
      fn: the plain site-kernel body (torch ops over the trailing site
        axis).  A body that also has a hand-written CUDA counterpart names
        it in its ``__cuda_site__`` attribute.
      fields: per-input role declarations (coercible: a ``Stencil`` means a
        stencil field, an int means a pointwise field of that ncomp,
        ``None`` means unconstrained pointwise).
      out: output component count(s); ``None`` → infer from input 0.
      site_index: pass the global site indices, an ``int32`` tensor of
        shape ``(nsites,)``, as the last positional kernel argument (the
        paper's ``TARGET_ILP`` offset + base index).
      consts: optionally, the accepted ``TARGET_CONST`` names — launches
        passing an undeclared const name fail fast.
      name: display name (defaults to ``fn.__name__``).
    """

    fn: Callable
    fields: tuple[FieldSpec, ...]
    out: tuple[int, ...] | None = None
    site_index: bool = False
    consts: tuple[str, ...] | None = None
    name: str = ""

    def __post_init__(self):
        if not callable(self.fn):
            raise TypeError(f"kernel fn must be callable, got {self.fn!r}")
        fields = tuple(_as_field_spec(f) for f in self.fields)
        if not fields:
            raise ValueError("a KernelSpec needs at least one input field")
        object.__setattr__(self, "fields", fields)
        object.__setattr__(self, "out", _normalize_out(self.out))
        object.__setattr__(self, "site_index", bool(self.site_index))
        if self.consts is not None:
            object.__setattr__(self, "consts",
                               tuple(str(c) for c in self.consts))
        if not self.name:
            object.__setattr__(
                self, "name", getattr(self.fn, "__name__", "site_kernel"))

    @property
    def has_stencil(self) -> bool:
        return any(f.stencil is not None for f in self.fields)

    @property
    def stencils(self) -> tuple[Stencil | None, ...]:
        return tuple(f.stencil for f in self.fields)

    def __call__(self, *args, **kwargs):
        """A spec is callable as its body — handy for composing kernels."""
        return self.fn(*args, **kwargs)


def kernel(fields: Sequence, out=None, *, site_index: bool = False,
           consts: Sequence[str] | None = None,
           name: str | None = None) -> Callable[[Callable], KernelSpec]:
    """Decorator form of :class:`KernelSpec`::

        @kernel(fields=[field(1, stencil=STENCIL_GRAD_6PT)], out=(3, 1))
        def grad6(phi_nb): ...

    The decorated name *is* the spec; its body stays reachable as
    ``spec.fn`` and the spec itself remains callable.
    """
    def deco(fn: Callable) -> KernelSpec:
        return KernelSpec(fn, tuple(fields), out=out, site_index=site_index,
                          consts=tuple(consts) if consts is not None else None,
                          name=name or getattr(fn, "__name__", ""))
    return deco
