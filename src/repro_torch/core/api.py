"""The unified targetDP launch: ``launch(spec, target, *tensors)``.

The :class:`~repro_torch.core.spec.KernelSpec` declares *what* (kernel body,
field roles, stencils, outputs), the :class:`~repro_torch.core.target.Target`
declares *where/how* (executor, VVL), and this module owns the single shared
path every launch takes:

1. **validation** — field roles vs tensor ranks/extents, stencil geometry
   vs lattice + halo, const names;
2. **const splitting** — *static* consts (``TargetConst``, host arrays,
   scalars) are unwrapped to host values and content-hashed into the cache
   key; *dynamic* consts (``torch.Tensor``, e.g. a per-layer norm weight
   on the card) are per-call operands, keyed only by ``(name, shape,
   dtype)``;
3. **plan caching** — plans keyed on ``(spec, target, resolved VVL,
   lattice, halo, out, static consts, dynamic-const signature, registry
   version)``, so a re-registered executor can never be served from a
   stale plan;
4. **the neighbour prologue** — *capability-aware*: executors declaring
   ``wants="gathered"`` get the periodic-roll / ghost-window gather into
   ``(noffsets, ncomp, nsites)`` stacks; executors declaring
   ``wants="halo_extended"`` get each stencil field **once**, as a
   halo-extended ``(ncomp, *ext_shape)`` grid (:func:`halo_extend`);
   executors registered with ``takes_fields=True`` (the card's) get no
   prologue: each stencil field is the caller's own array, viewed as
   ``(ncomp, *(shape + 2·halo))`` (:func:`field_view`), and the kernel
   wraps and reads ghost planes itself;
5. **dispatch** — through the executor registry
   (:mod:`repro_torch.core.registry`).

:func:`launch_ensemble` is the same path for a fleet
(:mod:`repro_torch.core.fleet`): ``batch`` independent members, each
operand and output with a leading member axis, one executor call for all
of them.  Per-member const values (a ``BatchedConst`` sweep) ride on
``plan.ensemble``; only executors registered with ``takes_ensemble=True``
take it.

Built-in executors registered here: ``"torch"`` (each site body called once
over all sites — the oracle and the CPU path), ``"cuda"`` (the targetDP
site-kernel executor on the card, :mod:`repro_torch.kernels.tdp_pointwise`)
and ``"cuda_windowed"`` (its stencil-only partner with the tiled fused
step, :mod:`repro_torch.kernels.tdp_windowed`); both take fields.  The
kernel modules are imported at first dispatch.
"""
from __future__ import annotations

import functools
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .lattice import Lattice, Stencil
from .layout import aosoa_gather, soa_to_aosoa
from .memory import BatchedConst, TargetConst
from .registry import (
    get_executor_entry,
    register_executor,
    registry_version,
)
from .spec import KernelSpec
from .target import CUDA_VVLS, Target, as_target


# ---------------------------------------------------------------------------
# shared helpers (padding, gathering, const handling)
# ---------------------------------------------------------------------------

def pad_sites(x: torch.Tensor, vvl: int) -> torch.Tensor:
    """Zero-pad the trailing site axis up to a VVL multiple (paper §III-C:
    the TLP loop strides in whole chunks)."""
    n = x.shape[-1]
    n_pad = -(-n // vvl) * vvl
    if n_pad == n:
        return x
    return F.pad(x, (0, n_pad - n))


def _prod_shape(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def shifted_grid(grid: torch.Tensor, shape: tuple[int, ...],
                 halo: tuple[int, ...], offset) -> torch.Tensor:
    """The ``(ncomp, *shape)`` interior of ``grid`` (``(ncomp, *(shape +
    2·halo))``) read at ``site + offset``: dimensions with ``halo[d] == 0``
    wrap periodically (``torch.roll``), those with ``halo[d] > 0`` read the
    caller-supplied ghost planes (a window into the extended extent)."""
    g = grid
    shifts, dims = [], []
    for d, o in enumerate(offset):
        if halo[d]:
            g = g.narrow(d + 1, halo[d] + o, shape[d])
        elif o:
            shifts.append(-o)
            dims.append(d + 1)
    if dims:
        g = torch.roll(g, shifts, dims)
    return g


def gather_neighbors(x: torch.Tensor, shape: tuple[int, ...],
                     halo: tuple[int, ...], stencil: Stencil) -> torch.Tensor:
    """``(ncomp, nsites_ext)`` → ``(noffsets, ncomp, nsites)`` neighbour
    stack over the interior sites (slot ``i`` = the field at ``site +
    stencil.offsets[i]``)."""
    ext = tuple(s + 2 * h for s, h in zip(shape, halo))
    ncomp = x.shape[0]
    grid = x.reshape(ncomp, *ext)
    out = torch.empty((stencil.noffsets, ncomp, _prod_shape(shape)),
                      dtype=x.dtype, device=x.device)
    for i, off in enumerate(stencil.offsets):
        out[i].view(ncomp, *shape).copy_(shifted_grid(grid, shape, halo, off))
    return out


def field_view(x: torch.Tensor, shape: tuple[int, ...],
               halo: tuple[int, ...], stencil: Stencil) -> torch.Tensor:
    """``(ncomp, nsites_ext)`` → the same storage viewed as ``(ncomp,
    *(shape + 2·halo))``: the prologue of ``takes_fields`` executors, which
    copies nothing (``stencil`` is unused; the signature is the other
    prologues')."""
    return x.view(x.shape[0], *(s + 2 * h for s, h in zip(shape, halo)))


def halo_extend(x: torch.Tensor, shape: tuple[int, ...],
                halo: tuple[int, ...], stencil: Stencil) -> torch.Tensor:
    """``(ncomp, nsites_ext)`` → halo-extended grid ``(ncomp, *ext)`` with
    exactly ``stencil.radius_per_dim()`` ghost layers per dimension.

    The gather-free prologue for ``wants="halo_extended"`` executors: the
    field is padded **once** so every neighbour of every interior site is
    addressable by a fixed shift.  Dimensions with ``halo[d] == 0`` wrap
    periodically (``F.pad(mode="circular")`` on a ``(1, ncomp, *ext)``
    view); dimensions with ``halo[d] > 0`` reuse the caller-supplied ghost
    planes, trimmed down to the stencil radius.
    """
    r = stencil.radius_per_dim()
    ext_in = tuple(s + 2 * h for s, h in zip(shape, halo))
    g = x.reshape(x.shape[0], *ext_in)
    pads = []
    for d, (h, rd, s) in enumerate(zip(halo, r, shape)):
        if h:
            if h > rd:       # caller ghost wider than needed: trim
                g = g.narrow(d + 1, h - rd, s + 2 * rd)
            pads.append(0)
        else:
            if rd > s:
                raise ValueError(
                    f"stencil {stencil.name!r} radius {rd} in dim {d} "
                    f"exceeds the periodic extent {s}; refusing to "
                    f"wrap-pad more than one full period — supply "
                    f">= {rd} exchanged ghost planes in dim {d} "
                    f"(halo > 0) or enlarge the dimension")
            pads.append(rd)
    if any(pads):
        if len(shape) > 3:
            raise ValueError(
                f"periodic halo extension supports 1-3 grid dimensions, "
                f"got {len(shape)}")
        flat = []
        for p in reversed(pads):      # F.pad lists the last dim first
            flat += [p, p]
        g = F.pad(g[None], flat, mode="circular")[0]
    return g.contiguous()


class WindowVmemError(ValueError):
    """A launch whose kernel's shared-memory tile cannot fit in a block.

    Raised when :func:`launch` builds its plan, before anything launches,
    if :meth:`LaunchPlan.vmem_bytes_estimate` exceeds the
    :data:`~repro_torch.core.costmodel.DEFAULT_VMEM_LIMIT` bytes a block may
    hold on the card (227 KB on the H100): ``"cuda_windowed"``'s fused tile
    is ``plane_block + 2`` x-planes deep.  ``autotune`` prunes candidates
    past its ``vmem_limit`` before measuring; shrinking ``plane_block`` is
    the fix.  The reference's error of the same name guards its VMEM
    window (``repro/core/api.py``)."""


def _check_window_vmem(plan: "LaunchPlan") -> None:
    from .costmodel import DEFAULT_VMEM_LIMIT

    total = plan.vmem_bytes_estimate()
    if total > DEFAULT_VMEM_LIMIT:
        p = dict(plan.target.tuning).get("plane_block")
        raise WindowVmemError(
            f"kernel {plan.name!r} under executor "
            f"{plan.target.executor!r}: its tile (plane_block={p}) needs "
            f"{total} bytes of shared memory, more than the "
            f"{DEFAULT_VMEM_LIMIT} a block may hold — shrink plane_block")


def _unwrap_consts(consts: Mapping[str, object]) -> dict:
    """Static consts as the site bodies take them: a ``TargetConst``'s host
    array, a 0-d one as its Python scalar (``copy_constant_to_target(2.0)``
    multiplies a tensor as ``2.0`` does)."""
    out = {}
    for k, v in consts.items():
        if isinstance(v, TargetConst):
            v = v.value.item() if v.value.ndim == 0 else v.value
        out[k] = v
    return out


def _consts_cache_key(consts: Mapping[str, object]):
    items = []
    for k in sorted(consts):
        v = consts[k]
        if isinstance(v, (TargetConst, int, float, bool, str)):
            items.append((k, v))
        else:
            # host arrays hash by content through TargetConst semantics
            items.append((k, TargetConst(v)))
    return tuple(items)


def _split_consts(consts: Mapping[str, object]):
    """Partition launch consts into *static* values (hashable, in the plan
    cache key by content) and *dynamic* ones (``torch.Tensor``s: per-call
    operands the plan hands to the executor at each launch; the cache key
    carries only their ``(name, shape, dtype)`` signature).  A tensor on
    the card never goes through a host copy, and a new value of the same
    shape reuses the plan.  A ``BatchedConst`` (a per-member sweep) has no
    meaning on a bare launch and raises."""
    static, dyn = {}, {}
    for k, v in consts.items():
        if isinstance(v, BatchedConst):
            raise ValueError(
                f"const {k!r} is a BatchedConst (per-member ensemble "
                f"sweep); a bare launch has no ensemble axis — bind it "
                f"through a Program stage and compile a fleet with "
                f"CompiledProgram.vmap(batch) (tdp.fleet)")
        (dyn if isinstance(v, torch.Tensor) else static)[k] = v
    return static, dyn


def _normalize_halo(halo, ndim) -> tuple[int, ...]:
    if halo is None:
        return (0,) * ndim
    if isinstance(halo, int):
        return (int(halo),) * ndim
    h = tuple(int(x) for x in halo)
    if len(h) != ndim:
        raise ValueError(f"halo {h} does not match lattice ndim {ndim}")
    return h


# ---------------------------------------------------------------------------
# launch plan — what an executor receives
# ---------------------------------------------------------------------------

class Ensemble(NamedTuple):
    """The ensemble of an ensemble launch: ``batch`` members, and
    ``consts``, the swept consts as host arrays with a leading ``(batch,)``
    axis (member *i*'s value is row *i*)."""

    batch: int
    consts: Mapping[str, np.ndarray]

class LaunchPlan:
    """Everything an executor needs to map one kernel over the sites.

    Built (and cached) by :func:`launch`; executors are called as
    ``executor(plan, prepared, out)`` (see :mod:`repro_torch.core.registry`).
    ``shape``/``halo``/``stencils`` carry the launch geometry (``None`` /
    all-``None`` for pure pointwise launches), so capability-declaring
    executors can resolve neighbour offsets themselves and so the
    :meth:`hbm_bytes_estimate` memory model is derivable from the plan.
    :attr:`layout` is the target's: under ``"aosoa"``, :attr:`vvl` is the
    width of the AoSoA site block.  :attr:`ensemble` is ``None`` except on
    the plan of an ensemble launch (:func:`launch_ensemble`), where it is an
    :class:`Ensemble`.
    """

    __slots__ = ("kernel", "name", "vvl", "out_ncomp", "consts", "target",
                 "shape", "halo", "stencils", "field_ncomp", "wants",
                 "site_index", "ensemble")

    def __init__(self, *, kernel, name, vvl, out_ncomp, consts, target,
                 shape=None, halo=None,
                 stencils=None, field_ncomp=None, wants="gathered",
                 site_index=False, ensemble=None):
        self.kernel = kernel
        self.name = name
        self.vvl = vvl
        self.out_ncomp = out_ncomp
        self.consts = consts
        self.target = target
        self.shape = shape
        self.halo = halo
        self.stencils = tuple(stencils) if stencils is not None else None
        self.field_ncomp = (tuple(field_ncomp)
                            if field_ncomp is not None else None)
        self.wants = wants
        self.site_index = site_index
        self.ensemble = ensemble

    def with_consts(self, consts: dict, ensemble=None) -> "LaunchPlan":
        """A copy of this plan with ``consts`` (and ``ensemble``) — how a
        launch's dynamic consts and a fleet's member values reach the
        executor without touching the cached plan."""
        return LaunchPlan(
            kernel=self.kernel, name=self.name, vvl=self.vvl,
            out_ncomp=self.out_ncomp, consts=consts, target=self.target,
            shape=self.shape, halo=self.halo, stencils=self.stencils,
            field_ncomp=self.field_ncomp, wants=self.wants,
            site_index=self.site_index, ensemble=ensemble)

    def member_plan(self, i: int) -> "LaunchPlan":
        """Member ``i``'s single-launch plan of an ensemble plan: its own
        row of every swept const, unwrapped as a ``TargetConst`` of that
        row would be, so member ``i`` runs exactly what a solo launch with
        that value runs."""
        row = {k: TargetConst(v[i]) for k, v in self.ensemble.consts.items()}
        return self.with_consts({**self.consts, **_unwrap_consts(row)})

    @property
    def layout(self) -> str:
        """``"soa"`` or ``"aosoa"``: the target's operand layout."""
        return self.target.layout

    def _fields(self):
        if self.field_ncomp is None:
            raise ValueError(
                f"plan {self.name!r} carries no field metadata; build it "
                f"through launch / launch_plan")
        stencils = self.stencils or (None,) * len(self.field_ncomp)
        return tuple(zip(self.field_ncomp, stencils))

    def _ext_shape(self, stencil):
        r = stencil.radius_per_dim()
        return tuple(s + 2 * rd for s, rd in zip(self.shape, r))

    def vmem_bytes_estimate(self) -> int:
        """Shared memory, in bytes, one block of the executor's kernel holds
        for this launch (the registry entry's ``smem_bytes``; 0 for an
        executor that declares none)."""
        fn = get_executor_entry(self.target.executor).smem_bytes
        return 0 if fn is None else int(fn(self))

    def hbm_bytes_estimate(self, itemsize: int = 4) -> int:
        """Device-memory footprint of the executor's prepared operands plus
        outputs (excluding the caller's own input tensors).

        The gathered path materialises ``noffsets_i`` copies of every
        stencil field; the halo-extended path pays only the ghost-layer
        overhead ``prod(shape + 2·radius) / prod(shape)``.  This is the
        reference's model, keyed on ``wants``: it does not know that the
        card's executors read their fields in place.

        ``layout="aosoa"`` doubles the estimate, as the reference's does:
        the SoA↔AoSoA boundary transforms write every operand and output
        once more.  On the card's executors, which read SoA fields in place
        and so have no prepared copy to speak of under SoA, the doubled
        figure stands for those transforms: each field is copied into its
        AoSoA buffer before the kernel and each gathered output back out of
        it after, one extra round trip per byte the kernel moves.
        """
        if self.shape is None:
            raise ValueError("hbm_bytes_estimate needs a lattice shape")
        n = _prod_shape(self.shape)
        total = sum(self.out_ncomp) * n
        for c, s in self._fields():
            if s is None:
                total += c * n
            elif self.wants == "halo_extended":
                total += c * _prod_shape(self._ext_shape(s))
            else:
                total += c * s.noffsets * n
        if self.layout == "aosoa":
            total *= 2
        return total * itemsize

    def __repr__(self):
        return (f"LaunchPlan({self.name!r}, executor={self.target.executor!r}"
                f", vvl={self.vvl}, out={self.out_ncomp}, "
                f"wants={self.wants!r})")


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _validate_arrays(spec: KernelSpec, arrays, lattice, halo):
    if len(arrays) != len(spec.fields):
        raise ValueError(
            f"kernel {spec.name!r} declares {len(spec.fields)} field(s) "
            f"but got {len(arrays)} array(s)")
    for i, (x, fs) in enumerate(zip(arrays, spec.fields)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(
                f"{fs.label(i)} of kernel {spec.name!r} must be a "
                f"torch.Tensor, got {type(x).__name__}")
        if x.ndim != 2:
            raise ValueError(
                f"{fs.label(i)} of kernel {spec.name!r} has role "
                f"{fs.role!r} and must be an SoA array of shape "
                f"(ncomp, nsites); got rank {x.ndim} array")
        if fs.ncomp is not None and int(x.shape[0]) != fs.ncomp:
            raise ValueError(
                f"{fs.label(i)} of kernel {spec.name!r} declares "
                f"ncomp={fs.ncomp} but the array has {x.shape[0]} "
                f"component(s)")
    devices = {x.device for x in arrays}
    if len(devices) != 1:
        raise ValueError(f"inputs of kernel {spec.name!r} lie on different "
                         f"devices: {sorted(map(str, devices))}")

    if spec.has_stencil:
        if lattice is None:
            raise ValueError(
                f"kernel {spec.name!r} has stencil input(s) but the launch "
                f"is missing a lattice (neighbour geometry needs the shape)")
        h = _normalize_halo(halo, lattice.ndim)
        n_ext = _prod_shape(tuple(s + 2 * hh
                                  for s, hh in zip(lattice.shape, h)))
        for i, (x, fs) in enumerate(zip(arrays, spec.fields)):
            s = fs.stencil
            want = n_ext if s is not None else lattice.nsites
            if int(x.shape[-1]) != want:
                raise ValueError(
                    f"{fs.label(i)} extent {x.shape[-1]} != expected {want} "
                    f"({'extended' if s is not None else 'interior'}; "
                    f"shape={lattice.shape}, halo={h})")
            if s is None:
                continue
            if s.ndim != lattice.ndim:
                raise ValueError(
                    f"stencil {s.name!r} is {s.ndim}-D on a "
                    f"{lattice.ndim}-D lattice")
            for d, r in enumerate(s.radius_per_dim()):
                if h[d] and h[d] < r:
                    raise ValueError(
                        f"halo {h[d]} in dim {d} < stencil {s.name!r} "
                        f"radius {r}")
            if fs.halo == "periodic" and any(h):
                raise ValueError(
                    f"{fs.label(i)} declares halo policy 'periodic' but "
                    f"the launch supplies ghost planes (halo={h})")
            if fs.halo == "ghost" and not all(
                    h[d] >= r for d, r in enumerate(s.radius_per_dim())
                    if r):
                raise ValueError(
                    f"{fs.label(i)} declares halo policy 'ghost' but the "
                    f"launch halo {h} does not cover stencil "
                    f"{s.name!r} radius {s.radius_per_dim()}")
        return h

    # pure pointwise launch
    if halo is not None:
        hseq = (halo,) if isinstance(halo, int) else tuple(halo)
        if any(int(x) for x in hseq):
            raise ValueError("halo is only meaningful for stencil launches")
    nsite_set = {int(x.shape[-1]) for x in arrays}
    if len(nsite_set) != 1:
        raise ValueError(f"inputs disagree on site extent: "
                         f"{sorted(nsite_set)}")
    if lattice is not None:
        n = nsite_set.pop()
        if n not in (lattice.nsites, lattice.nsites_with_halo):
            raise ValueError(
                f"site extent {n} matches neither interior "
                f"({lattice.nsites}) nor halo-padded "
                f"({lattice.nsites_with_halo}) lattice")
    return None


def _validate_wrap_extents(spec: KernelSpec, lattice, halo):
    """Plan-build guard for the periodic wrap of :func:`halo_extend` and of
    the card's kernels: refuse a ``wants="halo_extended"`` or
    ``takes_fields`` launch whose stencil radius exceeds a periodic extent,
    naming the dim/radius/extent before any work runs."""
    if lattice is None or not spec.has_stencil:
        return
    h = halo if halo is not None else (0,) * lattice.ndim
    for i, fs in enumerate(spec.fields):
        s = fs.stencil
        if s is None:
            continue
        for d, r in enumerate(s.radius_per_dim()):
            if r and h[d] == 0 and r > lattice.shape[d]:
                raise ValueError(
                    f"{fs.label(i)} of kernel {spec.name!r}: stencil "
                    f"{s.name!r} radius {r} in dim {d} exceeds the "
                    f"periodic extent {lattice.shape[d]} (halo_extend "
                    f"cannot wrap-pad a dimension thinner than the "
                    f"stencil radius); supply >= {r} ghost planes in "
                    f"dim {d} or enlarge it")


def _validate_layout(spec: KernelSpec, target: Target,
                     lattice: Lattice | None, wants: str) -> None:
    """Plan-build validation of the AoSoA layout axis (the reference's
    ``repro/core/api.py:_validate_layout``).  Gathered executors pad
    remainder sites, so any vvl is valid there; the *windowed* AoSoA path
    groups each x-plane into vvl blocks and has no remainder blocks over
    the interior — vvl must divide the interior plane's site count.  (The
    halo-widened planes of a stencil field are zero-padded to a vvl
    multiple by the executor, so only the interior constrains vvl.)"""
    if target.layout != "aosoa" or wants != "halo_extended":
        return
    if lattice is None:
        return
    vvl = target.resolve_vvl()
    shape = lattice.shape
    rest_n = _prod_shape(shape[1:]) if len(shape) > 1 else 1
    if rest_n % vvl:
        raise ValueError(
            f"kernel {spec.name!r} with layout='aosoa' under executor "
            f"{target.executor!r}: vvl={vvl} does not divide the "
            f"interior plane extent {rest_n} (= prod{tuple(shape[1:])}) "
            f"— the windowed AoSoA path groups whole x-planes into "
            f"vvl-site blocks; pick a vvl dividing the plane site count")


# ---------------------------------------------------------------------------
# the launch itself
# ---------------------------------------------------------------------------

def _make_plan(spec: KernelSpec, target: Target, vvl: int,
               out_ncomp: tuple[int, ...], lattice: Lattice | None,
               halo: tuple[int, ...] | None, consts: dict,
               wants: str) -> LaunchPlan:
    return LaunchPlan(
        kernel=spec.fn, name=spec.name, vvl=vvl, out_ncomp=out_ncomp,
        consts=consts, target=target,
        shape=lattice.shape if lattice is not None else None, halo=halo,
        stencils=spec.stencils,
        field_ncomp=tuple(fs.ncomp if fs.ncomp is not None else 1
                          for fs in spec.fields),
        wants=wants, site_index=spec.site_index)


@functools.lru_cache(maxsize=4096)
def _build_plan(spec: KernelSpec, target: Target, vvl: int,
                out_ncomp: tuple[int, ...], lattice: Lattice | None,
                halo: tuple[int, ...] | None, const_key, dyn_sig,
                _registry_version):
    consts = _unwrap_consts(dict(const_key))
    dyn_names = tuple(k for k, _, _ in dyn_sig)
    entry = get_executor_entry(target.executor)
    executor = entry.fn
    plan = _make_plan(spec, target, vvl, out_ncomp, lattice, halo, consts,
                      entry.wants)
    _check_window_vmem(plan)
    stencils = spec.stencils
    shape = lattice.shape if lattice is not None else None
    n_out = len(out_ncomp)
    if entry.takes_fields:
        prologue = field_view
    elif entry.wants == "halo_extended":
        prologue = halo_extend
    else:
        prologue = gather_neighbors

    def run(arrays, out, dyn_values=()):
        p = plan
        if dyn_names:
            p = plan.with_consts({**plan.consts,
                                  **dict(zip(dyn_names, dyn_values))})
        prepared = tuple(x if s is None else prologue(x, shape, halo, s)
                         for x, s in zip(arrays, stencils))
        outs = executor(p, prepared, out)
        outs = (outs,) if not isinstance(outs, (tuple, list)) else tuple(outs)
        if len(outs) != n_out:
            raise ValueError(
                f"executor {target.executor!r} returned {len(outs)} "
                f"output(s) for kernel {spec.name!r}; plan declares "
                f"{n_out}")
        return outs

    run.plan, run.prologue = plan, prologue
    return run


def _check_out(spec, out, out_ncomp, arrays, nsites):
    out = (out,) if isinstance(out, torch.Tensor) else tuple(out)
    if len(out) != len(out_ncomp):
        raise ValueError(f"kernel {spec.name!r} has {len(out_ncomp)} "
                         f"output(s), got {len(out)} out buffer(s)")
    x0 = arrays[0]
    for o, c in zip(out, out_ncomp):
        if (tuple(o.shape) != (c, nsites) or o.dtype != x0.dtype
                or o.device != x0.device or not o.is_contiguous()):
            raise ValueError(
                f"out buffer of kernel {spec.name!r} must be a contiguous "
                f"{x0.dtype} tensor of shape {(c, nsites)} on {x0.device}; "
                f"got {o.dtype} {tuple(o.shape)} on {o.device}")
    return out


def launch(spec: KernelSpec, target: Target | str | None = None, /,
           *arrays, lattice: Lattice | None = None,
           halo: int | Sequence[int] | None = None,
           consts: Mapping[str, object] | None = None,
           out=None, **kw_consts):
    """Launch a declared kernel over the lattice (``TARGET_LAUNCH``).

    Args:
      spec: the :class:`KernelSpec`.
      target: a :class:`Target`, a backend-name string, or ``None`` for the
        default ``"cuda"`` target.  The CUDA executors launch their kernels
        on CUDA tensors and run the plain version on CPU tensors; the data's
        device is the caller's choice.
      *arrays: one SoA tensor per declared field — ``(ncomp, nsites)``;
        stencil fields span the halo-extended extent when ``halo`` is
        non-zero.
      lattice: grid descriptor.  Required when any field carries a stencil.
      halo: per-dimension ghost width already present in stencil inputs
        (``0`` → periodic wrap).
      consts / **kw_consts: ``TARGET_CONST`` parameters: ``TargetConst``,
        host arrays or scalars (static, in the plan cache key by content)
        or ``torch.Tensor``s (dynamic, passed to the executor per call and
        keyed by name, shape and dtype only).  ``lattice``, ``halo``,
        ``consts`` and ``out`` are reserved keyword names — pass consts
        with those names through the ``consts=`` mapping.
      out: optional preallocated output tensor(s), contiguous
        ``(ncomp_o, nsites)``, written in place and returned.

    Returns one ``(ncomp_o, nsites)`` tensor per declared output (a bare
    tensor for single-output kernels).
    """
    if not isinstance(spec, KernelSpec):
        raise TypeError(f"launch expects a KernelSpec as first argument, "
                        f"got {type(spec).__name__}")
    tgt = as_target(target)
    entry = get_executor_entry(tgt.executor)
    if entry.wants == "halo_extended" and not spec.has_stencil:
        raise ValueError(
            f"executor {tgt.executor!r} declares wants='halo_extended' "
            f"(gather-free stencil windows) but kernel {spec.name!r} has "
            f"no stencil-carrying fields; use a 'gathered' executor such "
            f"as 'torch' or 'cuda' for pointwise kernels")
    arrays = tuple(arrays)
    if not arrays:
        raise ValueError("launch requires at least one input field")
    all_consts = dict(consts or {})
    all_consts.update(kw_consts)
    if spec.consts is not None:
        unknown = sorted(set(all_consts) - set(spec.consts))
        if unknown:
            raise ValueError(
                f"kernel {spec.name!r} does not declare const(s) "
                f"{unknown}; declared: {sorted(spec.consts)}")
    h = _validate_arrays(spec, arrays, lattice, halo)
    if entry.wants == "halo_extended" or entry.takes_fields:
        _validate_wrap_extents(spec, lattice, h)
    _validate_layout(spec, tgt, lattice, entry.wants)
    out_ncomp = spec.out if spec.out is not None else (int(arrays[0].shape[0]),)
    if out is not None:
        nsites = (lattice.nsites if spec.has_stencil
                  else int(arrays[0].shape[-1]))
        out = _check_out(spec, out, out_ncomp, arrays, nsites)
    static, dyn = _split_consts(all_consts)
    dyn_names = tuple(sorted(dyn))
    dyn_sig = tuple((k, tuple(int(n) for n in dyn[k].shape), str(dyn[k].dtype))
                    for k in dyn_names)
    run = _build_plan(spec, tgt, tgt.resolve_vvl(), out_ncomp, lattice, h,
                      _consts_cache_key(static), dyn_sig, registry_version())
    outs = run(arrays, out, tuple(dyn[k] for k in dyn_names))
    return outs[0] if len(outs) == 1 else outs


def _check_ensemble_out(spec, out, out_ncomp, arrays, nsites, batch):
    out = (out,) if isinstance(out, torch.Tensor) else tuple(out)
    for o in out:
        if o.ndim != 3 or int(o.shape[0]) != batch:
            raise ValueError(f"out buffer of ensemble launch of kernel "
                             f"{spec.name!r} must be (batch={batch}, ncomp, "
                             f"nsites); got {tuple(o.shape)}")
    _check_out(spec, tuple(o[0] for o in out), out_ncomp,
               tuple(x[0] for x in arrays), nsites)
    return out


def _ensemble_prologue(prologue, x, shape, halo, stencil):
    """The neighbour prologue of one ensemble operand ``(batch, ncomp,
    nsites_ext)``: a view for ``takes_fields`` executors, else the single
    prologue member by member, stacked."""
    if prologue is field_view:
        return x.view(x.shape[0], x.shape[1],
                      *(s + 2 * h for s, h in zip(shape, halo)))
    return torch.stack([prologue(m, shape, halo, stencil) for m in x])


def launch_ensemble(spec: KernelSpec, target: Target | str | None = None, /,
                    *arrays, batch: int, lattice: Lattice | None = None,
                    halo: int | Sequence[int] | None = None,
                    consts: Mapping[str, object] | None = None,
                    member_consts: Mapping[str, object] | None = None,
                    out=None):
    """One launch of ``spec`` over ``batch`` independent members: a stage
    of a fleet step (:mod:`repro_torch.core.fleet`).

    Each array is ``(batch, ncomp, nsites)`` (a stencil field over its
    halo-extended extent), each ``out`` buffer ``(batch, ncomp_o, nsites)``
    with each member contiguous.  ``consts`` are shared by every member
    (static: ``TargetConst``, host arrays, scalars); ``member_consts`` maps
    a const name to a host array with a leading ``(batch,)`` axis, row *i*
    being member *i*'s value (a ``BatchedConst`` sweep).  The executor,
    which must be registered with ``takes_ensemble=True``, gets the plan
    with :attr:`LaunchPlan.ensemble` set.  Returns one ``(batch, ncomp_o,
    nsites)`` tensor per output (a bare tensor for single-output kernels).
    """
    if not isinstance(spec, KernelSpec):
        raise TypeError(f"launch_ensemble expects a KernelSpec as first "
                        f"argument, got {type(spec).__name__}")
    tgt = as_target(target)
    entry = get_executor_entry(tgt.executor)
    if not entry.takes_ensemble:
        raise NotImplementedError(
            f"executor {tgt.executor!r} takes no ensemble launch (it is not "
            f"registered with takes_ensemble=True); a fleet cannot run "
            f"kernel {spec.name!r} under it")
    if entry.wants == "halo_extended" and not spec.has_stencil:
        raise ValueError(
            f"executor {tgt.executor!r} declares wants='halo_extended' but "
            f"kernel {spec.name!r} has no stencil-carrying fields")
    batch = int(batch)
    arrays = tuple(arrays)
    if not arrays:
        raise ValueError("launch_ensemble requires at least one input field")
    for i, x in enumerate(arrays):
        if not isinstance(x, torch.Tensor) or x.ndim != 3 \
                or int(x.shape[0]) != batch:
            raise ValueError(
                f"operand {i} of the ensemble launch of kernel {spec.name!r} "
                f"must be a (batch={batch}, ncomp, nsites) tensor, got "
                f"{tuple(getattr(x, 'shape', ()))}")
    shared = dict(consts or {})
    member = {k: np.asarray(v) for k, v in (member_consts or {}).items()}
    for k, v in member.items():
        if v.ndim < 1 or int(v.shape[0]) != batch:
            raise ValueError(
                f"member const {k!r} of kernel {spec.name!r}: leading "
                f"(ensemble) extent {v.shape[0] if v.ndim else '(scalar)'}, "
                f"expected {batch}")
    both = sorted(set(shared) & set(member))
    if both:
        raise ValueError(f"const(s) {both} of kernel {spec.name!r} are both "
                         f"shared and per member")
    if spec.consts is not None:
        unknown = sorted((set(shared) | set(member)) - set(spec.consts))
        if unknown:
            raise ValueError(
                f"kernel {spec.name!r} does not declare const(s) "
                f"{unknown}; declared: {sorted(spec.consts)}")
    h = _validate_arrays(spec, tuple(x[0] for x in arrays), lattice, halo)
    if entry.wants == "halo_extended" or entry.takes_fields:
        _validate_wrap_extents(spec, lattice, h)
    _validate_layout(spec, tgt, lattice, entry.wants)
    out_ncomp = spec.out if spec.out is not None else (int(arrays[0].shape[1]),)
    if out is not None:
        nsites = (lattice.nsites if spec.has_stencil
                  else int(arrays[0].shape[-1]))
        out = _check_ensemble_out(spec, out, out_ncomp, arrays, nsites, batch)
    static, dyn = _split_consts(shared)
    if dyn:
        raise ValueError(
            f"kernel {spec.name!r}: tensor const(s) {sorted(dyn)} on an "
            f"ensemble launch; pass per-member values as member_consts")
    run = _build_plan(spec, tgt, tgt.resolve_vvl(), out_ncomp, lattice, h,
                      _consts_cache_key(static), (), registry_version())
    plan = run.plan.with_consts(run.plan.consts,
                                ensemble=Ensemble(batch, member))
    shape = lattice.shape if lattice is not None else None
    prepared = tuple(x if s is None else _ensemble_prologue(run.prologue, x,
                                                            shape, h, s)
                     for x, s in zip(arrays, spec.stencils))
    outs = entry.fn(plan, prepared, out)
    outs = (outs,) if not isinstance(outs, (tuple, list)) else tuple(outs)
    if len(outs) != len(out_ncomp):
        raise ValueError(
            f"executor {tgt.executor!r} returned {len(outs)} output(s) for "
            f"kernel {spec.name!r}; plan declares {len(out_ncomp)}")
    return outs[0] if len(outs) == 1 else outs


def launch_plan(spec: KernelSpec, target: Target | str | None = None, *,
                lattice: Lattice | None = None,
                halo: int | Sequence[int] | None = None,
                consts: Mapping[str, object] | None = None) -> LaunchPlan:
    """Build (without launching) the :class:`LaunchPlan` a launch of
    ``spec`` under ``target`` would dispatch with — the introspection
    surface for :meth:`LaunchPlan.hbm_bytes_estimate`, and the handle the
    chip smoke test uses to call one executor directly."""
    if not isinstance(spec, KernelSpec):
        raise TypeError(f"launch_plan expects a KernelSpec, got "
                        f"{type(spec).__name__}")
    tgt = as_target(target)
    entry = get_executor_entry(tgt.executor)
    if entry.wants == "halo_extended" and not spec.has_stencil:
        raise ValueError(
            f"executor {tgt.executor!r} declares wants='halo_extended' but "
            f"kernel {spec.name!r} has no stencil-carrying fields")
    if spec.has_stencil and lattice is None:
        raise ValueError(f"kernel {spec.name!r} has stencil input(s); "
                         f"launch_plan needs the lattice")
    h = (_normalize_halo(halo, lattice.ndim)
         if lattice is not None and spec.has_stencil else None)
    if entry.wants == "halo_extended" or entry.takes_fields:
        _validate_wrap_extents(spec, lattice, h)
    _validate_layout(spec, tgt, lattice, entry.wants)
    if spec.out is not None:
        out_ncomp = spec.out
    elif spec.fields[0].ncomp is not None:
        out_ncomp = (spec.fields[0].ncomp,)
    else:
        raise ValueError(
            f"kernel {spec.name!r} declares neither out= nor an ncomp for "
            f"field 0 — its output count is only known at launch time, so "
            f"launch_plan cannot build a faithful plan")
    return _make_plan(spec, tgt, tgt.resolve_vvl(), tuple(out_ncomp),
                      lattice, h, _unwrap_consts(dict(consts or {})),
                      entry.wants)


# ---------------------------------------------------------------------------
# built-in executors
# ---------------------------------------------------------------------------

def aosoa_read(blocks: torch.Tensor, shape) -> torch.Tensor:
    """The SoA tensor of ``shape`` (``(..., n)``) whose rows the AoSoA
    ``(nblk, rows, vvl)`` buffer holds, read through the index map."""
    n = int(shape[-1])
    got = aosoa_gather(blocks, torch.arange(n, device=blocks.device))
    return got.reshape(shape)


def site_indices(n: int, device) -> torch.Tensor:
    """The global index of each of ``n`` sites, ``int32`` on ``device`` —
    what a ``site_index=True`` spec gets as its last positional argument.
    Indices stay 32-bit, as in the card's kernels: 2³¹ sites or more
    raise."""
    if n >= 2 ** 31:
        raise ValueError(f"{n} sites is 2^31 or more: site indices are "
                         f"32-bit")
    return torch.arange(n, dtype=torch.int32, device=device)


def torch_executor(plan: LaunchPlan, gathered, out=None):
    """The plain executor: the site body called **once** over all sites.

    Every targetDP site kernel is independent per site, so the VVL chunk
    loop of the reference's ``"xla"`` executor collapses to one call over
    the whole trailing site axis; under SoA ``plan.vvl`` is carried but not
    used.  A ``site_index`` plan's body also gets :func:`site_indices` of
    the output sites (the interior ones for a stencil launch).

    ``plan.layout == "aosoa"`` is the counterpart of the reference's
    AoSoA branch: every operand goes to AoSoA blocks of ``plan.vvl`` sites
    (:func:`~repro_torch.core.layout.soa_to_aosoa`) and the body reads its
    sites from the blocks through the AoSoA index map
    (:func:`~repro_torch.core.layout.aosoa_gather`), one call over all of
    them; outputs are SoA.  The reference maps its body over the blocks;
    here the body still makes one call over all sites, because PyTorch's
    CPU reductions pick their summation order by tensor shape, and a
    body mapped over ``(ncomp, vvl)`` tiles would round its sums
    differently from the SoA call.  So the AoSoA result equals the SoA one
    bit for bit.

    An ensemble plan (``plan.ensemble``) runs member by member
    (:func:`member_by_member`), each member exactly as its solo launch.
    """
    if plan.ensemble is not None:
        return member_by_member(plan, gathered, out, torch_executor)
    args = tuple(gathered)
    if plan.layout == "aosoa":
        args = tuple(aosoa_read(soa_to_aosoa(x.reshape(-1, x.shape[-1]),
                                             plan.vvl), x.shape)
                     for x in args)
    return call_body(plan, args, out)


def member_by_member(plan: LaunchPlan, operands, out, single):
    """An ensemble launch as ``batch`` single launches: member *i*'s
    operands (row *i* of each) through ``single(plan.member_plan(i),
    operands_i, out_i)``, so each member gets the bits of its solo launch.
    The plain version of the ensemble branches, and the ``"torch"``
    executor's."""
    results = []
    for i in range(plan.ensemble.batch):
        o_i = None if out is None else tuple(o[i] for o in out)
        results.append(single(plan.member_plan(i),
                              tuple(x[i] for x in operands), o_i))
    if out is not None:
        return tuple(out)
    return tuple(torch.stack([r[k] for r in results])
                 for k in range(len(plan.out_ncomp)))


def call_body(plan: LaunchPlan, args, out=None):
    """The plan's body called once over SoA operands (``(ncomp, n)``
    fields, ``(noffsets, ncomp, n)`` neighbour stacks), plus the site
    index of a ``site_index`` plan; written into ``out`` when given."""
    if plan.site_index:
        x = args[0]
        args = tuple(args) + (site_indices(int(x.shape[-1]), x.device),)
    outs = plan.kernel(*args, **plan.consts)
    outs = (outs,) if not isinstance(outs, tuple) else outs
    if out is None:
        return outs
    for o, v in zip(out, outs):
        o.copy_(v)
    return out


def _cuda_executor(plan: LaunchPlan, fields, out=None):
    from repro_torch.kernels.tdp_pointwise import cuda_execute
    return cuda_execute(plan, fields, out)


def _cuda_windowed_executor(plan: LaunchPlan, fields, out=None):
    from repro_torch.kernels.tdp_windowed import windowed_execute
    return windowed_execute(plan, fields, out)


def _cuda_windowed_smem(plan: LaunchPlan) -> int:
    from repro_torch.kernels.tdp_windowed import tile_smem_bytes
    return tile_smem_bytes(plan)


register_executor("torch", torch_executor, takes_ensemble=True)
register_executor("cuda", _cuda_executor, vvls=CUDA_VVLS, takes_fields=True,
                  takes_ensemble=True)
register_executor("cuda_windowed", _cuda_windowed_executor,
                  wants="halo_extended", tunables=("plane_block",),
                  vvls=CUDA_VVLS, takes_fields=True,
                  smem_bytes=_cuda_windowed_smem, takes_ensemble=True)
