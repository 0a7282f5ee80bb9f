"""Legacy targetDP launch surface + reductions.

The execution model (single-source site kernels, executor dispatch) lives
in the declarative API — :mod:`~repro_torch.core.spec` (*what*),
:mod:`~repro_torch.core.target` (*where/how*),
:mod:`~repro_torch.core.registry` and the one ``launch(spec, target,
*tensors)`` entry point of :mod:`~repro_torch.core.api`.

This module keeps the reference's original ``launch(kernel, lattice,
inputs)`` and ``launch_stencil(...)`` signatures as thin deprecation shims
over that entry point, plus :func:`reduce` (the paper's §V planned
extension) and :func:`site_kernel`.  The shims' ``backend`` defaults to
``"torch"``, the port's counterpart of the reference's ``"xla"``; the
device is the data's.  Each input's component count is read from its
tensor, so a site body that names a CUDA site function (``__cuda_site__``)
meets that function's signature under ``backend="cuda"``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Mapping, Sequence

import torch

from . import api as _api
from .lattice import Lattice, Stencil
from .spec import FieldSpec, KernelSpec
from .target import as_target


def site_kernel(fn: Callable) -> Callable:
    """Mark ``fn`` as a targetDP site kernel (``TARGET_ENTRY``).

    ``fn(*fields, **consts)`` receives one ``(ncomp_i, nsites)`` tensor per
    input field (plus the ``(nsites,)`` site indices if requested at
    launch) and returns one ``(ncomp_o, nsites)`` tensor or a tuple of
    them.  For the declarative form use :func:`repro_torch.core.spec.kernel`.
    """
    fn.__tdp_site_kernel__ = True
    return fn


def _normalize_out_ncomp(out_ncomp, inputs) -> tuple[int, ...]:
    if out_ncomp is None:
        return (int(inputs[0].shape[0]),)
    if isinstance(out_ncomp, int):
        return (out_ncomp,)
    return tuple(int(c) for c in out_ncomp)


def _as_fn(kernel):
    return kernel.fn if isinstance(kernel, KernelSpec) else kernel


def _fields(inputs, stencils=None) -> tuple[FieldSpec, ...]:
    stencils = stencils or (None,) * len(inputs)
    return tuple(FieldSpec(ncomp=int(x.shape[0]) if x.ndim else None,
                           stencil=s) for x, s in zip(inputs, stencils))


# ---------------------------------------------------------------------------
# deprecation shims — delegate to launch (repro_torch.core.api.launch)
# ---------------------------------------------------------------------------

def launch(kernel: Callable, lattice: Lattice | None,
           inputs: Sequence[torch.Tensor], *,
           out_ncomp: int | Sequence[int] | None = None,
           consts: Mapping[str, object] | None = None,
           vvl: int | None = None,
           backend: str = "torch",
           with_site_index: bool = False):
    """Deprecated: use ``launch(KernelSpec, Target, *tensors)``."""
    warnings.warn(
        "launch(kernel, lattice, inputs, backend=...) is deprecated; "
        "declare a KernelSpec and call tdp.launch(spec, Target(...), "
        "*tensors)", DeprecationWarning, stacklevel=2)
    inputs = tuple(inputs)
    if not inputs:
        raise ValueError("launch requires at least one input field")
    spec = KernelSpec(_as_fn(kernel), fields=_fields(inputs), out=out_ncomp,
                      site_index=with_site_index)
    return _api.launch(spec, as_target(backend, vvl=vvl), *inputs,
                       lattice=lattice, consts=consts)


def _normalize_stencils(stencil, n_inputs) -> tuple:
    if isinstance(stencil, Stencil):
        return (stencil,) * n_inputs
    stencils = tuple(stencil)
    if len(stencils) != n_inputs:
        raise ValueError(
            f"got {len(stencils)} stencils for {n_inputs} inputs")
    if not any(s is not None for s in stencils):
        raise ValueError("launch_stencil needs at least one Stencil; "
                         "use launch() for pointwise kernels")
    return stencils


def launch_stencil(kernel: Callable, lattice: Lattice,
                   inputs: Sequence[torch.Tensor], *,
                   stencil: Stencil | Sequence[Stencil | None],
                   out_ncomp: int | Sequence[int] | None = None,
                   consts: Mapping[str, object] | None = None,
                   vvl: int | None = None,
                   backend: str = "torch",
                   halo: int | Sequence[int] | None = None):
    """Deprecated: use ``launch`` with stencil-carrying ``FieldSpec``s.

    Under ``backend="cuda"`` a body naming a stencil site function
    (``stream``, ``grad6``, ...) launches kernel 2, which reads each
    neighbour in place."""
    warnings.warn(
        "launch_stencil(...) is deprecated; declare stencil fields on a "
        "KernelSpec and call tdp.launch(spec, Target(...), *tensors)",
        DeprecationWarning, stacklevel=2)
    inputs = tuple(inputs)
    if not inputs:
        raise ValueError("launch_stencil requires at least one input field")
    if lattice is None:
        raise ValueError("launch_stencil requires a lattice")
    spec = KernelSpec(_as_fn(kernel), out=out_ncomp, fields=_fields(
        inputs, _normalize_stencils(stencil, len(inputs))))
    return _api.launch(spec, as_target(backend, vvl=vvl), *inputs,
                       lattice=lattice, halo=halo, consts=consts)


# ---------------------------------------------------------------------------
# reductions — the paper's §V "planned extension", implemented
# ---------------------------------------------------------------------------

#: The plain reductions over the site axis.
_REDUCERS = {"sum": torch.sum, "max": torch.amax, "min": torch.amin}


def _map_reduce(spec, tgt, inputs, lattice, consts, op):
    """Map with :func:`~repro_torch.core.api.launch`, then reduce each
    output over its sites with :data:`_REDUCERS`."""
    mapped = _api.launch(spec, tgt, *inputs, lattice=lattice, consts=consts)
    mapped = (mapped,) if isinstance(mapped, torch.Tensor) else mapped
    return tuple(_REDUCERS[op](m, dim=-1) for m in mapped)


def _fused_reduce(spec, tgt, inputs, lattice, consts, op):
    """One launch of the example site function's map-and-reduce kernel
    (:func:`repro_torch.kernels.tdp_pointwise.example_reduce`)."""
    from repro_torch.kernels.tdp_pointwise import example_reduce
    out = spec.out or (int(inputs[0].shape[0]),)
    plan = _api.launch_plan(dataclasses.replace(spec, out=out), tgt,
                            lattice=lattice, consts=consts)
    return (example_reduce(plan, op, inputs),)


def reduce_route(spec: KernelSpec, target, device) -> Callable:
    """The route :func:`reduce` takes: :func:`_fused_reduce` where the
    card's executor can map and reduce in one launch
    (:func:`repro_torch.kernels.tdp_pointwise.fused_reduce_ok`),
    :func:`_map_reduce` otherwise."""
    from repro_torch.kernels.tdp_pointwise import fused_reduce_ok
    return (_fused_reduce if fused_reduce_ok(spec, target, device)
            else _map_reduce)


def reduce(kernel: Callable | KernelSpec, lattice: Lattice | None,
           inputs: Sequence[torch.Tensor], *,
           op: str = "sum",
           out_ncomp: int | Sequence[int] | None = None,
           consts: Mapping[str, object] | None = None,
           vvl: int | None = None,
           backend: str | None = None,
           target=None):
    """Map a site kernel over the lattice and reduce over the sites.

    Returns one ``(ncomp_out,)`` tensor per output on the inputs' device.
    The port's executors pad nothing (``"torch"`` maps all ``n`` sites in
    one call and the kernels mask their ragged end), so the body is mapped
    over exactly ``n`` sites and no identity mask is needed: a
    :class:`KernelSpec` launches as it is, and a site body of a CUDA site
    function (``__cuda_site__``) keeps it.  The target is a ``Target``, or
    the legacy ``backend=`` string (default ``"torch"``).

    Two routes (:func:`reduce_route`):

    * under ``target="cuda"``, SoA, on CUDA tensors, a body that is one of
      the paper's example site functions (``scale``, ``saxpy``,
      ``site_pos``) is mapped and reduced in **one** kernel launch, which
      reads each input once and writes only the result (the sum
      accumulates in double and rounds once to the input's dtype; max and
      min are exact);
    * every other case — the ``"torch"`` target, CPU tensors, the AoSoA
      layout, the LB and LM site functions, any other body — maps with
      :func:`~repro_torch.core.api.launch` and reduces with ``torch.sum``
      / ``amax`` / ``amin`` over the site axis, outside the kernel, as the
      reference's ``jnp.sum`` is outside Pallas (:data:`_REDUCERS`).
    """
    if op not in _REDUCERS:
        raise ValueError(f"op must be one of {sorted(_REDUCERS)}")
    inputs = tuple(inputs)
    if isinstance(kernel, KernelSpec) and out_ncomp is None:
        spec = kernel
    else:
        spec = KernelSpec(_as_fn(kernel), fields=_fields(inputs),
                          out=_normalize_out_ncomp(out_ncomp, inputs))
    tgt = as_target(target if target is not None else (backend or "torch"),
                    vvl=vvl)
    route = reduce_route(spec, tgt, inputs[0].device)
    red = route(spec, tgt, inputs, lattice, consts, op)
    return red[0] if len(red) == 1 else red
