"""The ``"cuda"`` executor — the targetDP site-kernel executor on Hopper.

Port of the Pallas executor ``repro/kernels/tdp_pointwise.py:_run_pallas``.
Where the reference's prologue gathers a ``(noffsets, ncomp, n)``
neighbour stack for each stencil field, this executor is registered with
``takes_fields=True``: it gets each stencil field as the caller's own
array, viewed as ``(ncomp, *(shape + 2·halo))``, and each pointwise field
as ``(ncomp, n)``.  ``csrc/tdp_gathered.cu`` maps the D3Q19 site function
over the sites, one thread per ``Target.vvl`` consecutive z-sites of a row
(``None`` → 1; any value outside {1, 2, 4, 8} raises), and reads each
neighbour in place: periodic dimensions (halo 0) wrap inside the kernel,
the others read the caller's ghost planes.  A launch with no stencil field
runs as one row of ``n`` sites.

The site function is the one the spec's plain body names in its
``__cuda_site__`` attribute; a spec whose body has none raises
``NotImplementedError``.  The D3Q19 site functions (``csrc/lb_sites.cuh``)
launch through ``csrc/tdp_gathered.cu``, the LM ones (``rmsnorm``, ``gated``,
``act``, ``mamba``; ``csrc/lm_sites.cuh``) through
``csrc/tdp_gathered_lm.cu``: ``rmsnorm``/``gated``/``act`` through one entry
that takes a runtime component count, a weight tensor and ``(eps,
scale_offset)``, ``mamba`` (the selective scan, site = channel) through one
of its own that takes four fields, the ``(batch·L, N)`` tensor consts
``b``/``c`` and two outputs, every batch row in one launch.  The paper's
example site functions (``scale``, ``saxpy``, ``site_pos``;
``csrc/example_sites.cuh``, plain bodies in
:mod:`repro_torch.kernels.example_sites`) launch through
``csrc/tdp_gathered_example.cu``: pointwise fields of a runtime component
count, the scalar const ``a``, one thread per ``Target.vvl`` sites moved
as one vector access per component (scalars where an operand's rows are
not aligned to it), and ``site_pos`` gets each site's global index (a
``site_index`` spec; every other site function refuses one).
:func:`example_reduce` maps one of them and reduces it over the sites in
one launch, the route :func:`repro_torch.core.execute.reduce` takes on the
card.
``gated``/``act`` map ``Target.vvl`` 16-byte groups to a thread (scalars
where an operand is not 16-byte aligned, as a view at a storage offset may
be); ``rmsnorm`` maps it to the tokens of a lane, a
block of warps sharing each token's components (one block sweeping the
array below 32 tokens).  Each site function checks its own fields and
consts.  CUDA tensors launch the kernel or raise; CPU tensors run the plain
version (:func:`fields_plain`: each stencil field's neighbours gathered by
:func:`repro_torch.core.api.gather_neighbors`, then the plain body).
:data:`launches` counts kernel launches per site function.

``Target(layout="aosoa")``: ``Target.vvl`` is the width ``W`` of the AoSoA
site block (any ``W >= 1``; ``None`` → the process default).  Every operand
goes through the boundary transform (:func:`aosoa_operands`): a stencil
field's flat extended grid, a pointwise field's sites, each into ``(nblk,
ncomp, W)`` blocks, the last zero-padded.  The AoSoA kernels read those
blocks themselves, one thread per site, and write AoSoA outputs, which
come back SoA through :func:`~repro_torch.core.layout.aosoa_to_soa`, as in
the reference.  ``gated``/``act`` are elementwise and every operand shares
one layout, so their AoSoA kernel is ``ew_kernel`` run over the padded
blocks.  ``mamba`` needs ``W`` a multiple of 4 (its chunk stage copies 4
channels at a time, and a copy may not straddle two blocks).  The LM site
functions take bfloat16 under AoSoA as under SoA (``mamba``'s ``a``, ``d``
and final state float32).  On CPU tensors the plain version
(:func:`aosoa_plain`) reads every operand through the same index map, then
runs the plain body.  :data:`aosoa_launches` counts the AoSoA kernel
launches per site function.

Ensembles (a fleet's stage, :func:`repro_torch.core.api.launch_ensemble`:
``plan.ensemble`` set, every operand and output with a leading member
axis): the LB site functions run every member in one launch of
``tdp_gathered_ensemble_launch`` (:func:`ensemble_execute`), the member on
``blockIdx.y``, each member's operands at its own offset (each member
contiguous, any distance between members) and its physics from row
``blockIdx.y`` of a device table (:func:`phys_table`) built by the kernels'
own ``make_phys``, so a member's ``fcoef``/``g3`` have the bits of its
single launch.  The table is cached by content: it is rebuilt only when a
member's values change, and the values are host arrays, so a launch reads
nothing back from the card.  On CPU tensors the plain version runs each
member in turn through :func:`fields_plain`.  A sweep of ``w`` or ``c``
raises (the kernels compile D3Q19's tables in); the LM and example site
functions and ``layout="aosoa"`` have no ensemble branch yet and raise
``NotImplementedError``.  :data:`ensemble_launches` counts the ensemble
launches per site function.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.layout import aosoa_gather, aosoa_to_soa, soa_to_aosoa

from . import _build
from . import bf16
from .lb_collision import (DTYPES, PHYS_DEFAULTS, check_cuda_tensors,
                           check_d3q19_consts, cuda_vvl, phys_row, refuse_bf16)

#: The LM site functions: those of the shared LM entry, and the selective
#: scan with its own.
LM_SITES = _build.LM_SITES + ("mamba",)
#: the storage types of the LM site functions' launches, SoA and AoSoA
#: (rmsnorm, gated, act; mamba's x, dt, b, c and y); the LB and example site
#: functions take them under SoA (``DTYPES``), their AoSoA and every
#: ensemble launch float32 only
LM_DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches of this executor, by site function; ``"reduce"`` counts
#: the one-pass map-and-reduce of an example site function
#: (:func:`example_reduce`)
launches = dict.fromkeys(_build.SITES + LM_SITES + _build.EXAMPLE_SITES
                         + ("reduce",), 0)
#: AoSoA kernel launches of this executor, by site function
aosoa_launches = dict.fromkeys(launches, 0)
#: ensemble kernel launches of this executor, by site function
ensemble_launches = dict.fromkeys(_build.SITES, 0)
#: the channels ``mamba``'s chunk stage copies at a time: the AoSoA width
#: must be a multiple of it
MAMBA_AOSOA_ALIGN = 4
#: the channels of a lane group of the AoSoA ``mamba`` kernel (its SoA VVL)
MAMBA_AOSOA_VVL = 2

_POINT = None
#: The field and output signature of each C site function
#: (``csrc/lb_sites.cuh``): ``((ncomp, stencil name or None), ...), out``.
SITE_FIELDS = {
    "stream": (((19, "d3q19_pull"),), (19,)),
    "grad6": (((1, "grad_6pt"),), (3, 1)),
    "moment": (((19, _POINT),), (1,)),
    "collide": (((19, _POINT), (19, _POINT), (1, _POINT), (3, _POINT),
                 (1, _POINT)), (19, 19)),
    "fused": (((19, "d3q19_pull"), (19, "fused_g")), (19, 19)),
    "phi_stream": (((19, "d3q19_pull"),), (1,)),
    "fused_two": (((19, "d3q19_pull"), (19, "d3q19_pull"), (1, "grad_6pt")),
                  (19, 19)),
}


def _lm_fields(site: str, plan):
    """The LM site functions' signatures: ``rmsnorm`` takes one pointwise
    field of any ncomp d and gives d components; ``gated`` takes two
    1-component fields, ``act`` one, and both give one; ``mamba`` takes
    ``x``/``dt`` of L components, ``a`` of N and ``d`` of 1, and gives
    ``y`` (L) and ``h`` (N)."""
    nc = plan.field_ncomp or ()
    if site == "rmsnorm":
        d = nc[0] if nc else None
        return ((d, None),), (d,)
    if site == "mamba":
        rows, nstate = (nc[0], nc[2]) if len(nc) == 4 else (None, None)
        batch = mamba_batch(plan)
        return (((rows, None),) * 2 + ((nstate, None), (1, None)),
                (rows, None if nstate is None else batch * nstate))
    return ((1, None),) * (2 if site == "gated" else 1), (1,)


def mamba_batch(plan) -> int:
    """The batch rows one launch of the ``mamba`` site function covers
    (its body's ``__cuda_batch__``)."""
    return int(getattr(plan.kernel, "__cuda_batch__", 1))


def _check_mamba_consts(plan) -> None:
    """``b``/``c`` are ``(batch·L, N)`` tensors (dynamic consts, never
    hashed through the host), and N is one the site function is
    instantiated for."""
    what = f"kernel {plan.name!r}"
    rows = plan.out_ncomp[0]
    nstate = plan.out_ncomp[1] // mamba_batch(plan)
    if nstate not in _build.MAMBA_NSTATES:
        raise ValueError(f"{what}: the CUDA site function 'mamba' is "
                         f"instantiated for d_state in "
                         f"{_build.MAMBA_NSTATES}, got {nstate}")
    for k in ("b", "c"):
        v = plan.consts.get(k)
        if not isinstance(v, torch.Tensor):
            raise ValueError(f"{what}: the CUDA site function 'mamba' needs "
                             f"const {k!r} as a tensor, got "
                             f"{type(v).__name__}")
        if tuple(v.shape) != (rows, nstate):
            raise ValueError(f"{what}: const {k!r} has shape "
                             f"{tuple(v.shape)}, expected {(rows, nstate)}")


def _check_lm_consts(site: str, plan) -> None:
    what = f"kernel {plan.name!r}"
    if site == "mamba":
        _check_mamba_consts(plan)
    elif site == "rmsnorm":
        missing = {"weight", "eps", "scale_offset"} - set(plan.consts)
        if missing:
            raise ValueError(f"{what}: the CUDA site function 'rmsnorm' "
                             f"needs const(s) {sorted(missing)}")
    elif getattr(plan.kernel, "__cuda_act__", None) not in _build.LM_ACT_ID:
        raise ValueError(f"{what}: activation "
                         f"{getattr(plan.kernel, '__cuda_act__', None)!r} "
                         f"is none of the CUDA ones {_build.LM_ACTS}")


def _check_example(site: str, plan) -> None:
    """The example site functions take pointwise fields (two for
    ``saxpy``), give one output, take the site index exactly when they are
    ``site_pos``, and a scalar ``a``."""
    what = f"kernel {plan.name!r}"
    nin = 2 if site == "saxpy" else 1
    if (len(plan.field_ncomp or ()) != nin or len(plan.out_ncomp) != 1
            or any(s is not None for s in plan.stencils or ())):
        raise ValueError(f"{what}: the CUDA site function {site!r} takes "
                         f"{nin} pointwise field(s) and gives one output")
    if plan.site_index != (site == "site_pos"):
        raise ValueError(f"{what}: the CUDA site function {site!r} "
                         f"{'needs a' if site == 'site_pos' else 'takes no'} "
                         f"site index")
    a = plan.consts.get("a", 1.0)
    if isinstance(a, torch.Tensor) or not isinstance(a, (int, float)):
        raise ValueError(f"{what}: the CUDA site function {site!r} takes "
                         f"const 'a' as a scalar, got {type(a).__name__}")


def cuda_site(plan, dtype=torch.float32) -> str:
    """The C site function behind ``plan``'s kernel, checked against the
    plan's field roles and consts (the D3Q19 tables as a launch in
    ``dtype`` takes them); ``NotImplementedError`` if the body has none."""
    site = getattr(plan.kernel, "__cuda_site__", None)
    if site is None:
        raise NotImplementedError(
            f"kernel {plan.name!r} has no CUDA site function (its body sets "
            f"no __cuda_site__); run it under Target('torch')")
    if site in _build.EXAMPLE_SITES:
        _check_example(site, plan)
        return site
    if plan.site_index:
        raise ValueError(f"kernel {plan.name!r}: the CUDA site function "
                         f"{site!r} takes no site index")
    if site in LM_SITES:
        fields, out = _lm_fields(site, plan)
    else:
        fields, out = SITE_FIELDS[site]
    got = tuple((c, None if s is None else s.name)
                for c, s in plan._fields())
    if got != fields or tuple(plan.out_ncomp) != out:
        raise ValueError(
            f"kernel {plan.name!r}: fields {got} -> {tuple(plan.out_ncomp)} "
            f"do not match the CUDA site function {site!r} "
            f"({fields} -> {out})")
    if site in LM_SITES:
        _check_lm_consts(site, plan)
    else:
        check_d3q19_consts(plan.consts, f"kernel {plan.name!r}", dtype)
    return site


def phys_args(consts) -> list[float]:
    """The six physics scalars, in the order of the C entries that take
    them (AoSoA; the SoA entries take :func:`~.lb_collision.phys_row`)."""
    return [float(consts.get(k, v)) for k, v in PHYS_DEFAULTS.items()]


def lb_geometry(plan, fields) -> tuple[int, ...]:
    """``(X, Y, Z, hx, hy, hz)`` of an LB launch for the C entries: the
    lattice and its ghost planes when a field carries a stencil, one row of
    ``n`` sites otherwise.  Checks each field's shape, and that a
    component of a field has fewer than 2³¹ elements (the kernels'
    in-component offsets and thread indices are 32-bit)."""
    if not any(s is not None for s in plan.stencils or ()):
        n = int(fields[0].shape[-1])
        if n >= 2 ** 31:
            raise ValueError(f"kernel {plan.name!r}: {n} sites is 2^31 or "
                             f"more")
        check_cuda_tensors(fields, [(c, n) for c, _ in plan._fields()],
                           f"kernel {plan.name!r}", DTYPES)
        return (1, 1, n, 0, 0, 0)
    if plan.shape is None or len(plan.shape) != 3:
        raise ValueError(f"kernel {plan.name!r}: the D3Q19 site functions "
                         f"need a 3-D lattice, got shape {plan.shape}")
    halo = tuple(plan.halo or (0, 0, 0))
    ext = tuple(s + 2 * h for s, h in zip(plan.shape, halo))
    if ext[0] * ext[1] * ext[2] >= 2 ** 31:
        raise ValueError(f"kernel {plan.name!r}: an extended grid of {ext} "
                         f"sites has 2^31 or more per component")
    n = plan.shape[0] * plan.shape[1] * plan.shape[2]
    check_cuda_tensors(fields, [(c, n) if s is None else (c, *ext)
                                for c, s in plan._fields()],
                       f"kernel {plan.name!r}", DTYPES)
    return (*plan.shape, *halo)


def fields_plain(plan, fields, out=None):
    """Plain version on the kernels' own operands: each stencil field
    (``(ncomp, *(shape + 2·halo))``) gathered into its neighbour stack by
    :func:`repro_torch.core.api.gather_neighbors` — the roll wraps
    periodic dimensions, the ghost planes serve the others — then the
    plain body once over all sites."""
    from repro_torch.core.api import gather_neighbors, torch_executor

    if not any(s is not None for s in plan.stencils or ()):
        return torch_executor(plan, fields, out)
    halo = tuple(plan.halo or (0,) * len(plan.shape))
    prepared = tuple(
        x if s is None else gather_neighbors(x.reshape(x.shape[0], -1),
                                             plan.shape, halo, s)
        for x, s in zip(fields, plan.stencils))
    return torch_executor(plan, prepared, out)


def pointer_arrays(ins, outs):
    """``(const void* in[5], void* out[2])`` for a C entry."""
    in_arr = (ctypes.c_void_p * 5)(*[x.data_ptr() for x in ins])
    out_arr = (ctypes.c_void_p * 2)(*[o.data_ptr() for o in outs])
    return in_arr, out_arr


def alloc_outputs(plan, like, n, out, dtypes=None):
    """Fresh ``(ncomp_o, n)`` outputs, or the caller's ``out`` buffers;
    each of ``like``'s dtype, or of ``dtypes`` (one an output)."""
    if out is not None:
        return tuple(out)
    dtypes = dtypes or (like.dtype,) * len(plan.out_ncomp)
    return tuple(torch.empty((c, n), dtype=dt, device=like.device)
                 for c, dt in zip(plan.out_ncomp, dtypes))


def _lib():
    fn = _build.load("tdp_gathered").tdp_gathered_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def _lm_lib():
    fn = _build.load("tdp_gathered_lm").tdp_gathered_lm_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _mamba_lib():
    fn = _build.load("tdp_gathered_lm").tdp_gathered_mamba_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                       + [ctypes.c_longlong] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _example_lib():
    fn = _build.load("tdp_gathered_example").tdp_gathered_example_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def example_a(plan, dtype) -> float:
    """The scalar ``a`` an example launch passes: in bfloat16 rounded as
    the plain body's weak scalar is."""
    return float(bf16.weak(plan.consts.get("a", 1.0), dtype))


def _example_shape(plan, site, fields) -> tuple[int, int]:
    """``(ncomp, n)`` of an example launch on CUDA tensors, its operands
    checked: fewer than 2³¹ sites (their indices are 32-bit), every field
    ``(ncomp, n)``, one output of ``ncomp`` components."""
    what = f"kernel {plan.name!r}"
    ncomp, n = (int(s) for s in fields[0].shape)
    if n >= 2 ** 31:
        raise ValueError(f"{what}: {n} sites is 2^31 or more: site indices "
                         f"are 32-bit")
    check_cuda_tensors(fields, [(ncomp, n)] * len(fields), what, DTYPES)
    if tuple(plan.out_ncomp) != (ncomp,):
        raise ValueError(f"{what}: the CUDA site function {site!r} gives "
                         f"{ncomp} component(s), the plan {plan.out_ncomp}")
    return ncomp, n


def _example_execute(plan, site, vvl, fields, out):
    """Launch an example site function on CUDA tensors."""
    what = f"kernel {plan.name!r}"
    x0 = fields[0]
    ncomp, n = _example_shape(plan, site, fields)
    outs = alloc_outputs(plan, x0, n, out)
    check_cuda_tensors([x0, *outs], [(ncomp, n)] * 2, f"{what} (out)", DTYPES)
    with torch.cuda.device(x0.device):
        rc = _example_lib()(
            _build.EXAMPLE_SITE_ID[site], vvl, _build.dtype_id(x0.dtype),
            x0.data_ptr(), fields[1].data_ptr() if len(fields) > 1 else None,
            outs[0].data_ptr(), n, ncomp, example_a(plan, x0.dtype),
            _build.stream_handle(x0.device))
    _build.check(rc, f"tdp_gathered_example {site}")
    launches[site] += 1
    return outs


def _example_reduce_lib():
    fn = _build.load("tdp_gathered_example").tdp_gathered_example_reduce_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


#: The block counter of the reduce kernel on each (device, stream): the
#: last block of every launch returns it to 0, so launches in one stream
#: share it.
_reduce_counters: dict = {}


def _reduce_counter(device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _reduce_counters:
        _reduce_counters[key] = torch.zeros(1, dtype=torch.int32,
                                            device=device)
    return _reduce_counters[key]


def fused_reduce_ok(spec, target, device) -> bool:
    """Whether :func:`example_reduce` takes ``spec`` under ``target`` on
    ``device``: a ``"cuda"`` target in the SoA layout, a CUDA device, and a
    body that is an example site function (``__cuda_site__`` in
    ``_build.EXAMPLE_SITES``)."""
    return (target.executor == "cuda" and target.layout == "soa"
            and torch.device(device).type == "cuda"
            and getattr(spec.fn, "__cuda_site__", None)
            in _build.EXAMPLE_SITES)


def example_reduce(plan, op: str, fields) -> torch.Tensor:
    """``op`` (``"sum"``, ``"max"``, ``"min"``) over the sites of the
    example site function of a SoA ``plan`` on CUDA ``fields``: the
    ``(ncomp,)`` result, from one launch of
    ``tdp_gathered_example_reduce_launch``, which maps and reduces in one
    pass and writes only the result (in the fields' dtype, float32 or
    bfloat16: a bfloat16 sum accumulated in double and rounded once).  Its
    plain version is ``reduce(..., target="torch")``."""
    site = cuda_site(plan)
    what = f"kernel {plan.name!r}"
    if site not in _build.EXAMPLE_SITE_ID or plan.layout != "soa":
        raise ValueError(f"{what}: the one-pass reduce takes an example site "
                         f"function {_build.EXAMPLE_SITES} under layout "
                         f"'soa', got {site!r} under {plan.layout!r}")
    if op not in _build.REDUCE_OP_ID:
        raise ValueError(f"op must be one of {_build.REDUCE_OPS}, got {op!r}")
    vvl = cuda_vvl(plan.target.vvl)
    x0 = fields[0]
    if x0.device.type != "cuda":
        raise ValueError(f"{what}: the one-pass reduce runs on CUDA tensors, "
                         f"got {x0.device}")
    ncomp, n = _example_shape(plan, site, fields)
    out = torch.empty(ncomp, dtype=x0.dtype, device=x0.device)
    partial = torch.empty(ncomp * _build.REDUCE_MAX_BLOCKS,
                          dtype=torch.float64, device=x0.device)
    stream = _build.stream_handle(x0.device)
    with torch.cuda.device(x0.device):
        rc = _example_reduce_lib()(
            _build.EXAMPLE_SITE_ID[site], _build.REDUCE_OP_ID[op], vvl,
            _build.dtype_id(x0.dtype), x0.data_ptr(),
            fields[1].data_ptr() if len(fields) > 1 else None,
            out.data_ptr(), partial.data_ptr(),
            _reduce_counter(x0.device, stream).data_ptr(), n, ncomp,
            example_a(plan, x0.dtype), stream)
    _build.check(rc, f"tdp_gathered_example reduce {op} of {site}")
    launches["reduce"] += 1
    return out


def _mamba_execute(plan, vvl, fields, out):
    """Launch the selective scan on CUDA tensors: every batch row in one
    launch.  x, dt, b, c and y float32 or bfloat16 (one dtype for the five),
    a, d and the final state h float32, as the plain body takes and gives
    them."""
    x0 = fields[0]
    rows, nstate_rows = plan.out_ncomp
    batch = mamba_batch(plan)
    nstate, length = nstate_rows // batch, rows // batch
    n = int(x0.shape[-1])
    b, c = plan.consts["b"], plan.consts["c"]
    what = f"kernel {plan.name!r}"
    check_cuda_tensors([x0, fields[1], b, c],
                       [(rows, n), (rows, n), (rows, nstate), (rows, nstate)],
                       f"{what} (x, dt, b, c)", LM_DTYPES)
    check_cuda_tensors(fields[2:], [(nstate, n), (1, n)], f"{what} (a, d)")
    outs = alloc_outputs(plan, x0, n, out, (x0.dtype, torch.float32))
    check_cuda_tensors([x0, outs[0]], [(rows, n)] * 2, f"{what} (x, y)",
                       LM_DTYPES)
    check_cuda_tensors(outs[1:], [(nstate_rows, n)], f"{what} (h)")
    if fields[2].device != x0.device:
        raise ValueError(f"{what}: a and d must lie on {x0.device}, got "
                         f"{fields[2].device}")
    with torch.cuda.device(x0.device):
        rc = _mamba_lib()(nstate, vvl, _build.dtype_id(x0.dtype),
                          *[t.data_ptr() for t in fields],
                          b.data_ptr(), c.data_ptr(), outs[0].data_ptr(),
                          outs[1].data_ptr(), length, n, batch,
                          _build.stream_handle(x0.device))
    _build.check(rc, "tdp_gathered_lm mamba")
    launches["mamba"] += 1
    return outs


def _lm_execute(plan, site, vvl, fields, out):
    """Launch an LM site function on CUDA tensors: float32 or bfloat16, one
    dtype for every operand (the weight too) and the output."""
    x0 = fields[0]
    ncomp, n = (int(s) for s in x0.shape)
    check_cuda_tensors(fields, [(ncomp, n)] * len(fields),
                       f"kernel {plan.name!r}", LM_DTYPES)
    weight = None
    if site == "rmsnorm":
        weight = plan.consts["weight"]
        if not isinstance(weight, torch.Tensor):
            raise ValueError(f"kernel {plan.name!r}: const 'weight' must be a "
                             f"tensor on {x0.device} for the CUDA site "
                             f"function, got {type(weight).__name__}")
        check_cuda_tensors([x0, weight], [(ncomp, n), (ncomp,)],
                           f"kernel {plan.name!r} (x, weight)", LM_DTYPES)
    outs = alloc_outputs(plan, x0, n, out)
    check_cuda_tensors([x0, *outs],
                       [(ncomp, n)] + [(c, n) for c in plan.out_ncomp],
                       f"kernel {plan.name!r} (x, out)", LM_DTYPES)
    act = _build.LM_ACT_ID.get(getattr(plan.kernel, "__cuda_act__", None), 0)
    with torch.cuda.device(x0.device):
        rc = _lm_lib()(
            _build.LM_SITE_ID[site], act, vvl, _build.dtype_id(x0.dtype),
            x0.data_ptr(),
            fields[1].data_ptr() if len(fields) > 1 else None,
            None if weight is None else weight.data_ptr(), outs[0].data_ptr(),
            n, ncomp, float(plan.consts.get("eps", 0.0)),
            float(plan.consts.get("scale_offset", 0.0)),
            _build.stream_handle(x0.device))
    _build.check(rc, f"tdp_gathered_lm {site}")
    launches[site] += 1
    return outs


def refuse_unported_bf16(plan, site, tensors) -> None:
    """``NotImplementedError`` (``lb_collision.refuse_bf16``) for a
    bfloat16 operand of a launch with no bfloat16 kernel: every ensemble
    launch (ROADMAP A5) and the AoSoA launches of the LB and example site
    functions (A7.1c.4).  Their SoA launches take bfloat16, and the LM
    site functions (``mamba`` too) take it under SoA and AoSoA."""
    what = f"kernel {plan.name!r} ({site!r}, layout {plan.layout!r}"
    if plan.ensemble is not None:
        refuse_bf16(tensors, f"{what}, an ensemble)", "A5: bfloat16 "
                    "ensembles")
    elif plan.layout == "aosoa" and site not in LM_SITES:
        refuse_bf16(tensors, f"{what})", "A7.1c.4: AoSoA LB and example "
                    "launches in bfloat16")


def cuda_execute(plan, fields, out=None):
    """Registry executor entry (``takes_fields=True``,
    ``takes_ensemble=True`` — see :mod:`repro_torch.core.registry`)."""
    site = cuda_site(plan, fields[0].dtype)
    if fields[0].device.type == "cuda":
        refuse_unported_bf16(plan, site, [*fields, *plan.consts.values()])
    if plan.ensemble is not None:
        return ensemble_execute(plan, site, fields, out, launch=_ensemble_launch)
    if plan.layout == "aosoa":
        return aosoa_execute(plan, site, fields, out)
    vvl = cuda_vvl(plan.target.vvl)
    x0 = fields[0]
    if x0.device.type == "cpu":
        return fields_plain(plan, fields, out)
    if x0.device.type != "cuda":
        raise ValueError(f"executor 'cuda' runs on CUDA or CPU tensors, got "
                         f"{x0.device}")
    if site == "mamba":
        return _mamba_execute(plan, vvl, fields, out)
    if site in _build.EXAMPLE_SITE_ID:
        return _example_execute(plan, site, vvl, fields, out)
    if site in _build.LM_SITE_ID:
        return _lm_execute(plan, site, vvl, fields, out)
    geom = lb_geometry(plan, fields)
    n = geom[0] * geom[1] * geom[2]
    outs = alloc_outputs(plan, x0, n, out)
    check_cuda_tensors([x0, *outs], [tuple(x0.shape)] + [
        (c, n) for c in plan.out_ncomp], f"kernel {plan.name!r} (out)", DTYPES)
    in_arr, out_arr = pointer_arrays(fields, outs)
    row = phys_row(plan.consts, x0.dtype)
    with torch.cuda.device(x0.device):
        rc = _lib()(_build.SITE_ID[site], vvl, _build.dtype_id(x0.dtype),
                    in_arr, out_arr, *geom, row.ctypes.data,
                    _build.stream_handle(x0.device))
    _build.check(rc, f"tdp_gathered {site}")
    launches[site] += 1
    return outs


# ---------------------------------------------------------------------------
# layout="aosoa"
# ---------------------------------------------------------------------------

def aosoa_plane_sites(plan, windowed: bool) -> int:
    """Sites of one x-plane of a stencil field's AoSoA operand: the
    extended plane's, padded to a multiple of ``W`` for the windowed
    executor (each plane in whole blocks), as they are for the gathered
    one (the blocks run over the flat extended grid)."""
    halo = tuple(plan.halo or (0,) * len(plan.shape))
    ps = 1
    for s, h in zip(plan.shape[1:], halo[1:]):
        ps *= s + 2 * h
    return -(-ps // plan.vvl) * plan.vvl if windowed else ps


def aosoa_operands(plan, fields, windowed: bool = False):
    """The boundary transform: each field into contiguous ``(nblk, ncomp,
    W)`` AoSoA blocks.  A pointwise field's blocks run over its sites; a
    stencil field's over its flat extended grid, each x-plane padded to
    :func:`aosoa_plane_sites` under the windowed executor."""
    ops = []
    for x, s in zip(fields, plan.stencils or (None,) * len(fields)):
        x = x.reshape(x.shape[0], -1) if s is None else x
        if s is not None:
            ps = aosoa_plane_sites(plan, windowed)
            x = x.reshape(x.shape[0], x.shape[1], -1)
            if ps != x.shape[-1]:
                x = F.pad(x, (0, ps - x.shape[-1]))
            x = x.reshape(x.shape[0], -1)
        ops.append(soa_to_aosoa(x, plan.vvl))
    return tuple(ops)


def neighbor_sites(plan, stencil, plane_sites: int, device=None
                   ) -> torch.Tensor:
    """``(noffsets, n)``: the flat index, in a stencil field's extended
    grid laid out with ``plane_sites`` sites an x-plane, of each interior
    site's neighbour at each offset — the wrap and the ghost planes of the
    kernels' accessor (``csrc/lb_sites.cuh``: ``wrap``)."""
    shape = plan.shape
    halo = tuple(plan.halo or (0,) * len(shape))
    ext = [s + 2 * h for s, h in zip(shape, halo)]
    strides = [plane_sites] + [1] * (len(shape) - 1)
    for d in range(len(shape) - 2, 0, -1):
        strides[d] = strides[d + 1] * ext[d + 1]
    coords = torch.meshgrid(*[torch.arange(s, device=device) for s in shape],
                            indexing="ij")
    rows = []
    for off in stencil.offsets:
        e = torch.zeros(shape, dtype=torch.int64, device=device)
        for c, o, s, h, st in zip(coords, off, shape, halo, strides):
            e += ((c + o + h) if h else (c + o) % s) * st
        rows.append(e.reshape(-1))
    return torch.stack(rows)


def aosoa_plain(plan, ops, n: int, windowed: bool = False):
    """Plain version on the AoSoA operands: every operand read through the
    index map (:func:`~repro_torch.core.layout.aosoa_gather`) — a stencil
    field at each interior site's neighbours (:func:`neighbor_sites`) —
    then the plain body once over the ``n`` sites.  Returns SoA
    outputs."""
    from repro_torch.core.api import call_body

    args = []
    for a, s in zip(ops, plan.stencils or (None,) * len(ops)):
        if s is None:
            args.append(aosoa_gather(a, torch.arange(n, device=a.device)))
        else:
            e = neighbor_sites(plan, s, aosoa_plane_sites(plan, windowed),
                               a.device)
            args.append(aosoa_gather(a, e).transpose(0, 1).contiguous())
    return call_body(plan, args)


def _aosoa_lib():
    fn = _build.load("tdp_gathered").tdp_gathered_aosoa_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p] + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _example_aosoa_lib():
    fn = _build.load(
        "tdp_gathered_example").tdp_gathered_example_aosoa_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _rmsnorm_aosoa_lib():
    fn = _build.load("tdp_gathered_lm").tdp_gathered_rmsnorm_aosoa_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                       + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _mamba_aosoa_lib():
    fn = _build.load("tdp_gathered_lm").tdp_gathered_mamba_aosoa_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                       + [ctypes.c_longlong] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _aosoa_launch(plan, site, ops, n, geom):
    """Launch the AoSoA kernel of ``site`` on the card's AoSoA operands;
    returns its AoSoA outputs: of operand 0's dtype, but ``mamba``'s final
    state, float32 as under SoA."""
    W = plan.vvl
    x0 = ops[0]
    dtypes = ((x0.dtype, torch.float32) if site == "mamba"
              else (x0.dtype,) * len(plan.out_ncomp))
    outs = tuple(torch.empty((-(-n // W), c, W), dtype=dt, device=x0.device)
                 for c, dt in zip(plan.out_ncomp, dtypes))
    dtype = _build.dtype_id(x0.dtype)
    stream = _build.stream_handle(x0.device)
    with torch.cuda.device(x0.device):
        if site == "mamba":
            rows, nstate_rows = plan.out_ncomp
            batch = mamba_batch(plan)
            b, c = plan.consts["b"], plan.consts["c"]
            nstate = nstate_rows // batch
            check_cuda_tensors([x0, b, c], [tuple(x0.shape)]
                               + [(rows, nstate)] * 2,
                               f"kernel {plan.name!r} (x, b, c)", LM_DTYPES)
            rc = _mamba_aosoa_lib()(
                nstate, W, dtype, *[t.data_ptr() for t in ops], b.data_ptr(),
                c.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                rows // batch, n, batch, stream)
        elif site in _build.EXAMPLE_SITE_ID:
            rc = _example_aosoa_lib()(
                _build.EXAMPLE_SITE_ID[site], W, x0.data_ptr(),
                ops[1].data_ptr() if len(ops) > 1 else None,
                outs[0].data_ptr(), n, int(x0.shape[1]),
                float(plan.consts.get("a", 1.0)), stream)
        elif site == "rmsnorm":
            weight = plan.consts["weight"]
            if not isinstance(weight, torch.Tensor):
                raise ValueError(f"kernel {plan.name!r}: const 'weight' must "
                                 f"be a tensor on {x0.device} for the CUDA "
                                 f"site function, got "
                                 f"{type(weight).__name__}")
            check_cuda_tensors([x0, weight], [tuple(x0.shape),
                                              (int(x0.shape[1]),)],
                               f"kernel {plan.name!r} (x, weight)", LM_DTYPES)
            rc = _rmsnorm_aosoa_lib()(
                W, dtype, x0.data_ptr(), weight.data_ptr(),
                outs[0].data_ptr(), n, int(x0.shape[1]),
                float(plan.consts.get("eps", 0.0)),
                float(plan.consts.get("scale_offset", 0.0)), stream)
        elif site in _build.LM_SITE_ID:
            # gated/act: every operand in one layout, so the elementwise
            # kernel over the padded blocks is the AoSoA kernel
            act = _build.LM_ACT_ID[plan.kernel.__cuda_act__]
            rc = _lm_lib()(
                _build.LM_SITE_ID[site], act, 1, dtype,
                x0.data_ptr(), ops[1].data_ptr() if len(ops) > 1 else None,
                None, outs[0].data_ptr(), x0.numel(), 1, 0.0, 0.0, stream)
        else:
            in_arr, out_arr = pointer_arrays(ops, outs)
            rc = _aosoa_lib()(_build.SITE_ID[site], W, in_arr, out_arr, *geom,
                              aosoa_plane_sites(plan, False)
                              if plan.shape else 1,
                              *phys_args(plan.consts), stream)
    _build.check(rc, f"tdp_gathered AoSoA {site}")
    aosoa_launches[site] += 1
    return outs


def check_aosoa_operands(plan, site, ops) -> None:
    """The AoSoA operands on the card: contiguous, on one device, of one
    dtype (float32, or for the LM site functions bfloat16 too), but
    ``mamba``'s ``a`` and ``d``, float32 whatever x's dtype."""
    what = f"kernel {plan.name!r}"
    shapes = [tuple(a.shape) for a in ops]
    if site == "mamba":
        check_cuda_tensors(ops[:2], shapes[:2], f"{what} (x, dt)", LM_DTYPES)
        check_cuda_tensors(ops[2:], shapes[2:], f"{what} (a, d)")
        if ops[2].device != ops[0].device:
            raise ValueError(f"{what}: a and d must lie on {ops[0].device}, "
                             f"got {ops[2].device}")
    else:
        check_cuda_tensors(ops, shapes, what, LM_DTYPES
                           if site in _build.LM_SITE_ID else (torch.float32,))


def aosoa_sites(plan, fields) -> int:
    """The interior sites of a launch: the lattice's for a stencil launch,
    the fields' otherwise."""
    if any(s is not None for s in plan.stencils or ()):
        n = 1
        for s in plan.shape:
            n *= int(s)
        return n
    return int(fields[0].shape[-1])


def aosoa_execute(plan, site, fields, out=None, *, windowed=False,
                  launch=None):
    """A ``layout="aosoa"`` launch: the boundary transform, the AoSoA
    kernel on CUDA tensors (``launch(plan, site, ops, n, geom)``, by
    default the gathered executor's; it returns AoSoA outputs, or SoA
    ones when ``windowed``) or :func:`aosoa_plain` on CPU tensors, and
    SoA outputs."""
    W = plan.vvl
    x0 = fields[0]
    if site == "mamba" and W % MAMBA_AOSOA_ALIGN:
        raise ValueError(
            f"kernel {plan.name!r}: the CUDA site function 'mamba' under "
            f"layout='aosoa' needs vvl (the AoSoA block width) to be a "
            f"multiple of {MAMBA_AOSOA_ALIGN}, the channels its chunk stage "
            f"copies at a time; got vvl={W}")
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the CUDA executors run on CUDA or CPU tensors, "
                         f"got {x0.device}")
    n = aosoa_sites(plan, fields)
    on_card = x0.device.type == "cuda"
    geom = (lb_geometry(plan, fields) if on_card and site in _build.SITE_ID
            else None)
    ops = aosoa_operands(plan, fields, windowed)
    for a in ops:
        if max(a.shape[0] * W, a.shape[0] * a.shape[1]) >= 2 ** 31:
            raise ValueError(
                f"kernel {plan.name!r}: an AoSoA operand of {tuple(a.shape)} "
                f"has 2^31 or more sites or rows of W: the AoSoA kernels "
                f"index them in 32 bits")
    if not on_card:
        outs = aosoa_plain(plan, ops, n, windowed)
    else:
        check_aosoa_operands(plan, site, ops)
        outs = (launch or _aosoa_launch)(plan, site, ops, n, geom)
        if not windowed:
            outs = tuple(aosoa_to_soa(o, n) for o in outs)
    if out is None:
        return outs
    for o, v in zip(out, outs):
        o.copy_(v)
    return tuple(out)


# ---------------------------------------------------------------------------
# ensembles: every member in one launch
# ---------------------------------------------------------------------------

#: device tables of member physics, by (device, the members' six scalars)
_phys_tables: dict = {}
_PHYS_TABLES_MAX = 64


def check_ensemble(plan, site: str) -> None:
    """The ensemble branch takes the LB site functions under SoA, each swept
    const a physics scalar (one per member); ``w``/``c`` are compiled in."""
    what = f"kernel {plan.name!r}"
    if site not in _build.SITE_ID:
        raise NotImplementedError(
            f"{what}: the CUDA site function {site!r} has no ensemble branch "
            f"(ROADMAP A5: ensembles of the LM and example site functions)")
    if plan.layout != "soa":
        raise NotImplementedError(
            f"{what}: an ensemble under layout={plan.layout!r} is not ported "
            f"(ROADMAP A5: AoSoA fleets)")
    for k, v in plan.ensemble.consts.items():
        if k in ("w", "c"):
            raise ValueError(
                f"{what}: const {k!r} is swept per member, but the CUDA "
                f"kernels compile D3Q19's {k!r} in; sweep the physics "
                f"scalars {tuple(PHYS_DEFAULTS)} only")
        if k not in PHYS_DEFAULTS or v.shape[1:] != ():
            raise ValueError(
                f"{what}: swept const {k!r} of member shape {v.shape[1:]}; "
                f"the CUDA site functions take one scalar a member of "
                f"{tuple(PHYS_DEFAULTS)}")


def member_phys(plan) -> np.ndarray:
    """``(batch, 6)`` float32: each member's six physics scalars in the C
    entries' order, a swept const's row or the shared value."""
    B = plan.ensemble.batch
    vals = np.empty((B, len(PHYS_DEFAULTS)), np.float32)
    for j, (k, v) in enumerate(PHYS_DEFAULTS.items()):
        if k in plan.ensemble.consts:
            vals[:, j] = plan.ensemble.consts[k].reshape(B)
        else:
            vals[:, j] = float(plan.consts.get(k, v))
    return vals


def _phys_rows_lib():
    fn = _build.load("tdp_gathered").tdp_phys_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = None
    return fn


def phys_table(plan, device) -> torch.Tensor:
    """The ``(batch, 8)`` float32 table of ``tdp::Phys`` rows on ``device``
    that an ensemble launch reads: :func:`member_phys` through the C
    ``make_phys_rows``, built once per content and device."""
    vals = member_phys(plan)
    key = (str(device), vals.tobytes())
    table = _phys_tables.get(key)
    if table is None:
        rows = np.empty((vals.shape[0], 8), np.float32)
        _phys_rows_lib()(vals.shape[0], vals.ctypes.data, rows.ctypes.data)
        table = torch.from_numpy(rows).to(device)
        if len(_phys_tables) >= _PHYS_TABLES_MAX:
            _phys_tables.pop(next(iter(_phys_tables)))
        _phys_tables[key] = table
    return table


def check_members(tensors, what: str) -> None:
    """Each ensemble operand holds its members contiguously, one after
    another at a non-negative distance (gaps allowed)."""
    for i, x in enumerate(tensors):
        if not x[0].is_contiguous() or (x.shape[0] > 1
                                        and x.stride(0) < x[0].numel()):
            raise ValueError(
                f"{what}: ensemble operand {i} of shape {tuple(x.shape)} and "
                f"strides {x.stride()} does not hold each member "
                f"contiguously, members apart")


def stride_arrays(ins, outs):
    """``(const long long in_stride[5], long long out_stride[2])``: the
    member strides, in elements."""
    in_s = (ctypes.c_longlong * 5)(*[x.stride(0) for x in ins])
    out_s = (ctypes.c_longlong * 2)(*[o.stride(0) for o in outs])
    return in_s, out_s


def _ensemble_lib():
    fn = _build.load("tdp_gathered").tdp_gathered_ensemble_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def _ensemble_launch(plan, site, vvl, fields, outs, geom, table, stream):
    in_arr, out_arr = pointer_arrays(fields, outs)
    in_s, out_s = stride_arrays(fields, outs)
    rc = _ensemble_lib()(_build.SITE_ID[site], vvl, plan.ensemble.batch,
                         in_arr, out_arr, in_s, out_s, *geom,
                         table.data_ptr(), stream)
    _build.check(rc, f"tdp_gathered ensemble {site}")
    ensemble_launches[site] += 1


def ensemble_execute(plan, site, fields, out=None, *, launch):
    """An ensemble launch of an LB site function: on CUDA tensors one
    ``launch(plan, site, vvl, fields, outs, geom, table, stream)`` for
    every member, on CPU tensors each member in turn through
    :func:`fields_plain`.  ``fields``/``out`` carry a leading member axis;
    returns ``(batch, ncomp_o, n)`` outputs."""
    from repro_torch.core.api import member_by_member

    check_ensemble(plan, site)
    vvl = cuda_vvl(plan.target.vvl)
    x0 = fields[0]
    if x0.device.type == "cpu":
        return member_by_member(plan, fields, out, fields_plain)
    if x0.device.type != "cuda":
        raise ValueError(f"the CUDA executors run on CUDA or CPU tensors, "
                         f"got {x0.device}")
    what = f"kernel {plan.name!r} (ensemble)"
    check_members(fields, what)
    geom = lb_geometry(plan, [x[0] for x in fields])
    n = geom[0] * geom[1] * geom[2]
    B = plan.ensemble.batch
    outs = (tuple(out) if out is not None else
            tuple(torch.empty((B, c, n), dtype=x0.dtype, device=x0.device)
                  for c in plan.out_ncomp))
    check_members(outs, f"{what} (out)")
    check_cuda_tensors([o[0] for o in outs], [(c, n) for c in plan.out_ncomp],
                       f"{what} (out)")
    table = phys_table(plan, x0.device)
    with torch.cuda.device(x0.device):
        launch(plan, site, vvl, fields, outs, geom, table,
               _build.stream_handle(x0.device))
    return outs
