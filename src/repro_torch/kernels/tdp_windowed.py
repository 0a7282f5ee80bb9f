"""The ``"cuda_windowed"`` executor — the gather-free stencil executor.

Port of the Pallas executor ``repro/kernels/tdp_windowed.py:
windowed_execute``.  It declares ``wants="halo_extended"`` (stencil launches
only; pointwise stages route to ``"cuda"``) and ``takes_fields=True``: each
stencil field arrives as the caller's own array, viewed as ``(ncomp,
*(shape + 2·halo))``, with no padded copy, and ``csrc/tdp_windowed.cu``
resolves every neighbour offset in the kernel, wrapping periodic
dimensions (halo 0) itself.  ``stream``, ``grad6``, ``phi_stream`` and
``fused_two`` run one thread per ``Target.vvl`` consecutive z-sites
(``None`` → 1; outside {1, 2, 4, 8} raises).  ``fused`` runs in tiles of
``plane_block`` x-planes by 8 × 32 (y, z) sites: a block sums the streamed
φ of its tile and a one-site rim into shared memory, then collides each
site of the tile with its gradient neighbours' φ from there.

Tuning (``Target.tuning``): ``plane_block`` — the tile's depth in x, the
reference's knob (default :data:`DEFAULT_PLANE_BLOCK`).  A tile holds
:func:`tile_smem_bytes` of shared memory; past the 227 KB a block may hold
the launch raises :class:`~repro_torch.core.api.WindowVmemError` when its
plan is built.

CUDA tensors launch the kernel or raise; CPU tensors run the plain version
(:func:`windowed_plain`: the neighbours gathered by slicing and rolling,
then the plain body).  :data:`launches` counts kernel launches per site
function.

``Target(layout="aosoa")`` (the reference's AoSoA branch,
``repro/kernels/tdp_windowed.py:102-206``): ``Target.vvl`` is the block
width ``W``, which must divide the interior plane's site count ``Y·Z``
(checked when the plan is built).  Each x-plane of every operand is grouped
into ``W``-site blocks, a stencil field's halo-widened planes zero-padded
to a multiple of ``W``
(:func:`~repro_torch.kernels.tdp_pointwise.aosoa_operands`); the kernels
read those blocks, one thread per site, and write SoA outputs, as the
reference's do.  ``fused`` keeps its tile: the same shared-memory φ array,
filled from the AoSoA planes, so ``plane_block`` and
:func:`tile_smem_bytes` keep their meaning.  :data:`aosoa_launches`
counts those launches.

Ensembles (a fleet's stage): every member in one launch of
``tdp_windowed_ensemble_launch``, the member on ``blockIdx.y``, ``fused`` in
the same tiles, each member's physics from the table of
:func:`~repro_torch.kernels.tdp_pointwise.phys_table`
(:func:`~repro_torch.kernels.tdp_pointwise.ensemble_execute`; on CPU tensors
each member in turn through the plain version).
:data:`ensemble_launches` counts them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .lb_collision import DTYPES, check_cuda_tensors, cuda_vvl, phys_row
from .tdp_pointwise import (alloc_outputs, aosoa_execute, aosoa_plane_sites,
                            cuda_site, ensemble_execute, fields_plain,
                            lb_geometry, phys_args, pointer_arrays,
                            refuse_unported_bf16, stride_arrays)

#: kernel launches of this executor, by site function
launches = dict.fromkeys(_build.SITES, 0)
#: AoSoA kernel launches of this executor, by site function
aosoa_launches = dict.fromkeys(_build.SITES, 0)
#: ensemble kernel launches of this executor, by site function
ensemble_launches = dict.fromkeys(_build.SITES, 0)

#: x-planes of a ``fused`` tile when ``Target.tuning`` sets none: the
#: fastest at 128³ on the H100 (PERF.md §6), by 0.5 % over 4
DEFAULT_PLANE_BLOCK = 2
#: (y, z) sites of a ``fused`` tile (``TILE_Y``, ``TILE_Z`` of
#: ``csrc/lb_sites.cuh``)
TILE_YZ = (8, 32)


def plane_block(plan) -> int:
    """The ``plane_block`` of ``plan``'s target (a positive int)."""
    p = dict(plan.target.tuning).get("plane_block", DEFAULT_PLANE_BLOCK)
    if isinstance(p, bool) or not isinstance(p, int) or p <= 0:
        raise ValueError(f"plane_block must be a positive int, got {p!r}")
    return p


def tile_smem_bytes(plan) -> int:
    """Shared memory of one block of ``plan``'s kernel: the ``fused`` tile's
    φ over ``plane_block + 2`` x-planes by ``(8 + 2) × (32 + 2)`` sites,
    float32 whatever the fields' dtype (a bfloat16 launch stages its
    bfloat16 φ widened); 0 for the other site functions, which stage
    nothing."""
    if getattr(plan.kernel, "__cuda_site__", None) != "fused":
        return 0
    ty, tz = TILE_YZ
    return 4 * (plane_block(plan) + 2) * (ty + 2) * (tz + 2)


def windowed_plain(plan, fields, out=None):
    """Plain version on the kernel's own operands (the ``"cuda"``
    executor's :func:`~repro_torch.kernels.tdp_pointwise.fields_plain`)."""
    return fields_plain(plan, fields, out)


def _lib():
    fn = _build.load("tdp_windowed").tdp_windowed_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def windowed_execute(plan, fields, out=None):
    """Registry executor entry (``wants="halo_extended"``,
    ``takes_fields=True`` — see :mod:`repro_torch.core.registry`)."""
    if plan.shape is None or len(plan.shape) != 3:
        raise ValueError(
            f"executor 'cuda_windowed' needs a 3-D lattice; kernel "
            f"{plan.name!r} was launched with shape {plan.shape}")
    site = cuda_site(plan, fields[0].dtype)
    p = plane_block(plan)
    if fields[0].device.type == "cuda":
        refuse_unported_bf16(plan, site, fields)
    if plan.ensemble is not None:
        return ensemble_execute(plan, site, fields, out,
                                launch=_ensemble_launch)
    if plan.layout == "aosoa":
        return aosoa_execute(plan, site, fields, out, windowed=True,
                             launch=_aosoa_launch)
    vvl = cuda_vvl(plan.target.vvl)
    x0 = fields[0]
    if x0.device.type == "cpu":
        return windowed_plain(plan, fields, out)
    if x0.device.type != "cuda":
        raise ValueError(f"executor 'cuda_windowed' runs on CUDA or CPU "
                         f"tensors, got {x0.device}")
    geom = lb_geometry(plan, fields)
    n = geom[0] * geom[1] * geom[2]
    outs = alloc_outputs(plan, x0, n, out)
    check_cuda_tensors([x0, *outs], [tuple(x0.shape)] + [
        (c, n) for c in plan.out_ncomp], f"kernel {plan.name!r} (out)", DTYPES)
    in_arr, out_arr = pointer_arrays(fields, outs)
    row = phys_row(plan.consts, x0.dtype)
    with torch.cuda.device(x0.device):
        rc = _lib()(_build.SITE_ID[site], vvl, p, _build.dtype_id(x0.dtype),
                    in_arr, out_arr, *geom, row.ctypes.data,
                    _build.stream_handle(x0.device))
    _build.check(rc, f"tdp_windowed {site}")
    launches[site] += 1
    return outs


def _aosoa_lib():
    fn = _build.load("tdp_windowed").tdp_windowed_aosoa_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 7 + [ctypes.c_float] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _aosoa_launch(plan, site, ops, n, geom):
    """Launch the windowed AoSoA kernel of ``site``; SoA outputs."""
    x0 = ops[0]
    outs = alloc_outputs(plan, x0, n, None)
    in_arr, out_arr = pointer_arrays(ops, outs)
    with torch.cuda.device(x0.device):
        rc = _aosoa_lib()(_build.SITE_ID[site], plan.vvl, plane_block(plan),
                          in_arr, out_arr, *geom,
                          aosoa_plane_sites(plan, True),
                          *phys_args(plan.consts),
                          _build.stream_handle(x0.device))
    _build.check(rc, f"tdp_windowed AoSoA {site}")
    aosoa_launches[site] += 1
    return outs


def _ensemble_lib():
    fn = _build.load("tdp_windowed").tdp_windowed_ensemble_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def _ensemble_launch(plan, site, vvl, fields, outs, geom, table, stream):
    """One launch of the windowed ensemble kernel of ``site``."""
    in_arr, out_arr = pointer_arrays(fields, outs)
    in_s, out_s = stride_arrays(fields, outs)
    rc = _ensemble_lib()(_build.SITE_ID[site], vvl, plane_block(plan),
                         plan.ensemble.batch, in_arr, out_arr, in_s, out_s,
                         *geom, table.data_ptr(), stream)
    _build.check(rc, f"tdp_windowed ensemble {site}")
    ensemble_launches[site] += 1
