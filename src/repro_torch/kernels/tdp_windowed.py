"""The ``"cuda_windowed"`` executor — the gather-free stencil executor.

Port of the Pallas executor ``repro/kernels/tdp_windowed.py:
windowed_execute``.  It declares ``wants="halo_extended"``, so the launch
prologue (:func:`repro_torch.core.api.halo_extend`) hands it each stencil
field **once**, as a halo-extended ``(ncomp, X+2r₀, Y+2r₁, Z+2r₂)`` grid,
and ``csrc/tdp_windowed.cu`` resolves every neighbour offset in the kernel:
the ``(noffsets, ncomp, n)`` stack of the gathered path never exists in
device memory.  One thread covers ``Target.vvl`` consecutive z-sites
(``None`` → 1; outside {1, 2, 4, 8} raises).

CUDA tensors launch the kernel or raise; CPU tensors run the plain version
(:func:`windowed_plain`: the same offsets read by slicing, then the plain
body).  :data:`launches` counts kernel launches per site function.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .lb_collision import check_cuda_tensors, cuda_vvl
from .tdp_pointwise import alloc_outputs, cuda_site, phys_args, pointer_arrays

#: kernel launches of this executor, by site function
launches = dict.fromkeys(_build.SITES, 0)


def windowed_plain(plan, extended, out=None):
    """Plain version: read each offset of each halo-extended field by
    slicing (:func:`repro_torch.core.api.gather_neighbors` with the stencil
    radius as ghost width), then run the plain body once over all sites."""
    from repro_torch.core.api import gather_neighbors, torch_executor

    prepared = tuple(
        x if s is None else gather_neighbors(x.reshape(x.shape[0], -1),
                                             plan.shape, s.radius_per_dim(), s)
        for x, s in zip(extended, plan.stencils))
    return torch_executor(plan, prepared, out)


def _lib():
    fn = _build.load("tdp_windowed").tdp_windowed_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def windowed_execute(plan, extended, out=None):
    """Registry executor entry (``wants="halo_extended"`` — see
    :mod:`repro_torch.core.registry`)."""
    if plan.shape is None or len(plan.shape) != 3:
        raise ValueError(
            f"executor 'cuda_windowed' needs a 3-D lattice; kernel "
            f"{plan.name!r} was launched with shape {plan.shape}")
    site = cuda_site(plan)
    vvl = cuda_vvl(plan.target.vvl)
    x0 = extended[0]
    if x0.device.type == "cpu":
        return windowed_plain(plan, extended, out)
    if x0.device.type != "cuda":
        raise ValueError(f"executor 'cuda_windowed' runs on CUDA or CPU "
                         f"tensors, got {x0.device}")
    X, Y, Z = plan.shape
    n = X * Y * Z
    shapes = []
    for c, s in plan._fields():
        if s is None:
            shapes.append((c, n))
        else:
            r = s.radius_per_dim()
            shapes.append((c, *(e + 2 * rd for e, rd in zip(plan.shape, r))))
    check_cuda_tensors(extended, shapes, f"kernel {plan.name!r}")
    outs = alloc_outputs(plan, x0, n, out)
    in_arr, out_arr = pointer_arrays(extended, outs)
    with torch.cuda.device(x0.device):
        rc = _lib()(_build.SITE_ID[site], vvl, in_arr, out_arr, X, Y, Z,
                    *phys_args(plan.consts), _build.stream_handle(x0.device))
    _build.check(rc, f"tdp_windowed {site}")
    launches[site] += 1
    return outs
