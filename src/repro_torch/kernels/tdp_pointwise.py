"""The ``"cuda"`` executor — the gathered targetDP executor on Hopper.

Port of the Pallas executor ``repro/kernels/tdp_pointwise.py:_run_pallas``.
The launch prologue (:func:`repro_torch.core.api.gather_neighbors`, in
PyTorch as the reference's stays in XLA) hands it one ``(noffsets, ncomp,
n)`` neighbour stack per stencil field and one ``(ncomp, n)`` array per
pointwise field.  ``csrc/tdp_gathered.cu`` maps the site function over the
sites, one thread per strip of ``Target.vvl`` consecutive sites (``None``
→ 1; any value outside {1, 2, 4, 8} raises).

The site function is the one the spec's plain body names in its
``__cuda_site__`` attribute (``csrc/lb_sites.cuh`` holds them all); a spec
whose body has none raises ``NotImplementedError``.  CUDA tensors launch the
kernel or raise; CPU tensors run the plain body through the ``"torch"``
executor.  :data:`launches` counts kernel launches per site function.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .lb_collision import PHYS_DEFAULTS, check_cuda_tensors, check_d3q19_consts, cuda_vvl

#: kernel launches of this executor, by site function
launches = dict.fromkeys(_build.SITES, 0)

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


def cuda_site(plan) -> str:
    """The C site function behind ``plan``'s kernel, checked against the
    plan's field roles; ``NotImplementedError`` if the body has none."""
    site = getattr(plan.kernel, "__cuda_site__", None)
    if site is None:
        raise NotImplementedError(
            f"kernel {plan.name!r} has no CUDA site function (its body sets "
            f"no __cuda_site__); run it under Target('torch')")
    fields, out = SITE_FIELDS[site]
    got = tuple((c, None if s is None else s.name)
                for c, s in plan._fields())
    if got != fields or tuple(plan.out_ncomp) != out:
        raise ValueError(
            f"kernel {plan.name!r}: fields {got} -> {tuple(plan.out_ncomp)} "
            f"do not match the CUDA site function {site!r} "
            f"({fields} -> {out})")
    check_d3q19_consts(plan.consts, f"kernel {plan.name!r}")
    return site


def phys_args(consts) -> list[float]:
    """The six physics scalars, in the C entries' order."""
    return [float(consts.get(k, v)) for k, v in PHYS_DEFAULTS.items()]


def pointer_arrays(ins, outs):
    """``(const void* in[5], void* out[2])`` for a C entry."""
    in_arr = (ctypes.c_void_p * 5)(*[x.data_ptr() for x in ins])
    out_arr = (ctypes.c_void_p * 2)(*[o.data_ptr() for o in outs])
    return in_arr, out_arr


def alloc_outputs(plan, like, n, out):
    """Fresh ``(ncomp_o, n)`` outputs, or the caller's ``out`` buffers."""
    if out is not None:
        return tuple(out)
    return tuple(torch.empty((c, n), dtype=like.dtype, device=like.device)
                 for c in plan.out_ncomp)


def _lib():
    fn = _build.load("tdp_gathered").tdp_gathered_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def cuda_execute(plan, gathered, out=None):
    """Registry executor entry (see :mod:`repro_torch.core.registry`)."""
    from repro_torch.core.api import torch_executor

    site = cuda_site(plan)
    vvl = cuda_vvl(plan.target.vvl)
    x0 = gathered[0]
    if x0.device.type == "cpu":
        return torch_executor(plan, gathered, out)
    if x0.device.type != "cuda":
        raise ValueError(f"executor 'cuda' runs on CUDA or CPU tensors, got "
                         f"{x0.device}")
    n = int(x0.shape[-1])
    shapes = [(c, n) if s is None else (s.noffsets, c, n)
              for c, s in plan._fields()]
    check_cuda_tensors(gathered, shapes, f"kernel {plan.name!r}")
    outs = alloc_outputs(plan, x0, n, out)
    in_arr, out_arr = pointer_arrays(gathered, outs)
    with torch.cuda.device(x0.device):
        rc = _lib()(_build.SITE_ID[site], vvl, in_arr, out_arr, n,
                    *phys_args(plan.consts), _build.stream_handle(x0.device))
    _build.check(rc, f"tdp_gathered {site}")
    launches[site] += 1
    return outs
