"""The cost model's calibration kernels: a streaming add and an FMA chain.

Port of the two Pallas kernels nested in the reference's
``core/costmodel.py::_calibrate_interpret`` (``add_kernel`` and
``fma_kernel``), which calibrate a :class:`MachineProfile`'s memory rate
and float32 rate.  Each has its plain PyTorch version beside it:

* :func:`stream_add` — ``o = x + y`` (``csrc/calibrate.cu``,
  ``calibrate_stream_add``); the plain version is ``x + y``, so the two
  agree exactly;
* :func:`fma_chain` — ``k`` rungs of ``acc = acc·v + v`` from ``acc = v``
  (``calibrate_fma_chain``).  The kernel's ``fmaf`` rounds once per rung,
  the plain version (:func:`fma_chain_plain`) twice.  For ``v`` in
  ``[0.25, 0.75)`` the map contracts (∂acc'/∂acc = v < 1), so the two stay
  within a few ulps at any ``k``: they are held at ``rtol=1e-5``
  (:data:`FMA_RTOL`).

CUDA tensors launch the kernel or raise; CPU tensors run the plain version.
:data:`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches, by kernel
launches = {"add": 0, "fma": 0}

#: the FMA chain's bar against its plain version (one rounding per rung
#: against two, on a contracting map)
FMA_RTOL = 1e-5


def stream_add_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x + y


def fma_chain_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    acc = x
    for _ in range(int(k)):
        acc = acc * x + x
    return acc if k else x.clone()


def _check(tensors, what: str) -> None:
    x = tensors[0]
    for i, t in enumerate(tensors):
        if (t.device != x.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape != x.shape):
            raise ValueError(
                f"{what}: operand {i} must be a contiguous float32 tensor of "
                f"shape {tuple(x.shape)} on {x.device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, contiguous="
                f"{t.is_contiguous()}")


def _fn(name: str, argtypes):
    fn = getattr(_build.load("calibrate"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def stream_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` over contiguous float32 tensors of one shape."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return stream_add_plain(x, y)
    _check((x, y), "stream_add")
    if x.device.type != "cuda":
        raise ValueError(f"stream_add runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    o = torch.empty_like(x)
    fn = _fn("calibrate_stream_add", [ctypes.c_void_p] * 3
             + [ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), o.data_ptr(), x.numel(),
                _build.stream_handle(x.device))
    _build.check(rc, "stream_add")
    launches["add"] += 1
    return o


def fma_chain(x: torch.Tensor, k: int) -> torch.Tensor:
    """``k`` rungs of ``acc = acc·x + x`` from ``acc = x``, elementwise."""
    k = int(k)
    if not 0 <= k < 2 ** 31:
        raise ValueError(f"fma_chain needs 0 <= k < 2**31, got {k}")
    if x.device.type == "cpu":
        return fma_chain_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"fma_chain runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    _check((x,), "fma_chain")
    o = torch.empty_like(x)
    fn = _fn("calibrate_fma_chain", [ctypes.c_void_p] * 2
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), o.data_ptr(), x.numel(), k,
                _build.stream_handle(x.device))
    _build.check(rc, "fma_chain")
    launches["fma"] += 1
    return o
