"""Blocked (flash) attention — the wrapper of ``csrc/flash_attention.cu``.

Port of the Pallas kernel ``repro/kernels/flash_attention.py:
flash_attention_pallas``: ``q (B, Hq, Sq, Dh)``, ``k, v (B, Hkv, Sk, Dh)`` →
``(B, Hq, Sq, Dh)``, with GQA (kv head = q head // (Hq / Hkv)), causal and
sliding-window masks, logit soft-capping before the mask, an arbitrary
softmax scale, float32 online-softmax state and zero output for a row with
no live key.  The kernel masks the ragged tail itself (the Pallas wrapper
pads), and skips key tiles that are wholly dead under the causal mask or the
window.

CUDA tensors launch the kernel (float32, head_dim in :data:`HEAD_DIMS`) or
raise; CPU tensors run the plain version
:func:`repro_torch.kernels.ref.attention_ref`.  :data:`launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import attention_ref

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)

#: kernel launches of the CUDA wrapper
launches = {"flash_attention": 0}


def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_shapes(q, k, v):
    """Raise unless q is (B, Hq, Sq, Dh) and k, v are (B, Hkv, Sk, Dh) with
    Hkv dividing Hq."""
    if q.ndim != 4:
        raise ValueError(f"flash_attention: q must be (B, Hq, Sq, Dh), got "
                         f"shape {tuple(q.shape)}")
    b, hq, sq, dh = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} needs k, v of "
                         f"shape (B, Hkv, Sk, Dh) = ({b}, Hkv, Sk, {dh}); got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if hq % k.shape[1] != 0:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq} % {k.shape[1]}")


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None):
    """Attention of ``q (B, Hq, Sq, Dh)`` over ``k, v (B, Hkv, Sk, Dh)``.

    ``window=0`` disables the sliding window, ``softcap=0`` the capping;
    ``scale=None`` is ``Dh ** -0.5``."""
    check_shapes(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    b, hq, sq, dh = (int(s) for s in q.shape)
    hkv, sk = int(k.shape[1]), int(k.shape[2])
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel is instantiated "
                         f"for head_dim in {HEAD_DIMS}, got {dh}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if (x.device != q.device or x.dtype != torch.float32
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(
                f"flash_attention: {name} must be a contiguous, 16-byte "
                f"aligned float32 tensor on {q.device}; got {x.dtype} on "
                f"{x.device}, contiguous={x.is_contiguous()}")
    o = torch.empty_like(q)
    scale = float(scale) if scale is not None else dh ** -0.5
    with torch.cuda.device(q.device):
        rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, hq, hkv, sq, sk, dh, scale, float(softcap),
                    int(bool(causal)), int(window),
                    _build.stream_handle(q.device))
    _build.check(rc, "flash_attention")
    launches["flash_attention"] += 1
    return o
