"""Blocked (flash) attention — the wrapper of ``csrc/flash_attention.cu``.

Port of the Pallas kernel ``repro/kernels/flash_attention.py:
flash_attention_pallas``: ``q (B, Hq, Sq, Dh)``, ``k, v (B, Hkv, Sk, Dh)`` →
``(B, Hq, Sq, Dh)``, with GQA (kv head = q head // (Hq / Hkv)), causal and
sliding-window masks, logit soft-capping before the mask, an arbitrary
softmax scale, float32 online-softmax state and zero output for a row with
no live key.  The kernel runs both products on the TF32 tensor cores, each
operand split into a TF32 high and low part (3xTF32, :data:`TF32_SPLIT`),
masks the ragged tail itself (the Pallas wrapper pads), and skips key
tiles that are wholly dead under the causal mask or the window.

The kernel takes each operand by its (batch, head, row) strides: any
layout whose rows are ``Dh`` contiguous values, 16-byte aligned — a
contiguous tensor, or the ``(B, S, H, Dh)`` projections of a model
transposed to ``(B, H, S, Dh)`` with no copy; the output takes ``q``'s
layout.  CUDA tensors launch the kernel (float32 or bfloat16 at a
head_dim in :data:`HEAD_DIMS`; q, k, v and the output of one dtype,
``lse`` float32) or raise ``ValueError`` on any other; CPU tensors run
the plain version :func:`repro_torch.kernels.ref.attention_ref`.  In bfloat16 the kernel
widens each value to float32 as it stages it and rounds the output once:
the scores, the probabilities and the softmax state stay float32, as the
reference's kernel keeps them.  :data:`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import attention_ref

#: head dims the kernel is instantiated for (80: zamba2's shared block;
#: 192: deepseek-v3's MLA, q·k over 128 + 64 dimensions, V padded to 192)
HEAD_DIMS = (16, 32, 64, 80, 128, 192, 256)

#: TF32 products the kernel runs per product of float32 operands (3xTF32;
#: one TF32 product misses the reference's bar of 2e-4).  Of bfloat16
#: operands, exact in TF32, Q·Kᵀ takes one and P·V two (P stays float32).
TF32_SPLIT = 3

#: kernel launches of the CUDA wrapper
launches = {"flash_attention": 0}


def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6
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


def row_strides(name, x, device, dtype=torch.float32) -> list[int]:
    """The (batch, head, row) strides of ``x`` in elements, as the kernel
    takes them; ``ValueError`` unless ``x`` is a ``dtype`` tensor (float32
    or bfloat16) on ``device`` with rows of contiguous elements, 16-byte
    aligned (a dimension of extent 1 has no stride to check and gets 0)."""
    strides = [x.stride(i) if x.shape[i] > 1 else 0 for i in range(3)]
    per16 = 16 // dtype.itemsize
    if (x.device != device or x.dtype != dtype
            or (x.shape[3] > 1 and x.stride(3) != 1)
            or any(s % per16 for s in strides) or x.data_ptr() % 16):
        raise ValueError(
            f"flash_attention: {name} must be a {dtype} tensor on {device} "
            f"whose rows are contiguous and 16-byte aligned (strides a "
            f"multiple of {per16} elements); got {x.dtype} on {x.device}, "
            f"strides {tuple(x.stride())}, data pointer {x.data_ptr()} mod "
            f"16 = {x.data_ptr() % 16}")
    return strides


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, return_lse=False):
    """Attention of ``q (B, Hq, Sq, Dh)`` over ``k, v (B, Hkv, Sk, Dh)``.

    ``window=0`` disables the sliding window, ``softcap=0`` the capping;
    ``scale=None`` is ``Dh ** -0.5``.  ``return_lse``: also each row's
    log-sum-exp of its live logits, ``(B, Hq, Sq)`` float32 (-1e30 for a
    row with no live key), which the backward pass recomputes the
    probabilities from; the kernel stores it as it finishes a row."""
    check_shapes(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale,
                             return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    b, hq, sq, dh = (int(s) for s in q.shape)
    hkv, sk = int(k.shape[1]), int(k.shape[2])
    dtype = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel is instantiated "
                         f"at head_dim in {HEAD_DIMS}, got {dh}")
    strides = [s for name, x in (("q", q), ("k", k), ("v", v))
               for s in row_strides(name, x, q.device, dtype)]
    o = torch.empty_like(q)            # q's layout (a dense permutation kept)
    strides += row_strides("o", o, q.device, dtype)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    scale = float(scale) if scale is not None else dh ** -0.5
    with torch.cuda.device(q.device):
        rc = _lib()(_build.dtype_id(dtype), q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(),
                    None if lse is None else lse.data_ptr(),
                    (ctypes.c_longlong * 12)(*strides), b, hq, hkv, sq, sk, dh,
                    scale, float(softcap), int(bool(causal)), int(window),
                    _build.stream_handle(q.device))
    _build.check(rc, "flash_attention")
    launches["flash_attention"] += 1
    return (o, lse) if return_lse else o
