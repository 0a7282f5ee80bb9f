"""targetDP memory model: host vs target copies, masked transfers, constants.

Paper §III-A/B: *"We maintain both host and target copies of our lattice
data, where the target copy is located in a memory space suitable for access
on the target, and is treated as the master copy within those lattice-based
computations."*  The distinction is kept even when the target is the host
CPU: a target copy on the CPU is a tensor of its own, never a view of the
host array.

Mapping of the paper's library surface:

=========================  ====================================================
paper                      this module
=========================  ====================================================
``targetMalloc``           :func:`target_malloc` (zeros on the device)
``targetFree``             :func:`target_free` (``Tensor.set_()``: the block
                           goes back to PyTorch's allocator; the functions
                           here raise ``RuntimeError`` on the freed target)
``copyToTarget``           :func:`copy_to_target`
``copyFromTarget``         :func:`copy_from_target`
``copyToTargetMasked``     :func:`copy_to_target_masked`   (pack on the host →
``copyFromTargetMasked``   :func:`copy_from_target_masked`  move the packed
                           buffer → scatter on the device, and the reverse:
                           the compress/unpack scheme of the paper's CUDA
                           implementation)
``TARGET_CONST`` +         :class:`TargetConst` — small read-only parameters
``copyConstant<X>ToTarget``  (:func:`copy_constant_to_target`);
                           :class:`BatchedConst` — one row per fleet member
``syncTarget``             :func:`sync_target` (``torch.cuda.synchronize``)
=========================  ====================================================

Every function that allocates takes ``device=``: ``None`` means the card,
and raises ``RuntimeError`` when there is none (``device="cpu"`` is the
caller's explicit choice).  The pack and scatter of the masked copies are
plain PyTorch ops (``index_select``, ``index_copy_``), as the reference does
them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .field import Field

#: The attribute :func:`target_free` marks a released target with.
_FREED = "_tdp_freed"


def _device(device) -> torch.device:
    from repro_torch.kernels.ops import resolve_device   # kernels imports core
    return resolve_device(device)


def _torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _check_live(t: torch.Tensor, what: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} expects a target tensor, got "
                        f"{type(t).__name__}")
    if getattr(t, _FREED, False):
        raise RuntimeError(f"{what}: the target was released by target_free")


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------

def target_malloc(shape: tuple[int, ...], dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Allocate a zeroed target tensor (``targetMalloc``)."""
    if any(int(s) <= 0 for s in shape):
        raise ValueError(f"non-positive extent in {tuple(shape)}")
    return torch.zeros(tuple(int(s) for s in shape), dtype=_torch_dtype(dtype),
                       device=_device(device))


def target_malloc_like(f: Field, device=None, dtype=None) -> torch.Tensor:
    """A zeroed target for host field ``f`` (its shape; its dtype unless
    ``dtype`` is given)."""
    return target_malloc(f.array_shape, f.dtype if dtype is None else dtype,
                         device)


def target_free(t: torch.Tensor) -> None:
    """Release target memory now (``targetFree``).

    ``t.set_()`` leaves ``t`` an empty ``(0,)`` tensor with no storage, so
    the block returns to PyTorch's caching allocator as soon as no other
    view holds it.  The functions of this module raise ``RuntimeError`` on
    the freed target; a raw torch op sees an empty tensor (the reference's
    ``jax.Array.delete`` makes every later use raise)."""
    _check_live(t, "target_free")
    t.set_()
    setattr(t, _FREED, True)


# ---------------------------------------------------------------------------
# full-lattice transfers
# ---------------------------------------------------------------------------

def copy_to_target(host: Field | np.ndarray, device=None,
                   dtype=None) -> torch.Tensor:
    """Host → target transfer of a full field (``copyToTarget``).

    The target's dtype is ``dtype`` if given, else the host data's (a
    :class:`Field` defaults to float64, which the CUDA kernels refuse by
    name: no silent cast)."""
    data = host.data if isinstance(host, Field) else np.asarray(host)
    dtype = data.dtype if dtype is None else dtype
    return torch.tensor(data, dtype=_torch_dtype(dtype),
                        device=_device(device))


def copy_from_target(target: torch.Tensor,
                     host: Field | None = None) -> Field | np.ndarray:
    """Target → host transfer (``copyFromTarget``).

    If ``host`` is given, its buffer is overwritten in place (the paper's
    signature) and returned; otherwise a new ndarray is returned."""
    _check_live(target, "copy_from_target")
    out = target.detach().to("cpu", copy=True).numpy()
    if host is None:
        return out
    if out.shape != host.data.shape:
        raise ValueError(f"shape mismatch {out.shape} vs {host.data.shape}")
    host.data[...] = out.astype(host.dtype)
    return host


# ---------------------------------------------------------------------------
# masked (compressed) transfers — paper §III-B
# ---------------------------------------------------------------------------
#
# "It is often the case that only a subset of the lattice data is required in
#  such transfers. ... a CUDA kernel ... pack[s] the included sites into a
#  scratch structure on the GPU, transferring the packed structure with
#  cudaMemcpy, and unpacking on the host using a loop."
#
# The mask is boolean over sites and known on the host; the packed buffer is
# (..., nsel) with the site axis last (SoA).

def _site_indices(mask: np.ndarray) -> np.ndarray:
    """The flat site indices a host mask selects."""
    mask = np.asarray(mask)
    if mask.dtype != np.bool_:
        mask = mask.astype(bool)
    return np.flatnonzero(mask.reshape(-1))


def copy_from_target_masked(target: torch.Tensor, mask: np.ndarray,
                            host: Field | None = None) -> np.ndarray | Field:
    """Compressed target → host copy of the masked site subset.

    Pack on the device (``index_select`` over the site axis), move only the
    packed buffer, unpack into the host field.  Without ``host`` the packed
    ``(..., nsel)`` array is returned."""
    _check_live(target, "copy_from_target_masked")
    idx = _site_indices(mask)
    if idx.size == 0:
        if host is not None:
            return host
        return np.zeros(tuple(target.shape[:-1]) + (0,),
                        dtype=torch.empty(0, dtype=target.dtype).numpy().dtype)
    sel = torch.from_numpy(idx).to(target.device)
    packed = target.index_select(-1, sel).cpu().numpy()
    if host is None:
        return packed
    host.data[..., idx] = packed.astype(host.dtype)
    return host


def copy_to_target_masked(target: torch.Tensor, host: Field | np.ndarray,
                          mask: np.ndarray) -> torch.Tensor:
    """Compressed host → target copy of the masked site subset.

    Pack on the host, move the packed buffer, scatter on the device
    (``index_copy_``).  The scatter is in place, the paper's semantics: the
    target itself is updated and returned (the reference, whose arrays are
    immutable, returns a new array and leaves its argument alone)."""
    _check_live(target, "copy_to_target_masked")
    data = host.data if isinstance(host, Field) else np.asarray(host)
    idx = _site_indices(mask)
    if idx.size == 0:
        return target
    packed = torch.tensor(data[..., idx], dtype=target.dtype,
                          device=target.device)
    return target.index_copy_(target.ndim - 1,
                              torch.from_numpy(idx).to(target.device), packed)


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

class TargetConst:
    """A small read-only parameter living "close to the registers".

    The paper's CUDA implementation copies these to ``__constant__`` memory
    via ``cudaMemcpyToSymbol``.  Here the value is kept as a host numpy
    array: the plain executor turns it into a tensor on the launch's device,
    and the CUDA executors pass it to the kernels as an argument or check it
    against the tables compiled into them.

    ``TargetConst`` values hash by content so they participate in the launch
    plan cache key: re-binding an equal constant reuses the plan.
    """

    __slots__ = ("value", "_key")

    def __init__(self, value: Any):
        arr = np.asarray(value)
        self.value = arr
        self._key = (arr.shape, str(arr.dtype), arr.tobytes())

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, TargetConst) and self._key == other._key

    def __repr__(self):
        return f"TargetConst(shape={self.value.shape}, dtype={self.value.dtype})"


class BatchedConst(TargetConst):
    """A :class:`TargetConst` with a leading **ensemble axis**: row *i* is
    member *i*'s value of the constant (a parameter sweep — per-member
    mobility, viscosity, ...).

    A Program stage binding a ``BatchedConst`` runs only inside a fleet
    (:meth:`repro_torch.core.program.CompiledProgram.vmap`): each ensemble
    launch hands the executor every member's value, and the card's
    executors read member *i*'s row from a device table
    (:mod:`repro_torch.kernels.tdp_pointwise`), so one launch serves the
    whole sweep.  Content hashing is inherited: two sweeps with equal
    values are equal.
    """

    __slots__ = ()

    def __init__(self, value: Any):
        super().__init__(value)
        if self.value.ndim < 1:
            raise ValueError(
                f"BatchedConst needs a leading ensemble axis; got a 0-d "
                f"value (shape {self.value.shape}) — wrap a plain scalar in "
                f"TargetConst instead")

    @property
    def batch(self) -> int:
        """The ensemble extent (leading-axis length)."""
        return int(self.value.shape[0])

    def member_shape(self) -> tuple:
        return tuple(self.value.shape[1:])

    def __repr__(self):
        return (f"BatchedConst(batch={self.batch}, "
                f"member_shape={self.member_shape()}, "
                f"dtype={self.value.dtype})")


def copy_constant_to_target(value: Any) -> TargetConst:
    """Family stand-in for ``copyConstant<Double|Int|...>ToTarget``."""
    return TargetConst(value)


# ---------------------------------------------------------------------------
# synchronisation
# ---------------------------------------------------------------------------

def sync_target(*tensors: torch.Tensor) -> None:
    """``syncTarget``: wait for the card's outstanding work.

    With tensors, every CUDA device they lie on is synchronised (a CPU
    tensor needs nothing); with none, the current CUDA device, which raises
    ``RuntimeError`` when there is no card."""
    for t in tensors:
        _check_live(t, "sync_target")
    if not tensors:
        torch.cuda.synchronize(_device(None))
        return
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
