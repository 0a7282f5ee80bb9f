"""Public wrappers for the lattice-Boltzmann kernels, Target-dispatched.

Every op takes a ``target=`` (a :class:`~repro_torch.core.Target` or an
executor name) and a ``device=``.  With no ``device=`` the op runs on
``cuda`` and raises ``RuntimeError`` when no card is present; it never
carries on quietly on the CPU.  The default target follows the device:

* ``lb_collision`` — ``"cuda"`` (the dedicated kernel ``csrc/lb_collision.cu``)
  on the card, ``"torch"`` (the plain oracle) on the CPU;
* ``lb_fused_step`` — ``"cuda_windowed"`` on the card, ``"torch"`` on the
  CPU.

A CUDA target resolves ``vvl=None`` to 1 site per thread.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import Target, as_target
from repro_torch.core.api import _normalize_halo

from . import lb_collision as _lb
from . import ref as _ref


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device with no card present raises."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def _op_target(target, vvl, default: str) -> Target:
    return as_target(target if target is not None else default, vvl=vvl)


def lb_collision(f, g, phi, gradphi, del2phi, *, target=None, vvl=None,
                 device=None, **phys):
    """Binary collision over SoA arrays ``(ncomp, nsites)`` (tensors or
    numpy arrays, moved to ``device``).  Returns ``(f', g')``."""
    dev = resolve_device(device)
    t = _op_target(target, vvl, "cuda" if dev.type == "cuda" else "torch")
    args = [torch.as_tensor(x, device=dev)
            for x in (f, g, phi, gradphi, del2phi)]
    if t.executor == "torch":
        return _ref.lb_collision_ref(*args, **phys)
    if t.executor == "cuda":
        return _lb.lb_collision(*args, vvl=t.vvl, **phys)
    raise ValueError(f"lb_collision runs under the 'torch' or 'cuda' "
                     f"executor, got {t.executor!r}")


def lb_fused_step(f, g, *, grid_shape, halo=0, mode="one_launch",
                  target=None, vvl=None, device=None, **phys):
    """One fused stream→gradient→collide step over SoA arrays (19, nsites).

    ``f``/``g`` are *pre-stream* populations over ``grid_shape`` (extended
    by ``halo`` caller-filled ghost planes per dimension where non-zero;
    0 → fully periodic).  Returns the next pre-stream state over the
    interior.  ``mode`` is ``"one_launch"`` (one stencil launch over the
    radius-2 composed g-neighbourhood) or ``"two_launch"`` (a streamed-φ
    launch, then a radius-1 stream/collide launch).
    """
    from repro_torch.lb import programs as _lbp   # lazy: avoids kernels↔lb cycle

    dev = resolve_device(device)
    t = _op_target(target, vvl,
                   "cuda_windowed" if dev.type == "cuda" else "torch")
    f = torch.as_tensor(f, device=dev)
    g = torch.as_tensor(g, device=dev)
    shape = tuple(int(s) for s in grid_shape)
    h = _normalize_halo(halo, len(shape))
    prog = _lbp.fused_program(
        mode, _lbp.collision_consts(dtype=np.float32, **phys))
    ext = tuple(s + 2 * hh for s, hh in zip(shape, h))
    out = prog.execute(t, {"f": f.reshape(_lb.NVEL, *ext),
                           "g": g.reshape(_lb.NVEL, *ext)},
                       grid_shape=shape, halo=h)
    return (out["f"].reshape(_lb.NVEL, -1),
            out["g"].reshape(_lb.NVEL, -1))
