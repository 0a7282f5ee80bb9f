"""Public wrappers for the kernels, Target-dispatched.

Every op takes a ``target=`` (a :class:`~repro_torch.core.Target` or an
executor name) and a ``device=``.  With no ``device=`` the op runs on
``cuda`` and raises ``RuntimeError`` when no card is present; it never
carries on quietly on the CPU.  The default target follows the device:

* ``lb_collision`` — ``"cuda"`` (the dedicated kernel ``csrc/lb_collision.cu``)
  on the card, ``"torch"`` (the plain oracle) on the CPU;
* ``lb_fused_step`` — ``"cuda_windowed"`` on the card, ``"torch"`` on the
  CPU;
* ``rmsnorm``, ``gated_act``, ``mamba_scan`` — ``"cuda"`` (the site-kernel
  executor running the LM site functions of ``csrc/lm_sites.cuh``) on the
  card, ``"torch"`` on the CPU, both through ``tdp.launch``;
* ``flash_attention`` — ``"cuda"`` (``csrc/flash_attention.cu``) on the card,
  ``"torch"`` (:func:`~repro_torch.kernels.ref.attention_ref`) on the CPU.

A CUDA target resolves ``vvl=None`` to 1 site per thread.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import Target, as_target
from repro_torch.core.api import _normalize_halo
from repro_torch.core.api import launch as _tdp_launch

from . import flash_attention as _fa
from . import lb_collision as _lb
from . import lm as _lm
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


def _lm_target(target, vvl, dev) -> Target:
    t = _op_target(target, vvl, "cuda" if dev.type == "cuda" else "torch")
    if t.executor not in ("torch", "cuda"):
        raise ValueError(f"the LM ops run under the 'torch' or 'cuda' "
                         f"executor, got {t.executor!r}")
    return t


def rmsnorm(x, weight, *, target=None, vvl=None, eps=1e-6, scale_offset=0.0,
            device=None):
    """RMSNorm of ``x: (tokens, d)`` with ``weight: (d,)`` through
    ``tdp.launch`` — site = token, features on the component axis
    (:func:`repro_torch.kernels.lm.rmsnorm_spec`); ``x`` goes in as the
    contiguous ``(d, tokens)`` SoA field and the result comes back as its
    ``(tokens, d)`` view.  ``scale_offset=1.0`` gives the Gemma convention
    ``x · rms · (1 + w)``.  The weight is a dynamic const: a tensor on the
    launch's device, never copied to the host."""
    dev = resolve_device(device)
    t = _lm_target(target, vvl, dev)
    x = torch.as_tensor(x, device=dev)
    weight = torch.as_tensor(weight, device=dev)
    spec = _lm.rmsnorm_spec(int(x.shape[-1]))
    out = _tdp_launch(spec, t, x.T.contiguous(),
                      consts={"weight": weight, "eps": float(eps),
                              "scale_offset": float(scale_offset)})
    return out.T


def gated_act(u, v=None, *, kind="swiglu", target=None, vvl=None,
              device=None):
    """Gated activation ``act(u) · v`` (or plain ``act(u)`` when ``v`` is
    ``None``) through ``tdp.launch`` — site = flattened element
    (:func:`repro_torch.kernels.lm.gated_act_spec`)."""
    dev = resolve_device(device)
    t = _lm_target(target, vvl, dev)
    u = torch.as_tensor(u, device=dev)
    spec = _lm.gated_act_spec(str(kind), v is not None)
    args = (u.reshape(1, -1),)
    if v is not None:
        args += (torch.as_tensor(v, device=dev).reshape(1, -1),)
    return _tdp_launch(spec, t, *args).reshape(u.shape)


def mamba_scan(x, dt, b, c, a, d, *, target=None, vvl=None, device=None):
    """Selective state-space scan through ``tdp.launch`` — site = channel,
    time on the component axis (:func:`repro_torch.kernels.lm.mamba_scan_spec`),
    every batch row in one launch: ``x``/``dt``/``b``/``c`` go in as their
    ``(batch·L, ·)`` views, so contiguous operands are not copied.

    Shapes: ``x``/``dt`` ``(batch, L, d_inner)``, ``b``/``c``
    ``(batch, L, N)``, ``a`` ``(d_inner, N)``, ``d`` ``(d_inner,)``.
    Returns ``(y (batch, L, d_inner), h_final (batch, d_inner, N))``.  The
    ``"cuda"`` site function takes d_state 8 or 16 and raises
    ``ValueError`` for any other."""
    dev = resolve_device(device)
    t = _lm_target(target, vvl, dev)
    x, dt, b, c, a, d = (torch.as_tensor(v, device=dev)
                         for v in (x, dt, b, c, a, d))
    batch, length, d_inner = (int(s) for s in x.shape)
    nstate = int(a.shape[-1])
    spec = _lm.mamba_scan_spec(length, nstate, batch)
    rows = batch * length
    y, h = _tdp_launch(spec, t, x.reshape(rows, d_inner).contiguous(),
                       dt.reshape(rows, d_inner).contiguous(),
                       a.T.contiguous(), d.reshape(1, d_inner).contiguous(),
                       consts={"b": b.reshape(rows, nstate).contiguous(),
                               "c": c.reshape(rows, nstate).contiguous()})
    # h contiguous as (batch, d_inner, N): decode's elementwise updates keep
    # their operand's layout, so a transposed view would slow every step
    return (y.reshape(batch, length, d_inner),
            h.reshape(batch, nstate, d_inner).transpose(1, 2).contiguous())


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, target=None, device=None, impl="ref",
                    q_offset=0):
    """Attention of ``q (B, Hq, Sq, Dh)`` over ``k, v (B, Hkv, Sk, Dh)``:
    the CUDA kernel under ``"cuda"``, the whole-score oracle under
    ``"torch"``.  The reference's memory-bounded ``impl="chunked"`` oracle
    and ``q_offset`` serve its sequence-parallel attention, which is not
    ported (ROADMAP, queue A, LM stack: sequence-sharded attention)."""
    if impl != "ref" or q_offset:
        raise NotImplementedError(
            "flash_attention: impl='chunked' and q_offset serve sequence-"
            "parallel attention, which is not ported yet (ROADMAP, queue A, "
            "LM stack: sequence-sharded attention)")
    dev = resolve_device(device)
    t = _op_target(target, None, "cuda" if dev.type == "cuda" else "torch")
    q, k, v = (torch.as_tensor(x, device=dev) for x in (q, k, v))
    _fa.check_shapes(q, k, v)
    if t.executor == "torch":
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    if t.executor == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    raise ValueError(f"flash_attention runs under the 'torch' or 'cuda' "
                     f"executor, got {t.executor!r}")
