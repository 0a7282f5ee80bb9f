"""bfloat16 arithmetic of the plain site bodies, rounded where the reference's
is.

The reference runs a site body in the operand's dtype.  In bfloat16 its
arithmetic rounds at three kinds of points (``jax.make_jaxpr`` of
``repro.kernels.lb_collision.collision_site_kernel`` lists them), and the
port's plain bodies take them over through these helpers; in float32 each
helper is the plain operation it replaces, so float32 bodies compute what
they computed before:

* every elementwise op is computed in float32 and rounded to bfloat16 —
  PyTorch's own bfloat16 ops on the CPU and the card do that already;
* a Python scalar is *weak*: JAX rounds it to bfloat16 before the op
  (``0.04 * x`` multiplies by ``0.0400390625``), where PyTorch would
  multiply by the float32 ``0.04`` and round once (:func:`weak`);
* a sum (``jnp.sum``, a product's contraction) converts to float32,
  reduces and rounds once (:func:`sum0`, :func:`contract`).

A double goes to bfloat16 through float32, as ``ml_dtypes`` (the
reference's bfloat16) and PyTorch both round it (:func:`round_f64`).
"""
from __future__ import annotations

import numpy as np
import torch


def round_f64(x) -> np.ndarray:
    """``x`` (float64) rounded to bfloat16 as the reference rounds a double:
    to float32, then to bfloat16, each to nearest with ties to even (not in
    one step: 7935623376.008 rounds to 236·2²⁵, not 237·2²⁵).  Returned as
    float32, which holds every bfloat16 exactly."""
    x = torch.from_numpy(np.asarray(x, dtype=np.float64))
    return x.to(torch.bfloat16).float().numpy()


def weak(x, dtype):
    """A Python scalar as a site body in ``dtype`` takes it: in bfloat16
    rounded first (a weak-typed scalar), otherwise as it is."""
    if (dtype == torch.bfloat16 and isinstance(x, (int, float))
            and not isinstance(x, bool)):
        return float(round_f64(float(x)))
    return x


def sum0(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """``x.sum(0)``; in bfloat16 accumulated in float32 in ascending index
    order and rounded once, as the reference's ``jnp.sum`` (and the CUDA
    site functions) do."""
    if x.dtype != torch.bfloat16:
        return x.sum(0, keepdim=keepdim)
    acc = x[0].float()
    for i in range(1, x.shape[0]):
        acc = acc + x[i].float()
    acc = acc.to(x.dtype)
    return acc[None] if keepdim else acc


def contract(coef, x: torch.Tensor) -> torch.Tensor:
    """``out[i] = Σ_j coef[i, j] · x[j]`` for a host matrix ``coef`` (m, k)
    and ``x`` (k, n).  Used in bfloat16 only (float32 bodies keep their
    ``einsum``): each term in float32, summed in ascending ``j`` from the
    first term whose coefficient is not 0 (zero terms dropped, as the CUDA
    site functions drop them), rounded once; a row with no term is 0."""
    coef = np.asarray(coef, dtype=np.float32)
    xf = x.float()
    rows = []
    for i in range(coef.shape[0]):
        acc = None
        for j in np.flatnonzero(coef[i]):
            cj = float(coef[i, j])
            t = xf[j] if cj == 1.0 else (-xf[j] if cj == -1.0 else cj * xf[j])
            acc = t if acc is None else acc + t
        rows.append(torch.zeros_like(xf[0]) if acc is None else acc)
    return torch.stack(rows).to(x.dtype)
