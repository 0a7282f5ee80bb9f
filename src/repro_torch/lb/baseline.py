"""The paper's "original code" baseline: AoS layout, model-dictated extents.

Before targetDP, Ludwig's collision loops had innermost extents of 19 (the
discrete momenta) or 3 (spatial dimensions) — extents the compiler cannot
map onto vector hardware (Fig. 1's lower bars).  This module keeps that
structure in plain PyTorch: the lattice field is **AoS** ``(X, Y, Z, 19)``,
so every contraction runs over the *minor* axis of extent 19 or 3 and the
site axis is not the innermost dimension.

It is the port of ``repro/lb/baseline.py``, which the reference also
computes with plain array ops outside any Pallas kernel.  It agrees with
the targetDP path (the SoA ``collide``/``stream`` of
:mod:`repro_torch.lb.stencil` and the CUDA kernels) after a layout
transposition, and exists as the measurable baseline of the paper's Fig. 1.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lb_collision import CV, NVEL, WEIGHTS

from .params import LBParams


def collide_aos(f, g, phi, gradphi, del2phi, params: LBParams):
    """AoS collision: f, g ``(..., 19)``; gradphi ``(..., 3)``; phi,
    del2phi ``(...)``.  Returns ``(f', g')``, both ``(..., 19)``.

    Contractions deliberately run over the trailing 19-/3-extent axes —
    the structure the paper identifies as vector-hostile.
    """
    w = torch.as_tensor(WEIGHTS, dtype=f.dtype, device=f.device)   # (19,)
    c = torch.as_tensor(CV, dtype=f.dtype, device=f.device)        # (19, 3)
    A, B, kappa = params.A, params.B, params.kappa
    tau, tau_phi, gamma = params.tau, params.tau_phi, params.gamma

    mu = -A * phi + B * phi ** 3 - kappa * del2phi         # (...)
    force = mu[..., None] * gradphi                        # (..., 3)

    rho = f.sum(-1)                                        # (...)
    mom = torch.einsum("...q,qd->...d", f, c)              # (..., 3)
    u = (mom + 0.5 * force) / rho[..., None]               # (..., 3)

    cu = torch.einsum("...d,qd->...q", u, c)               # (..., 19)
    usq = (u * u).sum(-1)                                  # (...)
    feq = w * rho[..., None] * (1 + 3 * cu + 4.5 * cu ** 2
                                - 1.5 * usq[..., None])
    cf = torch.einsum("...d,qd->...q", force, c)           # (..., 19)
    uf = (u * force).sum(-1)                               # (...)
    fterm = (1 - 0.5 / tau) * w * (3 * (cf - uf[..., None]) + 9 * cu * cf)
    f_out = f - (f - feq) / tau + fterm

    gt = w * (3 * gamma * mu[..., None] + 3 * phi[..., None] * cu)
    g0 = phi - (gt.sum(-1) - gt[..., 0])
    geq = torch.cat([g0[..., None], gt[..., 1:]], dim=-1)
    g_out = g - (g - geq) / tau_phi
    return f_out, g_out


def stream_aos(dist: torch.Tensor) -> torch.Tensor:
    """Streaming for AoS ``(X, Y, Z, 19)``: population q moves by c_q."""
    shifted = [torch.roll(dist[..., q], shifts=tuple(int(x) for x in CV[q]),
                          dims=(0, 1, 2))
               for q in range(NVEL)]
    return torch.stack(shifted, dim=-1)
