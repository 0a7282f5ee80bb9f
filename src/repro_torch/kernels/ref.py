"""Plain PyTorch oracles for the kernels.

Only the lattice-Boltzmann collision oracle is ported so far; the LM
oracles (attention, RMSNorm, Mamba scan) wait for their kernels (ROADMAP,
queue A).
"""
from __future__ import annotations

import torch

from .lb_collision import CV, WEIGHTS


def lb_collision_ref(f, g, phi, gradphi, del2phi, *,
                     A=0.0625, B=0.0625, kappa=0.04,
                     tau=1.0, tau_phi=1.0, gamma=1.0):
    """Oracle over full SoA tensors ``(ncomp, nsites)``; mirrors
    :func:`repro_torch.kernels.lb_collision.collision_site_kernel` — written
    independently but keeping the site kernel's association order
    (``cu * cu``, not ``cu ** 2``; ``φ·φ·φ``)."""
    dt, dev = f.dtype, f.device
    w = torch.as_tensor(WEIGHTS, dtype=dt, device=dev)[:, None]
    c = torch.as_tensor(CV, dtype=dt, device=dev)
    phi_ = phi[0]
    mu = -A * phi_ + B * phi_ * phi_ * phi_ - kappa * del2phi[0]
    force = mu[None, :] * gradphi

    rho = f.sum(0)
    u = (torch.einsum("qd,qv->dv", c, f) + 0.5 * force) / rho[None, :]
    cu = torch.einsum("qd,dv->qv", c, u)
    usq = (u * u).sum(0)
    feq = w * rho[None, :] * (1.0 + 3.0 * cu + 4.5 * cu * cu
                              - 1.5 * usq[None, :])
    cf = torch.einsum("qd,dv->qv", c, force)
    uf = (u * force).sum(0)
    fterm = (1.0 - 0.5 / tau) * w * (3.0 * (cf - uf[None, :])
                                     + 9.0 * cu * cf)
    f_out = f - (f - feq) / tau + fterm

    gt = w * (3.0 * gamma * mu[None, :] + 3.0 * phi_[None, :] * cu)
    g0 = phi_ - (gt.sum(0) - gt[0])
    geq = torch.cat([g0[None, :], gt[1:]], dim=0)
    g_out = g - (g - geq) / tau_phi
    return f_out, g_out
