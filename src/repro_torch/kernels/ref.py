"""Plain PyTorch oracles for the kernels.

The lattice-Boltzmann collision, RMSNorm, the gated activations,
attention and the Mamba selective scan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# LM pointwise
# ---------------------------------------------------------------------------

def rmsnorm_ref(x, weight, *, eps=1e-6, scale_offset=0.0):
    """RMSNorm of ``x (..., d)`` with ``weight (d,)``."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * inv * (weight.float() + scale_offset)).to(x.dtype)


def gated_act_ref(u, v=None, *, kind="swiglu"):
    """``act(u) · v`` (or ``act(u)``) for the kinds of
    :data:`repro_torch.kernels.lm.GATED_KINDS`."""
    uf = u.float()
    if kind in ("swiglu", "silu"):
        a = uf * torch.sigmoid(uf)
    elif kind in ("geglu", "gelu"):
        a = F.gelu(uf, approximate="tanh")
    elif kind == "relu2":
        r = torch.clamp_min(uf, 0.0)
        a = r * r
    else:
        raise ValueError(kind)
    out = a if v is None else a * v.float()
    return out.to(u.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
                  kv_len=None):
    """Oracle attention: q (B,Hq,Sq,Dh), k/v (B,Hkv,Sk,Dh).  The whole
    (Sq, Sk) score matrix per head; softcap before the mask; rows with no
    live key give zero."""
    b, hq, sq, dh = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else dh ** -0.5
    kv_len = sk if kv_len is None else kv_len

    kr = torch.repeat_interleave(k, group, dim=1)
    vr = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    # rows with no live keys: softmax of all -1e30 is uniform; zero them.
    alive = mask.any(-1)[None, None, :, None]
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr.float())
    return torch.where(alive, out, torch.zeros_like(out)).to(q.dtype)


# ---------------------------------------------------------------------------
# mamba selective scan
# ---------------------------------------------------------------------------

def mamba_scan_ref(x, dt, b, c, a, d):
    """Step-by-step oracle: ``x``/``dt`` ``(batch, L, d_inner)``, ``b``/``c``
    ``(batch, L, N)``, ``a`` ``(d_inner, N)``, ``d`` ``(d_inner,)``.  Returns
    ``(y (batch, L, d_inner), h_final (batch, d_inner, N))``; the state is
    float32."""
    batch, length, d_inner = x.shape
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b, c))
    h = torch.zeros(batch, d_inner, a.shape[-1], dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(length):
        decay = torch.exp(dtf[:, t, :, None] * a[None])   # (batch, d_inner, N)
        h = h * decay + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append((h * cf[:, t, None, :]).sum(-1) + d[None] * xf[:, t])
    return torch.stack(ys, 1).to(x.dtype), h
