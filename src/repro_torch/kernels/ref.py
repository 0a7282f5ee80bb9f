"""Plain PyTorch oracles for the kernels.

The lattice-Boltzmann collision, RMSNorm, the gated activations,
attention (whole-score, and the memory-bounded chunked version with its
flash-style recompute backward) and the Mamba selective scan.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import bf16 as _bf16
from .lb_collision import CV, WEIGHTS


def lb_collision_ref(f, g, phi, gradphi, del2phi, *,
                     A=0.0625, B=0.0625, kappa=0.04,
                     tau=1.0, tau_phi=1.0, gamma=1.0):
    """Oracle over full SoA tensors ``(ncomp, nsites)``; mirrors
    :func:`repro_torch.kernels.lb_collision.collision_site_kernel` — written
    independently but keeping the site kernel's association order
    (``cu * cu``, not ``cu ** 2``; ``φ·φ·φ``) and, in bfloat16, its
    rounding points (:mod:`repro_torch.kernels.bf16`: weak scalars, sums
    and the contractions with c in float32, rounded once)."""
    dt, dev = f.dtype, f.device
    k = functools.partial(_bf16.weak, dtype=dt)
    w = torch.as_tensor(WEIGHTS, dtype=dt, device=dev)[:, None]
    if dt == torch.bfloat16:
        cv = _bf16.round_f64(CV)

        def along_q(x):                    # Σ_q c_qd x_q → (3, n)
            return _bf16.contract(cv.T, x)

        def along_d(x):                    # Σ_d c_qd x_d → (19, n)
            return _bf16.contract(cv, x)
    else:
        c = torch.as_tensor(CV, dtype=dt, device=dev)

        def along_q(x):
            return torch.einsum("qd,qv->dv", c, x)

        def along_d(x):
            return torch.einsum("qd,dv->qv", c, x)
    phi_ = phi[0]
    mu = k(-A) * phi_ + k(B) * phi_ * phi_ * phi_ - k(kappa) * del2phi[0]
    force = mu[None, :] * gradphi

    rho = _bf16.sum0(f)
    u = (along_q(f) + 0.5 * force) / rho[None, :]
    cu = along_d(u)
    usq = _bf16.sum0(u * u)
    feq = w * rho[None, :] * (1.0 + 3.0 * cu + 4.5 * cu * cu
                              - 1.5 * usq[None, :])
    cf = along_d(force)
    uf = _bf16.sum0(u * force)
    fterm = k(1.0 - 0.5 / tau) * w * (3.0 * (cf - uf[None, :])
                                      + 9.0 * cu * cf)
    f_out = f - (f - feq) / k(tau) + fterm

    gt = w * (k(3.0 * gamma) * mu[None, :] + 3.0 * phi_[None, :] * cu)
    g0 = phi_ - (_bf16.sum0(gt) - gt[0])
    geq = torch.cat([g0[None, :], gt[1:]], dim=0)
    g_out = g - (g - geq) / k(tau_phi)
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
                  kv_len=None, return_lse=False):
    """Oracle attention: q (B,Hq,Sq,Dh), k/v (B,Hkv,Sk,Dh).  The whole
    (Sq, Sk) score matrix per head; softcap before the mask; rows with no
    live key give zero.  ``return_lse``: also the rows' log-sum-exp of the
    live logits, (B, Hq, Sq) float32, -1e30 for a row with no live key (the
    convention of :func:`_chunk_fwd`)."""
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
    out = torch.where(alive, out, torch.zeros_like(out)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(alive[..., 0], torch.logsumexp(s, -1),
                      torch.full_like(s[..., 0], -1e30))
    return out, lse


def _blk_scores(qblk, kr, i, bq, sk, *, causal, window, softcap, scale,
                q_offset=0):
    """(scores, mask) for one block of ``bq`` query rows, block ``i`` —
    shared by the forward and the recompute backward.  Scores float32,
    soft-capped, -1e30 where masked; ``q_offset`` shifts the query
    positions (global position of row 0)."""
    s = torch.einsum("bhqd,bhkd->bhqk", qblk.float(), kr.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset + i * bq + torch.arange(bq, device=qblk.device)
    k_pos = torch.arange(sk, device=qblk.device)
    mask = torch.ones((bq, sk), dtype=torch.bool, device=qblk.device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return torch.where(mask[None, None], s, torch.full_like(s, -1e30)), mask


def _pad_rows(x, npad):
    """Pad axis 2 (the query rows) of ``x`` with ``npad`` zero rows."""
    if not npad:
        return x
    pad = [0, 0] * (x.ndim - 3) + [0, npad]
    return F.pad(x, pad)


def _chunk_fwd(q, k, v, cfg):
    """Returns (out, lse); lse is the per-row log-sum-exp (B, Hq, Sq),
    -1e30 for a row with no live key.  ``cfg``: (causal, window, softcap,
    scale, block_q, q_offset)."""
    causal, window, softcap, scale, block_q, q_offset = cfg
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    bq = min(block_q, sq)
    npad = -(-sq // bq) * bq - sq
    qp = _pad_rows(q, npad)
    nblk = qp.shape[2] // bq
    kr = torch.repeat_interleave(k, group, dim=1).float()
    vr = torch.repeat_interleave(v, group, dim=1).float()
    outs, lses = [], []
    for i in range(nblk):
        qblk = qp[:, :, i * bq:(i + 1) * bq]
        s, mask = _blk_scores(qblk, kr, i, bq, sk, causal=causal,
                              window=window, softcap=softcap, scale=scale,
                              q_offset=q_offset)
        m = s.amax(-1, keepdim=True)
        m_safe = torch.where(m <= -1e29, torch.zeros_like(m), m)
        pt = torch.exp(s - m_safe)
        l = pt.sum(-1, keepdim=True)
        alive = mask.any(-1)[None, None, :, None]
        o = torch.einsum("bhqk,bhkd->bhqd", pt, vr) / torch.clamp_min(l, 1e-30)
        lse = torch.where(alive[..., 0], m_safe[..., 0] + torch.log(
            torch.clamp_min(l[..., 0], 1e-30)), torch.full_like(l[..., 0], -1e30))
        outs.append(torch.where(alive, o, torch.zeros_like(o)).to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, 2)[:, :, :sq], torch.cat(lses, 2)[:, :, :sq]


def _chunk_bwd(cfg, res, dout, as_plain=False):
    """Flash-style backward: recompute each query block's probabilities
    from the saved log-sum-exp instead of keeping the S² probabilities.
    ``res``: (q, k, v, out, lse).  Returns (dq, dk, dv).  As the
    reference computes it: the softmax jacobian's diagonal term D_i is
    Σ_d dout·out, and a grouped-query kv head's dk and dv sum its query
    heads' in float32.  ``as_plain`` rounds where the autograd of
    :func:`attention_ref` (the plain version) rounds, which matters in
    bfloat16: D_i is Σ_k p·dp over the row's probabilities in float32
    (bfloat16's rounding of ``out`` moves Σ_d dout·out by 2^-9 of
    |dout|·|out|, which dp − D cancels down to, and doubles dq's and dk's
    distance from the exact gradient), and each query head's dk and dv is
    rounded to k's dtype before the group's sum (``repeat_interleave``'s
    backward).  ``ops._FlashFn`` takes it."""
    causal, window, softcap, scale, block_q, q_offset = cfg
    q, k, v, out, lse = res
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    bq = min(block_q, sq)
    npad = -(-sq // bq) * bq - sq
    qp, outp, doutp = (_pad_rows(x, npad) for x in (q, out, dout))
    lsep = _pad_rows(lse, npad)
    nblk = qp.shape[2] // bq
    kr = torch.repeat_interleave(k, group, dim=1).float()
    vr = torch.repeat_interleave(v, group, dim=1).float()
    # D_i = Σ_d dout·out per row — the softmax-jacobian diagonal term
    dp_diag = None if as_plain else (doutp.float() * outp.float()).sum(-1)
    dkr = torch.zeros((b, hq, sk, dh), dtype=torch.float32, device=q.device)
    dvr = torch.zeros_like(dkr)
    dqs = []
    for i in range(nblk):
        rows = slice(i * bq, (i + 1) * bq)
        qblk = qp[:, :, rows]
        s, mask = _blk_scores(qblk, kr, i, bq, sk, causal=causal,
                              window=window, softcap=softcap, scale=scale,
                              q_offset=q_offset)
        live = mask[None, None]
        p = torch.exp(s - lsep[:, :, rows, None])       # normalised probs
        p = torch.where(live, p, torch.zeros_like(p))
        do = doutp[:, :, rows].float()
        dvr = dvr + torch.einsum("bhqk,bhqd->bhkd", p, do)
        dp = torch.einsum("bhqd,bhkd->bhqk", do, vr)
        diag = ((p * dp).sum(-1, keepdim=True) if as_plain
                else dp_diag[:, :, rows, None])
        ds = p * (dp - diag)                            # d(capped scores)
        if softcap > 0:
            # s here is post-cap; d(raw) = d(capped)·(1 - (s/c)²)
            ds = ds * (1.0 - torch.square(
                torch.where(live, s, torch.zeros_like(s)) / softcap))
        ds = torch.where(live, ds, torch.zeros_like(ds))
        dqs.append(torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale)
        dkr = dkr + torch.einsum("bhqk,bhqd->bhkd", ds, qblk.float()) * scale
    dq = torch.cat(dqs, 2)[:, :, :sq]
    # fold grouped-query heads back onto their kv head
    if as_plain:
        dkr, dvr = dkr.to(k.dtype), dvr.to(v.dtype)
    dk = dkr.reshape(b, hkv, group, sk, dh).sum(2)
    dv = dvr.reshape(b, hkv, group, sk, dh).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _ChunkedAttention(torch.autograd.Function):
    """:func:`_chunk_fwd` with :func:`_chunk_bwd` as its backward; saves
    q, k, v, the output and the log-sum-exp (``keep``).  A subclass with
    another forward that returns (out, lse) passes them to ``keep`` and
    inherits the backward (``ops._FlashFn``: kernel 4); its ``as_plain``
    is :func:`_chunk_bwd`'s."""

    as_plain = False

    @classmethod
    def keep(cls, ctx, q, k, v, cfg, out, lse):
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg, ctx.as_plain = cfg, cls.as_plain
        return out

    @staticmethod
    def forward(ctx, q, k, v, cfg):
        return _ChunkedAttention.keep(ctx, q, k, v, cfg,
                                      *_chunk_fwd(q, k, v, cfg))

    @staticmethod
    def backward(ctx, dout):
        return (*_chunk_bwd(ctx.cfg, ctx.saved_tensors, dout,
                            ctx.as_plain), None)


def attention_chunked_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                          scale=None, block_q=512, q_offset=0):
    """Memory-bounded oracle: the math of :func:`attention_ref`, with the
    query axis processed in ``block_q`` blocks (live score buffer (B, H,
    block_q, Sk), not (B, H, Sq, Sk)) and a backward that recomputes the
    block probabilities from a saved log-sum-exp (flash-attention
    backward) instead of saving them.  ``q_offset`` shifts the causal and
    window masks for callers whose block holds global positions [offset,
    offset + Sq)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    cfg = (bool(causal), int(window), float(softcap), float(scale),
           int(block_q), int(q_offset))
    return _ChunkedAttention.apply(q, k, v, cfg)


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
