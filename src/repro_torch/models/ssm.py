"""State-space mixers: Mamba-1 (falcon-mamba) and Mamba-2 SSD (zamba2).

Port of ``repro/models/ssm.py``.  Mamba-1:

* **prefill** — under ``ctx.backend == "cuda"`` the selective scan runs as
  the gathered executor's ``mamba`` site function (:func:`ops.mamba_scan`,
  site = channel, the state in registers), as the reference's Pallas
  backends do; under ``"torch"`` it is :func:`_chunked_scan`, the
  reference's ``"xla"`` path: a loop over time chunks with a doubling scan
  inside each chunk, so nothing of size L·d_inner·N is ever live.
* **decode** — the O(1) recurrent state update per token, in plain PyTorch
  (no kernel, as in the reference).

Mamba-2 (:func:`mamba2_mixer`) is plain PyTorch on every backend, as the
reference's is plain ``jnp`` outside any Pallas kernel:

* **prefill / training** — the SSD chunked matmul form
  (:func:`_ssd_chunked`): the intra-chunk part as decay-masked Q×Q score
  products over all chunks at once (:func:`_ssd_intra`), the inter-chunk
  part as the chunk-boundary state recurrence (:func:`_ssd_inter`).  The
  heads are viewed as (B/C group, head of the group), so a group's B and
  C are not repeated over its heads (the reference repeats them): C·Bᵀ is
  formed once a group, and the backward pass sums over a group's heads
  in its products rather than by ``repeat_interleave``'s scatter-add;
* **decode** — the O(1) state update per token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .config import ModelConfig, ssm_dims
from .context import ExecContext


def _silu(x):
    """SiLU as the reference rounds it: ``jax.nn.silu`` of a bfloat16 array
    is ``x · (1 / (1 + exp(−x)))`` with every op rounded to bfloat16
    (``F.silu`` computes in float32 and rounds once, a bfloat16 step apart
    on about a third of the values).  float32 goes through ``F.silu``."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def _causal_conv(x, w, b, *, state=None):
    """Depthwise causal conv of kernel size k.  x: (B, L, C); w: (k, C);
    b: (C,).  With ``state`` (B, k-1, C) the conv continues from a
    decode/prefill boundary; returns (y, new_state), the state a copy (not
    a view that would keep the whole (B, k-1+L, C) buffer alive)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros(x.shape[0], k - 1, x.shape[-1])
    ext = torch.cat([state, x], dim=1)                 # (B, k-1+L, C)
    y = b
    for j in range(k):
        y = y + ext[:, j:j + x.shape[1], :] * w[j]
    new_state = ext[:, -(k - 1):, :].contiguous() if k > 1 else state
    return y, new_state


def _mamba1_inner(p, xm, cfg: ModelConfig, ctx: ExecContext, *,
                  conv_state=None, ssm_state=None, decode=False):
    """Shared pre/post machinery around the scan; xm: (B, L, di)."""
    s, _, dtr = ssm_dims(cfg)
    n = s.d_state
    xc, new_conv = _causal_conv(xm, p["conv_w"], p["conv_b"], state=conv_state)
    xc = _silu(xc)
    xdbl = xc @ p["w_x"]                               # (B, L, dtr + 2N)
    dt_r, bmat, cmat = torch.split(xdbl, [dtr, n, n], dim=-1)
    dt = F.softplus(dt_r @ p["w_dt"] + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())                 # (di, N)

    if decode:
        # one step: h' = h·exp(dt·A) + (dt·x)·B ; y = h'·C + D·x
        decay = torch.exp(dt[:, 0, :, None] * a[None])     # (B, di, N)
        h = (ssm_state * decay
             + (dt[:, 0] * xc[:, 0])[..., None] * bmat[:, 0][:, None, :])
        y = (h * cmat[:, 0][:, None, :]).sum(-1) + p["d_skip"] * xc[:, 0]
        return y[:, None, :].to(xm.dtype), new_conv, h

    if ctx.backend == "cuda":
        y, h_fin = ops.mamba_scan(xc, dt.to(xc.dtype), bmat, cmat, a,
                                  p["d_skip"].float(), target="cuda",
                                  vvl=ctx.vvl, device=xc.device,
                                  chunk=s.chunk)
    else:
        y, h_fin = _chunked_scan(xc, dt, bmat, cmat, a, p["d_skip"].float(),
                                 chunk=s.chunk)
    return y.to(xm.dtype), new_conv, h_fin


def _doubling_scan(da, u):
    """Inclusive scan of ``h_t = da_t·h_{t-1} + u_t`` along axis 1 from
    ``h = 0``, in log₂(Q) doubling steps: step ``off`` composes every
    element with the one ``off`` before it, ``(a1, b1) ∘ (a2, b2) =
    (a1·a2, b2 + a2·b1)``.  Returns (cumulative decay, h)."""
    q, off = da.shape[1], 1
    while off < q:
        u = torch.cat([u[:, :off], u[:, off:] + da[:, off:] * u[:, :-off]], 1)
        da = torch.cat([da[:, :off], da[:, off:] * da[:, :-off]], 1)
        off *= 2
    return da, u


def _chunked_scan(x, dt, bmat, cmat, a, d_skip, *, chunk):
    """Chunked scan; only chunk-boundary states persist between chunks.

    x, dt: (B, L, di); bmat/cmat: (B, L, N); a: (di, N).  Returns
    (y (B, L, di) float32, h_final (B, di, N))."""
    batch, length, di = x.shape
    n = a.shape[-1]
    q = min(chunk, length)
    l_pad = -(-length // q) * q

    def pad(t):
        return F.pad(t.float(), (0, 0, 0, l_pad - length))

    xs, dts, bs, cs = (pad(t) for t in (x, dt, bmat, cmat))
    h = torch.zeros(batch, di, n, dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, l_pad, q):
        xq, dtq = xs[:, c0:c0 + q], dts[:, c0:c0 + q]
        bq, cq = bs[:, c0:c0 + q], cs[:, c0:c0 + q]
        da = torch.exp(dtq[..., None] * a)                 # (B, Q, di, N)
        u = (dtq * xq)[..., None] * bq[:, :, None, :]      # (B, Q, di, N)
        da_c, h_c = _doubling_scan(da, u)
        h_all = da_c * h[:, None] + h_c
        ys.append((h_all * cq[:, :, None, :]).sum(-1) + d_skip * xq)
        h = h_all[:, -1].contiguous()
    return torch.cat(ys, 1)[:, :length], h


def mamba1_mixer(p, x, cfg: ModelConfig, ctx: ExecContext, *, cache=None,
                 length=None):
    """Full mixer.  x: (B, L, D); with ``cache`` (decode) L must be 1.

    cache: {"conv": (B, k-1, di), "ssm": (B, di, N)}.  Returns (out,
    new_cache); ``length`` is unused (the state has no sequence extent)."""
    xm = x @ p["w_xm"]
    z = x @ p["w_z"]
    if cache is not None:
        y, new_conv, h = _mamba1_inner(p, xm, cfg, ctx,
                                       conv_state=cache["conv"],
                                       ssm_state=cache["ssm"], decode=True)
    else:
        y, new_conv, h = _mamba1_inner(p, xm, cfg, ctx)
    out = (y * _silu(z)) @ p["w_out"]
    return out, {"conv": new_conv, "ssm": h}


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------

def _segsum(a):
    """Segment sums ``S[..., i, j] = sum_{k in (j, i]} a[..., k]``, -inf
    above the diagonal.  a: (..., Q) → (..., Q, Q).

    The reference's values, summed directly (a cumulative sum of the
    lower-triangular repeats of ``a``) rather than as differences of one
    cumulative sum, so no cancellation between two large prefix sums.  The
    mask comes before any exponential: above the diagonal the sum of the
    negative ``a`` runs backwards and is positive, and ``exp`` of it would
    overflow (NaN in the backward pass, even where masked after)."""
    q = a.shape[-1]
    ones = torch.ones(q, q, dtype=torch.bool, device=a.device)
    x = a[..., :, None].expand(*a.shape, q)           # x[..., i, j] = a[i]
    x = x.masked_fill(~ones.tril(-1), 0.0)
    return torch.cumsum(x, dim=-2).masked_fill(~ones.tril(0), float("-inf"))


def _ssd_intra(xdt, adt, bq, cq):
    """The diagonal blocks: each chunk's output from its own inputs.  The
    heads are split as (G groups, R heads a group): xdt (B, nc, Q, G, R,
    P) the ∆-weighted input, adt (B, nc, Q, G, R); bq/cq (B, nc, Q, G, N)
    are a group's, so C·Bᵀ is formed once a group and shared by its R
    heads.  Returns (B, nc, Q, G, R, P)."""
    l_mat = torch.exp(_segsum(adt.permute(0, 1, 3, 4, 2)))  # (B,nc,G,R,Q,Q)
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cq, bq)          # (B,nc,G,Q,Q)
    return torch.einsum("bcgrqk,bckgrp->bcqgrp", cb[:, :, :, None] * l_mat,
                        xdt)


def _ssd_inter(xdt, adt, bq, cq, state0):
    """The off-diagonal part: each chunk's state contribution (inputs
    decayed to the chunk's end), the states entering each chunk by the
    chunk-boundary recurrence from ``state0`` (B, G, R, P, N), and their
    outputs inside the chunk (shapes as :func:`_ssd_intra`).  Returns (y
    (B, nc, Q, G, R, P), final state)."""
    cum = torch.cumsum(adt, dim=2)                           # (B,nc,Q,G,R)
    total = cum[:, :, -1]                                    # (B,nc,G,R)
    decay_out = torch.exp(total[:, :, None] - cum)
    chunk_states = torch.einsum("bcqgn,bcqgrp->bcgrpn", bq,
                                xdt * decay_out[..., None])
    state, entering = state0, []
    for c in range(adt.shape[1]):
        entering.append(state)
        state = (state * torch.exp(total[:, c])[..., None, None]
                 + chunk_states[:, c])
    states_in = torch.stack(entering, dim=1)                 # (B,nc,G,R,P,N)
    y = torch.einsum("bcqgn,bcgrpn->bcqgrp", cq, states_in)
    return y * torch.exp(cum)[..., None], state


def _ssd_chunked(xh, dt, a_h, bm, cm, d_skip, *, chunk, init_state=None):
    """SSD forward.  xh: (B, L, H, P); dt: (B, L, H), after the softplus;
    a_h: (H,) negative; bm/cm: (B, L, G, N), group g serving heads g·R ..
    g·R + R - 1 (R = H/G, the reference's ``jnp.repeat``); d_skip (H, 1);
    ``init_state`` (B, H, P, N) or zeros.  Returns (y (B, L, H, P) float32,
    final_state (B, H, P, N) float32).

    The heads are viewed as (G, R), so B and C are never repeated over
    them.  L is padded to whole chunks of ``min(chunk, L)`` with zeros
    after the softplus: a padded step neither decays nor injects, so the
    final state is exact for any L."""
    batch, length, h, p_dim = xh.shape
    g, n = bm.shape[2], bm.shape[3]
    r = h // g
    q = min(chunk, length)
    l_pad = -(-length // q) * q
    nc = l_pad // q

    def padt(t):
        t = t.float()
        return F.pad(t, (0, 0) * (t.ndim - 2) + (0, l_pad - length))

    xq = padt(xh).reshape(batch, nc, q, g, r, p_dim)
    dtq = padt(dt).reshape(batch, nc, q, g, r)
    bq = padt(bm).reshape(batch, nc, q, g, n)
    cq = padt(cm).reshape(batch, nc, q, g, n)
    adt = dtq * a_h.reshape(g, r)                   # (B,nc,Q,G,R), negative
    xdt = xq * dtq[..., None]                       # ∆-weighted input
    state0 = (xq.new_zeros(batch, g, r, p_dim, n) if init_state is None
              else init_state.float().reshape(batch, g, r, p_dim, n))
    y_off, state = _ssd_inter(xdt, adt, bq, cq, state0)
    y = _ssd_intra(xdt, adt, bq, cq) + y_off
    y = y.reshape(batch, l_pad, h, p_dim)[:, :length]
    return y + d_skip * xh.float(), state.reshape(batch, h, p_dim, n)


def _mamba2_project(p, x):
    """The input projections: x-branch, gate, B‖C, dt input."""
    bc = torch.cat([x @ p["w_B"], x @ p["w_C"]], dim=-1)
    return x @ p["w_xm"], x @ p["w_z"], bc, x @ p["w_dtin"]


def _gated_rmsnorm(y, z, w, dtype):
    """RMSNorm of ``y·silu(z)`` in float32, eps 1e-6, scale ``(1 + w)``
    (plain PyTorch, as the reference's is plain ``jnp``)."""
    gated = y.float() * F.silu(z.float())
    inv = torch.rsqrt((gated * gated).mean(-1, keepdim=True) + 1e-6)
    return (gated * inv * (1.0 + w.float())).to(dtype)


def mamba2_mixer(p, x, cfg: ModelConfig, ctx: ExecContext, *, cache=None,
                 length=None):
    """Mamba-2 mixer.  x: (B, L, D); with ``cache`` (decode) L must be 1.

    cache: {"conv": (B, k-1, di), "conv_bc": (B, k-1, 2·G·N), "ssm": (B,
    H, P, N) float32}.  Returns (out, new_cache), the cache replaced as in
    Mamba-1's decode; ``length`` is unused."""
    s, di, _ = ssm_dims(cfg)
    n, g = s.d_state, s.n_groups
    heads = di // s.head_dim
    b, L, _ = x.shape

    xm, z, bc, dt_in = _mamba2_project(p, x)
    xc, new_conv = _causal_conv(xm, p["conv_w"], p["conv_b"],
                                state=None if cache is None else cache["conv"])
    bcc, new_conv_bc = _causal_conv(
        bc, p["conv_w_bc"], p["conv_b_bc"],
        state=None if cache is None else cache["conv_bc"])
    xc, bcc = _silu(xc), _silu(bcc)
    bmat = bcc[..., :g * n].reshape(b, L, g, n)
    cmat = bcc[..., g * n:].reshape(b, L, g, n)
    dt = F.softplus(dt_in.float() + p["dt_bias"].float())     # (B, L, H)
    a_h = -torch.exp(p["a_log"].float())                      # (H,)
    xh = xc.reshape(b, L, heads, s.head_dim)
    d_skip = p["d_skip"].float()[:, None]                     # (H, 1)

    if cache is not None:
        # one step: h' = h·exp(dt·A) + B ⊗ (dt·x) ; y = h'·C + D·x, the
        # heads viewed as (G, R) as in _ssd_chunked
        r = heads // g
        b1, c1 = bmat[:, 0].float(), cmat[:, 0].float()      # (B, G, N)
        dt1 = dt[:, 0].reshape(b, g, r)
        x1 = xh[:, 0].float().reshape(b, g, r, s.head_dim)
        decay = torch.exp(dt1 * a_h.reshape(g, r))[..., None, None]
        state = (cache["ssm"].reshape(b, g, r, s.head_dim, n) * decay
                 + torch.einsum("bgn,bgrp->bgrpn", b1, x1 * dt1[..., None]))
        y = (torch.einsum("bgrpn,bgn->bgrp", state, c1)
             + d_skip.reshape(g, r, 1) * x1)
        y = y.reshape(b, 1, di)
        state = state.reshape(b, heads, s.head_dim, n)
    else:
        y, state = _ssd_chunked(xh, dt, a_h, bmat, cmat, d_skip,
                                chunk=s.chunk)
        y = y.reshape(b, L, di)
    yn = _gated_rmsnorm(y, z, p["out_norm"], x.dtype)
    return yn @ p["w_out"], {"conv": new_conv, "conv_bc": new_conv_bc,
                             "ssm": state}
