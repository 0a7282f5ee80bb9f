"""State-space mixer: Mamba-1 (falcon-mamba).

Port of the Mamba-1 half of ``repro/models/ssm.py``:

* **prefill** — under ``ctx.backend == "cuda"`` the selective scan runs as
  the gathered executor's ``mamba`` site function (:func:`ops.mamba_scan`,
  site = channel, the state in registers), as the reference's Pallas
  backends do; under ``"torch"`` it is :func:`_chunked_scan`, the
  reference's ``"xla"`` path: a loop over time chunks with a doubling scan
  inside each chunk, so nothing of size L·d_inner·N is ever live.
* **decode** — the O(1) recurrent state update per token, in plain PyTorch
  (no kernel, as in the reference).

Mamba-2 (SSD, zamba2) has no Pallas kernel and waits for its slice
(ROADMAP, queue A, LM stack).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .config import ModelConfig, ssm_dims
from .context import ExecContext


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
    xc = F.silu(xc)
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
    out = (y * F.silu(z)) @ p["w_out"]
    return out, {"conv": new_conv, "ssm": h}
