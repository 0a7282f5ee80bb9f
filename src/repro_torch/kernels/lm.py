"""LM site functions on the targetDP core — rmsnorm, gated activations, mamba.

Port of ``repro/kernels/lm.py``: the "site" is whatever axis the op is
independent over, so the same :class:`~repro_torch.core.KernelSpec` rides
every executor of the registry.

* **rmsnorm** — site = token.  The SoA field is ``(d, tokens)`` (the
  transpose of the usual ``(tokens, d)`` activation), so the per-token
  feature reduction runs over the *components* of one site; the weight is
  a dynamic tensor const (a per-call operand, never a host copy).
* **gated activations** — site = flattened element: ``(tokens, d_ff)``
  flattens to one 1-component field of ``tokens·d_ff`` sites.
* **mamba selective scan** — site = channel (``d_inner``).  The scan is
  sequential in time but independent per channel, so time lives on the
  component axis (``(batch·L, channels)`` fields, the batch rows one after
  another) and the recurrence is a loop inside the body; ``B``/``C`` have
  no channel axis and are dynamic tensor consts.

Each plain body names its CUDA site function in ``__cuda_site__``
(``csrc/lm_sites.cuh``); the gated ones also name the activation in
``__cuda_act__``.

Specs are built per shape signature and cached, so the launch-plan cache
keys stay stable across calls.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core import FieldSpec, KernelSpec

#: gated_act kinds (same table as repro_torch.kernels.ref.gated_act_ref)
GATED_KINDS = ("swiglu", "silu", "geglu", "gelu", "relu2")
#: the activation each kind applies, by its name in csrc/lm_sites.cuh
ACT_OF_KIND = {"swiglu": "silu", "silu": "silu", "geglu": "gelu_tanh",
               "gelu": "gelu_tanh", "relu2": "relu2"}


@functools.lru_cache(maxsize=None)
def rmsnorm_spec(d: int) -> KernelSpec:
    """RMSNorm over ``(d, tokens)`` SoA: per-site (= per-token) feature
    reduction across the ``d`` components."""

    def rmsnorm_site(x, *, weight, eps, scale_offset):
        xf = x.float()                                    # (d, n)
        inv = torch.rsqrt((xf * xf).mean(0, keepdim=True) + eps)
        w = weight.float().reshape(d, 1) + scale_offset
        return (xf * inv * w).to(x.dtype)

    rmsnorm_site.__cuda_site__ = "rmsnorm"
    return KernelSpec(rmsnorm_site, fields=(FieldSpec(d, name="x"),),
                      out=(d,), consts=("weight", "eps", "scale_offset"),
                      name=f"rmsnorm_d{d}")


def _act(kind: str, uf):
    if kind in ("swiglu", "silu"):
        return uf * torch.sigmoid(uf)
    if kind in ("geglu", "gelu"):
        return F.gelu(uf, approximate="tanh")
    if kind == "relu2":
        r = torch.clamp_min(uf, 0.0)
        return r * r
    raise ValueError(kind)


@functools.lru_cache(maxsize=None)
def gated_act_spec(kind: str, gated: bool) -> KernelSpec:
    """Elementwise activation (optionally × a gate field) over flattened
    1-component sites."""
    if kind not in GATED_KINDS:
        raise ValueError(f"kind must be one of {GATED_KINDS}, got {kind!r}")

    if gated:
        def gated_site(u, v):
            return (_act(kind, u.float()) * v.float()).to(u.dtype)
        fields = (FieldSpec(1, name="u"), FieldSpec(1, name="v"))
        fn = gated_site
        fn.__cuda_site__ = "gated"
    else:
        def act_site(u):
            return _act(kind, u.float()).to(u.dtype)
        fields = (FieldSpec(1, name="u"),)
        fn = act_site
        fn.__cuda_site__ = "act"
    fn.__cuda_act__ = ACT_OF_KIND[kind]

    return KernelSpec(fn, fields=fields, out=(1,),
                      name=f"gated_{kind}{'' if gated else '_ungated'}")


@functools.lru_cache(maxsize=None)
def mamba_scan_spec(length: int, nstate: int, batch: int = 1) -> KernelSpec:
    """Selective state-space scan, site = channel, over ``batch`` rows.

    Fields ``x``/``dt`` ``(batch·L, n)`` (row r's steps at ``r·L``),
    ``a`` ``(N, n)``, ``d`` ``(1, n)``; ``b``/``c`` are ``(batch·L, N)``
    dynamic tensor consts.  Outputs ``y (batch·L, n)`` and the final states
    ``h (batch·N, n)``.  The plain body is a loop over rows and time in the
    reference's arithmetic order: ``h = h·exp(dt·a) + (dt·x)·b``,
    ``y = Σ_k h·c + d·x``.  The body's ``__cuda_batch__`` tells the CUDA
    site function how many rows one launch covers."""

    def mamba_site(x, dt, a, d, *, b, c):
        xf, dtf, af, df = (t.float() for t in (x, dt, a, d))
        bf, cf = b.float(), c.float()
        ys, hs = [], []
        for r in range(batch):
            h = torch.zeros(nstate, xf.shape[-1], dtype=torch.float32,
                            device=xf.device)
            for t in range(r * length, (r + 1) * length):
                decay = torch.exp(dtf[t][None, :] * af)             # (N, n)
                h = h * decay + (dtf[t] * xf[t])[None, :] * bf[t][:, None]
                ys.append((h * cf[t][:, None]).sum(0) + df[0] * xf[t])
            hs.append(h)
        return torch.stack(ys).to(x.dtype), torch.cat(hs)

    mamba_site.__cuda_site__ = "mamba"
    mamba_site.__cuda_batch__ = batch
    rows = batch * length
    return KernelSpec(
        mamba_site,
        fields=(FieldSpec(rows, name="x"), FieldSpec(rows, name="dt"),
                FieldSpec(nstate, name="a"), FieldSpec(1, name="d")),
        out=(rows, batch * nstate), consts=("b", "c"),
        name=f"mamba_scan_B{batch}_L{length}_n{nstate}")
