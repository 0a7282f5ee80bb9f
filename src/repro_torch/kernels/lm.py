"""LM site functions on the targetDP core — rmsnorm and gated activations.

Port of ``repro/kernels/lm.py``: the "site" is whatever axis the op is
independent over, so the same :class:`~repro_torch.core.KernelSpec` rides
every executor of the registry.

* **rmsnorm** — site = token.  The SoA field is ``(d, tokens)`` (the
  transpose of the usual ``(tokens, d)`` activation), so the per-token
  feature reduction runs over the *components* of one site; the weight is
  a dynamic tensor const (a per-call operand, never a host copy).
* **gated activations** — site = flattened element: ``(tokens, d_ff)``
  flattens to one 1-component field of ``tokens·d_ff`` sites.

Each plain body names its CUDA site function in ``__cuda_site__``
(``csrc/lm_sites.cuh``); the gated ones also name the activation in
``__cuda_act__``.  The mamba scan (``mamba_scan_spec``) is not ported yet
(ROADMAP, queue B, kernel 2a).

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
