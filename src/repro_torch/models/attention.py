"""Attention: GQA, sliding window, softcap, qk-norm, KV cache.  Port of
``repro/models/attention.py``, single device.

Two execution paths, one weight layout:

* **prefill** — :func:`full_attention` through ``ops.flash_attention``: the
  hand-written CUDA kernel under ``ctx.backend == "cuda"``, the plain oracle
  of ``ctx.attn_impl`` under ``"torch"``; causal, or not (whisper's
  encoder), and with ``kv_override`` cross-attention of the queries onto
  keys and values projected elsewhere (the encoder's frames: Sq ≠ Sk);
* **decode** — :func:`decode_attention`: single-token attention over the
  cache in plain PyTorch (as in the reference, no kernel), with the
  ring-buffer branch for window-sized caches of ``local`` layers and, with
  ``cross=True``, over a fixed cross-attention cache that is read, never
  written.

The reference's sequence-sharded and sequence-parallel branches wait for
their slice (ROADMAP A7.7).  Cache layout per layer: ``{"k": (B, Hkv,
S_max, Dh), "v": ...}``.  A decode step writes its key and value into the
cache tensors **in place** (the reference updates functionally): at full
width a copy of every layer's cache per step would move the whole cache
each token.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from . import layers
from .config import AttnConfig
from .context import ExecContext


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def _qk_normalize(p, q, k):
    """Per-head RMSNorm of q and k (gemma3): float32, eps 1e-6, the (1 + w)
    scale.  Plain PyTorch, as the reference computes it inline: routing it
    through ``ops.rmsnorm`` would change the eps."""
    def nrm(w, t):
        tf = t.float()
        inv = torch.rsqrt((tf * tf).mean(-1, keepdim=True) + 1e-6)
        return (tf * inv * (1.0 + w.float())).to(t.dtype)
    return nrm(p["q_norm"], q), nrm(p["k_norm"], k)


def project_qkv(p, x, a: AttnConfig, ctx: ExecContext, rope=None):
    """x: (B, S, D) → q (B,S,H,dh), k/v (B,S,Hkv,dh), qk-norm then rope
    applied."""
    q = _split_heads(x @ p["wq"], a.n_heads, a.head_dim)
    k = _split_heads(x @ p["wk"], a.n_kv_heads, a.head_dim)
    v = _split_heads(x @ p["wv"], a.n_kv_heads, a.head_dim)
    if a.qk_norm:
        q, k = _qk_normalize(p, q, k)
    if rope is not None:
        cos, sin = rope
        q = layers.apply_rope(q, cos, sin)
        k = layers.apply_rope(k, cos, sin)
    return q, k, v


def full_attention(p, x, a: AttnConfig, ctx: ExecContext, *, rope=None,
                   causal=True, window=0, kv_override=None):
    """Full-sequence attention (training, prefill, the encoder), causal or
    not.  ``kv_override``: ``(k, v)``, each (B, Sk, Hkv, dh), already
    projected (cross-attention): only ``q`` is projected from ``x``, with
    no qk-norm and no rope (whisper's cross-attention has neither).

    Returns (out (B,S,D), (k, v)) with k/v (B,Sk,Hkv,dh) so prefill can
    seed the cache."""
    if kv_override is None:
        q, k, v = project_qkv(p, x, a, ctx, rope=rope)
    else:
        q = _split_heads(x @ p["wq"], a.n_heads, a.head_dim)
        k, v = kv_override
    # (B, H, S, dh) views of the (B, S, H, dh) projections: the kernel takes
    # them by strides and writes o in q's layout, so neither side copies
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            softcap=a.softcap, scale=a.scale,
                            target=ctx.backend, device=x.device,
                            impl=ctx.attn_impl)
    b, s = x.shape[:2]
    out = o.transpose(1, 2).reshape(b, s, a.n_heads * a.head_dim)
    return out @ p["wo"], (k, v)


def _decode_scores_to_out(q, k, v, a: AttnConfig, length, window=0,
                          key_positions=None):
    """Single-token attention over a cache.

    q: (B, H, 1, dh); k/v: (B, Hkv, S, dh).  Masks positions >= length and,
    for sliding-window layers, positions <= length-1-window.
    ``key_positions``: per-slot global positions (ring buffers); default
    ``arange(S)``; negative positions = never-written slots.
    Returns (out (B,H,1,dh) *unnormalised*, denominator, local max).  The
    query heads of one kv head are grouped against it instead of
    repeating k and v."""
    b, h, _, dh = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    group = a.n_heads // a.n_kv_heads
    scale = a.scale if a.scale is not None else a.head_dim ** -0.5
    qg = q.float().reshape(b, hkv, group, dh)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) * scale
    if a.softcap > 0:
        s = a.softcap * torch.tanh(s / a.softcap)
    pos = (torch.arange(s_len, device=q.device) if key_positions is None
           else key_positions)
    mask = (pos < length) & (pos >= 0)
    if window > 0:
        mask = mask & (pos > length - 1 - window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)                                 # (B,Hkv,G,1)
    # guard fully-masked shards
    m_safe = torch.where(m <= -1e29, torch.zeros_like(m), m)
    pt = torch.where(mask, torch.exp(s - m_safe), torch.zeros_like(s))
    num = torch.einsum("bhgk,bhkd->bhgd", pt, v.float())
    den = pt.sum(-1, keepdim=True)
    return (num.reshape(b, h, 1, dh), den.reshape(b, h, 1, 1),
            m_safe.reshape(b, h, 1, 1))


def decode_attention(p, x, a: AttnConfig, ctx: ExecContext, cache, length, *,
                     rope=None, window=0, cross=False):
    """One-token attention step.

    x: (B, 1, D); cache: {"k","v"} (B, Hkv, S_max, dh), written in place at
    slot ``length`` (``length mod window`` for a window-sized ring cache);
    ``length``: the cache fill before this token, a Python int.  With
    ``cross``, the cache is a cross-attention one (the encoder's keys and
    values): only ``q`` is projected (no rope), and it attends over every
    slot of the cache, which is not written.  Returns (out, cache)."""
    b = x.shape[0]
    if cross:
        q = _split_heads(x @ p["wq"], a.n_heads, a.head_dim)
        num, den, _ = _decode_scores_to_out(q.transpose(1, 2), cache["k"],
                                            cache["v"], a, cache["k"].shape[2])
        out = num / torch.clamp_min(den, 1e-30)
        out = out.to(x.dtype).transpose(1, 2).reshape(b, 1, -1)
        return out @ p["wo"], cache
    q, k_new, v_new = project_qkv(p, x, a, ctx, rope=rope)
    k_new = k_new.transpose(1, 2)                                # (B,Hkv,1,dh)
    v_new = v_new.transpose(1, 2)
    w_cache = cache["k"].shape[2]
    ring = window > 0 and w_cache == window
    # ring buffers (local layers, window-sized cache): write at length mod
    # W; slot i then holds global position length - ((slot - i) mod W),
    # negative = never written.
    write_at = length % w_cache if ring else length
    if write_at >= w_cache:
        raise ValueError(f"decode at position {length} past the cache's "
                         f"{w_cache} slots; pad the cache first")
    cache["k"][:, :, write_at] = k_new[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, write_at] = v_new[:, :, 0].to(cache["v"].dtype)
    key_positions = None
    if ring:
        idx = torch.arange(w_cache, device=x.device)
        key_positions = length - torch.remainder(write_at - idx, w_cache)

    qt = q.transpose(1, 2)                                       # (B,H,1,dh)
    num, den, _ = _decode_scores_to_out(qt, cache["k"], cache["v"], a,
                                        length + 1, window,
                                        key_positions=key_positions)
    out = num / torch.clamp_min(den, 1e-30)
    out = out.to(x.dtype).transpose(1, 2).reshape(b, 1, -1)
    return out @ p["wo"], cache
