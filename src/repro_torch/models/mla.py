"""Multi-head Latent Attention (DeepSeek-V2/V3).  Port of
``repro/models/mla.py``, single device.

Two paths over one weight set:

* **expanded** (training, prefill) — :func:`mla_full`: the latent is
  decompressed to per-head keys and values and the heads run through
  ``ops.flash_attention`` at the qk width nope + rope (192 at full width),
  V zero-padded to that width and the output sliced after, as in the
  reference: under ``ctx.backend == "cuda"`` kernel 4's Dh 192
  instantiation, under ``"torch"`` the plain oracle of ``ctx.attn_impl``;
* **absorbed** (decode) — :func:`mla_decode`: the cache holds only the
  ``kv_lora_rank`` latent and the shared rope key a token, and the
  up-projections are absorbed into the query and output sides::

      score(h) = (q_nope(h) W_uk(h)ᵀ) · c_kv + q_rope(h) · k_rope
      out(h)   = (softmax · c_kv) W_uv(h)

  in float32 plain PyTorch, as the reference computes it outside any
  Pallas kernel.  A decode step writes its latent and rope key into the
  cache tensors **in place** (the reference updates functionally).

The latent norms (:func:`_rms`: float32, eps 1e-6, the ``(1 + w)`` scale)
are plain PyTorch, as in the reference.  The reference's sequence-sharded
decode (``_mla_seq_sharded``, a flash-decoding combine over a mesh axis)
waits for sharded execution (ROADMAP A7.7).  Each stage is a function of
its own, so a profile can put a range around it
(``tools/profile_serve.py``'s ``mla_ms_by_part``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from . import layers
from .config import ModelConfig
from .context import ExecContext


def _rms(w, x):
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    return (xf * inv * (1.0 + w.float())).to(x.dtype)


def _project_q(p, x, cfg: ModelConfig):
    """x (B, S, D) → q_nope (B, S, H, nope), q_rope (B, S, H, rope), before
    the rotation."""
    m, h = cfg.mla, cfg.attn.n_heads
    b, s, _ = x.shape
    cq = _rms(p["q_norm"], x @ p["w_dq"])
    q = (cq @ p["w_uq"]).reshape(b, s, h, m.nope_head_dim + m.rope_head_dim)
    return q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]


def _latent_kv(p, x, cfg: ModelConfig, rope):
    """c_kv (B, S, R) and the rotated shared key k_rope (B, S, rope)."""
    c_kv = _rms(p["kv_norm"], x @ p["w_dkv"])
    k_rope = (x @ p["w_kr"])[:, :, None, :]                  # (B,S,1,rope)
    k_rope = layers.apply_rope(k_rope, *rope)[:, :, 0, :]
    return c_kv, k_rope


def _expand_kv(p, c_kv, k_rope, cfg: ModelConfig):
    """The per-head keys (B, S, H, nope + rope), the shared rope key
    broadcast to every head, and values (B, S, H, v) from the latent."""
    m, h = cfg.mla, cfg.attn.n_heads
    b, s, _ = c_kv.shape
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, m.nope_head_dim)
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, m.v_head_dim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.rope_head_dim)], dim=-1)
    return k, v


def _pad_v(v, width: int):
    """V zero-padded to the qk width, so one kernel signature serves q, k
    and v (the reference's pad)."""
    return F.pad(v, (0, width - v.shape[-1]))


def _attend(q, k, v, cfg: ModelConfig, ctx: ExecContext, *, causal, scale,
            device):
    """Attention of (B, S, H, Dh) projections through
    ``ops.flash_attention`` on their (B, H, S, Dh) views (rows of Dh
    contiguous floats: the kernel takes them by strides, no copy); the
    output (B, H, S, Dh) in q's layout."""
    return ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               softcap=cfg.attn.softcap, scale=scale,
                               target=ctx.backend, device=device,
                               impl=ctx.attn_impl)


def _scale(cfg: ModelConfig) -> float:
    m, a = cfg.mla, cfg.attn
    return a.scale if a.scale is not None else (
        m.nope_head_dim + m.rope_head_dim) ** -0.5


def mla_full(p, x, cfg: ModelConfig, ctx: ExecContext, *, rope,
             causal=True):
    """Expanded-path attention of x (B, S, D); returns (out (B, S, D),
    (c_kv (B, S, R), k_rope (B, S, rope))) for the cache."""
    m = cfg.mla
    b, s, _ = x.shape
    qk_dim = m.nope_head_dim + m.rope_head_dim

    q_nope, q_rope = _project_q(p, x, cfg)
    q_rope = layers.apply_rope(q_rope, *rope)
    q = torch.cat([q_nope, q_rope], dim=-1)                  # (B,S,H,192)
    c_kv, k_rope = _latent_kv(p, x, cfg, rope)
    k, v = _expand_kv(p, c_kv, k_rope, cfg)
    o = _attend(q, k, _pad_v(v, qk_dim), cfg, ctx, causal=causal,
                scale=_scale(cfg), device=x.device)
    o = o.transpose(1, 2)[..., :m.v_head_dim].reshape(b, s, -1)
    return o @ p["wo"], (c_kv, k_rope)


def _absorbed(p, q_nope, q_rope, c_kv, k_rope, cfg: ModelConfig,
              length: int):
    """One query token's attention over the latent cache's first
    ``length`` slots, the up-projections absorbed, in float32: q_nope,
    q_rope (B, H, ·), c_kv (B, S_max, R), k_rope (B, S_max, rope) →
    (B, H, v)."""
    m, h = cfg.mla, cfg.attn.n_heads
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, m.nope_head_dim)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope.float(), w_uk.float())
    s = (torch.einsum("bhr,bsr->bhs", q_abs, c_kv.float())
         + torch.einsum("bhd,bsd->bhs", q_rope.float(), k_rope.float())
         ) * _scale(cfg)
    pos = torch.arange(c_kv.shape[1], device=c_kv.device)
    s = torch.where(pos < length, s, torch.full_like(s, -1e30))
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", pr, c_kv.float())
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    return torch.einsum("bhr,rhd->bhd", o_lat, w_uv.float())


def mla_decode(p, x, cfg: ModelConfig, ctx: ExecContext, cache, length, *,
               rope):
    """Absorbed-path one-token step.  x: (B, 1, D); cache: ``{"c_kv": (B,
    S_max, R), "k_rope": (B, S_max, rope)}``, written in place at slot
    ``length`` (the fill before this token, a Python int).  Returns (out
    (B, 1, D), cache)."""
    b = x.shape[0]
    if length >= cache["c_kv"].shape[1]:
        raise ValueError(f"decode at position {length} past the cache's "
                         f"{cache['c_kv'].shape[1]} slots; pad the cache "
                         f"first")
    q_nope, q_rope = _project_q(p, x, cfg)                   # (B,1,H,·)
    q_rope = layers.apply_rope(q_rope, *rope)
    c_new, kr_new = _latent_kv(p, x, cfg, rope)              # (B,1,·)
    cache["c_kv"][:, length] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, length] = kr_new[:, 0].to(cache["k_rope"].dtype)
    o = _absorbed(p, q_nope[:, 0], q_rope[:, 0], cache["c_kv"],
                  cache["k_rope"], cfg, length + 1)
    o = o.reshape(b, 1, -1).to(x.dtype)
    return o @ p["wo"], cache
