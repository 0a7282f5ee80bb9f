"""Common layers: norms, rotary embeddings, MLPs, embedding and logits.

Site-wise ops (norms, activations) route through the kernel layer
(:mod:`repro_torch.kernels.ops`), single source and executor-switched by the
:class:`~repro_torch.models.context.ExecContext`.  Matrix products stay as
``torch.matmul``, as the reference leaves them to XLA.  Port of
``repro/models/layers.py`` (standard RoPE only: M-RoPE waits for its slice),
with the training loss :func:`cross_entropy`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .config import ModelConfig
from .context import ExecContext


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(w, x, ctx: ExecContext, *, scale_offset: float = 1.0):
    """RMSNorm with the (1 + w) convention (w init = 0)."""
    shp = x.shape
    y = ops.rmsnorm(x.reshape(-1, shp[-1]), w, target=ctx.backend,
                    vvl=ctx.vvl, scale_offset=scale_offset, device=x.device)
    return y.reshape(shp)


def norm(w, x, cfg: ModelConfig, ctx: ExecContext):
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"norm {cfg.norm!r} (whisper's layernorm) is not ported yet "
            f"(ROADMAP, queue A, LM stack)")
    return rmsnorm(w, x, ctx)


# ---------------------------------------------------------------------------
# rotary position embeddings (standard)
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections=None):
    """cos/sin tables for ``positions: (B, S)`` integers, each ``(B, S,
    head_dim // 2)`` in float32."""
    if mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) is not ported yet (ROADMAP, queue A, LM stack)")
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=positions.device) / half))
    ang = positions.float()[..., None] * inv_freq                 # (B,S,half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate ``x: (B, S, H, head_dim)`` (split-halves / NeoX convention)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x1.dtype)
    s = sin[:, :, None, :].to(x1.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(p, x, cfg: ModelConfig, ctx: ExecContext):
    """Dense MLP: gated (swiglu/geglu) or plain (relu2/gelu)."""
    shp = x.shape
    x2 = x.reshape(-1, shp[-1])
    up = x2 @ p["w_up"]
    if "w_gate" in p:
        gate = x2 @ p["w_gate"]
        h = ops.gated_act(gate, up, kind=cfg.act, target=ctx.backend,
                          vvl=ctx.vvl, device=x.device)
    else:
        h = ops.gated_act(up, None, kind=cfg.act, target=ctx.backend,
                          vvl=ctx.vvl, device=x.device)
    return (h @ p["w_down"]).reshape(shp)


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: ModelConfig):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def logits_from_hidden(params, x, cfg: ModelConfig):
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    logits = x.float() @ head.float()
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    # mask vocab padding
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in float32; ``labels`` integer ids below
    the vocabulary size; ``mask`` (optional) 1 = count."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
