"""Common layers: norms, rotary embeddings, MLPs, embedding and logits.

Site-wise ops (norms, activations) route through the kernel layer
(:mod:`repro_torch.kernels.ops`), single source and executor-switched by the
:class:`~repro_torch.models.context.ExecContext`.  Matrix products stay as
``torch.matmul``, as the reference leaves them to XLA.  Port of
``repro/models/layers.py`` (RMSNorm and LayerNorm, standard RoPE and
M-RoPE), with the training loss :func:`cross_entropy`.
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


def layernorm(w, x):
    """LayerNorm without a bias, with the (1 + w) scale, in float32 at eps
    1e-5 (plain PyTorch, as in the reference: no kernel computes it)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-5) * (1.0 + w.float())
    return y.to(x.dtype)


def norm(w, x, cfg: ModelConfig, ctx: ExecContext):
    if cfg.norm == "rmsnorm":
        return rmsnorm(w, x, ctx)
    return layernorm(w, x)


# ---------------------------------------------------------------------------
# rotary position embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections=None):
    """cos/sin tables, each ``(B, S, head_dim // 2)`` in float32.

    ``positions``: ``(B, S)`` integers, or ``(3, B, S)`` (t, h, w) for
    M-RoPE.  Under M-RoPE a ``(B, S)`` input stands for all three
    components, and frequency ``i`` reads the component of its section
    (``mrope_sections`` frequencies for t, then h, then w); without it a
    ``(3, B, S)`` input means its first component."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=positions.device) / half))
    if mrope_sections is None:
        if positions.dim() == 3:
            positions = positions[0]
        ang = positions.float()[..., None] * inv_freq             # (B,S,half)
    else:
        if positions.dim() != 3:
            positions = positions[None].expand(3, *positions.shape)
        sec_id = torch.repeat_interleave(
            torch.arange(3, device=positions.device),
            torch.tensor(mrope_sections, device=positions.device))
        pos_per_freq = positions.float()[sec_id]                  # (half,B,S)
        ang = torch.movedim(pos_per_freq, 0, -1) * inv_freq       # (B,S,half)
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
