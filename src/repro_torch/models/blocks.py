"""Block-level forward: one dispatch for prefill and decode.

Port of ``repro/models/blocks.py`` for the dense attention blocks, ``attn``
(global causal attention + MLP) and ``local`` (sliding-window causal
attention + MLP), and the ``mamba1`` block (norm, Mamba-1 mixer, residual;
no MLP).  The presence of ``cache`` selects decode over full-sequence mode.
Every other block type (MoE, MLA, Mamba-2, cross-attention, encoder,
shared) raises ``NotImplementedError`` until its slice (ROADMAP, queue A).
"""
from __future__ import annotations

from . import attention, layers, ssm
from .config import ModelConfig
from .context import ExecContext


def apply_block(btype: str, bp, x, *, cfg: ModelConfig, ctx: ExecContext,
                rope=None, rope_local=None, cache=None, length=None,
                collect_cache=True):
    """Apply one block; returns (x, cache) — for attention the new cache
    ``{"k", "v"}`` (B, Hkv, S, dh) in full-sequence mode, the cache written
    in place in decode mode; for ``mamba1`` the new ``{"conv", "ssm"}``
    state.  ``rope_local`` is the ``local`` layers' table where the arch
    gives them their own theta (gemma3).  ``collect_cache=False``
    (training) returns ``None`` for a full-sequence cache and builds
    none."""
    if btype == "mamba1":
        h = layers.norm(bp["norm1"], x, cfg, ctx)
        out, new_cache = ssm.mamba1_mixer(bp["mixer"], h, cfg, ctx,
                                          cache=cache, length=length)
        return x + out, (new_cache if collect_cache else None)
    if btype not in ("attn", "local") or cfg.mla is not None:
        raise NotImplementedError(
            f"block type {btype!r}{' with MLA' if cfg.mla else ''} is not "
            f"ported yet: only attn/local blocks with standard attention and "
            f"mamba1 blocks run (ROADMAP, queue A, LM stack)")
    a = cfg.attn
    window = a.window if btype == "local" else 0
    if btype == "local" and rope_local is not None:
        rope = rope_local

    h = layers.norm(bp["norm1"], x, cfg, ctx)
    if cache is None:
        out, (k, v) = attention.full_attention(
            bp["attn"], h, a, ctx, rope=rope, causal=True, window=window)
        new_cache = ({"k": k.transpose(1, 2).contiguous(),
                      "v": v.transpose(1, 2).contiguous()}
                     if collect_cache else None)
    else:
        out, new_cache = attention.decode_attention(
            bp["attn"], h, a, ctx, cache, length, rope=rope, window=window)
    x = x + out

    h = layers.norm(bp["norm2"], x, cfg, ctx)
    x = x + layers.mlp(bp["mlp"], h, cfg, ctx)
    return x, new_cache
