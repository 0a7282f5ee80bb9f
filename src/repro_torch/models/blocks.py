"""Block-level forward: one dispatch for prefill and decode.

Port of ``repro/models/blocks.py`` for the attention blocks, ``attn``
(global causal attention + MLP), ``local`` (sliding-window causal
attention + MLP), ``attn_dense`` (``attn`` with a dense MLP: the MoE
models' leading dense layers) and ``attn_moe`` (global attention + the MoE
MLP of :mod:`repro_torch.models.moe`, dispatched on ``ctx.moe_impl``),
``shared_attn`` (an ``attn`` block on the one weight-tied ``shared``
parameter set, zamba2), and the ``mamba1`` and ``mamba2`` blocks (norm,
Mamba mixer, residual; no MLP).  Under ``cfg.mla`` (deepseek-v3) every
attention block runs Multi-head Latent Attention
(:mod:`repro_torch.models.mla`) in place of the standard attention, as the
reference's ``_attn_for`` dispatches it.  The presence of ``cache``
selects decode over full-sequence mode.  The other block types
(cross-attention, encoder) raise ``NotImplementedError`` until their slice
(ROADMAP, queue A).

Cache structure per block type: attention ``{"k", "v"}: (B, Hkv, S, dh)``;
MLA ``{"c_kv": (B, S, R), "k_rope": (B, S, rope_dim)}``; ``mamba1``
``{"conv", "ssm"}``; ``mamba2`` ``{"conv", "conv_bc", "ssm"}``.
"""
from __future__ import annotations

from . import attention, layers, mla, moe, ssm
from .config import ModelConfig
from .context import ExecContext

#: the attention block types the port runs
ATTN_BLOCKS = ("attn", "local", "attn_dense", "attn_moe")


def _mlp_for(btype, bp, x, cfg: ModelConfig, ctx: ExecContext):
    if btype == "attn_moe":
        if ctx.moe_impl == "a2a":
            return moe.moe_a2a(bp["mlp"], x, cfg, ctx)
        return moe.moe_mlp(bp["mlp"], x, cfg, ctx)
    return layers.mlp(bp["mlp"], x, cfg, ctx)


def apply_block(btype: str, bp, x, *, cfg: ModelConfig, ctx: ExecContext,
                shared=None, rope=None, rope_local=None, cache=None,
                length=None, collect_cache=True):
    """Apply one block; returns (x, cache) — for attention the new cache
    ``{"k", "v"}`` (B, Hkv, S, dh) (under MLA ``{"c_kv", "k_rope"}``) in
    full-sequence mode, the cache written in place in decode mode; for
    ``mamba1`` the new ``{"conv", "ssm"}`` state, for ``mamba2`` the new
    ``{"conv", "conv_bc", "ssm"}``.  A
    ``shared_attn`` block runs the ``attn`` path on ``shared`` (the tied
    block's parameters; its own ``bp`` is ``{}``).  ``rope_local`` is the
    ``local`` layers' table where the arch gives them their own theta
    (gemma3).  ``collect_cache=False`` (training) returns ``None`` for a
    full-sequence cache and builds none."""
    if btype == "shared_attn":
        bp, btype = shared, "attn"
    if btype in ("mamba1", "mamba2"):
        mixer = ssm.mamba1_mixer if btype == "mamba1" else ssm.mamba2_mixer
        h = layers.norm(bp["norm1"], x, cfg, ctx)
        out, new_cache = mixer(bp["mixer"], h, cfg, ctx, cache=cache,
                               length=length)
        return x + out, (new_cache if collect_cache else None)
    if btype not in ATTN_BLOCKS:
        raise NotImplementedError(
            f"block type {btype!r} is not ported yet: only "
            f"attn/local/attn_dense/attn_moe/shared_attn blocks and "
            f"mamba1/mamba2 blocks run (ROADMAP, queue A, LM stack)")
    a = cfg.attn
    window = a.window if btype == "local" else 0
    if btype == "local" and rope_local is not None:
        rope = rope_local

    h = layers.norm(bp["norm1"], x, cfg, ctx)
    if cfg.mla is not None:
        if cache is None:
            out, (c_kv, k_rope) = mla.mla_full(bp["attn"], h, cfg, ctx,
                                               rope=rope)
            new_cache = ({"c_kv": c_kv, "k_rope": k_rope}
                         if collect_cache else None)
        else:
            out, new_cache = mla.mla_decode(bp["attn"], h, cfg, ctx, cache,
                                            length, rope=rope)
    elif cache is None:
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
    x = x + _mlp_for(btype, bp, h, cfg, ctx)
    return x, new_cache
