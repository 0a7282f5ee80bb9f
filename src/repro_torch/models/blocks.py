"""Block-level forward: one dispatch for prefill and decode.

Port of ``repro/models/blocks.py`` for every block type: ``attn`` (global
causal attention + MLP), ``local`` (sliding-window causal attention +
MLP), ``attn_dense`` (``attn`` with a dense MLP: the MoE models' leading
dense layers) and ``attn_moe`` (global attention + the MoE MLP of
:mod:`repro_torch.models.moe`, dispatched on ``ctx.moe_impl``),
``shared_attn`` (an ``attn`` block on the one weight-tied ``shared``
parameter set, zamba2), ``enc`` (whisper's encoder: non-causal
self-attention + MLP), ``xattn`` (whisper's decoder: causal
self-attention, then cross-attention onto the encoder's output, then the
MLP), and the ``mamba1`` and ``mamba2`` blocks (norm, Mamba mixer,
residual; no MLP).  Under ``cfg.mla`` (deepseek-v3) every attention block
runs Multi-head Latent Attention (:mod:`repro_torch.models.mla`) in place
of the standard attention, as the reference's ``_attn_for`` dispatches it.
The presence of ``cache`` selects decode over full-sequence mode.

Cache structure per block type: attention ``{"k", "v"}: (B, Hkv, S, dh)``;
MLA ``{"c_kv": (B, S, R), "k_rope": (B, S, rope_dim)}``; ``xattn``
``{"self": {"k", "v"}, "xk", "xv": (B, Hkv, n_frames, dh)}`` (the cross
keys and values, set by the prefill and only read by decode); ``mamba1``
``{"conv", "ssm"}``; ``mamba2`` ``{"conv", "conv_bc", "ssm"}``.
"""
from __future__ import annotations

from . import attention, layers, mla, moe, ssm
from .config import ModelConfig
from .context import ExecContext

#: the attention block types (``shared_attn`` runs as ``attn``)
ATTN_BLOCKS = ("attn", "local", "attn_dense", "attn_moe", "xattn", "enc")


def _mlp_for(btype, bp, x, cfg: ModelConfig, ctx: ExecContext):
    if btype == "attn_moe":
        if ctx.moe_impl == "a2a":
            return moe.moe_a2a(bp["mlp"], x, cfg, ctx)
        return moe.moe_mlp(bp["mlp"], x, cfg, ctx)
    return layers.mlp(bp["mlp"], x, cfg, ctx)


def _cross_attention(bp, x, cfg: ModelConfig, ctx: ExecContext, cache,
                     length, enc_out):
    """An ``xattn`` block's cross-attention sub-layer: ``norm_x``, then
    the queries onto the encoder's keys and values, added to ``x``.  In
    decode (``cache``) they are the cache's ``xk``/``xv``; otherwise they
    are projected from ``enc_out`` (B, F, D).  Returns (x, (xk, xv)) with
    the keys and values (B, F, Hkv, dh) in full-sequence mode, (x, None)
    in decode."""
    a = cfg.attn
    hx = layers.norm(bp["norm_x"], x, cfg, ctx)
    if cache is not None:
        out, _ = attention.decode_attention(
            bp["xattn"], hx, a, ctx, {"k": cache["xk"], "v": cache["xv"]},
            length, cross=True)
        return x + out, None
    if enc_out is None:
        raise ValueError(f"{cfg.name}: an xattn block needs the encoder's "
                         f"output (enc_out) outside decode")
    b, f = enc_out.shape[:2]
    k = (enc_out @ bp["xattn"]["wk"]).reshape(b, f, a.n_kv_heads, a.head_dim)
    v = (enc_out @ bp["xattn"]["wv"]).reshape(b, f, a.n_kv_heads, a.head_dim)
    out, _ = attention.full_attention(bp["xattn"], hx, a, ctx, causal=False,
                                      kv_override=(k, v))
    return x + out, (k, v)


def apply_block(btype: str, bp, x, *, cfg: ModelConfig, ctx: ExecContext,
                shared=None, rope=None, rope_local=None, cache=None,
                length=None, enc_out=None, collect_cache=True):
    """Apply one block; returns (x, cache) — for attention the new cache
    ``{"k", "v"}`` (B, Hkv, S, dh) (under MLA ``{"c_kv", "k_rope"}``; for
    ``xattn`` ``{"self": {"k", "v"}, "xk", "xv"}``) in full-sequence mode,
    the cache written in place in decode mode; for ``mamba1`` the new
    ``{"conv", "ssm"}`` state, for ``mamba2`` the new ``{"conv",
    "conv_bc", "ssm"}``.  A ``shared_attn`` block runs the ``attn`` path on
    ``shared`` (the tied block's parameters; its own ``bp`` is ``{}``).
    ``rope_local`` is the ``local`` layers' table where the arch gives them
    their own theta (gemma3).  ``enc_out`` (B, F, D): the encoder's output,
    which an ``xattn`` block attends to outside decode.
    ``collect_cache=False`` (training, the encoder) returns ``None`` for a
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
            f"unknown block type {btype!r}: the port runs "
            f"{ATTN_BLOCKS + ('shared_attn', 'mamba1', 'mamba2')}")
    a = cfg.attn
    window = a.window if btype == "local" else 0
    if btype == "local" and rope_local is not None:
        rope = rope_local
    causal = btype != "enc"
    self_cache = cache["self"] if btype == "xattn" and cache is not None \
        else cache

    h = layers.norm(bp["norm1"], x, cfg, ctx)
    if cfg.mla is not None:
        if cache is None:
            out, (c_kv, k_rope) = mla.mla_full(bp["attn"], h, cfg, ctx,
                                               rope=rope, causal=causal)
            new_cache = ({"c_kv": c_kv, "k_rope": k_rope}
                         if collect_cache else None)
        else:
            out, new_cache = mla.mla_decode(bp["attn"], h, cfg, ctx, cache,
                                            length, rope=rope)
    elif self_cache is None:
        out, (k, v) = attention.full_attention(
            bp["attn"], h, a, ctx, rope=rope, causal=causal, window=window)
        new_cache = ({"k": k.transpose(1, 2).contiguous(),
                      "v": v.transpose(1, 2).contiguous()}
                     if collect_cache else None)
    else:
        out, new_cache = attention.decode_attention(
            bp["attn"], h, a, ctx, self_cache, length, rope=rope,
            window=window)
    x = x + out

    if btype == "xattn":
        x, xkv = _cross_attention(bp, x, cfg, ctx, cache, length, enc_out)
        if cache is not None:
            new_cache = cache               # "self" written in place
        elif collect_cache:
            new_cache = {"self": new_cache,
                         "xk": xkv[0].transpose(1, 2).contiguous(),
                         "xv": xkv[1].transpose(1, 2).contiguous()}

    h = layers.norm(bp["norm2"], x, cfg, ctx)
    x = x + _mlp_for(btype, bp, h, cfg, ctx)
    return x, new_cache
