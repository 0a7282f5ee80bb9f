"""Model-level forwards: the training loss, cache init, prefill, decode.

Port of ``repro/models/lm.py``.  Batch dict: ``tokens (B, S)`` integer,
optionally ``positions (B, S)`` (default ``arange``; the rope tables' or
the learned table's rows); under M-RoPE (qwen2-vl) optionally
``positions3 (3, B, S)`` (t, h, w), for the vision stub ``vision_embed
(B, P, D)`` with ``vision_slot (B, S)`` (-1 = text), and for an
encoder–decoder model (whisper) ``audio_embed (B, F, D)``, the stub
frontend's frames; for the loss ``labels (B, S)`` integer and optionally
``loss_mask (B, S)``.  The reference runs its layer program as
``lax.scan`` groups to keep its HLO small; PyTorch runs eagerly, so
:func:`_apply_stack` is a plain loop over the layers, each under
``torch.utils.checkpoint`` when ``ctx.remat == "block"`` (the reference's
``jax.checkpoint`` of a scan unit).  Every layer gets the tied
``params["shared_block"]`` (zamba2's ``shared_attn`` positions read it), so
the gradients of all its uses add into its one set of tensors.  The loss
adds DeepSeek's multi-token prediction where the config has it.  An
encoder–decoder model runs :func:`encode` first and hands its output to
every layer (to each checkpointed layer as an argument, so that its
gradient reaches the encoder).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import blocks, layers
from .config import ModelConfig, ssm_dims
from .context import ExecContext


def embed_inputs(params, batch, cfg: ModelConfig, ctx: ExecContext):
    """Token embeddings; with the vision stub, each slot ``vision_slot >=
    0`` takes patch ``vision_slot`` of ``vision_embed`` instead; with
    learned positions, plus the row of ``params["pos_embed"]`` at each
    token's position (``batch["positions"]``, default ``arange(S)``)."""
    tokens = batch["tokens"]
    x = layers.embed_tokens(params, tokens, cfg)
    if cfg.vision_stub and "vision_embed" in batch:
        slot = batch["vision_slot"]                       # (B,S), -1 = text
        patches = batch["vision_embed"].to(x.dtype)       # (B,P,D)
        idx = torch.clamp_min(slot, 0).long()[..., None].expand(
            *slot.shape, patches.shape[-1])
        take = torch.gather(patches, 1, idx)
        x = torch.where((slot >= 0)[..., None], take, x)
    if cfg.pos_embed == "learned":
        pos = batch.get("positions")
        if pos is None:
            pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
        x = x + params["pos_embed"][pos.long()].to(x.dtype)
    return x


def _rope_for(batch, cfg: ModelConfig, seq_len: int, *, positions=None):
    """``(global, local)`` cos/sin tables for the arch, ``None`` where
    unused: the local one (the ``local`` layers' own theta, gemma3) only
    when the config sets ``rope_theta_local`` and has ``local`` layers.
    Under M-RoPE the positions are the batch's ``positions3`` when it has
    them.  Under MLA the tables are at the rope head dim (only the shared
    rope key and the queries' rope part rotate)."""
    a = cfg.attn
    if a is None or cfg.pos_embed not in ("rope", "mrope"):
        return None, None
    if positions is None:
        if cfg.pos_embed == "mrope" and "positions3" in batch:
            positions = batch["positions3"]
        else:
            positions = batch.get("positions")
        if positions is None:
            tokens = batch["tokens"]
            positions = torch.arange(seq_len, dtype=torch.int32,
                                     device=tokens.device)[None].expand(
                                         tokens.shape[0], seq_len)
    head_dim = cfg.mla.rope_head_dim if cfg.mla is not None else a.head_dim
    sections = a.mrope_sections if cfg.pos_embed == "mrope" else None
    rope = layers.rope_tables(positions, head_dim, a.rope_theta,
                              mrope_sections=sections)
    rope_local = None
    if a.rope_theta_local and "local" in cfg.layer_program:
        rope_local = layers.rope_tables(positions, head_dim,
                                        a.rope_theta_local,
                                        mrope_sections=sections)
    return rope, rope_local


def _apply_stack(layer_params, program, x, cfg: ModelConfig,
                 ctx: ExecContext, *, rope, rope_local=None, shared=None,
                 enc_out=None, caches=None, length=None, collect_cache=True):
    """Run the whole layer program; returns (x, per-layer caches).
    ``shared``: the tied block's parameters, and ``enc_out``: the
    encoder's output, each handed to every layer (and, under remat, to its
    recompute as an argument of the checkpoint).  With
    ``collect_cache=False`` (training, the encoder) no cache is built and
    the caches are ``None``; each layer is then recomputed in the backward
    pass when ``ctx.remat == "block"``."""
    caches_out = []
    for i, btype in enumerate(program):
        cache = None if caches is None else caches[i]
        if not collect_cache and ctx.remat == "block":
            def layer(x_in, bp, sh, enc, btype=btype):
                return blocks.apply_block(btype, bp, x_in, cfg=cfg, ctx=ctx,
                                          shared=sh, rope=rope,
                                          rope_local=rope_local, enc_out=enc,
                                          collect_cache=False)[0]
            x, c = checkpoint(layer, x, layer_params[i], shared, enc_out,
                              use_reentrant=False), None
        else:
            x, c = blocks.apply_block(
                btype, layer_params[i], x, cfg=cfg, ctx=ctx, shared=shared,
                rope=rope, rope_local=rope_local, cache=cache, length=length,
                enc_out=enc_out, collect_cache=collect_cache)
        caches_out.append(c)
    return x, (caches_out if collect_cache else None)


def encode(params, batch, cfg: ModelConfig, ctx: ExecContext):
    """The encoder (whisper): ``batch["audio_embed"]`` (B, F, D) plus the
    first F rows of ``params["encoder"]["pos_embed"]``, through the ``enc``
    layers (non-causal self-attention + MLP, no cache; each checkpointed
    under remat), then the encoder's final norm.  Returns (B, F, D)."""
    enc = params["encoder"]
    if "audio_embed" not in batch:
        raise ValueError(f"{cfg.name}: an encoder-decoder batch needs "
                         f"'audio_embed' (B, {cfg.encoder.n_frames}, "
                         f"{cfg.d_model}), the stub frontend's frames")
    x = batch["audio_embed"].to(params["embed"].dtype)
    x = x + enc["pos_embed"][None, :x.shape[1]].to(x.dtype)
    x, _ = _apply_stack(enc["layers"], ("enc",) * cfg.encoder.n_layers, x,
                        cfg, ctx, rope=None, collect_cache=False)
    return layers.norm(enc["final_norm"], x, cfg, ctx)


def forward_hidden(params, batch, cfg: ModelConfig, ctx: ExecContext):
    """The final-normed hidden states (B, S, d) of a full-sequence pass
    without caches, the encoder run first where the model has one (the
    reference also returns the encoder's output; no caller of the port
    reads it)."""
    seq_len = batch["tokens"].shape[1]
    x = embed_inputs(params, batch, cfg, ctx)
    rope, rope_local = _rope_for(batch, cfg, seq_len)
    enc_out = encode(params, batch, cfg, ctx) if cfg.is_encdec else None
    x, _ = _apply_stack(params["layers"], cfg.layer_program, x, cfg, ctx,
                        rope=rope, rope_local=rope_local,
                        shared=params.get("shared_block"), enc_out=enc_out,
                        collect_cache=False)
    return layers.norm(params["final_norm"], x, cfg, ctx)


def loss_fn(params, batch, cfg: ModelConfig, ctx: ExecContext, *,
            mtp_weight: float = 0.3):
    """Mean next-token cross-entropy of ``batch`` (``loss_mask``
    honoured).  Returns (loss, {"ce", "loss"}).

    With ``cfg.mtp_depth`` and ``params["mtp"]``, DeepSeek's multi-token
    prediction as the reference computes it: module m (from 1) maps the
    RMS-normed hidden states of the one before (the final-normed ones for
    the first) and the embeddings of the tokens m ahead (``torch.roll``),
    concatenated, through its ``proj`` and its block (the program's last
    type, no remat) to logits for the labels m ahead, the wrapped tail
    masked; ``loss = ce + mtp_weight · mtp`` with ``mtp`` the mean of the
    modules' cross-entropies, and the metrics get ``"mtp"`` too."""
    h = forward_hidden(params, batch, cfg, ctx)
    logits = layers.logits_from_hidden(params, h, cfg)
    mask = batch.get("loss_mask")
    loss = layers.cross_entropy(logits, batch["labels"], mask)
    metrics = {"ce": loss}
    if cfg.mtp_depth and "mtp" in params:
        s = batch["labels"].shape[1]
        rope, rope_local = _rope_for(batch, cfg, s)
        hm, total = h, 0.0
        for m, mp in enumerate(params["mtp"], start=1):
            emb_next = layers.embed_tokens(
                params, torch.roll(batch["tokens"], -m, dims=1), cfg)
            cat = torch.cat([layers.rmsnorm(mp["norm"], hm, ctx), emb_next],
                            dim=-1)
            hm, _ = blocks.apply_block(
                cfg.layer_program[-1], mp["block"], cat @ mp["proj"],
                cfg=cfg, ctx=ctx, shared=params.get("shared_block"),
                rope=rope, rope_local=rope_local, collect_cache=False)
            logits_m = layers.logits_from_hidden(params, hm, cfg)
            labels_m = torch.roll(batch["labels"], -m, dims=1)
            keep = (torch.arange(s, device=h.device) < s - m)[None].float()
            if mask is not None:
                keep = keep * mask
            total = total + layers.cross_entropy(logits_m, labels_m, keep)
        loss = loss + mtp_weight * total / cfg.mtp_depth
        metrics["mtp"] = total / cfg.mtp_depth
    metrics["loss"] = loss
    return loss, metrics


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda", local_ring: bool = False):
    """Zeroed per-layer caches of ``dtype`` (the reference's default,
    bfloat16; the SSM states float32 whatever it is): ``{"k", "v"}: (B,
    Hkv, S, dh)`` for an
    attention layer (a ``shared_attn`` position too: the weights are tied,
    the caches are not), ``{"conv": (B, d_conv-1, di), "ssm": (B, di, N)
    float32}`` for a ``mamba1`` layer, ``{"conv", "conv_bc": (B, d_conv-1,
    2·G·N), "ssm": (B, H, P, N) float32}`` for a ``mamba2`` layer,
    ``{"self": {"k", "v"}, "xk", "xv": (B, Hkv, n_frames, dh)}`` for an
    ``xattn`` layer.

    ``local_ring``: sliding-window (``local``) layers allocate only
    ``window`` slots, written modulo the window at decode time (ring
    buffer).  Under MLA every attention layer gets the latent cache
    ``{"c_kv": (B, S, R), "k_rope": (B, S, rope_dim)}``."""
    a = cfg.attn
    out = []
    for btype in cfg.layer_program:
        if btype in ("mamba1", "mamba2"):
            s, di, _ = ssm_dims(cfg)
            c = {"conv": torch.zeros((batch, s.d_conv - 1, di), dtype=dtype,
                                     device=device)}
            if btype == "mamba1":
                c["ssm"] = torch.zeros((batch, di, s.d_state),
                                       dtype=torch.float32, device=device)
            else:
                c["conv_bc"] = torch.zeros(
                    (batch, s.d_conv - 1, 2 * s.n_groups * s.d_state),
                    dtype=dtype, device=device)
                c["ssm"] = torch.zeros(
                    (batch, di // s.head_dim, s.head_dim, s.d_state),
                    dtype=torch.float32, device=device)
            out.append(c)
            continue
        if cfg.mla is not None:
            m = cfg.mla
            out.append({"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                             dtype=dtype, device=device),
                        "k_rope": torch.zeros((batch, max_len,
                                               m.rope_head_dim),
                                              dtype=dtype, device=device)})
            continue
        blen = max_len
        if local_ring and btype == "local" and a.window > 0:
            blen = min(max_len, a.window)
        shape = (batch, a.n_kv_heads, blen, a.head_dim)
        c = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
        if btype == "xattn":
            xshape = (batch, a.n_kv_heads, cfg.encoder.n_frames, a.head_dim)
            c = {"self": c,
                 "xk": torch.zeros(xshape, dtype=dtype, device=device),
                 "xv": torch.zeros(xshape, dtype=dtype, device=device)}
        out.append(c)
    return out


def prefill(params, batch, cfg: ModelConfig, ctx: ExecContext):
    """Full forward that also builds the caches (KV, or the SSM state; an
    ``xattn`` layer's cross keys and values from the encoder's output).

    Returns (last-token logits (B, 1, V), caches); the KV caches' sequence
    extent is the prompt length (pad them for a decode budget with
    :func:`repro_torch.runtime.steps._pad_caches`)."""
    seq_len = batch["tokens"].shape[1]
    x = embed_inputs(params, batch, cfg, ctx)
    rope, rope_local = _rope_for(batch, cfg, seq_len)
    enc_out = encode(params, batch, cfg, ctx) if cfg.is_encdec else None
    x, caches = _apply_stack(params["layers"], cfg.layer_program, x, cfg,
                             ctx, rope=rope, rope_local=rope_local,
                             shared=params.get("shared_block"),
                             enc_out=enc_out)
    h = layers.norm(params["final_norm"], x[:, -1:], cfg, ctx)
    return layers.logits_from_hidden(params, h, cfg), caches


def decode_step(params, token, caches, length: int, cfg: ModelConfig,
                ctx: ExecContext, *, positions3=None):
    """One-token decode.  token: (B, 1) integer; length: current cache fill
    (a Python int), the token's position; ``positions3``: the token's
    M-RoPE positions (3, B, 1), default ``length`` in all three.  Returns
    (logits (B, 1, V), caches written in place).

    Under learned positions the token gets the table's row ``length``, as
    the prefill over the same tokens gives it; the reference's
    ``decode_step`` adds row 0 to every decoded token (ROADMAP §C)."""
    b = token.shape[0]
    pos = torch.full((b, 1), length, dtype=torch.int32, device=token.device)
    batch = {"tokens": token, "positions": pos}
    x = embed_inputs(params, batch, cfg, ctx)
    rope, rope_local = _rope_for(
        batch, cfg, 1, positions=positions3 if positions3 is not None
        else pos)
    x, caches = _apply_stack(params["layers"], cfg.layer_program, x, cfg,
                             ctx, rope=rope, rope_local=rope_local,
                             shared=params.get("shared_block"),
                             caches=caches, length=length)
    h = layers.norm(params["final_norm"], x, cfg, ctx)
    return layers.logits_from_hidden(params, h, cfg), caches
