"""Serving steps: sampling, cache padding, prefill and decode steps.

Port of the serving half of ``repro/runtime/steps.py``.  ``jax.random``
keys become an explicit ``torch.Generator``; greedy sampling needs none.
The caches are per-layer dicts: ``{"k", "v"}`` for attention, which the
decode step writes in place, or ``{"conv", "ssm"}`` for Mamba-1, which it
replaces; ``length`` is a Python int.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.context import ExecContext


def sample_logits(logits, generator: torch.Generator | None = None, *,
                  temperature: float = 0.0, top_k: int = 0):
    """logits (B, 1, V) → tokens (B, 1) int64: argmax at temperature 0,
    else a draw from softmax(logits / temperature) over the top ``top_k``
    (all when 0), with ``generator``."""
    lg = logits[:, -1, :].float()
    if temperature <= 0.0:
        return lg.argmax(-1)[:, None]
    lg = lg / temperature
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


def _pad_caches(caches, cfg: ModelConfig, max_len: int):
    """Grow every sequence-extent leaf (``k``/``v``: (B, Hkv, S, dh)) to
    ``max_len``, zero-filled; the fixed-size ``conv``/``ssm`` state stays
    as it is."""
    def pad(name, t):
        if name not in ("k", "v") or t.shape[2] >= max_len:
            return t
        return F.pad(t, (0, 0, 0, max_len - t.shape[2]))
    return [{k: pad(k, v) for k, v in c.items()} for c in caches]


def build_serve_steps(cfg: ModelConfig, ctx: ExecContext, *, max_len: int,
                      temperature: float = 0.0, top_k: int = 0):
    """Returns (prefill_step, decode_step).

    prefill_step(params, batch, generator) -> (token, caches, length, logits)
    decode_step(params, token, caches, length, generator)
        -> (next_token, caches, length + 1, logits)

    The last slot, the encoder output in the reference, is the step's
    logits (B, 1, V) here: the port has no encoder, and a caller that
    checks or scores the tokens needs them."""
    def prefill_step(params, batch, generator=None):
        logits, caches = lm.prefill(params, batch, cfg, ctx)
        caches = _pad_caches(caches, cfg, max_len)
        tok = sample_logits(logits, generator, temperature=temperature,
                            top_k=top_k)
        return tok, caches, int(batch["tokens"].shape[1]), logits

    def decode_step(params, token, caches, length, generator=None):
        logits, caches = lm.decode_step(params, token, caches, length, cfg,
                                        ctx)
        tok = sample_logits(logits, generator, temperature=temperature,
                            top_k=top_k)
        return tok, caches, length + 1, logits

    return prefill_step, decode_step
