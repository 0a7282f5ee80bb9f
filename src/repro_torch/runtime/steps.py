"""Train and serve steps.  Port of ``repro/runtime/steps.py``.

Training: :func:`build_train_step` assembles ``(params, opt_state, batch)
-> (params, opt_state, metrics)`` from plain pieces — the global batch cut
into ``grad_accum`` strided microbatches, their gradients accumulated in
float32 (each microbatch's ``.grad``, in the leaf's dtype, moved into a
float32 sum one leaf at a time, as the reference's scan adds them), layer
remat when ``ctx.remat == "block"``, and an in-place AdamW step on the
schedule's learning rate, decaying the leaves the reference decays
(:func:`repro_torch.models.params.weight_decay_mask`); the loss carries
multi-token prediction at ``mtp_weight`` where the config has it.  The
cross-pod compressed variant needs a pod axis and waits for sharded
training (ROADMAP A7.7).

Serving: sampling, cache padding, prefill and decode steps.  ``jax.random``
keys become an explicit ``torch.Generator``; greedy sampling needs none.
The caches are per-layer dicts: ``{"k", "v"}`` for attention and
``{"c_kv", "k_rope"}`` for MLA, which the decode step writes in place,
``{"self": {"k", "v"}, "xk", "xv"}`` for whisper's ``xattn`` layers (the
cross keys and values fixed at the prefill), or ``{"conv", "ssm"}`` for
Mamba-1, which it replaces; ``length`` is a Python int.  Batches of an
encoder–decoder model carry ``audio_embed (B, F, D)``, cut into
microbatches with the rest.  With ``local_ring=True`` the sliding-window layers keep
window-sized ring caches after the prefill (the reference's
``init_cache(local_ring=True)`` layout).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import weight_decay_mask
from repro_torch.models.context import ExecContext
from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine
from repro_torch.optim.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_accum: int = 1
    mtp_weight: float = 0.3      # multi-token prediction's share of the loss
    compress_pod: bool = False   # raises: needs a pod mesh axis (A7.7)


def _microbatch(batch: dict, n: int) -> dict:
    """(B, ...) leaves → (n, B/n, ...) with microbatch rows **strided**:
    microbatch j = rows {i·n + j} (the reference's cut, which keeps every
    microbatch spread over a data-sharded batch).  ``positions3`` carries
    the batch on dim 1 (M-RoPE's (3, B, S) layout)."""
    def cut(x, bdim=0):
        b = x.shape[bdim]
        assert b % n == 0, f"global batch {b} not divisible by accum {n}"
        shp = x.shape[:bdim] + (b // n, n) + x.shape[bdim + 1:]
        return torch.movedim(x.reshape(shp), bdim + 1, 0)
    return {k: cut(v, 1 if k == "positions3" else 0)
            for k, v in batch.items()}


def _metrics_and_grads(cfg: ModelConfig, ctx: ExecContext,
                       hp: TrainHParams):
    """(params, batch) → (metrics, grads): the loss function's metrics
    (``"loss"``, ``"ce"`` and, under multi-token prediction, ``"mtp"``),
    each the mean over the microbatches, and the loss's gradient tree
    (params' structure).  Each microbatch's ``backward()`` writes the
    leaves' ``.grad`` (cleared before); with one microbatch that is the
    gradient, in the leaf's dtype, as the reference's; with accumulation
    each microbatch's ``.grad`` is moved into a float32 sum and cleared
    before the next, and the sums and metrics are scaled by 1 /
    grad_accum, as the reference's are."""
    n = hp.grad_accum

    def metrics_and_grads(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        mbs = [batch] if n == 1 else [
            {k: v[j] for k, v in _microbatch(batch, n).items()}
            for j in range(n)]
        sums: dict = {}
        acc = [None] * len(leaves)
        for b in mbs:
            lb, mb = lm.loss_fn(params, b, cfg, ctx, mtp_weight=hp.mtp_weight)
            lb.backward()
            for k, v in mb.items():
                sums[k] = v.detach() if k not in sums else sums[k] + v.detach()
            if n > 1:
                for i, p in enumerate(leaves):
                    if p.grad is not None:
                        acc[i] = (p.grad.float() if acc[i] is None
                                  else acc[i].add_(p.grad))
                        p.grad = None

        def take(p, a):
            if n > 1:
                return (a.mul_(1.0 / n) if a is not None else
                        torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device))
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            return g
        it = iter(acc)
        grads = tree_map(lambda p: take(p, next(it)), params)
        return ({k: v * (1.0 / n) if n > 1 else v for k, v in sums.items()},
                grads)

    return metrics_and_grads


def _grads_of(cfg: ModelConfig, ctx: ExecContext, hp: TrainHParams):
    """(params, batch) → (loss, grads): :func:`_metrics_and_grads`' mean
    loss and gradient tree."""
    metrics_and_grads = _metrics_and_grads(cfg, ctx, hp)

    def grads_of(params, batch):
        metrics, grads = metrics_and_grads(params, batch)
        return metrics["loss"], grads

    return grads_of


def build_train_step(cfg: ModelConfig, ctx: ExecContext,
                     opt_cfg: AdamWConfig, hp: TrainHParams) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, {"loss", "ce", "mtp"?, "grad_norm", "lr"})``; ``params``
    (leaves that require gradients) and the dense moments are updated in
    place.  ``ce`` and ``mtp`` (under multi-token prediction) are the
    loss's parts, an addition to the reference's metrics."""
    if hp.compress_pod:
        raise NotImplementedError(
            "compress_pod: the error-feedback int8 gradient reduction over a "
            "pod mesh axis is not ported yet (ROADMAP A7.7)")
    metrics_and_grads = _metrics_and_grads(cfg, ctx, hp)

    def train_step(params, opt_state, batch):
        metrics, grads = metrics_and_grads(params, batch)
        lr = warmup_cosine(opt_state["step"], peak_lr=hp.peak_lr,
                           warmup_steps=hp.warmup_steps,
                           total_steps=hp.total_steps)
        params, opt_state, om = adamw_update(
            params, grads, opt_state, opt_cfg, lr=lr,
            decay=weight_decay_mask(params))
        return params, opt_state, {**metrics, **om}

    return train_step


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
    """Grow every sequence-extent leaf (``k``/``v``: (B, Hkv, S, dh), and
    MLA's ``c_kv``/``k_rope``: (B, S, ·)) to ``max_len``, zero-filled, at
    any depth of a layer's dict (an ``xattn`` layer's ``self``); the
    fixed-size ``conv``/``ssm`` state and the cross keys and values
    ``xk``/``xv`` (the encoder's frames) stay as they are."""
    seq_dim = {"k": 2, "v": 2, "c_kv": 1, "k_rope": 1}

    def pad(name, t):
        if name not in seq_dim or t.shape[seq_dim[name]] >= max_len:
            return t
        grow = [0, 0] * (t.dim() - 1 - seq_dim[name]) + [
            0, max_len - t.shape[seq_dim[name]]]
        return F.pad(t, grow)

    def walk(c):
        return {k: walk(v) if isinstance(v, dict) else pad(k, v)
                for k, v in c.items()}
    return [walk(c) for c in caches]


def _ring_caches(caches, cfg: ModelConfig, length: int):
    """Each ``local`` layer's cache cut to ``min(extent, window)`` slots,
    the decode step's ring buffer: position p of the last ones written
    sits at slot p mod slots, where :func:`lm.decode_step` looks for it.
    The other layers' caches are returned as they are."""
    w = cfg.attn.window if cfg.attn is not None else 0
    out = []
    for btype, c in zip(cfg.layer_program, caches):
        if btype != "local" or w <= 0:
            out.append(c)
            continue
        slots = min(c["k"].shape[2], w)
        pos = torch.arange(max(length - slots, 0), length,
                           device=c["k"].device)
        ring = {}
        for name in ("k", "v"):
            t = c[name]
            r = t.new_zeros(t.shape[0], t.shape[1], slots, t.shape[3])
            r[:, :, pos % slots] = t[:, :, pos]
            ring[name] = r
        out.append(ring)
    return out


def build_serve_steps(cfg: ModelConfig, ctx: ExecContext, *, max_len: int,
                      temperature: float = 0.0, top_k: int = 0,
                      local_ring: bool = False):
    """Returns (prefill_step, decode_step).

    prefill_step(params, batch, generator) -> (token, caches, length, logits)
    decode_step(params, token, caches, length, generator, positions3=None)
        -> (next_token, caches, length + 1, logits)

    The last slot, the encoder output in the reference, is the step's
    logits (B, 1, V) here: the encoder's output lives on in the ``xattn``
    caches' ``xk``/``xv``, and a caller that checks or scores the tokens
    needs the logits.  ``positions3`` (3, B, 1): the
    token's M-RoPE positions (default ``length`` in all three).
    ``local_ring``: the ``local`` layers' caches become window-sized ring
    buffers after the prefill (:func:`_ring_caches`)."""
    def prefill_step(params, batch, generator=None):
        logits, caches = lm.prefill(params, batch, cfg, ctx)
        length = int(batch["tokens"].shape[1])
        caches = _pad_caches(caches, cfg, max_len)
        if local_ring:
            caches = _ring_caches(caches, cfg, length)
        tok = sample_logits(logits, generator, temperature=temperature,
                            top_k=top_k)
        return tok, caches, length, logits

    def decode_step(params, token, caches, length, generator=None,
                    positions3=None):
        logits, caches = lm.decode_step(params, token, caches, length, cfg,
                                        ctx, positions3=positions3)
        tok = sample_logits(logits, generator, temperature=temperature,
                            top_k=top_k)
        return tok, caches, length + 1, logits

    return prefill_step, decode_step
