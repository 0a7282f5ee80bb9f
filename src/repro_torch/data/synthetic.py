"""Deterministic synthetic LM data.  The port's own copy of
``repro/data/synthetic.py``: the batches are numpy arrays made from the
seed, so the port's tokens and labels equal the reference's.

* **Stateless addressing** — ``batch_for_step(step)`` is a pure function of
  ``(seed, step, rows)``; a restarted job replays the exact stream from
  any step with no loader state in the checkpoint beyond the step counter.
* **Learnable structure** — tokens follow a fixed random successor table
  (order-1 Markov, ``branching`` successors a token), so training has a
  real, falling loss (a uniform stream would pin the loss at log V).
* **Row ownership** — a row's content depends only on its global
  position, so any slicing of the batch over processes reproduces it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device


@dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 8       # bigram successors per token (entropy ≈ log2 b)


def _successor_table(cfg: SyntheticConfig) -> np.ndarray:
    """(vocab, branching) successor table, derived from the seed."""
    rng = np.random.default_rng(cfg.seed ^ 0x5EED)
    return rng.integers(0, cfg.vocab_size,
                        size=(cfg.vocab_size, cfg.branching), dtype=np.int64)


_TABLE_CACHE: dict = {}


def batch_for_step(cfg: SyntheticConfig, step: int, *,
                   lo: int = 0, hi: Optional[int] = None) -> dict:
    """Global batch rows [lo, hi) for ``step`` (hi=None → full batch).

    Returns {"tokens": (rows, S) int32, "labels": (rows, S) int32} numpy
    arrays; labels are next-token targets."""
    hi = cfg.global_batch if hi is None else hi
    key = (cfg.vocab_size, cfg.branching, cfg.seed)
    table = _TABLE_CACHE.get(key)
    if table is None:
        table = _successor_table(cfg)
        _TABLE_CACHE[key] = table

    rows = hi - lo
    seq = np.empty((rows, cfg.seq_len + 1), dtype=np.int64)
    choices = np.empty((rows, cfg.seq_len), dtype=np.int64)
    for i, row in enumerate(range(lo, hi)):
        rng = np.random.default_rng(np.random.SeedSequence(
            [cfg.seed, step, row]))
        seq[i, 0] = rng.integers(0, cfg.vocab_size)
        choices[i] = rng.integers(0, cfg.branching, size=cfg.seq_len)
    for t in range(cfg.seq_len):
        seq[:, t + 1] = table[seq[:, t], choices[:, t]]
    return {"tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32)}


def make_batch_loader(cfg: SyntheticConfig, *, device=None,
                      process_index: int = 0, process_count: int = 1):
    """Returns ``load(step) -> {"tokens", "labels"}``: int64 tensors (the
    index dtype of ``embed_tokens`` and ``cross_entropy``) on ``device``
    (default the card; it raises without one).  Process ``pi`` of ``P``
    materialises rows [pi·B/P, (pi+1)·B/P)."""
    per = cfg.global_batch // process_count
    lo = process_index * per
    hi = lo + per
    device = resolve_device(device)

    def load(step: int):
        host = batch_for_step(cfg, step, lo=lo, hi=hi)
        return {k: torch.from_numpy(v.astype(np.int64)).to(device)
                for k, v in host.items()}

    return load
