"""Execution context: which executor the model's kernel ops run under.

The targetDP contract at framework scale: model code is written once and
the :class:`ExecContext` decides how it runs.  The port has no mesh yet
(ROADMAP, queue A), so the context holds the executor, the VVL, the
remat policy, the MoE dispatch and the plain attention's oracle.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ExecContext:
    """``backend``: ``"cuda"`` (the hand-written kernels; on CPU tensors
    their plain versions run) or ``"torch"`` (the plain PyTorch versions
    everywhere — the oracle).  ``vvl``: sites per thread of the gathered
    executor's LM site functions.  The reference's default of 256 is the
    width of a Pallas chunk; on the card a thread covers 1, 2, 4 or 8
    sites, and 1 is the coalesced mapping, so the port defaults to 1.
    ``remat``: ``"none"``, or ``"block"`` to recompute each layer's
    forward in the backward pass (``torch.utils.checkpoint``) instead of
    keeping its activations.  ``moe_impl``: the MoE dispatch of
    :mod:`repro_torch.models.moe`, ``"capacity"`` (tokens packed into
    ``(E, cap, D)``, batched GEMMs, overflow dropped), ``"ragged"``
    (dropless, a per-expert loop) or ``"a2a"`` (all-to-all expert
    parallelism; with no mesh it is ``"capacity"``, as in the
    reference).  ``attn_impl``: the plain attention under ``"torch"``,
    ``"ref"`` (the whole (B, H, Sq, Sk) score tensor at once) or
    ``"chunked"`` (a block of query rows at a time, with a recompute
    backward: the oracle at lengths where the whole scores do not fit);
    the ``"cuda"`` backend runs kernel 4 under either."""

    backend: str = "cuda"
    vvl: int = 1
    remat: str = "none"
    moe_impl: str = "capacity"
    attn_impl: str = "ref"

    def __post_init__(self):
        if self.backend not in ("cuda", "torch"):
            raise ValueError(f"backend must be 'cuda' or 'torch', got "
                             f"{self.backend!r}")
        if self.remat not in ("none", "block"):
            raise ValueError(f"remat must be 'none' or 'block', got "
                             f"{self.remat!r}")
        if self.moe_impl not in ("capacity", "ragged", "a2a"):
            raise ValueError(f"moe_impl must be 'capacity', 'ragged' or "
                             f"'a2a', got {self.moe_impl!r}")
        if self.attn_impl not in ("ref", "chunked"):
            raise ValueError(f"attn_impl must be 'ref' or 'chunked', got "
                             f"{self.attn_impl!r}")
