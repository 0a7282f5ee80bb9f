"""AdamW with optional block-quantised (8-bit) moments.

Port of ``repro/optim/adamw.py``.  State layout (twin tree to params)::

  fp32 moments:   {"m": tree, "v": tree, "step": () int32}
  8-bit moments:  {"m": QTensor tree, "v": QTensor tree, "step": ()}

The update is written once over float32 moments; the 8-bit path
de/re-quantises around it.  It runs in place, under ``torch.no_grad()``,
on the parameter tensors and the dense moments, one leaf at a time (the
reference's ``lax.map`` streaming of large leaves has no counterpart: one
leaf's temporaries are all that is live).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .quant import QTensor, dequantize_blockwise, quantize_blockwise
from .tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                  # used when schedule not supplied
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0            # 0 disables
    quantize_moments: bool = False
    quant_block: int = 256


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves))


def adamw_init(params, cfg: AdamWConfig):
    def zero_like(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.quantize_moments:
            return quantize_blockwise(z, cfg.quant_block)
        return z
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zero_like, params),
            "v": tree_map(zero_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(params, grads, state, cfg: AdamWConfig, *,
                 lr: Optional[torch.Tensor] = None, decay=None):
    """One AdamW step, in place on ``params`` and the dense moments.
    Returns ``(params, state, metrics)``: the same parameter tensors, the
    state with its new step (and new ``QTensor`` moments), and
    ``{"grad_norm": the norm before clipping, "lr"}``.  ``decay``: a tree
    of bools twin to ``params``, the leaves weight decay applies to;
    ``None`` is the reference's rule, leaves of two or more dimensions."""
    with torch.no_grad():
        step = state["step"] + 1
        dev = step.device
        lr = torch.as_tensor(cfg.lr if lr is None else lr,
                             dtype=torch.float32, device=dev)
        gnorm = global_norm(grads)
        scale = None
        if cfg.clip_norm > 0:
            scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                                max=1.0)
        c1 = 1.0 - cfg.b1 ** step.float()
        c2 = 1.0 - cfg.b2 ** step.float()

        def upd(p, g, m, v, decay_ok):
            g = g.float()
            if scale is not None:
                g = g * scale
            quant = isinstance(m, QTensor)
            if quant:
                m = dequantize_blockwise(m, p.shape)
                v = dequantize_blockwise(v, p.shape)
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            del g
            # mhat / (sqrt(vhat) + eps), the reference's operations in its
            # order, in place on two temporaries
            den = (v / c2).sqrt_().add_(cfg.eps)
            upd_ = (m / c1).div_(den)
            del den
            if cfg.weight_decay > 0 and decay_ok:
                upd_.add_(cfg.weight_decay * p.float())
            # one rounding to the leaf's dtype, as the reference's
            # (p.f32 - lr·step).astype(p.dtype); in place in float32
            upd_.mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(upd_)
            else:
                p.copy_(p.float().sub_(upd_))
            if quant:
                m = quantize_blockwise(m, cfg.quant_block)
                v = quantize_blockwise(v, cfg.quant_block)
            return m, v

        flat_p = tree_leaves(params)
        flat_g = tree_leaves(grads)
        flat_m = tree_leaves(state["m"])
        flat_v = tree_leaves(state["v"])
        flat_d = ([p.ndim >= 2 for p in flat_p] if decay is None
                  else tree_leaves(decay))
        out = [upd(*leaf) for leaf in
               zip(flat_p, flat_g, flat_m, flat_v, flat_d)]
        it_m = iter([o[0] for o in out])
        it_v = iter([o[1] for o in out])
        new_state = {"m": tree_map(lambda _: next(it_m), params),
                     "v": tree_map(lambda _: next(it_v), params),
                     "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
