"""Shape-preserving block-wise 8-bit quantisation for optimizer moments.

Port of ``repro/optim/quant.py``: absmax blocks along the **last axis**,
the codes keeping the tensor's exact shape::

    codes: int8, same shape as x
    scale: float32, x.shape[:-1] + (ceil(last/block),)

The codes and scales equal the reference's bit for bit: both round half
to even (``torch.round``, ``jnp.round``) and divide, scale by 127 and
clamp in the same order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .tree import tree_map


class QTensor(NamedTuple):
    codes: torch.Tensor          # int8, shape == original
    scale: torch.Tensor          # float32, (*lead, nblocks); already /127


def quantize_blockwise(x: torch.Tensor, block: int = 256) -> QTensor:
    x = x.float()
    if x.ndim == 0:
        q = quantize_blockwise(x[None], block)
        return QTensor(q.codes[0], q.scale[0])
    last = x.shape[-1]
    nb = -(-last // min(block, last))
    bs = -(-last // nb)          # dequantize re-derives this from (last, nb)
    pad = nb * bs - last
    xp = F.pad(x, (0, pad)) if pad else x
    xb = xp.reshape(*x.shape[:-1], nb, bs)
    scale = xb.abs().amax(-1)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(xb / safe[..., None] * 127.0),
                        -127, 127).to(torch.int8)
    codes = codes.reshape(*x.shape[:-1], nb * bs)
    if pad:
        codes = codes[..., :last].contiguous()
    return QTensor(codes, scale / 127.0)


def dequantize_blockwise(q: QTensor, shape, dtype=torch.float32):
    codes, scale = q.codes, q.scale
    if codes.ndim == 0:
        return (codes.float() * scale).to(dtype)
    last = codes.shape[-1]
    nb = scale.shape[-1]
    bs = -(-last // nb)
    pad = nb * bs - last
    cp = F.pad(codes, (0, pad)) if pad else codes
    xb = cp.reshape(*codes.shape[:-1], nb, bs).float()
    out = (xb * scale[..., None]).reshape(*codes.shape[:-1], nb * bs)
    if pad:
        out = out[..., :last]
    return out.reshape(shape).to(dtype)


def tree_quantize(tree, block: int = 256):
    return tree_map(lambda x: quantize_blockwise(x, block), tree)


def tree_dequantize(qtree, shapes_tree, dtype=torch.float32):
    return tree_map(lambda q, s: dequantize_blockwise(q, s.shape, dtype),
                    qtree, shapes_tree)
