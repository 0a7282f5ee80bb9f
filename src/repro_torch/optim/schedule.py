"""Learning-rate schedules (functions of the step counter).  Port of
``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1):
    """Linear warmup → cosine decay to ``min_ratio · peak_lr``.  ``step``:
    a tensor (any integer or float dtype, any device) or a number; returns
    float32 on its device."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) /
                       max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
