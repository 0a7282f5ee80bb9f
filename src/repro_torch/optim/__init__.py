"""Optimizer substrate: AdamW, schedules, quantised state.  Port of
``repro/optim``; gradient compression (``compress.py``, the ``ef`` state)
needs a pod axis and waits for sharded training (ROADMAP A7.7)."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .quant import QTensor, dequantize_blockwise, quantize_blockwise
from .schedule import warmup_cosine

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "global_norm",
    "warmup_cosine", "QTensor", "quantize_blockwise", "dequantize_blockwise",
]
