"""Data pipeline: deterministic synthetic token streams."""
from .synthetic import SyntheticConfig, batch_for_step, make_batch_loader

__all__ = ["SyntheticConfig", "batch_for_step", "make_batch_loader"]
