"""Architecture registry of the port.

One module per architecture exports ``CONFIG`` (the exact public
configuration, sources cited in-module) and ``SMOKE`` (a reduced
same-family config for CPU tests).  Every arch of the reference's registry
(``repro/configs``) is registered.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ("granite_moe_1b_a400m", "gemma3_27b", "nemotron_4_15b",
         "phi3_medium_14b", "gemma2_2b", "falcon_mamba_7b", "qwen2_vl_2b",
         "zamba2_2p7b", "deepseek_v3_671b", "whisper_medium")

# brief ids ↔ module names
ALIASES = {"granite-moe-1b-a400m": "granite_moe_1b_a400m",
           "gemma3-27b": "gemma3_27b",
           "nemotron-4-15b": "nemotron_4_15b",
           "phi3-medium-14b": "phi3_medium_14b",
           "gemma2-2b": "gemma2_2b",
           "falcon-mamba-7b": "falcon_mamba_7b",
           "qwen2-vl-2b": "qwen2_vl_2b",
           "zamba2-2.7b": "zamba2_2p7b",
           "deepseek-v3-671b": "deepseek_v3_671b",
           "whisper-medium": "whisper_medium"}


def _module(arch: str):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; the port "
                       f"knows {list(ARCHS)} (+aliases {list(ALIASES)})")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def first_layers(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` at full width with only its first ``n_layers`` layers (a
    depth that fits one card; cut at a whole period of the layer program
    to keep every block type in its ratio)."""
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"{cfg.name}: n_layers must be in 1..{cfg.n_layers}, "
                         f"got {n_layers}")
    return dataclasses.replace(cfg, n_layers=n_layers,
                               layer_program=cfg.layer_program[:n_layers])
