"""Architecture registry of the port.

One module per architecture exports ``CONFIG`` (the exact public
configuration, sources cited in-module) and ``SMOKE`` (a reduced
same-family config for CPU tests).  Only the archs whose blocks the port
runs are registered; the rest of the reference's registry
(``repro/configs``) waits for its slices (ROADMAP, queue A, LM stack).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ("gemma2_2b", "falcon_mamba_7b")

# brief ids ↔ module names
ALIASES = {"gemma2-2b": "gemma2_2b",
           "falcon-mamba-7b": "falcon_mamba_7b"}


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
