"""Architecture registry: `get_config(name)` / `get_smoke_config(name)`.

Ported from `repro.configs`: one module per architecture, each exporting
FULL (the published configuration, bfloat16) and SMOKE (2 layers, d_model
256, float32, for the CPU tests).  Every architecture of the reference is
here: the dense decoders, the audio encoder (hubert-xlarge), the VLM
(phi-3-vision-4.2b), the MoE decoders (grok-1-314b, deepseek-v2-236b with
MLA), the SSM (mamba2-1.3b) and the hybrid (zamba2-7b).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

ARCH_NAMES = ["phi-3-vision-4.2b", "grok-1-314b", "mamba2-1.3b",
              "zamba2-7b", "hubert-xlarge", "tinyllama-1.1b", "llama3-8b",
              "yi-34b", "deepseek-v2-236b", "yi-9b"]

_MODULES = {n: "repro_torch.configs." + n.replace("-", "_").replace(".", "_")
            for n in ARCH_NAMES}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str, **overrides) -> ModelConfig:
    """The published configuration of `name`, with `overrides` applied."""
    return dataclasses.replace(_module(name).FULL, **overrides)


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    """The reduced same-family configuration of `name` (CPU tests)."""
    return dataclasses.replace(_module(name).SMOKE, **overrides)
