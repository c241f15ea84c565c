"""Batch construction and parameter counts (the dense family).

Ported from `repro.models.api`: `make_batch` draws tokens from an explicit
`torch.Generator` (on its own device), `param_count` counts weights.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.utils.trees import leaves


def make_batch(cfg: ModelConfig, batch_size: int, seq_len: int,
               generator: torch.Generator):
    """{tokens, targets: [B, S] int64}, uniform over the vocabulary, drawn
    from `generator` on its device."""
    kw = dict(generator=generator, device=generator.device)
    return {
        "tokens": torch.randint(0, cfg.vocab_size, (batch_size, seq_len), **kw),
        "targets": torch.randint(0, cfg.vocab_size, (batch_size, seq_len), **kw),
    }


def param_count(params) -> int:
    """Number of weights in a parameter tree."""
    return sum(t.numel() for t in leaves(params))
