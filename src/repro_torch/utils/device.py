"""The device an entry point of the port runs on.

Every entry point (`make_synth_mnist`, `init_mlp`, the converters,
`run_simulation`) takes ``device=None``, which means the card.  The CPU is
used only where the caller asks for it, as the tests do; without a card
and without such a request the entry point raises rather than carry on on
the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a `torch.device`; ``None`` is the card.  Raises when no
    card is present and no other device was asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU (the "
                "kernels then take their plain versions)")
        device = "cuda"
    return torch.device(device)
