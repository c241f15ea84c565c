"""Step-staleness (paper §2.1), ported from `repro.core.staleness`.

The exact B-Staleness oracle (`b_staleness`) waits for a later slice.
"""
from __future__ import annotations

import torch


def step_staleness(server_timestamp, grad_timestamp) -> torch.Tensor:
    """τ = i − j, clipped to be ≥ 1 so it can be divided by (float32).

    A gradient computed on the server's current parameters has τ = 0; like
    Zhang et al. and the reference, the freshest gradient counts as τ = 1.
    Stays on the device of its inputs: no host sync.
    """
    tau = torch.as_tensor(server_timestamp) - torch.as_tensor(grad_timestamp)
    return torch.clamp(tau, min=1).to(torch.float32)
