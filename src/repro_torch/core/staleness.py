"""Staleness measures (paper §2.1, §2.2), ported from `repro.core.staleness`.

* **step-staleness** τ = i − j: server updates elapsed since the client
  fetched the parameters its gradient was computed on;
* **B-Staleness** Γ = ||Δθ^l − Δθ_i||: the drift between the client's
  gradient and the one it would have computed on the server's current
  parameters (same minibatch) — an exact oracle for tests and diagnostics,
  never used by the update path.

`mean_leaf_tau` (in `repro.core.rules` in the reference) collapses a
per-tensor staleness tree (§5) to one diagnostic τ.
"""
from __future__ import annotations

import torch

from repro_torch.utils.trees import leaves


def step_staleness(server_timestamp, grad_timestamp) -> torch.Tensor:
    """τ = i − j, clipped to be ≥ 1 so it can be divided by (float32).

    A gradient computed on the server's current parameters has τ = 0; like
    Zhang et al. and the reference, the freshest gradient counts as τ = 1.
    Stays on the device of its inputs: no host sync.
    """
    tau = torch.as_tensor(server_timestamp) - torch.as_tensor(grad_timestamp)
    return torch.clamp(tau, min=1).to(torch.float32)


def b_staleness(grad_fn, server_params, client_params, batch) -> torch.Tensor:
    """Exact B-Staleness: Γ = ||∇f(θ_client; batch) − ∇f(θ_server; batch)||.

    `grad_fn(params, batch)` returns a tree of gradients.
    """
    g_client = grad_fn(client_params, batch)
    g_server = grad_fn(server_params, batch)
    sq = sum(torch.sum((a - b) ** 2)
             for a, b in zip(leaves(g_client), leaves(g_server)))
    return torch.sqrt(sq)


def mean_leaf_tau(tau_tree) -> torch.Tensor:
    """The mean over leaves of a per-leaf staleness tree (leaves scalars or
    [K] event vectors), float32, summed in leaf order as the reference
    does."""
    ls = leaves(tau_tree)
    return sum(t.to(torch.float32) for t in ls) / max(len(ls), 1)
