"""Weights carried across: numpy in, tensors out, and back.

Both packages hold the MLP as a list of ``{"w", "b"}`` dicts, so a state
written out of one with numpy starts the other from the same point.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.rules import ServerState
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import tree_map


def _tensor(a, device):
    return torch.as_tensor(np.array(a)).to(device)


def params_from_numpy(params, device=None):
    """A tree of numpy arrays (or anything `np.asarray` takes) as tensors on
    `device` (the card unless the caller passes another), dtypes kept."""
    device = resolve_device(device)
    return tree_map(lambda a: _tensor(a, device), params)


def server_state_from_numpy(params, T, n, b, v, device=None) -> ServerState:
    """A `ServerState` from numpy trees: params, timestamp T, statistics, on
    `device` (the card unless the caller passes another)."""
    device = resolve_device(device)
    return ServerState(
        params=params_from_numpy(params, device),
        timestamp=torch.tensor(int(T), dtype=torch.int32, device=device),
        n=params_from_numpy(n, device),
        b=params_from_numpy(b, device),
        v=params_from_numpy(v, device))


def to_numpy(tree):
    """Every tensor leaf of `tree` (a `ServerState` too) as a numpy array;
    bfloat16 comes back as float32, which numpy lacks."""
    def one(t):
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()
    return tree_map(one, tree)
