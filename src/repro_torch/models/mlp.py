"""The paper's experimental model: a 2-layer MLP (784-200-10, relu, NLL).

Ported from `repro.models.mlp`.  Params are a list of ``{"w", "b"}`` dicts
(``w`` is [d_in, d_out]), the same tree the JAX package uses, so the two
hand weights across through numpy.  The GEMMs stay `torch.matmul`, as the
reference leaves them to XLA.  Float32 products run in full float32: the
package turns TF32 off when it is imported (see `repro_torch.models`).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.utils.device import resolve_device


def init_mlp(generator: torch.Generator, sizes: Sequence[int] = (784, 200, 10),
             device=None):
    """He-normal weights from `generator` (a CPU generator), zero biases, on
    `device` (the card unless the caller passes another)."""
    device = resolve_device(device)
    params = []
    for d_in, d_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn(d_in, d_out, generator=generator) * math.sqrt(2.0 / d_in)
        params.append({"w": w.to(device), "b": torch.zeros(d_out, device=device)})
    return params


def apply_mlp(params, x):
    """Logits of `x` [..., d_in]."""
    for layer in params[:-1]:
        x = F.relu(x @ layer["w"] + layer["b"])
    last = params[-1]
    return x @ last["w"] + last["b"]


def nll_loss(params, x, y):
    """Mean negative log-likelihood of int64 labels `y` [B]."""
    logp = F.log_softmax(apply_mlp(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, -1, y[:, None]))


def accuracy(params, x, y):
    """Share of `x` whose arg-max logit is `y`."""
    return torch.mean((apply_mlp(params, x).argmax(dim=-1) == y).float())
