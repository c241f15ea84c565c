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


def nll_loss_event_batched(params, deltas, x, y):
    """Per-event NLL [K] in the shared/delta form the cotangent fused path
    differentiates (`engine.fused_apply_cotangent`).

    `params` is the one differentiable parameter set W; `deltas` holds each
    event's detached stale offset δ_k = p_k − W ([K, ...] leaves); `x` is
    [K, μ, d_in], `y` [K, μ].  Each layer is evaluated as

        h @ (W_l + δ_l[k])  =  h @ W_l  +  h @ δ_l[k]

    so the differentiable operand of every GEMM is the shared W_l: the
    weight gradient is one contraction over the flattened K·μ axis into
    [d_in, d_out], and no [K, ...] per-event gradient is formed.
    """
    K, mu = x.shape[0], x.shape[1]
    h = x
    last = len(params) - 1
    for i, (layer, dl) in enumerate(zip(params, deltas)):
        shared = (h.reshape(K * mu, -1) @ layer["w"]).reshape(K, mu, -1)
        stale = torch.einsum("kmi,kio->kmo", h, dl["w"])
        z = shared + stale + layer["b"] + dl["b"][:, None, :]
        h = z if i == last else F.relu(z)
    logp = F.log_softmax(h, dim=-1)
    return -torch.gather(logp, -1, y[..., None])[..., 0].mean(dim=-1)


# the cotangent fused path finds it through engine.resolve_event_batched_loss
nll_loss.event_batched = nll_loss_event_batched


def accuracy(params, x, y):
    """Share of `x` whose arg-max logit is `y`."""
    return torch.mean((apply_mlp(params, x).argmax(dim=-1) == y).float())
