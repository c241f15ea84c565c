"""Shared model layers: RMSNorm, RoPE, SwiGLU, embeddings.

Ported from `repro.models.layers`.  Pure functions over plain dicts of
tensors; initializers draw from an explicit `torch.Generator` and create
every weight in the config's dtype.  RMSNorm and RoPE upcast to float32
and cast back to the working dtype where the reference does, so bfloat16
rounds at the same places.  The GEMMs stay `torch.einsum`, as the
reference leaves them to XLA.  The stale-offset forms (`dget`, `eff`,
`delta_einsum`) carry an event's offset δ = p_k − W through the training
forward for the cotangent fused path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.sharding.rules import batch_only, gathered


def dget(dp, key):
    """Sub-delta lookup: `dp[key]`, passing an absent delta tree
    through."""
    return None if dp is None else dp[key]


def eff(w, dw):
    """Effective parameter `w + dw` (plain `w` when there is no delta).

    For small or elementwise-consumed leaves (norm gains) the add is cheap;
    the shared/delta GEMM split below is kept for the large contractions,
    where a per-event [K, ...] weight gradient would hurt.
    """
    return w if dw is None else w + dw


def delta_einsum(eq, x, w, dw=None):
    """`einsum(eq, x, w)` with an optional stale offset `dw` (detached).

    Split as `einsum(x, w) + einsum(x, dw)` so that the shared `w` stays
    the differentiable operand of its GEMM: under `torch.func.vmap` with
    `w` unbatched, the weight gradient contracts over the combined
    event × token batch in one pass and never forms a per-event [K, ...]
    weight gradient.  This is not `einsum(x, w + dw)` to the last bit.

    Over processes (DTensor operands) the weight is gathered for the
    contraction and x keeps its batch sharding alone (`sharding.rules`):
    the output is sharded as x's batch.
    """
    x, w = batch_only(x), gathered(w)
    y = torch.einsum(eq, x, w)
    return y if dw is None else y + torch.einsum(eq, x, gathered(dw))


def is_meta(device, generator=None) -> bool:
    """Whether an initializer's target (`device`, else the generator's) is
    the meta device, where weights are shapes alone and nothing is
    drawn."""
    target = device if device is not None else getattr(generator, "device",
                                                       None)
    return target is not None and torch.device(target).type == "meta"


def dense_init(generator: torch.Generator, shape, dtype, scale=None, *,
               layers: int = 0, device=None):
    """scale · N(0, 1) weights of `shape` in `dtype` on `device` (default:
    the generator's); scale defaults to 1/√shape[0] (fan-in).  With
    `layers` > 0 the weight is stacked: [layers, *shape], each layer with
    the same scale, as the reference's vmapped per-layer init gives.  On
    the meta device nothing is drawn (`generator` may be None): the
    weight is an empty meta tensor, its shape and dtype alone."""
    full = ((layers,) if layers else ()) + tuple(shape)
    if is_meta(device, generator):
        return torch.empty(full, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    w = torch.randn(full, generator=generator, device=generator.device)
    # scaled in place: a second float32 copy of a stacked leaf (zamba2-7b's
    # in_proj is 16.9 GB in float32) would double the init's peak
    return w.mul_(scale).to(device=device or generator.device, dtype=dtype)


def rms_norm(x, weight, eps: float = 1e-5):
    """x · rsqrt(mean(x²) + eps) · weight, in float32, cast back to x's
    dtype.  Over processes x keeps its batch sharding alone and the gain
    is gathered, so the mean is over a whole row."""
    x, weight = batch_only(x), gathered(weight)
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding (halves rotated).  x: [..., S, H, D]; positions:
    [..., S] integers."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs          # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                  # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_mlp(generator, d_model: int, d_ff: int, dtype, *, layers: int = 0,
             device=None):
    """SwiGLU weights {w_gate, w_up: [d, f], w_down: [f, d]} (stacked over
    `layers` when > 0)."""
    kw = dict(layers=layers, device=device)
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), dtype, **kw),
        "w_up": dense_init(generator, (d_model, d_ff), dtype, **kw),
        "w_down": dense_init(generator, (d_ff, d_model), dtype, **kw),
    }


def mlp_forward(p, x, dp=None):
    """SwiGLU MLP: (silu(x·W_gate) ⊙ x·W_up)·W_down.

    `dp` optionally carries a stale offset (the structure of `p`); every
    GEMM then runs in the shared/delta split form (`delta_einsum`).
    """
    gate = F.silu(delta_einsum("...d,df->...f", x, p["w_gate"],
                               dget(dp, "w_gate")))
    up = delta_einsum("...d,df->...f", x, p["w_up"], dget(dp, "w_up"))
    return delta_einsum("...f,fd->...d", gate * up, p["w_down"],
                        dget(dp, "w_down"))


def embed_lookup(table, tokens):
    """``table[tokens]``; over processes a lookup of the batch-sharded
    tokens in the table gathered whole (`F.embedding`, whose backward sums
    into the table's gradient)."""
    if isinstance(table, DTensor):
        return F.embedding(batch_only(tokens), gathered(table))
    return table[tokens]


def init_embedding(generator, vocab: int, d_model: int, dtype, device=None):
    """[vocab, d_model] embedding, 0.02 · N(0, 1)."""
    return dense_init(generator, (vocab, d_model), dtype, scale=0.02,
                      device=device)
