"""Shared model layers: RMSNorm, RoPE, SwiGLU, embeddings.

Ported from `repro.models.layers`.  Pure functions over plain dicts of
tensors; initializers draw from an explicit `torch.Generator` and create
every weight in the config's dtype.  RMSNorm and RoPE upcast to float32
and cast back to the working dtype where the reference does, so bfloat16
rounds at the same places.  The GEMMs stay `torch.einsum`, as the
reference leaves them to XLA.  The stale-offset forms (`delta_einsum`,
`dget`, `eff`) wait for the LM training slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(generator: torch.Generator, shape, dtype, scale=None, *,
               layers: int = 0, device=None):
    """scale · N(0, 1) weights of `shape` in `dtype` on `device` (default:
    the generator's); scale defaults to 1/√shape[0] (fan-in).  With
    `layers` > 0 the weight is stacked: [layers, *shape], each layer with
    the same scale, as the reference's vmapped per-layer init gives."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    full = ((layers,) if layers else ()) + tuple(shape)
    w = torch.randn(full, generator=generator, device=generator.device)
    return (scale * w).to(device=device or generator.device, dtype=dtype)


def rms_norm(x, weight, eps: float = 1e-5):
    """x · rsqrt(mean(x²) + eps) · weight, in float32, cast back to x's
    dtype."""
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


def mlp_forward(p, x):
    """SwiGLU MLP: (silu(x·W_gate) ⊙ x·W_up)·W_down."""
    gate = F.silu(torch.einsum("...d,df->...f", x, p["w_gate"]))
    up = torch.einsum("...d,df->...f", x, p["w_up"])
    return torch.einsum("...f,fd->...d", gate * up, p["w_down"])


def init_embedding(generator, vocab: int, d_model: int, dtype, device=None):
    """[vocab, d_model] embedding, 0.02 · N(0, 1)."""
    return dense_init(generator, (vocab, d_model), dtype, scale=0.02,
                      device=device)
