"""GQA attention (llama family) with full-sequence, prefill and decode paths.

Ported from `repro.models.attention` (the GQA half; MLA waits).

Conventions, as in the reference:
 - keys are stored in the cache *post-RoPE*, so a ring-buffer overwrite
   (sliding-window decode) is safe;
 - when `cfg.attn_window > 0` the decode cache is a ring buffer of exactly
   `window` slots, written at pos % window.

Where the reference runs its q-chunked `_sdpa` (prefill) or einsums over the
whole cache under a validity mask (decode), the port calls `kernels.ops.
attention`: the hand-written flash-attention kernel on the card, its plain
version on the CPU.  It takes [B, H, L, D] tensors, so the model passes
permuted *views* of its [B, S, H, hd] activations and cache; the kernel
honours their strides, so nothing is transposed or copied.  Decode is the
kernel with Lq = 1 over a view of the cache's valid slots: the query sits at
the end of the kv axis, which is the kernel's own semantics.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rope


def init_attention(generator, cfg, *, layers: int = 0, device=None):
    """{wq: [d, H, hd], wk, wv: [d, Kv, hd], wo: [H, hd, d]}, stacked over
    `layers` when > 0."""
    d, H, Kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    kw = dict(layers=layers, device=device)
    return {
        "wq": dense_init(generator, (d, H, hd), cfg.dtype, **kw),
        "wk": dense_init(generator, (d, Kv, hd), cfg.dtype, **kw),
        "wv": dense_init(generator, (d, Kv, hd), cfg.dtype, **kw),
        "wo": dense_init(generator, (H, hd, d), cfg.dtype, **kw),
    }


def _heads(t):
    """[B, S, H, hd] → a [B, H, S, hd] view (no copy)."""
    return t.permute(0, 2, 1, 3)


def _qkv(p, cfg, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _attend_and_project(p, cfg, q, k, v):
    o = ops.attention(_heads(q), _heads(k), _heads(v), causal=cfg.causal,
                      window=cfg.attn_window)
    return torch.einsum("bshk,hkd->bsd", _heads(o), p["wo"])


def gqa_forward(p, cfg, x, positions):
    """Full-sequence attention.  x: [B, S, d]; positions: [B, S]."""
    q, k, v = _qkv(p, cfg, x, positions)
    return _attend_and_project(p, cfg, q, k, v)


def gqa_prefill(p, cfg, x, positions):
    """Like `gqa_forward`, and also returns the (post-RoPE) cache
    {k, v: [B, S, Kv, hd]}."""
    q, k, v = _qkv(p, cfg, x, positions)
    return _attend_and_project(p, cfg, q, k, v), {"k": k, "v": v}


def gqa_decode(p, cfg, x, cache, pos: int):
    """One-token decode.  x: [B, 1, d]; cache k/v: [B, W, Kv, hd]; `pos` the
    token's position (a Python int).

    The new key and value are written into `cache` IN PLACE (slot pos % W
    for a ring buffer, else pos), unlike the reference, which returns a new
    cache: a copy of the whole cache per layer and step would cost as much
    as the attention.  Returns (out [B, 1, d], cache).
    """
    B = x.shape[0]
    W = cache["k"].shape[1]
    posv = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, cfg, x, posv)
    windowed = cfg.attn_window > 0
    slot = pos % W if windowed else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    if windowed:
        # ring buffer: every written slot lies in the window, in any order
        n, causal = min(pos + 1, W), False
    else:
        n, causal = pos + 1, True
    o = ops.attention(_heads(q), _heads(cache["k"][:, :n]),
                      _heads(cache["v"][:, :n]), causal=causal, window=0)
    out = torch.einsum("bshk,hkd->bsd", _heads(o), p["wo"])
    return out, cache
