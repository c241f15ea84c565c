"""GQA attention (llama family) with full-sequence, prefill and decode paths.

Ported from `repro.models.attention` (the GQA half; MLA waits).

Conventions, as in the reference:
 - keys are stored in the cache *post-RoPE*, so a ring-buffer overwrite
   (sliding-window decode) is safe;
 - when `cfg.attn_window > 0` the decode cache is a ring buffer of exactly
   `window` slots, written at pos % window.

The full-sequence path the training loss differentiates (`gqa_forward`)
runs the reference's exact, q-chunked `_sdpa` in plain PyTorch ops: scores
and P·V in float32, masked scores set to −1e30 (a row with no visible key
averages V uniformly), chunks of 512 queries above 512.  Autograd and
`torch.func.vmap` go through it, and the reference trains through it too:
neither package has a backward kernel for flash attention.

Serving (prefill and decode) calls `kernels.ops.attention`: the
hand-written flash-attention kernel on the card, its plain version on the
CPU.  It takes [B, H, L, D] tensors, so the model passes permuted *views*
of its [B, S, H, hd] activations and cache; the kernel honours their
strides, so nothing is transposed or copied.  Decode is the kernel with
Lq = 1 over a view of the cache's valid slots: the query sits at the end
of the kv axis, which is the kernel's own semantics.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import delta_einsum, dense_init, dget, rope

NEG_INF = -1e30


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


def _sdpa(q, k, v, *, causal, window, q_offset=0, chunk=512):
    """q: [B, S, H, hd]; k, v: [B, Sk, Kv, hd] → [B, S, H, hd] in q's dtype.

    Exact softmax attention, the queries at positions q_offset .. q_offset
    + S − 1 of the key axis, in float32; masked scores are −1e30, so a row
    with no visible key averages every value (the flash kernel gives 0
    there).  For S > chunk the query axis runs in chunks of `chunk` (S
    must be a multiple of it), which bounds the scores to [chunk, Sk].
    """
    B, S, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    group = H // Kv
    scale = 1.0 / (hd ** 0.5)
    qh = q.reshape(B, S, Kv, group, hd)
    k32, v32 = k.float(), v.float()
    kpos = torch.arange(Sk, device=q.device)[None, :]

    def block(q_blk, q_start):
        c = q_blk.shape[1]
        s = torch.einsum("bckgh,bskh->bckgs", q_blk.float(), k32) * scale
        qpos = (q_start + q_offset
                + torch.arange(c, device=q.device)[:, None])
        mask = torch.ones((c, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        o = torch.einsum("bckgs,bskh->bckgh", torch.softmax(s, dim=-1), v32)
        return o.to(q.dtype)

    if S <= chunk:
        out = block(qh, 0)
    else:
        if S % chunk:
            raise ValueError(f"{S} queries do not split into chunks of "
                             f"{chunk}")
        out = torch.cat([block(qh[:, i:i + chunk], i)
                         for i in range(0, S, chunk)], dim=1)
    return out.reshape(B, S, H, hd)


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


def gqa_forward(p, cfg, x, positions, dp=None):
    """Full-sequence attention (the training path).  x: [B, S, d];
    positions: [B, S].

    `dp` optionally carries a stale offset; the four projections then run
    in the shared/delta split form (`delta_einsum`).  Attention is `_sdpa`,
    never the flash kernel, which has no backward.
    """
    q = delta_einsum("bsd,dhk->bshk", x, p["wq"], dget(dp, "wq"))
    k = delta_einsum("bsd,dhk->bshk", x, p["wk"], dget(dp, "wk"))
    v = delta_einsum("bsd,dhk->bshk", x, p["wv"], dget(dp, "wv"))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = _sdpa(q, k, v, causal=cfg.causal, window=cfg.attn_window)
    return delta_einsum("bshk,hkd->bsd", o, p["wo"], dget(dp, "wo"))


def gqa_prefill(p, cfg, x, positions):
    """Full-sequence attention through the flash kernel, and the
    (post-RoPE) cache {k, v: [B, S, Kv, hd]}."""
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
