"""Attention: GQA (llama family) and MLA (deepseek-v2), each with
full-sequence, prefill and decode paths.

Ported from `repro.models.attention`.

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

MLA caches the compressed latent c [B, S, r] and the shared rope key kr
[B, S, 64] (decoupled RoPE, as in DeepSeek-V2).  Its full-sequence paths
fold the rope columns into the head dim, hd + 64 (192 at deepseek-v2's
width), and pad V with 64 zero columns, as the reference does, so prefill
attends through the flash kernel at that head dim and slices the output
back to hd columns.  Its decode is the reference's absorbed form (q
projected into latent space, scores and values over the latent cache), in
plain PyTorch: no kernel computes it on either side.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (delta_einsum, dense_init, dget,
                                       rms_norm, rope)
from repro_torch.sharding.rules import batch_only, constrain, write_rows
from repro_torch.utils.trees import tree_map

NEG_INF = -1e30
MLA_ROPE_DIM = 64        # the reference's dr: the shared rope key's width


def init_attention(generator, cfg, *, layers: int = 0, device=None):
    """GQA: {wq: [d, H, hd], wk, wv: [d, Kv, hd], wo: [H, hd, d]}; MLA:
    {wq_nope: [d, H, hd], wq_rope: [d, H, 64], w_dkv: [d, r], kv_norm:
    ones [r], w_uk, w_uv: [r, H, hd], w_kr: [d, 64], wo: [H, hd, d]};
    stacked over `layers` when > 0."""
    d, H, Kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    kw = dict(layers=layers, device=device)
    if cfg.use_mla:
        r, dr = cfg.kv_lora_rank, MLA_ROPE_DIM
        norm = ((layers,) if layers else ()) + (r,)
        return {
            "wq_nope": dense_init(generator, (d, H, hd), cfg.dtype, **kw),
            "wq_rope": dense_init(generator, (d, H, dr), cfg.dtype, **kw),
            "w_dkv": dense_init(generator, (d, r), cfg.dtype, **kw),
            "kv_norm": torch.ones(norm, dtype=cfg.dtype,
                                  device=device or generator.device),
            "w_uk": dense_init(generator, (r, H, hd), cfg.dtype, **kw),
            "w_uv": dense_init(generator, (r, H, hd), cfg.dtype, **kw),
            "w_kr": dense_init(generator, (d, dr), cfg.dtype, **kw),
            "wo": dense_init(generator, (H, hd, d), cfg.dtype, **kw),
        }
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
    q, k, v = batch_only(q), batch_only(k), batch_only(v)
    qh = q.reshape(B, S, Kv, group, hd)
    k32, v32 = k.float(), v.float()
    kpos = torch.arange(Sk, device=q.device)[None, :]

    def block(q_blk, q_start):
        c = q_blk.shape[1]
        s = torch.einsum("bckgh,bskh->bckgs", q_blk.float(), k32) * scale
        s = constrain(s, "attn")   # batch → data, q chunk → model
        qpos = (q_start + q_offset
                + torch.arange(c, device=q.device)[:, None])
        mask = torch.ones((c, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        o = torch.einsum("bckgs,bskh->bckgh", torch.softmax(s, dim=-1), v32)
        return constrain(o.to(q.dtype), "attn")

    if S <= chunk:
        out = batch_only(block(qh, 0))
    else:
        if S % chunk:
            raise ValueError(f"{S} queries do not split into chunks of "
                             f"{chunk}")
        out = torch.cat([batch_only(block(qh[:, i:i + chunk], i))
                         for i in range(0, S, chunk)], dim=1)
    return out.reshape(B, S, H, hd)


def _heads(t):
    """[B, S, H, hd] → a [B, H, S, hd] view (no copy)."""
    return t.permute(0, 2, 1, 3)


def _qkv(p, cfg, x, positions):
    q = delta_einsum("bsd,dhk->bshk", x, p["wq"])
    k = delta_einsum("bsd,dhk->bshk", x, p["wk"])
    v = delta_einsum("bsd,dhk->bshk", x, p["wv"])
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _attend_and_project(p, cfg, q, k, v):
    o = ops.attention(_heads(q), _heads(k), _heads(v), causal=cfg.causal,
                      window=cfg.attn_window)
    return delta_einsum("bshk,hkd->bsd", _heads(o), p["wo"])


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
    write_rows(cache["k"], 1, slot, k)
    write_rows(cache["v"], 1, slot, v)
    if windowed:
        # ring buffer: every written slot lies in the window, in any order
        n, causal = min(pos + 1, W), False
    else:
        n, causal = pos + 1, True
    o = ops.attention(_heads(q), _heads(cache["k"][:, :n]),
                      _heads(cache["v"][:, :n]), causal=causal, window=0)
    out = delta_einsum("bshk,hkd->bsd", _heads(o), p["wo"])
    return out, cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v2)
# ---------------------------------------------------------------------------

def _mla_qkv(p, cfg, x, positions):
    """The non-absorbed MLA projections of x [B, S, d] → (q, k, v) with the
    rope columns folded into the head dim, [B, S, H, hd + 64] each (v
    padded with zeros), and the cache entries c [B, S, r], kr [B, S, 64]."""
    B, S, _ = x.shape
    H = cfg.num_heads
    c = rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dkv"]), p["kv_norm"],
                 cfg.norm_eps)
    k_nope = torch.einsum("bsr,rhk->bshk", c, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c, p["w_uv"])
    k_rope = rope(torch.einsum("bsd,dk->bsk", x, p["w_kr"])[:, :, None, :],
                  positions, cfg.rope_theta)                    # [B, S, 1, dr]
    q_nope = torch.einsum("bsd,dhk->bshk", x, p["wq_nope"])
    q_rope = rope(torch.einsum("bsd,dhk->bshk", x, p["wq_rope"]), positions,
                  cfg.rope_theta)
    dr = k_rope.shape[-1]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    v = torch.nn.functional.pad(v, (0, dr))
    return q, k, v, c, k_rope[:, :, 0, :]


def mla_forward(p, cfg, x, positions, dp=None):
    """MLA over the full sequence (the training path), attention through
    `_sdpa`, never the flash kernel, which has no backward.  `dp` (the
    event's stale offset) is folded into effective weights, as in the
    reference: the latent c feeds K and V through an rms_norm, so a
    shared/delta split of the products would not commute through it."""
    if dp is not None:
        p = tree_map(lambda w, dl: w + dl, p, dp)
    q, k, v, _, _ = _mla_qkv(p, cfg, x, positions)
    o = _sdpa(q, k, v, causal=cfg.causal, window=cfg.attn_window)
    return torch.einsum("bshk,hkd->bsd", o[..., :cfg.hd], p["wo"])


def mla_prefill(p, cfg, x, positions):
    """MLA over the full sequence through the flash kernel at head dim
    hd + 64 (scale 1/√(hd + 64), as the reference's `_sdpa` of the folded
    q, k takes it), the output sliced back to hd columns; and the cache
    {c: [B, S, r], kr: [B, S, 64]}."""
    q, k, v, c, kr = _mla_qkv(p, cfg, x, positions)
    o = ops.attention(_heads(q), _heads(k), _heads(v), causal=cfg.causal,
                      window=cfg.attn_window)
    out = torch.einsum("bshk,hkd->bsd", _heads(o)[..., :cfg.hd], p["wo"])
    return out, {"c": c, "kr": kr}


def mla_decode(p, cfg, x, cache, pos: int):
    """Absorbed MLA decode: the query projected into latent space, scores
    and values over the latent cache, in float32.  x: [B, 1, d]; cache
    {c: [B, W, r], kr: [B, W, 64]}; `pos` the token's position (a Python
    int).

    Writes c and kr IN PLACE at slot pos (pos % W for a ring buffer, when
    `cfg.attn_window` > 0), as `gqa_decode` does, and attends over the
    written slots only (the reference masks the others to −1e30, whose
    weights are exactly 0).  Returns (out [B, 1, d], cache).
    """
    B = x.shape[0]
    W = cache["c"].shape[1]
    hd = cfg.hd
    posv = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    c_t = rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dkv"]), p["kv_norm"],
                   cfg.norm_eps)
    kr_t = rope(torch.einsum("bsd,dk->bsk", x, p["w_kr"])[:, :, None, :],
                posv, cfg.rope_theta)[:, :, 0, :]
    windowed = cfg.attn_window > 0
    slot = pos % W if windowed else pos
    cache["c"][:, slot] = c_t[:, 0]
    cache["kr"][:, slot] = kr_t[:, 0]
    n = min(pos + 1, W) if windowed else pos + 1
    cc, ckr = cache["c"][:, :n], cache["kr"][:, :n]

    q_nope = torch.einsum("bd,dhk->bhk", x[:, 0], p["wq_nope"].to(x.dtype))
    q_rope = rope(torch.einsum("bsd,dhk->bshk", x, p["wq_rope"]), posv,
                  cfg.rope_theta)[:, 0]                         # [B, H, dr]
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope, p["w_uk"])     # absorb w_uk
    scale = 1.0 / ((hd + q_rope.shape[-1]) ** 0.5)
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), cc.float())
         + torch.einsum("bhk,bsk->bhs", q_rope.float(), ckr.float())) * scale
    pattn = torch.softmax(s, dim=-1)
    lat = torch.einsum("bhs,bsr->bhr", pattn, cc.float()).to(x.dtype)
    o = torch.einsum("bhr,rhk->bhk", lat, p["w_uv"])            # absorb w_uv
    out = torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None, :]
    return out, cache
