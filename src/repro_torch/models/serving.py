"""Serving runtime: prefill (full sequence → cache) and single-token decode
for the decoders, and `encode`, the encoder's full-sequence inference.

Ported from `repro.models.serving` (the GQA and MLA branches: the dense
decoders, the VLM and the MoE decoders) and from the encoder branch of
`repro.launch.steps.make_prefill_step`.  A VLM prefill takes the image
embeddings with its prompt tokens; decode then continues the text at
positions P + S_text + i.  The cache, its leaves stacked over layers, is
 - GQA: {"k": [L, B, W, Kv, hd], "v": ...}, keys stored post-RoPE;
 - MLA: {"c": [L, B, W, r], "kr": [L, B, W, 64]}, the compressed latent
   and the shared rope key;
with W = attn_window when set (a ring buffer) else the longest sequence
served.  An MoE FFN routes with the reference's capacity factor, 1.25.

Unlike the reference, which is pure, `decode_step` writes the new entries
into the cache it is given (in place) and returns that same cache: the
reference's functional update copies the whole cache every layer and
step.  `pos` is a Python int.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import mlp_forward, rms_norm
from repro_torch.models.transformer import _embed_inputs, layer_views, unembed
from repro_torch.utils.device import resolve_device


def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    """Slots per layer of a cache that serves `max_seq` positions."""
    return min(max_seq, cfg.attn_window) if cfg.attn_window > 0 else max_seq


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device=None):
    """A zero cache on `device` (the card unless the caller passes
    another): {k, v: [L, B, W, Kv, hd]}, or for MLA {c: [L, B, W, r],
    kr: [L, B, W, 64]}."""
    device = resolve_device(device)
    lead = (cfg.num_layers, batch_size, cache_len(cfg, max_seq))
    if cfg.use_mla:
        shapes = {"c": lead + (cfg.kv_lora_rank,),
                  "kr": lead + (attn.MLA_ROPE_DIM,)}
    else:
        shapes = dict.fromkeys(("k", "v"), lead + (cfg.num_kv_heads, cfg.hd))
    dt = dtype or cfg.dtype
    return {nm: torch.zeros(shape, dtype=dt, device=device)
            for nm, shape in shapes.items()}


def grow_cache(cfg: ModelConfig, cache, max_seq: int):
    """A decode cache of `cache_len(cfg, max_seq)` slots holding a prefill
    cache of S positions.  Without a window, position p goes to slot p.
    With one, the last min(S, W) positions go to their ring slots p % W,
    where decode will look for them and overwrite the oldest first.  (The
    reference's `launch/serve.py` places them from slot 0, which matches the
    ring only when W divides S.)  Either layout: GQA's k, v or MLA's c,
    kr."""
    first = next(iter(cache.values()))
    L, B, S = first.shape[:3]
    out = init_cache(cfg, B, max_seq, dtype=first.dtype, device=first.device)
    W = next(iter(out.values())).shape[2]
    if cfg.attn_window > 0:
        n = min(S, W)
        slots = torch.arange(S - n, S, device=first.device) % W
        for name in out:
            out[name][:, :, slots] = cache[name][:, :, S - n:]
    else:
        if S > W:
            raise ValueError(f"a prefill of {S} positions does not fit "
                             f"{W} slots")
        for name in out:
            out[name][:, :, :S] = cache[name]
    return out


def _ffn(lp, cfg, x):
    """The layer's FFN on x (normed): the MoE (its aux loss dropped, as
    serving drops it) or the SwiGLU MLP."""
    if cfg.is_moe:
        return moe_mod.moe_forward(lp["moe"], cfg, x)[0]
    return mlp_forward(lp["mlp"], x)


def _serve_stack(params, cfg, batch, keep_cache):
    """The layers over the embedded batch with attention through
    `ops.attention` (the flash kernel on the card) → (logits [B, S, V],
    {name: the per-layer cache entries} if `keep_cache`: GQA's post-RoPE
    keys and values, MLA's c and kr)."""
    x, positions = _embed_inputs(params, cfg, batch)
    prefill_attn = attn.mla_prefill if cfg.use_mla else attn.gqa_prefill
    entries = {}
    for lp in layer_views(params["layers"]):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, kv = prefill_attn(lp["attn"], cfg, h, positions)
        x = x + a
        x = x + _ffn(lp, cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))
        if keep_cache:
            for name, t in kv.items():
                entries.setdefault(name, []).append(t)
    return unembed(params, cfg, x), entries


def prefill(params, cfg: ModelConfig, batch):
    """Full-sequence forward that also builds the cache: `batch` holds
    `tokens` [B, S], and for the VLM `image_embeds` [B, P, F] before them.

    Returns (logits [B, S, V], cache {k, v: [L, B, S, Kv, hd]} or, for
    MLA, {c: [L, B, S, r], kr: [L, B, S, 64]}), S counting the image
    tokens.
    """
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.name} is encoder-only")
    logits, entries = _serve_stack(params, cfg, batch, True)
    return logits, {name: torch.stack(ts) for name, ts in entries.items()}


def encode(params, cfg: ModelConfig, batch):
    """The encoder's inference forward: `frames` [B, S, F] → logits
    [B, S, V], each layer's attention through `ops.attention` with the
    config's mask (bidirectional for hubert), no cache.  A bidirectional
    row sees every key, so the kernel and the training path's `_sdpa`
    compute the same attention.  Raises for a decoder (use `prefill`)."""
    if cfg.supports_decode():
        raise ValueError(f"{cfg.name} is a decoder: serve it with prefill "
                         f"and decode_step")
    return _serve_stack(params, cfg, batch, False)[0]


def decode_step(params, cfg: ModelConfig, token, cache, pos: int):
    """One decode step.  token: [B, 1] integers; `pos` the token's position.

    Writes layer l's new entries into cache[name][l] in place (GQA's key
    and value, MLA's c and kr); returns (logits [B, 1, V], cache).
    """
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.name} is encoder-only")
    decode_attn = attn.mla_decode if cfg.use_mla else attn.gqa_decode
    x = params["embed"][token]
    for i, lp in enumerate(layer_views(params["layers"])):
        layer_cache = {name: t[i] for name, t in cache.items()}
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = decode_attn(lp["attn"], cfg, h, layer_cache, pos)
        x = x + a
        x = x + _ffn(lp, cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))
    return unembed(params, cfg, x), cache
