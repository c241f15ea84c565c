"""Serving runtime: prefill (full sequence → cache) and single-token decode
for the decoders, and `encode`, the encoder's full-sequence inference.

Ported from `repro.models.serving` (the GQA branch, the dense decoders and
the VLM) and from the encoder branch of `repro.launch.steps.
make_prefill_step`.  A VLM prefill takes the image embeddings with its
prompt tokens; decode then continues the text at positions P + S_text + i.
The cache is
{"k": [L, B, W, Kv, hd], "v": ...} with W = attn_window when set (a ring
buffer) else the longest sequence served; keys are stored post-RoPE.

Unlike the reference, which is pure, `decode_step` writes the new key and
value into the cache it is given (in place) and returns that same cache:
the reference's functional update copies the whole cache every layer and
step.  `pos` is a Python int.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp_forward, rms_norm
from repro_torch.models.transformer import _embed_inputs, layer_views, unembed
from repro_torch.utils.device import resolve_device


def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    """Slots per layer of a cache that serves `max_seq` positions."""
    return min(max_seq, cfg.attn_window) if cfg.attn_window > 0 else max_seq


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device=None):
    """A zero cache {k, v: [L, B, W, Kv, hd]} on `device` (the card unless
    the caller passes another)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch_size, cache_len(cfg, max_seq),
             cfg.num_kv_heads, cfg.hd)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def grow_cache(cfg: ModelConfig, cache, max_seq: int):
    """A decode cache of `cache_len(cfg, max_seq)` slots holding a prefill
    cache of S positions.  Without a window, position p goes to slot p.
    With one, the last min(S, W) positions go to their ring slots p % W,
    where decode will look for them and overwrite the oldest first.  (The
    reference's `launch/serve.py` places them from slot 0, which matches the
    ring only when W divides S.)"""
    L, B, S = cache["k"].shape[:3]
    out = init_cache(cfg, B, max_seq, dtype=cache["k"].dtype,
                     device=cache["k"].device)
    W = out["k"].shape[2]
    if cfg.attn_window > 0:
        n = min(S, W)
        slots = torch.arange(S - n, S, device=cache["k"].device) % W
        for name in ("k", "v"):
            out[name][:, :, slots] = cache[name][:, :, S - n:]
    else:
        if S > W:
            raise ValueError(f"a prefill of {S} positions does not fit "
                             f"{W} slots")
        for name in ("k", "v"):
            out[name][:, :, :S] = cache[name]
    return out


def _serve_stack(params, cfg, batch, keep_cache):
    """The layers over the embedded batch with attention through
    `ops.attention` (the flash kernel on the card) → (logits [B, S, V],
    the per-layer post-RoPE keys and values if `keep_cache`)."""
    x, positions = _embed_inputs(params, cfg, batch)
    ks, vs = [], []
    for lp in layer_views(params["layers"]):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, kv = attn.gqa_prefill(lp["attn"], cfg, h, positions)
        x = x + a
        x = x + mlp_forward(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
        if keep_cache:
            ks.append(kv["k"])
            vs.append(kv["v"])
    return unembed(params, cfg, x), (ks, vs)


def prefill(params, cfg: ModelConfig, batch):
    """Full-sequence forward that also builds the cache: `batch` holds
    `tokens` [B, S], and for the VLM `image_embeds` [B, P, F] before them.

    Returns (logits [B, S, V], cache {k, v: [L, B, S, Kv, hd]}), S counting
    the image tokens.
    """
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.name} is encoder-only")
    logits, (ks, vs) = _serve_stack(params, cfg, batch, True)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


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

    Writes layer l's new key and value into cache["k"][l] / cache["v"][l]
    in place; returns (logits [B, 1, V], cache).
    """
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.name} is encoder-only")
    x = params["embed"][token]
    for i, lp in enumerate(layer_views(params["layers"])):
        kv = {"k": cache["k"][i], "v": cache["v"][i]}
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attn.gqa_decode(lp["attn"], cfg, h, kv, pos)
        x = x + a
        x = x + mlp_forward(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
    return unembed(params, cfg, x), cache
