"""Serving runtime: prefill (full sequence → cache) and single-token decode
for the decoders, and `encode`, the encoder's full-sequence inference.

Ported from `repro.models.serving` (every decoder family: the dense
decoders, the VLM, the MoE decoders with GQA or MLA, the SSM and the
hybrid) and from the encoder branch of
`repro.launch.steps.make_prefill_step`.  A VLM prefill takes the image
embeddings with its prompt tokens; decode then continues the text at
positions P + S_text + i.  The cache, its leaves stacked over layers, is
 - GQA: {"k": [L, B, W, Kv, hd], "v": ...}, keys stored post-RoPE;
 - MLA: {"c": [L, B, W, r], "kr": [L, B, W, 64]}, the compressed latent
   and the shared rope key;
 - SSM: {"h": [L, B, H, P, N] float32 whatever the weights' dtype,
   "conv": [L, B, W_conv − 1, conv_dim]}, O(1) state a layer;
 - hybrid: {"mamba": the SSM cache over the L layers, "attn": a GQA cache
   over the n_groups applications of the shared block};
with W = attn_window when set (a ring buffer) else the longest sequence
served.  An MoE FFN routes with the reference's capacity factor, 1.25.

Unlike the reference, which is pure, `decode_step` writes the new entries
into the cache it is given (in place: an attention layer's slot, an SSM
layer's whole state) and returns that same cache: the reference's
functional update copies the whole cache every layer and step.  `pos` is
a Python int.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import embed_lookup, mlp_forward, rms_norm
from repro_torch.models.transformer import (_embed_inputs, hybrid_split,
                                            layer_views, shared_after,
                                            unembed)
from repro_torch.sharding.rules import (cache_shardings, constrain,
                                        get_mesh_context, write_rows,
                                        zeros_placed)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import unflatten


def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    """Slots per layer of a cache that serves `max_seq` positions."""
    return min(max_seq, cfg.attn_window) if cfg.attn_window > 0 else max_seq


def _attn_cache(cfg, L, B, W, dt, device):
    """A zero attention cache of L layers and W slots: GQA's {k, v: [L, B,
    W, Kv, hd]} or MLA's {c: [L, B, W, r], kr: [L, B, W, 64]}."""
    if cfg.use_mla:
        shapes = {"c": (L, B, W, cfg.kv_lora_rank),
                  "kr": (L, B, W, attn.MLA_ROPE_DIM)}
    else:
        shapes = dict.fromkeys(("k", "v"),
                               (L, B, W, cfg.num_kv_heads, cfg.hd))
    return {nm: torch.zeros(shape, dtype=dt, device=device)
            for nm, shape in shapes.items()}


def _ssm_cache(cfg, L, B, dt, device):
    """A zero SSM state of L layers: h float32 whatever `dt`, conv in
    `dt`."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {"h": torch.zeros((L, B, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((L, B, cfg.conv_width - 1, conv_dim),
                                dtype=dt, device=device)}


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device=None):
    """A zero cache on `device` (the card unless the caller passes
    another), of the family's layout (the module docstring)."""
    device = resolve_device(device)
    dt = dtype or cfg.dtype
    L, B, W = cfg.num_layers, batch_size, cache_len(cfg, max_seq)
    if cfg.arch_type == "ssm":
        return _ssm_cache(cfg, L, B, dt, device)
    if cfg.arch_type == "hybrid":
        return {"mamba": _ssm_cache(cfg, L, B, dt, device),
                "attn": _attn_cache(cfg, hybrid_split(cfg)[1], B, W, dt,
                                    device)}
    return _attn_cache(cfg, L, B, W, dt, device)


def grow_cache(cfg: ModelConfig, cache, max_seq: int):
    """A decode cache of `cache_len(cfg, max_seq)` slots holding a prefill
    cache of S positions.  Without a window, position p goes to slot p.
    With one, the last min(S, W) positions go to their ring slots p % W,
    where decode will look for them and overwrite the oldest first.  (The
    reference's `launch/serve.py` places them from slot 0, which matches the
    ring only when W divides S.)  Either attention layout: GQA's k, v or
    MLA's c, kr.  An SSM state has no slots and passes through as it is;
    the hybrid grows its attention part only, as the reference's
    `launch/serve.py` does."""
    if cfg.arch_type == "ssm":
        return cache
    if cfg.arch_type == "hybrid":
        return {"mamba": cache["mamba"],
                "attn": _grow_attn(cfg, cache["attn"], max_seq)}
    return _grow_attn(cfg, cache, max_seq)


def _grow_attn(cfg, cache, max_seq):
    first = next(iter(cache.values()))
    L, B, S = first.shape[:3]
    W = cache_len(cfg, max_seq)
    mesh = get_mesh_context()
    if isinstance(first, DTensor) and mesh is not None:
        # over processes: made shard by shard, placed by `cache_specs`
        meta = _attn_cache(cfg, L, B, W, first.dtype, "meta")
        out = unflatten(meta, [
            zeros_placed(t.shape, t.dtype, sh) for t, sh in zip(
                meta.values(), cache_shardings(meta, mesh).values())])
    else:
        out = _attn_cache(cfg, L, B, W, first.dtype, first.device)
    if cfg.attn_window > 0:
        if isinstance(first, DTensor):
            raise ValueError("a ring-buffer cache is not placed over "
                             "processes")
        n = min(S, W)
        slots = torch.arange(S - n, S, device=first.device) % W
        for name in out:
            out[name][:, :, slots] = cache[name][:, :, S - n:]
    else:
        if S > W:
            raise ValueError(f"a prefill of {S} positions does not fit "
                             f"{W} slots")
        for name in out:
            write_rows(out[name], 2, 0, cache[name])
    return out


def _ffn(lp, cfg, x):
    """The layer's FFN on x (normed): the MoE (its aux loss dropped, as
    serving drops it) or the SwiGLU MLP."""
    if cfg.is_moe:
        return moe_mod.moe_forward(lp["moe"], cfg, x)[0]
    return mlp_forward(lp["mlp"], x)


def _mamba_decode(lp, cfg, x, cache, i):
    """One Mamba2 layer on one token; writes layer i's new state into the
    SSM cache {h, conv} in place."""
    out, st = ssm_mod.ssm_decode(
        lp["mamba"], cfg, rms_norm(x, lp["ln"], cfg.norm_eps),
        {"h": cache["h"][i], "conv": cache["conv"][i]})
    cache["h"][i] = st["h"]
    cache["conv"][i] = st["conv"]     # a new tensor: no overlapping copy
    return x + out


def _shared_serve(sp, cfg, x, emb0, attend, *args):
    """The hybrid's shared block in serving, its attention `attend(p, cfg,
    h, *args)`: `attention.gqa_prefill` or `gqa_decode`, through
    `ops.attention` → (out, cache entries)."""
    y = torch.einsum("bsd,dk->bsk", torch.cat([x, emb0], dim=-1),
                     sp["in_proj"])
    a, kv = attend(sp["attn"], cfg, rms_norm(y, sp["ln1"], cfg.norm_eps),
                   *args)
    y = y + a
    y = y + mlp_forward(sp["mlp"], rms_norm(y, sp["ln2"], cfg.norm_eps))
    return x + y, kv


def _ssm_stack(params, cfg, x, positions, keep_cache):
    """Prefill of the SSM and hybrid families over the embedded x → (x,
    the cache's entries {h, conv} and for the hybrid the shared block's
    {k, v} per application)."""
    emb0, entries = x, {}
    for i, lp in enumerate(layer_views(params["layers"])):
        out, st = ssm_mod.ssm_forward(lp["mamba"], cfg,
                                      rms_norm(x, lp["ln"], cfg.norm_eps),
                                      return_state=True)
        x = x + out
        if keep_cache:
            for name, t in st.items():
                entries.setdefault(name, []).append(t)
        if shared_after(cfg, i):
            x, kv = _shared_serve(params["shared"], cfg, x, emb0,
                                  attn.gqa_prefill, positions)
            if keep_cache:
                for name, t in kv.items():
                    entries.setdefault(name, []).append(t)
    return x, entries


def _serve_stack(params, cfg, batch, keep_cache):
    """The layers over the embedded batch with attention through
    `ops.attention` (the flash kernel on the card) → (logits [B, S, V],
    {name: the per-layer cache entries} if `keep_cache`: GQA's post-RoPE
    keys and values, MLA's c and kr, an SSM layer's h and conv)."""
    x, positions = _embed_inputs(params, cfg, batch)
    x = constrain(x, "bsd")
    if cfg.arch_type in ("ssm", "hybrid"):
        x, entries = _ssm_stack(params, cfg, x, positions, keep_cache)
        return unembed(params, cfg, x), entries
    prefill_attn = attn.mla_prefill if cfg.use_mla else attn.gqa_prefill
    entries = {}
    for lp in layer_views(params["layers"]):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, kv = prefill_attn(lp["attn"], cfg, h, positions)
        x = x + a
        x = constrain(x + _ffn(lp, cfg, rms_norm(x, lp["ln2"], cfg.norm_eps)),
                      "bsd")
        if keep_cache:
            for name, t in kv.items():
                entries.setdefault(name, []).append(t)
    return unembed(params, cfg, x), entries


def prefill(params, cfg: ModelConfig, batch):
    """Full-sequence forward that also builds the cache: `batch` holds
    `tokens` [B, S], and for the VLM `image_embeds` [B, P, F] before them.

    Returns (logits [B, S, V], cache {k, v: [L, B, S, Kv, hd]} or, for
    MLA, {c: [L, B, S, r], kr: [L, B, S, 64]}), S counting the image
    tokens; for the SSM {h, conv} after the last position, and for the
    hybrid {"mamba": {h, conv}, "attn": {k, v: [n_groups, B, S, Kv,
    hd]}}.
    """
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.name} is encoder-only")
    logits, entries = _serve_stack(params, cfg, batch, True)
    cache = {name: torch.stack(ts) for name, ts in entries.items()}
    if cfg.arch_type == "hybrid":
        cache = {"mamba": {nm: cache[nm] for nm in ("h", "conv")},
                 "attn": {nm: cache[nm] for nm in ("k", "v")}}
    return logits, cache


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
    and value, MLA's c and kr, an SSM layer's h and conv; the hybrid's
    shared block its application's slot of cache["attn"]); returns
    (logits [B, 1, V], cache).  The hybrid's shared block takes the
    current token's embedding as its emb0, as in the reference.
    """
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.name} is encoder-only")
    if cfg.arch_type in ("ssm", "hybrid"):
        x = emb0 = params["embed"][token]
        k = cfg.hybrid_attn_every
        ssm_cache = cache if cfg.arch_type == "ssm" else cache["mamba"]
        for i, lp in enumerate(layer_views(params["layers"])):
            x = _mamba_decode(lp, cfg, x, ssm_cache, i)
            if shared_after(cfg, i):
                layer_cache = {nm: t[i // k]
                               for nm, t in cache["attn"].items()}
                x, _ = _shared_serve(params["shared"], cfg, x, emb0,
                                     attn.gqa_decode, layer_cache, pos)
        return unembed(params, cfg, x), cache
    decode_attn = attn.mla_decode if cfg.use_mla else attn.gqa_decode
    x = embed_lookup(params["embed"], token)
    for i, lp in enumerate(layer_views(params["layers"])):
        layer_cache = {name: t[i] for name, t in cache.items()}
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = decode_attn(lp["attn"], cfg, h, layer_cache, pos)
        x = x + a
        x = x + _ffn(lp, cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))
    return unembed(params, cfg, x), cache
