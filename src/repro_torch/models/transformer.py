"""The dense decoder stack: [ln→GQA→res, ln→SwiGLU→res] × L.

Ported from `repro.models.transformer` (the dense family; the MoE, SSM,
hybrid, audio and VLM families and the training loss wait).  Parameters are
a plain dict of tensors with the reference's structure and its stacked
[L, ...] layer leaves, so weights carry across one to one
(`utils.convert.lm_params_from_numpy`).  The reference's `lax.scan` over
layers is a Python loop that indexes the stacked leaves (views, no copies).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, init_embedding, init_mlp,
                                       mlp_forward, rms_norm)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import tree_map


def init_model(generator: torch.Generator, cfg: ModelConfig, device=None):
    """Random weights at the reference's scales (N(0, 1/fan_in), embedding
    and unembedding 0.02, norm gains 1) in `cfg.dtype`, on `device` (the
    card unless the caller passes another).  Draws come from `generator`, on
    its own device: a CUDA generator keeps a full-width init on the card."""
    device = resolve_device(device)
    L, d, dt = cfg.num_layers, cfg.d_model, cfg.dtype
    kw = dict(device=device)
    params: Dict[str, Any] = {
        "embed": init_embedding(generator, cfg.padded_vocab, d, dt, **kw),
        "final_norm": torch.ones(d, dtype=dt, device=device),
        "unembed": dense_init(generator, (d, cfg.padded_vocab), dt,
                              scale=0.02, **kw),
    }
    params["layers"] = {
        "ln1": torch.ones(L, d, dtype=dt, device=device),
        "attn": attn.init_attention(generator, cfg, layers=L, **kw),
        "ln2": torch.ones(L, d, dtype=dt, device=device),
        "mlp": init_mlp(generator, d, cfg.d_ff, dt, layers=L, **kw),
    }
    return params


def layer(params, i: int):
    """Layer `i`'s parameters: views into the stacked [L, ...] leaves."""
    return tree_map(lambda t: t[i], params["layers"])


def _attn_block(lp, cfg, x, positions):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + attn.gqa_forward(lp["attn"], cfg, h, positions)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_forward(lp["mlp"], h)


def _embed_inputs(params, cfg, batch):
    """→ (x [B, S, d], positions [B, S]) for a batch of `tokens` [B, S]."""
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    return x, pos


def mask_vocab_pad(cfg: ModelConfig, logits):
    """−∞ (−1e30) in the padded logit columns (no-op when the vocab is
    already a multiple of 128)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
    return torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                         device=logits.device), logits)


def unembed(params, cfg, x):
    """Final norm and unembedding: x [B, S, d] → masked logits [B, S, V]."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params["unembed"])
    return mask_vocab_pad(cfg, logits)


def forward(params, cfg: ModelConfig, batch):
    """Full-sequence forward → (logits [B, S, V], moe_aux).  The dense
    family has no MoE, so moe_aux is 0.0, as in the reference."""
    x, positions = _embed_inputs(params, cfg, batch)
    for i in range(cfg.num_layers):
        x = _attn_block(layer(params, i), cfg, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params, cfg, x), aux
