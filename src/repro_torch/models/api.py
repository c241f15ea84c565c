"""Batch construction, the training gradient and parameter counts.

Ported from `repro.models.api`: `make_batch` draws each family's batch
from an explicit `torch.Generator` (on its own device), `param_count`
counts weights.  `make_dict_grad_fn` is the reference's `launch/train.py`
gradient: `loss_fn`'s value and gradient over a dict batch, the round
trainer's ``grad_fn`` for every family (the audio and VLM batches carry
keys that `models.lm`'s token-only loss does not take).  It differs from
`core.round_trainer.make_grad_fn`, which unpacks a tuple batch into a
given loss.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import loss_fn
from repro_torch.utils.trees import leaves


def make_batch(cfg: ModelConfig, batch_size: int, seq_len: int,
               generator: torch.Generator):
    """A random batch of `cfg`'s family, drawn from `generator` on its
    device: {tokens, targets: [B, S] int64} uniform over the vocabulary
    (dense, moe, ssm, hybrid); {frames [B, S, F] normal in `cfg.dtype`,
    targets [B, S]} (audio); {tokens [B, S − P], image_embeds [B, P, F]
    normal in `cfg.dtype`, targets [B, S − P]} (vlm), where `seq_len` is
    the total length with the P = `cfg.num_image_tokens` image tokens and
    must exceed P."""
    kw = dict(generator=generator, device=generator.device)
    B, V = batch_size, cfg.vocab_size
    if cfg.arch_type == "audio":
        frames = torch.randn((B, seq_len, cfg.frame_embed_dim), **kw)
        return {"frames": frames.to(cfg.dtype),
                "targets": torch.randint(0, V, (B, seq_len), **kw)}
    if cfg.arch_type == "vlm":
        P = cfg.num_image_tokens
        if seq_len <= P:
            raise ValueError(f"{cfg.name}: a sequence of {seq_len} leaves no "
                             f"text after its {P} image tokens")
        tokens = torch.randint(0, V, (B, seq_len - P), **kw)
        image = torch.randn((B, P, cfg.image_embed_dim), **kw)
        return {"tokens": tokens, "image_embeds": image.to(cfg.dtype),
                "targets": torch.randint(0, V, (B, seq_len - P), **kw)}
    return {
        "tokens": torch.randint(0, V, (B, seq_len), **kw),
        "targets": torch.randint(0, V, (B, seq_len), **kw),
    }


def make_dict_grad_fn(cfg: ModelConfig):
    """``grad_fn(params, batch) -> (loss, grads)`` of `transformer.loss_fn`
    over a dict batch (`make_batch`'s keys with a leading client axis in
    the round trainer).  It carries no event-batched loss, so the round
    trainer's cotangent path refuses it, as the reference's does.

    The loss is the mean over the batch's own tokens (text tokens for the
    VLM) with no mask, so over a group of processes that each take an
    equal share of the rows (`sharding.rules.row_slice`) the mean of the
    processes' losses and gradients is the whole batch's, with no
    reweighting (`sharding.reduce.GroupMean`).  The MoE family's is not:
    its capacity and aux loss depend on every routed token."""
    vg = torch.func.grad_and_value(lambda p, b: loss_fn(p, cfg, b)[0])

    def grad_fn(params, batch):
        grads, loss = vg(params, batch)
        return loss, grads
    return grad_fn


def param_count(params) -> int:
    """Number of weights in a parameter tree."""
    return sum(t.numel() for t in leaves(params))
