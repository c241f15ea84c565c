"""Synthetic token-LM data, ported from `repro.data.tokens`.

Sequences from a fixed-seed, low-rank random Markov chain over the
vocabulary, P(next | cur) ∝ softmax(E[cur] · D / t), so that a language
model has signal to learn (its cross-entropy falls) with no data from
outside.  The law is the reference's; the draws come from a
`torch.Generator` on the given device, so the tokens differ from the JAX
generator's (the parity tests carry the reference's tokens across through
numpy instead).  A batch is a function of (seed, step) alone.  Tokens and
targets are int64, torch's index type.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Tuple

import torch

from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenDataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    rank: int = 32          # rank of the transition logits
    temperature: float = 1.0
    seed: int = 0


def _chain_params(cfg: TokenDataConfig, device):
    """The chain's factors E [V, rank] and D [rank, V], N(0, 1/rank)."""
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    scale = 1.0 / math.sqrt(cfg.rank)
    emb = torch.randn(cfg.vocab_size, cfg.rank, generator=g,
                      device=device) * scale
    dec = torch.randn(cfg.rank, cfg.vocab_size, generator=g,
                      device=device) * scale
    return emb, dec


def make_batch(cfg: TokenDataConfig, step: int,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch of `step`: (tokens [B, S], targets [B, S]), targets the
    tokens shifted by one, on `device` (the card unless the caller passes
    another).  The first token is uniform; each next one is drawn from
    the chain by the Gumbel-max trick."""
    device = resolve_device(device)
    emb, dec = _chain_params(cfg, device)
    g = torch.Generator(device=device).manual_seed(
        ((cfg.seed + 1) << 32) + step)
    B, V = cfg.batch_size, cfg.vocab_size
    cur = torch.randint(0, V, (B,), generator=g, device=device)
    seq = [cur]
    for _ in range(cfg.seq_len):
        logits = (emb[cur] @ dec) / cfg.temperature             # [B, V]
        u = torch.rand(B, V, generator=g, device=device)
        cur = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
        seq.append(cur)
    seq = torch.stack(seq, dim=1)                               # [B, S+1]
    return seq[:, :-1], seq[:, 1:]


def synthetic_token_batches(
        cfg: TokenDataConfig,
        device=None) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """`make_batch` of steps 0, 1, 2, ..."""
    step = 0
    while True:
        yield make_batch(cfg, step, device)
        step += 1
