"""LM loss adapters: the token decoders (dense, MoE, SSM and hybrid) in
the engine's loss convention.

Ported from `repro.models.lm`.  FRED (`sim.fred`) and the round trainer
(`core.round_trainer`) take

    loss(params, tokens, targets) -> scalar           (serial / fused path)
    loss.event_batched(W, deltas, tokens, targets) -> [K]   (cotangent path)

with `tokens` and `targets` [μ, S] ([K, μ, S] event-batched) and `deltas`
each event's detached stale offset δ_k = p_k − W ([K, ...] leaves).  The
event-batched form is `torch.func.vmap` over (δ_k, tokens_k, targets_k)
with W closed over, so W stays unbatched: every large GEMM and the
embedding gather run in the shared/delta split (`transformer.loss_fn` with
`deltas`), and the weight gradient contracts over the combined K·μ·S axis
without forming a [K, P] gradient batch.  `engine.
resolve_event_batched_loss` and `round_trainer.make_grad_fn` pick up
``loss.event_batched``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def make_lm_loss(cfg: ModelConfig, aux_weight: float = 0.01):
    """Scalar LM loss `(params, tokens, targets) -> loss` (CE + `aux_weight`
    · the MoE aux term) with its ``.event_batched`` shared/delta form
    attached."""

    def loss(params, tokens, targets):
        value, _ = transformer.loss_fn(
            params, cfg, {"tokens": tokens, "targets": targets},
            aux_weight=aux_weight)
        return value

    def event_batched(params, deltas, tokens, targets):
        """Per-event losses [K] at the stale points W + δ_k; `params` is
        the one differentiable W, unbatched under the map.  Each is the
        mean over its event's own tokens, with no mask: over a group of
        processes holding equal shares of every event's rows, the mean of
        the processes' losses (and of their pullbacks) is the whole
        batch's (`engine.fused_apply_cotangent`'s ``reduce``)."""
        def one_event(delta, tok, tgt):
            value, _ = transformer.loss_fn(
                params, cfg, {"tokens": tok, "targets": tgt},
                aux_weight=aux_weight, deltas=delta)
            return value

        return torch.func.vmap(one_event)(deltas, tokens, targets)

    loss.event_batched = event_batched
    return loss


def make_eval_fn(cfg: ModelConfig, tokens, targets):
    """Held-out evaluation `params -> CE` on a fixed token batch (no MoE
    aux term): `run_simulation`'s `eval_fn`."""
    batch = {"tokens": tokens, "targets": targets}

    def eval_fn(params):
        with torch.no_grad():
            _, metrics = transformer.loss_fn(params, cfg, batch)
        return metrics["ce"]
    return eval_fn
