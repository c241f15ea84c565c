"""Step functions and abstract input specs for every (arch × shape) pair.

Ported from `repro.launch.steps`, the bridge between the model zoo and the
launcher:

 - `abstract_params(cfg)`: the parameter tree as meta tensors, shapes and
   dtypes without storage and without a random draw (a 314B-parameter
   model "exists" in a few KB of metadata);
 - `input_specs(cfg, shape)`: meta stand-ins for every model input of a
   named input shape (train batch / prefill batch / decode step);
 - `make_train_step(cfg, tc)`: the pod-sync FASGD step, one gradient of
   the mean loss over the batch followed by the FASGD server update (eqs.
   4-8).  Every data-parallel group is a client pushing each round; with
   no gating their copies coincide, so none is materialized (the
   divergent-copy round trainer, `core.round_trainer`, is the general
   case);
 - `make_prefill_step(cfg)` / `make_decode_step(cfg)`: the serving steps;
 - `shardings_for(cfg, shape, mesh)`: a step function, its abstract
   arguments and their `sharding.rules` shardings;
 - `place_args(fn, shardings)`: the port's ``jax.jit(fn,
   in_shardings=shardings)``: each argument placed by its sharding, then
   the step as it is, under the shardings' mesh context.

Token tensors are int64, the port's index type (the reference's are
int32).  In one process the shardings are reckoned, not applied; over a
mesh spread over processes `place_args` places every leaf as a DTensor
holding this process's shard (`sharding.rules.place`).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      TrainerConfig)
from repro_torch.core import rules as server_rules
from repro_torch.core.rules import ServerConfig, ServerState
from repro_torch.models.serving import decode_step, init_cache, prefill
from repro_torch.models.transformer import forward, init_model, loss_fn
from repro_torch.sharding import (batch_shardings, cache_shardings,
                                  param_shardings, state_shardings)
from repro_torch.sharding.rules import (NamedSharding, PartitionSpec, gather,
                                        mesh_context, place, redistribute)
from repro_torch.utils.trees import leaves, tree_map, unflatten


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def abstract_params(cfg: ModelConfig):
    """The parameter tree as meta tensors: no storage, nothing drawn."""
    return init_model(None, cfg, device="meta")


def abstract_server_state(cfg: ModelConfig, tc: TrainerConfig) -> ServerState:
    """The `ServerState` (W, the eq. 4-6 statistics n, b, v, the scalar T)
    as meta tensors, the statistics in `tc.stats_dtype` when it is not
    float32."""
    st = server_rules.init(server_config(tc), abstract_params(cfg))
    if tc.stats_dtype != "float32":
        dt = getattr(torch, tc.stats_dtype)
        recast = lambda t: tree_map(lambda l: _meta(l.shape, dt), t)
        st = st._replace(n=recast(st.n), b=recast(st.b), v=recast(st.v))
    return st


def server_config(tc: TrainerConfig) -> ServerConfig:
    """Project the trainer config onto the engine's `ServerConfig`, as the
    reference's launch layer does, and carry `tc.use_fused_kernel`: the
    pod-sync step then updates through `kernels.ops.fasgd_update` (the
    reference's step updates with the plain rule, which it computes to
    float32 rounding)."""
    return ServerConfig(
        rule=tc.rule, lr=tc.lr, gamma=tc.gamma, beta=tc.beta, eps=tc.eps,
        kappa=tc.kappa, poly_power=tc.poly_power,
        variant=tc.variant, num_clients=tc.num_round_clients,
        use_fused_kernel=tc.use_fused_kernel,
    )


def batch_struct(cfg: ModelConfig, B: int, S: int, *,
                 with_targets: bool) -> Dict[str, Any]:
    """A meta batch of `models.api.make_batch`'s keys and shapes."""
    i64 = torch.int64
    if cfg.arch_type == "audio":
        d = {"frames": _meta((B, S, cfg.frame_embed_dim), cfg.dtype)}
        if with_targets:
            d["targets"] = _meta((B, S), i64)
        return d
    if cfg.arch_type == "vlm":
        P = cfg.num_image_tokens
        S_text = S - P
        if S_text <= 0:
            raise ValueError(f"{cfg.name}: a sequence of {S} leaves no text "
                             f"after its {P} image tokens")
        d = {"tokens": _meta((B, S_text), i64),
             "image_embeds": _meta((B, P, cfg.image_embed_dim), cfg.dtype)}
        if with_targets:
            d["targets"] = _meta((B, S_text), i64)
        return d
    d = {"tokens": _meta((B, S), i64)}
    if with_targets:
        d["targets"] = _meta((B, S), i64)
    return d


def input_specs(cfg: ModelConfig, shape: InputShape | str) -> Dict[str, Any]:
    """Abstract inputs for (cfg, shape):

    train    → {'batch': ...}
    prefill  → {'batch': ...}
    decode   → {'token': [B, 1], 'cache': <tree>, 'pos': scalar}

    An encoder has no decode step: `ValueError`.
    """
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": batch_struct(cfg, B, S, with_targets=True)}
    if shape.kind == "prefill":
        return {"batch": batch_struct(cfg, B, S, with_targets=False)}
    if shape.kind != "decode":
        raise ValueError(f"unknown input kind {shape.kind!r}")
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.name} is encoder-only: no decode")
    return {"token": _meta((B, 1), torch.int64),
            "cache": init_cache(cfg, B, S, device="meta"),
            "pos": _meta((), torch.int64)}


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, tc: TrainerConfig):
    """``(server_state, batch) -> (server_state, metrics)``: pod-sync FASGD.

    The gradient is plain autograd's (`torch.autograd.grad` of `loss_fn`;
    a parameter the loss does not reach gets zeros, as under JAX), cast to
    `tc.stats_dtype` when that is not float32, then
    `core.rules.apply_update` at the state's own timestamp.  With
    ``cfg.remat`` each layer is recomputed in the backward.

    Over processes (a state placed by `place_args`) each gradient leaf is
    brought to its parameter's placements before the update
    (`sharding.rules.redistribute`), and the metrics come back whole, the
    same on every process."""
    scfg = server_config(tc)

    def train_step(state: ServerState, batch):
        params = tree_map(lambda l: l.detach().requires_grad_(),
                          state.params)
        loss, metrics = loss_fn(params, cfg, batch)
        flat = leaves(params)
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
        grads = unflatten(state.params, [
            redistribute(g, p.placements) if isinstance(p, DTensor) else g
            for g, p in zip(grads, flat)])
        if tc.stats_dtype != "float32":
            dt = getattr(torch, tc.stats_dtype)
            grads = tree_map(lambda g: g.to(dt), grads)
        with torch.no_grad():
            new_state, aux = server_rules.apply_update(
                scfg, state, grads, state.timestamp)
        out = gather({"loss": loss.detach(), "ce": metrics["ce"].detach(),
                      "moe_aux": metrics["moe_aux"].detach(),
                      "tau": aux["tau"], "mean_scale": aux["mean_scale"]})
        return new_state, out

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``(params, batch) -> (logits, cache)``, or the logits alone for an
    encoder (its full-sequence forward), under no grad."""
    if cfg.is_encoder:
        def encode_step(params, batch):
            with torch.no_grad():
                return forward(params, cfg, batch)[0]
        return encode_step

    def prefill_step(params, batch):
        with torch.no_grad():
            return prefill(params, cfg, batch)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``(params, token [B, 1], cache, pos) -> (logits, cache)``: one token,
    under no grad.  `pos` may be a 0-d tensor (read once on the host) or
    an int; the cache is written in place (`models.serving`)."""
    def serve_step(params, token, cache, pos):
        with torch.no_grad():
            return decode_step(params, cfg, token, cache, int(pos))
    return serve_step


# ---------------------------------------------------------------------------
# sharding assembly
# ---------------------------------------------------------------------------

def shardings_for(cfg: ModelConfig, shape: InputShape | str, mesh,
                  tc: TrainerConfig | None = None):
    """→ (fn, abstract_args: tuple, in_shardings: tuple).  The train step's
    statistics are bfloat16 for a bfloat16 model unless `tc` says
    otherwise, as in the reference."""
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    specs = input_specs(cfg, shape)
    repl = NamedSharding(mesh, PartitionSpec())
    if shape.kind == "train":
        tc = tc or TrainerConfig(stats_dtype="bfloat16"
                                 if cfg.dtype == torch.bfloat16
                                 else "float32")
        state = abstract_server_state(cfg, tc)
        args = (state, specs["batch"])
        shard = (state_shardings(state, mesh),
                 batch_shardings(specs["batch"], mesh))
        return make_train_step(cfg, tc), args, shard
    params = abstract_params(cfg)
    pshard = param_shardings(params, mesh)
    if shape.kind == "prefill":
        args = (params, specs["batch"])
        shard = (pshard, batch_shardings(specs["batch"], mesh))
        return make_prefill_step(cfg), args, shard
    args = (params, specs["token"], specs["cache"], specs["pos"])
    shard = (pshard, batch_shardings(specs["token"], mesh, seq_dim=None),
             cache_shardings(specs["cache"], mesh), repl)
    return make_decode_step(cfg), args, shard


def place_args(fn, shardings):
    """The port's ``jax.jit(fn, in_shardings=shardings)``: a step that
    places each argument by its sharding (`sharding.rules.place`: over a
    mesh spread over processes, only this process's shard of each leaf;
    an argument already placed so is kept) and runs `fn` on them as it is,
    under the shardings' mesh context (`mesh_context`), where the model's
    `constrain` sites act.  ``shardings_for(...)``'s third element is
    such a tuple."""
    mesh = next(s for s in leaves(list(shardings))
                if isinstance(s, NamedSharding)).mesh

    def step(*args):
        placed = [place(a, s) for a, s in zip(args, shardings)]
        with mesh_context(mesh):
            return fn(*placed)

    return step
