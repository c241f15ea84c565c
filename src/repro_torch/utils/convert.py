"""Weights and states carried across: numpy in, tensors out, and back.

Both packages hold the MLP as a list of ``{"w", "b"}`` dicts and the LM as
a dict with stacked [L, ...] layer leaves, so a state written out of one with
numpy starts the other from the same point; the round trainer's state, its
counters and ingress queue, and a scenario's state cross the same way.
bfloat16 crosses as its bits: numpy holds it as ml_dtypes' ``bfloat16``
(the JAX package's arrays carry that type), which torch cannot read
directly.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import server_shard
from repro_torch.core.engine import Counters
from repro_torch.core.queue import QueueState
from repro_torch.core.round_trainer import RoundState
from repro_torch.core.rules import ServerState
from repro_torch.core.scenarios import ScenarioState
from repro_torch.sim.fred import FleetRows
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import tree_map


def _tensor(a, device):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.as_tensor(a).to(device)


LM_KEYS = {"embed", "final_norm", "unembed", "layers"}
# the modality stubs' input projections: the VLM's and the audio encoder's
LM_OPTIONAL_KEYS = ({"img_proj"}, {"frame_proj"})
# a layer's FFN: the SwiGLU MLP or the MoE; its attention: GQA or MLA
LM_LAYER_KEYS = ({"ln1", "attn", "ln2", "mlp"}, {"ln1", "attn", "ln2", "moe"})
LM_ATTN_KEYS = ({"wq", "wk", "wv", "wo"},
                {"wq_nope", "wq_rope", "w_dkv", "kv_norm", "w_uk", "w_uv",
                 "w_kr", "wo"})
# an SSM layer (mamba2, zamba2's stack): its norm and the Mamba2 mixer
LM_SSM_LAYER_KEYS = {"ln", "mamba"}
LM_SSM_KEYS = {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
               "out_norm", "out_proj"}
# zamba2's shared block: GQA attention and a SwiGLU MLP
LM_SHARED_KEYS = {"in_proj", "ln1", "attn", "ln2", "mlp"}


def params_from_numpy(params, device=None):
    """A tree of numpy arrays (or anything `np.asarray` takes) as tensors on
    `device` (the card unless the caller passes another), dtypes kept."""
    device = resolve_device(device)
    return tree_map(lambda a: _tensor(a, device), params)


def server_state_from_numpy(params, T, n, b, v, device=None,
                            extra=None) -> ServerState:
    """A `ServerState` from numpy trees: params, timestamp T, statistics and
    the rule's `extra` state (gap's ``{"gbar": tree}``, the barrier rules'
    ``{"pending": tree, "count": int32, "seen": int32}``, or None), on
    `device` (the card unless the caller passes another)."""
    device = resolve_device(device)
    return ServerState(
        params=params_from_numpy(params, device),
        timestamp=torch.tensor(int(T), dtype=torch.int32, device=device),
        n=params_from_numpy(n, device),
        b=params_from_numpy(b, device),
        v=params_from_numpy(v, device),
        extra=None if extra is None else params_from_numpy(extra, device))


def _fields(obj) -> dict:
    """A NamedTuple's fields (the reference's states) or a mapping's."""
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def counters_from_numpy(counters, device=None) -> Counters:
    """The port's `Counters` from the reference's (a NamedTuple or mapping
    of numpy scalars, the ``shard_*`` fields included), dtypes kept, on
    `device` (the card unless the caller passes another)."""
    got = _fields(counters)
    device = resolve_device(device)
    return Counters(*(_tensor(got[k], device) for k in Counters._fields))


def queue_state_from_numpy(queue, device=None) -> QueueState:
    """The port's `QueueState` from the reference's (numpy leaves; its
    optional fields None where it has none), on `device` (the card unless
    the caller passes another)."""
    device = resolve_device(device)
    got = _fields(queue)
    return QueueState(**{
        k: None if got.get(k) is None else params_from_numpy(got[k], device)
        for k in QueueState._fields})


def scenario_state_from_numpy(state, device=None) -> ScenarioState:
    """The port's `ScenarioState` from the reference's (now, next_t,
    n_draws, dropped, window as numpy), on `device` (the card unless the
    caller passes another)."""
    device = resolve_device(device)
    got = _fields(state)
    return ScenarioState(**{k: _tensor(got[k], device)
                            for k in ScenarioState._fields})


def round_state_from_numpy(state, device=None) -> RoundState:
    """A round trainer's `RoundState` from the reference's, its leaves as
    numpy (``jax.tree.map(np.asarray, state)``): the server with its
    `extra`, the divergent client copies, ``client_ts``, ``round_idx``,
    the counters, and ``client_leaf_ts`` and the ingress queue where the
    run has them, on `device` (the card unless the caller passes another).
    A run carried across mid-way continues in the port from where the
    reference left it."""
    device = resolve_device(device)
    srv = state.server
    return RoundState(
        server=server_state_from_numpy(srv.params, srv.timestamp, srv.n,
                                       srv.b, srv.v, device, srv.extra),
        client_params=params_from_numpy(state.client_params, device),
        client_ts=_tensor(state.client_ts, device),
        round_idx=_tensor(state.round_idx, device),
        counters=counters_from_numpy(state.counters, device),
        client_leaf_ts=(None if state.client_leaf_ts is None
                        else _tensor(state.client_leaf_ts, device)),
        queue=(None if state.queue is None
               else queue_state_from_numpy(state.queue, device)))


def to_numpy(tree):
    """Every tensor leaf of `tree` (a `ServerState` too, `extra` included)
    as a numpy array; bfloat16 comes back as float32, which numpy lacks.
    A sharded server state (`core.server_shard.ShardedTree`) is gathered
    first, so it comes back in the reference's layout, and so is a fleet
    array split over a client axis (`sim.fred.FleetRows`) and a DTensor
    placed over processes (`sharding.rules.place`); spread over
    processes, each gather is a collective that every process calls."""
    def one(t):
        if server_shard.is_sharded(t):
            return to_numpy(t.gather())
        if isinstance(t, FleetRows):
            t = t.gather()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()
    return tree_map(one, tree)


def _check_lm(params):
    extra = set(params) - LM_KEYS
    layers = params.get("layers", {})
    if set(layers) == LM_SSM_LAYER_KEYS:
        ok = set(layers["mamba"]) == LM_SSM_KEYS
        if extra == {"shared"}:   # the hybrid: the SSM stack and its block
            shared = params["shared"]
            ok = ok and (set(shared) == LM_SHARED_KEYS
                         and set(shared["attn"]) == LM_ATTN_KEYS[0])
        elif extra:
            ok = False
    else:
        ok = (set(layers) in LM_LAYER_KEYS
              and set(layers["attn"]) in LM_ATTN_KEYS
              and (not extra or extra in LM_OPTIONAL_KEYS))
    if not (LM_KEYS <= set(params) and ok):
        raise ValueError(f"not a dense LM (nor a modal, MoE, SSM or hybrid "
                         f"LM) parameter tree: keys "
                         f"{sorted(params)} / layers {sorted(layers)} / "
                         f"attention {sorted(layers.get('attn', {}))} / "
                         f"mamba {sorted(layers.get('mamba', {}))}")


def lm_params_from_numpy(params, device=None):
    """An LM's parameters (numpy, the JAX package's structure with stacked
    [L, ...] layer leaves: GQA or MLA attention, an MLP or an MoE FFN; the
    VLM's `img_proj` or the audio encoder's `frame_proj` besides; or
    Mamba2 layers {ln, mamba}, with the hybrid's `shared` block) as
    tensors on `device` (the card unless the caller passes another), dtypes
    kept, bfloat16 included."""
    _check_lm(params)
    return params_from_numpy(params, device)


def lm_params_to_numpy(params):
    """The port's LM parameters as numpy, dtypes kept: bfloat16 comes
    back as ml_dtypes' ``bfloat16``, which numpy knows once ml_dtypes (a
    JAX dependency) is imported."""
    _check_lm(params)

    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("bfloat16")
        return t.numpy()
    return tree_map(one, params)
