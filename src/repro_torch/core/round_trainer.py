"""Round-based FASGD: the paper's async protocol as C divergent copies.

Ported from `repro.core.round_trainer`.  C client groups hold divergent
parameter copies (a leading [C] axis on every leaf); each round every
client computes a gradient on its own copy (`torch.func.vmap` of the
gradient function), the B-FASGD gate (eq. 9) decides per client whether it
is pushed into the canonical update and whether the client fetches the new
canonical parameters, and the pushed gradients update the server under any
`core.rules` rule.  The decisions live in `core.engine`, shared with FRED:

- ``apply_mode='serial'``: `engine.serial_apply`, pushed gradients one at
  a time in client order (arrival order under a scenario), the lock
  protocol; with ``use_fused_kernel`` each of the C candidates is one
  launch of the `fasgd_update` kernel;
- ``apply_mode='fused'``: `engine.fused_apply`, one masked-sum update with
  one statistics step on the mean pushed gradient (one `fused_event_apply`
  launch with the kernel), or, with ``fused_mode`` 'auto'/'cotangent' on an
  eligible configuration, `engine.fused_apply_cotangent`, whose per-client
  gradients are backward passes of one event-batched forward.

Dropped pushes follow ``drop_policy``: ``'local_apply'`` applies the
client's own gradient to its own copy; ``'discard'`` drops it.

**Bounded ingress queue** (``queue_capacity > 0``, `core.queue`): pushes
are admitted into a fixed-capacity ring and each round drains
``drain_count`` of them, so the server models a bounded apply rate.  A
rejected push falls back to the client's ``drop_policy``, and its bytes do
not count as sent.  The ring's slots are written in place, as FRED's are.
The cotangent path is not wired through the queue: ``fused_mode='auto'``
takes the materialized reduction there and ``'cotangent'`` raises.

**Scenario-lite wall clock** (``scenario``, `core.scenarios`): each round
the C clients draw service times (client c's draw number ``round_idx``);
the server applies pushes in arrival (fastest-first, ties by index) order,
so a partial-barrier rule (kasync) accepts the fastest K, and the round
costs the ``barrier_k``-th order statistic (t_(C) for an async rule).
Churn and elastic knobs are FRED-only and raise here.

`round_step(state, batch, draws)` takes the round's gate uniforms
(`utils.rng.RoundDraws`) where the reference takes a key.  Every decision
stays on the device: a round makes no host sync.

**Sharded server** (``server_shards > 1``, `core.server_shard`):
`shard_round_state` places the server, and the queue's payload, in blocks
on a mesh's server axis; the engine's gates read the shards' coupled v̄
and each apply runs on every shard's blocks, and the clients' refresh
reads the gathered parameters once a round.  Without placement the round
is the unsharded one, and only the ``shard_*`` counters move.  On a mesh
spread over processes (`launch.mesh.init_distributed_mesh`) every process
steps the same round and applies its own shards only.

**Over a group of processes** (`launch.train` under torchrun, a
``(data=w, model=1)`` mesh, as the reference's launcher installs): each
process passes its rows of every client's micro-batch and a ``reduce``
that averages the losses and gradients over the group once a round
(`sharding.reduce.GroupMean`); the state stays whole and every process
steps it the same way (`sharding.reduce.check_replicas` checks it).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import TrainerConfig
from repro_torch.core import engine
from repro_torch.core import queue as qlib
from repro_torch.core import rules as server_rules
from repro_torch.core import scenarios as scen
from repro_torch.core import server_shard
from repro_torch.core.bandwidth import masked_bytes, tree_bytes
from repro_torch.core.engine import Counters
from repro_torch.core.rules import ServerConfig, ServerState
from repro_torch.utils.device import resolve_device
from repro_torch.utils.rng import NativeRoundDraws
from repro_torch.utils.trees import leaves, tree_map, unflatten

class RoundState(NamedTuple):
    """Server + C divergent client copies + engine counters (leaves
    [C, ...])."""

    server: ServerState
    client_params: Any          # tree, leaves [C, ...]
    client_ts: torch.Tensor     # [C] int32
    round_idx: torch.Tensor     # int32 scalar
    counters: Counters          # shared engine bookkeeping (as in FRED)
    # per-tensor fetch (§5): [C, n_leaves] int32 — when each tensor of each
    # client's copy last synchronized
    client_leaf_ts: Optional[torch.Tensor] = None
    # bounded server ingress queue (queue_capacity > 0; core/queue.py)
    queue: Optional[qlib.QueueState] = None


def server_config(tc: TrainerConfig) -> ServerConfig:
    """Project the trainer config onto the engine's `ServerConfig`."""
    return ServerConfig(
        rule=tc.rule, lr=tc.lr, gamma=tc.gamma, beta=tc.beta, eps=tc.eps,
        kappa=tc.kappa, poly_power=tc.poly_power, variant=tc.variant,
        num_clients=tc.num_round_clients,
        use_fused_kernel=tc.use_fused_kernel, kasync_k=tc.kasync_k)


def _queue_payload_example(tc: TrainerConfig, params):
    """One queued push: the gradient, plus the pushing copy for gap-aware
    rules."""
    payload = {"grad": params}
    if server_rules.get_rule(tc.rule).needs_client_params:
        payload["copy"] = params
    return payload


def init_round_state(tc: TrainerConfig, params, device=None) -> RoundState:
    """Fresh `RoundState` on `device` (the card unless the caller passes
    another): server at T = 0, C identical client copies, zeroed counters,
    and per-tensor timestamps and an empty ingress queue where
    configured."""
    device = resolve_device(device)
    params = tree_map(lambda l: torch.as_tensor(l).to(device), params)
    C = tc.num_round_clients
    n_leaves = len(leaves(params))
    i32 = dict(dtype=torch.int32, device=device)
    return RoundState(
        server=server_rules.init(server_config(tc), params),
        client_params=tree_map(
            lambda l: l[None].expand((C,) + tuple(l.shape)).clone(), params),
        client_ts=torch.zeros(C, **i32),
        round_idx=torch.zeros((), **i32),
        counters=engine.init_counters(device),
        client_leaf_ts=(torch.zeros((C, n_leaves), **i32)
                        if tc.per_tensor_fetch else None),
        queue=(qlib.init_queue(
            tc.queue_capacity, _queue_payload_example(tc, params),
            n_leaves=n_leaves if tc.per_tensor_fetch else 0,
            mask_like=params if tc.per_tensor_push else None)
            if tc.queue_capacity else None),
    )


def shard_round_state(state: RoundState, mesh,
                      axis: str = server_shard.SERVER_AXIS) -> RoundState:
    """Place a `RoundState`'s server, and its queue's payload, on `mesh`'s
    `axis` (`core.server_shard`); the [C] client copies stay whole.  A
    mesh whose `axis` has one device, or none, places nothing: the
    ``server_shards=1`` bitwise contract."""
    return state._replace(
        server=server_shard.shard_server_state(state.server, mesh, axis),
        queue=server_shard.shard_queue_state(state.queue, mesh, axis))


def native_round_draws(tc: TrainerConfig, params, device=None):
    """The default provider of a run's round draws (`NativeRoundDraws` from
    ``tc.seed``), with per-leaf uniforms where the config gates per
    tensor."""
    return NativeRoundDraws(tc.seed, tc.num_round_clients,
                            n_leaves=len(leaves(params)),
                            per_tensor_push=tc.per_tensor_push,
                            per_tensor_fetch=tc.per_tensor_fetch,
                            device=device)


def make_grad_fn(loss_fn):
    """``grad_fn(params, batch) -> (loss, grads)`` for a ``loss_fn(params,
    *batch)``: the contract `build_round_step` takes (the reference's
    ``jax.value_and_grad`` order).  The cotangent path needs an
    event-batched loss besides: attach one as ``grad_fn.event_batched`` or
    pass ``batched_loss_fn``."""
    vg = torch.func.grad_and_value(loss_fn)

    def grad_fn(params, batch):
        grads, loss = vg(params, *batch)
        return loss, grads
    return grad_fn


def _check(tc: TrainerConfig, rule):
    """The reference's refusals (`ValueError`)."""
    if tc.server_shards < 1:
        raise ValueError(
            f"server_shards must be >= 1 (1 = replicated server), got "
            f"{tc.server_shards}")
    if tc.queue_capacity < 0:
        raise ValueError(
            f"queue_capacity must be >= 0 (0 disables the queue), got "
            f"{tc.queue_capacity}")
    if tc.drain_policy not in qlib.DRAIN_POLICIES:
        raise ValueError(
            f"unknown drain_policy {tc.drain_policy!r}: expected one of "
            f"{qlib.DRAIN_POLICIES}")
    if tc.admission_policy not in qlib.ADMISSION_POLICIES:
        raise ValueError(
            f"unknown admission_policy {tc.admission_policy!r}: expected "
            f"one of {qlib.ADMISSION_POLICIES}")
    if tc.queue_capacity > 0:
        if rule.synchronous:
            raise ValueError(
                f"queue_capacity > 0 is undefined for synchronous rule "
                f"{tc.rule!r}: the barrier already buffers a full round "
                f"server-side — use an async rule or queue_capacity=0")
        if tc.drain_k < 1:
            raise ValueError(f"drain_k must be >= 1, got {tc.drain_k}")
        if (tc.drain_policy == "adaptive"
                and not 0.0 < tc.drain_adaptive_gain <= 1.0):
            raise ValueError(
                f"drain_adaptive_gain must be in (0, 1], got "
                f"{tc.drain_adaptive_gain}")
        if tc.admission_policy == "block":
            if tc.drain_policy != "drain_all":
                raise ValueError(
                    "admission_policy='block' models lossless backpressure "
                    "— only sound when overflow is impossible: use "
                    "drain_policy='drain_all', or admission "
                    "'reject'/'drop_oldest' for a lossy loaded server")
            if tc.queue_capacity < tc.num_round_clients:
                raise ValueError(
                    f"admission_policy='block' requires queue_capacity >= "
                    f"num_round_clients (got {tc.queue_capacity} < "
                    f"{tc.num_round_clients}): all C round pushes must fit "
                    f"the drained-empty ring — raise queue_capacity or use "
                    f"'reject'/'drop_oldest'")
        if tc.fused_mode == "cotangent":
            raise ValueError(
                "fused_mode='cotangent' is not wired through the round "
                "trainer's ingress queue (the round's minibatch would have "
                "to be queued alongside each stale copy, as FRED does) — "
                "use fused_mode='auto'/'materialized' with queue_capacity "
                "> 0, or FRED for queued cotangent runs")
    if tc.scenario is not None:
        if tc.scenario.has_churn():
            raise ValueError(
                "churn/elastic scenario knobs (dropout_rate, rejoin_rate, "
                "initial_active_frac < 1, resize_at) are FRED-only: the "
                "round trainer's fleet is a fixed SPMD program — use "
                "sim.fred for churny fleets, or a pure service-time "
                "scenario (e.g. 'stragglers', 'hotspot') here")
        scen.check_fleet(tc.scenario, tc.num_round_clients)


def build_round_step(tc: TrainerConfig, grad_fn: Callable,
                     apply_mode: str = "serial",
                     batched_loss_fn: Optional[Callable] = None,
                     scenario_draws=None, reduce: Optional[Callable] = None):
    """Returns ``round_step(state, batch, draws) -> (state, metrics)``.

    `grad_fn(params, batch) -> (loss, grads)` (see `make_grad_fn`) is
    mapped over the clients with `torch.func.vmap`; `batch` is a tuple of
    [C, μ, ...] tensors, one shard per client; `draws` is the round's
    `utils.rng.RoundDraws` (`native_round_draws(...).round(r)`, or a
    replay).  On the cotangent path the event-batched loss is
    ``batched_loss_fn(W, deltas, batch) -> [C]``, else a
    ``grad_fn.event_batched`` in the model convention ``batched(W, deltas,
    *batch)``.  `scenario_draws` is the scenario's variate provider
    (`core.scenarios.native_draws(tc.scenario)` by default).

    `reduce` (None: none) is the round's one reduction over a group of
    processes, each of which passes its rows of every client's batch
    (`sharding.rules.row_slice`): it maps the tree (losses [C], gradients)
    to its mean over the group (`sharding.reduce.GroupMean`), right after
    the vmapped gradient (on the cotangent path, after the pullbacks:
    `engine.fused_apply_cotangent`), so that the gates, the applies and
    the clients' refresh run on the same values in every process.
    """
    if apply_mode not in ("serial", "fused"):
        raise ValueError(f"unknown apply_mode {apply_mode!r}")
    if tc.fused_mode not in ("auto", "materialized", "cotangent"):
        raise ValueError(f"unknown fused_mode {tc.fused_mode!r}")
    scfg = server_config(tc)
    rule = server_rules.get_rule(tc.rule)
    if tc.per_tensor_push and rule.synchronous:
        # a partially transmitted gradient has no coherent meaning at a
        # synchronous round barrier (as in SimConfig)
        raise ValueError(
            f"per_tensor_push is undefined for synchronous rule {tc.rule!r}")
    _check(tc, rule)
    use_queue = tc.queue_capacity > 0
    use_scenario = tc.scenario is not None
    batched_losses = batched_loss_fn
    if batched_losses is None:
        attached = getattr(grad_fn, "event_batched", None)
        if attached is not None:
            # model convention batched(W, deltas, x, y, ...): splat the
            # round's batch tuple
            batched_losses = lambda W, deltas, batch: attached(
                W, deltas, *batch)
    # v_separable rules (fasgd's ε-reparameterised eq. 7) take the
    # cotangent path only on explicit request, as in SimConfig
    use_cotangent = (
        apply_mode == "fused"
        and tc.fused_mode in ("auto", "cotangent")
        and rule.supports_fused
        and (rule.coeffs_are_v_independent
             or (rule.v_separable and tc.fused_mode == "cotangent"))
        and not tc.per_tensor_push and not tc.per_tensor_fetch
        and tc.drop_policy == "discard"
        and not tc.use_fused_kernel
        and not use_queue
        and batched_losses is not None)
    if tc.fused_mode == "cotangent" and not use_cotangent:
        raise ValueError(
            "fused_mode='cotangent' needs apply_mode='fused', a "
            "coeffs_are_v_independent (or v_separable) rule, whole-copy "
            "gating, drop_policy='discard', use_fused_kernel=False, and an "
            "event-batched loss (batched_loss_fn or grad_fn.event_batched)")
    vgrad = torch.func.vmap(grad_fn)
    C = tc.num_round_clients
    # the round's wall cost: a sync rule's round ends at its partial
    # barrier (the K-th arrival); an async round is charged the full t_(C)
    k_used = rule.barrier_k(scfg) if rule.synchronous else C
    scales = {}     # client_scales on the state's device, made once
    count_shard = server_shard.shard_counter(tc.server_shards,
                                             tc.server_axis)

    def round_step(state: RoundState, batch, draws):
        server = state.server
        dev = state.client_ts.device
        like = server_shard.like(server).params
        model_bytes = tree_bytes(like)
        n_leaves = len(leaves(like))

        # --- scenario-lite: this round's [C] service draws; the server
        # sees the pushes in arrival (fastest-first) order ---
        svc = svc_order = None
        if use_scenario:
            if dev not in scales:
                scales[dev] = scen.client_scales(tc.scenario, C, dev)
            svc = scen.round_draws(tc.scenario, scales[dev], state.round_idx,
                                   scenario_draws)
            svc_order = torch.argsort(svc, stable=True)

        if not use_cotangent:
            losses, grads = vgrad(state.client_params, batch)
            if reduce is not None:
                losses, grads = reduce((losses, grads))
        else:
            grads = None        # cotangent: losses come from the forward

        # --- push gates (eq. 9; per leaf under per-tensor push) ---
        if tc.per_tensor_push:
            push, _, _ = engine.per_tensor_gate(draws.push_u, server,
                                                tc.c_push, tc.eps)
            push_event = engine.any_leaf(push)                   # [C]
            push_sent = masked_bytes(push, like)
        else:
            push = push_event = engine.transmit_gate(
                draws.push_u, server, tc.c_push, tc.eps)          # [C]
            push_sent = push.to(torch.float32).sum() * model_bytes

        grad_ts = state.client_ts
        if tc.per_tensor_fetch:
            # per-tensor staleness: each tensor's τ from its own last sync
            grad_ts = unflatten(like, [state.client_leaf_ts[:, i]
                                       for i in range(n_leaves)])

        queue = state.queue
        admitted = push_event
        if use_queue:
            # --- admission: this round's pushes enter the bounded ring ---
            payload = {"grad": grads}
            if rule.needs_client_params:
                payload["copy"] = state.client_params
            arrivals = qlib.Arrivals(
                payload=payload, ts=state.client_ts,
                client=torch.arange(C, dtype=torch.int32, device=dev),
                valid=push_event,
                leaf_ts=state.client_leaf_ts if tc.per_tensor_fetch else None,
                leaf_mask=push if tc.per_tensor_push else None)
            if svc_order is not None:
                # ring order = arrival order: the fastest clients enqueue
                # (and, under a lossy admission policy, survive) first
                arrivals = tree_map(lambda a: a[svc_order], arrivals)
            T = server_shard.gather(server, lambda s: s.timestamp, dev)
            queue, admitted, n_rejected, n_dropped = qlib.enqueue(
                state.queue, arrivals, tc.admission_policy, T)
            if svc_order is not None:
                # back to client order: refresh and byte accounting index
                # `admitted` by client
                inv = torch.empty_like(svc_order)
                inv[svc_order] = torch.arange(C, device=dev)
                admitted = admitted[inv]
            depth_peak = queue.size
            # only admitted pushes crossed the wire
            if tc.per_tensor_push:
                push_sent = masked_bytes(
                    tree_map(lambda m: m & admitted, push), like)
            else:
                push_sent = admitted.to(torch.float32).sum() * model_bytes

            # --- drain: apply the k_eff oldest queued pushes ---
            k_eff = qlib.drain_count(queue.size, tc.drain_policy,
                                     drain_k=tc.drain_k,
                                     gain=tc.drain_adaptive_gain)
            queue, qbatch = qlib.dequeue(queue, k_eff)
            latency_sum = torch.where(
                qbatch.valid, (T - qbatch.enq_T).to(torch.float32),
                0.0).sum()
            q_ts = (unflatten(like, [qbatch.leaf_ts[:, i]
                                     for i in range(n_leaves)])
                    if tc.per_tensor_fetch else qbatch.ts)
            q_push = qlib.drained_push_arg(qbatch, tc.per_tensor_push)
            q_cp = qbatch.payload.get("copy")
            if apply_mode == "serial":
                new_server, taus = engine.serial_apply(
                    scfg, server, qbatch.payload["grad"], q_push, q_ts, q_cp)
            else:
                new_server, taus = engine.fused_apply(
                    scfg, server, qbatch.payload["grad"], q_push, q_ts,
                    client_params=q_cp)
            mean_tau = ((qbatch.valid.to(torch.float32) * taus).sum()
                        / torch.clamp(k_eff, min=1))
        elif use_cotangent:
            new_server, taus, losses = engine.fused_apply_cotangent(
                scfg, server,
                lambda W, deltas: batched_losses(W, deltas, batch),
                state.client_params, push, grad_ts, reduce=reduce)
        elif apply_mode == "serial":
            g_srv, p_srv, t_srv, cp_srv = (grads, push, grad_ts,
                                           state.client_params)
            if svc_order is not None:
                g_srv, p_srv, t_srv, cp_srv = tree_map(
                    lambda a: a[svc_order], (g_srv, p_srv, t_srv, cp_srv))
            new_server, taus = engine.serial_apply(
                scfg, server, g_srv, p_srv, t_srv, cp_srv)
        else:
            new_server, taus = engine.fused_apply(
                scfg, server, grads, push, grad_ts, state.client_params)
        if not use_queue:
            mean_tau = taus.mean()
        # the canonical parameters and T, gathered once from a placed
        # server
        new_params, new_T = server_shard.gather(
            new_server, lambda s: (s.params, s.timestamp), dev)

        # --- fetch gates (against the post-apply server) ---
        if tc.per_tensor_fetch:
            fmask, _, _ = engine.per_tensor_gate(draws.fetch_u, new_server,
                                                 tc.c_fetch, tc.eps)
            fm = torch.stack(leaves(fmask))                  # [n_leaves, C]
            fetch = fm.all(dim=0)                            # [C]
            fetch_sent = masked_bytes(fmask, new_params)
            f_leaves = list(fm)
        else:
            fetch = engine.transmit_gate(draws.fetch_u, new_server,
                                         tc.c_fetch, tc.eps)     # [C]
            fetch_sent = fetch.to(torch.float32).sum() * model_bytes
            f_leaves = [fetch] * n_leaves

        # --- client-side parameter refresh: a push the queue refused
        # behaves like a gated-out push and falls back to drop_policy ---
        refresh_push = push
        if use_queue:
            refresh_push = (tree_map(lambda m: m & admitted, push)
                            if tc.per_tensor_push else admitted)
        p_leaves = (leaves(refresh_push) if tc.per_tensor_push
                    else [refresh_push] * n_leaves)
        # no gradient on the cotangent path, which requires 'discard'
        g_leaves = leaves(grads) if grads is not None else [None] * n_leaves

        def upd_leaf(cp, sp, g, p, f):
            exp = (-1,) + (1,) * (cp.dim() - 1)
            local = (cp - tc.lr * g if tc.drop_policy == "local_apply"
                     else cp)
            kept = torch.where(p.reshape(exp), cp, local)
            return torch.where(f.reshape(exp), sp[None], kept)

        client_params = unflatten(like, [
            upd_leaf(*x) for x in zip(leaves(state.client_params),
                                      leaves(new_params), g_leaves,
                                      p_leaves, f_leaves)])
        client_ts = torch.where(fetch, new_T, state.client_ts)
        client_leaf_ts = state.client_leaf_ts
        if tc.per_tensor_fetch:
            client_leaf_ts = torch.where(fm.T, new_T, state.client_leaf_ts)

        counters = engine.count_events(
            state.counters, admitted, fetch,
            push_bytes_sent=push_sent, push_bytes_total=C * model_bytes,
            fetch_bytes_sent=fetch_sent, fetch_bytes_total=C * model_bytes)
        if use_queue:
            counters = qlib.count_queue(
                counters, enqueued=admitted.to(torch.int32).sum(),
                rejected=n_rejected, dropped=n_dropped, drained=k_eff,
                depth_post=queue.size, depth_peak=depth_peak,
                latency_sum=latency_sum)
        # kernel telemetry, the reference's folds: a fused round is one
        # launch per leaf; a serial round stages one per leaf per row
        if (apply_mode == "fused" and not use_cotangent
                and engine.fused_kernel_active(scfg)):
            counters = engine.count_kernel(counters, n_leaves,
                                           k_eff if use_queue else C)
        elif (apply_mode == "serial"
              and engine.serial_kernel_active(scfg, tc.per_tensor_fetch)):
            rows = qbatch.valid.shape[0] if use_queue else C
            counters = engine.count_kernel(counters, rows * n_leaves,
                                           k_eff if use_queue else C)
        # one round = one apply against the partitioned server, placed or
        # not (the plan is the shapes')
        counters = count_shard(counters, server, k_eff if use_queue else C)
        if use_scenario:
            round_dt = torch.sort(svc).values[k_used - 1]
            counters = scen.advance_wall(counters, round_dt, active_count=C)
        new_state = RoundState(
            server=new_server, client_params=client_params,
            client_ts=client_ts, round_idx=state.round_idx + 1,
            counters=counters, client_leaf_ts=client_leaf_ts, queue=queue)
        metrics = {
            "loss": losses.mean(),
            "loss_per_client": losses,
            "mean_tau": mean_tau,
            "pushes": admitted.to(torch.int32).sum(),
            "fetches": fetch.to(torch.int32).sum(),
            "timestamp": new_T,
        }
        if use_queue:
            metrics.update(queue_depth=queue.size, drained=k_eff,
                           rejected=n_rejected, dropped=n_dropped)
        if use_scenario:
            metrics.update(wall=counters.wall_clock, round_dt=round_dt)
        return new_state, metrics

    return round_step


def bandwidth_saved_bytes(tc: TrainerConfig, params, num_rounds: int,
                          push_rate: float, fetch_rate: float) -> dict:
    """Byte accounting of the elided transfers: a push is a reduce of one
    gradient copy, a fetch a broadcast of one parameter copy; the rates are
    measured actual/potential ratios."""
    pbytes = sum(l.numel() * l.element_size() for l in leaves(params))
    full = num_rounds * tc.num_round_clients * pbytes
    return {
        "full_push_bytes": full,
        "full_fetch_bytes": full,
        "actual_push_bytes": int(full * push_rate),
        "actual_fetch_bytes": int(full * fetch_rate),
        "total_saving_factor": 2.0 / max(push_rate + fetch_rate, 1e-9),
    }
