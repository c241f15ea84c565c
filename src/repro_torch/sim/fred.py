"""FRED: deterministic single-node simulation of distributed SGD.

Ported from `repro.sim.fred`.  The (server, λ clients, dispatcher) system is
a fixed-shape tree of tensors on one device, advanced by a Python loop over
events (serial) or over K-event windows (fused) where the reference runs
`lax.scan`.

* each event = one client finishing one minibatch gradient on the
  parameters it fetched last (its stale copy), carrying that copy's
  timestamp;
* the server applies the update under the configured rule (any of the
  eight), and the client receives the new parameters — unless B-FASGD
  gating drops the push and/or the fetch (paper §2.3; whole-copy or, as
  §5 proposes, tensor by tensor in either direction; 'cache' or 'skip'
  drop policy).  When a barrier rule (ssgd, kasync) completes a round,
  every client receives the new parameters.

``apply_mode='serial'`` processes a window's K events one at a time and is
K-invariant: every draw comes from the RNG provider by global event index
(`repro_torch.utils.rng`).  ``apply_mode='fused'`` computes the K
gradients with one `torch.func.vmap` and applies them through
`engine.fused_apply` (the materialized reduction; with ``use_fused_kernel``
the one-kernel CUDA path).

Nothing in the event loop reads a tensor on the host: gates are
`torch.where`, indices stay on the device, and the device scalars τ,
`has_push` and the per-event weights reach the kernels as device pointers.
The host waits for the device only at each evaluation.

Under per-tensor fetch each client copy keeps one timestamp per tensor
(`SimState.client_leaf_ts`), so staleness is per leaf in both apply modes.

Not ported yet, and refused with `NotImplementedError`: the ingress queue
(`queue_capacity`), scenarios, a sharded server or client mesh, and the
cotangent fused path — including ``fused_mode='auto'`` where the reference
would resolve it to the cotangent path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import engine
from repro_torch.core import rules as server_rules
from repro_torch.core.bandwidth import BandwidthConfig, masked_bytes, tree_bytes
from repro_torch.core.engine import (Counters, tree_select, tree_select_axis,
                                     tree_where, tree_where_axis)
from repro_torch.core.rules import ServerConfig, ServerState
from repro_torch.utils.device import resolve_device
from repro_torch.utils.rng import Draws, NativeDraws
from repro_torch.utils.trees import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One FRED fleet: λ clients, a server rule, and the event schedule."""

    num_clients: int = 4
    batch_size: int = 32
    server: ServerConfig = ServerConfig()
    bandwidth: BandwidthConfig = BandwidthConfig()
    dispatcher: str = "uniform"   # 'uniform' | 'roundrobin' | 'heterogeneous'
    het_skew: float = 1.5         # log-speed std for the heterogeneous schedule
    seed: int = 0
    events_per_step: int = 1      # K client events per window
    apply_mode: str = "serial"    # 'serial' (paper-faithful) | 'fused'
    fused_mode: str = "auto"      # 'auto' | 'materialized' ('cotangent' waits)
    # kept so that a configuration asking for them is refused, not ignored
    queue_capacity: int = 0
    scenario: Optional[Any] = None
    server_shards: int = 1

    def cotangent_serviceable(self) -> bool:
        """True iff the reference's cotangent fused path can serve this
        configuration: a fused rule whose scale rides it (v-independent
        coefficients, or `v_separable`), whole-copy gating, no gradient
        cache and the kernel off."""
        rule = server_rules.get_rule(self.server.rule)
        use_cache = (self.bandwidth.c_push > 0
                     and self.bandwidth.drop_policy == "cache")
        return (rule.supports_fused
                and (rule.coeffs_are_v_independent or rule.v_separable)
                and not self.bandwidth.per_tensor
                and not use_cache
                and not self.server.use_fused_kernel)

    def cotangent_eligible(self) -> bool:
        """True iff the reference's fused_mode='auto' resolves to the
        cotangent path: serviceable, with exactly v-independent
        coefficients."""
        return (self.cotangent_serviceable()
                and server_rules.get_rule(
                    self.server.rule).coeffs_are_v_independent)

    def __post_init__(self):
        if self.dispatcher not in ("uniform", "roundrobin", "heterogeneous"):
            raise ValueError(f"unknown dispatcher {self.dispatcher!r}")
        if self.apply_mode not in ("serial", "fused"):
            raise ValueError(f"unknown apply_mode {self.apply_mode!r}")
        if self.fused_mode not in ("auto", "materialized", "cotangent"):
            raise ValueError(f"unknown fused_mode {self.fused_mode!r}")
        if self.events_per_step < 1:
            raise ValueError(f"events_per_step={self.events_per_step} < 1")
        rule = server_rules.get_rule(self.server.rule)
        if rule.synchronous:
            # a barrier needs a fair schedule (scenarios are not ported), and
            # a partly transmitted gradient has no meaning at a barrier
            if self.dispatcher != "roundrobin":
                raise ValueError(f"{self.server.rule} requires roundrobin")
            if self.bandwidth.per_tensor_push:
                raise ValueError(
                    f"per_tensor_push is undefined for synchronous rule "
                    f"{self.server.rule!r}")
        if self.apply_mode == "fused" and not rule.supports_fused:
            raise ValueError(
                f"rule {self.server.rule!r} does not support "
                f"apply_mode='fused'")
        if self.queue_capacity:
            raise NotImplementedError(
                "the ingress queue is not ported to repro_torch yet")
        if self.scenario is not None:
            raise NotImplementedError(
                "scenarios are not ported to repro_torch yet")
        if self.server_shards != 1:
            raise NotImplementedError(
                "a sharded server is not ported to repro_torch yet")
        if self.apply_mode == "fused" and (
                self.fused_mode == "cotangent"
                or (self.fused_mode == "auto" and self.cotangent_eligible())):
            raise NotImplementedError(
                "the cotangent fused path is not ported to repro_torch yet "
                "(fused_mode='auto' resolves to it for this rule with the "
                "kernel off and whole-copy gating without a gradient "
                "cache): set fused_mode='materialized'")


class SimState(NamedTuple):
    """Loop carry: server + λ stale client copies + protocol bookkeeping.

    `client_params`, `client_ts`, `grad_cache` and `client_leaf_ts` are
    fleet arrays owned by the loop and updated in place (a functional copy
    would write the whole [λ, P] fleet every event); the server state is
    replaced, not mutated.
    """

    server: ServerState
    client_params: Any            # tree, leaves [λ, ...]
    client_ts: torch.Tensor       # [λ] int32 — timestamp of each client's copy
    grad_cache: Optional[Any]     # tree [λ, ...] or None (cache drop policy)
    rr_pos: int                   # round-robin cursor (= global event index)
    counters: Counters
    # per-tensor fetch (§5): [λ, n_leaves] int32 — the timestamp at which
    # each tensor of each client's copy last synchronized
    client_leaf_ts: Optional[torch.Tensor] = None


def init_sim(config: SimConfig, params) -> SimState:
    """Fresh `SimState` on the params' device: server at T = 0, λ identical
    client copies, and the gradient cache and per-tensor timestamps when
    the config needs them."""
    lam = config.num_clients
    device = leaves(params)[0].device
    server = server_rules.init(config.server, params)
    use_cache = (config.bandwidth.c_push > 0
                 and config.bandwidth.drop_policy == "cache")
    fleet = lambda: tree_map(
        lambda l: l[None].expand((lam,) + l.shape).clone(), params)
    return SimState(
        server=server,
        client_params=fleet(),
        client_ts=torch.zeros(lam, dtype=torch.int32, device=device),
        grad_cache=tree_map(torch.zeros_like, fleet()) if use_cache else None,
        rr_pos=0,
        counters=engine.init_counters(device),
        client_leaf_ts=(torch.zeros((lam, len(leaves(params))),
                                    dtype=torch.int32, device=device)
                        if config.bandwidth.per_tensor_fetch else None),
    )


def native_draws(config: SimConfig, n_data: int, n_leaves: int) -> NativeDraws:
    """The run's default RNG provider: `NativeDraws` from ``config.seed``,
    with per-leaf gate uniforms where the config gates per tensor."""
    bw = config.bandwidth
    return NativeDraws(config.seed, config.num_clients, config.batch_size,
                       n_data, config.dispatcher, config.het_skew,
                       n_leaves=n_leaves,
                       per_tensor_push=bw.per_tensor_push,
                       per_tensor_fetch=bw.per_tensor_fetch)


def _row(tree, c1):
    """Row `c1` ([1] int64 device index) of every [λ, ...] leaf."""
    return tree_map(lambda l: l[c1][0], tree)


def _set_row_(tree, c1, row):
    """In place: row `c1` of every leaf ← `row`."""
    tree_map(lambda l, r: l.index_copy_(0, c1, r[None].to(l.dtype)), tree, row)


def _leaf_tree(like, cols):
    """A tree shaped like `like` whose i-th leaf is ``cols[..., i]``."""
    return unflatten(like, [cols[..., i] for i in range(cols.shape[-1])])


def build_step_fn(config: SimConfig, loss_fn: Callable, data_x, data_y):
    """Returns ``step(state, draws) -> (state, metrics)`` for one window.

    `draws` holds the window's K events (`utils.rng.Draws`), which sets the
    window size: the reference's ``events`` override is not needed.
    Metrics are per-event [K] tensors (``loss``, ``tau``, ``client``,
    ``pushed``, ``fetched``).  `loss_fn(params, xb, yb) -> scalar`.
    """
    grad_fn = torch.func.grad_and_value(loss_fn)
    bw = config.bandwidth
    scfg = config.server
    lam = config.num_clients
    synchronous = server_rules.get_rule(scfg.rule).synchronous

    def clients_of(state: SimState, draws: Draws):
        if config.dispatcher == "roundrobin":
            return (torch.arange(draws.idx.shape[0], device=data_x.device)
                    + state.rr_pos) % lam
        return draws.clients

    def event_body(state: SimState, c1, idx, u_push, u_fetch):
        """One client event — the paper's protocol, verbatim.  `c1` is the
        client as a [1] device index; `u_push`/`u_fetch` a scalar, or one
        uniform per leaf in a direction gated per tensor."""
        server = state.server
        model_bytes = tree_bytes(server.params)
        n_leaves = len(leaves(server.params))

        # --- client computes a stochastic gradient on its (stale) params ---
        xb, yb = data_x[idx], data_y[idx]
        p_c = _row(state.client_params, c1)
        g, loss = grad_fn(p_c, xb, yb)

        # --- push gate (B-FASGD eq. 9; per leaf under per-tensor push) ---
        if bw.per_tensor_push:
            push, push_sent, push_total = engine.per_tensor_gate(
                u_push, server, bw.c_push, bw.eps)
            push_event = engine.any_leaf(push)
        else:
            push = push_event = engine.transmit_gate(u_push, server,
                                                     bw.c_push, bw.eps)
            push_sent = push.to(torch.float32) * model_bytes
            push_total = model_bytes
        ts_c = state.client_ts[c1][0]
        if bw.per_tensor_fetch:
            # per-tensor timestamps → per-leaf staleness in the update rule
            leaf_ts = state.client_leaf_ts[c1][0]               # [n_leaves]
            grad_ts = _leaf_tree(server.params, leaf_ts)
        else:
            grad_ts = ts_c

        # --- gated server application (cache / skip drop policy) ---
        cached = (_row(state.grad_cache, c1)
                  if state.grad_cache is not None else None)
        new_server, aux = engine.apply_gated(
            scfg, server, g, push, grad_ts, client_params=p_c,
            cached_grad=cached)
        if state.grad_cache is not None:
            # a leaf becomes the "most recent transmitted" one only if that
            # leaf crossed the wire
            _set_row_(state.grad_cache, c1,
                      tree_select(push, g, cached) if bw.per_tensor_push
                      else tree_where(push, g, cached))

        # --- fetch gate (per leaf under per-tensor fetch) ---
        if bw.per_tensor_fetch:
            mask, fetch_sent, fetch_total = engine.per_tensor_gate(
                u_fetch, new_server, bw.c_fetch, bw.eps)
            new_p_c = tree_select(mask, new_server.params, p_c)
            leaf_mask = torch.stack(leaves(mask))               # [n_leaves]
            fetch = leaf_mask.all()
            state.client_leaf_ts.index_copy_(0, c1, torch.where(
                leaf_mask, new_server.timestamp, leaf_ts)[None])
        else:
            fetch = engine.transmit_gate(u_fetch, new_server, bw.c_fetch,
                                         bw.eps)
            fetch_sent = fetch.to(torch.float32) * model_bytes
            fetch_total = model_bytes
            new_p_c = tree_where(fetch, new_server.params, p_c)
        _set_row_(state.client_params, c1, new_p_c)
        # the whole-copy timestamp moves only when every tensor was fetched
        state.client_ts.index_copy_(
            0, c1, torch.where(fetch, new_server.timestamp, ts_c)[None])

        if synchronous:
            # a completed round unblocks every client with the new
            # parameters (the paper's `unblock`), in place on the fleet
            applied = aux["applied"]
            tree_map(lambda cl, sp: torch.where(applied, sp, cl, out=cl),
                     state.client_params, new_server.params)
            torch.where(applied, new_server.timestamp, state.client_ts,
                        out=state.client_ts)

        counters = engine.count_events(
            state.counters, push_event, fetch,
            push_bytes_sent=push_sent, push_bytes_total=push_total,
            fetch_bytes_sent=fetch_sent, fetch_bytes_total=fetch_total)
        if engine.serial_kernel_active(scfg, bw.per_tensor_fetch):
            # each event launches the rule's kernel once per leaf, pushed or
            # not (a dropped 'skip' candidate is computed, then masked)
            counters = engine.count_kernel(counters, n_leaves, 1)
        new_state = state._replace(server=new_server, rr_pos=state.rr_pos + 1,
                                   counters=counters)
        return new_state, (loss, aux["tau"], push_event, fetch)

    if config.apply_mode == "serial":
        def step(state: SimState, draws: Draws):
            cs = clients_of(state, draws)
            out = []
            for j in range(draws.idx.shape[0]):
                state, m = event_body(state, cs[j:j + 1], draws.idx[j],
                                      draws.push_u[j], draws.fetch_u[j])
                out.append(m)
            loss, tau, pushed, fetched = (torch.stack(x) for x in zip(*out))
            return state, {"loss": loss, "tau": tau, "client": cs,
                           "pushed": pushed, "fetched": fetched}
        return step

    # ----- fused: all K events advance in one batched protocol round -----
    vgrad = torch.func.vmap(grad_fn)

    def step(state: SimState, draws: Draws):
        k = draws.idx.shape[0]
        server = state.server
        model_bytes = tree_bytes(server.params)
        cs = clients_of(state, draws)
        xb, yb = data_x[draws.idx], data_y[draws.idx]            # [K, μ, ...]

        # --- event dedup: clients that fetched at the same T hold identical
        # copies, so the stale batch is gathered through representatives.
        # Under per-tensor fetch the key is the client_leaf_ts row (every
        # tensor must match) ---
        dedup_key = (state.client_leaf_ts[cs] if bw.per_tensor_fetch
                     else state.client_ts[cs])
        rep, _, _ = engine.dedup_events(dedup_key)
        p_e = engine.tree_index(state.client_params, cs[rep])    # [K, ...]

        # --- push gates (pre-window server state; per event and leaf under
        # per-tensor push) ---
        if bw.per_tensor_push:
            push, _, _ = engine.per_tensor_gate(draws.push_u, server,
                                                bw.c_push, bw.eps)  # [K] each
            push_event = engine.any_leaf(push)                    # [K]
            push_sent = masked_bytes(push, server.params)
        else:
            push = push_event = engine.transmit_gate(
                draws.push_u, server, bw.c_push, bw.eps)          # [K]
            push_sent = push.to(torch.float32).sum() * model_bytes
        # per-tensor staleness: each tensor's τ from its own last fetch
        grad_ts = (_leaf_tree(server.params, dedup_key)
                   if bw.per_tensor_fetch else dedup_key)

        grads, losses = vgrad(p_e, xb, yb)
        if state.grad_cache is not None:
            # cache policy: every opportunity applies *some* gradient (leaf
            # by leaf under per-tensor push), so the fused mask is all-ones
            # over the effective gradients
            cache_e = engine.tree_index(state.grad_cache, cs)
            g_eff = (tree_select_axis(push, grads, cache_e)
                     if bw.per_tensor_push
                     else tree_where_axis(push, grads, cache_e))
            new_server, taus = engine.fused_apply(
                scfg, server, g_eff,
                torch.ones(k, dtype=torch.bool, device=cs.device), grad_ts,
                client_params=p_e)
            engine.last_event_scatter(state.grad_cache, cs, grads, push)
        else:
            new_server, taus = engine.fused_apply(
                scfg, server, grads, push, grad_ts, client_params=p_e)

        # --- fetch gates (post-apply server state).  Every fetch delivers
        # the same canonical parameters, so the scatters are deterministic ---
        expand = lambda x: x[None].expand((k,) + x.shape)
        if bw.per_tensor_fetch:
            fmask, _, _ = engine.per_tensor_gate(draws.fetch_u, new_server,
                                                 bw.c_fetch, bw.eps)
            fetch_sent = masked_bytes(fmask, new_server.params)
            fm = torch.stack(leaves(fmask))                   # [n_leaves, K]
            for i, (cl, sp) in enumerate(zip(leaves(state.client_params),
                                             leaves(new_server.params))):
                source = engine.last_event_source(cs, fm[i])
                engine.scatter_rows_(cl, cs, expand(sp), source)
                engine.scatter_rows_(state.client_leaf_ts[:, i], cs,
                                     expand(new_server.timestamp), source)
            # the whole-copy timestamp moves only when every tensor was
            # fetched
            fetch = fm.all(dim=0)
            source = engine.last_event_source(cs, fetch)
        else:
            fetch = engine.transmit_gate(draws.fetch_u, new_server,
                                         bw.c_fetch, bw.eps)      # [K]
            fetch_sent = fetch.to(torch.float32).sum() * model_bytes
            source = engine.last_event_source(cs, fetch)
            tree_map(lambda cl, sp: engine.scatter_rows_(
                cl, cs, expand(sp), source),
                state.client_params, new_server.params)
        engine.scatter_rows_(state.client_ts, cs,
                             expand(new_server.timestamp), source)

        counters = engine.count_events(
            state.counters, push_event, fetch,
            push_bytes_sent=push_sent, push_bytes_total=k * model_bytes,
            fetch_bytes_sent=fetch_sent, fetch_bytes_total=k * model_bytes)
        if engine.fused_kernel_active(scfg):
            # one fused window = one launch per leaf consuming all K events
            counters = engine.count_kernel(
                counters, len(leaves(server.params)), k)
        new_state = state._replace(server=new_server, rr_pos=state.rr_pos + k,
                                   counters=counters)
        return new_state, {"loss": losses, "tau": taus, "client": cs,
                           "pushed": push_event, "fetched": fetch}

    return step


def run_simulation(
    config: SimConfig,
    loss_fn: Callable,
    init_params,
    data_x,
    data_y,
    num_steps: int,
    eval_every: int = 500,
    eval_fn: Optional[Callable] = None,   # eval_fn(server_params) -> scalar
    collect_step_metrics: bool = False,
    mesh=None,
    rng=None,
    device=None,
):
    """Run the deterministic simulation; returns a results dict.

    `num_steps` counts client events and is honoured exactly (a shorter
    final window covers any remainder).  The validation cost is measured on
    the *server* parameters every `eval_every` events.  `rng` is the RNG
    provider (`utils.rng.NativeDraws` from ``config.seed`` by default;
    `ReplayDraws` to replay recorded draws).  `init_params`, `data_x` and
    `data_y` are moved to `device` (labels as int64): the card unless the
    caller passes another device (`utils.device.resolve_device`).

    The dict has the reference's keys: ``steps``, ``val_cost``,
    ``wall_clock`` (the unit event clock), ``counters`` (floats),
    ``final_timestamp``, ``state``, and ``train_loss`` / ``tau`` when
    `collect_step_metrics`.  The final state's `client_leaf_ts` is there
    under per-tensor fetch.
    """
    if mesh is not None:
        raise NotImplementedError(
            "a client mesh is not ported to repro_torch yet")
    device = resolve_device(device)
    params = tree_map(lambda l: torch.as_tensor(l).to(device), init_params)
    data_x = torch.as_tensor(data_x).to(device)
    data_y = torch.as_tensor(data_y).to(device=device, dtype=torch.int64)
    if rng is None:
        rng = native_draws(config, data_x.shape[0], len(leaves(params)))
    state = init_sim(config, params)
    step = build_step_fn(config, loss_fn, data_x, data_y)
    K = config.events_per_step

    curve_steps, curve_cost, curve_wall = [], [], []
    train_losses, taus = [], []
    done = 0
    while done < num_steps:
        span = min(eval_every, num_steps - done)
        draws = rng.events(done, span, device)
        n_batches, rem = divmod(span, K)
        bounds = [(j * K, (j + 1) * K) for j in range(n_batches)]
        if rem:
            bounds.append((n_batches * K, span))
        for lo, hi in bounds:
            state, metrics = step(state, draws.window(lo, hi))
            if collect_step_metrics:
                train_losses.append(metrics["loss"].reshape(-1))
                taus.append(metrics["tau"].reshape(-1))
        done += span
        if eval_fn is not None:
            curve_steps.append(done)
            with torch.no_grad():
                curve_cost.append(float(eval_fn(state.server.params)))
            curve_wall.append(float(done))

    counters = {k: float(v) for k, v in state.counters._asdict().items()}
    if not config.server.use_fused_kernel:
        # kernel-path telemetry only appears when the kernel path can run
        counters = {k: v for k, v in counters.items()
                    if not k.startswith("kernel_")}
    out = {
        "state": state,
        "steps": curve_steps,
        "val_cost": curve_cost,
        "wall_clock": curve_wall,
        "counters": counters,
        "final_timestamp": int(state.server.timestamp),
    }
    if collect_step_metrics:
        out["train_loss"] = torch.cat(train_losses)
        out["tau"] = torch.cat(taus)
    return out
