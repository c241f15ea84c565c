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
(`repro_torch.utils.rng`).  ``apply_mode='fused'`` applies the K events in
one masked-sum update, its stale copies gathered through `dedup_events`
representatives, by one of two reductions (``SimConfig.fused_mode``):

* ``'materialized'``: one `torch.func.vmap` of the gradient forms the
  [K, P] gradient batch and `engine.fused_apply` reduces it (with
  ``use_fused_kernel`` on the one-kernel CUDA path);
* ``'cotangent'``: for rules whose fused scale is a per-event scalar (times
  one elementwise v-factor for fasgd's ε-reparameterised split), the
  weighted gradient sum and the statistics' mean gradient are backward
  passes of one event-batched forward (`engine.fused_apply_cotangent`), and
  the [K, P] batch is never formed;
* ``'auto'`` (default) takes the cotangent path wherever the configuration
  is eligible (`SimConfig.cotangent_eligible`: exactly v-independent
  coefficients), else the materialized one.

**Bounded ingress queue** (``queue_capacity > 0``, `core.queue`): each
window is K arrivals (dispatch, stale-copy gradient, eq.-9 push gate
against the server as it was before the window, admission into the ring),
one drain (`engine.serial_apply`, `engine.fused_apply` or
`engine.fused_apply_cotangent` over the drained ``[capacity]`` batch, its
invalid rows weighted 0), then the K arriving clients' fetch gates against
the post-drain server.  Every gate of a queued window is drawn per event.
With ``queue_capacity=1``, ``drain_all`` and ``block`` the queued serial
path is the immediate-apply serial path.

Nothing in the event loop reads a tensor on the host: gates are
`torch.where`, indices stay on the device, and the device scalars τ,
`has_push` and the per-event weights reach the kernels as device pointers.
The host waits for the device only at each evaluation.

Under per-tensor fetch each client copy keeps one timestamp per tensor
(`SimState.client_leaf_ts`), so staleness is per leaf in both apply modes.

**Scenarios** (``SimConfig.scenario``, `core.scenarios`): a modelled
arrival process replaces the dispatcher.  Each window starts with the
scenario's prologue (elastic activation, churn), then takes its clients
from the race: `sync_round`'s λ arrivals fastest-first for a barrier rule
(one round per window, K = λ), `async_window`'s K earliest finishers
otherwise, on every path (serial, fused, queued).  The wall clock and the
churn counts fold into the counters, admitted queue slots carry their
arrival's wall time, and `run_simulation`'s ``wall_clock`` curve is the
modelled clock.  The scenario's variates come from its own provider
(``scenario_draws``; `core.scenarios.native_draws` by default).

**Sharded parameter server** (``SimConfig.server_shards > 1``,
`core.server_shard`): ``run_simulation(mesh=...)`` with a mesh whose
``server_axis`` has exactly S devices (`launch.mesh.make_server_mesh`)
places the server state, and the queue's payload, in blocks on those
devices; the engine's gates read the shards' coupled v̄ and its applies
run on each shard's blocks (one kernel launch a shard on the kernel path).
Fetching clients read the gathered parameters, once per event or window.
The ``shard_*`` counters appear only when ``server_shards > 1``.

**Client axis**: a mesh with a ``clients`` axis of D devices splits the
[λ, ...] fleet arrays by rows over them (`shard_fleet`, `FleetRows`), and
the fused path computes its gradient batch in D chunks of K/D events, one
on each device.  Over processes (a `launch.mesh.Mesh` whose entries
carry the ranks holding them) each process holds its own blocks of rows
and maps its own chunks; row reads and the batch are gathered with
`core.server_shard.exchange`, and every process's run is the
one-process run, bitwise.  The queue refuses a client axis, and so does
``fused_mode='cotangent'``; ``'auto'`` takes the materialized reduction
where the axis has more than one device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import engine
from repro_torch.core import queue as qlib
from repro_torch.core import rules as server_rules
from repro_torch.core import scenarios as scen
from repro_torch.core import server_shard
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
    fused_mode: str = "auto"      # 'auto' | 'materialized' | 'cotangent'
    # --- bounded server ingress queue (core/queue.py) ---
    queue_capacity: int = 0       # 0 = immediate apply (no queue)
    drain_policy: str = "drain_all"     # 'drain_all' | 'drain_k' | 'adaptive'
    drain_k: int = 1              # per-window drain budget ('drain_k'; the
                                  # floor of 'adaptive')
    drain_adaptive_gain: float = 0.5    # 'adaptive': drain ceil(gain·depth)
    admission_policy: str = "block"     # 'block' | 'reject' | 'drop_oldest'
    # modelled arrival process (core/scenarios.py); None = the dispatcher
    scenario: Optional[scen.ScenarioConfig] = None
    # sharded parameter server (core/server_shard.py): 1 = one whole
    # server; S > 1 places it on the `server_axis` of the mesh passed to
    # run_simulation, which must have exactly S devices
    server_shards: int = 1
    server_axis: str = "server"

    def cotangent_serviceable(self) -> bool:
        """True iff `engine.fused_apply_cotangent` can serve this
        configuration: a fused rule whose scale rides it (v-independent
        coefficients, or `v_separable`), whole-copy gating, no gradient
        cache (it stores per-event gradients the path never forms) and the
        kernel off (``use_fused_kernel`` selects the one-kernel
        materialized path)."""
        rule = server_rules.get_rule(self.server.rule)
        use_cache = (self.bandwidth.c_push > 0
                     and self.bandwidth.drop_policy == "cache")
        return (rule.supports_fused
                and (rule.coeffs_are_v_independent or rule.v_separable)
                and not self.bandwidth.per_tensor
                and not use_cache
                and not self.server.use_fused_kernel)

    def cotangent_eligible(self) -> bool:
        """True iff ``fused_mode='auto'`` resolves to the cotangent path:
        serviceable, with exactly v-independent coefficients (fasgd's
        ε-reparameterised split is served on explicit request only)."""
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
        if self.fused_mode == "cotangent":
            if self.apply_mode != "fused":
                raise ValueError(
                    "fused_mode='cotangent' requires apply_mode='fused'")
            if not self.cotangent_serviceable():
                raise ValueError(
                    f"configuration is not cotangent-serviceable: rule "
                    f"{self.server.rule!r} must declare "
                    f"coeffs_are_v_independent or v_separable, and gating "
                    f"must be whole-copy without a gradient cache and with "
                    f"the kernel off (see SimConfig.cotangent_serviceable)")
        rule = server_rules.get_rule(self.server.rule)
        if rule.synchronous:
            # a barrier needs a fair schedule — round-robin, or a scenario
            # (whose sync_round delivers each client once a round) — and a
            # partly transmitted gradient has no meaning at a barrier
            if self.scenario is None and self.dispatcher != "roundrobin":
                raise ValueError(f"{self.server.rule} requires roundrobin")
            if self.bandwidth.per_tensor_push:
                raise ValueError(
                    f"per_tensor_push is undefined for synchronous rule "
                    f"{self.server.rule!r}")
        if self.apply_mode == "fused" and not rule.supports_fused:
            raise ValueError(
                f"rule {self.server.rule!r} does not support "
                f"apply_mode='fused'")
        if self.server_shards < 1:
            raise ValueError(
                f"server_shards must be >= 1 (1 = replicated server), got "
                f"{self.server_shards}")
        self._check_queue(rule)
        self._check_scenario(rule)

    def _check_scenario(self, rule):
        """The reference's scenario validation."""
        if self.scenario is None:
            return
        if self.dispatcher == "heterogeneous":
            raise ValueError(
                "a scenario's service-time model replaces the "
                "heterogeneous dispatcher's speed schedule: configure "
                "hotspot/straggler client scales in ScenarioConfig "
                "instead (dispatcher='uniform' or 'roundrobin' are "
                "accepted and ignored for arrival ordering)")
        # raises early on inconsistent straggler/hotspot fractions
        scen.check_fleet(self.scenario, self.num_clients)
        if rule.synchronous:
            if self.events_per_step != self.num_clients:
                raise ValueError(
                    f"a synchronous rule under a scenario advances one "
                    f"round of λ arrivals per window: set events_per_step "
                    f"= num_clients (got {self.events_per_step} != "
                    f"{self.num_clients})")
            if self.scenario.has_churn():
                raise ValueError(
                    f"synchronous rule {self.server.rule!r} cannot run "
                    f"under dropout/rejoin/elastic churn: a barrier over a "
                    f"changing fleet deadlocks — use an async rule, or a "
                    f"churn-free scenario (stragglers/hotspot)")

    def _check_queue(self, rule):
        """The reference's ingress-queue validation: clear errors for
        configurations with no coherent queued semantics."""
        if self.queue_capacity < 0:
            raise ValueError(
                f"queue_capacity must be >= 0 (0 disables the queue), got "
                f"{self.queue_capacity}")
        if self.drain_policy not in qlib.DRAIN_POLICIES:
            raise ValueError(
                f"unknown drain_policy {self.drain_policy!r}: expected one "
                f"of {qlib.DRAIN_POLICIES}")
        if self.admission_policy not in qlib.ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission_policy {self.admission_policy!r}: "
                f"expected one of {qlib.ADMISSION_POLICIES}")
        if not self.queue_capacity:
            return
        if rule.synchronous:
            raise ValueError(
                f"queue_capacity > 0 is undefined for synchronous rule "
                f"{self.server.rule!r}: a barrier rule already buffers a "
                f"full round server-side — use an async rule or "
                f"queue_capacity=0")
        if self.drain_k < 1:
            raise ValueError(f"drain_k must be >= 1, got {self.drain_k}")
        if (self.drain_policy == "adaptive"
                and not 0.0 < self.drain_adaptive_gain <= 1.0):
            raise ValueError(
                f"drain_adaptive_gain must be in (0, 1], got "
                f"{self.drain_adaptive_gain}")
        if self.bandwidth.c_push > 0 and self.bandwidth.drop_policy == "cache":
            raise ValueError(
                "drop_policy='cache' (server-side gradient cache) is "
                "incompatible with an ingress queue: a gated-out push never "
                "reaches the server, so there is no arrival to admit — use "
                "drop_policy='skip' with queue_capacity > 0")
        if self.admission_policy == "block":
            if self.drain_policy != "drain_all":
                raise ValueError(
                    "admission_policy='block' models lossless backpressure, "
                    "which a fixed-shape window can honour only when "
                    "overflow is impossible: use drain_policy='drain_all', "
                    "or admission 'reject'/'drop_oldest'")
            if self.queue_capacity < self.events_per_step:
                raise ValueError(
                    f"admission_policy='block' requires queue_capacity >= "
                    f"events_per_step (got {self.queue_capacity} < "
                    f"{self.events_per_step})")


class SimState(NamedTuple):
    """Loop carry: server + λ stale client copies + protocol bookkeeping.

    `client_params`, `client_ts`, `grad_cache` and `client_leaf_ts` are
    fleet arrays owned by the loop and updated in place (a functional copy
    would write the whole [λ, P] fleet every event), as are the ingress
    queue's slot arrays (`core.queue`); the server state is replaced, not
    mutated.
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
    # bounded server ingress queue (queue_capacity > 0; core/queue.py)
    queue: Optional[qlib.QueueState] = None
    # modelled arrival process (SimConfig.scenario; core/scenarios.py)
    scenario: Optional[scen.ScenarioState] = None


def _use_cotangent(config: SimConfig) -> bool:
    """Whether the fused path reduces through `fused_apply_cotangent`:
    asked for, or 'auto' on an eligible configuration."""
    return (config.apply_mode == "fused"
            and (config.fused_mode == "cotangent"
                 or (config.fused_mode == "auto"
                     and config.cotangent_eligible())))


def _queue_payload_example(config: SimConfig, params):
    """One event's payload in the ingress queue: the gradient and its loss
    (plus the stale copy for gap-aware rules), or, on the cotangent fused
    path, the stale copy and the minibatch indices (its forward and
    backward run at drain time)."""
    device = leaves(params)[0].device
    if _use_cotangent(config):
        return {"copy": params,
                "idx": torch.zeros(config.batch_size, dtype=torch.int64,
                                   device=device)}
    payload = {"grad": params,
               "loss": torch.zeros((), dtype=torch.float32, device=device)}
    if server_rules.get_rule(config.server.rule).needs_client_params:
        payload["copy"] = params
    return payload


def init_sim(config: SimConfig, params, scenario_draws=None) -> SimState:
    """Fresh `SimState` on the params' device: server at T = 0, λ identical
    client copies, and the gradient cache, per-tensor timestamps, ingress
    queue and scenario state (its first draws from `scenario_draws`, the
    scenario's native provider by default) when the config needs them."""
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
        queue=(qlib.init_queue(
            config.queue_capacity, _queue_payload_example(config, params),
            n_leaves=(len(leaves(params))
                      if config.bandwidth.per_tensor_fetch else 0),
            mask_like=(params if config.bandwidth.per_tensor_push else None),
            track_wall=config.scenario is not None)
            if config.queue_capacity else None),
        scenario=(scen.init_scenario(config.scenario, lam, device,
                                     scenario_draws)
                  if config.scenario is not None else None),
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


class FleetRows:
    """A [λ, ...] fleet array split by rows over the devices of a client
    axis: block d holds rows [d·λ/D, (d+1)·λ/D) on its device, then one
    spare row that takes the writes aimed at other blocks' rows (so a
    write never lands twice on a real row).  It answers the indexing the
    event loop does on a fleet array (row reads and writes by a device
    index tensor, column views) on the run's device `home`; `gather` gives
    the whole array back.

    Over processes (a client axis whose `ranks` name the process holding
    each block) a process holds its own blocks only, the others None.  A
    row read is then a collective (`core.server_shard.exchange`): every
    block's candidate rows reach every process, and the owner's row wins
    as in one process; a write lands in this process's blocks only."""

    def __init__(self, blocks, home, rows, ranks=None):
        self.blocks = list(blocks)
        self.home = torch.device(home)
        self.rows = rows
        self.ranks = None if ranks is None else tuple(ranks)

    @classmethod
    def place(cls, leaf, devices, ranks=None):
        """`leaf` split by rows over `devices` (their number divides λ),
        block d built only where ``ranks[d]`` is this process."""
        n = leaf.shape[0] // len(devices)
        spare = torch.zeros_like(leaf[:1])
        me = server_shard.process_rank()
        return cls([torch.cat([leaf[d * n:(d + 1) * n], spare]).to(dev)
                    if ranks is None or ranks[d] == me else None
                    for d, dev in enumerate(devices)], leaf.device, n, ranks)

    @property
    def _first(self):
        return next(b for b in self.blocks if b is not None)

    @property
    def dtype(self):
        """The array's dtype."""
        return self._first.dtype

    def dim(self) -> int:
        """The array's number of dimensions."""
        return self._first.dim()

    def _local(self, idx, d):
        lo = d * self.rows
        own = (idx >= lo) & (idx < lo + self.rows)
        return own, torch.where(own, idx - lo, self.rows)

    def _every_block(self, mine):
        """Each block's tensor, in block order, from this process's
        (`mine`: block → tensor; alike in shape and dtype)."""
        t = next(iter(mine.values()))
        got = server_shard.exchange(
            self.ranks, {d: [x] for d, x in mine.items()},
            [[(tuple(t.shape), t.dtype)]] * len(self.blocks), self.home)
        return [x[0] for x in got]

    def __getitem__(self, key):
        if isinstance(key, tuple):          # a column view, e.g. [:, i]
            return FleetRows([None if b is None else b[key]
                              for b in self.blocks], self.home, self.rows,
                             self.ranks)
        rows = self._every_block({
            d: b[self._local(key, d)[1].to(b.device)]
            for d, b in enumerate(self.blocks) if b is not None})
        out = None
        for d, r in enumerate(rows):
            own, _ = self._local(key, d)
            r = r.to(self.home)
            out = r if out is None else torch.where(
                own.reshape((-1,) + (1,) * (r.dim() - 1)), r, out)
        return out

    def __setitem__(self, key, value):
        for d, b in enumerate(self.blocks):
            if b is not None:
                _, local = self._local(key, d)
                b[local.to(b.device)] = value.to(b.device)

    def index_copy_(self, dim, index, source):
        """In place: rows `index` ← `source` (dim 0 only)."""
        if dim != 0:
            raise ValueError("a fleet array is written by rows")
        self[index] = source
        return self

    def gather(self) -> torch.Tensor:
        """The whole array on the run's device."""
        return torch.cat([b.to(self.home) for b in self._every_block(
            {d: b[:-1] for d, b in enumerate(self.blocks) if b is not None})])


def shard_fleet(state: SimState, mesh, client_axis: str = "clients"):
    """Split every [λ, ...] fleet array (the client copies, their
    timestamps, the gradient cache) by rows over `mesh[client_axis]`
    (`FleetRows`; over processes, each process holds its own blocks);
    the server is left as it is.  The axis's size must divide λ; a size
    of 1 places nothing."""
    devices = mesh.axis_devices(client_axis)
    ranks = mesh.axis_ranks(client_axis)
    lam = state.client_ts.shape[0]
    if len(devices) == 1:
        return state
    if lam % len(devices):
        raise ValueError(f"the {client_axis!r} axis has {len(devices)} "
                         f"devices, which must divide λ={lam}")
    if ranks is not None and server_shard.process_rank() not in ranks:
        raise ValueError(f"process {server_shard.process_rank()} holds no "
                         f"block of the {client_axis!r} axis (ranks "
                         f"{ranks})")
    put = lambda tree: tree_map(
        lambda l: FleetRows.place(l, devices, ranks), tree)
    return state._replace(client_params=put(state.client_params),
                          client_ts=put(state.client_ts),
                          grad_cache=put(state.grad_cache),
                          client_leaf_ts=put(state.client_leaf_ts))


def _fill_where_(cond, value, fleet_leaf):
    """In place: every row of a fleet leaf ← `value` where `cond`."""
    for b in (fleet_leaf.blocks if isinstance(fleet_leaf, FleetRows)
              else [fleet_leaf]):
        if b is not None:
            torch.where(cond.to(b.device), value.to(b.device), b, out=b)


def _canonical(server, device):
    """The server's parameters and T, whole on `device` (gathered from the
    shards of a placed server)."""
    return server_shard.gather(server, lambda s: (s.params, s.timestamp),
                               device)


def _row(tree, c1):
    """Row `c1` ([1] int64 device index) of every [λ, ...] leaf."""
    return tree_map(lambda l: l[c1][0], tree)


def _set_row_(tree, c1, row):
    """In place: row `c1` of every leaf ← `row`."""
    tree_map(lambda l, r: l.index_copy_(0, c1, r[None].to(l.dtype)), tree, row)


def _leaf_tree(like, cols):
    """A tree shaped like `like` whose i-th leaf is ``cols[..., i]``."""
    return unflatten(like, [cols[..., i] for i in range(cols.shape[-1])])


def _clients_of(config: SimConfig, state: SimState, draws: Draws):
    """The window's K dispatched clients ([K] int64 on the device)."""
    if config.dispatcher == "roundrobin":
        return (torch.arange(draws.idx.shape[0], device=draws.idx.device)
                + state.rr_pos) % config.num_clients
    return draws.clients


def _fetch_window(config: SimConfig, state: SimState, cs, new_server,
                  fetch_u, model_bytes):
    """The fetch gates of a window's K clients `cs` against `new_server`
    (per leaf under per-tensor fetch) and their scatters into the fleet, in
    place.  Every fetch delivers the same canonical parameters (gathered
    once from a placed server), so the scatters are deterministic.  A
    whole-copy fetch counts `model_bytes` (the pre-window tree's).
    Returns (fetch [K], fetch bytes sent)."""
    bw = config.bandwidth
    k = cs.shape[0]
    expand = lambda x: x[None].expand((k,) + x.shape)
    new_params, new_T = _canonical(new_server, cs.device)
    if bw.per_tensor_fetch:
        fmask, _, _ = engine.per_tensor_gate(fetch_u, new_server,
                                             bw.c_fetch, bw.eps)
        fetch_sent = masked_bytes(fmask, new_params)
        fm = torch.stack(leaves(fmask))                   # [n_leaves, K]
        for i, (cl, sp) in enumerate(zip(leaves(state.client_params),
                                         leaves(new_params))):
            source = engine.last_event_source(cs, fm[i])
            engine.scatter_rows_(cl, cs, expand(sp), source)
            engine.scatter_rows_(state.client_leaf_ts[:, i], cs,
                                 expand(new_T), source)
        # the whole-copy timestamp moves only when every tensor was fetched
        fetch = fm.all(dim=0)
        source = engine.last_event_source(cs, fetch)
    else:
        fetch = engine.transmit_gate(fetch_u, new_server, bw.c_fetch,
                                     bw.eps)                  # [K]
        fetch_sent = fetch.to(torch.float32).sum() * model_bytes
        source = engine.last_event_source(cs, fetch)
        tree_map(lambda cl, sp: engine.scatter_rows_(
            cl, cs, expand(sp), source), state.client_params, new_params)
    engine.scatter_rows_(state.client_ts, cs, expand(new_T), source)
    return fetch, fetch_sent


class _Race:
    """A scenario's arrival race for the step functions: the window's
    clients and finish times in place of the dispatcher's."""

    def __init__(self, config: SimConfig, device, draws):
        rule = server_rules.get_rule(config.server.rule)
        self.config = config
        self.scales = scen.client_scales(config.scenario, config.num_clients,
                                         device)
        self.draws = draws
        # a barrier rule's window is one sync round of λ arrivals
        self.sync_k = (rule.barrier_k(config.server) if rule.synchronous
                       else None)

    def window(self, state: SimState, k: int):
        """The prologue, then the window's K arrivals; the scenario state
        and its counters advance.  Returns (state, clients [K] int64,
        finish times [K] float32)."""
        cfg, lam = self.config.scenario, self.config.num_clients
        if self.sync_k is not None and k != lam:
            raise ValueError(
                f"synchronous scenario rounds advance exactly λ={lam} "
                f"events per window, got a {k}-event window: num_steps and "
                f"eval_every must be multiples of num_clients")
        st, active, n_drop, n_rejoin = scen.window_prologue(
            cfg, lam, state.scenario, self.scales, self.draws)
        if self.sync_k is not None:
            st, cs, t_fin = scen.sync_round(cfg, lam, st, self.scales,
                                            self.sync_k, self.draws)
        else:
            st, cs, t_fin = scen.async_window(cfg, lam, st, self.scales,
                                              active, k, self.draws)
        counters = scen.count_scenario(
            state.counters, now=st.now,
            active_count=active.to(torch.float32).sum(),
            dropouts=n_drop, rejoins=n_rejoin)
        return state._replace(scenario=st, counters=counters), cs, t_fin


def build_step_fn(config: SimConfig, loss_fn: Callable, data_x, data_y,
                  batched_loss_fn: Optional[Callable] = None,
                  scenario_draws=None, mesh=None,
                  client_axis: str = "clients"):
    """Returns ``step(state, draws) -> (state, metrics)`` for one window.

    `draws` holds the window's K events (`utils.rng.Draws`), which sets the
    window size: the reference's ``events`` override is not needed.
    Metrics are per-event [K] tensors (``loss``, ``tau``, ``client``,
    ``pushed``, ``fetched``, and ``wall``, the arrivals' modelled finish
    times, under a scenario); a queued window's ``loss`` and ``tau`` are
    means over its drained events, with its queue telemetry beside them.
    `loss_fn(params, xb, yb) -> scalar`; `batched_loss_fn(W, deltas, xb,
    yb) -> [K]` is the event-batched loss the cotangent path
    differentiates (default: ``loss_fn.event_batched``, else the generic
    `engine.event_batched_losses`).  `scenario_draws` provides the
    scenario's variates (`core.scenarios.native_draws` of
    ``config.scenario`` by default); the dispatcher's draws go unused
    under a scenario.  A `mesh` with a `client_axis` of D > 1 devices
    splits the fused path's gradient batch over them; the queue and the
    cotangent path refuse an axis of that name whatever its size, and
    'auto' gives the cotangent path up where D > 1.
    """
    home = torch.as_tensor(data_x).device
    race = (_Race(config, home, scenario_draws)
            if config.scenario is not None else None)
    names_client_axis = (mesh is not None and client_axis
                         in getattr(mesh, "axis_names", ()))
    client_devices = (mesh.axis_devices(client_axis)
                      if names_client_axis else ())
    client_ranks = mesh.axis_ranks(client_axis) if names_client_axis else None
    if config.queue_capacity:
        if names_client_axis:
            raise ValueError(
                "queue_capacity > 0 does not support a client-axis mesh: "
                "the ring buffer is server state, and arrival gradients "
                "split over the client axis are not wired through it yet "
                "— run the queued simulation without one")
        return _build_queue_step(config, loss_fn, data_x, data_y,
                                 batched_loss_fn, race)
    grad_fn = torch.func.grad_and_value(loss_fn)
    bw = config.bandwidth
    scfg = config.server
    synchronous = server_rules.get_rule(scfg.rule).synchronous
    count_shard = server_shard.shard_counter(config.server_shards,
                                              config.server_axis)

    def event_body(state: SimState, c1, idx, u_push, u_fetch):
        """One client event — the paper's protocol, verbatim.  `c1` is the
        client as a [1] device index; `u_push`/`u_fetch` a scalar, or one
        uniform per leaf in a direction gated per tensor."""
        server = state.server
        like = server_shard.like(server).params
        model_bytes = tree_bytes(like)
        n_leaves = len(leaves(like))

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
            grad_ts = _leaf_tree(like, leaf_ts)
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

        # --- fetch gate (per leaf under per-tensor fetch), against the
        # canonical parameters, gathered once from a placed server ---
        new_params, new_T = _canonical(new_server, home)
        if bw.per_tensor_fetch:
            mask, fetch_sent, fetch_total = engine.per_tensor_gate(
                u_fetch, new_server, bw.c_fetch, bw.eps)
            new_p_c = tree_select(mask, new_params, p_c)
            leaf_mask = torch.stack(leaves(mask))               # [n_leaves]
            fetch = leaf_mask.all()
            state.client_leaf_ts.index_copy_(0, c1, torch.where(
                leaf_mask, new_T, leaf_ts)[None])
        else:
            fetch = engine.transmit_gate(u_fetch, new_server, bw.c_fetch,
                                         bw.eps)
            fetch_sent = fetch.to(torch.float32) * model_bytes
            fetch_total = model_bytes
            new_p_c = tree_where(fetch, new_params, p_c)
        _set_row_(state.client_params, c1, new_p_c)
        # the whole-copy timestamp moves only when every tensor was fetched
        state.client_ts.index_copy_(
            0, c1, torch.where(fetch, new_T, ts_c)[None])

        if synchronous:
            # a completed round unblocks every client with the new
            # parameters (the paper's `unblock`), in place on the fleet
            applied = aux["applied"]
            tree_map(lambda cl, sp: _fill_where_(applied, sp, cl),
                     state.client_params, new_params)
            _fill_where_(applied, new_T, state.client_ts)

        counters = engine.count_events(
            state.counters, push_event, fetch,
            push_bytes_sent=push_sent, push_bytes_total=push_total,
            fetch_bytes_sent=fetch_sent, fetch_bytes_total=fetch_total)
        if engine.serial_kernel_active(scfg, bw.per_tensor_fetch):
            # each event launches the rule's kernel once per leaf, pushed or
            # not (a dropped 'skip' candidate is computed, then masked)
            counters = engine.count_kernel(counters, n_leaves, 1)
        # serial lock order: each event is a one-event apply window
        counters = count_shard(counters, server, 1)
        new_state = state._replace(server=new_server, rr_pos=state.rr_pos + 1,
                                   counters=counters)
        return new_state, (loss, aux["tau"], push_event, fetch)

    if config.apply_mode == "serial":
        def step(state: SimState, draws: Draws):
            k = draws.idx.shape[0]
            if race is None:
                cs = _clients_of(config, state, draws)
            else:
                state, cs, t_fin = race.window(state, k)
            out = []
            for j in range(k):
                state, m = event_body(state, cs[j:j + 1], draws.idx[j],
                                      draws.push_u[j], draws.fetch_u[j])
                out.append(m)
            loss, tau, pushed, fetched = (torch.stack(x) for x in zip(*out))
            metrics = {"loss": loss, "tau": tau, "client": cs,
                       "pushed": pushed, "fetched": fetched}
            if race is not None:
                metrics["wall"] = t_fin
            return state, metrics
        return step

    # ----- fused: all K events advance in one batched protocol round -----
    vgrad = torch.func.vmap(grad_fn)
    use_cotangent = _use_cotangent(config)
    if use_cotangent and names_client_axis:
        if config.fused_mode == "cotangent":
            raise ValueError(
                "fused_mode='cotangent' does not support a client-axis mesh "
                "(the client axis splits the materialized per-event "
                "gradients)")
        use_cotangent = len(client_devices) <= 1
    batched_losses = (engine.resolve_event_batched_loss(loss_fn,
                                                        batched_loss_fn)
                      if use_cotangent else None)

    def batch_grads(p_e, xb, yb):
        """The window's per-event gradients and losses: one vmap, or, on a
        client axis of D devices, one per device over K/D events each,
        concatenated on the run's device in event order.  Over processes
        each process maps its own devices' chunks, and one collective
        (`server_shard.exchange`) brings every chunk to every process."""
        D = len(client_devices)
        if D <= 1:
            return vgrad(p_e, xb, yb)
        k = xb.shape[0]
        if k % D:
            raise ValueError(f"the client axis has {D} devices, which must "
                             f"divide the window's {k} events")
        n = k // D
        me = server_shard.process_rank()
        mine = {}
        for d, dev in enumerate(client_devices):
            if client_ranks is None or client_ranks[d] == me:
                g, loss = vgrad(*server_shard.on(
                    (tree_map(lambda l: l[d * n:(d + 1) * n], p_e),
                     xb[d * n:(d + 1) * n], yb[d * n:(d + 1) * n]), dev))
                mine[d] = leaves(g) + [loss]
        spec = [(tuple(t.shape), t.dtype) for t in next(iter(mine.values()))]
        parts = server_shard.exchange(client_ranks, mine, [spec] * D, home)
        cat = lambda i: torch.cat([part[i].to(home) for part in parts])
        n_leaves = len(spec) - 1
        return (unflatten(p_e, [cat(i) for i in range(n_leaves)]),
                cat(n_leaves))

    def step(state: SimState, draws: Draws):
        k = draws.idx.shape[0]
        if race is None:
            cs = _clients_of(config, state, draws)
        else:
            state, cs, t_fin = race.window(state, k)
        server = state.server
        like = server_shard.like(server).params
        model_bytes = tree_bytes(like)
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
            push_sent = masked_bytes(push, like)
        else:
            push = push_event = engine.transmit_gate(
                draws.push_u, server, bw.c_push, bw.eps)          # [K]
            push_sent = push.to(torch.float32).sum() * model_bytes
        # per-tensor staleness: each tensor's τ from its own last fetch
        grad_ts = (_leaf_tree(like, dedup_key)
                   if bw.per_tensor_fetch else dedup_key)

        if use_cotangent:
            # Σ_k w_k·g_k and the statistics' mean gradient as backward
            # passes of the batched forward; eligibility rules out the
            # gradient cache, per-tensor gating and gap rules
            new_server, taus, losses = engine.fused_apply_cotangent(
                scfg, server,
                lambda W, deltas: batched_losses(W, deltas, xb, yb),
                p_e, push, grad_ts)
        elif state.grad_cache is not None:
            grads, losses = batch_grads(p_e, xb, yb)
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
            grads, losses = batch_grads(p_e, xb, yb)
            new_server, taus = engine.fused_apply(
                scfg, server, grads, push, grad_ts, client_params=p_e)

        # --- fetch gates (post-apply server state) ---
        fetch, fetch_sent = _fetch_window(config, state, cs, new_server,
                                          draws.fetch_u, model_bytes)

        counters = engine.count_events(
            state.counters, push_event, fetch,
            push_bytes_sent=push_sent, push_bytes_total=k * model_bytes,
            fetch_bytes_sent=fetch_sent, fetch_bytes_total=k * model_bytes)
        if engine.fused_kernel_active(scfg):
            # one fused window = one launch per leaf consuming all K events
            counters = engine.count_kernel(counters, len(leaves(like)), k)
        # one window = one apply, every shard consuming its blocks of K
        counters = count_shard(counters, server, k)
        new_state = state._replace(server=new_server, rr_pos=state.rr_pos + k,
                                   counters=counters)
        metrics = {"loss": losses, "tau": taus, "client": cs,
                   "pushed": push_event, "fetched": fetch}
        if race is not None:
            metrics["wall"] = t_fin
        return new_state, metrics

    return step


def _build_queue_step(config: SimConfig, loss_fn, data_x, data_y,
                      batched_loss_fn=None, race=None):
    """``step(state, draws)`` for the queued protocol: one drain window.

    K arrivals (dispatch, stale-copy gradient, eq.-9 push gate against the
    pre-window server, admission into the ring), one drain of the
    ``[capacity]`` batch through the configured apply, then the K arriving
    clients' fetch gates against the post-drain server.  Serial arrivals
    take the gradient one event at a time, so ``queue_capacity=1`` with
    ``drain_all`` is the immediate-apply serial path; fused arrivals map
    the gradient over `dedup_events` representatives; cotangent arrivals
    queue the stale copy and the minibatch rows, and the forward and
    backward run at drain time.
    """
    grad_fn = torch.func.grad_and_value(loss_fn)
    vgrad = torch.func.vmap(grad_fn)
    bw = config.bandwidth
    scfg = config.server
    rule = server_rules.get_rule(scfg.rule)
    fused = config.apply_mode == "fused"
    use_cotangent = _use_cotangent(config)
    batched_losses = (engine.resolve_event_batched_loss(loss_fn,
                                                        batched_loss_fn)
                      if use_cotangent else None)
    count_shard = server_shard.shard_counter(config.server_shards,
                                              config.server_axis)

    def step(state: SimState, draws: Draws):
        K = draws.idx.shape[0]
        t_fin = None
        if race is None:
            cs = _clients_of(config, state, draws)
        else:
            state, cs, t_fin = race.window(state, K)
        server = state.server
        like = server_shard.like(server).params
        T = server_shard.gather(server, lambda s: s.timestamp, cs.device)
        model_bytes = tree_bytes(like)
        n_leaves = len(leaves(like))
        idx = draws.idx

        # --- push gates at arrival, all against the pre-window server ---
        if bw.per_tensor_push:
            push, _, _ = engine.per_tensor_gate(draws.push_u, server,
                                                bw.c_push, bw.eps)
            push_event = engine.any_leaf(push)                  # [K]
        else:
            push = push_event = engine.transmit_gate(
                draws.push_u, server, bw.c_push, bw.eps)        # [K]
        # the stale copies' timestamps double as the dedup key
        dedup_key = (state.client_leaf_ts[cs] if bw.per_tensor_fetch
                     else state.client_ts[cs])

        # --- arrival-side work → queue payload ---
        if use_cotangent:
            rep, _, _ = engine.dedup_events(dedup_key)
            payload = {"copy": engine.tree_index(state.client_params,
                                                 cs[rep]),
                       "idx": idx}
        elif fused:
            rep, _, _ = engine.dedup_events(dedup_key)
            p_e = engine.tree_index(state.client_params, cs[rep])
            grads, losses = vgrad(p_e, data_x[idx], data_y[idx])
            payload = {"grad": grads, "loss": losses}
            if rule.needs_client_params:
                payload["copy"] = p_e
        else:
            # one event at a time, as the immediate-apply serial path
            rows = []
            for j in range(K):
                p_c = _row(state.client_params, cs[j:j + 1])
                g, loss = grad_fn(p_c, data_x[idx[j]], data_y[idx[j]])
                row = {"grad": g, "loss": loss}
                if rule.needs_client_params:
                    row["copy"] = p_c
                rows.append(row)
            payload = tree_map(lambda *xs: torch.stack(xs), *rows)

        # --- admission ---
        arrivals = qlib.Arrivals(
            payload=payload, ts=state.client_ts[cs], client=cs,
            valid=push_event,
            leaf_ts=dedup_key if bw.per_tensor_fetch else None,
            leaf_mask=push if bw.per_tensor_push else None, wall=t_fin)
        queue, admitted, n_rejected, n_dropped = qlib.enqueue(
            state.queue, arrivals, config.admission_policy, T)
        depth_peak = queue.size
        # only admitted pushes crossed the wire: a rejected push is
        # refused before transmission
        if bw.per_tensor_push:
            push_sent = masked_bytes(tree_map(lambda m: m & admitted, push),
                                     like)
        else:
            push_sent = admitted.to(torch.float32).sum() * model_bytes

        # --- drain: apply the k_eff oldest queued events in one pass ---
        k_eff = qlib.drain_count(queue.size, config.drain_policy,
                                 drain_k=config.drain_k,
                                 gain=config.drain_adaptive_gain)
        queue, batch = qlib.dequeue(queue, k_eff)
        latency_sum = torch.where(
            batch.valid, (T - batch.enq_T).to(torch.float32), 0.0).sum()
        latency_wall_sum = (
            torch.where(batch.valid, state.scenario.now - batch.enq_wall,
                        0.0).sum() if race is not None else None)
        grad_ts = (_leaf_tree(like, batch.leaf_ts)
                   if bw.per_tensor_fetch else batch.ts)
        push_arg = qlib.drained_push_arg(batch, bw.per_tensor_push)
        # a placed payload reaches the apply placed; its losses and
        # minibatch rows are gathered
        cp = batch.payload.get("copy") if rule.needs_client_params else None
        if use_cotangent:
            rows = server_shard.gather(batch.payload["idx"])
            xb, yb = data_x[rows], data_y[rows]
            new_server, taus, dlosses = engine.fused_apply_cotangent(
                scfg, server,
                lambda W, deltas: batched_losses(W, deltas, xb, yb),
                batch.payload["copy"], push_arg, grad_ts)
        elif fused:
            new_server, taus = engine.fused_apply(
                scfg, server, batch.payload["grad"], push_arg, grad_ts,
                client_params=cp)
            dlosses = server_shard.gather(batch.payload["loss"])
        else:
            new_server, taus = engine.serial_apply(
                scfg, server, batch.payload["grad"], push_arg, grad_ts, cp)
            dlosses = server_shard.gather(batch.payload["loss"])

        # --- fetch gates: the K arriving clients, post-drain server ---
        fetch, fetch_sent = _fetch_window(config, state, cs, new_server,
                                          draws.fetch_u, model_bytes)

        counters = engine.count_events(
            state.counters, admitted, fetch,
            push_bytes_sent=push_sent, push_bytes_total=K * model_bytes,
            fetch_bytes_sent=fetch_sent, fetch_bytes_total=K * model_bytes)
        counters = qlib.count_queue(
            counters, enqueued=admitted.to(torch.int32).sum(),
            rejected=n_rejected, dropped=n_dropped, drained=k_eff,
            depth_post=queue.size, depth_peak=depth_peak,
            latency_sum=latency_sum, latency_wall_sum=latency_wall_sum)
        # kernel telemetry: a fused drain is one launch per leaf consuming
        # k_eff events; a serial drain computes every row's candidate
        # (capacity launches per leaf) and masks the invalid ones
        if fused and engine.fused_kernel_active(scfg):
            counters = engine.count_kernel(counters, n_leaves, k_eff)
        elif not fused and engine.serial_kernel_active(scfg,
                                                       bw.per_tensor_fetch):
            counters = engine.count_kernel(
                counters, batch.valid.shape[0] * n_leaves, k_eff)
        # one drain = one apply, every shard consuming its blocks of the
        # k_eff drained events
        counters = count_shard(counters, server, k_eff)

        new_state = state._replace(server=new_server, rr_pos=state.rr_pos + K,
                                   counters=counters, queue=queue)
        validf = batch.valid.to(torch.float32)
        nz = torch.clamp(k_eff, min=1).to(torch.float32)
        metrics = {
            # means over the drained (not the arriving) events
            "loss": (validf * dlosses).sum() / nz,
            "tau": (validf * taus).sum() / nz,
            "client": cs, "pushed": push_event, "fetched": fetch,
            "queue_depth": queue.size, "drained": k_eff,
            "admitted": admitted.to(torch.int32).sum(),
            "rejected": n_rejected, "dropped": n_dropped,
        }
        if t_fin is not None:
            metrics["wall"] = t_fin                 # per-arrival wall time
        return new_state, metrics

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
    batched_loss_fn: Optional[Callable] = None,
    scenario_draws=None,
    client_axis: str = "clients",
):
    """Run the deterministic simulation; returns a results dict.

    `num_steps` counts client events and is honoured exactly (a shorter
    final window covers any remainder).  The validation cost is measured on
    the *server* parameters every `eval_every` events.  `rng` is the RNG
    provider (`utils.rng.NativeDraws` from ``config.seed`` by default;
    `ReplayDraws` to replay recorded draws).  `init_params`, `data_x` and
    `data_y` are moved to `device` (labels as int64): the card unless the
    caller passes another device (`utils.device.resolve_device`).
    `batched_loss_fn` is the cotangent path's event-batched loss and
    `scenario_draws` the scenario's variate provider (`build_step_fn`).
    `mesh` (`launch.mesh.Mesh`) may carry a `client_axis` (the fleet
    arrays split by rows over it, and the fused gradient batch; see
    `build_step_fn`), a ``config.server_axis`` of exactly
    ``config.server_shards`` devices when that is above 1 (the server
    and the queue's payload placed on it, `core.server_shard`), or both.

    The dict has the reference's keys: ``steps``, ``val_cost``,
    ``wall_clock`` (the modelled wall clock at each evaluation under a
    scenario, else the unit event clock), ``counters`` (floats),
    ``final_timestamp``, ``state``, and ``train_loss`` / ``tau`` when
    `collect_step_metrics`.  The final state's `client_leaf_ts` is there
    under per-tensor fetch, its `queue` under a queue, its `scenario`
    under a scenario; the `queue_*` counters only under a queue and
    ``wall_clock`` / ``scenario_*`` only under a scenario, and the
    ``shard_*`` counters only when ``server_shards > 1``, as in the
    reference.  A sharded run's ``state.server`` stays placed
    (`core.server_shard.gather` makes it whole), as do the fleet arrays
    under a client axis of several devices (`FleetRows.gather`).
    """
    device = resolve_device(device)
    params = tree_map(lambda l: torch.as_tensor(l).to(device), init_params)
    data_x = torch.as_tensor(data_x).to(device)
    data_y = torch.as_tensor(data_y).to(device=device, dtype=torch.int64)
    if rng is None:
        rng = native_draws(config, data_x.shape[0], len(leaves(params)))
    step = build_step_fn(config, loss_fn, data_x, data_y,
                         batched_loss_fn=batched_loss_fn,
                         scenario_draws=scenario_draws, mesh=mesh,
                         client_axis=client_axis)
    state = init_sim(config, params, scenario_draws)
    if mesh is not None and client_axis in getattr(mesh, "axis_names", ()):
        state = shard_fleet(state, mesh, client_axis)
    if config.server_shards > 1:
        server_shard.validate_server_mesh(mesh, config.server_shards,
                                          config.server_axis)
        state = state._replace(
            server=server_shard.shard_server_state(state.server, mesh,
                                                   config.server_axis),
            queue=server_shard.shard_queue_state(state.queue, mesh,
                                                 config.server_axis))
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
                curve_cost.append(float(eval_fn(server_shard.gather(
                    state.server, lambda s: s.params, device))))
            # error against wall clock: the modelled time under a
            # scenario, else the unit event clock
            curve_wall.append(float(state.counters.wall_clock)
                              if config.scenario is not None
                              else float(done))

    counters = {k: float(v) for k, v in state.counters._asdict().items()}
    if not config.queue_capacity:
        # the queue telemetry only appears when a queue is configured
        counters = {k: v for k, v in counters.items()
                    if not k.startswith("queue_")}
    if config.scenario is None:
        # so does the wall-clock and scenario telemetry
        counters = {k: v for k, v in counters.items()
                    if k != "wall_clock" and not k.startswith("scenario_")}
    if not config.server.use_fused_kernel:
        # kernel-path telemetry only appears when the kernel path can run
        counters = {k: v for k, v in counters.items()
                    if not k.startswith("kernel_")}
    if config.server_shards <= 1:
        # partitioned-server telemetry only appears when the server shards
        counters = {k: v for k, v in counters.items()
                    if not k.startswith("shard_")}
    out = {
        "state": state,
        "steps": curve_steps,
        "val_cost": curve_cost,
        "wall_clock": curve_wall,
        "counters": counters,
        "final_timestamp": int(server_shard.gather(
            state.server, lambda s: s.timestamp)),
    }
    if collect_step_metrics:
        out["train_loss"] = torch.cat(train_losses)
        out["tau"] = torch.cat(taus)
    return out
