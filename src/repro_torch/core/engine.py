"""The shared async-SGD protocol core ("the engine"), ported from
`repro.core.engine`.

- **gates** — the B-FASGD eq. 9 push/fetch decisions (`transmit_gate`),
  against uniforms the caller draws through the RNG seam: one for the
  whole copy, or one per tensor (`per_tensor_gate`, §5);
- **gated application** — one server update under a push decision with the
  FRED drop policies (`apply_gated`: 'cache' re-applies the client's last
  transmitted gradient, 'skip' masks the update; both leaf by leaf under a
  per-leaf decision);
- **serial application** — pushed gradients applied one at a time in event
  order (`serial_apply`);
- **fused application** — one masked-sum update over a K-event window
  (`fused_apply`), through the one-kernel CUDA path
  (`kernels.ops.fused_event_apply`) for rules with a batched kernel mode,
  with per-leaf masks and staleness handed to the kernel leaf by leaf;
- **cotangent fused application** — the same window for rules whose fused
  scale is a per-event scalar (times one elementwise v-factor for
  `v_separable` rules), as weighted backward passes of one event-batched
  forward, without the [K, P] gradient batch (`fused_apply_cotangent`);
- **event dedup and scatter** — `dedup_events`, `last_event_winners`,
  `last_event_scatter`;
- **bookkeeping** — push/fetch opportunity `Counters`.

A decision is one device bool (or [K] of them) for the whole tree, or a
tree of them mirroring the parameters (`is_per_leaf`).  Every decision
stays on the device: gating is `torch.where`, never a host branch on a
tensor.

A server placed on shards (`core.server_shard.ShardedTree`) goes through
the same functions: the gates read its coupled v̄, and each apply runs
unchanged on every shard's block tree, its params-shaped operands routed
to the shards' blocks and the small ones (masks, timestamps) handed to
each shard whole.  Over processes each process applies its own shards
only (`core.server_shard`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import rules as server_rules
from repro_torch.core import server_shard
from repro_torch.core.bandwidth import per_tensor_transmit_mask, transmit_prob
from repro_torch.core.rules import ServerConfig, ServerState
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import leaves, same_structure, tree_map, unflatten


# ---------------------------------------------------------------------------
# tree helpers
# ---------------------------------------------------------------------------

def tree_index(tree, i):
    """Gather rows `i` (an int64 tensor) along every leaf's leading axis."""
    return tree_map(lambda l: l[i], tree)


def tree_where(pred, a, b):
    """Scalar-predicate select over matching trees (device predicate)."""
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def tree_where_axis(pred, a, b):
    """Per-row select: `pred` is [K] over the leading axis of every leaf."""
    return tree_map(
        lambda x, y: torch.where(pred.reshape((-1,) + (1,) * (x.dim() - 1)),
                                 x, y), a, b)


def is_per_leaf(x, like) -> bool:
    """True iff `x` is a tree of per-leaf values mirroring `like` (not one
    value shared by the whole tree)."""
    return same_structure(x, like)


def tree_select(mask_tree, a, b):
    """Leaf-aligned select: `mask_tree` mirrors `a`/`b`, leaves broadcast."""
    return tree_map(lambda m, x, y: torch.where(m, x, y), mask_tree, a, b)


def tree_select_axis(mask_tree, a, b):
    """Per-leaf per-row select: each mask leaf is [K] over the leading axis
    of the matching `a`/`b` leaf."""
    return tree_map(
        lambda m, x, y: torch.where(
            m.reshape((-1,) + (1,) * (x.dim() - 1)), x, y), mask_tree, a, b)


def any_leaf(mask_tree):
    """OR over the leaves of a per-leaf bool tree: one mask (scalar or
    [K]) for the whole tree."""
    ls = leaves(mask_tree)
    out = ls[0]
    for m in ls[1:]:
        out = out | m
    return out


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

class Counters(NamedTuple):
    """Push/fetch opportunity accounting (device scalars).

    `push_actual` and `push_bytes_sent` count admitted pushes only: a push
    the ingress queue rejects is refused before transmission.  The
    `queue_*` fields are the ingress queue's telemetry (`core.queue`,
    folded in by `queue.count_queue`) and stay zero without a queue;
    `queue_latency_wall_sum` is its latency on a scenario's modelled wall
    clock.  `wall_clock` and the `scenario_*` fields are a scenario's
    telemetry (`core.scenarios.count_scenario`, or `advance_wall` in the
    round trainer) and stay zero without one.  `kernel_*` count per-leaf
    kernel launches and the events they consumed.  `shard_*` are a
    sharded server's telemetry (`core.server_shard.count_shard`) and stay
    zero with one shard.
    """
    push_potential: torch.Tensor   # int32
    push_actual: torch.Tensor
    fetch_potential: torch.Tensor
    fetch_actual: torch.Tensor
    push_bytes_sent: torch.Tensor  # float32
    push_bytes_total: torch.Tensor
    fetch_bytes_sent: torch.Tensor
    fetch_bytes_total: torch.Tensor
    queue_enqueued: torch.Tensor   # int32 — pushes admitted to the ring
    queue_rejected: torch.Tensor   # int32 — refused before transmission
    queue_dropped: torch.Tensor    # int32 — evicted by drop_oldest
    queue_drained: torch.Tensor    # int32 — events applied from the ring
    queue_depth_sum: torch.Tensor  # float32 — Σ post-drain depth per window
    queue_depth_peak: torch.Tensor  # int32 — max post-admission depth
    queue_latency_sum: torch.Tensor  # float32 — Σ admission→drain T-ticks
    queue_windows: torch.Tensor    # int32 — drain windows accumulated
    wall_clock: torch.Tensor       # float32 — latest modelled wall time
    scenario_dropouts: torch.Tensor  # int32 — clients lost to churn
    scenario_rejoins: torch.Tensor   # int32 — clients recovered by churn
    scenario_active_sum: torch.Tensor  # float32 — Σ active clients per window
    scenario_windows: torch.Tensor   # int32 — scenario windows accumulated
    queue_latency_wall_sum: torch.Tensor  # float32 — Σ admission→drain wall
    kernel_launches: torch.Tensor  # int32
    kernel_events: torch.Tensor
    shard_applies: torch.Tensor    # int32 — windows applied on the shards
    shard_events: torch.Tensor     # int32 — events those windows consumed
    shard_bytes_peak: torch.Tensor  # float32 — max per-shard resident bytes
    shard_depth_peak: torch.Tensor  # int32 — max events in one window


def init_counters(device=None) -> Counters:
    """All-zero `Counters` on `device` (the card unless the caller passes
    another)."""
    device = resolve_device(device)
    z = lambda dt: torch.zeros((), dtype=dt, device=device)
    i32, f32 = torch.int32, torch.float32
    return Counters(z(i32), z(i32), z(i32), z(i32), z(f32), z(f32), z(f32),
                    z(f32), z(i32), z(i32), z(i32), z(i32), z(f32), z(i32),
                    z(f32), z(i32), z(f32), z(i32), z(i32), z(f32), z(i32),
                    z(f32), z(i32), z(i32), z(i32), z(i32), z(f32), z(i32))


def count_events(counters: Counters, push, fetch, push_bytes_sent=None,
                 push_bytes_total=None, fetch_bytes_sent=None,
                 fetch_bytes_total=None) -> Counters:
    """Fold one batch of events in: `push`/`fetch` are bool scalars or [K].

    Byte amounts accumulate in float32, as in the reference.
    """
    acc = lambda prev, amount: prev if amount is None else prev + amount
    return counters._replace(
        push_potential=counters.push_potential + push.numel(),
        push_actual=counters.push_actual + push.to(torch.int32).sum(),
        fetch_potential=counters.fetch_potential + fetch.numel(),
        fetch_actual=counters.fetch_actual + fetch.to(torch.int32).sum(),
        push_bytes_sent=acc(counters.push_bytes_sent, push_bytes_sent),
        push_bytes_total=acc(counters.push_bytes_total, push_bytes_total),
        fetch_bytes_sent=acc(counters.fetch_bytes_sent, fetch_bytes_sent),
        fetch_bytes_total=acc(counters.fetch_bytes_total, fetch_bytes_total),
    )


def count_kernel(counters: Counters, launches: int, events: int) -> Counters:
    """Fold one kernel-path application window into the telemetry:
    `launches` per-leaf kernel launches consuming `events` events."""
    return counters._replace(
        kernel_launches=counters.kernel_launches + launches,
        kernel_events=counters.kernel_events + events)


def fused_kernel_active(scfg: ServerConfig) -> bool:
    """`fused_apply` routes through the one-kernel path: a rule with a
    batched kernel mode and no per-leaf gap tensors."""
    rule = server_rules.get_rule(scfg.rule)
    return bool(scfg.use_fused_kernel
                and rule.batched_kernel_mode is not None
                and not rule.needs_client_params)


def serial_kernel_active(scfg: ServerConfig,
                         per_tensor_tau: bool = False) -> bool:
    """Serial `apply_update` routes through the rule's single-push kernel,
    which takes a scalar τ only: per-tensor staleness keeps it off."""
    rule = server_rules.get_rule(scfg.rule)
    return bool(scfg.use_fused_kernel and rule.kernel_op is not None
                and not per_tensor_tau)


# ---------------------------------------------------------------------------
# gates — B-FASGD eq. 9
# ---------------------------------------------------------------------------

def transmit_gate(u, server: ServerState, c, eps):
    """Eq.-9 decision(s) ``u < 1/(1 + c/(v̄+ε))`` for uniforms `u` (a scalar
    or [K]).

    The reference draws ``u`` inside this function; here the run's RNG
    provider draws it for every event, whether or not gating is on (c = 0
    gives probability exactly 1), which keeps every other stream fixed.
    """
    return u < transmit_prob(server_rules.vbar(server), c, eps)


def _server_v(server):
    """The server's v tree: placed when the server is."""
    if server_shard.is_sharded(server):
        return server.sub(lambda s: s.v)
    return server.v


def per_tensor_gate(u, server: ServerState, c, eps):
    """§5: one eq.-9 decision per parameter tensor, against that tensor's
    own v̄ (both directions).  `u` is [n_leaves] for one event or [K,
    n_leaves] for a window.  Returns (mask tree mirroring the params with
    scalar or [K] leaves, transmitted bytes, total bytes); c = 0 transmits
    every leaf."""
    return per_tensor_transmit_mask(u, _server_v(server), c, eps)


def _per_shard(server, fn, *trees, batch_dims=0):
    """``fn(block_server, *block_trees, device)`` on every shard this
    process holds of a placed server, in shard order: `trees`
    (params-shaped, `batch_dims` leading event dimensions, or placed
    already) routed to each shard's blocks just before its apply.  Returns
    the per-shard list of results, None for another process's shard."""
    return [None if blk is None else
            fn(blk, *(server_shard.block_of(t, server, s, batch_dims)
                      for t in trees), server.devices[s])
            for s, blk in enumerate(server.blocks)]


def _part(outs, i):
    """Entry `i` of each shard's result pair (None stays None)."""
    return [None if o is None else o[i] for o in outs]


# ---------------------------------------------------------------------------
# gated application — one event
# ---------------------------------------------------------------------------

def _merge_extra(extra_old, extra_new, push, like, any_push):
    """Per-leaf merge of the rule's `ServerState.extra`: entries that mirror
    the params tree (gap's ĝ EMA) follow the per-leaf mask; anything else
    (counts, buffers) takes the new value iff any leaf pushed."""
    if extra_old is None:
        return extra_new
    if isinstance(extra_old, dict):
        return {k: (tree_select(push, extra_new[k], sub)
                    if same_structure(sub, like)
                    else tree_where(any_push, extra_new[k], sub))
                for k, sub in extra_old.items()}
    return tree_where(any_push, extra_new, extra_old)


def merge_gated_state(old: ServerState, cand: ServerState,
                      push) -> ServerState:
    """Per-leaf 'skip': keep the candidate update only on the pushed leaves
    (parameters and their statistics); T advances iff any leaf pushed.  Not
    meaningful for the barrier rules, whose configurations refuse it."""
    any_push = torch.stack([m.any() for m in leaves(push)]).any()
    return ServerState(
        params=tree_select(push, cand.params, old.params),
        timestamp=torch.where(any_push, cand.timestamp, old.timestamp),
        n=tree_select(push, cand.n, old.n),
        b=tree_select(push, cand.b, old.b),
        v=tree_select(push, cand.v, old.v),
        extra=_merge_extra(old.extra, cand.extra, push, old.params, any_push),
    )


def apply_gated(scfg: ServerConfig, server: ServerState, grad, push, grad_ts,
                *, client_params=None, cached_grad=None):
    """One server application under a push decision: one device bool for
    the whole gradient, or a per-leaf tree of them (§5 per-tensor push).

    cached_grad is not None → 'cache': a dropped push (or dropped leaf)
      re-applies that client's most recent transmitted gradient (leaf), so
      the server still moves and T still advances.
    cached_grad is None     → 'skip' (or no gating): a dropped push masks
      the update out — the whole state for one decision, leaf by leaf for
      a per-leaf one (T then advances iff any leaf pushed).  The candidate
      is computed all the same (and its kernel launched), then discarded
      by `torch.where`.

    `client_params` is the copy the gradient was computed on (gap-aware
    rules measure against it).  Returns (new_server, aux).
    """
    if server_shard.is_sharded(server):
        outs = _per_shard(
            server, lambda blk, g, cp, cg, dev: apply_gated(
                scfg, blk, g, server_shard.on(push, dev),
                server_shard.on(grad_ts, dev), client_params=cp,
                cached_grad=cg), grad, client_params, cached_grad)
        return (server.with_blocks(_part(outs, 0)),
                server_shard.merge_aux(server, _part(outs, 1)))
    per_leaf = is_per_leaf(push, server.params)
    if cached_grad is not None:
        g_eff = (tree_select(push, grad, cached_grad) if per_leaf
                 else tree_where(push, grad, cached_grad))
        return server_rules.apply_update(scfg, server, g_eff, grad_ts,
                                         client_params=client_params)
    cand, aux = server_rules.apply_update(scfg, server, grad, grad_ts,
                                          client_params=client_params)
    if per_leaf:
        return merge_gated_state(server, cand, push), aux
    return tree_where(push, cand, server), aux


# ---------------------------------------------------------------------------
# serial application — the paper-faithful lock order
# ---------------------------------------------------------------------------

def serial_apply(scfg: ServerConfig, server: ServerState, grads, push,
                 grad_ts, client_params=None):
    """Apply pushed gradients one at a time in event order (lock = order).

    `grads` leaves are [K, ...]; `push`/`grad_ts` are [K], or per-leaf trees
    with [K] leaves (per-tensor push / staleness); `client_params`
    (optional, [K, ...] leaves) feeds the gap-aware rule.  Returns (server,
    taus [K]).  A placed server applies the K events on each shard in turn.
    """
    if server_shard.is_sharded(server):
        outs = _per_shard(
            server, lambda blk, g, cp, dev: serial_apply(
                scfg, blk, g, server_shard.on(push, dev),
                server_shard.on(grad_ts, dev), cp),
            grads, client_params, batch_dims=1)
        return _assemble(server, outs)
    taus = []
    for k in range(leaves(grads)[0].shape[0]):
        row = lambda tree: tree_index(tree, k)
        server, aux = apply_gated(
            scfg, server, row(grads), row(push), row(grad_ts),
            client_params=(None if client_params is None
                           else row(client_params)))
        taus.append(aux["tau"])
    return server, torch.stack(taus)


# ---------------------------------------------------------------------------
# fused application — one masked-sum update over the whole event batch
# ---------------------------------------------------------------------------

def fused_apply(scfg: ServerConfig, server: ServerState, grads, push,
                client_ts, client_params=None):
    """One masked-sum application of all pushed gradients.

    `grads` leaves are [K, ...].  `push` is [K], or a per-leaf tree of [K]
    masks (per-tensor push: T advances by the events that pushed any
    leaf); `client_ts` is [K], or a per-leaf tree of [K] timestamps
    (per-tensor staleness).  Stats (n, b, v, extra) advance once with the
    mean pushed gradient (per leaf under per-leaf masks, where a leaf no
    event pushed keeps its statistics) iff `scfg.track_stats` or the rule
    requires them; the weight delta Σ_k m_k·scale(v, τ_k)·g_k is taken
    against the post-stats v; `client_params` ([K, ...] leaves) gives the
    gap-aware rule its θ_T − θ_ts.  With `scfg.use_fused_kernel` and a
    rule with a batched kernel mode, the application is one
    `kernels.ops.fused_event_apply` call over the tree (one kernel launch
    on the card), which gets each leaf's own w/wmean/τ/has_push under
    per-leaf masks or staleness, and advances n/b/v too where the rule
    keeps the shared statistics and no `extra`.

    Returns (server, taus [K] — averaged over leaves under per-leaf
    staleness).  A placed server applies the window on each shard (one
    kernel launch a shard on the kernel path).
    """
    if server_shard.is_sharded(server):
        outs = _per_shard(
            server, lambda blk, g, cp, dev: fused_apply(
                scfg, blk, g, server_shard.on(push, dev),
                server_shard.on(client_ts, dev), cp),
            grads, client_params, batch_dims=1)
        return _assemble(server, outs)
    rule = server_rules.get_rule(scfg.rule)
    if not rule.supports_fused:
        raise ValueError(
            f"rule {scfg.rule!r} does not support the fused apply mode")
    per_leaf_push = is_per_leaf(push, server.params)
    per_leaf_ts = is_per_leaf(client_ts, server.params)
    track_stats = scfg.track_stats or rule.requires_stats

    if per_leaf_push:
        pushf = tree_map(lambda m: m.to(torch.float32), push)
        # an event is a server update iff it transmitted at least one leaf
        n_push = any_leaf(push).to(torch.int32).sum()
        n_push_leaf = tree_map(lambda m: m.to(torch.int32).sum(), push)
    else:
        n_push = push.to(torch.int32).sum()
        pushf = push.to(torch.float32)

    gap = None
    if rule.needs_client_params and client_params is not None:
        # per-event parameter-space divergence θ_T − θ_ts, leaves [K, ...]
        gap = tree_map(lambda sp, cp: sp[None].float() - cp.float(),
                       server.params, client_params)

    use_kernel = (scfg.use_fused_kernel
                  and rule.batched_kernel_mode is not None and gap is None)
    # the kernel advances the statistics itself only where they are the
    # shared eqs. 4-6 with no `extra` to merge
    kernel_stats = (
        use_kernel and track_stats and server.extra is None
        and type(rule).update_stats is server_rules.UpdateRule.update_stats)

    if track_stats and not kernel_stats:
        if per_leaf_push:
            mean_g = tree_map(
                lambda m, g, n: torch.einsum("c,c...->...", m, g.float())
                / torch.clamp(n, min=1), pushf, grads, n_push_leaf)
            stats_state = rule.update_stats(scfg, server, mean_g)
            has_push_leaf = tree_map(lambda n: n > 0, n_push_leaf)
            server = server._replace(
                n=tree_select(has_push_leaf, stats_state.n, server.n),
                b=tree_select(has_push_leaf, stats_state.b, server.b),
                v=tree_select(has_push_leaf, stats_state.v, server.v),
                extra=_merge_extra(server.extra, stats_state.extra,
                                   has_push_leaf, server.params, n_push > 0))
        else:
            mean_g = tree_map(
                lambda g: torch.einsum("c,c...->...", pushf, g.float())
                / torch.clamp(n_push, min=1), grads)
            stats_state = rule.update_stats(scfg, server, mean_g)
            server = tree_where(n_push > 0, stats_state, server)

    if per_leaf_ts:
        taus_tree = tree_map(
            lambda ts: server_rules.step_staleness(server.timestamp, ts),
            client_ts)                                        # leaves [K]
        taus = server_rules.mean_leaf_tau(taus_tree)          # [K]
    else:
        taus = server_rules.step_staleness(server.timestamp, client_ts)

    n_leaves = len(leaves(server.params))
    t_leaves = leaves(taus_tree) if per_leaf_ts else [taus] * n_leaves
    m_leaves = leaves(pushf) if per_leaf_push else [pushf] * n_leaves

    if use_kernel:
        from repro_torch.kernels.ops import fused_event_apply
        if rule.batched_kernel_mode == "coeff":
            w_leaves = [rule.fused_coeffs(scfg, t) * m
                        for t, m in zip(t_leaves, m_leaves)]
        else:
            w_leaves = m_leaves
        if per_leaf_push:
            np_leaves = leaves(n_push_leaf)
            wm_leaves = [m / torch.clamp(c, min=1)
                         for m, c in zip(m_leaves, np_leaves)]
            hp_leaves = [c > 0 for c in np_leaves]
        else:
            wm_leaves = [pushf / torch.clamp(n_push, min=1)] * n_leaves
            hp_leaves = [n_push > 0] * n_leaves
        unfl = lambda ls: unflatten(server.params, ls)
        f32 = lambda tr: tree_map(lambda l: l.float(), tr)
        # one [K] tensor shared by every leaf is handed over once
        new_params, n_new, b_new, v_new = fused_event_apply(
            server.params, tree_map(torch.Tensor.contiguous, grads),
            f32(server.n), f32(server.b), f32(server.v), unfl(w_leaves),
            unfl(wm_leaves), unfl(t_leaves), unfl(hp_leaves), lr=scfg.lr,
            gamma=scfg.gamma, beta=scfg.beta, eps=scfg.eps,
            variant=scfg.variant, mode=rule.batched_kernel_mode,
            track_stats=kernel_stats)
        if kernel_stats:
            cast = lambda new, old: tree_map(lambda a, o: a.to(o.dtype),
                                             new, old)
            server = server._replace(
                n=cast(n_new, server.n), b=cast(b_new, server.b),
                v=cast(v_new, server.v))
    elif rule.batched_kernel_mode == "coeff" and gap is None:
        # v-independent scale: one contraction over the event axis per leaf,
        # in float32 as the reference's type promotion does (bf16 θ comes
        # back float32)
        new_params = unflatten(server.params, [
            p - torch.einsum("k,k...->...", rule.fused_coeffs(scfg, t) * m,
                             g.float())
            for p, g, t, m in zip(leaves(server.params), leaves(grads),
                                  t_leaves, m_leaves)])
    else:
        v_leaves = leaves(server.v)
        gap_leaves = (leaves(gap) if gap is not None
                      else [None] * len(v_leaves))
        e_leaves = server_rules.extra_leaf_dicts(server.extra, server.v)
        deltas = []
        for v_leaf, g_leaf, e_leaf, gap_leaf, t_leaf, m_leaf in zip(
                v_leaves, leaves(grads), e_leaves, gap_leaves, t_leaves,
                m_leaves):
            expand = (-1,) + (1,) * v_leaf.dim()
            scale = rule.scale_leaf(scfg, v_leaf[None], t_leaf.reshape(expand),
                                    extra=e_leaf, gap=gap_leaf)
            deltas.append(torch.sum(m_leaf.reshape(expand) * scale * g_leaf,
                                    dim=0))
        new_params = tree_map(torch.subtract, server.params,
                              unflatten(server.params, deltas))
    # T keeps its int32 (a sum of int32 counts comes back int64)
    server = server._replace(
        params=new_params,
        timestamp=server.timestamp + n_push.to(server.timestamp.dtype))
    return server, taus


def _assemble(server, outs):
    """(placed server, this process's first shard's second output on its
    device) from the shards' (block server, per-event values) pairs."""
    return (server.with_blocks(_part(outs, 0)),
            server_shard.on(server.first(outs)[1], server.home))


# ---------------------------------------------------------------------------
# cotangent fused application — rules with a per-event scalar scale
# ---------------------------------------------------------------------------

def event_batched_losses(loss_fn):
    """Generic event-batched loss: ``batched(W, deltas, *batch) -> [K]``,
    each event's stale parameters entering as p_k = W + δ_k (`deltas`
    leaves [K, ...], detached).

    It maps `loss_fn` over the per-event parameters with `torch.func.vmap`:
    right for any loss, but the backward of the per-event GEMMs still forms
    a [K, P] gradient batch before summing.  A model avoids that with a
    shared/delta form whose differentiable operand is the shared W, exposed
    as ``loss_fn.event_batched`` (`repro_torch.models.mlp`).
    """
    def batched(W, deltas, *batch):
        p_eff = tree_map(lambda w, d: w[None] + d, W, deltas)
        return torch.func.vmap(loss_fn)(p_eff, *batch)
    return batched


def resolve_event_batched_loss(loss_fn, batched_loss_fn=None):
    """The event-batched form of `loss_fn` for the cotangent fused path: an
    explicit `batched_loss_fn`, else ``loss_fn.event_batched``, else the
    generic `event_batched_losses`."""
    if batched_loss_fn is not None:
        return batched_loss_fn
    attached = getattr(loss_fn, "event_batched", None)
    if attached is not None:
        return attached
    return event_batched_losses(loss_fn)


class _ReweightByV(torch.autograd.Function):
    """Identity forward; the backward scales the cotangent by `vfac`."""

    @staticmethod
    def forward(ctx, w, vfac):
        ctx.save_for_backward(vfac)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, ct):
        (vfac,) = ctx.saved_tensors
        return (vfac * ct).to(ct.dtype), None


def reweight_by_v(W, vfac):
    """Identity in the tree `W` whose pullback scales each leaf's cotangent
    elementwise by the matching leaf of `vfac`.

    The fused delta of a `v_separable` rule factorises as
    Δθ = vfac(v) ⊙ Σ_k w_k·g_k with per-event scalars w_k (fasgd: w_k =
    m_k·lr/τ_k, vfac = 1/(v+ε)).  The pullback is elementwise-linear, so it
    commutes with the event-axis contraction: `fused_apply_cotangent`
    contracts once with the scalar weights, then pulls the result through
    this function against the post-stats v.
    """
    return tree_map(_ReweightByV.apply, W, vfac)


def fused_apply_cotangent(scfg: ServerConfig, server: ServerState,
                          event_losses, stale_params, push, client_ts,
                          reduce=None):
    """Fused application as weighted backward passes — no [K, P] gradient
    batch.

    For rules with v-independent coefficients the fused update needs only

        Δθ = Σ_k m_k·c(τ_k)·g_k      and      ḡ = Σ_k m_k·g_k / n_push,

    both linear in the per-event gradients, so both are backward passes of
    one batched forward with per-event cotangent weights (two
    `torch.autograd.grad` calls over one retained graph).
    `v_separable` rules (fasgd) contract with the scalar part of their
    scale and apply the elementwise v-factor once afterwards, through
    `reweight_by_v`, against the post-stats v.

    `event_losses(W, deltas) -> [K]` evaluates every event's loss with its
    stale parameters p_k = W + δ_k, δ_k = p_k − W detached (`deltas` is
    built here from `stale_params`, [K, ...] leaves); the gradient with
    respect to W contracts the weight-gradient GEMMs over the event axis.
    `push` and `client_ts` are [K]: per-leaf trees are refused (per-leaf
    weights cannot ride one cotangent vector).  Statistics advance once
    with ḡ where some event pushed, iff `scfg.track_stats` or the rule
    requires them; T advances by the number of pushes.

    `reduce` (None: none) maps the tree (losses, Δ, ḡ) to its mean over
    a group of processes that each evaluated `event_losses` on their rows
    of every event's batch (`sharding.reduce.GroupMean`), between the
    pullbacks and the update: the weights of both pullbacks depend on T
    and the pushes, never on the losses, so both sums are linear in the
    rows and their mean over equal row shards is the whole batch's.

    Returns (server, taus [K], losses [K]).  On a placed server the
    contraction runs on the gathered parameters (the loss needs W whole);
    the statistics and the update then run on each shard's blocks.
    """
    rule = server_rules.get_rule(scfg.rule)
    if not (rule.supports_fused
            and (rule.coeffs_are_v_independent or rule.v_separable)):
        raise ValueError(
            f"rule {scfg.rule!r} does not support the cotangent fused path "
            f"(needs supports_fused and coeffs_are_v_independent or "
            f"v_separable)")
    like = server_shard.like(server)
    if is_per_leaf(push, like.params) or is_per_leaf(client_ts, like.params):
        raise ValueError(
            "per-leaf push masks / timestamps require the materialized "
            "fused path (per-leaf weights cannot ride one cotangent vector)")
    params, T = server_shard.gather(server, lambda s: (s.params, s.timestamp))
    pushf = push.to(torch.float32)
    n_push = push.to(torch.int32).sum()
    taus = server_rules.step_staleness(T, client_ts)                  # [K]
    coeffs = rule.fused_coeffs(scfg, taus)                            # [K]

    deltas = tree_map(lambda p, w: (p - w[None]).detach(),
                      server_shard.gather(stale_params), params)
    W = leaves(tree_map(lambda w: w.detach().requires_grad_(), params))
    track_stats = scfg.track_stats or rule.requires_stats
    mean_g = None
    with torch.enable_grad():
        losses = event_losses(unflatten(params, W), deltas)
        w_delta = (pushf * coeffs).to(losses.dtype)
        delta = torch.autograd.grad(losses, W, grad_outputs=w_delta,
                                    retain_graph=track_stats)
        if track_stats:
            w_mean = (pushf / torch.clamp(n_push, min=1)).to(losses.dtype)
            mean_g = unflatten(params, list(torch.autograd.grad(
                losses, W, grad_outputs=w_mean)))
    delta = unflatten(params, list(delta))
    losses = losses.detach()
    if reduce is not None:
        losses, delta, mean_g = reduce((losses.clone(), delta, mean_g))
    if server_shard.is_sharded(server):
        server = server.with_blocks(_per_shard(
            server, lambda blk, d, m, dev: _cotangent_update(
                scfg, rule, blk, d, m, n_push.to(dev)), delta, mean_g))
    else:
        server = _cotangent_update(scfg, rule, server, delta, mean_g, n_push)
    return server, taus, losses


def _cotangent_update(scfg, rule, server, delta, mean_g, n_push):
    """The elementwise end of `fused_apply_cotangent`: the statistics step
    on the mean gradient `mean_g` where some event pushed (None: no
    statistics), a `v_separable` rule's v-factor on the contraction
    `delta` against the post-stats v, θ − delta, and T + n_push."""
    if mean_g is not None:
        stats_state = rule.update_stats(scfg, server, mean_g)
        server = tree_where(n_push > 0, stats_state, server)
    delta = leaves(delta)
    if not rule.coeffs_are_v_independent:
        # v_separable: the elementwise v-factor, once, against the
        # post-stats v
        vfac = leaves(rule.fused_vfactor(scfg, server.v))
        with torch.enable_grad():
            W = [w.detach().requires_grad_() for w in leaves(server.params)]
            delta = torch.autograd.grad(
                leaves(reweight_by_v(W, vfac)), W, grad_outputs=delta)
    new_params = tree_map(torch.subtract, server.params,
                          unflatten(server.params, list(delta)))
    return server._replace(
        params=new_params,
        timestamp=server.timestamp + n_push.to(server.timestamp.dtype))


# ---------------------------------------------------------------------------
# event dedup and deterministic duplicate-client resolution
# ---------------------------------------------------------------------------

def dedup_events(ts):
    """Group an event batch by identical fetch timestamps `ts` [K].

    Returns `(rep, counts, is_rep)`: `rep[k]` is the first event with k's
    timestamp, `counts[k]` the size of k's group, `is_rep[k]` whether k is
    its group's representative.  Clients that fetched at the same T hold
    identical copies, so gathering through `rep` is numerically a no-op.
    """
    t = ts if ts.dim() == 2 else ts[:, None]
    same = torch.all(t[:, None, :] == t[None, :, :], dim=-1)      # [K, K]
    rep = torch.argmax(same.to(torch.int32), dim=1)               # first True
    counts = same.to(torch.int32).sum(dim=1)
    is_rep = rep == torch.arange(t.shape[0], device=t.device)
    return rep, counts, is_rep


def last_event_winners(clients, eligible=None):
    """[K] bool: event k wins iff no later eligible event targets its
    client."""
    k = clients.shape[0]
    order = torch.arange(k, device=clients.device)
    if eligible is None:
        eligible = torch.ones(k, dtype=torch.bool, device=clients.device)
    later_same = ((clients[None, :] == clients[:, None]) & eligible[None, :]
                  & (order[None, :] > order[:, None]))
    return eligible & ~torch.any(later_same, dim=1)


def last_event_source(clients, eligible):
    """[K] int64: for event k, the last eligible event that targets k's
    client, or -1 if none does.

    Scattering ``values[source[k]]`` (or the old row where -1) to
    ``clients[k]`` for every k writes one value to every duplicate index,
    so the scatter is deterministic whatever order the device applies the
    duplicates in.  This is how the port gets the reference's
    ``mode="drop"`` scatter, which torch does not have, without a host sync
    or a data-dependent shape.
    """
    k = clients.shape[0]
    order = torch.arange(1, k + 1, device=clients.device)
    cand = (clients[None, :] == clients[:, None]) & eligible[None, :]
    return (cand.to(torch.int64) * order[None, :]).amax(dim=1) - 1


def scatter_rows_(leaf, clients, values, source):
    """In place: row ``clients[k]`` of `leaf` ← ``values[source[k]]``, or
    keeps its old value where ``source[k] == -1``.  Returns `leaf`."""
    new = values[source.clamp(min=0)]
    old = leaf[clients]
    keep = (source < 0).reshape((-1,) + (1,) * (leaf.dim() - 1))
    leaf[clients] = torch.where(keep, old, new.to(leaf.dtype))
    return leaf


def last_event_scatter(tree, clients, values, eligible):
    """Scatter per-event `values` ([K, ...] leaves) into per-client `tree`
    ([λ, ...] leaves) with last-eligible-event-wins semantics.  `eligible`
    is one [K] mask for every leaf, or a per-leaf tree of [K] masks (per-
    tensor push: each leaf of the gradient cache advances only where that
    leaf was transmitted).

    Updates `tree`'s leaves in place (the fleet arrays are owned by the
    simulation loop, and a copy would cost a fleet-sized write per window)
    and returns it.  The reference's `num_slots` (its out-of-range drop
    index) has no use here: every duplicate index writes one value.
    """
    if is_per_leaf(eligible, tree):
        tree_map(lambda l, v, e: scatter_rows_(
            l, clients, v, last_event_source(clients, e)),
            tree, values, eligible)
        return tree
    source = last_event_source(clients, eligible)
    tree_map(lambda l, v: scatter_rows_(l, clients, v, source), tree, values)
    return tree
