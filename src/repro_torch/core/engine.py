"""The shared async-SGD protocol core ("the engine"), ported from
`repro.core.engine`.

- **gates** — the B-FASGD eq. 9 push/fetch decisions (`transmit_gate`),
  against uniforms the caller draws through the RNG seam;
- **gated application** — one server update under a push decision with the
  FRED drop policies (`apply_gated`: 'cache' re-applies the client's last
  transmitted gradient, 'skip' masks the whole update);
- **serial application** — pushed gradients applied one at a time in event
  order (`serial_apply`);
- **fused application** — one masked-sum update over a K-event window
  (`fused_apply`), through the one-kernel CUDA path
  (`kernels.ops.fused_event_apply`) for rules with a batched kernel mode;
- **event dedup and scatter** — `dedup_events`, `last_event_winners`,
  `last_event_scatter`;
- **bookkeeping** — push/fetch opportunity `Counters`.

Every decision stays on the device: gating is `torch.where`, never a host
branch on a tensor.  Per-tensor (§5) masks and timestamps and the cotangent
fused path wait for a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import rules as server_rules
from repro_torch.core.bandwidth import transmit_prob
from repro_torch.core.rules import ServerConfig, ServerState
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import leaves, tree_map, unflatten


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


def _reject_per_leaf(x, what):
    if isinstance(x, (list, tuple, dict)):
        raise NotImplementedError(
            f"per-tensor {what} (§5) is not ported to repro_torch yet")


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

class Counters(NamedTuple):
    """Push/fetch opportunity accounting (device scalars).

    The reference's queue, scenario and shard fields belong to modules not
    ported yet; the fields kept here are the ones the immediate-apply
    simulator reports.  `kernel_*` count per-leaf kernel launches and the
    events they consumed.
    """
    push_potential: torch.Tensor   # int32
    push_actual: torch.Tensor
    fetch_potential: torch.Tensor
    fetch_actual: torch.Tensor
    push_bytes_sent: torch.Tensor  # float32
    push_bytes_total: torch.Tensor
    fetch_bytes_sent: torch.Tensor
    fetch_bytes_total: torch.Tensor
    kernel_launches: torch.Tensor  # int32
    kernel_events: torch.Tensor


def init_counters(device=None) -> Counters:
    """All-zero `Counters` on `device` (the card unless the caller passes
    another)."""
    device = resolve_device(device)
    z = lambda dt: torch.zeros((), dtype=dt, device=device)
    i32, f32 = torch.int32, torch.float32
    return Counters(z(i32), z(i32), z(i32), z(i32), z(f32), z(f32), z(f32),
                    z(f32), z(i32), z(i32))


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
    """`fused_apply` routes through the one-kernel path."""
    rule = server_rules.get_rule(scfg.rule)
    return bool(scfg.use_fused_kernel
                and rule.batched_kernel_mode is not None)


def serial_kernel_active(scfg: ServerConfig) -> bool:
    """Serial `apply_update` routes through the rule's single-push kernel."""
    rule = server_rules.get_rule(scfg.rule)
    return bool(scfg.use_fused_kernel and rule.kernel_op is not None)


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


# ---------------------------------------------------------------------------
# gated application — one event
# ---------------------------------------------------------------------------

def apply_gated(scfg: ServerConfig, server: ServerState, grad, push, grad_ts,
                *, cached_grad=None):
    """One server application under a (device bool) push decision.

    cached_grad is not None → 'cache': a dropped push re-applies that
      client's most recent transmitted gradient, so the server still moves
      and T still advances.
    cached_grad is None     → 'skip' (or no gating): a dropped push masks
      the whole update out.  The candidate is computed all the same (and its
      kernel launched), then discarded by `torch.where`.

    Returns (new_server, aux).
    """
    _reject_per_leaf(push, "push gating")
    if cached_grad is not None:
        g_eff = tree_where(push, grad, cached_grad)
        return server_rules.apply_update(scfg, server, g_eff, grad_ts)
    cand, aux = server_rules.apply_update(scfg, server, grad, grad_ts)
    return tree_where(push, cand, server), aux


# ---------------------------------------------------------------------------
# serial application — the paper-faithful lock order
# ---------------------------------------------------------------------------

def serial_apply(scfg: ServerConfig, server: ServerState, grads, push,
                 grad_ts):
    """Apply pushed gradients one at a time in event order (lock = order).

    `grads` leaves are [K, ...]; `push`/`grad_ts` are [K].  Returns
    (server, taus [K]).
    """
    taus = []
    for k in range(push.shape[0]):
        server, aux = apply_gated(scfg, server, tree_index(grads, k), push[k],
                                  grad_ts[k])
        taus.append(aux["tau"])
    return server, torch.stack(taus)


# ---------------------------------------------------------------------------
# fused application — one masked-sum update over the whole event batch
# ---------------------------------------------------------------------------

def fused_apply(scfg: ServerConfig, server: ServerState, grads, push,
                client_ts):
    """One masked-sum application of all pushed gradients.

    `grads` leaves are [K, ...]; `push`/`client_ts` are [K].  Stats (n, b,
    v) advance once with the mean pushed gradient iff `scfg.track_stats` or
    the rule requires them; the weight delta Σ_k m_k·scale(v, τ_k)·g_k is
    taken against the post-stats v; T advances by the number of pushes.
    With `scfg.use_fused_kernel` and a rule with a batched kernel mode, the
    whole application is one `kernels.ops.fused_event_apply` call over the
    tree (one kernel launch on the card), which advances n/b/v too.

    Returns (server, taus [K]).
    """
    rule = server_rules.get_rule(scfg.rule)
    _reject_per_leaf(push, "push gating")
    _reject_per_leaf(client_ts, "timestamps")
    track_stats = scfg.track_stats or rule.requires_stats
    n_push = push.to(torch.int32).sum()
    pushf = push.to(torch.float32)
    has_push = n_push > 0

    use_kernel = fused_kernel_active(scfg)
    # every ported rule uses the shared eq. 4-6 statistics, so on the kernel
    # path the kernel advances them in the same launch as the delta
    kernel_stats = use_kernel and track_stats

    if track_stats and not kernel_stats:
        mean_g = tree_map(
            lambda g: torch.einsum("c,c...->...", pushf, g.float())
            / torch.clamp(n_push, min=1), grads)
        stats_state = server_rules._shared_stats(scfg, server, mean_g)
        server = tree_where(has_push, stats_state, server)

    taus = server_rules.step_staleness(server.timestamp, client_ts)   # [K]

    if use_kernel:
        from repro_torch.kernels.ops import fused_event_apply
        weights = (rule.fused_coeffs(scfg, taus) * pushf
                   if rule.batched_kernel_mode == "coeff" else pushf)
        wmean = pushf / torch.clamp(n_push, min=1)
        f32 = lambda tr: tree_map(lambda l: l.float(), tr)
        new_params, n_new, b_new, v_new = fused_event_apply(
            server.params, tree_map(torch.Tensor.contiguous, grads),
            f32(server.n), f32(server.b), f32(server.v), weights, wmean,
            taus, has_push, lr=scfg.lr, gamma=scfg.gamma, beta=scfg.beta,
            eps=scfg.eps, variant=scfg.variant,
            mode=rule.batched_kernel_mode, track_stats=kernel_stats)
        if kernel_stats:
            cast = lambda new, old: tree_map(lambda a, o: a.to(o.dtype),
                                             new, old)
            server = server._replace(
                n=cast(n_new, server.n), b=cast(b_new, server.b),
                v=cast(v_new, server.v))
    elif rule.batched_kernel_mode == "coeff":
        # v-independent scale: one contraction over the event axis per leaf
        w = rule.fused_coeffs(scfg, taus) * pushf
        # contracted in float32, as the reference's type promotion does:
        # bf16 θ comes back float32
        new_params = tree_map(
            lambda p, g: p - torch.einsum("k,k...->...", w, g.float()),
            server.params, grads)
    else:
        deltas = []
        for v_leaf, g_leaf in zip(leaves(server.v), leaves(grads)):
            expand = (-1,) + (1,) * v_leaf.dim()
            scale = rule.scale_leaf(scfg, v_leaf[None], taus.reshape(expand))
            m = pushf.reshape(expand)
            deltas.append(torch.sum(m * scale * g_leaf, dim=0))
        new_params = tree_map(torch.subtract, server.params,
                              unflatten(server.params, deltas))
    server = server._replace(params=new_params,
                             timestamp=server.timestamp + n_push)
    return server, taus


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
    ([λ, ...] leaves) with last-eligible-event-wins semantics.

    Updates `tree`'s leaves in place (the fleet arrays are owned by the
    simulation loop, and a copy would cost a fleet-sized write per window)
    and returns it.  The reference's `num_slots` (its out-of-range drop
    index) has no use here: every duplicate index writes one value.
    """
    _reject_per_leaf(eligible, "push gating")
    source = last_event_source(clients, eligible)
    tree_map(lambda l, v: scatter_rows_(l, clients, v, source), tree, values)
    return tree
