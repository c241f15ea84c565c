"""Bounded server ingress queue: ring buffer + admission + drain policies.

Ported from `repro.core.queue`.  A fixed-capacity ring of pending push
events whose every field is a device tensor of fixed shape; `head`, `size`
and the drain count stay device scalars, so a queued window runs with no
host sync and no data-dependent shape.

**Admission** (`enqueue`), when a push arrives at a full queue:

- ``'block'`` — lossless backpressure.  The simulator accepts it only
  where overflow is impossible (capacity ≥ the arrival window and a
  ``drain_all`` drain), because a fixed-shape window cannot suspend a
  client.
- ``'reject'`` — the server refuses the push before transmission; the
  gradient is lost and its bytes are not counted as sent.
- ``'drop_oldest'`` — the push is admitted (its bytes crossed the wire) and
  the oldest queued event is evicted to make room.

**Drain** (`drain_count`), how many queued events one server pass applies:

- ``'drain_all'`` — the whole backlog, every window;
- ``'drain_k'`` — at most ``drain_k`` events per window;
- ``'adaptive'`` — ``min(size, max(drain_k, ceil(gain·size)))``, computed
  in float32 as the reference does (its size is cast to float32 and the
  gain rounds to float32: ``gain=0.6`` at ``size=25`` drains 16, not 15).

The payload is a tree chosen by the caller: FRED queues gradients and
their losses (plus the stale copies for gap-aware rules), or, on the
cotangent fused path, the stale copies and the minibatch indices.  A
dequeued batch is ``[capacity, ...]`` with a validity mask; invalid rows
hold finite ring garbage (slots start zeroed) that the apply weights 0.

The ring's leaves are owned by the simulation loop and written in place by
`enqueue` (a functional copy would write the whole [capacity, P] payload
every window); `head` and `size` are replaced, and `dequeue` gathers a new
batch, so a drained batch never aliases the ring.  Under a scenario each
admitted slot also carries its arrival's modelled wall time
(``enq_wall``), and a drain's admission→drain latency on the wall clock is
folded into ``queue_latency_wall_sum``.

Under a sharded server (`core.server_shard.shard_queue_state`) the
payload is placed as the server is, each slot's gradient in blocks on the
shards that apply them: `enqueue` routes each arrival's payload to the
shards' rings, and `dequeue` gathers each shard's rows, so a drained batch
reaches the apply placed already; over processes each process keeps the
rings of its own shards only.  The slot bookkeeping stays whole.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import engine
from repro_torch.core import server_shard
from repro_torch.core.engine import Counters
from repro_torch.utils.trees import leaves, tree_map

ADMISSION_POLICIES = ("block", "reject", "drop_oldest")
DRAIN_POLICIES = ("drain_all", "drain_k", "adaptive")


class QueueState(NamedTuple):
    """The ring: slots ``(head + i) % capacity`` for ``i < size`` are live,
    the rest is garbage that the admission and drain masks keep inert."""

    payload: Any                  # caller tree, leaves [capacity, ...]
    ts: torch.Tensor              # [capacity] int32 — stale-copy timestamp
    client: torch.Tensor          # [capacity] int32 — pushing client id
    enq_T: torch.Tensor           # [capacity] int32 — server T at admission
    head: torch.Tensor            # int32 — oldest live slot
    size: torch.Tensor            # int32 — number of live slots
    # per-tensor (§5): per-leaf timestamps and push masks
    leaf_ts: Optional[torch.Tensor] = None    # [capacity, n_leaves] int32
    leaf_mask: Optional[Any] = None           # tree of [capacity] bool
    # scenario: modelled wall time at admission
    enq_wall: Optional[torch.Tensor] = None   # [capacity] float32

    @property
    def capacity(self) -> int:
        """The ring's number of slots."""
        return self.ts.shape[0]


class Arrivals(NamedTuple):
    """One window of candidate pushes, [K, ...] per leaf.  Only the rows
    marked `valid` (pushes the eq.-9 gate let through) try to enqueue."""

    payload: Any
    ts: torch.Tensor              # [K]
    client: torch.Tensor          # [K]
    valid: torch.Tensor           # [K] bool
    leaf_ts: Optional[torch.Tensor] = None    # [K, n_leaves]
    leaf_mask: Optional[Any] = None           # tree of [K] bool
    wall: Optional[torch.Tensor] = None       # [K] float32 — arrival time


class Drained(NamedTuple):
    """A dequeued batch: [capacity, ...] leaves; row i holds the i-th oldest
    drained event iff ``valid[i]``."""

    payload: Any
    ts: torch.Tensor              # [capacity] int32
    client: torch.Tensor          # [capacity] int32
    enq_T: torch.Tensor           # [capacity] int32
    valid: torch.Tensor           # [capacity] bool
    leaf_ts: Optional[torch.Tensor] = None
    leaf_mask: Optional[Any] = None
    enq_wall: Optional[torch.Tensor] = None   # [capacity] float32


def init_queue(capacity: int, payload_example, *, n_leaves: int = 0,
               mask_like=None, track_wall: bool = False) -> QueueState:
    """An empty ring of `capacity` zeroed slots on the payload's device.

    `payload_example` is one event's payload (no leading event axis);
    `n_leaves > 0` adds the per-tensor timestamps ``leaf_ts``, `mask_like`
    (a params-like tree) the per-leaf push masks ``leaf_mask``, and
    `track_wall` the scenario's admission wall times ``enq_wall``.
    """
    if capacity < 1:
        raise ValueError(f"queue capacity must be >= 1, got {capacity}")
    device = leaves(payload_example)[0].device
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    i32 = torch.int32
    return QueueState(
        payload=tree_map(lambda l: zeros((capacity,) + tuple(l.shape),
                                         l.dtype), payload_example),
        ts=zeros((capacity,), i32),
        client=zeros((capacity,), i32),
        enq_T=zeros((capacity,), i32),
        head=zeros((), i32),
        size=zeros((), i32),
        leaf_ts=zeros((capacity, n_leaves), i32) if n_leaves else None,
        leaf_mask=(tree_map(lambda _: zeros((capacity,), torch.bool),
                            mask_like) if mask_like is not None else None),
        enq_wall=zeros((capacity,), torch.float32) if track_wall else None,
    )


def enqueue(q: QueueState, arrivals: Arrivals, admission: str, enq_T):
    """Admit one window of arrivals under an admission policy; `enq_T` (the
    server's T, a device scalar) is stamped on the admitted slots.

    Valid arrivals are packed after the ring's tail in arrival order (the
    rank is an exclusive prefix sum of ``valid``); slots that several
    admissions reach (more admissions than capacity under
    ``'drop_oldest'``) take the last arrival, as `engine.last_event_winners`
    decides in the reference: every duplicate index writes that one value
    (`engine.last_event_source`), so the scatter is deterministic.

    Returns ``(queue, admitted [K] bool, n_rejected, n_dropped)``:
    `admitted` marks the arrivals that reached the ring (the ones whose
    bytes count as sent), `n_rejected` the arrivals refused at a full ring
    ('block'/'reject'), `n_dropped` the evictions ('drop_oldest': old
    entries plus same-window arrivals overwritten when the window exceeds
    the capacity).
    """
    if admission not in ADMISSION_POLICIES:
        raise ValueError(f"unknown admission policy {admission!r}")
    cap = q.capacity
    valid = arrivals.valid
    validi = valid.to(torch.int32)
    rank = torch.cumsum(validi, 0, dtype=torch.int32) - validi
    n_valid = validi.sum(dtype=torch.int32)

    if admission in ("block", "reject"):
        free = torch.clamp(cap - q.size, min=0)
        admitted = valid & (rank < free)
        n_admit = torch.minimum(n_valid, free)
        n_rejected = n_valid - n_admit
        n_dropped = torch.zeros_like(q.size)
        new_head = q.head
        new_size = q.size + n_admit
    else:      # drop_oldest: every valid arrival is admitted
        admitted = valid
        n_dropped = torch.clamp(q.size + n_valid - cap, min=0)
        n_rejected = torch.zeros_like(q.size)
        new_head = torch.where(n_dropped > 0, (q.head + n_dropped) % cap,
                               q.head)
        new_size = torch.clamp(q.size + n_valid, max=cap)

    # pack admissions after the current tail (wrapping); under drop_oldest
    # the wrap lands on the evicted oldest slots
    slot = ((q.head + q.size + rank) % cap).long()
    source = engine.last_event_source(slot, admitted)
    put = lambda ring, values: engine.scatter_rows_(ring, slot, values,
                                                    source)
    k = valid.shape[0]
    if server_shard.is_sharded(q.payload):
        for s in q.payload.local:
            ring, dev = q.payload.blocks[s], q.payload.devices[s]
            rows = server_shard.block_of(arrivals.payload, q.payload, s, 1)
            slot_d, source_d = slot.to(dev), source.to(dev)
            tree_map(lambda r, v: engine.scatter_rows_(r, slot_d, v,
                                                       source_d), ring, rows)
    else:
        tree_map(put, q.payload, arrivals.payload)
    put(q.ts, arrivals.ts)
    put(q.client, arrivals.client)
    put(q.enq_T, torch.as_tensor(enq_T).to(torch.int32).expand(k))
    if q.leaf_ts is not None:
        put(q.leaf_ts, arrivals.leaf_ts)
    if q.leaf_mask is not None:
        tree_map(put, q.leaf_mask, arrivals.leaf_mask)
    if q.enq_wall is not None:
        put(q.enq_wall, arrivals.wall)
    q = q._replace(head=new_head.to(torch.int32),
                   size=new_size.to(torch.int32))
    return q, admitted, n_rejected, n_dropped


def drain_count(size, policy: str, *, drain_k: int = 1, gain: float = 0.5):
    """How many events one server pass applies: an int32 device scalar ≤
    `size` (see the module docstring for the policies)."""
    if policy not in DRAIN_POLICIES:
        raise ValueError(f"unknown drain policy {policy!r}")
    size = torch.as_tensor(size).to(torch.int32)
    if policy == "drain_all":
        return size
    if policy == "drain_k":
        return torch.clamp(size, max=drain_k)
    # float32 throughout: the Python gain is cast to the tensor's float32,
    # as the reference's weakly typed gain is
    target = torch.clamp(
        torch.ceil(size.to(torch.float32) * gain).to(torch.int32),
        min=drain_k)
    return torch.minimum(size, target)


def dequeue(q: QueueState, k):
    """Pop the `k` oldest events (a device int32 scalar) as a fixed
    ``[capacity]`` `Drained` batch with ``valid = arange(capacity) < k``:
    row i gathers slot ``(head + i) % capacity``.  Drained slots are not
    cleared; `head` advances by `k`."""
    cap = q.capacity
    pos = torch.arange(cap, dtype=torch.int32, device=q.ts.device)
    slot = ((q.head + pos) % cap).long()
    k = torch.as_tensor(k).to(torch.int32)
    if server_shard.is_sharded(q.payload):
        payload = q.payload.with_blocks([
            None if b is None else engine.tree_index(b, slot.to(dev))
            for b, dev in zip(q.payload.blocks, q.payload.devices)])
    else:
        payload = engine.tree_index(q.payload, slot)
    batch = Drained(
        payload=payload,
        ts=q.ts[slot],
        client=q.client[slot],
        enq_T=q.enq_T[slot],
        valid=pos < k,
        leaf_ts=None if q.leaf_ts is None else q.leaf_ts[slot],
        leaf_mask=(None if q.leaf_mask is None
                   else engine.tree_index(q.leaf_mask, slot)),
        enq_wall=None if q.enq_wall is None else q.enq_wall[slot],
    )
    return q._replace(head=(q.head + k) % cap, size=q.size - k), batch


def drained_push_arg(batch: Drained, per_tensor_push: bool):
    """The `push` argument that hands a drained window to the apply:
    ``valid`` under whole-copy gating, ``valid`` folded into each leaf's
    mask under per-tensor push.  Invalid rows are weighted 0 inside the
    apply (and its kernel), never sliced out."""
    if per_tensor_push:
        return tree_map(lambda m: m & batch.valid, batch.leaf_mask)
    return batch.valid


def count_queue(counters: Counters, *, enqueued, rejected, dropped, drained,
                depth_post, depth_peak, latency_sum,
                latency_wall_sum=None) -> Counters:
    """Fold one drain window into the `queue_*` counters: `depth_post` is
    the post-drain backlog (its sum over the windows gives the mean
    standing depth), `depth_peak` the post-admission depth (its running max
    is the high-water mark), `latency_sum` the summed admission→drain
    latency of the drained events in server-timestamp ticks, and
    `latency_wall_sum` the same on a scenario's wall clock (None leaves
    ``queue_latency_wall_sum`` as it is)."""
    i32 = lambda x: torch.as_tensor(x).to(torch.int32)
    f32 = lambda x: torch.as_tensor(x).to(torch.float32)
    if latency_wall_sum is not None:
        counters = counters._replace(
            queue_latency_wall_sum=(counters.queue_latency_wall_sum
                                    + f32(latency_wall_sum)))
    return counters._replace(
        queue_enqueued=counters.queue_enqueued + i32(enqueued),
        queue_rejected=counters.queue_rejected + i32(rejected),
        queue_dropped=counters.queue_dropped + i32(dropped),
        queue_drained=counters.queue_drained + i32(drained),
        queue_depth_sum=counters.queue_depth_sum + f32(depth_post),
        queue_depth_peak=torch.maximum(counters.queue_depth_peak,
                                       i32(depth_peak)),
        queue_latency_sum=counters.queue_latency_sum + f32(latency_sum),
        queue_windows=counters.queue_windows + 1,
    )
