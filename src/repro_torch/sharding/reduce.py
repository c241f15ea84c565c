"""The round trainer's one reduction over a group of processes, and the
check that every process holds the same round state.

Over a ``(data=w, model=1)`` mesh of processes (`launch.train` under
torchrun) each process computes the gradients of its rows of every
client's micro-batch (`sharding.rules.row_slice`).  A loss that is the
mean of per-token terms over rows of equal size is then the mean over the
processes of their losses, and so is its gradient: `GroupMean` makes
every process's losses and gradients that mean, once a round, outside
every `torch.func` transform (`core.round_trainer.build_round_step`'s
and `core.engine.fused_apply_cotangent`'s ``reduce``).  The state stays
whole on every process, and since the reduced values, the draws and the
code are the same on each, every process steps the same state:
`check_replicas` compares a digest of it across the group and raises
where it differs.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.server_shard import ShardedTree
from repro_torch.utils.trees import leaves, unflatten

# the staging buffer of one all-reduce: a bucket of float32 entries
BUCKET_BYTES = 256 << 20

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GroupMean:
    """``reduce(tree) -> tree``: every floating leaf of `tree` replaced, in
    place, by its mean over the processes of the default group (the
    ``data`` axis of the launcher's ``(data=w, model=1)`` mesh).

    The leaves are packed in order into one float32 staging buffer of
    `bucket_bytes` (a leaf larger than the room left is split over
    buckets); each full bucket is one ``all_reduce`` (SUM), divided by the
    group's size and copied back, a bf16 leaf rounded once.  So a
    round's reduction holds one bucket beside the gradients, never a
    float32 copy of them.  The same call works over NCCL (card tensors)
    and over gloo (CPU tensors, or card tensors through gloo's plain
    collectives).  It waits for the device before and after, and keeps
    what a call moves: `buckets` and `bytes` (float32) of the last call,
    and `seconds`, each call's host seconds."""

    def __init__(self, bucket_bytes: int = BUCKET_BYTES):
        self.size = dist.get_world_size()
        self.bucket = bucket_bytes // 4
        self.buckets = self.bytes = 0
        self.seconds: List[float] = []

    def __call__(self, tree):
        flat = [t if t.is_contiguous() else t.contiguous()
                for t in leaves(tree)]
        parts = [t.view(-1) for t in flat if t.is_floating_point()]
        total = sum(p.numel() for p in parts)
        if total == 0:
            return unflatten(tree, flat)
        device = parts[0].device
        _sync(device)
        t0 = time.perf_counter()
        buf = torch.empty(min(total, self.bucket), dtype=torch.float32,
                          device=device)
        pending: List[Tuple[torch.Tensor, int]] = []
        used = buckets = 0
        for part in parts:
            start = 0
            while start < part.numel():
                k = min(part.numel() - start, buf.numel() - used)
                piece = part[start:start + k]
                buf[used:used + k].copy_(piece)
                pending.append((piece, used))
                used += k
                start += k
                if used == buf.numel():
                    self._flush(buf[:used], pending)
                    used, buckets = 0, buckets + 1
        if used:
            self._flush(buf[:used], pending)
            buckets += 1
        _sync(device)
        self.seconds.append(time.perf_counter() - t0)
        self.buckets, self.bytes = buckets, 4 * total
        return unflatten(tree, flat)

    def _flush(self, buf, pending):
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        buf.div_(self.size)
        for piece, at in pending:
            piece.copy_(buf[at:at + piece.numel()])
        pending.clear()


def _named_leaves(tree, prefix: str = ""):
    """[(dotted name, tensor)] of a state, a `ShardedTree`'s blocks
    opened (the shards this process holds)."""
    if tree is None:
        return []
    if isinstance(tree, ShardedTree):
        return [x for s, block in enumerate(tree.blocks) if block is not None
                for x in _named_leaves(block, f"{prefix}shard{s}.")]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        return [x for name, sub in zip(names, tree)
                for x in _named_leaves(sub, f"{prefix}{name}.")]
    if isinstance(tree, torch.Tensor):
        return [(prefix[:-1], tree)]
    return []


def digest(tree) -> Tuple[List[str], torch.Tensor]:
    """The leaves' names and an int64 [n_leaves, 2] digest of their bits,
    on their device: each leaf's bits (as integers of its width) summed,
    and their squares summed, both wrapping modulo 2^64.  Two leaves
    whose bits differ in one entry differ in the first sum."""
    named = _named_leaves(tree)
    rows = []
    for _, t in named:
        t = t.detach().contiguous().reshape(-1)
        b = (t.to(torch.int64) if t.dtype == torch.bool
             else t.view(_BITS[t.element_size()]).to(torch.int64))
        rows.append(torch.stack([b.sum(), (b * b).sum()]))
    return [name for name, _ in named], torch.stack(rows)


def check_replicas(tree) -> None:
    """Raise unless every process of the default group holds `tree` bit
    for bit (its `digest`, all-gathered: one collective), naming the
    first leaf that differs and the process that disagrees."""
    names, mine = digest(tree)
    if dist.get_backend() == "gloo":
        mine = mine.cpu()
    everyone = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(everyone, mine)
    for rank, other in enumerate(everyone[1:], 1):
        if not torch.equal(other, everyone[0]):
            i = int((other != everyone[0]).any(dim=1).nonzero()[0])
            raise RuntimeError(
                f"the processes' states differ: leaf {names[i]} of rank "
                f"{rank} is not rank 0's (digest {other[i].tolist()} vs "
                f"{everyone[0][i].tolist()})")

