"""Sharded parameter server: W, n, b, v partitioned across S shards.

Ported from `repro.core.server_shard`.  The reference partitions the server
by placement alone and lets XLA's partitioner split the unchanged step;
here the placement is explicit.  A placed tree is a `ShardedTree`: S block
trees, shard s's on the s-th device of the mesh's server axis (the same
device may repeat, as in ``[cuda:0] * 4``), and `gather` brings it back
whole.  Each leaf is

* **routed** (`server_leaf_spec`): cut into S contiguous blocks along the
  last dimension S divides, block s on shard s; or
* **replicated**: S copies, one on every shard (a leaf with no dimension
  S divides, and every scalar: T, the barrier rules' counts).

The eq. 4–8 statistics and every rule's scale are elementwise in a leaf,
so the engine's apply runs unchanged on each shard's block tree (one
kernel launch per shard on the kernel path: `core.engine` dispatches on a
`ShardedTree` server).  Three values couple the shards, and each is
computed once from per-shard partial sums, summed in shard order in
float32 (`coupled_mean`): the whole-copy v̄ (`rules.vbar`), each leaf's v̄
for the per-tensor gates (`leaf_means`), and the telemetry's mean scale.
A replicated leaf counts once, on its owner shard (`make_shard_plan`),
never S times.  T is a replicated integer every shard advances alike.
Gate draws are keyed per event and per leaf, never per shard, so sharding
leaves every stream as it was.

``server_shards=1``, or a server axis of size 1, places nothing
(`shard_server_state` returns the state as it was): the unsharded run,
bitwise.  With S > 1 the blocks' sums run in another order, so runs agree
to floating-point rounding.

**Over processes** (a mesh from `launch.mesh.init_distributed_mesh`, whose
server axis records the rank holding each shard): every process runs the
same program (SPMD, as the reference's `jax.distributed` recipe) and
holds only its own shards' blocks; another process's shard is None in
`ShardedTree.blocks`.  The couplings and the gathers are then collectives
on the default `torch.distributed` group, all of them in this module
(`exchange`): each process all-gathers every shard's bytes (per-leaf
partial sums, routed blocks, and a replica from its owner shard only),
and the sums add in shard order exactly as in one process, so a run over
processes is bitwise the one-process run at the same S on the same kind
of device.  No sum goes through an `all_reduce`, whose order differs.
Every process calls each collective in the same order, since every
process takes the same steps.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.utils.trees import leaves, tree_map, unflatten

# The mesh axis the server state partitions over; FRED's fleet arrays use
# the 'clients' axis (`sim.fred.shard_fleet`).  The two compose on one mesh.
SERVER_AXIS = "server"
# `server_leaf_spec`'s answer for a leaf that every shard holds whole.
REPLICATE = "replicate"


def _flatten_with_path(tree, path=()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in leaf order: dict keys, NamedTuple field
    names and sequence indices, as `jax.tree_util.tree_flatten_with_path`
    names them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [e for k in sorted(tree)
                for e in _flatten_with_path(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        return [e for name, sub in zip(names, tree)
                for e in _flatten_with_path(sub, path + (str(name),))]
    return [(path, tree)]


def _leaf_nbytes(leaf) -> int:
    return leaf.numel() * leaf.element_size()


def mesh_axis_size(mesh, axis: str = SERVER_AXIS) -> int:
    """Size of `axis` on `mesh`, or 0 when the mesh is None or lacks it."""
    if mesh is None or axis not in getattr(mesh, "axis_names", ()):
        return 0
    return int(mesh.shape[axis])


def server_leaf_spec(shape, num_shards: int,
                     axis: str = SERVER_AXIS) -> Union[int, str]:
    """The dimension of a leaf of `shape` that carries the server axis, or
    `REPLICATE`.

    Scanning from the last dimension, the first one S divides is cut into
    S contiguous blocks; a leaf with none (a small bias, a scalar)
    replicates, and ``num_shards <= 1`` always does.  `axis` names the
    mesh axis, as in the reference, and does not change the answer.
    """
    if num_shards <= 1:
        return REPLICATE
    for dim in range(len(shape) - 1, -1, -1):
        if shape[dim] >= num_shards and shape[dim] % num_shards == 0:
            return dim
    return REPLICATE


class ServerShardPlan(NamedTuple):
    """The leaf → shard routing table of one server-state tree: per-leaf
    tuples in leaf order (`paths`, `specs`, `owners`, `leaf_bytes`) and the
    byte accounting.  ``owners[i]`` is leaf i's one control-plane home (the
    shard whose replica the couplings read); ``specs[i]`` its data-plane
    placement.  ``shard_bytes[s]`` counts the block bytes on shard s,
    `replicated_bytes` what every shard holds besides."""

    num_shards: int
    axis: str
    paths: Tuple[str, ...]
    specs: Tuple[Union[int, str], ...]
    owners: Tuple[int, ...]
    leaf_bytes: Tuple[int, ...]
    owned_bytes: Tuple[int, ...]       # per shard: Σ bytes of owned leaves
    shard_bytes: Tuple[int, ...]       # per shard: Σ block bytes
    replicated_bytes: int              # bytes resident on every shard
    total_bytes: int

    def resident_bytes(self, shard: int) -> int:
        """Bytes shard `shard` holds: its blocks and the replicas."""
        return self.shard_bytes[shard] + self.replicated_bytes

    @property
    def peak_resident_bytes(self) -> int:
        """The largest `resident_bytes` over the shards."""
        return max(self.resident_bytes(s) for s in range(self.num_shards))


def make_shard_plan(tree, num_shards: int,
                    axis: str = SERVER_AXIS) -> ServerShardPlan:
    """Route every leaf of a server-state tree (or a `ShardedTree`: its
    whole shapes) to the S shards.

    Each leaf gets its `server_leaf_spec` placement and one owner shard by
    greedy byte balance: largest leaf first, ties broken by key path, to
    the least-loaded shard (ties to the lowest index).  Deterministic, and
    the reference's plan owner for owner.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards={num_shards} < 1")
    if isinstance(tree, ShardedTree):
        tree = tree.like
    entries = [("/".join(path), tuple(leaf.shape), _leaf_nbytes(leaf))
               for path, leaf in _flatten_with_path(tree)]
    owned = [0] * num_shards
    blocks = [0] * num_shards
    replicated = 0
    owners, specs = {}, {}
    for path, shape, nbytes in sorted(entries, key=lambda e: (-e[2], e[0])):
        home = min(range(num_shards), key=lambda s: (owned[s], s))
        owners[path] = home
        owned[home] += nbytes
        specs[path] = server_leaf_spec(shape, num_shards, axis)
        if specs[path] == REPLICATE:
            replicated += nbytes
        else:
            # the routed dimension divides, so nbytes // S is exact
            for s in range(num_shards):
                blocks[s] += nbytes // num_shards
    paths = tuple(e[0] for e in entries)
    return ServerShardPlan(
        num_shards=num_shards, axis=axis, paths=paths,
        specs=tuple(specs[p] for p in paths),
        owners=tuple(owners[p] for p in paths),
        leaf_bytes=tuple(e[2] for e in entries),
        owned_bytes=tuple(owned), shard_bytes=tuple(blocks),
        replicated_bytes=replicated,
        total_bytes=sum(e[2] for e in entries))


def peak_shard_bytes(tree, num_shards: int, axis: str = SERVER_AXIS) -> float:
    """The largest per-shard resident bytes of `tree` under S-way routing,
    from shapes and dtypes alone (each leaf at its own itemsize)."""
    return float(make_shard_plan(tree, num_shards, axis).peak_resident_bytes)


class ShardedTree:
    """A tree placed on S shards: `blocks[s]` is shard s's tree (same
    structure; a routed leaf's block, or a replica), on ``devices[s]``.

    `like` holds the whole tree's shapes and dtypes as meta tensors (the
    structure and byte counts, without data); `dims[i]` is leaf i's routed
    dimension (leading batch dimensions included) or None for a replica;
    `owners[i]` the shard whose replica stands for a replicated leaf.
    `ranks[s]` is the process that holds shard s when the shards are
    spread over processes (None: this process holds them all); a shard of
    another process has None for its block.
    """

    def __init__(self, blocks: Sequence[Any], like, dims, owners, devices,
                 ranks=None):
        self.blocks = tuple(blocks)
        self.like = like
        self.dims = tuple(dims)
        self.owners = tuple(owners)
        self.devices = tuple(devices)
        self.ranks = None if ranks is None else tuple(ranks)

    @property
    def num_shards(self) -> int:
        """S."""
        return len(self.blocks)

    @property
    def local(self) -> Tuple[int, ...]:
        """The shards this process holds, in shard order."""
        return tuple(s for s, b in enumerate(self.blocks) if b is not None)

    @property
    def spread(self) -> bool:
        """Whether the shards lie in more than one process."""
        return self.ranks is not None and len(set(self.ranks)) > 1

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard."""
        return self.devices[self.local[0]]

    def first(self, per_shard):
        """The entry of this process's first shard in a per-shard list."""
        return per_shard[self.local[0]]

    def with_blocks(self, blocks) -> "ShardedTree":
        """The same placement holding `blocks` (new values, same shapes;
        None for another process's shard)."""
        return ShardedTree(blocks, self.like, self.dims, self.owners,
                           self.devices, self.ranks)

    def sub(self, select) -> "ShardedTree":
        """The placed subtree ``select(tree)``, e.g. ``lambda s: s.v``."""
        index = unflatten(self.like, list(range(len(self.dims))))
        idx = leaves(select(index))
        return ShardedTree([None if b is None else select(b)
                            for b in self.blocks],
                           select(self.like), [self.dims[i] for i in idx],
                           [self.owners[i] for i in idx], self.devices,
                           self.ranks)

    def __getitem__(self, key) -> "ShardedTree":
        return self.sub(lambda t: t[key])

    def get(self, key, default=None):
        """``self[key]`` where the (dict) tree has `key`, else `default`."""
        return self[key] if key in self.like else default

    def gather(self, device=None):
        """The whole tree on `device` (this process's first shard's by
        default): routed leaves concatenated along their dimension in
        shard order, replicated ones from their owner.  Over processes a
        collective that every process calls."""
        device = self.home if device is None else device
        metas = leaves(self.like)
        held = [[(dim is not None or owner == s)
                 for dim, owner in zip(self.dims, self.owners)]
                for s in range(self.num_shards)]
        shards = exchange(
            self.ranks,
            {s: [l for l, h in zip(leaves(self.blocks[s]), held[s]) if h]
             for s in self.local},
            [[(self._block_shape(m, dim), m.dtype)
              for m, dim, h in zip(metas, self.dims, held[s]) if h]
             for s in range(self.num_shards)], device)
        per_shard = [iter(x) for x in shards]
        out = []
        for dim, owner in zip(self.dims, self.owners):
            if dim is None:
                out.append(next(per_shard[owner]).to(device))
            else:
                out.append(torch.cat([next(it).to(device)
                                      for it in per_shard], dim))
        return unflatten(self.like, out)

    def _block_shape(self, meta, dim):
        shape = list(meta.shape)
        if dim is not None:
            shape[dim] //= self.num_shards
        return tuple(shape)


# bytes of each tensor in an `exchange` buffer are padded to this, so that
# every tensor starts aligned for a view of its dtype
_ALIGN = 8


def _padded_nbytes(shape, dtype) -> int:
    n = int(torch.Size(shape).numel()) * dtype.itemsize
    return -(-n // _ALIGN) * _ALIGN


def process_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def exchange(ranks, rows, specs, device):
    """Every part's list of tensors, in part order, on every process: the
    one collective of a server (or a fleet) spread over processes.

    Part p (a shard, or a block of fleet rows) lies in process
    ``ranks[p]`` (`ranks` None: this process holds every part).  `rows[p]`
    is part p's list of tensors for this process's parts (returned as they
    are); `specs[p]` lists part p's (shape, dtype)s, the same on every
    process.  Each process packs its parts' tensors into one byte buffer
    on `device` (gloo takes card tensors as well as host ones), one
    all-gather on the default group brings every process's buffer, and
    the other parts come back as views of the gathered bytes on `device`.
    With every part in one process no collective runs.  No value is
    reduced here: callers add what they gather in part order."""
    P = len(specs)
    if ranks is None or len(set(ranks)) <= 1:
        return [rows[p] for p in range(P)]
    me, world = dist.get_rank(), dist.get_world_size()
    size = [sum(_padded_nbytes(*x) for x in spec) for spec in specs]
    width = max(sum(size[p] for p in range(P) if ranks[p] == r)
                for r in range(world))
    mine = torch.zeros(width, dtype=torch.uint8, device=device)
    off = 0
    for p in range(P):
        if ranks[p] != me:
            continue
        for t, (shape, dtype) in zip(rows[p], specs[p]):
            if (tuple(t.shape), t.dtype) != (tuple(shape), dtype):
                raise ValueError(
                    f"part {p} holds a {t.dtype} {tuple(t.shape)} tensor "
                    f"where its placement has {dtype} {tuple(shape)}")
            raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
            mine[off:off + raw.numel()] = raw
            off += _padded_nbytes(t.shape, t.dtype)
    bufs = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(bufs, mine)
    flat = torch.cat(bufs)
    base = {r: r * width for r in range(world)}
    out = []
    for p in range(P):
        r = ranks[p]
        if r == me:
            out.append(list(rows[p]))
            base[r] += size[p]
            continue
        got = []
        for shape, dtype in specs[p]:
            n = int(torch.Size(shape).numel()) * dtype.itemsize
            got.append(flat[base[r]:base[r] + n].view(dtype).reshape(shape))
            base[r] += _padded_nbytes(shape, dtype)
        out.append(got)
    return out


def is_sharded(tree) -> bool:
    """Whether `tree` is placed on shards."""
    return isinstance(tree, ShardedTree)


def like(tree):
    """The tree's structure with its whole shapes and dtypes: a
    `ShardedTree`'s meta tree, any other tree itself."""
    return tree.like if isinstance(tree, ShardedTree) else tree


def gather(tree, select=None, device=None):
    """``select(tree)`` whole (all of it when `select` is None): gathered
    from the shards of a `ShardedTree` onto `device`, else as it is."""
    if isinstance(tree, ShardedTree):
        return (tree if select is None else tree.sub(select)).gather(device)
    return tree if select is None else select(tree)


def _copy_to(t, device):
    """A fresh contiguous copy of `t` on `device`."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _routed_dim(leaf, num_shards, batch_dims):
    """The dimension of `leaf` cut into blocks, or None for a replica."""
    spec = server_leaf_spec(tuple(leaf.shape)[batch_dims:], num_shards)
    return None if spec == REPLICATE else spec + batch_dims


def _block(leaf, dim, s, num_shards):
    """Shard s's block of `leaf` (a view), or the leaf for a replica."""
    if dim is None:
        return leaf
    size = leaf.shape[dim] // num_shards
    return leaf.narrow(dim, s * size, size)


def shard_tree(tree, mesh, axis: str = SERVER_AXIS, *, batch_dims: int = 0):
    """Place every leaf of `tree` on the devices of `mesh`'s `axis` under
    its routing (`server_leaf_spec` of the shape after `batch_dims`
    leading event or slot dimensions, which stay whole: the queue's
    ``[capacity, *leaf]`` payload routes as the live state does), each
    block and replica a fresh contiguous tensor.  Owners come from
    `make_shard_plan`.  On a mesh spread over processes this process
    builds the blocks of its own shards only, and must hold one at least.
    None passes through."""
    if tree is None:
        return None
    devices = mesh.axis_devices(axis)
    ranks = mesh.axis_ranks(axis)
    S = len(devices)
    me = process_rank()
    mine = [ranks is None or ranks[s] == me for s in range(S)]
    if not any(mine):
        raise ValueError(f"process {me} holds no shard of the {axis!r} "
                         f"axis (ranks {ranks}): every process of a "
                         f"spread server must hold one")
    dims = [_routed_dim(l, S, batch_dims) for l in leaves(tree)]
    blocks = [unflatten(tree, [_copy_to(_block(l, d, s, S), dev)
                               for l, d in zip(leaves(tree), dims)])
              if mine[s] else None
              for s, dev in enumerate(devices)]
    owners = make_shard_plan(tree, S, axis).owners
    return ShardedTree(blocks, tree_map(_meta, tree), dims, owners, devices,
                       ranks)


def block_of(tree, server: ShardedTree, s: int, batch_dims: int = 0):
    """Shard s's blocks of an operand of `server`'s apply: a whole tree
    shaped like its params with `batch_dims` leading dimensions, cut as
    the server is with one contiguous copy per leaf at most (a replica is
    the leaf itself, on the shard's device); a placed tree (a drained
    queue payload) gives its own block; None gives None."""
    if tree is None:
        return None
    if isinstance(tree, ShardedTree):
        if (tree.devices, tree.ranks) != (server.devices, server.ranks):
            raise ValueError("the operand is placed on other shards than "
                             "the server")
        return tree.blocks[s]
    S, dev = server.num_shards, server.devices[s]
    return tree_map(lambda l: _block(l, _routed_dim(l, S, batch_dims), s,
                                     S).contiguous().to(dev), tree)


def on(tree, device):
    """Every leaf of a small operand (masks, timestamps) on `device`."""
    return tree_map(lambda t: t.to(device), tree)


def coupled_mean(shard_leaf_sums, dims, owners, numel, device):
    """Σ over the whole tree / `numel` from each shard's per-leaf float32
    sums: shard s's partial sum adds its routed blocks and the replicas it
    owns, in leaf order; the partials add in shard order on `device`."""
    total = None
    for s, sums in enumerate(shard_leaf_sums):
        part = None
        for x, dim, owner in zip(sums, dims, owners):
            if dim is not None or owner == s:
                part = x if part is None else part + x
        if part is not None:
            part = part.to(device)
            total = part if total is None else total + part
    return total / float(numel)


def _all_shards(placed: ShardedTree, rows):
    """Every shard's list of tensors from this process's shards' `rows`
    (lists alike in shape and dtype on every shard): `exchange`."""
    spec = [(tuple(t.shape), t.dtype) for t in placed.first(rows)]
    return exchange(placed.ranks, rows, [spec] * placed.num_shards,
                    placed.home)


def _leaf_sums(sharded: ShardedTree):
    return _all_shards(sharded, {
        s: [torch.sum(l.float()) for l in leaves(sharded.blocks[s])]
        for s in sharded.local})


def _numel(sharded: ShardedTree) -> int:
    return sum(l.numel() for l in leaves(sharded.like))


def tree_mean(sharded: ShardedTree) -> torch.Tensor:
    """The mean over every element of a placed tree (the whole-copy v̄ of
    a placed v), by `coupled_mean`, on this process's first shard's
    device."""
    return coupled_mean(_leaf_sums(sharded), sharded.dims, sharded.owners,
                        _numel(sharded), sharded.home)


def leaf_means(sharded: ShardedTree) -> List[torch.Tensor]:
    """Each leaf's mean (its v̄ for a per-tensor gate), on this process's
    first shard's device: a routed leaf's block sums added in shard order,
    a replica's owner's sum, over the leaf's whole element count."""
    sums = _leaf_sums(sharded)
    home = sharded.home
    out = []
    for i, (l, dim, owner) in enumerate(zip(leaves(sharded.like),
                                            sharded.dims, sharded.owners)):
        total = None
        for s in range(sharded.num_shards):
            if dim is not None or owner == s:
                x = sums[s][i].to(home)
                total = x if total is None else total + x
        out.append(total / float(l.numel()))
    return out


def merge_aux(server: ShardedTree, auxes):
    """One aux dict from the shards' applies (None for another process's
    shard): this process's first shard's values on its device (τ and a
    barrier's decision are the same on every shard), with ``mean_scale``
    made again from every shard's ``scale_sums`` by `coupled_mean` over
    the params."""
    home = server.home
    first = server.first(auxes)
    aux = {k: on(v, home) for k, v in first.items() if k != "scale_sums"}
    if "scale_sums" in first:
        params = server.sub(lambda s: s.params)
        sums = _all_shards(server, {s: auxes[s]["scale_sums"]
                                    for s in server.local})
        aux["mean_scale"] = coupled_mean(sums, params.dims, params.owners,
                                         _numel(params), home)
    return aux


def shard_server_state(server, mesh, axis: str = SERVER_AXIS):
    """Partition a `rules.ServerState` across `mesh[axis]`: W, n, b, v and
    the rule's params-shaped `extra` route by `server_leaf_spec`; T and
    scalar extras replicate.  A mesh without the axis, or with one device
    on it, places nothing: the state comes back as it was (the bitwise
    S = 1 contract)."""
    if mesh_axis_size(mesh, axis) <= 1:
        return server
    return shard_tree(server, mesh, axis)


def shard_queue_state(queue, mesh, axis: str = SERVER_AXIS):
    """Partition the ingress queue's payload (leaves ``[capacity,
    *leaf]``) across `mesh[axis]`, so that a queued gradient's blocks lie
    with the shard that applies them.  The slot bookkeeping (ts, client,
    enq_T, ...) and head and size stay whole.  None (no queue) passes
    through, as does a server axis of size 1."""
    if queue is None or mesh_axis_size(mesh, axis) <= 1:
        return queue
    return queue._replace(
        payload=shard_tree(queue.payload, mesh, axis, batch_dims=1))


def count_shard(counters, *, applies, events, bytes_peak, depth_peak):
    """Fold one apply window against the partitioned server into the
    ``shard_*`` counters: `applies` windows consuming `events` events,
    `bytes_peak` the plan's largest per-shard resident bytes and
    `depth_peak` the largest per-window event batch (both max-folded).
    Python numbers or device scalars; nothing is copied from the host.
    `run_simulation` drops these counters when ``server_shards <= 1``."""
    def add(prev, x):
        return prev + (x.to(prev.dtype) if torch.is_tensor(x) else x)

    def fold_max(prev, x):
        if torch.is_tensor(x):
            return torch.maximum(prev, x.to(prev.dtype))
        return torch.clamp(prev, min=x)
    return counters._replace(
        shard_applies=add(counters.shard_applies, applies),
        shard_events=add(counters.shard_events, events),
        shard_bytes_peak=fold_max(counters.shard_bytes_peak, bytes_peak),
        shard_depth_peak=fold_max(counters.shard_depth_peak, depth_peak))


def shard_counter(num_shards: int, axis: str = SERVER_AXIS):
    """``count(counters, server, events)``: one apply window of `events`
    against the partitioned server folded in by `count_shard` when
    ``num_shards > 1`` (the plan's peak bytes reckoned at the first window:
    the shapes never change), else the counters as they are."""
    peak = []

    def count(counters, server, events):
        if num_shards <= 1:
            return counters
        if not peak:
            peak.append(peak_shard_bytes(server, num_shards, axis))
        return count_shard(counters, applies=1, events=events,
                           bytes_peak=peak[0], depth_peak=events)
    return count


def validate_server_mesh(mesh, num_shards: int,
                         axis: str = SERVER_AXIS) -> None:
    """Raise ValueError unless `mesh` has an `axis` of exactly
    `num_shards` devices, so that a mis-sized mesh fails at set-up instead
    of replicating."""
    size = mesh_axis_size(mesh, axis)
    if size != num_shards:
        raise ValueError(
            f"server_shards={num_shards} requires a mesh with a "
            f"{axis!r} axis of exactly that size; got "
            f"{'no mesh' if mesh is None else f'axis size {size}'} — build "
            f"one with launch.mesh.make_server_mesh(server={num_shards}) "
            f"(several shards on one device through its devices= list, "
            f"e.g. [torch.device('cpu')] * {num_shards})")


__all__ = [
    "REPLICATE",
    "SERVER_AXIS",
    "ServerShardPlan",
    "ShardedTree",
    "count_shard",
    "coupled_mean",
    "exchange",
    "gather",
    "is_sharded",
    "leaf_means",
    "like",
    "make_shard_plan",
    "block_of",
    "merge_aux",
    "mesh_axis_size",
    "on",
    "peak_shard_bytes",
    "process_rank",
    "server_leaf_spec",
    "shard_counter",
    "shard_queue_state",
    "shard_server_state",
    "shard_tree",
    "tree_mean",
    "validate_server_mesh",
]
