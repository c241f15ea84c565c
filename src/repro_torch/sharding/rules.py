"""Named-axis sharding rules with divisibility fallbacks.

Ported from `repro.sharding.rules`, over the port's `launch.mesh.Mesh`.
One generic rule derives a `PartitionSpec` from a leaf's key path and
shape (FSDP-style "shard everything"), rather than a table per
architecture:

 - the **last** dim divisible by the `model` axis size → ``"model"``;
 - the **largest remaining** dim divisible by the data axes → ``"data"``
   (``("data", "pod")`` in a multi-pod mesh);
 - leaves under a stacked-layer prefix (``layers/...``) never shard dim 0;
 - a dim that fails divisibility is replicated, that dim alone.

The rules decide exactly as the reference's do, leaf by leaf, on the
port's trees: a key path is spelled as the reference spells it (a dict
key as itself, a list index as its number, a NamedTuple field as
``.name``), so a `ServerState`'s leaves are not treated as stacked, as
there.  A spec is a `PartitionSpec`, a tuple of axis names, None or
tuples of names; a `NamedSharding` pairs a mesh with one.

Over a mesh spread over processes (`launch.mesh.init_distributed_host_mesh`)
a `NamedSharding` is a DTensor placement: `placements` turns a spec into
one `Shard(dim)` or `Replicate()` per mesh axis of the mesh's
`DeviceMesh` (`launch.mesh.device_mesh`), `place` keeps only this
process's shard of each leaf of a tree, and `gather` makes the leaves
whole again; `row_slice` gives a process its rows of a micro-batch by
the 'bsd' rule (the round trainer over processes, on plain tensors).
Under such a mesh context `constrain` and `constrain_axes` redistribute
a DTensor to the spec the reference would constrain it to,
at the reference's sites in the dense family's models
(`models.transformer`, `models.attention`, `models.serving`); the
weights of a contraction or a lookup are gathered for the op
(`gathered`, FSDP's all-gather).  Without a mesh context, under a mesh of
one process, and on a plain tensor, both return their input itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import (Mesh, device_mesh, is_spread,
                                     local_device)
from repro_torch.utils.trees import leaves, tree_map, unflatten


class PartitionSpec(tuple):
    """Per-dimension axis assignment: an axis name, a tuple of names, or
    None (replicated) for each dimension."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec over its axes."""
    mesh: Mesh
    spec: PartitionSpec


# ---------------------------------------------------------------------------
# mesh context (the reference's target of activation constraints)
# ---------------------------------------------------------------------------

_ctx = threading.local()


def set_mesh_context(mesh: Optional[Mesh]):
    """Install `mesh` (thread-locally) as the mesh context; None
    uninstalls it."""
    _ctx.mesh = mesh


def get_mesh_context() -> Optional[Mesh]:
    """The thread-local mesh context, or None outside one."""
    return getattr(_ctx, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    """Scoped `set_mesh_context`: restores the previous mesh on exit.
    Under a mesh spread over processes, a plain tensor that meets a
    DTensor in an op counts as replicated (DTensor's
    `implicit_replication`): positions, masks and constants made inside
    the model are the same on every process."""
    prev = get_mesh_context()
    set_mesh_context(mesh)
    try:
        if is_spread(mesh):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        set_mesh_context(prev)


# ---------------------------------------------------------------------------
# §Perf switch read by `cache_specs` (baseline = unset).  The
# reference's attention and MoE switches have no reader in one process.
# ---------------------------------------------------------------------------

_modes = {"mla_cache": None}


def set_mla_cache_mode(mode: Optional[str]):
    """'rank' (baseline: latent rank → model) | 'seq' (window → model)."""
    _modes["mla_cache"] = mode


def mla_cache_mode() -> str:
    """Active MLA-cache mode: explicit set, env REPRO_MLA_CACHE, else
    'rank'."""
    return _modes["mla_cache"] or os.environ.get("REPRO_MLA_CACHE", "rank")


def axis_size(mesh: Mesh, name) -> int:
    """Size of an axis or tuple of axes (product); 1 if absent."""
    if isinstance(name, tuple):
        s = 1
        for n in name:
            s *= axis_size(mesh, n)
        return s
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(name, 1)


def batch_axes(mesh: Mesh):
    """The axes the batch dim shards over: ("pod", "data") when pod
    exists."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


# ---------------------------------------------------------------------------
# key paths
# ---------------------------------------------------------------------------

def _keyed(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(key path, leaf)] in JAX leaf order; a path element is ("key", k)
    for a dict key, ("idx", i) for a list index, ("attr", name) for a
    NamedTuple field.  None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _keyed(tree[k], prefix + (("key", k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _keyed(getattr(tree, f), prefix + (("attr", f),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, sub in enumerate(tree)
                for x in _keyed(sub, prefix + (("idx", i),))]
    return [(prefix, tree)]


def _path_str(path) -> str:
    """The reference's ``"/".join(key or idx or str(entry))``."""
    return "/".join(str(v) if kind != "attr" else f".{v}"
                    for kind, v in path)


def _numel(leaf) -> int:
    n = 1
    for s in leaf.shape:
        n *= s
    return n


# ---------------------------------------------------------------------------
# parameter rule
# ---------------------------------------------------------------------------

_STACKED_PREFIXES = ("layers", "mamba", "attn")   # stacked leading dims


def _is_stacked(path: str) -> bool:
    first = path.split("/", 1)[0].strip("'[]\"")
    return first in _STACKED_PREFIXES or path.startswith("client_params")


def leaf_param_spec(path: str, shape: Sequence[int], mesh: Mesh) -> P:
    """Generic FSDP rule: last divisible dim → model, largest rest →
    data."""
    ndim = len(shape)
    if ndim == 0:
        return P()
    start = 1 if (_is_stacked(path) and ndim >= 2) else 0
    model_n = axis_size(mesh, "model")
    spec: list = [None] * ndim
    for i in range(ndim - 1, start - 1, -1):
        if shape[i] >= model_n and shape[i] % model_n == 0:
            spec[i] = "model"
            break
    for data_ax in (("data", "pod") if "pod" in mesh.axis_names
                    else ("data",), ("data",)):
        dn = axis_size(mesh, data_ax)
        cands = [i for i in range(start, ndim)
                 if spec[i] is None and shape[i] >= dn and shape[i] % dn == 0]
        if cands:
            i = max(cands, key=lambda j: shape[j])
            spec[i] = data_ax if len(data_ax) > 1 else data_ax[0]
            break
    return P(*spec)


def _param_spec_list(params, mesh: Mesh) -> list:
    return [leaf_param_spec(_path_str(p), tuple(l.shape), mesh)
            for p, l in _keyed(params)]


def param_specs(params, mesh: Mesh):
    """Tree of `PartitionSpec` matching `params` (meta tensors serve)."""
    return unflatten(params, _param_spec_list(params, mesh))


def _named(like, specs, mesh):
    return unflatten(like, [NamedSharding(mesh, s) for s in specs])


def param_shardings(params, mesh: Mesh):
    """`param_specs` as a tree of `NamedSharding` on `mesh`."""
    return _named(params, _param_spec_list(params, mesh), mesh)


def state_shardings(state, mesh: Mesh):
    """Shardings for a `ServerState` or `RoundState`: params-like leaves
    take the param rule (the n/b/v statistics and stacked client copies
    too), scalars and leaves of at most 64 entries replicate."""
    specs = []
    for path, leaf in _keyed(state):
        if len(leaf.shape) == 0 or _numel(leaf) <= 64:
            specs.append(P())
        else:
            specs.append(leaf_param_spec(_path_str(path), tuple(leaf.shape),
                                         mesh))
    return _named(state, specs, mesh)


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------

def _div(n: int, by: int) -> bool:
    return n >= by and n % by == 0


def batch_spec(shape: Sequence[int], mesh: Mesh, *,
               seq_dim: Optional[int] = None) -> P:
    """Shard dim 0 (batch) over the batch axes; fall back to `data` alone,
    then to the sequence dim (context parallelism, a batch of 1), then
    replicate."""
    b = shape[0]
    ba = batch_axes(mesh)
    spec: list = [None] * len(shape)
    if _div(b, axis_size(mesh, ba)):
        spec[0] = ba if len(ba) > 1 else ba[0]
    elif _div(b, axis_size(mesh, "data")):
        spec[0] = "data"
    elif seq_dim is not None and _div(shape[seq_dim], axis_size(mesh, ba)):
        spec[seq_dim] = ba if len(ba) > 1 else ba[0]
    return P(*spec)


def batch_shardings(batch, mesh: Mesh, *, seq_dim: Optional[int] = 1):
    """`NamedSharding`s for a batch tree (leaves [B, S, ...]): dim 0 over
    the batch axes via `batch_spec`, with the seq-dim fallback."""
    def one(leaf):
        sd = seq_dim if (len(leaf.shape) > (seq_dim or 0)) else None
        return NamedSharding(mesh, batch_spec(tuple(leaf.shape), mesh,
                                              seq_dim=sd))
    return unflatten(batch, [one(l) for _, l in _keyed(batch)])


def cache_specs(cache, mesh: Mesh):
    """Tree of `PartitionSpec` matching a cache (`_cache_spec_list`)."""
    return unflatten(cache, _cache_spec_list(cache, mesh))


def _cache_spec_list(cache, mesh: Mesh) -> list:
    """KV/SSM cache rule; leaves are [L, B, W, ...] (stacked over layers).

    batch → data when divisible, else the longest remaining dim ≥ 2 → data
    (context parallelism).  The innermost dim (head_dim / latent rank /
    SSM state) → model when divisible, else the second innermost; in
    'seq' `mla_cache_mode` an MLA cache's window dim → model instead.
    """
    model_n = axis_size(mesh, "model")
    ba = batch_axes(mesh)

    def one_spec(name, shape):
        ndim = len(shape)
        spec: list = [None] * ndim
        if mla_cache_mode() == "seq" and ndim == 4 and name in ("c", "kr") \
                and _div(shape[2], model_n):
            spec[2] = "model"
        else:
            for i in (ndim - 1, ndim - 2):
                if i >= 2 and _div(shape[i], model_n):
                    spec[i] = "model"
                    break
        dn = axis_size(mesh, ba)
        if ndim >= 2 and _div(shape[1], dn):
            spec[1] = ba if len(ba) > 1 else ba[0]
        elif ndim >= 2 and _div(shape[1], axis_size(mesh, "data")):
            spec[1] = "data"
        else:
            cands = [i for i in range(2, ndim)
                     if spec[i] is None and _div(shape[i], dn)]
            if cands:
                i = max(cands, key=lambda j: shape[j])
                spec[i] = ba if len(ba) > 1 else ba[0]
        return P(*spec)

    return [one_spec(_last_key(path), tuple(leaf.shape))
            for path, leaf in _keyed(cache)]


def _last_key(path) -> str:
    """The last path element's dict key, else "" (the reference's
    ``getattr(path[-1], "key", "")``)."""
    return str(path[-1][1]) if path and path[-1][0] == "key" else ""


def cache_shardings(cache, mesh: Mesh):
    """`cache_specs` as a tree of `NamedSharding` on `mesh`."""
    return _named(cache, _cache_spec_list(cache, mesh), mesh)


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

def _spread_context():
    mesh = get_mesh_context()
    return mesh if mesh is not None and is_spread(mesh) else None


def constrain_spec(shape, kind: str, mesh: Mesh) -> P:
    """The reference's spec at a named activation site:

      'bsd'  — [batch, seq, d_model]: batch → batch axes (else seq), d →
               model;
      'bsv'  — [batch, seq, vocab]: batch → batch axes, vocab → model;
      'ecd'  — [experts, capacity, d]: capacity → batch axes, d → model;
      'attn' — attention scores / outputs [batch, ...]: batch → batch
               axes, model → the first divisible dim of 1 .. n − 1 (the
               query chunk, so the softmax over keys stays local);
      'grad' — a parameter-shaped gradient leaf: the generic param rule.
    """
    model_n = axis_size(mesh, "model")
    ba = batch_axes(mesh)
    ba_spec = ba if len(ba) > 1 else ba[0]
    bn = axis_size(mesh, ba)
    ndim = len(shape)
    spec: list = [None] * ndim
    if kind in ("bsd", "bsv", "ecd"):
        bdim = 0 if kind != "ecd" else 1
        if _div(shape[bdim], bn):
            spec[bdim] = ba_spec
        elif kind == "bsd" and _div(shape[1], bn):
            spec[1] = ba_spec        # context parallelism (batch=1 long seq)
        if _div(shape[-1], model_n):
            spec[-1] = "model"
        return P(*spec)
    if kind == "attn":
        if _div(shape[0], bn):
            spec[0] = ba_spec
        for i in range(1, ndim):
            if _div(shape[i], model_n):
                spec[i] = "model"
                break
        return P(*spec)
    if kind == "grad":
        return leaf_param_spec("", tuple(shape), mesh)
    raise ValueError(kind)


def constrain(x, kind: str):
    """The reference's sharding constraint at a named activation site
    (`constrain_spec`): under a mesh context spread over processes, a
    DTensor `x` is redistributed to that spec's placements.  Without a
    mesh context, under a mesh of one process, or for a plain tensor it
    returns `x` itself."""
    mesh = _spread_context()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return redistribute(x, placements(constrain_spec(x.shape, kind, mesh),
                                      mesh))


def constrain_axes(x, axes: dict):
    """The reference's per-dim constraint ({dim: 'batch' | 'model'}; a dim
    that fails divisibility stays unsharded), acting as `constrain`
    does."""
    mesh = _spread_context()
    if mesh is None or not isinstance(x, DTensor):
        return x
    model_n = axis_size(mesh, "model")
    ba = batch_axes(mesh)
    bn = axis_size(mesh, ba)
    spec: list = [None] * x.ndim
    for dim, role in axes.items():
        if role == "batch" and _div(x.shape[dim], bn):
            spec[dim] = ba if len(ba) > 1 else ba[0]
        elif role == "model" and _div(x.shape[dim], model_n):
            spec[dim] = "model"
    return redistribute(x, placements(P(*spec), mesh))


def row_slice(shape, mesh: Mesh) -> Optional[slice]:
    """This process's rows of a micro-batch of `shape` [Bc, S, ...] over a
    mesh spread over processes, by the reference's 'bsd' rule
    (`constrain_spec`): where the batch axes divide Bc, process i of them
    (in the mesh's order) takes rows [i·Bc/n, (i+1)·Bc/n).  None where the
    rule does not split Bc (the reference then splits the sequence, a
    placement the round trainer over processes replicates instead) and on
    a mesh of one process."""
    if not is_spread(mesh):
        return None
    spec = constrain_spec(tuple(shape), "bsd", mesh)
    if spec[0] is None:
        return None
    where = (mesh.ranks == dist.get_rank()).nonzero()
    index = 0
    for name in batch_axes(mesh):
        if name in mesh.axis_names:
            axis = mesh.axis_names.index(name)
            index = index * mesh.devices.shape[axis] + int(where[axis][0])
    rows = shape[0] // axis_size(mesh, batch_axes(mesh))
    return slice(index * rows, (index + 1) * rows)


# ---------------------------------------------------------------------------
# placement over processes (DTensor)
# ---------------------------------------------------------------------------

def placements(spec, mesh: Mesh) -> tuple:
    """One DTensor placement per axis of `mesh` for `spec`: ``Shard(i)``
    on each axis that dim i names (a tuple of names shards dim i on each
    of them, in the mesh's axis order), ``Replicate()`` on the others."""
    out = [Replicate()] * len(mesh.axis_names)
    for i, part in enumerate(spec):
        names = part if isinstance(part, tuple) else (part,)
        for name in names:
            if name is not None and name in mesh.axis_names:
                out[mesh.axis_names.index(name)] = Shard(i)
    return tuple(out)


def _gloo_group() -> bool:
    return dist.is_initialized() and dist.get_backend() == "gloo"


def redistribute(x, target):
    """`x` (a DTensor) with placements `target`.  Over gloo, a partial sum
    that must end sharded goes through its all-reduce and then this
    process's slice (both supported on gloo, on the CPU and on the card),
    never a reduce-scatter."""
    target = tuple(target)
    if tuple(x.placements) == target:
        return x
    if _gloo_group() and any(c.is_partial() and t.is_shard()
                             for c, t in zip(x.placements, target)):
        x = x.redistribute(x.device_mesh, [
            Replicate() if c.is_partial() and t.is_shard() else c
            for c, t in zip(x.placements, target)])
    return x.redistribute(x.device_mesh, target)


def gathered(x):
    """`x` replicated on every axis (a weight gathered whole for the op
    that reads it); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return redistribute(x, [Replicate()] * x.device_mesh.ndim)


def batch_only(x):
    """`x` with its dim-0 (batch) sharding kept and every other axis
    replicated: the operand layout of a contraction with a gathered
    weight; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return redistribute(x, [p if p.is_shard(0) else Replicate()
                            for p in x.placements])


def unstacked(x):
    """`x` with no axis sharding its dim 0 (a stacked [L, ...] leaf
    gathered along its layers before they are taken apart); a plain
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return redistribute(x, [Replicate() if p.is_shard(0) else p
                            for p in x.placements])


def write_rows(dst, dim: int, start: int, src) -> None:
    """``dst[..., start:start + n, ...] = src`` along `dim` (n =
    src.shape[dim]), in place.  Over processes `src` is brought to `dst`'s
    placements and each process writes its own shard, which needs `dim`
    unsharded."""
    index = (slice(None),) * dim + (slice(start, start + src.shape[dim]),)
    if not isinstance(dst, DTensor):
        dst[index] = src
        return
    if any(p.is_shard(dim) for p in dst.placements):
        raise ValueError(f"rows of dim {dim} are written in place only "
                         f"where no mesh axis shards that dim")
    dst.to_local()[index] = redistribute(src, dst.placements).to_local()


def local_index(shape, pls, dm):
    """This process's index (a tuple of slices) into a tensor of `shape`
    placed by `pls` on the `DeviceMesh` `dm`."""
    index = [slice(None)] * len(shape)
    sizes = list(shape)
    coord = dm.get_coordinate()
    for axis, p in enumerate(pls):
        if not p.is_shard():
            continue
        d, n = p.dim, dm.size(axis)
        if sizes[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {n}")
        sizes[d] //= n
        start = (index[d].start or 0) + coord[axis] * sizes[d]
        index[d] = slice(start, start + sizes[d])
    return tuple(index)


def place_leaf(t, sharding: NamedSharding):
    """`t` placed by `sharding`: over a spread mesh, a DTensor holding only
    this process's shard (sliced from `t`, whole on every process, and
    copied to this process's device; a DTensor is redistributed);
    otherwise `t` itself, and so are a scalar (a 0-d tensor, the same on
    every process) and a non-tensor."""
    mesh = sharding.mesh
    if not is_spread(mesh) or not isinstance(t, torch.Tensor) or t.ndim == 0:
        return t
    pls = placements(sharding.spec, mesh)
    if isinstance(t, DTensor):
        return redistribute(t, pls)
    dm = device_mesh(mesh)
    part = t[local_index(t.shape, pls, dm)]
    local = torch.empty(part.shape, dtype=t.dtype,
                        device=local_device(mesh)).copy_(part)
    return DTensor.from_local(local, dm, pls, run_check=False,
                              shape=t.shape, stride=local_stride(t.shape))


def local_stride(shape) -> tuple:
    """The row-major strides of `shape`."""
    strides, n = [], 1
    for d in reversed(tuple(shape)):
        strides.append(n)
        n *= d
    return tuple(reversed(strides))


def place(tree, shardings):
    """Every leaf of `tree` placed by the matching leaf of `shardings` (a
    tree of `NamedSharding`, or one for every leaf): the port's
    ``jax.device_put(tree, shardings)``."""
    if isinstance(shardings, NamedSharding):
        return tree_map(lambda t: place_leaf(t, shardings), tree)
    return unflatten(tree, [place_leaf(t, s) for t, s in
                            zip(leaves(tree), leaves(shardings))])


def gather(tree):
    """Every DTensor leaf of `tree` whole, a plain tensor on this process's
    device (a collective that every process of the mesh calls); plain
    leaves as they are."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def zeros_placed(shape, dtype, sharding: NamedSharding):
    """A zero tensor of `shape` placed by `sharding`, made shard by shard:
    no process holds it whole."""
    mesh = sharding.mesh
    pls = placements(sharding.spec, mesh)
    dm = device_mesh(mesh)
    sizes = list(shape)
    for axis, p in enumerate(pls):
        if p.is_shard():
            sizes[p.dim] //= dm.size(axis)
    local = torch.zeros(sizes, dtype=dtype, device=local_device(mesh))
    return DTensor.from_local(local, dm, pls, run_check=False,
                              shape=torch.Size(shape),
                              stride=local_stride(shape))
