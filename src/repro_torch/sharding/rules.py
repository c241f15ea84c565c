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

One process has no partitioner: `constrain` and `constrain_axes` keep the
reference's signatures and return their input itself, with or without a
mesh context.  Placing a model's tensors over processes is ROADMAP.md
queue 1, item 10; the port's models call neither function.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.launch.mesh import Mesh
from repro_torch.utils.trees import unflatten


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
    """Scoped `set_mesh_context`: restores the previous mesh on exit."""
    prev = get_mesh_context()
    set_mesh_context(mesh)
    try:
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

def constrain(x, kind: str):
    """The reference's sharding constraint at a named activation site
    ('bsd', 'bsv', 'ecd', 'attn', 'grad').  One process has no partitioner,
    so this returns `x` itself, with or without a mesh context; placing
    activations over processes is ROADMAP.md queue 1, item 10."""
    return x


def constrain_axes(x, axes: dict):
    """The reference's per-dim constraint ({dim: 'batch' | 'model'}).
    Returns `x` itself, as `constrain` does (one process, no
    partitioner)."""
    return x
