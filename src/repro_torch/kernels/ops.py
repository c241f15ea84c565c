"""Public wrappers of the kernels: the three server updates (over trees of
leaves) and attention.

Ported from `repro.kernels.ops`.  Dispatch is by the tensors' device:

* a CPU tensor takes the kernel's plain PyTorch version (`kernels.ref`);
* a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/<name>.cu``, built by `kernels.build`) or raises.

* a meta tensor (shapes without storage) takes attention's shape-only
  route, an op of its own (`torch.ops.repro_torch.flash_attention`) that
  `launch.analysis` counts as the kernel's useful work (`flash_flops`).

There is no switch and no fallback.  The server-update kernels take each
leaf flat and contiguous and mask its tail, so unlike the TPU wrappers there
is no padding to (R, 128) tiles; the attention kernel takes each tensor's
strides and masks its ragged tails, so it needs neither padding nor
contiguous copies.  A launch runs on PyTorch's current stream, does not
synchronise, and writes out-of-place outputs allocated here.

The three server updates take a whole tree in one launch on the card: the
leaves go to the kernel in a table (`build.leaf_table`,
``repro::LeafTable`` in ``csrc/common.cuh``) of at most `build.MAX_LEAVES`
leaves of one dtype, so a longer tree, or one of mixed dtypes, takes one
launch per such chunk (`_leaf_plan`).  Their per-leaf entries go through
the same kernel with a one-leaf table.  On the CPU the tree entries take
the plain versions leaf by leaf.

Two counts per kernel:

* `LAUNCHES` counts leaf dispatches on either device, the meaning of the
  reference's ``Counters.kernel_launches``: a tree entry adds its number of
  leaves, a leaf entry one.  On the CPU the tests hold it against the
  simulator's counter and the model's layer count.
* `DEVICE_LAUNCHES` counts kernel launches on the card, one where a
  wrapper launches its kernel and nowhere else; it stays 0 on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.utils.trees import leaves, same_structure, unflatten

LAUNCHES = {"fasgd_update": 0, "fused_event_apply": 0,
            "batched_scale_apply": 0, "flash_attention": 0}
DEVICE_LAUNCHES = dict(LAUNCHES)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The elements one block of csrc/fasgd_update.cu owns (its kTile).
FASGD_TILE = 1024
# csrc/batched_update.cu: its rows path takes 4 elements a thread up to
# _WIDE_MAX_K events and 2 above (rows_vec); its terms path's tile bounds
# (kMinTile, kMaxTile) and the terms it stages per chunk (kTerms).
_WIDE_MAX_K = 16
_TERMS_MIN_TILE, _TERMS_MAX_TILE, _TERMS = 32, 256, 4096
# Leaves below this many rows-path tiles take the terms path when K > 16:
# the rows path would not give every SM of the card a block.
_TERMS_BELOW_TILES = 132
# csrc/fused_event_apply.cu's terms path stages a tile's K gradient rows
# whole: at most this many floats (its kStageFloats), so K <= 256.
_FUSED_STAGE = 8192


def reset_launches() -> None:
    """Set every launch count to 0."""
    for counts in (LAUNCHES, DEVICE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _device_kind(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return kind


def _tree_kind(ps) -> str:
    """'cpu' or 'cuda' for leaves that all lie on one device (raises else)."""
    devices = {p.device for p in ps}
    if len(devices) > 1:
        raise ValueError(f"the leaves lie on several devices: {devices}")
    return _device_kind(ps[0])


def _check(name, t, *, device, numel, dtype=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")


def _scalar_f32(x, device) -> torch.Tensor:
    """A float32 device scalar; a tensor already there is not copied."""
    return torch.as_tensor(x, device=device).to(torch.float32).reshape(())


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _leaf_plan(sizes, elems_per_block, groups=None):
    """The launches of a tree kernel whose blocks own `elems_per_block`
    elements of one leaf each (one count for all leaves, or one per leaf):
    the leaves (by index) grouped by `groups` (their dtypes; one group if
    None), in the order each group first appears, in chunks of at most
    `build.MAX_LEAVES`.  Each launch is (leaf indices, first blocks): the
    first block of every leaf of the chunk, then the launch's block count.
    A chunk of empty leaves has no blocks and is left out."""
    groups = [None] * len(sizes) if groups is None else list(groups)
    per_leaf = (list(elems_per_block) if isinstance(elems_per_block,
                                                    (list, tuple))
                else [elems_per_block] * len(sizes))
    by_group = {}
    for i, key in enumerate(groups):
        by_group.setdefault(key, []).append(i)
    plan = []
    for idx in by_group.values():
        for c in range(0, len(idx), build.MAX_LEAVES):
            chunk = idx[c:c + build.MAX_LEAVES]
            starts = [0]
            for i in chunk:
                starts.append(starts[-1] + -(-sizes[i] // per_leaf[i]))
            if starts[-1]:
                plan.append((chunk, starts))
    return plan


def _table(struct, ptrs, sizes, starts):
    """A leaf table of type `struct`: each leaf's pointers, size and first
    block, and the launch's block count."""
    t = struct()
    t.num_leaves = len(sizes)
    for l, (row, n) in enumerate(zip(ptrs, sizes)):
        t.ptr[l][:] = row
        t.size[l] = n
    t.first_block[:len(starts)] = starts
    return t


def _flat_outputs(shapes, dtype, copies, device):
    """`copies` lists of empty leaves of `shapes`, all views of one flat
    buffer, each leaf starting on a 16-byte boundary: one allocation in
    place of one per leaf, on a path that is bound by its host work."""
    layout, total = [], 0
    for shape in shapes:
        strides, n = [], 1
        for d in reversed(shape):
            strides.append(n)
            n *= d
        layout.append((tuple(shape), tuple(reversed(strides)), total))
        total += -(-n // 4) * 4
    buf = torch.empty(copies * total, dtype=dtype, device=device)
    return [[buf.as_strided(shape, strides, c * total + off)
             for shape, strides, off in layout] for c in range(copies)]


def _by_dtype(ps):
    """{dtype: indices of the leaves of that dtype}, in leaf order."""
    groups = {}
    for i, p in enumerate(ps):
        groups.setdefault(p.dtype, []).append(i)
    return groups


def _fasgd_update_cuda(ps, gs, ns, bs, vs, lr, tau, gamma, beta, eps,
                       variant):
    """Launch the tree kernel over the leaves `ps`...; returns one
    (θ', n', b', v') per leaf."""
    dev = ps[0].device
    for p, g, n, b, v in zip(ps, gs, ns, bs, vs):
        if p.dtype not in _DTYPE_CODE:
            raise ValueError(f"params dtype {p.dtype} not supported by the "
                             f"kernel")
        size = p.numel()
        _check("params", p, device=dev, numel=size)
        _check("grads", g, device=dev, numel=size, dtype=p.dtype)
        for nm, t in (("n", n), ("b", b), ("v", v)):
            _check(nm, t, device=dev, numel=size, dtype=torch.float32)
    fn = build.kernel("fasgd_update")
    tau = _scalar_f32(tau, dev)
    outs = [None] * len(ps)
    for dtype, idx in _by_dtype(ps).items():
        # θ' in θ's dtype and n', b', v' in float32: one buffer for all four
        # when θ is float32
        shapes = [ps[i].shape for i in idx]
        if dtype == torch.float32:
            new = _flat_outputs(shapes, dtype, 4, dev)
        else:
            new = (_flat_outputs(shapes, dtype, 1, dev)
                   + _flat_outputs(shapes, torch.float32, 3, dev))
        for j, i in enumerate(idx):
            outs[i] = tuple(o[j] for o in new)
    stream = _stream(dev)
    sizes = [p.numel() for p in ps]
    for chunk, starts in _leaf_plan(sizes, FASGD_TILE,
                                    [p.dtype for p in ps]):
        rows = [[x.data_ptr() for x in (ps[i], gs[i], ns[i], bs[i], vs[i],
                                        *outs[i])] for i in chunk]
        table = _table(build.FASGD_TABLE, rows, [sizes[i] for i in chunk],
                       starts)
        with torch.cuda.device(dev):
            rc = fn(_DTYPE_CODE[ps[chunk[0]].dtype], int(variant == "literal"),
                    table, tau.data_ptr(), lr, gamma, 1.0 - gamma, beta,
                    1.0 - beta, eps, stream)
        _raise_on(rc, "fasgd_update")
        DEVICE_LAUNCHES["fasgd_update"] += 1
    return outs


def fasgd_update_leaf(p, g, n, b, v, lr, tau, *, gamma=0.9, beta=0.9,
                      eps=1e-8, variant="intent"):
    """One FASGD push on one leaf: (θ', n', b', v'), statistics float32.

    `tau` is a float or a float32 device scalar; `lr` and the constants are
    floats.
    """
    if variant not in ("intent", "literal"):
        raise ValueError(f"unknown variant {variant!r}")
    LAUNCHES["fasgd_update"] += 1
    if _device_kind(p) == "cpu":
        return ref.fasgd_update_ref(p, g, n, b, v, lr, tau, gamma=gamma,
                                    beta=beta, eps=eps, variant=variant)
    return _fasgd_update_cuda([p], [g], [n], [b], [v], lr, tau, gamma, beta,
                              eps, variant)[0]


def _unzip(params, outs):
    return tuple(unflatten(params, [o[i] for o in outs]) for i in range(4))


def fasgd_update(params: Any, grads: Any, n: Any, b: Any, v: Any, lr, tau,
                 *, gamma=0.9, beta=0.9, eps=1e-8, variant="intent"):
    """Fused FASGD update over trees: one launch on the card for up to
    `build.MAX_LEAVES` leaves of one dtype, the plain version leaf by leaf
    on the CPU.

    Returns (params', n', b', v') trees; the statistics are float32.
    """
    if variant not in ("intent", "literal"):
        raise ValueError(f"unknown variant {variant!r}")
    ps = leaves(params)
    if not ps:
        return _unzip(params, [])
    trees = (ps, leaves(grads), leaves(n), leaves(b), leaves(v))
    if _tree_kind(ps) == "cpu":
        outs = [fasgd_update_leaf(p, g, nn, bb, vv, lr, tau, gamma=gamma,
                                  beta=beta, eps=eps, variant=variant)
                for p, g, nn, bb, vv in zip(*trees)]
    else:
        LAUNCHES["fasgd_update"] += len(ps)
        outs = _fasgd_update_cuda(*trees, lr, tau, gamma, beta, eps, variant)
    return _unzip(params, outs)


# The most events `csrc/batched_update.cu` and `csrc/fused_event_apply.cu`
# take (their kMaxEvents).
MAX_BATCHED_EVENTS = 4096


def _rows_tile(K: int) -> int:
    """The elements a rows-path block of csrc/batched_update.cu and
    csrc/fused_event_apply.cu owns."""
    return 256 * (4 if K <= _WIDE_MAX_K else 2)


def _batched_tiles(K: int, sizes):
    """The tile of csrc/batched_update.cu's terms path at K events, and
    which leaves take it: above 16 events, the leaves too small to give
    the rows path a block per SM (at K = 128 the MLP's b0, b1 and w1, not
    w0); all leaves take the rows path up to 16.  The tile is the power of
    two nearest below 4096 / K within the path's bounds (32 at K = 128)."""
    tile = 1 << max(0, (_TERMS // K).bit_length() - 1)
    tile = min(_TERMS_MAX_TILE, max(_TERMS_MIN_TILE, tile))
    terms = [K > _WIDE_MAX_K and n < _TERMS_BELOW_TILES * _rows_tile(K)
             for n in sizes]
    return tile, terms


def _batched_plan(K: int, sizes, dtypes):
    """(launches as `_leaf_plan` gives them, the terms path's tile, which
    leaves take it) of csrc/batched_update.cu over leaves of `sizes` and
    `dtypes` at K events."""
    tile, terms = _batched_tiles(K, sizes)
    plan = _leaf_plan(sizes, [tile if x else _rows_tile(K) for x in terms],
                      dtypes)
    return plan, tile, terms


def _per_leaf(x, params, n):
    """One entry per leaf: `x`'s leaves when it is a tree that mirrors
    `params` (the reference's rule, `repro.kernels.ops.fused_event_apply`),
    else `x` itself `n` times (a shared vector or scalar, or None)."""
    if x is not None and same_structure(x, params):
        return leaves(x)
    return [x] * n


def _device_vectors(dev):
    """A converter of [K] vectors and scalars to contiguous float32 tensors
    on `dev`, each converted once however many leaves share it (the value
    is kept beside it so that its id is not reused meanwhile)."""
    made = {}

    def vec(name, x, numel):
        if id(x) not in made:
            t = torch.as_tensor(x, device=dev).to(torch.float32).contiguous()
            _check(name, t, device=dev, numel=numel)
            made[id(x)] = (t, x)
        return made[id(x)][0]
    return vec


def _fused_plan(K: int, sizes, dtypes, terms=None):
    """(launches as `_leaf_plan` gives them, the terms path's tile, which
    leaves take it) of csrc/fused_event_apply.cu over leaves of `sizes`
    and `dtypes` at K events: `_batched_plan`'s choice where the terms
    path can stage a tile's K gradient rows whole (K <= 256), the rows
    path for every leaf above.  `terms` (one bool per leaf) overrides the
    choice, for timing a leaf on the path it would not take."""
    tile, chosen = _batched_tiles(K, sizes)
    if K * tile > _FUSED_STAGE:
        chosen = [False] * len(sizes)
    terms = chosen if terms is None else list(terms)
    plan = _leaf_plan(sizes, [tile if x else _rows_tile(K) for x in terms],
                      dtypes)
    return plan, tile, terms


def _fused_tree_cuda(ps, gs, ns, bs, vs, ws, wms, ts, hps, lr, gamma, beta,
                     eps, variant, mode, track_stats, terms=None):
    """Launch the tree kernel over the leaves `ps`, each with its own [K]
    weights/wmean/τ and has_push (shared ones are one tensor); returns one
    (θ', n', b', v') per leaf.  With track_stats off, n', b', v' are the
    inputs n, b, v themselves, as in the plain version."""
    dev = ps[0].device
    K = gs[0].shape[0] if gs[0].dim() else 0
    if not 1 <= K <= MAX_BATCHED_EVENTS:
        raise ValueError(f"{K} events: the kernel takes 1 to "
                         f"{MAX_BATCHED_EVENTS}")
    vec = _device_vectors(dev)
    rows = []
    for p, g, n, b, v, w, wm, t, hp in zip(ps, gs, ns, bs, vs, ws, wms, ts,
                                          hps):
        if p.dtype not in _DTYPE_CODE:
            raise ValueError(f"params dtype {p.dtype} not supported by the "
                             f"kernel")
        size = p.numel()
        _check("params", p, device=dev, numel=size)
        _check("grads", g, device=dev, numel=K * size, dtype=p.dtype)
        for nm, x in (("n", n), ("b", b), ("v", v)):
            _check(nm, x, device=dev, numel=size, dtype=torch.float32)
        rows.append([p.data_ptr(), g.data_ptr(), n.data_ptr(), b.data_ptr(),
                     v.data_ptr(), vec("weights", w, K).data_ptr(),
                     vec("wmean", wm, K).data_ptr(),
                     vec("taus", t, K).data_ptr(),
                     vec("has_push", hp, 1).data_ptr()])
    outs = [None] * len(ps)
    for dtype, idx in _by_dtype(ps).items():
        # θ' in θ's dtype and n', b', v' in float32: one buffer for all four
        # when θ is float32
        shapes = [ps[i].shape for i in idx]
        if not track_stats:
            new = _flat_outputs(shapes, dtype, 1, dev)
            new += [[ns[i] for i in idx], [bs[i] for i in idx],
                    [vs[i] for i in idx]]
        elif dtype == torch.float32:
            new = _flat_outputs(shapes, dtype, 4, dev)
        else:
            new = (_flat_outputs(shapes, dtype, 1, dev)
                   + _flat_outputs(shapes, torch.float32, 3, dev))
        for j, i in enumerate(idx):
            outs[i] = tuple(o[j] for o in new)
            rows[i] += [x.data_ptr() for x in outs[i]]
    sizes = [p.numel() for p in ps]
    plan, tile, terms = _fused_plan(K, sizes, [p.dtype for p in ps], terms)
    fn = build.kernel("fused_event_apply")
    stream = _stream(dev)
    for chunk, starts in plan:
        table = _table(build.FUSED_TABLE, [rows[i] for i in chunk],
                       [sizes[i] for i in chunk], starts)
        terms_leaves = sum(1 << j for j, i in enumerate(chunk) if terms[i])
        with torch.cuda.device(dev):
            rc = fn(_DTYPE_CODE[ps[chunk[0]].dtype], int(mode == "fasgd"),
                    int(track_stats), int(variant == "literal"), table, lr,
                    gamma, 1.0 - gamma, beta, 1.0 - beta, eps, K, tile,
                    terms_leaves, stream)
        _raise_on(rc, "fused_event_apply")
        DEVICE_LAUNCHES["fused_event_apply"] += 1
    return outs


def _check_modes(mode, variant):
    if mode not in ("coeff", "fasgd"):
        raise ValueError(f"unknown mode {mode!r}")
    if variant not in ("intent", "literal"):
        raise ValueError(f"unknown variant {variant!r}")


def fused_event_apply_leaf(p, g, n, b, v, weights, wmean, taus, has_push, *,
                           lr, gamma=0.9, beta=0.9, eps=1e-8,
                           variant="intent", mode="fasgd", track_stats=True):
    """One K-event server apply on one leaf: (θ', n', b', v').

    `g` is [K, *p.shape]; `weights`/`wmean`/`taus` are [K] and `has_push` a
    scalar, all allowed to live on the device.  On the card the leaf goes
    through the tree kernel with a one-leaf table.
    """
    _check_modes(mode, variant)
    LAUNCHES["fused_event_apply"] += 1
    if _device_kind(p) == "cpu":
        return ref.fused_event_apply_ref(
            p, g, n, b, v, weights, wmean, taus, lr, has_push, gamma=gamma,
            beta=beta, eps=eps, variant=variant, mode=mode,
            track_stats=track_stats)
    return _fused_tree_cuda([p], [g], [n], [b], [v], [weights], [wmean],
                            [taus], [has_push], lr, gamma, beta, eps, variant,
                            mode, track_stats)[0]


def fused_event_apply(params: Any, grads: Any, n: Any, b: Any, v: Any,
                      weights, wmean, taus, has_push, *, lr, gamma=0.9,
                      beta=0.9, eps=1e-8, variant="intent", mode="fasgd",
                      track_stats=True):
    """One-kernel K-event server apply over trees: one launch on the card
    for up to `build.MAX_LEAVES` leaves of one dtype, the plain version
    leaf by leaf on the CPU.

    `grads` leaves carry a leading [K] event axis.  `weights`/`wmean`/
    `taus` ([K]) and `has_push` (a scalar) are each shared by every leaf,
    or a tree that mirrors `params` with one per leaf (per-tensor gating
    and staleness).  `n`/`b`/`v` must be float32.  Returns (params', n',
    b', v') with the statistics in float32.
    """
    _check_modes(mode, variant)
    ps = leaves(params)
    k = len(ps)
    trees = (ps, leaves(grads), leaves(n), leaves(b), leaves(v),
             _per_leaf(weights, params, k), _per_leaf(wmean, params, k),
             _per_leaf(taus, params, k), _per_leaf(has_push, params, k))
    kw = dict(lr=lr, gamma=gamma, beta=beta, eps=eps, variant=variant,
              mode=mode, track_stats=track_stats)
    if not ps or _tree_kind(ps) == "cpu":
        outs = [fused_event_apply_leaf(*leaf, **kw) for leaf in zip(*trees)]
    else:
        LAUNCHES["fused_event_apply"] += k
        outs = _fused_tree_cuda(*trees, lr, gamma, beta, eps, variant, mode,
                                track_stats)
    return _unzip(params, outs)


def _batched_tree_cuda(ps, gs, vs, cs, ts, ms, lr, eps, mode):
    """Launch the tree kernel over the leaves `ps`, each with its own [K]
    coeffs/τ/masks (`ms` all None for no mask); returns θ' per leaf."""
    dev = ps[0].device
    K = gs[0].shape[0] if gs[0].dim() else 0
    if not 1 <= K <= MAX_BATCHED_EVENTS:
        raise ValueError(f"{K} events: the kernel takes 1 to "
                         f"{MAX_BATCHED_EVENTS}")
    vec = _device_vectors(dev)
    rows = []
    for p, g, v, c, t, m in zip(ps, gs, vs, cs, ts, ms):
        if p.dtype not in _DTYPE_CODE:
            raise ValueError(f"params dtype {p.dtype} not supported by the "
                             f"kernel")
        size = p.numel()
        _check("params", p, device=dev, numel=size)
        _check("grads", g, device=dev, numel=K * size, dtype=p.dtype)
        _check("v", v, device=dev, numel=size, dtype=torch.float32)
        rows.append([p.data_ptr(), g.data_ptr(), v.data_ptr(),
                     vec("coeffs", c, K).data_ptr(),
                     vec("taus", t, K).data_ptr(),
                     None if m is None else vec("masks", m, K).data_ptr()])
    fn = build.kernel("batched_update")
    outs = [None] * len(ps)
    for dtype, idx in _by_dtype(ps).items():
        for i, o in zip(idx, _flat_outputs([ps[i].shape for i in idx], dtype,
                                           1, dev)[0]):
            outs[i] = o
            rows[i].append(o.data_ptr())
    sizes = [p.numel() for p in ps]
    plan, tile, terms = _batched_plan(K, sizes, [p.dtype for p in ps])
    stream = _stream(dev)
    for chunk, starts in plan:
        table = _table(build.BATCHED_TABLE, [rows[i] for i in chunk],
                       [sizes[i] for i in chunk], starts)
        terms_leaves = sum(1 << j for j, i in enumerate(chunk) if terms[i])
        with torch.cuda.device(dev):
            rc = fn(_DTYPE_CODE[ps[chunk[0]].dtype], int(mode == "fasgd"),
                    int(ms[0] is not None), table, lr, eps, K, tile,
                    terms_leaves, stream)
        _raise_on(rc, "batched_scale_apply")
        DEVICE_LAUNCHES["batched_scale_apply"] += 1
    return outs


def _batched_scale_apply_cuda(p, g, v, coeffs, taus, masks, lr, eps, mode):
    """One leaf through the tree kernel, with a one-leaf table."""
    return _batched_tree_cuda([p], [g], [v], [coeffs], [taus], [masks], lr,
                              eps, mode)[0]


def batched_scale_apply_leaf(p, g, v, coeffs, taus, *, masks=None, lr,
                             eps=1e-8, mode="fasgd"):
    """θ' = θ - Σ_k m_k·c_k·scale_k·g_k on one leaf, in θ's dtype.

    `g` is [K, *p.shape]; `coeffs`, `taus` and `masks` are [K], allowed to
    live on the device; `masks=None` weighs event k by c_k alone.  scale_k
    is lr / (v·τ_k + ε) in 'fasgd' mode and 1 in 'coeff' mode, where `v`
    is not read.
    """
    if mode not in ("coeff", "fasgd"):
        raise ValueError(f"unknown mode {mode!r}")
    LAUNCHES["batched_scale_apply"] += 1
    if _device_kind(p) == "cpu":
        return ref.batched_scale_apply_ref(p, g, v, coeffs, taus, lr,
                                           masks=masks, eps=eps, mode=mode)
    return _batched_scale_apply_cuda(p, g, v, coeffs, taus, masks, lr, eps,
                                     mode)


def batched_scale_apply(params: Any, grads: Any, v: Any, coeffs, taus, *,
                        masks=None, lr, eps=1e-8, mode="fasgd"):
    """Σ_k m_k·c_k·scale(v,τ_k)·g_k applied over trees: one launch on the
    card for up to `build.MAX_LEAVES` leaves of one dtype, the plain
    version leaf by leaf on the CPU; returns params' in the params' dtypes.

    `grads` leaves carry a leading [K] event axis.  `coeffs`, `taus` and
    `masks` are each one [K] vector shared by every leaf, or a tree that
    mirrors `params` with one [K] vector per leaf (per-tensor gating and
    per-tensor staleness).  `masks=None` means the push decision is already
    folded into `coeffs`, the same as an all-ones mask.
    """
    if mode not in ("coeff", "fasgd"):
        raise ValueError(f"unknown mode {mode!r}")
    ps = leaves(params)
    k = len(ps)
    trees = (ps, leaves(grads), leaves(v), _per_leaf(coeffs, params, k),
             _per_leaf(taus, params, k), _per_leaf(masks, params, k))
    if not ps or _tree_kind(ps) == "cpu":
        outs = [batched_scale_apply_leaf(p, g, vv, c, t, masks=m, lr=lr,
                                         eps=eps, mode=mode)
                for p, g, vv, c, t, m in zip(*trees)]
    else:
        LAUNCHES["batched_scale_apply"] += len(ps)
        outs = _batched_tree_cuda(*trees, lr, eps, mode)
    return unflatten(params, outs)


# The flash kernel's shape-only route: an op with a meta implementation
# alone, so that a counting dispatch mode sees one call with q, k, v in and
# o out, as on the card, and not the plain version's full score matrix.
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window) -> Tensor")
_LIB.impl("flash_attention",
          lambda q, k, v, causal, window: torch.empty_like(q), "Meta")


def visible_pairs(Lq: int, Lk: int, causal: bool, window: int) -> int:
    """The query-key pairs that `attention`'s mask lets through, the
    queries being the last Lq of Lk positions."""
    pos = np.arange(Lk - Lq, Lk, dtype=np.int64)
    hi = pos if causal else np.full_like(pos, Lk - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_flops(q_shape, k_shape, causal: bool, window: int) -> int:
    """The flash kernel's useful work: 4·B·Hq·(visible pairs)·D, two FLOPs
    a multiply-add in q·kᵀ and in p·v; masked pairs are not counted."""
    B, Hq, Lq, D = q_shape
    return 4 * B * Hq * visible_pairs(Lq, k_shape[2], causal, window) * D


_HEAD_DIMS = (32, 64, 80, 96, 112, 128, 192)
# Lq up to this takes the decode kernel, which splits the keys across at
# most _DECODE_MAX_SPLITS blocks and merges their (m, l, acc) from a float32
# scratch buffer (kRowsMaxLq and kMaxSplits in csrc/flash_attention.cu).
_DECODE_MAX_LQ = 16
_DECODE_MAX_SPLITS = 32


def _attention_cuda(q, k, v, causal, window, sm_scale):
    B, Hq, Lq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    Hkv, Lk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{Hq} q heads do not group over {Hkv} kv heads")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if min(B, Hq, Lq, Lk) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype} not supported by the kernel")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{nm} is {t.dtype} on {t.device}, expected "
                             f"{q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{nm}'s last dimension must be contiguous")
    o = torch.empty_like(q)          # q's layout where q is dense, else packed
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *o.stride()[:3])
    scratch = None
    if Lq <= _DECODE_MAX_LQ:
        scratch = torch.empty(B * Hq * Lq * _DECODE_MAX_SPLITS * (D + 2),
                              dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = build.kernel("flash_attention")(
            _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, Hq, Hkv, Lq, Lk, strides, int(causal),
            int(window), sm_scale,
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel(), _stream(q.device))
    _raise_on(rc, "flash_attention")
    DEVICE_LAUNCHES["flash_attention"] += 1
    return o


def _refuse_training(q, k, v):
    """Raise where the flash kernel would silently cut a gradient: it is
    launched through raw pointers, so its output has no autograd history
    and a functorch-batched input has no pointer of its own."""
    from torch._C._functorch import is_functorch_wrapped_tensor
    ts = (q, k, v)
    if any(is_functorch_wrapped_tensor(t) for t in ts):
        raise RuntimeError(
            "ops.attention: the flash kernel takes no torch.func-transformed "
            "(vmapped or grad-tracked) input; the training path attends "
            "through models.attention._sdpa")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "ops.attention: the flash kernel has no backward, so an input "
            "that requires grad would get none; the training path attends "
            "through models.attention._sdpa")


def attention(q, k, v, *, causal=True, window=0, sm_scale=None):
    """Exact GQA attention: q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D] → o like q.

    Causal and sliding-window (`window` > 0) masks; the queries are the last
    Lq positions of the kv axis; a row with no visible key outputs 0;
    `sm_scale` defaults to 1/√D.  On the card the tensors may be strided
    views (permuted heads, cache slices) as long as their last dimension is
    contiguous; the output keeps q's layout.  The kernel is for serving: on
    the card an input that requires grad (with autograd recording) or is
    transformed by `torch.func` raises `RuntimeError`.  On the meta device
    it returns an empty output of q's shape (the shape-only route).
    """
    if q.device.type == "meta":
        return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal),
                                                     int(window))
    on_card = _device_kind(q) == "cuda"
    if on_card:
        _refuse_training(q, k, v)
    LAUNCHES["flash_attention"] += 1
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if not on_card:
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 sm_scale=sm_scale)
    return _attention_cuda(q, k, v, causal, window, sm_scale)
