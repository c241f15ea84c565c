"""The tree entries of the port's one-launch kernels on the CPU.

`repro_torch.kernels.ops.fasgd_update` and `ops.batched_scale_apply` take a
whole tree in one launch on the card: `_leaf_plan` splits the leaves into
launches of at most `build.MAX_LEAVES` leaves of one dtype and gives each
leaf its first block, and `_table` packs a launch into the ctypes mirror of
``repro::LeafTable`` (csrc/common.cuh).  The CUDA kernels run only on the
card (`chip_smoke.py` phases 2, 3 and 11); here the plan is held against
the kernels' block-to-leaf search, mirrored in Python, and the tree entries
(on the CPU, the plain versions leaf by leaf) against the per-leaf plain
versions and the live JAX entry points in interpret mode, on a 40-leaf tree
of mixed sizes and dtypes.

Tolerances as tests/test_torch_kernels.py and
tests/test_torch_batched_update.py state them: fp32 rtol 1e-5 / atol 1e-6
(n, b: atol 1e-7; the literal variant's v rtol 5e-3), bf16 θ rtol 2e-2 /
atol 1e-2.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.kernels import build, ops, ref
from repro_torch.utils.trees import leaves

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=1e-2)
# 40 leaves: the MLP's sizes and some ragged ones, in both dtypes
SIZES = [(1, 10, 200, 1023, 2000, 156_800)[i % 6] for i in range(40)]
DTYPES = ["float32" if i % 3 else "bfloat16" for i in range(40)]


def _block_leaf(starts, block):
    """The leaf of `block`, as the kernels find it (`repro::find_leaf`)."""
    leaf = 0
    while leaf + 2 < len(starts) and block >= starts[leaf + 1]:
        leaf += 1
    return leaf


@pytest.mark.parametrize("tile", [ops.FASGD_TILE, 32, 256, 512, "per leaf"])
@pytest.mark.parametrize("sizes", [SIZES, [0, 7, 0, 4096, 4097, 0],
                                   [156_800], [0] * 3 + [5] * 70])
def test_leaf_plan_covers_every_element_once(sizes, tile):
    """Every element of every leaf is owned by exactly one (block, offset)
    of exactly one launch, and a launch takes at most MAX_LEAVES leaves of
    one dtype; 'per leaf' gives the leaves below 4096 elements 32-element
    tiles and the others 512, as `batched_scale_apply`'s two paths do."""
    dtypes = [DTYPES[i % 40] for i in range(len(sizes))]
    if tile == "per leaf":
        tile = [32 if n < 4096 else 512 for n in sizes]
    plan = ops._leaf_plan(sizes, tile, dtypes)
    tiles = tile if isinstance(tile, list) else [tile] * len(sizes)
    seen = [np.zeros(n, dtype=np.int64) for n in sizes]
    for chunk, starts in plan:
        assert 1 <= len(chunk) <= build.MAX_LEAVES
        assert len(starts) == len(chunk) + 1 and starts[0] == 0
        assert len({dtypes[i] for i in chunk}) == 1
        for block in range(starts[-1]):
            l = _block_leaf(starts, block)
            n, leaf_tile = sizes[chunk[l]], tiles[chunk[l]]
            first = (block - starts[l]) * leaf_tile
            assert 0 <= first < n             # no block without elements
            seen[chunk[l]][first:first + leaf_tile] += 1
    for n, s in zip(sizes, seen):
        assert s.shape == (n,) and (s == 1).all()


def test_leaf_plan_chunks_and_dtypes():
    """40 leaves of two dtypes: the 14 bfloat16 leaves take one launch and
    the 26 float32 leaves another, the first leaf's group first; 70 leaves
    of one dtype take launches of 32, 32 and 6, in leaf order; a tree of
    empty leaves takes none."""
    plan = ops._leaf_plan(SIZES, ops.FASGD_TILE, DTYPES)
    groups = [[DTYPES[i] for i in chunk] for chunk, _ in plan]
    assert [g[0] for g in groups] == ["bfloat16", "float32"]
    assert [len(g) for g in groups] == [DTYPES.count("bfloat16"),
                                        DTYPES.count("float32")]
    one = ops._leaf_plan(SIZES + SIZES[:30], 1024)
    assert [len(c) for c, _ in one] == [32, 32, 6]
    assert sum((c for c, _ in one), []) == list(range(70))
    assert ops._leaf_plan([0, 0], 1024) == []


def test_leaf_table_layout():
    """The ctypes tables have repro::LeafTable's layout: pointers [32][P],
    then sizes, block starts and the leaf count (the loader also checks the
    size against the library's on the card)."""
    for struct, n_ptrs in ((build.FASGD_TABLE, 9), (build.BATCHED_TABLE, 7),
                           (build.FUSED_TABLE, 13)):
        ptr_bytes = build.MAX_LEAVES * n_ptrs * 8
        assert struct.size.offset == ptr_bytes
        assert struct.first_block.offset == ptr_bytes + 8 * build.MAX_LEAVES
        assert ctypes.sizeof(struct) == (ptr_bytes + 8 * build.MAX_LEAVES
                                         + 8 * (build.MAX_LEAVES + 1) + 8)
        assert ctypes.sizeof(struct) < 4096 - 64     # kernel parameters
    rows = [[1000 * l + j for j in range(9)] for l in range(3)]
    t = ops._table(build.FASGD_TABLE, rows, [5, 0, 2000], [0, 1, 1, 3])
    assert t.num_leaves == 3
    assert [list(t.ptr[l]) for l in range(3)] == [
        [x or None for x in r] for r in rows]
    assert list(t.size[:3]) == [5, 0, 2000]
    assert list(t.first_block[:4]) == [0, 1, 1, 3]


@pytest.mark.parametrize("K", [1, 5, 16, 17, 33, 128, 4096])
def test_batched_paths(K):
    """Up to 16 events every leaf takes the rows path (1024-element tiles);
    above, the leaves below 132 rows tiles (of 512 elements) take the terms
    path, in a power-of-two tile of
    [32, 256] that divides the 256 threads, whose chunks of min(K, 4096 /
    tile) events give each thread at most 16 terms.  The plan gives each
    path's leaves that path's tiles."""
    sizes = [10, 200, 2000, 156_800, 2_097_152]
    plan, tile, terms = ops._batched_plan(K, sizes, ["float32"] * 5)
    assert 32 <= tile <= 256 and 256 % tile == 0
    assert tile * min(K, 4096 // tile) <= 16 * 256
    assert terms == [K > 16] * 3 + [False, False]
    (chunk, starts), = plan
    rows_tile = 1024 if K <= 16 else 512
    blocks = [-(-n // (tile if x else rows_tile))
              for n, x in zip(sizes, terms)]
    assert chunk == list(range(5))
    assert list(np.diff(starts)) == blocks


def test_fused_table_and_signature():
    """`fused_event_apply`'s table: 13 pointers a leaf (θ g n b v w wmean τ
    has_push θ' n' b' v'), 3,856 bytes (32·13·8 + 32·8 + 33·8 + 8, the
    size csrc/fused_event_apply.cu asserts), checked against the library at
    load; the entry takes it by value."""
    assert ctypes.sizeof(build.FUSED_TABLE) == 3856
    assert build.TABLES["fused_event_apply"] == (
        build.FUSED_TABLE, "repro_fused_event_apply_table_bytes")
    symbol, argtypes = build.SIGNATURES["fused_event_apply"]
    assert symbol == "repro_fused_event_apply"
    assert argtypes[4] is build.FUSED_TABLE
    assert argtypes.count(build.FUSED_TABLE) == 1
    rows = [[1000 * l + j + 1 for j in range(13)] for l in range(2)]
    t = ops._table(build.FUSED_TABLE, rows, [200, 156_800], [0, 7, 313])
    assert [list(t.ptr[l]) for l in range(2)] == rows
    assert list(t.first_block[:3]) == [0, 7, 313]


@pytest.mark.parametrize("K", [1, 16, 17, 128, 256, 257, 4096])
def test_fused_paths(K):
    """`fused_event_apply` takes `batched_scale_apply`'s paths where its
    terms path can stage a tile's K rows whole (K·tile <= 8192, so K <=
    256): the MLP's small leaves on the terms path at 16 < K <= 256, w0
    and the 2M leaf on the rows path; every leaf on the rows path at K <=
    16 and above 256.  The plan gives each path's leaves that path's
    tiles, and `terms` forces a path."""
    sizes = [10, 200, 2000, 156_800, 2_097_152]
    plan, tile, terms = ops._fused_plan(K, sizes, ["float32"] * 5)
    assert terms == [16 < K <= 256] * 3 + [False, False]
    if any(terms):
        assert K * tile <= ops._FUSED_STAGE and 256 % tile == 0
    (chunk, starts), = plan
    rows_tile = 1024 if K <= 16 else 512
    assert list(np.diff(starts)) == [-(-n // (tile if x else rows_tile))
                                     for n, x in zip(sizes, terms)]
    forced = ops._fused_plan(K, sizes, ["float32"] * 5, terms=[True] * 5)
    assert forced[2] == [True] * 5
    assert list(np.diff(forced[0][0][1])) == [-(-n // tile) for n in sizes]


def test_fused_plan_launches_per_dtype_and_32_leaves():
    """The 40-leaf tree takes one launch per dtype (and per 32 leaves): two
    for one dtype, one each mixed."""
    for dtypes, want in ((["float32"] * 40, 2), (["bfloat16"] * 40, 2),
                         (DTYPES, 2)):
        plan = ops._fused_plan(128, SIZES, dtypes)[0]
        assert len(plan) == want
        assert sorted(i for c, _ in plan for i in c) == list(range(40))


def test_flat_outputs_are_aligned_disjoint_views():
    shapes = [(200,), (784, 200), (10,), (200, 10), ()]
    outs = ops._flat_outputs(shapes, torch.bfloat16, 3, torch.device("cpu"))
    spans = []
    for copy in outs:
        for x, s in zip(copy, shapes):
            assert x.shape == s and x.is_contiguous()
            assert x.dtype == torch.bfloat16
            assert x.data_ptr() % 8 == 0              # 4 elements of bf16
            spans.append((x.data_ptr(), x.data_ptr() + 2 * x.numel()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_tree_of_mixed_devices_raises():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="devices"):
        ops.fasgd_update([x, x.to("meta")], [x, x], [x, x], [x, x], [x, x],
                         0.01, 1.0)


def _tree(seed, dtypes, K=None):
    """θ, g (in `dtypes`; g with a leading [K] when K is given), n, b, v as
    lists of numpy float32 arrays over SIZES."""
    rng = np.random.default_rng(seed)
    rnd = lambda n, s=1.0: (s * rng.standard_normal(n)).astype(np.float32)
    gshape = lambda n: n if K is None else (K, n)
    return ([rnd(n) for n in SIZES], [rnd(gshape(n), 0.1) for n in SIZES],
            [np.abs(rnd(n, 0.01)) for n in SIZES],
            [rnd(n, 0.05) for n in SIZES],
            [1.0 + rnd(n, 0.1) for n in SIZES])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("variant", ["intent", "literal"])
def test_fasgd_update_tree_matches_leaves_and_jax(variant):
    p, g, n, b, v = _tree(0, DTYPES)
    tdt = [getattr(torch, d) for d in DTYPES]
    T = lambda xs, dts=None: [torch.from_numpy(x).to(dt) if dts else
                              torch.from_numpy(x)
                              for x, dt in zip(xs, dts or xs)]
    args = (T(p, tdt), T(g, tdt), T(n), T(b), T(v))
    tau = torch.tensor(3.0)
    ops.reset_launches()
    got = ops.fasgd_update(*args, 0.01, tau, variant=variant)
    assert ops.LAUNCHES["fasgd_update"] == 40
    assert ops.DEVICE_LAUNCHES == dict.fromkeys(ops.DEVICE_LAUNCHES, 0)
    for i, leaf_args in enumerate(zip(*args)):
        want = ref.fasgd_update_ref(*leaf_args, 0.01, tau, variant=variant)
        for out, w in zip(got, want):
            assert out[i].dtype == w.dtype and torch.equal(out[i], w)
    J = lambda xs, dts=None: [jnp.asarray(x, jnp.dtype(dt)) if dts else
                              jnp.asarray(x) for x, dt in zip(xs, dts or xs)]
    want = jops.fasgd_update(J(p, DTYPES), J(g, DTYPES), J(n), J(b), J(v),
                             0.01, 3.0, variant=variant, interpret=True)
    for i, dt in enumerate(DTYPES):
        np.testing.assert_allclose(_f32(got[0][i]), _f32(want[0][i]),
                                   **(F32 if dt == "float32" else BF16))
        for j in (1, 2):
            np.testing.assert_allclose(got[j][i].numpy(), want[j][i],
                                       rtol=1e-5, atol=1e-7)
        # the literal v is ill-conditioned where n ≈ b² (see
        # tests/test_torch_kernels.py): rtol 5e-3 there
        np.testing.assert_allclose(got[3][i].numpy(), want[3][i],
                                   rtol=1e-5 if variant == "intent" else 5e-3,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["coeff", "fasgd"])
def test_batched_scale_apply_tree_matches_leaves_and_jax(mode):
    K = 3
    p, g, _, _, v = _tree(1, DTYPES, K=K)
    rng = np.random.default_rng(2)
    coeffs = (0.5 + rng.random(K)).astype(np.float32)
    taus = [rng.integers(1, 40, K).astype(np.float32) for _ in SIZES]
    masks = [(rng.random(K) < 0.7).astype(np.float32) for _ in SIZES]
    tdt = [getattr(torch, d) for d in DTYPES]
    T = torch.from_numpy
    tp = [T(x).to(dt) for x, dt in zip(p, tdt)]
    tg = [T(x).to(dt) for x, dt in zip(g, tdt)]
    ops.reset_launches()
    got = ops.batched_scale_apply(tp, tg, [T(x) for x in v], T(coeffs),
                                  [T(t) for t in taus],
                                  masks=[T(m) for m in masks], lr=0.01,
                                  mode=mode)
    assert ops.LAUNCHES["batched_scale_apply"] == 40
    assert ops.DEVICE_LAUNCHES == dict.fromkeys(ops.DEVICE_LAUNCHES, 0)
    for i in range(40):
        want = ref.batched_scale_apply_ref(tp[i], tg[i], T(v[i]), T(coeffs),
                                           T(taus[i]), 0.01,
                                           masks=T(masks[i]), mode=mode)
        assert got[i].dtype == tdt[i] and torch.equal(got[i], want)
    want = jops.batched_scale_apply(
        [jnp.asarray(x, jnp.dtype(d)) for x, d in zip(p, DTYPES)],
        [jnp.asarray(x, jnp.dtype(d)) for x, d in zip(g, DTYPES)],
        [jnp.asarray(x) for x in v], jnp.asarray(coeffs),
        [jnp.asarray(t) for t in taus], masks=[jnp.asarray(m) for m in masks],
        lr=0.01, mode=mode, interpret=True)
    for a, e, dt in zip(leaves(got), want, DTYPES):
        np.testing.assert_allclose(_f32(a), _f32(e),
                                   **(F32 if dt == "float32" else BF16))


@pytest.mark.parametrize("mode", ["coeff", "fasgd"])
def test_fused_event_apply_tree_matches_leaves_and_jax(mode):
    """The 40-leaf tree (mixed dtypes) with per-leaf weights/wmean/τ and
    has_push (0 on every third leaf) through the tree entry: on the CPU,
    each leaf's plain version to the bit, one dispatch per leaf and no
    kernel launch; against the reference's tree entry in interpret mode,
    fp32 rtol 1e-4 / atol 1e-6 (K-sums in another order), bf16 θ as
    above."""
    K = 3
    p, g, n, b, v = _tree(3, DTYPES, K=K)
    rng = np.random.default_rng(4)
    masks = [(rng.random(K) < 0.7).astype(np.float32) for _ in SIZES]
    w = [0.01 * m for m in masks]
    wm = [m / max(m.sum(), 1.0) for m in masks]
    taus = [rng.integers(1, 40, K).astype(np.float32) for _ in SIZES]
    hp = [i % 3 != 2 for i in range(40)]
    tdt = [getattr(torch, d) for d in DTYPES]
    T = torch.from_numpy
    tp = [T(x).to(dt) for x, dt in zip(p, tdt)]
    tg = [T(x).to(dt) for x, dt in zip(g, tdt)]
    vecs = ([T(x) for x in w], [T(x) for x in wm], [T(x) for x in taus],
            [torch.tensor(x) for x in hp])
    stats = ([T(x) for x in n], [T(x) for x in b], [T(x) for x in v])
    ops.reset_launches()
    got = ops.fused_event_apply(tp, tg, *stats, *vecs, lr=0.01, mode=mode)
    assert ops.LAUNCHES["fused_event_apply"] == 40
    assert ops.DEVICE_LAUNCHES == dict.fromkeys(ops.DEVICE_LAUNCHES, 0)
    for i in range(40):
        want = ref.fused_event_apply_ref(
            tp[i], tg[i], *(s[i] for s in stats), *(x[i] for x in vecs[:3]),
            0.01, vecs[3][i], mode=mode)
        for out, e in zip(got, want):
            assert out[i].dtype == e.dtype and torch.equal(out[i], e)
    J = lambda xs, dts=None: [jnp.asarray(x, jnp.dtype(dt)) if dts else
                              jnp.asarray(x) for x, dt in zip(xs, dts or xs)]
    want = jops.fused_event_apply(
        J(p, DTYPES), J(g, DTYPES), J(n), J(b), J(v), J(w), J(wm), J(taus),
        [jnp.asarray(x) for x in hp], lr=0.01, mode=mode, interpret=True)
    for j in range(4):
        for i, dt in enumerate(DTYPES):
            tol = BF16 if j == 0 and dt == "bfloat16" else dict(rtol=1e-4,
                                                                atol=1e-6)
            np.testing.assert_allclose(_f32(got[j][i]), _f32(want[j][i]),
                                       **tol)
