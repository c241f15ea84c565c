"""The port's server-update kernels on the CPU against the JAX reference.

On a CPU tensor `repro_torch.kernels.ops` takes each kernel's plain PyTorch
version (`kernels.ref`); here both are held against the Pallas kernels run
in interpret mode, as the JAX package's own kernel tests run them.  The
CUDA kernels themselves are held against the plain versions on the card by
`chip_smoke.py`.

Tolerances as tests/test_kernels_fasgd.py states them: fp32 rtol 1e-5 /
atol 1e-6; bf16 θ 2e-2.  The literal variant's v = β·v + (1−β)/√(max(n −
b², 0) + ε) is ill-conditioned where n ≈ b²: XLA's CPU code contracts
n − b·b into one fused multiply-add, PyTorch rounds b² first, and over the
156,800-element leaf that moves v by up to 2.9e-3 relative (the reference's
2e-3 was stated for its smaller leaves): rtol 5e-3 there.  The
K-event sums of `fused_event_apply` are taken in another order by the plain
version's einsum than by the kernel's in-order loop: rtol 1e-5 / atol 1e-6
all the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.kernels import ops, ref
from repro_torch.utils.trees import leaves

F32 = dict(rtol=1e-5, atol=1e-6)


def _np(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (0.1 * rng.standard_normal(shape)).astype(np.float32),
            np.abs(0.01 * rng.standard_normal(shape)).astype(np.float32),
            (0.05 * rng.standard_normal(shape)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("size", [7, 130, 200, 2000, 156_800])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["intent", "literal"])
def test_fasgd_update_matches_pallas(size, dtype, variant):
    p, g, n, b, v = _np((size,), seed=size)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jops.fasgd_update(
        {"x": jnp.asarray(p, jdt)}, {"x": jnp.asarray(g, jdt)},
        {"x": jnp.asarray(n)}, {"x": jnp.asarray(b)}, {"x": jnp.asarray(v)},
        0.01, 3.0, variant=variant, interpret=True)
    want = [w["x"] for w in want]
    args = (torch.from_numpy(p).to(tdt), torch.from_numpy(g).to(tdt),
            torch.from_numpy(n), torch.from_numpy(b), torch.from_numpy(v))
    tau = torch.tensor(3.0)
    for got in (ops.fasgd_update_leaf(*args, 0.01, tau, variant=variant),
                ref.fasgd_update_ref(*args, 0.01, 3.0, variant=variant)):
        assert got[0].dtype == tdt
        ptol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=1e-2)
        np.testing.assert_allclose(_f32(got[0]), _f32(want[0]), **ptol)
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-5,
                                   atol=1e-7)
        vtol = 1e-5 if variant == "intent" else 5e-3
        np.testing.assert_allclose(got[3].numpy(), want[3], rtol=vtol,
                                   atol=1e-6)
    # `pytest -s` shows the parity reached (recorded in PERF.md)
    print(f"\nPARITY fasgd_update/{size}/{dtype}/{variant} max|Δ| "
          f"θ={np.max(np.abs(_f32(got[0]) - _f32(want[0]))):.3e} "
          f"v={np.max(np.abs(got[3].numpy() - want[3])):.3e}")


def _window(K, shape, seed):
    rng = np.random.default_rng(seed)
    p, _, n, b, v = _np(shape, seed)
    g = (0.1 * rng.standard_normal((K,) + shape)).astype(np.float32)
    mask = (rng.random(K) < 0.7).astype(np.float32)
    mask[0] = 1.0
    taus = rng.integers(1, 40, K).astype(np.float32)
    return p, g, n, b, v, mask, mask / mask.sum(), taus


@pytest.mark.parametrize("K", [1, 5, 16])
@pytest.mark.parametrize("mode", ["coeff", "fasgd"])
@pytest.mark.parametrize("has_push", [0, 1])
@pytest.mark.parametrize("track_stats", [True, False])
def test_fused_event_apply_matches_pallas(K, mode, has_push, track_stats):
    p, g, n, b, v, w, wm, t = _window(K, (200, 10), seed=K)
    if mode == "coeff":
        w = w * 0.01 / t
    kw = dict(lr=0.01, gamma=0.9, beta=0.9, eps=1e-8, variant="intent",
              mode=mode, track_stats=track_stats)
    want = jops.fused_event_apply(
        {"x": jnp.asarray(p)}, {"x": jnp.asarray(g)}, {"x": jnp.asarray(n)},
        {"x": jnp.asarray(b)}, {"x": jnp.asarray(v)}, jnp.asarray(w),
        jnp.asarray(wm), jnp.asarray(t), jnp.asarray(bool(has_push)),
        interpret=True, **kw)
    want = [np.asarray(x["x"]) for x in want]
    T = torch.from_numpy
    hp = torch.tensor(bool(has_push))
    got = ops.fused_event_apply_leaf(T(p), T(g), T(n), T(b), T(v), T(w),
                                     T(wm), T(t), hp, **kw)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), e, **F32)
    print(f"\nPARITY fused_event_apply/K={K}/{mode}/{has_push}/{track_stats} "
          f"max|Δ| " + " ".join(f"{nm}={np.max(np.abs(a.numpy() - e)):.3e}"
                               for nm, a, e in zip("θnbv", got, want)))
    if not track_stats or not has_push:
        # statistics pass through (track_stats off) or hold (nothing pushed)
        for a, e in zip(got[1:], (n, b, v)):
            np.testing.assert_array_equal(a.numpy(), e)


def test_fused_event_apply_bf16_params():
    p, g, n, b, v, w, wm, t = _window(8, (130,), seed=3)
    kw = dict(lr=0.01, gamma=0.9, beta=0.9, eps=1e-8, mode="fasgd")
    want = jops.fused_event_apply(
        {"x": jnp.asarray(p, jnp.bfloat16)},
        {"x": jnp.asarray(g, jnp.bfloat16)}, {"x": jnp.asarray(n)},
        {"x": jnp.asarray(b)}, {"x": jnp.asarray(v)}, jnp.asarray(w),
        jnp.asarray(wm), jnp.asarray(t), jnp.asarray(True), interpret=True,
        **kw)
    T = torch.from_numpy
    got = ops.fused_event_apply(
        {"x": T(p).bfloat16()}, {"x": T(g).bfloat16()}, {"x": T(n)},
        {"x": T(b)}, {"x": T(v)}, T(w), T(wm), T(t), torch.tensor(True),
        **kw)
    assert got[0]["x"].dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got[0]["x"]), _f32(want[0]["x"]),
                               rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(got[3]["x"].numpy(), np.asarray(want[3]["x"]),
                               **F32)


# a small MLP-shaped tree: leaves b0 w0 b1 w1 in JAX order
TREE_SHAPES = [{"w": (20, 8), "b": (8,)}, {"w": (8, 3), "b": (3,)}]


def _tree_window(K, seed, dtype):
    """θ, g [K, ...] (in `dtype`), n, b, v over TREE_SHAPES as numpy, and
    per-leaf push masks as weights, wmean, τ and has_push (0 on leaf 1,
    w0), as lists in leaf order."""
    rng = np.random.default_rng(seed)
    shapes = [s for layer in TREE_SHAPES for s in (layer["b"], layer["w"])]
    p, g, n, b, v = ([] for _ in range(5))
    w, wm, t, hp = ([] for _ in range(4))
    for i, s in enumerate(shapes):
        pp, _, nn, bb, vv = _np(s, seed + i)
        p.append(pp)
        g.append((0.1 * rng.standard_normal((K,) + s)).astype(np.float32))
        n.append(nn), b.append(bb), v.append(vv)
        mask = (rng.random(K) < 0.7).astype(np.float32)
        mask[0] = 1.0
        w.append(mask * 0.01 / (1.0 + i))
        wm.append(mask / mask.sum())
        t.append(rng.integers(1, 40, K).astype(np.float32))
        hp.append(i != 1)
    return p, g, n, b, v, w, wm, t, hp


def _mlp_tree(xs):
    return [{"b": xs[0], "w": xs[1]}, {"b": xs[2], "w": xs[3]}]


@pytest.mark.parametrize("mode", ["coeff", "fasgd"])
@pytest.mark.parametrize("track_stats", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_event_apply_per_leaf_trees_match_pallas(mode, track_stats,
                                                       dtype):
    """Per-leaf weights/wmean/τ/has_push trees (has_push 0 on one leaf)
    through the tree entry, against the reference's tree entry in
    interpret mode on the same trees: fp32 rtol 1e-4 / atol 1e-6 (the
    K-sums' order differs, as tests/test_one_kernel.py allows the
    reference), bf16 θ' within one bf16 ulp."""
    K = 5
    p, g, n, b, v, w, wm, t, hp = _tree_window(K, 7, dtype)
    kw = dict(lr=0.01, gamma=0.9, beta=0.9, eps=1e-8, variant="intent",
              mode=mode, track_stats=track_stats)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    J = lambda xs, dt=None: _mlp_tree([jnp.asarray(x, dt) for x in xs])
    want = jops.fused_event_apply(
        J(p, jdt), J(g, jdt), J(n), J(b), J(v), J(w), J(wm), J(t),
        _mlp_tree([jnp.asarray(x) for x in hp]), interpret=True, **kw)
    T = lambda xs, dt=torch.float32: _mlp_tree(
        [torch.from_numpy(x).to(dt) for x in xs])
    ops.reset_launches()
    got = ops.fused_event_apply(
        T(p, tdt), T(g, tdt), T(n), T(b), T(v), T(w), T(wm), T(t),
        _mlp_tree([torch.tensor(x) for x in hp]), **kw)
    assert ops.LAUNCHES["fused_event_apply"] == 4
    for j, (a_tree, e_tree) in enumerate(zip(got, want)):
        for a, e in zip(leaves(a_tree), jax.tree.leaves(e_tree)):
            if j == 0 and dtype == "bfloat16":
                assert a.dtype == torch.bfloat16
                e32 = _f32(e)
                ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(e32),
                                                          1e-30))) - 7)
                assert np.all(np.abs(_f32(a) - e32) <= ulp), "θ' > 1 ulp"
            else:
                np.testing.assert_allclose(_f32(a), _f32(e), rtol=1e-4,
                                           atol=1e-6, err_msg="θnbv"[j])
    # leaf 1 pushed nothing: its statistics hold
    for j, x in zip((1, 2, 3), (n, b, v)):
        np.testing.assert_array_equal(leaves(got[j])[1].numpy(), x[1])


def test_fused_event_apply_shared_vectors_equal_per_leaf_copies():
    """Shared [K] vectors and has_push give what the same values copied
    into per-leaf trees give, to the bit."""
    K = 4
    p, g, n, b, v, w, wm, t, _ = _tree_window(K, 11, "float32")
    T = lambda xs: _mlp_tree([torch.from_numpy(x) for x in xs])
    hp = torch.tensor(True)
    for mode in ("coeff", "fasgd"):
        shared = ops.fused_event_apply(
            T(p), T(g), T(n), T(b), T(v), torch.from_numpy(w[0]),
            torch.from_numpy(wm[0]), torch.from_numpy(t[0]), hp, lr=0.01,
            mode=mode)
        copies = ops.fused_event_apply(
            T(p), T(g), T(n), T(b), T(v), T([w[0]] * 4), T([wm[0]] * 4),
            T([t[0]] * 4), _mlp_tree([hp] * 4), lr=0.01, mode=mode)
        for a_tree, e_tree in zip(shared, copies):
            for a, e in zip(leaves(a_tree), leaves(e_tree)):
                assert torch.equal(a, e)


def test_tree_wrappers_follow_jax_leaf_order_and_count_launches():
    """Leaves go in JAX order (dict keys sorted), one dispatch each."""
    shapes = {"w": (20, 8), "b": (8,)}
    mk = lambda s: {k: torch.from_numpy(_np(v, s)[0]) for k, v in
                    shapes.items()}
    params = [mk(0), mk(1)]
    ops.reset_launches()
    out = ops.fasgd_update(params, params, params, params, params, 0.01,
                           torch.tensor(2.0))
    assert ops.LAUNCHES == {"fasgd_update": 4, "fused_event_apply": 0,
                            "batched_scale_apply": 0, "flash_attention": 0}
    assert list(out[0][0]) == ["b", "w"]
    grads = [{k: x[None].expand((3,) + x.shape) for k, x in l.items()}
             for l in params]
    w = torch.ones(3)
    ops.fused_event_apply(params, grads, params, params, params, w, w / 3,
                          w, torch.tensor(True), lr=0.01)
    assert ops.LAUNCHES == {"fasgd_update": 4, "fused_event_apply": 4,
                            "batched_scale_apply": 0, "flash_attention": 0}
    out = ops.batched_scale_apply(params, grads, params, w, w, lr=0.01)
    assert ops.LAUNCHES == {"fasgd_update": 4, "fused_event_apply": 4,
                            "batched_scale_apply": 4, "flash_attention": 0}
    assert list(out[0]) == ["b", "w"]


def test_other_devices_raise():
    """A CPU tensor takes the plain version, a CUDA tensor the kernel; any
    other device has neither and raises."""
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.fasgd_update_leaf(x, x, x, x, x, 0.01, 1.0)
    with pytest.raises(ValueError, match="device"):
        ops.fused_event_apply_leaf(x, x[None], x, x, x, x[:1], x[:1], x[:1],
                                   x[0], lr=0.01)
    with pytest.raises(ValueError, match="device"):
        ops.batched_scale_apply_leaf(x, x[None], x, x[:1], x[:1], lr=0.01)


def test_build_flags_target_hopper():
    """The kernels build for sm_90a only; the server updates without FMA
    contraction, flash attention (bound by its operations) with it."""
    from repro_torch.kernels import build
    for name in build.SOURCES:
        flags = " ".join(build._flags(name))
        assert "arch=compute_90a,code=sm_90a" in flags
        assert ("-fmad=false" in flags) == (name != "flash_attention")
        assert (build.CSRC / f"{name}.cu").exists()
        assert name in build.SIGNATURES
    assert set(build.SOURCES) == {"fasgd_update", "fused_event_apply",
                                  "batched_update", "flash_attention"}
