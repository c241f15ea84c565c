"""The port's `batched_scale_apply` on the CPU against the JAX reference.

On a CPU tensor `repro_torch.kernels.ops.batched_scale_apply` takes the
plain PyTorch version (`kernels.ref.batched_scale_apply_ref`).  Here it is
held against the Pallas kernel `batched_scale_apply_2d` and the JAX tree
entry point `repro.kernels.ops.batched_scale_apply`, both run in interpret
mode, as the JAX package's own tests run them, and against the port's other
K-event kernel, `fused_event_apply` with its statistics off.  The CUDA
kernel itself is held against the plain version on the card by
`chip_smoke.py` (phase 11).

Tolerances as tests/test_torch_kernels.py states them: fp32 rtol 1e-5 /
atol 1e-6 (XLA's CPU code contracts some products into fused
multiply-adds, PyTorch does not: up to 6e-8 apart at these sizes); bf16
rtol 2e-2 / atol 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.batched_update import batched_scale_apply_2d
from repro.models.mlp import init_mlp as jax_init_mlp

from repro_torch.kernels import ops, ref
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import leaves, tree_map

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=1e-2)
LR = 0.01


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _events(K, rng):
    """coeffs, taus and a push mask ([K], float32) with event 0 pushed."""
    coeffs = (0.5 + rng.random(K)).astype(np.float32)
    taus = rng.integers(1, 40, K).astype(np.float32)
    mask = (rng.random(K) < 0.7).astype(np.float32)
    mask[0] = 1.0
    return coeffs, taus, mask


@pytest.mark.parametrize("K", [1, 8, 33])
@pytest.mark.parametrize("mode", ["coeff", "fasgd"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_pallas_2d(K, mode, masked, dtype):
    """The plain version against the interpreted Pallas kernel on (R, 128)
    tiles (two grid steps of 8 rows)."""
    rng = np.random.default_rng(K)
    p = rng.standard_normal((16, 128)).astype(np.float32)
    g = (0.1 * rng.standard_normal((K, 16, 128))).astype(np.float32)
    v = (1.0 + 0.1 * rng.standard_normal((16, 128))).astype(np.float32)
    coeffs, taus, mask = _events(K, rng)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = batched_scale_apply_2d(
        jnp.asarray(p, jdt), jnp.asarray(g, jdt), jnp.asarray(v),
        jnp.asarray(coeffs), jnp.asarray(taus), LR,
        masks=jnp.asarray(mask) if masked else None, mode=mode,
        block_rows=8, interpret=True)
    T = torch.from_numpy
    args = (T(p).to(tdt), T(g).to(tdt), T(v), T(coeffs), T(taus))
    tmask = T(mask) if masked else None
    for got in (ref.batched_scale_apply_ref(*args, LR, masks=tmask, mode=mode),
                ops.batched_scale_apply_leaf(*args, masks=tmask, lr=LR,
                                             mode=mode)):
        assert got.dtype == tdt and got.shape == (16, 128)
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   **(F32 if dtype == "float32" else BF16))
    print(f"\nPARITY batched_scale_apply_2d/K={K}/{mode}/mask={masked}/"
          f"{dtype} max|Δ| {np.max(np.abs(_f32(got) - _f32(want))):.3e}")


@pytest.fixture(scope="module")
def mlp():
    """The 784-200-10 MLP from the JAX package's init, its K=8 window
    (gradients, v, per-event vectors, per-leaf masks and τ) as numpy."""
    params = jax.tree.map(np.asarray, jax_init_mlp(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    K = 8
    grads = jax.tree.map(lambda a: (0.1 * rng.standard_normal(
        (K,) + a.shape)).astype(np.float32), params)
    v = jax.tree.map(lambda a: (1.0 + 0.1 * rng.standard_normal(
        a.shape)).astype(np.float32), params)
    coeffs, taus, mask = _events(K, rng)
    leaf_events = jax.tree.map(lambda _: _events(K, rng), params)
    per_leaf = [jax.tree.map(lambda e, i=i: e[i], leaf_events,
                             is_leaf=lambda x: isinstance(x, tuple))
                for i in range(3)]
    return dict(params=params, grads=grads, v=v, coeffs=coeffs, taus=taus,
                mask=mask, leaf_coeffs=per_leaf[0], leaf_taus=per_leaf[1],
                leaf_masks=per_leaf[2])


# (name, mode, coeffs, taus, masks, dtype): which of the window's vectors
# are shared ([K]) and which are per leaf (trees of [K])
TREE_CASES = [
    ("shared fasgd", "fasgd", "coeffs", "taus", "mask", "float32"),
    ("shared coeff", "coeff", "coeffs", "taus", "mask", "float32"),
    ("per-leaf masks and taus", "fasgd", "coeffs", "leaf_taus", "leaf_masks",
     "float32"),
    ("per-leaf everything, coeff", "coeff", "leaf_coeffs", "leaf_taus",
     "leaf_masks", "float32"),
    ("no mask", "fasgd", "coeffs", "taus", None, "float32"),
    ("bf16, per-leaf masks", "fasgd", "coeffs", "taus", "leaf_masks",
     "bfloat16"),
]


@pytest.mark.parametrize("case", TREE_CASES, ids=[c[0] for c in TREE_CASES])
def test_tree_entry_point_matches_jax(mlp, case):
    """`ops.batched_scale_apply` over the 784-200-10 tree (leaves of 200,
    156,800, 10 and 2,000 elements) against the JAX entry point, which pads
    each leaf to (R, 128) tiles."""
    name, mode, c, t, m, dtype = case
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx = lambda x, dt=jnp.float32: jax.tree.map(lambda a: jnp.asarray(a, dt),
                                                x)
    want = jops.batched_scale_apply(
        jx(mlp["params"], jdt), jx(mlp["grads"], jdt), jx(mlp["v"]),
        jx(mlp[c]), jx(mlp[t]), masks=None if m is None else jx(mlp[m]),
        lr=LR, mode=mode, interpret=True)
    tx = lambda x: params_from_numpy(x, device="cpu")
    got = ops.batched_scale_apply(
        tree_map(lambda a: a.to(tdt), tx(mlp["params"])),
        tree_map(lambda a: a.to(tdt), tx(mlp["grads"])), tx(mlp["v"]),
        tx(mlp[c]), tx(mlp[t]), masks=None if m is None else tx(mlp[m]),
        lr=LR, mode=mode)
    assert list(got[0]) == ["b", "w"]
    errs = []
    for a, e in zip(leaves(got), jax.tree.leaves(want)):
        assert a.dtype == tdt and tuple(a.shape) == e.shape
        np.testing.assert_allclose(_f32(a), _f32(e),
                                   **(F32 if dtype == "float32" else BF16))
        errs.append(np.max(np.abs(_f32(a) - _f32(e))))
    print(f"\nPARITY batched_scale_apply tree/{name} max|Δ| per leaf "
          + " ".join(f"{x:.3e}" for x in errs))


def _torch_window(mlp):
    tx = lambda x: params_from_numpy(x, device="cpu")
    return {k: tx(x) for k, x in mlp.items()}


@pytest.mark.parametrize("mode", ["coeff", "fasgd"])
def test_no_mask_equals_all_ones_mask(mlp, mode):
    w = _torch_window(mlp)
    args = (w["params"], w["grads"], w["v"], w["coeffs"], w["taus"])
    plain = ops.batched_scale_apply(*args, lr=LR, mode=mode)
    ones = ops.batched_scale_apply(*args, masks=torch.ones(8), lr=LR,
                                   mode=mode)
    for a, b in zip(leaves(plain), leaves(ones)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["coeff", "fasgd"])
@pytest.mark.parametrize("per_leaf", [False, True])
def test_equals_fused_event_apply_without_stats(mlp, mode, per_leaf):
    """The oracle-free identity: Σ_k m_k·c_k·scale_k·g_k is what
    `fused_event_apply` applies with its statistics off and weights m·c.
    The two plain versions sum the 'coeff' delta in another order (einsum)
    and `fused_event_apply_ref` divides lr as a Python float (a reciprocal
    times lr): fp32 rtol 1e-5 / atol 1e-6."""
    w = _torch_window(mlp)
    c = "leaf_coeffs" if per_leaf else "coeffs"
    t = "leaf_taus" if per_leaf else "taus"
    m = "leaf_masks" if per_leaf else "mask"
    got = ops.batched_scale_apply(w["params"], w["grads"], w["v"], w[c],
                                  w[t], masks=w[m], lr=LR, mode=mode)
    per = lambda x: leaves(x) if per_leaf else [x] * 4
    zero = torch.tensor(0.0)
    for a, p, g, v, cc, tt, mm in zip(
            leaves(got), leaves(w["params"]), leaves(w["grads"]),
            leaves(w["v"]), per(w[c]), per(w[t]), per(w[m])):
        want = ops.fused_event_apply_leaf(
            p, g, v, v, v, mm * cc, mm * cc, tt, zero, lr=LR, mode=mode,
            track_stats=False)[0]
        np.testing.assert_allclose(a.numpy(), want.numpy(), **F32)


def test_per_leaf_vectors_follow_jax_leaf_order(mlp):
    """A per-leaf mask tree lines up with the params by key, not by dict
    insertion order: masking out w0 alone leaves w0, and only w0, as it
    was."""
    w = _torch_window(mlp)
    masks = [{"w": torch.zeros(8), "b": torch.ones(8)},
             {"b": torch.ones(8), "w": torch.ones(8)}]
    got = ops.batched_scale_apply(w["params"], w["grads"], w["v"],
                                  w["coeffs"], w["taus"], masks=masks, lr=LR)
    assert torch.equal(got[0]["w"], w["params"][0]["w"])
    for a, b in ((got[0]["b"], w["params"][0]["b"]),
                 (got[1]["w"], w["params"][1]["w"]),
                 (got[1]["b"], w["params"][1]["b"])):
        assert not torch.equal(a, b)


@pytest.mark.parametrize("K", [0, ops.MAX_BATCHED_EVENTS + 1])
def test_kernel_rejects_event_counts_it_cannot_stage(K):
    """The CUDA path raises before it builds or launches for K outside
    [1, MAX_BATCHED_EVENTS] (meta tensors stand in for the card's)."""
    x = torch.zeros(4, device="meta")
    g = torch.zeros((K, 4), device="meta")
    e = torch.zeros(K, device="meta")
    with pytest.raises(ValueError, match="events"):
        ops._batched_scale_apply_cuda(x, g, x, e, e, None, LR, 1e-8, "fasgd")


def test_unknown_mode_raises():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="mode"):
        ops.batched_scale_apply_leaf(x, x[None], x, x[:1], x[:1], lr=LR,
                                     mode="adam")
    with pytest.raises(ValueError, match="mode"):
        ref.batched_scale_apply_ref(x, x[None], x, x[:1], x[:1], LR,
                                    mode="adam")
