"""The port's protocol core against `repro.core.engine`.

Same server state, gradients, masks and timestamps (numpy) into both
packages; the gates get the uniforms `jax.random` draws for the same key.
The JAX package runs its Pallas kernels in interpret mode, the port its
plain versions on the CPU.  Tolerance fp32 rtol 1e-5 / atol 1e-6 (rtol 1e-4
for K-event sums, taken in another order by each framework, as
tests/test_one_kernel.py holds the reference); τ, T, masks and indices
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import rules as jrules

from repro_torch.core import engine, rules
from repro_torch.kernels import ops
from repro_torch.utils.convert import (params_from_numpy,
                                      server_state_from_numpy, to_numpy)
from repro_torch.utils.trees import leaves

TOL = dict(rtol=1e-5, atol=1e-6)
KSUM = dict(rtol=1e-4, atol=1e-6)
SIZES = (30, 12, 5)


def _tree(seed, scale=1.0, lead=()):
    rng = np.random.default_rng(seed)
    return [{"w": (scale * rng.standard_normal(lead + (i, o))).astype(
                np.float32),
             "b": (scale * rng.standard_normal(lead + (o,))).astype(
                np.float32)}
            for i, o in zip(SIZES[:-1], SIZES[1:])]


def _pair(rule="fasgd", kernel=False, T=9, **kw):
    jcfg = jrules.ServerConfig(rule=rule, lr=0.02, use_fused_kernel=kernel,
                               kernel_interpret=True if kernel else None,
                               **kw)
    cfg = rules.ServerConfig(rule=rule, lr=0.02, use_fused_kernel=kernel,
                             **kw)
    p = _tree(0)
    n = jax.tree.map(np.abs, _tree(1, 0.01))
    b, v = _tree(2, 0.05), jax.tree.map(lambda x: 1.0 + x, _tree(3, 0.1))
    J = lambda t: jax.tree.map(jnp.asarray, t)
    js = jrules.init(jcfg, J(p))._replace(n=J(n), b=J(b), v=J(v),
                                          timestamp=jnp.int32(T))
    return jcfg, cfg, js, server_state_from_numpy(p, T, n, b, v, device="cpu")


def _close_state(got, want, tol=TOL):
    for field in ("params", "n", "b", "v"):
        for a, e in zip(leaves(to_numpy(getattr(got, field))),
                        jax.tree.leaves(getattr(want, field))):
            np.testing.assert_allclose(a, np.asarray(e), err_msg=field, **tol)
    assert int(got.timestamp) == int(want.timestamp)


@pytest.mark.parametrize("c", [0.0, 0.05, 2.0])
@pytest.mark.parametrize("shape", [(), (16,)])
def test_transmit_gate_with_replayed_uniforms(c, shape):
    _, _, js, ts = _pair()
    key = jax.random.PRNGKey(5)
    want = jengine.transmit_gate(key, js, c, 1e-8, shape=shape)
    u = torch.from_numpy(np.array(jax.random.uniform(key, shape)))
    got = engine.transmit_gate(u, ts, c, 1e-8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if c == 0.0:
        assert bool(got.all())


@pytest.mark.parametrize("policy", ["cache", "skip"])
@pytest.mark.parametrize("push", [True, False])
@pytest.mark.parametrize("kernel", [False, True])
def test_apply_gated(policy, push, kernel):
    jcfg, cfg, js, ts = _pair(kernel=kernel)
    g, cache = _tree(7, 0.1), _tree(8, 0.1)
    jcached = jax.tree.map(jnp.asarray, cache) if policy == "cache" else None
    tcached = params_from_numpy(cache, device="cpu") if policy == "cache" else None
    jnew, jaux = jengine.apply_gated(
        jcfg, js, jax.tree.map(jnp.asarray, g), jnp.asarray(push),
        jnp.int32(4), cached_grad=jcached)
    ops.reset_launches()
    tnew, taux = engine.apply_gated(
        cfg, ts, params_from_numpy(g, device="cpu"), torch.tensor(push),
        torch.tensor(4, dtype=torch.int32), cached_grad=tcached)
    _close_state(tnew, jnew)
    assert float(taux["tau"]) == float(jaux["tau"]) == 5.0
    # the kernel runs whether or not the push went through
    assert ops.LAUNCHES["fasgd_update"] == (4 if kernel else 0)


@pytest.mark.parametrize("kernel", [False, True])
def test_serial_apply(kernel):
    jcfg, cfg, js, ts = _pair(kernel=kernel)
    K = 6
    grads = _tree(11, 0.1, lead=(K,))
    push = np.array([1, 0, 1, 1, 0, 1], bool)
    grad_ts = np.array([9, 3, 5, 9, 1, 0], np.int32)
    jnew, jtaus = jengine.serial_apply(jcfg, js, jax.tree.map(
        jnp.asarray, grads), jnp.asarray(push), jnp.asarray(grad_ts))
    tnew, ttaus = engine.serial_apply(cfg, ts, params_from_numpy(grads, device="cpu"),
                                      torch.from_numpy(push),
                                      torch.from_numpy(grad_ts))
    _close_state(tnew, jnew)
    np.testing.assert_array_equal(ttaus.numpy(), np.asarray(jtaus))


@pytest.mark.parametrize("rule,kernel", [
    ("fasgd", False), ("fasgd", True),      # generic scale_leaf / 'fasgd'
    ("sasgd", False), ("sasgd", True),      # 'coeff' einsum / 'coeff' kernel
    ("exp", True), ("asgd", False)])
@pytest.mark.parametrize("all_dropped", [False, True])
def test_fused_apply(rule, kernel, all_dropped):
    jcfg, cfg, js, ts = _pair(rule=rule, kernel=kernel)
    K = 8
    grads = _tree(13, 0.1, lead=(K,))
    push = (np.zeros(K, bool) if all_dropped
            else np.array([1, 1, 0, 1, 0, 1, 1, 1], bool))
    cts = np.array([9, 2, 2, 7, 0, 9, 4, 2], np.int32)
    jnew, jtaus = jengine.fused_apply(
        jcfg, js, jax.tree.map(jnp.asarray, grads), jnp.asarray(push),
        jnp.asarray(cts))
    ops.reset_launches()
    tnew, ttaus = engine.fused_apply(cfg, ts, params_from_numpy(grads, device="cpu"),
                                     torch.from_numpy(push),
                                     torch.from_numpy(cts))
    _close_state(tnew, jnew, KSUM)
    np.testing.assert_array_equal(ttaus.numpy(), np.asarray(jtaus))
    assert ops.LAUNCHES["fused_event_apply"] == (4 if kernel else 0)
    assert engine.fused_kernel_active(cfg) == kernel


BF16_THETA = dict(rtol=2 ** -7, atol=1e-6)   # one bf16 ulp


@pytest.mark.parametrize("rule", ["asgd", "sasgd", "exp", "poly", "fasgd"])
@pytest.mark.parametrize("kernel", [False, True])
def test_fused_apply_bf16_params(rule, kernel):
    """bf16 θ and gradients through `fused_apply` for every ported rule.

    Both packages contract the event axis in float32 (the reference by
    type promotion), so θ' comes back in the reference's dtype: float32
    with the kernel off, bf16 with it on; the statistics are float32 in
    both.  Statistics at the K-sum tolerance; θ' the same when float32 and
    within one bf16 ulp when bf16 (the kernel rounds the float32 result
    once in each package)."""
    jcfg, cfg, js, ts = _pair(rule=rule, kernel=kernel)
    bf = lambda tree: jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                   tree)
    js = js._replace(params=bf(js.params))
    ts = ts._replace(params=params_from_numpy(
        jax.tree.map(np.asarray, js.params), device="cpu"))
    K = 8
    grads = bf(_tree(13, 0.1, lead=(K,)))
    push = np.array([1, 1, 0, 1, 0, 1, 1, 1], bool)
    cts = np.array([9, 2, 2, 7, 0, 9, 4, 2], np.int32)
    jnew, jtaus = jengine.fused_apply(jcfg, js, grads, jnp.asarray(push),
                                      jnp.asarray(cts))
    tnew, ttaus = engine.fused_apply(
        cfg, ts, params_from_numpy(jax.tree.map(np.asarray, grads),
                                   device="cpu"),
        torch.from_numpy(push), torch.from_numpy(cts))
    want_dtype = jax.tree.leaves(jnew.params)[0].dtype
    assert want_dtype == (jnp.bfloat16 if kernel else jnp.float32)
    for a in leaves(tnew.params):
        assert a.dtype == (torch.bfloat16 if want_dtype == jnp.bfloat16
                           else torch.float32)
    for field in ("n", "b", "v"):
        for a, e in zip(leaves(getattr(tnew, field)),
                        jax.tree.leaves(getattr(jnew, field))):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(e),
                                       err_msg=field, **KSUM)
    tol = BF16_THETA if kernel else KSUM
    for a, e in zip(leaves(to_numpy(tnew.params)),
                    jax.tree.leaves(jnew.params)):
        np.testing.assert_allclose(a, np.asarray(e, np.float32), **tol)
    assert int(tnew.timestamp) == int(jnew.timestamp)
    np.testing.assert_array_equal(ttaus.numpy(), np.asarray(jtaus))


def test_dedup_events():
    ts = np.array([3, 1, 3, 0, 1, 3], np.int32)
    want = jengine.dedup_events(jnp.asarray(ts))
    got = engine.dedup_events(torch.from_numpy(ts))
    for a, e in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))


@pytest.mark.parametrize("seed", range(4))
def test_last_event_scatter_with_colliding_clients(seed):
    rng = np.random.default_rng(seed)
    K, lam = 12, 5
    clients = rng.integers(0, lam, K).astype(np.int32)   # many collisions
    eligible = rng.random(K) < 0.6
    fleet = _tree(20 + seed, lead=(lam,))
    values = _tree(40 + seed, lead=(K,))
    want_win = jengine.last_event_winners(jnp.asarray(clients),
                                          jnp.asarray(eligible))
    got_win = engine.last_event_winners(torch.from_numpy(clients).long(),
                                        torch.from_numpy(eligible))
    np.testing.assert_array_equal(got_win.numpy(), np.asarray(want_win))
    want = jengine.last_event_scatter(
        jax.tree.map(jnp.asarray, fleet), jnp.asarray(clients),
        jax.tree.map(jnp.asarray, values), jnp.asarray(eligible), lam)
    got = engine.last_event_scatter(
        params_from_numpy(fleet, device="cpu"), torch.from_numpy(clients).long(),
        params_from_numpy(values, device="cpu"), torch.from_numpy(eligible))
    for a, e in zip(leaves(to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(e))


def test_counters_accumulate_like_the_reference():
    push = np.array([1, 0, 1], bool)
    fetch = np.array([0, 0, 1], bool)
    jc = jengine.count_events(jengine.init_counters(), jnp.asarray(push),
                              jnp.asarray(fetch), push_bytes_sent=2.5e6,
                              push_bytes_total=7.5e6)
    jc = jengine.count_kernel(jc, 4, 3)
    tc = engine.count_events(engine.init_counters("cpu"), torch.from_numpy(push),
                             torch.from_numpy(fetch), push_bytes_sent=2.5e6,
                             push_bytes_total=7.5e6)
    tc = engine.count_kernel(tc, 4, 3)
    for k, v in tc._asdict().items():
        assert float(v) == float(getattr(jc, k)), k


@pytest.mark.parametrize("fn", ["apply_gated", "fused_apply"])
def test_per_tensor_masks_match_reference(fn):
    """Per-leaf push masks, which the port used to refuse, go through both
    entry points as they do in the reference ('skip': the dropped leaves
    keep their parameters and statistics).  The full matrix is in
    tests/test_torch_per_tensor.py."""
    jcfg, cfg, js, ts = _pair()
    bits = [True, False, False, True]
    if fn == "apply_gated":
        g = _tree(1, 0.1)
        mask = [{"b": bits[0], "w": bits[1]}, {"b": bits[2], "w": bits[3]}]
        jnew, _ = jengine.apply_gated(
            jcfg, js, jax.tree.map(jnp.asarray, g),
            jax.tree.map(jnp.asarray, mask), jnp.int32(4))
        tnew, _ = engine.apply_gated(
            cfg, ts, params_from_numpy(g, device="cpu"),
            jax.tree.map(torch.tensor, mask),
            torch.tensor(4, dtype=torch.int32))
        tol = TOL
    else:
        K = 4
        g = _tree(1, 0.1, lead=(K,))
        cols = np.array([[1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 0, 0],
                         [0, 1, 1, 1]], bool)          # leaf x event
        mask = [{"b": cols[0], "w": cols[1]}, {"b": cols[2], "w": cols[3]}]
        cts = np.array([9, 2, 5, 7], np.int32)
        jnew, _ = jengine.fused_apply(
            jcfg, js, jax.tree.map(jnp.asarray, g),
            jax.tree.map(jnp.asarray, mask), jnp.asarray(cts))
        tnew, _ = engine.fused_apply(
            cfg, ts, params_from_numpy(g, device="cpu"),
            jax.tree.map(torch.from_numpy, mask), torch.from_numpy(cts))
        tol = KSUM
    _close_state(tnew, jnew, tol)
    # leaf 1 (w0) never pushed: it keeps its parameters and statistics
    for field in ("params", "n", "v"):
        assert torch.equal(leaves(getattr(tnew, field))[1],
                           leaves(getattr(ts, field))[1])
