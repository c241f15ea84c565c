"""Per-tensor gating and staleness (the paper's §5) in the port, against a
live run of `repro.core` / `repro.sim.fred`.

The same numpy state, gradients, masks and timestamps go into both
packages; the gates get the uniforms `jax.random` draws for the same keys
(one per leaf, from the event's key split per leaf, as
`repro.core.bandwidth.per_tensor_transmit_mask` draws them).  The JAX
package runs its Pallas kernels in interpret mode, the port their plain
versions on the CPU.

Tolerances, as in tests/test_torch_engine.py and tests/test_torch_fred.py:
one update fp32 rtol 1e-5 / atol 1e-6, K-event sums rtol 1e-4 / atol 1e-6;
FRED runs rtol 1e-4 / atol 1e-5 on floats, and τ, masks, counters, T,
`client_ts` and `client_leaf_ts` exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bandwidth as jbandwidth
from repro.core import engine as jengine
from repro.core import rules as jrules

from repro_torch.core import bandwidth, engine, rules
from repro_torch.core.bandwidth import BandwidthConfig
from repro_torch.core.rules import ServerConfig
from repro_torch.kernels import ops
from repro_torch.models.mlp import nll_loss
from repro_torch.sim.fred import SimConfig, native_draws, run_simulation
from repro_torch.utils.convert import params_from_numpy, to_numpy
from repro_torch.utils.trees import leaves

from test_torch_engine import KSUM, TOL, _close_state, _pair, _tree
from test_torch_fred import (check_against_reference, one_thread,  # noqa: F401
                             setup)

N_LEAVES = 4


def _leaf_uniforms(key):
    """The per-leaf uniforms the reference's per-tensor gate draws from
    `key` (one key, or [K] keys)."""
    one = lambda k: jax.vmap(jax.random.uniform)(
        jax.random.split(k, N_LEAVES))
    u = one(key) if key.ndim == 1 else jax.vmap(one)(key)
    return torch.from_numpy(np.array(u))


def _v_tree(seed):
    """A v tree whose leaves' v̄ differ by orders of magnitude."""
    v = _tree(seed, 0.1)
    scales = (10.0, 1e-3, 1.0, 1e-1)
    return [{k: (np.abs(l) * s + s).astype(np.float32)
             for (k, l), s in zip(sorted(layer.items()), pair)}
            for layer, pair in zip(v, (scales[:2], scales[2:]))]


@pytest.mark.parametrize("c", [0.0, 0.05, 2.0])
@pytest.mark.parametrize("events", [None, 64])
def test_per_tensor_transmit_mask_matches_reference(c, events):
    """Masks, sent bytes and total bytes, for one event and vmapped over
    64 events (bytes through `masked_bytes`, as the fused path counts
    them)."""
    v = _v_tree(0)
    jv = jax.tree.map(jnp.asarray, v)
    tv = params_from_numpy(v, device="cpu")
    key = jax.random.PRNGKey(3)
    if events is None:
        jmask, jsent, jtotal = jbandwidth.per_tensor_transmit_mask(
            key, jv, c)
        mask, sent, total = bandwidth.per_tensor_transmit_mask(
            _leaf_uniforms(key), tv, c)
        assert float(sent) == float(jsent) and total == jtotal
    else:
        keys = jax.random.split(key, events)
        jmask = jax.vmap(
            lambda k: jbandwidth.per_tensor_transmit_mask(k, jv, c)[0])(keys)
        mask, _, total = bandwidth.per_tensor_transmit_mask(
            _leaf_uniforms(keys), tv, c)
        assert float(bandwidth.masked_bytes(mask, tv)) == float(
            jbandwidth.masked_bytes(jmask, jv))
    for a, e in zip(leaves(mask), jax.tree.leaves(jmask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))
    if c == 0.0:
        assert all(bool(m.all()) for m in leaves(mask))


def test_per_tensor_mask_direction():
    """A tensor with a large v̄ transmits nearly always, one with a tiny v̄
    nearly never (eq. 9 per tensor)."""
    v = {"hot": torch.full((4,), 10.0), "cold": torch.full((4,), 1e-4)}
    u = torch.rand((512, 2), generator=torch.Generator().manual_seed(0))
    mask, sent, total = bandwidth.per_tensor_fetch_mask(u, v, 0.05)
    assert int(mask["hot"].sum()) > 500 and int(mask["cold"].sum()) < 5
    assert total == 32.0
    assert float(sent.sum()) == 16.0 * float(mask["hot"].sum()
                                             + mask["cold"].sum())


def _leafwise(values, dtype):
    """The MLP-shaped tree (b0, w0, b1, w1) of `values`, one per leaf."""
    v = [np.asarray(x, dtype) for x in values]
    return [{"b": v[0], "w": v[1]}, {"b": v[2], "w": v[3]}]


@pytest.mark.parametrize("rule,kernel", [
    ("fasgd", False), ("fasgd", True), ("sasgd", False), ("exp", False),
    ("poly", False), ("asgd", True)])
def test_per_leaf_tau_in_apply_update(rule, kernel):
    """Per-tensor timestamps: each leaf's τ from its own timestamp; aux's τ
    is their mean; the single-push kernel stays off (it takes a scalar
    τ), as in the reference."""
    jcfg, cfg, js, ts = _pair(rule=rule, kernel=kernel)
    g = _tree(5, 0.1)
    grad_ts = _leafwise([8, 0, 3, 9], np.int32)
    jnew, jaux = jrules.apply_update(jcfg, js, jax.tree.map(jnp.asarray, g),
                                     jax.tree.map(jnp.asarray, grad_ts))
    ops.reset_launches()
    tnew, taux = rules.apply_update(cfg, ts, params_from_numpy(g, device="cpu"),
                                    params_from_numpy(grad_ts, device="cpu"))
    _close_state(tnew, jnew)
    assert float(taux["tau"]) == float(jaux["tau"]) == (1 + 9 + 6 + 1) / 4
    np.testing.assert_allclose(float(taux["mean_scale"]),
                               float(jaux["mean_scale"]), **TOL)
    assert ops.LAUNCHES["fasgd_update"] == 0


def test_per_leaf_tau_equal_to_scalar_when_uniform():
    _, cfg, _, ts = _pair()
    g = params_from_numpy(_tree(5, 0.1), device="cpu")
    one, _ = rules.apply_update(cfg, ts, g, torch.tensor(3, dtype=torch.int32))
    tree, _ = rules.apply_update(
        cfg, ts, g, params_from_numpy(_leafwise([3] * 4, np.int32),
                                      device="cpu"))
    for a, b in zip(leaves(one), leaves(tree)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["cache", "skip"])
@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("per_leaf_ts", [False, True])
def test_apply_gated_per_leaf(policy, kernel, per_leaf_ts):
    """Per-leaf push under 'cache' (dropped leaves re-apply the cached
    leaf) and 'skip' (dropped leaves keep parameters and statistics, T
    advances as one leaf pushed); the kernel runs where τ is a scalar."""
    jcfg, cfg, js, ts = _pair(kernel=kernel)
    g, cache = _tree(7, 0.1), _tree(8, 0.1)
    push = _leafwise([True, False, False, True], bool)
    grad_ts = (_leafwise([4, 1, 8, 0], np.int32) if per_leaf_ts
               else np.int32(4))
    cached = policy == "cache"
    J = lambda t: jax.tree.map(jnp.asarray, t)
    P = lambda t: params_from_numpy(t, device="cpu")
    jnew, jaux = jengine.apply_gated(
        jcfg, js, J(g), J(push), J(grad_ts),
        cached_grad=J(cache) if cached else None)
    ops.reset_launches()
    tnew, taux = engine.apply_gated(
        cfg, ts, P(g), P(push), P(grad_ts),
        cached_grad=P(cache) if cached else None)
    _close_state(tnew, jnew)
    assert float(taux["tau"]) == float(jaux["tau"])
    assert ops.LAUNCHES["fasgd_update"] == (4 if kernel and not per_leaf_ts
                                            else 0)
    if not cached:
        none = P(_leafwise([False] * 4, bool))
        same, _ = engine.apply_gated(cfg, ts, P(g), none, P(grad_ts))
        assert int(same.timestamp) == int(ts.timestamp)
        for a, b in zip(leaves(same.params), leaves(ts.params)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", [False, True])
def test_serial_apply_per_leaf(kernel):
    jcfg, cfg, js, ts = _pair(kernel=kernel)
    K = 6
    grads = _tree(11, 0.1, lead=(K,))
    rng = np.random.default_rng(0)
    push = _leafwise(rng.random((N_LEAVES, K)) < 0.6, bool)
    grad_ts = _leafwise(rng.integers(0, 10, (N_LEAVES, K)), np.int32)
    J = lambda t: jax.tree.map(jnp.asarray, t)
    P = lambda t: params_from_numpy(t, device="cpu")
    jnew, jtaus = jengine.serial_apply(jcfg, js, J(grads), J(push),
                                       J(grad_ts))
    tnew, ttaus = engine.serial_apply(cfg, ts, P(grads), P(push), P(grad_ts))
    _close_state(tnew, jnew)
    np.testing.assert_allclose(ttaus.numpy(), np.asarray(jtaus), **TOL)


@pytest.mark.parametrize("rule,kernel", [
    ("fasgd", False), ("fasgd", True),      # generic scale_leaf / 'fasgd'
    ("sasgd", False), ("sasgd", True),      # 'coeff' einsum / 'coeff' kernel
    ("poly", True)])
@pytest.mark.parametrize("per_push,per_ts", [
    (True, False), (False, True), (True, True)])
def test_fused_apply_per_leaf(rule, kernel, per_push, per_ts):
    """Per-leaf push masks and/or per-leaf τ through `fused_apply`: T
    advances by the events that pushed any leaf, a leaf no event pushed
    keeps its statistics, and on the kernel path each leaf's own
    w/wmean/τ/has_push reach `ops.fused_event_apply` (one tree call)."""
    jcfg, cfg, js, ts = _pair(rule=rule, kernel=kernel)
    K = 8
    grads = _tree(13, 0.1, lead=(K,))
    rng = np.random.default_rng(1)
    bits = rng.random((N_LEAVES, K)) < 0.5
    bits[2] = False                      # b1: no event pushes it
    push = (_leafwise(bits, bool) if per_push
            else np.array([1, 1, 0, 1, 0, 1, 1, 1], bool))
    cts = (_leafwise(rng.integers(0, 10, (N_LEAVES, K)), np.int32) if per_ts
           else np.array([9, 2, 2, 7, 0, 9, 4, 2], np.int32))
    J = lambda t: jax.tree.map(jnp.asarray, t)
    P = lambda t: params_from_numpy(t, device="cpu")
    jnew, jtaus = jengine.fused_apply(jcfg, js, J(grads), J(push), J(cts))
    ops.reset_launches()
    tnew, ttaus = engine.fused_apply(cfg, ts, P(grads), P(push), P(cts))
    _close_state(tnew, jnew, KSUM)
    np.testing.assert_allclose(ttaus.numpy(), np.asarray(jtaus), **TOL)
    assert ops.LAUNCHES["fused_event_apply"] == (4 if kernel else 0)
    if per_push:
        for field in ("n", "b", "v"):
            assert torch.equal(leaves(getattr(tnew, field))[2],
                               leaves(getattr(ts, field))[2])


@pytest.mark.parametrize("seed", range(3))
def test_last_event_scatter_per_leaf_eligible(seed):
    """Each leaf of the fleet advances only where that leaf is eligible,
    the last eligible event winning."""
    rng = np.random.default_rng(seed)
    K, lam = 12, 5
    clients = rng.integers(0, lam, K).astype(np.int32)
    eligible = _leafwise(rng.random((N_LEAVES, K)) < 0.5, bool)
    fleet = _tree(20 + seed, lead=(lam,))
    values = _tree(40 + seed, lead=(K,))
    J = lambda t: jax.tree.map(jnp.asarray, t)
    want = jengine.last_event_scatter(J(fleet), jnp.asarray(clients),
                                      J(values), J(eligible), lam)
    got = engine.last_event_scatter(
        params_from_numpy(fleet, device="cpu"),
        torch.from_numpy(clients).long(), params_from_numpy(values,
                                                            device="cpu"),
        params_from_numpy(eligible, device="cpu"))
    for a, e in zip(leaves(to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(e))


SERIAL = dict(num_clients=4, batch_size=8, seed=7)
FUSED = dict(num_clients=16, batch_size=8, seed=3, events_per_step=8,
             apply_mode="fused")
PT_BOTH = dict(c_push=0.5, c_fetch=0.5, per_tensor_push=True,
               per_tensor_fetch=True)
CASES = {
    "serial_fetch_kernel": dict(
        sim=SERIAL, server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True),
        bandwidth=dict(c_fetch=0.5, per_tensor_fetch=True)),
    "serial_push_cache_kernel": dict(
        sim=SERIAL, server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True),
        bandwidth=dict(c_push=0.5, per_tensor_push=True,
                       drop_policy="cache")),
    "serial_push_skip_kernel": dict(
        sim=SERIAL, server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True),
        bandwidth=dict(c_push=0.5, per_tensor_push=True, drop_policy="skip")),
    "serial_push_fetch_plain": dict(
        sim=dict(SERIAL, seed=11), server=dict(rule="fasgd", lr=0.01),
        bandwidth=dict(PT_BOTH, drop_policy="cache")),
    "fused_push_fetch_cache_kernel": dict(
        sim=FUSED, server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True),
        bandwidth=dict(PT_BOTH, drop_policy="cache")),
    "fused_push_fetch_cache_plain": dict(
        sim=FUSED, server=dict(rule="fasgd", lr=0.01),
        bandwidth=dict(PT_BOTH, drop_policy="cache")),
    "fused_push_fetch_skip_kernel": dict(
        sim=FUSED, server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True),
        bandwidth=dict(PT_BOTH, drop_policy="skip")),
    "fused_push_fetch_skip_plain": dict(
        sim=FUSED, server=dict(rule="fasgd", lr=0.01),
        bandwidth=dict(PT_BOTH, drop_policy="skip")),
    # fused_mode='auto' with a v-independent rule under per-tensor gating
    # resolves to the materialized path in both packages
    "fused_sasgd_auto_skip_kernel": dict(
        sim=FUSED, server=dict(rule="sasgd", lr=0.05, use_fused_kernel=True),
        bandwidth=dict(PT_BOTH, drop_policy="skip")),
    "fused_sasgd_auto_fetch_plain": dict(
        sim=dict(FUSED, dispatcher="roundrobin"),
        server=dict(rule="sasgd", lr=0.05),
        bandwidth=dict(c_fetch=0.5, per_tensor_fetch=True)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_per_tensor_run_simulation_matches_reference(setup, name):  # noqa: F811
    out = check_against_reference(setup, name, CASES[name])
    c = out["counters"]
    bw = CASES[name]["bandwidth"]
    if bw.get("per_tensor_push"):
        assert 0 < c["push_bytes_sent"] < c["push_bytes_total"]
    if bw.get("per_tensor_fetch"):
        assert 0 < c["fetch_bytes_sent"] < c["fetch_bytes_total"]
        ts = out["state"].client_leaf_ts
        assert ts.shape == (CASES[name]["sim"]["num_clients"], N_LEAVES)
        # the tensors of one copy desynchronize (the point of §5)
        assert bool((ts.max(dim=1).values != ts.min(dim=1).values).any())


def _port_run(setup, cfg, steps=48, **kw):  # noqa: F811
    params, ds = setup
    return run_simulation(
        cfg, nll_loss, params_from_numpy(params, device="cpu"),
        ds["x_train"], ds["y_train"], steps, eval_every=steps,
        collect_step_metrics=True, device="cpu", **kw)


@pytest.mark.parametrize("policy", ["cache", "skip"])
def test_fused_k1_equals_serial_per_tensor(setup, policy):  # noqa: F811
    """Per-event per-leaf draws: the fused path at K=1 is the serial path
    (the port's own draws, both apply modes)."""
    bw = BandwidthConfig(drop_policy=policy, **PT_BOTH)
    base = dict(num_clients=4, batch_size=8, seed=5, bandwidth=bw,
                server=ServerConfig(rule="fasgd", lr=0.01))
    serial = _port_run(setup, SimConfig(**base))
    fused = _port_run(setup, SimConfig(apply_mode="fused", **base))
    assert serial["counters"] == fused["counters"]
    assert serial["final_timestamp"] == fused["final_timestamp"]
    assert torch.equal(serial["tau"], fused["tau"])
    for f in ("client_ts", "client_leaf_ts"):
        assert torch.equal(getattr(serial["state"], f),
                           getattr(fused["state"], f))
    for a, b in zip(leaves(serial["state"].server.params),
                    leaves(fused["state"].server.params)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_per_tensor_gating_off_is_rng_invariant(setup):  # noqa: F811
    """c = 0 transmits every tensor: the same clients and minibatches, and
    the same trajectory bit for bit as the ungated run."""
    params, ds = setup
    base = dict(num_clients=4, batch_size=8, seed=9,
                server=ServerConfig(rule="fasgd", lr=0.01))
    plain_cfg = SimConfig(**base)
    pt_cfg = SimConfig(bandwidth=BandwidthConfig(
        per_tensor_push=True, per_tensor_fetch=True), **base)
    n = ds["x_train"].shape[0]
    d0 = native_draws(plain_cfg, n, N_LEAVES).events(0, 48, "cpu")
    d1 = native_draws(pt_cfg, n, N_LEAVES).events(0, 48, "cpu")
    assert torch.equal(d0.clients, d1.clients) and torch.equal(d0.idx, d1.idx)
    assert d1.push_u.shape == d1.fetch_u.shape == (48, N_LEAVES)
    # one direction per tensor: the other keeps the whole-copy uniforms
    for flag, same in (("per_tensor_fetch", "push_u"),
                       ("per_tensor_push", "fetch_u")):
        one = native_draws(SimConfig(bandwidth=BandwidthConfig(
            **{flag: True}), **base), n, N_LEAVES).events(0, 48, "cpu")
        assert torch.equal(getattr(one, same), getattr(d0, same))
        assert torch.equal(one.clients, d0.clients)
    plain = _port_run(setup, plain_cfg)
    pt = _port_run(setup, pt_cfg)
    assert plain["final_timestamp"] == pt["final_timestamp"] == 48
    assert torch.equal(plain["train_loss"], pt["train_loss"])
    for a, b in zip(leaves(plain["state"].server.params),
                    leaves(pt["state"].server.params)):
        assert torch.equal(a, b)
    for k in ("push_actual", "fetch_actual", "push_bytes_sent",
              "fetch_bytes_sent"):
        assert plain["counters"][k] == pt["counters"][k], k
