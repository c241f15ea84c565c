"""Gap-Aware, synchronous SGD and K-async in the port, against a live run
of `repro.core.rules` / `repro.sim.fred`.

Each rule's update starts both packages from one mid-run state with the
rule's `extra` (gap's ĝ EMA, the barrier rules' pending sum, count and
cursor), carried across with `server_state_from_numpy`; the FRED runs
replay the reference's draws.  Tolerances as in tests/test_torch_rules.py
(one update: fp32 rtol 1e-5 / atol 1e-6) and tests/test_torch_fred.py (runs:
rtol 1e-4 / atol 1e-5); T, counts, cursors, τ, counters, `client_ts` and
`client_leaf_ts` exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import rules as jrules
from repro.core import staleness as jstaleness
from repro.models.mlp import nll_loss as j_nll_loss

from repro_torch.core import engine, rules, staleness
from repro_torch.core.rules import ServerConfig
from repro_torch.models.mlp import nll_loss
from repro_torch.sim.fred import SimConfig, run_simulation
from repro_torch.utils.convert import (params_from_numpy,
                                      server_state_from_numpy, to_numpy)
from repro_torch.utils.trees import leaves

from test_torch_engine import KSUM, TOL, _tree
from test_torch_fred import (check_against_reference, one_thread,  # noqa: F401
                             setup)

LAM = 4


def _extra(rule, seed, count=0, seen=0):
    """A mid-run `extra` of `rule` (numpy): ĝ > 0, or a pending sum with
    its count (and K-async's cursor)."""
    if rule == "gap":
        return {"gbar": jax.tree.map(lambda x: np.abs(x) + 1e-3,
                                     _tree(seed, 0.01))}
    out = {"pending": _tree(seed, 0.1), "count": np.int32(count)}
    if rule == "kasync":
        out["seen"] = np.int32(seen)
    return out


def _state_pair(rule, extra, T=9, **kw):
    """The same state with `extra` in both packages: the JAX one built,
    the port's carried across through numpy."""
    jcfg = jrules.ServerConfig(rule=rule, lr=0.02, num_clients=LAM, **kw)
    cfg = ServerConfig(rule=rule, lr=0.02, num_clients=LAM, **kw)
    p = _tree(0)
    n = jax.tree.map(np.abs, _tree(1, 0.01))
    b, v = _tree(2, 0.05), jax.tree.map(lambda x: 1.0 + x, _tree(3, 0.1))
    J = lambda t: jax.tree.map(jnp.asarray, t)
    js = jrules.ServerState(J(p), jnp.int32(T), J(n), J(b), J(v), J(extra))
    ts = server_state_from_numpy(
        *(jax.tree.map(np.asarray, x) for x in (js.params, T, js.n, js.b,
                                                js.v)),
        device="cpu", extra=jax.tree.map(np.asarray, js.extra))
    return jcfg, cfg, js, ts


def _near_params(seed, lead=()):
    """Client copies θ_ts = θ + 0.01·noise of the state `_state_pair`
    builds (leading axes `lead`)."""
    return jax.tree.map(lambda p, d: (p + d).astype(np.float32), _tree(0),
                        _tree(seed, 0.01, lead=lead))


def _close_state(got, want, tol=TOL):
    """Floats within `tol`, integers (T, count, seen) exactly."""
    for field in ("params", "n", "b", "v", "extra"):
        g, w = leaves(to_numpy(getattr(got, field))), jax.tree.leaves(
            getattr(want, field))
        assert len(g) == len(w), field
        for a, e in zip(g, w):
            e = np.asarray(e)
            if np.issubdtype(e.dtype, np.integer):
                np.testing.assert_array_equal(a, e, err_msg=field)
            else:
                np.testing.assert_allclose(a, e, err_msg=field, **tol)
    assert int(got.timestamp) == int(want.timestamp)


UPDATE_CASES = {
    # rule, extra kwargs, ServerConfig kwargs, client copy, per-leaf ts
    "gap_no_copy": ("gap", {}, {}, False, False),
    "gap_copy": ("gap", {}, {}, True, False),
    "gap_copy_leaf_ts": ("gap", {}, {}, True, True),
    "ssgd_pending": ("ssgd", dict(count=1), {}, False, False),
    "ssgd_round_done": ("ssgd", dict(count=LAM - 1), {}, False, False),
    "ssgd_no_stats": ("ssgd", dict(count=LAM - 1), dict(track_stats=False),
                      False, False),
    "kasync2_take": ("kasync", dict(count=0, seen=0), dict(kasync_k=2),
                     False, False),
    "kasync2_round_done": ("kasync", dict(count=1, seen=1),
                           dict(kasync_k=2), False, False),
    "kasync2_discard": ("kasync", dict(count=0, seen=2), dict(kasync_k=2),
                        False, False),
    "kasync2_discard_wrap": ("kasync", dict(count=0, seen=LAM - 1),
                             dict(kasync_k=2), False, True),
    "kasync0_round_done": ("kasync", dict(count=LAM - 1, seen=LAM - 1), {},
                           False, False),
}


@pytest.mark.parametrize("name", sorted(UPDATE_CASES))
def test_apply_update_with_extra_matches_reference(name):
    rule, ex, kw, copy, leaf_ts = UPDATE_CASES[name]
    jcfg, cfg, js, ts = _state_pair(rule, _extra(rule, 5, **ex), **kw)
    g = _tree(7, 0.1)
    # a copy near θ, so that the penalty max(1, |gap|/ĝ) is 1 on some
    # elements and above 1 on others
    cp = _near_params(8) if copy else None
    grad_ts = ([{"b": np.int32(3), "w": np.int32(8)},
                {"b": np.int32(0), "w": np.int32(9)}] if leaf_ts
               else np.int32(4))
    J = lambda t: None if t is None else jax.tree.map(jnp.asarray, t)
    P = lambda t: None if t is None else params_from_numpy(t, device="cpu")
    jnew, jaux = jrules.apply_update(jcfg, js, J(g), J(grad_ts),
                                     client_params=J(cp))
    tnew, taux = rules.apply_update(cfg, ts, P(g), P(grad_ts),
                                    client_params=P(cp))
    _close_state(tnew, jnew)
    assert float(taux["tau"]) == float(jaux["tau"])
    if "applied" in jaux:
        assert bool(taux["applied"]) == bool(jaux["applied"])
    else:
        np.testing.assert_allclose(float(taux["mean_scale"]),
                                   float(jaux["mean_scale"]), **TOL)


@pytest.mark.parametrize("per_leaf", [False, True])
def test_gap_fused_apply_matches_reference(per_leaf):
    """Gap's fused path: the [K, *s] gap tensor against each event's copy,
    the ĝ statistics merged leaf by leaf under per-leaf masks."""
    jcfg, cfg, js, ts = _state_pair("gap", _extra("gap", 5))
    K = 8
    grads = _tree(13, 0.1, lead=(K,))
    copies = _near_params(14, lead=(K,))
    rng = np.random.default_rng(2)
    if per_leaf:
        bits = rng.random((4, K)) < 0.5
        bits[0] = False                  # b0: no event pushes it
        push = [{"b": bits[0], "w": bits[1]}, {"b": bits[2], "w": bits[3]}]
    else:
        push = np.array([1, 1, 0, 1, 0, 1, 1, 1], bool)
    cts = np.array([9, 2, 2, 7, 0, 9, 4, 2], np.int32)
    J = lambda t: jax.tree.map(jnp.asarray, t)
    P = lambda t: params_from_numpy(t, device="cpu")
    jnew, jtaus = jengine.fused_apply(jcfg, js, J(grads), J(push), J(cts),
                                      client_params=J(copies))
    tnew, ttaus = engine.fused_apply(cfg, ts, P(grads), P(push), P(cts),
                                     client_params=P(copies))
    _close_state(tnew, jnew, KSUM)
    np.testing.assert_array_equal(ttaus.numpy(), np.asarray(jtaus))
    if per_leaf:
        assert torch.equal(leaves(tnew.extra)[0], leaves(ts.extra)[0])


def test_barrier_rules_refuse_the_fused_apply():
    for rule in ("ssgd", "kasync"):
        _, cfg, _, ts = _state_pair(rule, _extra(rule, 5))
        g = params_from_numpy(_tree(1, 0.1, lead=(2,)), device="cpu")
        with pytest.raises(ValueError, match="fused"):
            engine.fused_apply(cfg, ts, g, torch.ones(2, dtype=torch.bool),
                               torch.zeros(2, dtype=torch.int32))


SERIAL_RR = dict(num_clients=LAM, batch_size=8, seed=3,
                 dispatcher="roundrobin")
CASES = {
    "gap_serial": dict(
        sim=dict(SERIAL_RR, dispatcher="uniform"),
        server=dict(rule="gap", lr=0.02)),
    "gap_serial_gated_leaf_fetch": dict(
        sim=dict(SERIAL_RR, dispatcher="uniform", seed=7),
        server=dict(rule="gap", lr=0.02),
        bandwidth=dict(c_push=0.5, c_fetch=0.5, per_tensor_fetch=True,
                       drop_policy="cache")),
    "gap_fused": dict(
        sim=dict(num_clients=16, batch_size=8, seed=3, events_per_step=8,
                 apply_mode="fused"),
        server=dict(rule="gap", lr=0.02, use_fused_kernel=True)),
    "gap_fused_per_tensor_skip": dict(
        sim=dict(num_clients=16, batch_size=8, seed=5, events_per_step=8,
                 apply_mode="fused"),
        server=dict(rule="gap", lr=0.02),
        bandwidth=dict(c_push=0.5, c_fetch=0.5, per_tensor_push=True,
                       per_tensor_fetch=True, drop_policy="skip")),
    "ssgd_rr": dict(sim=SERIAL_RR,
                    server=dict(rule="ssgd", lr=0.05, num_clients=LAM)),
    "ssgd_rr_leaf_fetch": dict(
        sim=dict(SERIAL_RR, seed=5),
        server=dict(rule="ssgd", lr=0.05, num_clients=LAM),
        bandwidth=dict(c_fetch=0.5, per_tensor_fetch=True)),
    "kasync0_rr": dict(sim=SERIAL_RR,
                       server=dict(rule="kasync", lr=0.05, num_clients=LAM)),
    "kasync2_rr": dict(sim=SERIAL_RR,
                       server=dict(rule="kasync", lr=0.05, num_clients=LAM,
                                   kasync_k=2)),
    "kasync2_rr_gated_skip": dict(
        sim=dict(SERIAL_RR, seed=7),
        server=dict(rule="kasync", lr=0.05, num_clients=LAM, kasync_k=2),
        bandwidth=dict(c_push=0.5, c_fetch=0.5, drop_policy="skip")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_simulation_matches_reference(setup, name):  # noqa: F811
    out = check_against_reference(setup, name, CASES[name])
    rule = CASES[name]["server"]["rule"]
    if rule in ("ssgd", "kasync") and "bandwidth" not in CASES[name]:
        # one round per λ arrivals: 48 events, 12 rounds
        assert out["final_timestamp"] == 48 // LAM


def _port_run(setup, rule, **kw):  # noqa: F811
    params, ds = setup
    cfg = SimConfig(num_clients=LAM, batch_size=8, seed=2,
                    dispatcher="roundrobin",
                    server=ServerConfig(rule=rule, lr=0.05,
                                        num_clients=LAM, **kw))
    return run_simulation(
        cfg, nll_loss, params_from_numpy(params, device="cpu"),
        ds["x_train"], ds["y_train"], 40, eval_every=40,
        collect_step_metrics=True, device="cpu")


def test_kasync_with_k0_is_ssgd_bitwise(setup):  # noqa: F811
    """kasync_k = 0 means K = λ: the same trajectory as ssgd, bit for
    bit (the barrier's pending sum, count and statistics included)."""
    ssgd, kasync = _port_run(setup, "ssgd"), _port_run(setup, "kasync")
    assert ssgd["final_timestamp"] == kasync["final_timestamp"] == 10
    assert torch.equal(ssgd["train_loss"], kasync["train_loss"])
    a, b = ssgd["state"].server, kasync["state"].server
    for field in ("params", "n", "b", "v"):
        for x, y in zip(leaves(getattr(a, field)), leaves(getattr(b, field))):
            assert torch.equal(x, y), field
    for x, y in zip(leaves(a.extra["pending"]), leaves(b.extra["pending"])):
        assert torch.equal(x, y)
    assert int(a.extra["count"]) == int(b.extra["count"])
    assert torch.equal(ssgd["state"].client_ts, kasync["state"].client_ts)


def test_barrier_unblocks_every_client(setup):  # noqa: F811
    """When a round completes every client copy is the server's."""
    out = _port_run(setup, "kasync", kasync_k=2)
    srv = out["state"].server
    assert bool((out["state"].client_ts == srv.timestamp).all())
    for cl, sp in zip(leaves(out["state"].client_params), leaves(srv.params)):
        assert torch.equal(cl, sp[None].expand_as(cl))


def test_b_staleness_matches_reference(setup):  # noqa: F811
    params, ds = setup
    rng = np.random.default_rng(0)
    client = jax.tree.map(
        lambda x: (x + 0.01 * rng.standard_normal(x.shape)).astype(
            np.float32), params)
    xb, yb = ds["x_train"][:32], ds["y_train"][:32]
    want = jstaleness.b_staleness(
        lambda p, b: jax.grad(j_nll_loss)(p, *b),
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, client),
        (jnp.asarray(xb), jnp.asarray(yb)))
    got = staleness.b_staleness(
        lambda p, b: torch.func.grad(nll_loss)(p, *b),
        params_from_numpy(params, device="cpu"),
        params_from_numpy(client, device="cpu"),
        (torch.as_tensor(xb), torch.as_tensor(yb).long()))
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    same = staleness.b_staleness(
        lambda p, b: torch.func.grad(nll_loss)(p, *b),
        params_from_numpy(params, device="cpu"),
        params_from_numpy(params, device="cpu"),
        (torch.as_tensor(xb), torch.as_tensor(yb).long()))
    assert float(same) == 0.0


@pytest.mark.parametrize("kw", [dict(kasync_k=-1),
                                dict(kasync_k=5, num_clients=4)])
def test_server_config_checks_match_reference(kw):
    with pytest.raises(ValueError):
        jrules.ServerConfig(rule="kasync", **kw)
    with pytest.raises(ValueError):
        ServerConfig(rule="kasync", **kw)
