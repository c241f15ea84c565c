"""The port's scenario module (`core.scenarios`) and FRED under a scenario,
against a live run of the JAX reference.

The arrival primitives replay the variates `jax.random` drew for the
reference (`test_torch_fred.scenario_replay_of`, a `ReplayScenarioDraws`):
integer and boolean state (``n_draws``, ``dropped``, ``window``, the
clients in firing order, the active masks and churn counts) must match
exactly, times within rtol 1e-6 (each framework's exp and float32 sums
round on their own).  FRED under a scenario goes through
`test_torch_fred.check_against_reference` with those tolerances.  The
reference's own properties (tests/test_scenarios.py) are held for the
native provider, whose draws are a counter hash on the device.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scenarios as jscen
from repro.core.engine import init_counters as j_init_counters
from repro.core.rules import ServerConfig as JServerConfig
from repro.models.mlp import nll_loss as j_nll_loss
from repro.sim.fred import SimConfig as JSimConfig
from repro.sim.fred import build_step_fn as j_build_step_fn
from repro.sim.fred import init_sim as j_init_sim

from repro_torch.core import scenarios as scen
from repro_torch.core.engine import init_counters
from repro_torch.core.rules import ServerConfig
from repro_torch.models.mlp import nll_loss
from repro_torch.sim.fred import SimConfig, build_step_fn, init_sim
from repro_torch.utils import rng
from repro_torch.utils.convert import (params_from_numpy,
                                       scenario_state_from_numpy)
from repro_torch.utils.rng import NativeScenarioDraws

from test_torch_fred import (WALL_RTOL, assert_scenario_states_match,
                             check_against_reference, one_thread,  # noqa: F401
                             replay_of, scenario_configs, scenario_replay_of,
                             setup)

CPU = torch.device("cpu")
PRESETS = sorted(scen.SCENARIO_PRESETS)
# a fleet with hotspots and stragglers under each service law
MIXED = dict(straggler_frac=0.25, straggler_slowdown=4.0, hotspot_frac=0.125,
             hotspot_speedup=2.0, seed=5)


def _replay(j_cfg, lam, n_draws=96, n_windows=16):
    return scenario_replay_of(j_cfg, lam, n_draws, n_windows)


def _close(got, want, what):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want),
                               rtol=WALL_RTOL, err_msg=what)


def _equal(got, want, what):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want),
                                  err_msg=what)


@pytest.fixture
def unstable_ties(monkeypatch):
    """`torch.argsort` as a device may run it without ``stable=True``:
    ties in descending index order (the CPU's sort is stable either way,
    so without this a missing ``stable=True`` would pass here)."""
    real = torch.argsort

    def argsort(x, *args, stable=False, **kwargs):
        if stable:
            return real(x, *args, stable=True, **kwargs)
        n = x.shape[-1]
        return n - 1 - real(x.flip(-1), *args, stable=True, **kwargs)
    monkeypatch.setattr(torch, "argsort", argsort)


# ---------------------------------------------------------------------------
# the primitives against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lam", [8, 16])
@pytest.mark.parametrize("name", PRESETS + ["mixed"])
def test_client_scales_match_reference(name, lam):
    j_cfg, p_cfg = scenario_configs(MIXED if name == "mixed" else name)
    _equal(scen.client_scales(p_cfg, lam, CPU),
           jscen.client_scales(j_cfg, lam), "scales")


@pytest.mark.parametrize("name", PRESETS + ["fixed", "pareto"])
def test_init_scenario_matches_reference(name):
    spec = (dict(MIXED, service=name) if name in ("fixed", "pareto")
            else name)
    j_cfg, p_cfg = scenario_configs(spec)
    lam = 16
    got = scen.init_scenario(p_cfg, lam, CPU, _replay(j_cfg, lam))
    assert_scenario_states_match(got, jscen.init_scenario(j_cfg, lam))


@pytest.mark.parametrize("name", ["dropout", "elastic"])
def test_window_prologue_matches_reference_over_windows(name):
    """Prologue + an 8-event race, eight windows: churn counts, active
    masks and the whole state each window.  The dropout case raises both
    hazards so that clients drop and rejoin; the elastic one runs past
    ``resize_at``, where parked clients (+inf) join the argmin."""
    spec = (dict(preset="dropout", dropout_rate=0.3, rejoin_rate=0.4,
                 seed=11) if name == "dropout" else name)
    j_cfg, p_cfg = scenario_configs(spec)
    lam, K = 8, 8
    draws = _replay(j_cfg, lam)
    j_scales = jscen.client_scales(j_cfg, lam)
    scales = scen.client_scales(p_cfg, lam, CPU)
    j_st = jscen.init_scenario(j_cfg, lam)
    st = scen.init_scenario(p_cfg, lam, CPU, draws)
    churned = 0
    for w in range(8):
        j_st, j_act, j_drop, j_rej = jscen.window_prologue(
            j_cfg, lam, j_st, j_scales)
        st, act, drop, rej = scen.window_prologue(p_cfg, lam, st, scales,
                                                  draws)
        _equal(act, j_act, f"active, window {w}")
        assert (int(drop), int(rej)) == (int(j_drop), int(j_rej))
        churned += int(drop) + int(rej)
        assert_scenario_states_match(st, j_st)
        j_st, j_cs, j_t = jscen.async_window(j_cfg, lam, j_st, j_scales,
                                             j_act, K)
        st, cs, t = scen.async_window(p_cfg, lam, st, scales, act, K, draws)
        _equal(cs, j_cs, f"clients, window {w}")
        _close(t, j_t, f"finish times, window {w}")
        assert_scenario_states_match(st, j_st)
    if name == "dropout":
        assert churned > 0
    else:
        assert float(st.now) > p_cfg.resize_at
        assert bool(torch.all(torch.isfinite(st.next_t)))


def test_mid_run_scenario_state_carried_across():
    """A reference race stopped after 3 churned windows continues in the
    port from its state (`scenario_state_from_numpy`) as it does in the
    reference."""
    j_cfg, p_cfg = scenario_configs(dict(preset="dropout", dropout_rate=0.3,
                                         rejoin_rate=0.4, seed=4))
    lam, K = 8, 8
    draws = _replay(j_cfg, lam)
    j_scales = jscen.client_scales(j_cfg, lam)
    scales = scen.client_scales(p_cfg, lam, CPU)
    j_st = jscen.init_scenario(j_cfg, lam)
    for w in range(6):
        if w == 3:
            st = scenario_state_from_numpy(jax.tree.map(np.asarray, j_st),
                                           device="cpu")
            assert_scenario_states_match(st, j_st)
            assert bool(st.dropped.any())
        j_st, j_act, _, _ = jscen.window_prologue(j_cfg, lam, j_st, j_scales)
        j_st, j_cs, _ = jscen.async_window(j_cfg, lam, j_st, j_scales, j_act,
                                           K)
        if w >= 3:
            st, act, _, _ = scen.window_prologue(p_cfg, lam, st, scales,
                                                 draws)
            st, cs, _ = scen.async_window(p_cfg, lam, st, scales, act, K,
                                          draws)
            _equal(cs, j_cs, f"clients, window {w}")
    assert_scenario_states_match(st, j_st)


@pytest.mark.parametrize("service", scen._SERVICE_KINDS)
def test_async_window_matches_reference(service):
    """Every service law, 'fixed' included: its service times tie, and the
    argmin must break each tie to the lowest index as `jnp.argmin` does."""
    j_cfg, p_cfg = scenario_configs(dict(MIXED, service=service))
    lam, K = 16, 40
    draws = _replay(j_cfg, lam)
    active = np.ones(lam, bool)
    active[[3, 9]] = False
    j_st, j_cs, j_t = jscen.async_window(
        j_cfg, lam, jscen.init_scenario(j_cfg, lam),
        jscen.client_scales(j_cfg, lam), jnp.asarray(active), K)
    st, cs, t = scen.async_window(
        p_cfg, lam, scen.init_scenario(p_cfg, lam, CPU, draws),
        scen.client_scales(p_cfg, lam, CPU), torch.from_numpy(active), K,
        draws)
    _equal(cs, j_cs, "clients")
    _close(t, j_t, "finish times")
    assert_scenario_states_match(st, j_st)


@pytest.mark.parametrize("k_used", [3, 16])
@pytest.mark.parametrize("service", scen._SERVICE_KINDS)
def test_sync_round_matches_reference(service, k_used, unstable_ties):
    """Three rounds; under 'fixed' the 16 draws fall in three tied groups,
    which only a stable sort orders by index as `jnp.argsort` does."""
    j_cfg, p_cfg = scenario_configs(dict(MIXED, service=service))
    lam = 16
    draws = _replay(j_cfg, lam)
    j_scales = jscen.client_scales(j_cfg, lam)
    scales = scen.client_scales(p_cfg, lam, CPU)
    j_st = jscen.init_scenario(j_cfg, lam)
    st = scen.init_scenario(p_cfg, lam, CPU, draws)
    for r in range(3):
        j_st, j_order, j_t = jscen.sync_round(j_cfg, lam, j_st, j_scales,
                                              k_used)
        st, order, t = scen.sync_round(p_cfg, lam, st, scales, k_used, draws)
        _equal(order, j_order, f"order, round {r}")
        _close(t, j_t, f"finish times, round {r}")
        assert_scenario_states_match(st, j_st)
    if service == "fixed":
        # hotspots (2 of them) first, then the nominal 10, then stragglers
        assert order.tolist() == list(range(lam))
    with pytest.raises(ValueError):
        scen.sync_round(p_cfg, lam, st, scales, lam + 1, draws)


@pytest.mark.parametrize("service", scen._SERVICE_KINDS)
def test_round_service_times_match_reference(service):
    j_cfg, p_cfg = scenario_configs(dict(MIXED, service=service))
    draws = _replay(j_cfg, 8)
    for r in range(4):
        want = jscen.round_service_times(j_cfg, 8, r)
        _close(scen.round_service_times(p_cfg, 8, r, draws, device=CPU),
               want, f"round {r}")
        # a device scalar round index gives the same draws
        _close(scen.round_service_times(
            p_cfg, 8, torch.tensor(r, dtype=torch.int32), draws), want,
            f"round {r} (tensor index)")


def test_count_scenario_and_advance_wall_match_reference():
    j_c, c = j_init_counters(), init_counters(CPU)
    folds = [(1.5, 4.0, 1, 0), (3.25, 3.0, 0, 2), (2.0, 5.0, 2, 1)]
    for now, act, drop, rej in folds:
        j_c = jscen.count_scenario(j_c, now=jnp.float32(now),
                                   active_count=jnp.float32(act),
                                   dropouts=drop, rejoins=rej)
        c = scen.count_scenario(c, now=torch.tensor(now), active_count=act,
                                dropouts=torch.tensor(drop), rejoins=rej)
    for dt in (0.75, torch.tensor(1.125)):
        j_c = jscen.advance_wall(j_c, float(dt), active_count=8)
        c = scen.advance_wall(c, dt, active_count=8)
    for f in ("wall_clock", "scenario_dropouts", "scenario_rejoins",
              "scenario_active_sum", "scenario_windows"):
        got, want = getattr(c, f), getattr(j_c, f)
        assert got.dtype == getattr(torch, str(np.asarray(want).dtype)), f
        _equal(got, want, f)


@pytest.mark.parametrize("kwargs", [
    dict(service="weibull"), dict(mean_service=0.0), dict(pareto_alpha=1.0),
    dict(dropout_rate=1.5), dict(straggler_frac=-0.1),
    dict(initial_active_frac=2.0), dict(straggler_slowdown=0.5),
    dict(hotspot_speedup=0.9), dict(resize_at=-1.0),
])
def test_scenario_config_validation_matches_reference(kwargs):
    with pytest.raises(ValueError):
        jscen.ScenarioConfig(**kwargs)
    with pytest.raises(ValueError):
        scen.ScenarioConfig(**kwargs)


def test_presets_and_fleet_checks_match_reference():
    for name in PRESETS:
        assert (dataclasses.asdict(scen.preset(name))
                == dataclasses.asdict(jscen.preset(name)))
        assert scen.preset(name).has_churn() == jscen.preset(name).has_churn()
    with pytest.raises(KeyError):
        jscen.preset("nonexistent")
    with pytest.raises(KeyError, match="presets"):
        scen.preset("nonexistent")
    overlap = dict(hotspot_frac=0.6, straggler_frac=0.6)
    with pytest.raises(ValueError, match="cover"):
        jscen.client_scales(jscen.ScenarioConfig(**overlap), 8)
    with pytest.raises(ValueError, match="cover"):
        scen.client_scales(scen.ScenarioConfig(**overlap), 8, CPU)


# ---------------------------------------------------------------------------
# the reference's properties, with the native provider
# ---------------------------------------------------------------------------

def _race(cfg, lam, num_events, active):
    scales = scen.client_scales(cfg, lam, CPU)
    state = scen.init_scenario(cfg, lam, CPU)
    state, cs, t = scen.async_window(cfg, lam, state, scales, active,
                                     num_events)
    per_client = {c: [] for c in range(lam)}
    for c, ti in zip(cs.tolist(), t.tolist()):
        per_client[c].append(ti)
    return state, per_client, t


def test_dropout_isolation_bitwise():
    """Removing client 1 leaves every other client's event times bitwise
    unchanged: each client's stream is keyed by (seed, client, draw)."""
    cfg, lam = scen.preset("stragglers"), 4
    on = torch.ones(lam, dtype=torch.bool)
    off = on.clone()
    off[1] = False
    _, full, _ = _race(cfg, lam, 16, on)
    _, dropped, _ = _race(cfg, lam, 16, off)
    assert not dropped[1]
    for c in (0, 2, 3):
        n = min(len(full[c]), len(dropped[c]))
        assert n > 0
        assert full[c][:n] == dropped[c][:n]


@pytest.mark.parametrize("name", PRESETS)
def test_async_event_times_never_decrease(name):
    cfg, lam = scen.preset(name), 8
    draws = scen.native_draws(cfg)
    scales = scen.client_scales(cfg, lam, CPU)
    state = scen.init_scenario(cfg, lam, CPU)
    last = 0.0
    for _ in range(6):
        state, active, _, _ = scen.window_prologue(cfg, lam, state, scales,
                                                   draws)
        state, _, t = scen.async_window(cfg, lam, state, scales, active, 16,
                                        draws)
        t = t.numpy()
        assert t[0] >= last and np.all(np.diff(t) >= 0)
        assert float(state.now) == t[-1]
        last = t[-1]


def test_sync_round_wall_is_kth_order_statistic():
    cfg = scen.ScenarioConfig(service="lognormal", seed=5)
    lam, k = 8, 3
    scales = scen.client_scales(cfg, lam, CPU)
    state = scen.init_scenario(cfg, lam, CPU)
    new, order, t = scen.sync_round(cfg, lam, state, scales, k)
    dts = np.sort(t.numpy() - float(state.now))
    assert float(new.now) - float(state.now) == pytest.approx(dts[k - 1])
    assert sorted(order.tolist()) == list(range(lam))
    assert np.all(np.diff(t.numpy()) >= 0)


def test_dropout_rejoin_counts_are_consistent():
    cfg = dataclasses.replace(scen.preset("dropout"), dropout_rate=0.5,
                              rejoin_rate=0.5, seed=11)
    lam = 32
    scales = scen.client_scales(cfg, lam, CPU)
    state = scen.init_scenario(cfg, lam, CPU)
    prev, moved = lam, 0
    for _ in range(8):
        state, active, n_drop, n_rejoin = scen.window_prologue(
            cfg, lam, state, scales)
        n_active = int(active.sum())
        assert n_active >= 1
        assert n_active == prev - int(n_drop) + int(n_rejoin)
        assert int(state.dropped.sum()) == lam - n_active
        prev, moved = n_active, moved + int(n_drop) + int(n_rejoin)
    assert moved > 0


def test_elastic_resize_activates_parked_clients():
    cfg, lam = scen.preset("elastic"), 8
    scales = scen.client_scales(cfg, lam, CPU)
    state = scen.init_scenario(cfg, lam, CPU)
    assert bool(torch.isinf(state.next_t[lam // 2:]).all())
    state, active, _, _ = scen.window_prologue(cfg, lam, state, scales)
    assert int(active.sum()) == lam // 2
    state = state._replace(now=torch.tensor(cfg.resize_at + 1.0))
    state, active, _, _ = scen.window_prologue(cfg, lam, state, scales)
    assert int(active.sum()) == lam
    assert bool(torch.isfinite(state.next_t).all())
    assert bool((state.next_t[lam // 2:] > cfg.resize_at + 1.0).all())


# ---------------------------------------------------------------------------
# the native provider
# ---------------------------------------------------------------------------

def test_hash_arithmetic_is_exact():
    """The 32-bit products and the mixer against Python integers."""
    r = np.random.default_rng(0)
    xs = [int(v) for v in r.integers(0, 1 << 32, 2000, dtype=np.uint64)]
    t = torch.tensor(xs, dtype=torch.int64)
    for c in (0x7FEB352D, 0x846CA68B, 0x9E3779B9, 1, 0xFFFFFFFF):
        assert rng._mul32(t, c).tolist() == [(x * c) & 0xFFFFFFFF
                                              for x in xs]

    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)
    assert rng._mix32_t(t).tolist() == [mix(x) for x in xs]


@pytest.mark.parametrize("service", ["lognormal", "pareto"])
def test_native_service_draws_are_counter_based(service):
    """A draw is a function of (seed, c, n) alone, whatever batch it is
    made in; another seed gives other draws; the variates have the law's
    moments (standard normal; Pareto(α) on [1, ∞) with mean α/(α−1))."""
    d = NativeScenarioDraws(3, service, pareto_alpha=3.0)
    c = torch.arange(16)[:, None]
    n = torch.arange(512)[None, :]
    grid = d.service(c, n)
    assert grid.dtype == torch.float32 and grid.shape == (16, 512)
    assert torch.equal(d.service(torch.tensor([5]), torch.tensor([77])),
                       grid[5, 77:78])
    assert torch.equal(d.service(c[4:9], n[:, 100:130]), grid[4:9, 100:130])
    other = NativeScenarioDraws(4, service, pareto_alpha=3.0)
    assert not torch.equal(other.service(c, n), grid)
    x = grid.double()
    if service == "lognormal":
        assert abs(float(x.mean())) < 0.03 and abs(float(x.std()) - 1) < 0.03
    else:
        assert float(x.min()) >= 1.0
        assert abs(float(x.mean()) - 1.5) < 0.05


def test_native_churn_draws_are_counter_based():
    d = NativeScenarioDraws(3, "lognormal")
    u = d.churn(torch.tensor(5, dtype=torch.int32), 16)
    assert u.shape == (16, 2) and u.dtype == torch.float32
    assert bool((u >= 0).all() and (u < 1).all())
    assert torch.equal(d.churn(torch.tensor(5), 8), u[:8])
    assert not torch.equal(d.churn(torch.tensor(6), 16), u)
    many = torch.stack([d.churn(torch.tensor(w), 64) for w in range(64)])
    assert abs(float(many.mean()) - 0.5) < 0.02


def test_replay_refuses_draws_it_does_not_hold():
    j_cfg, _ = scenario_configs("stragglers")
    draws = _replay(j_cfg, 4, n_draws=8, n_windows=2)
    with pytest.raises(IndexError):
        draws.service(torch.arange(4), torch.full((4,), 8))


@pytest.mark.parametrize("make", [
    lambda **kw: scen.client_scales(scen.preset("stragglers"), 8, **kw),
    lambda **kw: scen.init_scenario(scen.preset("stragglers"), 8, **kw),
    lambda **kw: scen.round_service_times(scen.preset("stragglers"), 8, 0,
                                          **kw),
], ids=["client_scales", "init_scenario", "round_service_times"])
def test_entry_points_run_on_the_card_unless_asked(make):
    out = make(device="cpu")
    assert all(t.device.type == "cpu" for t in
               (out if isinstance(out, tuple) else (out,)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------------------
# FRED under a scenario
# ---------------------------------------------------------------------------

FRED_CASES = {
    "stragglers_serial_asgd": dict(
        sim=dict(num_clients=8, batch_size=8, seed=3, events_per_step=8),
        server=dict(rule="asgd", lr=0.01), scenario="stragglers"),
    "stragglers_fused_fasgd_kernel": dict(
        sim=dict(num_clients=8, batch_size=8, seed=3, events_per_step=8,
                 apply_mode="fused"),
        server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True),
        scenario="stragglers"),
    "dropout_async": dict(
        sim=dict(num_clients=8, batch_size=8, seed=9, events_per_step=4),
        server=dict(rule="asgd", lr=0.01),
        scenario=dict(preset="dropout", dropout_rate=0.2, rejoin_rate=0.3,
                      seed=9)),
    "elastic_fused": dict(
        sim=dict(num_clients=8, batch_size=8, seed=5, events_per_step=8,
                 apply_mode="fused"),
        server=dict(rule="sasgd", lr=0.01), scenario="elastic"),
    "kasync_stragglers": dict(
        sim=dict(num_clients=8, batch_size=8, seed=3, events_per_step=8),
        server=dict(rule="kasync", lr=0.05, num_clients=8, kasync_k=3),
        scenario="stragglers"),
    "ssgd_stragglers": dict(
        sim=dict(num_clients=8, batch_size=8, seed=3, events_per_step=8),
        server=dict(rule="ssgd", lr=0.05, num_clients=8),
        scenario="stragglers"),
    "queued_stragglers": dict(
        sim=dict(num_clients=4, batch_size=8, seed=3, events_per_step=4,
                 queue_capacity=6, drain_policy="drain_k", drain_k=2,
                 admission_policy="reject"),
        server=dict(rule="asgd", lr=0.01), scenario="stragglers"),
    "queued_fused_hotspot": dict(
        sim=dict(num_clients=8, batch_size=8, seed=3, events_per_step=8,
                 apply_mode="fused", queue_capacity=12,
                 drain_policy="adaptive", drain_adaptive_gain=0.6,
                 admission_policy="drop_oldest"),
        server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True),
        scenario="hotspot"),
}


@pytest.mark.parametrize("name", sorted(FRED_CASES))
def test_fred_under_a_scenario_matches_reference(setup, name):
    out = check_against_reference(setup, name, FRED_CASES[name])
    c = out["counters"]
    assert c["wall_clock"] > 0 and c["scenario_windows"] > 0
    walls = out["wall_clock"]
    assert all(b >= a for a, b in zip(walls, walls[1:]))
    if FRED_CASES[name]["sim"].get("queue_capacity"):
        assert c["queue_latency_wall_sum"] > 0


@pytest.mark.parametrize("mode", ["serial", "fused"])
def test_fred_scenario_windows_fire_the_reference_clients(setup, mode):
    """Window by window, the clients in firing order and their finish
    times (the step's ``client`` and ``wall`` metrics)."""
    params, ds = setup
    sim = dict(num_clients=8, batch_size=4, seed=2, events_per_step=8,
               apply_mode=mode)
    j_scn, p_scn = scenario_configs("hotspot")
    j_cfg = JSimConfig(server=JServerConfig(rule="asgd", lr=0.01),
                       scenario=j_scn, **sim)
    cfg = SimConfig(server=ServerConfig(rule="asgd", lr=0.01),
                    scenario=p_scn, **sim)
    x, y = ds["x_train"], ds["y_train"]
    j_step = jax.jit(j_build_step_fn(j_cfg, j_nll_loss, jnp.asarray(x),
                                     jnp.asarray(y)))
    j_state = j_init_sim(j_cfg, jax.tree.map(jnp.asarray, params))
    draws_scn = scenario_replay_of(j_scn, 8, 64, 8)
    state = init_sim(cfg, params_from_numpy(params, "cpu"), draws_scn)
    step = build_step_fn(cfg, nll_loss, torch.as_tensor(x),
                         torch.as_tensor(y).long(), scenario_draws=draws_scn)
    ev = replay_of(sim, x.shape[0], num_steps=32, eval_every=32)
    base = jax.random.PRNGKey(sim["seed"])
    for w in range(4):
        keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
            w * 8 + jnp.arange(8))
        j_state, j_m = j_step(j_state, keys)
        state, m = step(state, ev.events(w * 8, 8, "cpu"))
        _equal(m["client"], j_m["client"], f"clients, window {w}")
        _close(m["wall"], j_m["wall"], f"wall, window {w}")
    assert_scenario_states_match(state.scenario, j_state.scenario)
