"""The port's FRED simulator against a live run of the JAX reference.

Both packages start from the same 784-200-10 MLP weights and the same
synthetic data (the JAX generator's arrays, through numpy), and the port
replays the exact draws `jax.random` made for the reference run (its
`ReplayDraws` provider).  The reference runs its Pallas kernels in
interpret mode; the port, on the CPU, runs their plain versions.

Tolerances: τ, the counters and the final timestamp match exactly; losses,
parameters and the n/b/v statistics within rtol 1e-4 / atol 1e-5 (float32
sums and BLAS products taken in another order by each framework, over 48
events).  Under a scenario the modelled wall clock (the ``wall_clock`` and
``queue_latency_wall_sum`` counters, the curve, the scenario's times) is
held within rtol 1e-6: each framework's exp rounds on its own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scenarios as jscen
from repro.core.bandwidth import BandwidthConfig as JBandwidthConfig
from repro.core.rules import ServerConfig as JServerConfig
from repro.data.mnist import make_synth_mnist as j_make_synth_mnist
from repro.models.mlp import init_mlp as j_init_mlp
from repro.models.mlp import nll_loss as j_nll_loss
from repro.sim.fred import SimConfig as JSimConfig
from repro.sim.fred import run_simulation as j_run_simulation

from repro_torch.core import engine
from repro_torch.core import scenarios as scen
from repro_torch.core.bandwidth import BandwidthConfig
from repro_torch.core.engine import init_counters
from repro_torch.core.rules import ServerConfig
from repro_torch.data.mnist import make_synth_mnist
from repro_torch.kernels import ops
from repro_torch.models.mlp import init_mlp, nll_loss
from repro_torch.sim.fred import SimConfig, run_simulation
from repro_torch.utils.convert import (params_from_numpy,
                                       server_state_from_numpy, to_numpy)
from repro_torch.utils.rng import (NativeDraws, ReplayDraws,
                                   ReplayScenarioDraws)
from repro_torch.utils.trees import leaves

EVENTS = 48
EVAL_EVERY = 24
RTOL, ATOL = 1e-4, 1e-5
WALL_RTOL = 1e-6
# counters on the modelled wall clock, held within WALL_RTOL
WALL_COUNTERS = ("wall_clock", "queue_latency_wall_sum")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Run the port's CPU ops on one thread for the tests of a module that
    uses this fixture, and restore the thread count after them.  The suite
    runs in several worker processes at once, and torch's intra-op thread
    pools then oversubscribe the cores: every one of the thousands of small
    ops of a FRED run waits on threads that are not running."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    params = jax.tree.map(np.array, j_init_mlp(jax.random.PRNGKey(0)))
    ds = j_make_synth_mnist(n_train=512, n_valid=256)
    return params, jax.tree.map(np.array, ds._asdict())


def replay_of(cfg, n_data, num_steps=EVENTS, eval_every=EVAL_EVERY,
              bandwidth=None, n_leaves=4):
    """The draws the reference makes for `cfg` (and its `bandwidth`
    settings), window by window, exactly as `repro.sim.fred.run_simulation`
    derives them: whole-copy gates from one key per window on the
    unqueued fused path, and from each event's key on the serial path and
    on every queued path (``queue_capacity > 0``, serial and fused alike);
    per-tensor gates from each event's key split into one key per leaf, on
    every path."""
    base = jax.random.PRNGKey(cfg["seed"])
    lam, mu, K = cfg["num_clients"], cfg["batch_size"], cfg.get(
        "events_per_step", 1)
    window_key = (cfg.get("apply_mode") == "fused"
                  and not cfg.get("queue_capacity"))
    bw = bandwidth or {}
    per_leaf = jax.vmap(lambda kk: jax.vmap(jax.random.uniform)(
        jax.random.split(kk, n_leaves)))
    out = {"clients": [], "idx": [], "push_u": [], "fetch_u": []}
    done = 0
    while done < num_steps:
        span = min(eval_every, num_steps - done)
        n_batches, rem = divmod(span, K)
        windows = [K] * n_batches + ([rem] if rem else [])
        for k in windows:
            keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
                done + jnp.arange(k))
            ks = jax.vmap(lambda kk: jax.random.split(kk, 4))(keys)
            out["clients"].append(jax.vmap(
                lambda kk: jax.random.randint(kk, (), 0, lam))(ks[:, 0]))
            out["idx"].append(jax.vmap(
                lambda kk: jax.random.randint(kk, (mu,), 0, n_data))(ks[:, 1]))
            for name, col, flag in (("push_u", 2, "per_tensor_push"),
                                    ("fetch_u", 3, "per_tensor_fetch")):
                if bw.get(flag):
                    out[name].append(per_leaf(ks[:, col]))
                elif window_key:   # one key draws the window's gates
                    out[name].append(jax.random.uniform(ks[0, col], (k,)))
                else:
                    out[name].append(jax.vmap(jax.random.uniform)(ks[:, col]))
            done += k
    return ReplayDraws(**{k: np.concatenate([np.asarray(a) for a in v])
                          for k, v in out.items()})


def scenario_configs(spec):
    """The reference's and the port's `ScenarioConfig` for `spec`: a preset
    name, or a dict of fields (with an optional ``preset`` to start
    from)."""
    if isinstance(spec, str):
        spec = {"preset": spec}
    spec = dict(spec)
    name = spec.pop("preset", None)
    kw = dict(dataclasses.asdict(jscen.preset(name)) if name else {}, **spec)
    return jscen.ScenarioConfig(**kw), scen.ScenarioConfig(**kw)


def scenario_replay_of(j_cfg, lam, n_draws, n_windows):
    """The variates `jax.random` draws for the scenario `j_cfg` over a
    λ-client fleet, as the reference keys them: client c's n-th service
    draw (n < `n_draws`; a standard normal for 'lognormal', a Pareto(α)
    for 'pareto', unused for 'fixed') and the churn uniforms of windows
    ``< n_windows``."""
    base = jax.random.fold_in(jax.random.PRNGKey(j_cfg.seed),
                              jscen._SVC_SALT)

    def unit(c, n):
        key = jax.random.fold_in(jax.random.fold_in(base, c), n)
        if j_cfg.service == "pareto":
            return jax.random.pareto(key, j_cfg.pareto_alpha)
        return jax.random.normal(key)
    cs = jnp.arange(lam)
    svc = jax.vmap(lambda c: jax.vmap(lambda n: unit(c, n))(
        jnp.arange(n_draws)))(cs)
    cbase = jax.random.fold_in(jax.random.PRNGKey(j_cfg.seed),
                               jscen._CHURN_SALT)
    churn = jax.vmap(lambda w: jax.vmap(lambda c: jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(cbase, c), w), (2,)))(cs))(
        jnp.arange(n_windows))
    return ReplayScenarioDraws(np.asarray(svc), np.asarray(churn))


def assert_counters_match(got, want):
    """Counters equal, those on the modelled wall clock within
    WALL_RTOL."""
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        if k in WALL_COUNTERS:
            np.testing.assert_allclose(got[k], want[k], rtol=WALL_RTOL,
                                       err_msg=k)
        else:
            assert got[k] == want[k], (k, got[k], want[k])


def assert_scenario_states_match(got, want):
    """Integer and boolean fields exactly, times within WALL_RTOL (+inf of
    a parked client included)."""
    for f in ("n_draws", "dropped", "window"):
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("now", "next_t"):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=WALL_RTOL, err_msg=f)


CASES = {
    "fasgd_serial_kernel": dict(
        sim=dict(num_clients=4, batch_size=8, seed=3),
        server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True)),
    "fasgd_serial_plain": dict(
        sim=dict(num_clients=4, batch_size=8, seed=3),
        server=dict(rule="fasgd", lr=0.01)),
    "gated_cache": dict(
        sim=dict(num_clients=4, batch_size=8, seed=7),
        server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True),
        bandwidth=dict(c_push=2.0, c_fetch=2.0, drop_policy="cache")),
    "gated_skip": dict(
        sim=dict(num_clients=4, batch_size=8, seed=7),
        server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True),
        bandwidth=dict(c_push=2.0, c_fetch=2.0, drop_policy="skip")),
}


def _close(a, b, what, worst):
    """Assert within tolerance; keep the largest |Δ| per kind in `worst`."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=what)
    kind = what.split()[0]
    worst[kind] = max(worst.get(kind, 0.0), float(np.max(np.abs(a - b))))


def _same_or_close(a, b, what, worst):
    """Integer leaves exactly, float leaves within tolerance."""
    if np.issubdtype(np.asarray(b).dtype, np.integer):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)
    else:
        _close(a, b, what, worst)


def check_against_reference(setup, name, case, num_steps=EVENTS):
    """Run `case` through both packages (the port replaying the reference's
    draws) and hold the port to the reference: τ, counters, T, client
    timestamps (whole-copy and per tensor) and the ingress queue's ring
    indices, timestamps and clients exactly, floats within tolerance
    (server state with the rule's `extra`, client copies, the gradient
    cache, the queued payloads)."""
    params, ds = setup
    bw = case.get("bandwidth", {})
    j_scn = p_scn = scn_rng = None
    if case.get("scenario") is not None:
        j_scn, p_scn = scenario_configs(case["scenario"])
        scn_rng = scenario_replay_of(j_scn, case["sim"]["num_clients"],
                                     2 * num_steps + 8, num_steps + 1)
    j_cfg = JSimConfig(
        server=JServerConfig(**case["server"], kernel_interpret=True),
        bandwidth=JBandwidthConfig(**bw), scenario=j_scn, **case["sim"])
    cfg = SimConfig(server=ServerConfig(**case["server"]),
                    bandwidth=BandwidthConfig(**bw), scenario=p_scn,
                    **case["sim"])
    j_out = j_run_simulation(
        j_cfg, j_nll_loss, jax.tree.map(jnp.asarray, params),
        jnp.asarray(ds["x_train"]), jnp.asarray(ds["y_train"]), num_steps,
        eval_every=EVAL_EVERY,
        eval_fn=lambda p: j_nll_loss(p, ds["x_valid"], ds["y_valid"]),
        collect_step_metrics=True)

    xv = torch.as_tensor(ds["x_valid"])
    yv = torch.as_tensor(ds["y_valid"]).long()
    ops.reset_launches()
    out = run_simulation(
        cfg, nll_loss, params_from_numpy(params, device="cpu"), ds["x_train"],
        ds["y_train"], num_steps, eval_every=EVAL_EVERY,
        eval_fn=lambda p: nll_loss(p, xv, yv), collect_step_metrics=True,
        rng=replay_of(case["sim"], ds["x_train"].shape[0], num_steps,
                      bandwidth=bw),
        device="cpu", scenario_draws=scn_rng)

    np.testing.assert_array_equal(out["tau"].numpy(), np.asarray(j_out["tau"]))
    assert_counters_match(out["counters"], j_out["counters"])
    assert out["final_timestamp"] == j_out["final_timestamp"]
    assert out["steps"] == j_out["steps"]
    np.testing.assert_allclose(out["wall_clock"], j_out["wall_clock"],
                               rtol=WALL_RTOL)
    if j_scn is None:
        assert out["state"].scenario is None
    else:
        assert_scenario_states_match(out["state"].scenario,
                                     j_out["state"].scenario)
    worst = {}
    _close(out["train_loss"].numpy(), j_out["train_loss"], "train_loss",
           worst)
    _close(out["val_cost"], j_out["val_cost"], "val_cost", worst)
    j_srv, srv = j_out["state"].server, to_numpy(out["state"].server)
    for field in ("params", "n", "b", "v", "extra"):
        got, want = leaves(getattr(srv, field)), jax.tree.leaves(
            getattr(j_srv, field))
        assert len(got) == len(want), field
        for i, (a, b) in enumerate(zip(got, want)):
            _same_or_close(a, b, f"{field} leaf {i}", worst)
    j_st, st = j_out["state"], out["state"]
    for field in ("client_params", "grad_cache"):
        got, want = (leaves(to_numpy(getattr(st, field))),
                     jax.tree.leaves(getattr(j_st, field)))
        assert len(got) == len(want), field
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{field} leaf {i}", worst)
    np.testing.assert_array_equal(st.client_ts.numpy(),
                                  np.asarray(j_st.client_ts))
    if j_st.client_leaf_ts is None:
        assert st.client_leaf_ts is None
    else:
        np.testing.assert_array_equal(st.client_leaf_ts.numpy(),
                                      np.asarray(j_st.client_leaf_ts))
    if j_st.queue is None:
        assert st.queue is None
    else:
        for field in ("head", "size", "ts", "client", "enq_T", "leaf_ts"):
            want = getattr(j_st.queue, field)
            got = getattr(st.queue, field)
            assert (got is None) == (want is None), field
            if want is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=f"queue {field}")
        want = j_st.queue.enq_wall
        assert (st.queue.enq_wall is None) == (want is None)
        if want is not None:
            np.testing.assert_allclose(st.queue.enq_wall.numpy(),
                                       np.asarray(want), rtol=WALL_RTOL)
        for field in ("payload", "leaf_mask"):
            got = leaves(to_numpy(getattr(st.queue, field)))
            want = jax.tree.leaves(getattr(j_st.queue, field))
            assert len(got) == len(want), field
            for i, (a, b) in enumerate(zip(got, want)):
                _same_or_close(a, b, f"queue_{field} leaf {i}", worst)
    # `pytest -s` shows the parity reached (recorded in PERF.md)
    print(f"\nPARITY fred/{name} max|Δ| " + " ".join(
        f"{k}={v:.3e}" for k, v in sorted(worst.items())))

    launches = ops.LAUNCHES["fasgd_update"] + ops.LAUNCHES["fused_event_apply"]
    assert launches == out["counters"].get("kernel_launches", 0.0)
    kernel_on = (engine.fused_kernel_active(cfg.server)
                 if cfg.apply_mode == "fused" else
                 engine.serial_kernel_active(
                     cfg.server, bw.get("per_tensor_fetch", False)))
    if kernel_on:
        assert launches > 0
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_simulation_matches_reference(setup, name):
    check_against_reference(setup, name, CASES[name])


def test_serial_native_draws_are_k_invariant(setup):
    """Draws keyed by global event index: the serial trajectory does not
    depend on the window size."""
    params, ds = setup
    outs = []
    for k in (1, 5):
        cfg = SimConfig(num_clients=4, batch_size=8, seed=1,
                        events_per_step=k,
                        server=ServerConfig(rule="fasgd", lr=0.01))
        outs.append(run_simulation(
            cfg, nll_loss, params_from_numpy(params, device="cpu"), ds["x_train"],
            ds["y_train"], 12, eval_every=12, collect_step_metrics=True,
            device="cpu"))
    assert torch.equal(outs[0]["train_loss"], outs[1]["train_loss"])
    for a, b in zip(leaves(outs[0]["state"].server.params),
                    leaves(outs[1]["state"].server.params)):
        assert torch.equal(a, b)


def test_native_draws_depend_only_on_seed_and_event():
    rng = NativeDraws(seed=4, num_clients=8, batch_size=3, n_data=100)
    whole = rng.events(0, 10, "cpu")
    part = rng.events(6, 4, "cpu")
    for a, b in zip(whole.window(6, 10), part):
        assert torch.equal(a, b)
    other = NativeDraws(seed=5, num_clients=8, batch_size=3, n_data=100)
    assert not torch.equal(other.events(0, 10, "cpu").idx, whole.idx)


def test_heterogeneous_dispatch_follows_the_speed_logits():
    rng = NativeDraws(seed=2, num_clients=8, batch_size=1, n_data=10,
                      dispatcher="heterogeneous", het_skew=1.5)
    clients = rng.events(0, 4000, "cpu").clients
    share = torch.bincount(clients, minlength=8).float() / 4000
    assert torch.allclose(share, rng.probs, atol=0.03)
    assert share.max() > 2 * share.min()        # skewed, not uniform


def test_run_simulation_needs_a_device_without_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    params, ds = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_simulation(SimConfig(), nll_loss, params_from_numpy(params, device="cpu"),
                       ds["x_train"], ds["y_train"], 4)


ZEROS = [{"w": np.zeros((3, 2), np.float32), "b": np.zeros(2, np.float32)}]
ENTRY_POINTS = {
    "make_synth_mnist": lambda **kw: make_synth_mnist(
        n_train=8, n_valid=4, **kw),
    "init_mlp": lambda **kw: init_mlp(torch.Generator().manual_seed(0),
                                      (3, 2), **kw),
    "params_from_numpy": lambda **kw: params_from_numpy(ZEROS, **kw),
    "server_state_from_numpy": lambda **kw: server_state_from_numpy(
        ZEROS, 0, ZEROS, ZEROS, ZEROS, **kw),
    "init_counters": lambda **kw: init_counters(**kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_run_on_the_card_unless_asked(name):
    """Without `device=` an entry point puts its tensors on the card, and
    raises where there is none; ``device="cpu"`` puts them on the CPU."""
    make = ENTRY_POINTS[name]
    out = leaves(list(make(device="cpu")))
    assert out and all(t.device.type == "cpu" for t in out)
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in leaves(list(make())))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_port_native_data_and_init_match_the_reference_geometry():
    """The port's own generators: the reference's shapes and scales, and
    the same output for the same seed."""
    ds = make_synth_mnist(seed=3, n_train=256, n_valid=64, device="cpu")
    again = make_synth_mnist(seed=3, n_train=256, n_valid=64, device="cpu")
    assert ds.x_train.shape == (256, 784) and ds.x_valid.shape == (64, 784)
    assert ds.y_train.dtype == torch.int64
    assert int(ds.y_train.min()) >= 0 and int(ds.y_train.max()) <= 9
    assert all(torch.equal(a, b) for a, b in zip(ds, again))
    # feature std is the reference's 0.3 (means and noise both rescaled)
    assert abs(float(ds.x_train.std()) - 0.3) < 0.02
    params = init_mlp(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(l.shape) for l in leaves(params)] == [
        (200,), (784, 200), (10,), (200, 10)]
    w0 = params[0]["w"]
    assert abs(float(w0.std()) - (2.0 / 784) ** 0.5) < 2e-3
    loss = nll_loss(params, ds.x_valid, ds.y_valid)
    assert torch.isfinite(loss) and abs(float(loss) - np.log(10)) < 1.5


@pytest.mark.parametrize("kwargs", [
    # a sharded server is ported under the queue, the cotangent path and
    # scenarios alike; it needs a mesh whose server axis has its size
    dict(queue_capacity=4, scenario=scen.preset("stragglers"),
         server_shards=2),
    dict(scenario=scen.preset("dropout"), server_shards=2),
    dict(server_shards=2),
    dict(apply_mode="fused", fused_mode="cotangent",
         scenario=scen.preset("hotspot"), server_shards=2),
    dict(apply_mode="fused", server=ServerConfig(rule="sasgd"),
         queue_capacity=4, server_shards=2),
])
def test_unported_configurations_raise(setup, kwargs):
    """The configuration is accepted; a run without a server mesh of its
    size raises the reference's `ValueError`."""
    cfg = SimConfig(**kwargs)
    params, ds = setup
    with pytest.raises(ValueError, match="server_shards=2 requires a mesh"):
        run_simulation(cfg, nll_loss, params_from_numpy(params, device="cpu"),
                       ds["x_train"], ds["y_train"], 4, device="cpu")


SCENARIO_CONFIGS = {
    "async": dict(),
    "fused": dict(apply_mode="fused", events_per_step=4),
    "queued": dict(events_per_step=4, queue_capacity=8),
    "roundrobin": dict(dispatcher="roundrobin"),
    "heterogeneous": dict(dispatcher="heterogeneous"),
    "ssgd": dict(rule="ssgd", events_per_step=4),
    "ssgd_k2": dict(rule="ssgd", events_per_step=2),
    "kasync": dict(rule="kasync", events_per_step=4),
    "kasync_k8": dict(rule="kasync", events_per_step=8),
}


@pytest.mark.parametrize("preset", sorted(scen.SCENARIO_PRESETS))
@pytest.mark.parametrize("name", sorted(SCENARIO_CONFIGS))
def test_sim_config_takes_a_scenario_where_the_reference_does(name, preset):
    """Every preset with every dispatcher, apply mode, queue and barrier
    rule: the port accepts what the reference accepts and refuses the rest
    with its `ValueError` (a heterogeneous dispatcher; a barrier under
    churn or with a window other than λ)."""
    kw = dict(SCENARIO_CONFIGS[name])
    rule = kw.pop("rule", "asgd")
    server = dict(rule=rule, num_clients=4)
    j_scn, p_scn = scenario_configs(preset)
    try:
        JSimConfig(num_clients=4, server=JServerConfig(**server),
                   scenario=j_scn, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0][:30]):
            SimConfig(num_clients=4, server=ServerConfig(**server),
                      scenario=p_scn, **kw)
        return
    SimConfig(num_clients=4, server=ServerConfig(**server), scenario=p_scn,
              **kw)


def test_mesh_raises(setup):
    """A mesh without a server axis of ``server_shards`` devices is
    refused, as the reference refuses it."""
    params, ds = setup
    with pytest.raises(ValueError, match="axis size 0"):
        run_simulation(SimConfig(server_shards=2), nll_loss,
                       params_from_numpy(params, device="cpu"),
                       ds["x_train"], ds["y_train"], 4, mesh=object(),
                       device="cpu")


def test_per_tensor_gating_is_accepted():
    """The §5 switches that used to be refused: both directions, both drop
    policies, with the reference's derived properties."""
    for policy in ("cache", "skip"):
        bw = BandwidthConfig(c_push=0.05, c_fetch=0.2, drop_policy=policy,
                             per_tensor_push=True, per_tensor_fetch=True)
        j_bw = JBandwidthConfig(c_push=0.05, c_fetch=0.2, drop_policy=policy,
                                per_tensor_push=True, per_tensor_fetch=True)
        assert (bw.enabled, bw.per_tensor) == (j_bw.enabled,
                                               j_bw.per_tensor) == (True,
                                                                    True)
        SimConfig(bandwidth=bw)
    for kw in ({}, dict(per_tensor_fetch=True), dict(c_push=0.1)):
        assert BandwidthConfig(**kw).enabled == JBandwidthConfig(**kw).enabled
        assert (BandwidthConfig(**kw).per_tensor
                == JBandwidthConfig(**kw).per_tensor)


@pytest.mark.parametrize("rule,kwargs", [
    ("ssgd", dict(dispatcher="roundrobin",
                  bandwidth=BandwidthConfig(per_tensor_push=True))),
    ("kasync", dict(dispatcher="roundrobin",
                    bandwidth=BandwidthConfig(per_tensor_push=True))),
    ("ssgd", dict(dispatcher="uniform")),
    ("kasync", dict(dispatcher="heterogeneous")),
    ("ssgd", dict(dispatcher="roundrobin", apply_mode="fused",
                  events_per_step=4)),
    ("kasync", dict(dispatcher="roundrobin", apply_mode="fused",
                    events_per_step=4)),
])
def test_sim_config_refuses_what_the_reference_refuses(rule, kwargs):
    """A barrier rule with per-tensor push or without round-robin dispatch,
    and a rule without fused support in the fused mode, are refused by both
    packages."""
    server = dict(rule=rule, num_clients=4)
    j_kwargs = dict(kwargs)
    if "bandwidth" in j_kwargs:
        j_kwargs["bandwidth"] = JBandwidthConfig(per_tensor_push=True)
    with pytest.raises(AssertionError):
        JSimConfig(num_clients=4, server=JServerConfig(**server), **j_kwargs)
    with pytest.raises(ValueError):
        SimConfig(num_clients=4, server=ServerConfig(**server), **kwargs)
