"""The port's round trainer (`core.round_trainer`) against a live run of the
JAX reference.

Both packages start from the reference's 16-8-4 MLP and batch (C=4
clients, μ=8), and the port replays the round draws `jax.random` made from
each round's key (`ReplayRoundDraws`: the push and fetch uniforms of the C
clients, per leaf in a direction gated per tensor) and, under a scenario,
its service variates (`test_torch_fred.scenario_replay_of`).  The
reference runs its Pallas kernels in interpret mode; the port, on the CPU,
runs their plain versions.

Tolerances: ``round_idx``, ``client_ts``, ``client_leaf_ts``, T, the
counters (``wall_clock`` within rtol 1e-6), the queue's integer state and
the integer metrics exactly; θ, n, b, v, the rule's `extra`, the client
copies, the queued payloads and the float metrics within rtol 1e-4 / atol
1e-5, as FRED's parity tests hold them.  The reference's own properties
(tests/test_round_trainer.py, the round-trainer cases of
tests/test_queue.py and tests/test_scenarios.py) are held on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainerConfig as JTrainerConfig
from repro.core import round_trainer as jrt
from repro.core.engine import init_counters as j_init_counters
from repro.models.mlp import init_mlp as j_init_mlp
from repro.models.mlp import nll_loss as j_nll_loss
from repro.models.mlp import nll_loss_event_batched as j_nll_batched

from repro_torch.configs.base import TrainerConfig
from repro_torch.core import round_trainer as rt
from repro_torch.core import rules as server_rules
from repro_torch.core import scenarios as scen
from repro_torch.kernels import ops
from repro_torch.models.mlp import nll_loss, nll_loss_event_batched
from repro_torch.utils.convert import (counters_from_numpy,
                                       params_from_numpy,
                                       round_state_from_numpy, to_numpy)
from repro_torch.utils.rng import NativeRoundDraws, ReplayRoundDraws
from repro_torch.utils.trees import leaves

from test_torch_fred import (RTOL, ATOL, WALL_RTOL, one_thread,  # noqa: F401
                             scenario_configs, scenario_replay_of)
from test_torch_scenarios import unstable_ties  # noqa: F401

C, MU, N_LEAVES = 4, 8, 4


@pytest.fixture(scope="module")
def setup():
    params = jax.tree.map(np.array, j_init_mlp(jax.random.PRNGKey(0),
                                               (16, 8, 4)))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (C, MU, 16)))
    y = np.array(jax.random.randint(jax.random.PRNGKey(2), (C, MU), 0, 4))
    return params, x, y


def j_grad_fn(p, batch):
    return jax.value_and_grad(j_nll_loss)(p, batch[0], batch[1])


def round_replay(keys, c, per_tensor_push, per_tensor_fetch):
    """The gate uniforms the reference draws from each round's key: one
    uniform per client from ``uniform(k, (C,))``, or per leaf from each
    client's key split per leaf, as `round_trainer.round_step` and
    `engine.per_tensor_gate` key them."""
    per_leaf = jax.vmap(lambda kc: jax.vmap(jax.random.uniform)(
        jax.random.split(kc, N_LEAVES)))
    push, fetch = [], []
    for key in keys:
        k_push, k_fetch = jax.random.split(key)
        for out, k, pt in ((push, k_push, per_tensor_push),
                           (fetch, k_fetch, per_tensor_fetch)):
            out.append(per_leaf(jax.random.split(k, c)) if pt
                       else jax.random.uniform(k, (c,)))
    return ReplayRoundDraws(np.stack(push), np.stack(fetch), device="cpu")


def _j_batched(W, d, b):
    return j_nll_batched(W, d, b[0], b[1])


def _batched(W, d, b):
    return nll_loss_event_batched(W, d, b[0], b[1])


class Pair:
    """One configuration in both packages, stepped round by round with the
    same params, batch and draws."""

    def __init__(self, setup, kw, apply_mode="serial", rounds=5, c=C,
                 via=None):
        params, x, y = setup
        kw = dict(kw)
        j_scn = p_scn = None
        if kw.get("scenario") is not None:
            j_scn, p_scn = scenario_configs(kw.pop("scenario"))
        self.j_tc = JTrainerConfig(num_round_clients=c, kernel_interpret=True,
                                   scenario=j_scn, **kw)
        self.tc = TrainerConfig(num_round_clients=c, scenario=p_scn, **kw)
        self.c, self.rounds = c, rounds
        self.batch = (torch.as_tensor(x[:c]), torch.as_tensor(y[:c]).long())
        self.j_batch = (jnp.asarray(x[:c]), jnp.asarray(y[:c]))
        j_gf, gf = j_grad_fn, rt.make_grad_fn(nll_loss)
        j_kw, p_kw = {}, {}
        if via == "argument":
            j_kw, p_kw = (dict(batched_loss_fn=_j_batched),
                          dict(batched_loss_fn=_batched))
        elif via == "attached":
            j_gf = lambda p, b: j_grad_fn(p, b)
            j_gf.event_batched = j_nll_batched
            gf = rt.make_grad_fn(nll_loss)
            gf.event_batched = nll_loss_event_batched
        scn_rng = (scenario_replay_of(j_scn, c, rounds + 8, 1)
                   if j_scn is not None else None)
        self.j_step = jax.jit(jrt.build_round_step(
            self.j_tc, j_gf, apply_mode=apply_mode, **j_kw))
        self.step = rt.build_round_step(self.tc, gf, apply_mode=apply_mode,
                                        scenario_draws=scn_rng, **p_kw)
        self.keys = [jax.random.PRNGKey(100 + r) for r in range(rounds)]
        self.draws = round_replay(self.keys, c, self.tc.per_tensor_push,
                                  self.tc.per_tensor_fetch)
        self.j_state = jrt.init_round_state(self.j_tc, params)
        self.state = rt.init_round_state(
            self.tc, params_from_numpy(params, "cpu"), device="cpu")

    def run(self, rounds=None, first=0):
        """Step both `rounds` rounds from round `first`; compare the
        metrics each round and the states at the end."""
        for r in range(first, first + (rounds or self.rounds)):
            self.j_state, j_m = self.j_step(self.j_state, self.j_batch,
                                            self.keys[r])
            self.state, m = self.step(self.state, self.batch,
                                      self.draws.round(r))
            compare_metrics(m, j_m)
        compare_states(self.state, self.j_state)
        return self


def compare_metrics(got, want):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k].detach().cpu().numpy()
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k in ("wall", "round_dt"):
            np.testing.assert_allclose(g, w, rtol=WALL_RTOL, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)


def _leaves_close(got, want, what):
    got, want = leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        if np.issubdtype(b.dtype, np.integer) or b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} leaf {i}")


def compare_states(st, j_st):
    """Every field of the round state: integers exactly, floats within
    tolerance, the modelled wall clock within WALL_RTOL."""
    for field in ("params", "n", "b", "v", "extra"):
        _leaves_close(getattr(st.server, field), getattr(j_st.server, field),
                      field)
    assert int(st.server.timestamp) == int(j_st.server.timestamp)
    _leaves_close(st.client_params, j_st.client_params, "client_params")
    for field in ("client_ts", "round_idx", "client_leaf_ts"):
        got, want = getattr(st, field), getattr(j_st, field)
        assert (got is None) == (want is None), field
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=field)
    j_c = {k: float(v) for k, v in j_st.counters._asdict().items()}
    c = {k: float(v) for k, v in st.counters._asdict().items()}
    assert sorted(c) == sorted(j_c)
    for k, v in c.items():
        if k == "wall_clock":
            np.testing.assert_allclose(v, j_c[k], rtol=WALL_RTOL)
        else:
            assert v == j_c[k], (k, v, j_c[k])
    assert (st.queue is None) == (j_st.queue is None)
    if st.queue is not None:
        for field in ("head", "size", "ts", "client", "enq_T", "leaf_ts"):
            got, want = getattr(st.queue, field), getattr(j_st.queue, field)
            assert (got is None) == (want is None), field
            if want is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=f"queue {field}")
        _leaves_close(st.queue.payload, j_st.queue.payload, "queue payload")
        _leaves_close(st.queue.leaf_mask, j_st.queue.leaf_mask,
                      "queue leaf_mask")


GATED = dict(c_push=1.0, c_fetch=2.0)
CASES = {
    # serial and fused fasgd, the kernel off and on
    "serial_fasgd": ("serial", dict(rule="fasgd", lr=0.02, **GATED)),
    "serial_fasgd_kernel": ("serial", dict(rule="fasgd", lr=0.02,
                                           use_fused_kernel=True, **GATED)),
    "fused_fasgd": ("fused", dict(rule="fasgd", lr=0.02, **GATED)),
    "fused_fasgd_kernel": ("fused", dict(rule="fasgd", lr=0.02,
                                         use_fused_kernel=True, **GATED)),
    # the drop policies, gated
    "serial_local_apply": ("serial", dict(rule="fasgd", lr=0.02,
                                          c_push=2.0, c_fetch=2.0,
                                          drop_policy="local_apply")),
    "fused_discard": ("fused", dict(rule="asgd", lr=0.02, c_push=2.0,
                                    c_fetch=2.0, drop_policy="discard")),
    # per-tensor push and fetch
    "serial_per_tensor": ("serial", dict(
        rule="fasgd", lr=0.02, per_tensor_push=True, per_tensor_fetch=True,
        use_fused_kernel=True, **GATED)),
    "serial_per_tensor_push": ("serial", dict(
        rule="fasgd", lr=0.02, per_tensor_push=True, use_fused_kernel=True,
        **GATED)),
    "fused_per_tensor": ("fused", dict(
        rule="fasgd", lr=0.02, per_tensor_push=True, per_tensor_fetch=True,
        use_fused_kernel=True, **GATED)),
    # the other rules
    "serial_gap": ("serial", dict(rule="gap", lr=0.05, c_fetch=2.0)),
    "fused_gap": ("fused", dict(rule="gap", lr=0.05, c_fetch=2.0)),
    "serial_ssgd": ("serial", dict(rule="ssgd", lr=0.05, c_fetch=2.0)),
    "serial_kasync": ("serial", dict(rule="kasync", kasync_k=3, lr=0.05,
                                     c_fetch=2.0)),
    "fused_exp": ("fused", dict(rule="exp", lr=0.02, **GATED)),
    "serial_poly": ("serial", dict(rule="poly", lr=0.02, **GATED)),
    # the ingress queue
    "queue_block_drain_all_serial": ("serial", dict(
        rule="fasgd", lr=0.01, queue_capacity=4, use_fused_kernel=True,
        c_fetch=2.0)),
    "queue_block_drain_all_fused": ("fused", dict(
        rule="fasgd", lr=0.01, queue_capacity=6, use_fused_kernel=True,
        c_fetch=2.0)),
    "queue_reject_drain_k_serial": ("serial", dict(
        rule="fasgd", lr=0.01, queue_capacity=3, drain_policy="drain_k",
        drain_k=2, admission_policy="reject", c_fetch=1.0)),
    "queue_reject_drain_k_fused": ("fused", dict(
        rule="asgd", lr=0.01, queue_capacity=3, drain_policy="drain_k",
        drain_k=2, admission_policy="reject", c_fetch=1.0)),
    "queue_drop_oldest_adaptive_fused": ("fused", dict(
        rule="fasgd", lr=0.01, queue_capacity=5, drain_policy="adaptive",
        drain_k=1, drain_adaptive_gain=0.6, admission_policy="drop_oldest",
        use_fused_kernel=True, c_fetch=1.0)),
    "queue_per_tensor_serial": ("serial", dict(
        rule="fasgd", lr=0.01, queue_capacity=3, drain_policy="drain_k",
        drain_k=2, admission_policy="reject", per_tensor_push=True,
        per_tensor_fetch=True, **GATED)),
    "queue_per_tensor_fused": ("fused", dict(
        rule="fasgd", lr=0.01, queue_capacity=5, drain_policy="adaptive",
        drain_adaptive_gain=0.6, admission_policy="drop_oldest",
        per_tensor_push=True, per_tensor_fetch=True, use_fused_kernel=True,
        **GATED)),
    "queue_gap_serial": ("serial", dict(
        rule="gap", lr=0.05, queue_capacity=3, drain_policy="drain_k",
        drain_k=2, admission_policy="reject", c_fetch=1.0)),
    # scenario-lite
    "scenario_kasync": ("serial", dict(rule="kasync", kasync_k=2, lr=0.05,
                                       c_fetch=2.0, scenario="stragglers")),
    "scenario_fasgd_serial": ("serial", dict(
        rule="fasgd", lr=0.02, use_fused_kernel=True, scenario="stragglers",
        **GATED)),
    "scenario_fasgd_fused": ("fused", dict(
        rule="fasgd", lr=0.02, use_fused_kernel=True, scenario="hotspot",
        **GATED)),
    # arrival order against client order: 'reject' below C admits the
    # fastest arrivals
    "scenario_queue_reject": ("serial", dict(
        rule="fasgd", lr=0.01, queue_capacity=3, drain_policy="drain_k",
        drain_k=2, admission_policy="reject", scenario="stragglers",
        per_tensor_push=True, **GATED)),
    "scenario_fixed_ties": ("serial", dict(
        rule="kasync", kasync_k=2, lr=0.05, c_fetch=2.0,
        scenario=dict(service="fixed", straggler_frac=0.25,
                      straggler_slowdown=2.0))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_step_matches_reference(setup, name, unstable_ties):
    mode, kw = CASES[name]
    ops.reset_launches()
    pair = Pair(setup, kw, mode).run()
    # the kernel counters count the port's own leaf dispatches
    launches = ops.LAUNCHES["fasgd_update"] + ops.LAUNCHES["fused_event_apply"]
    assert launches == int(pair.state.counters.kernel_launches)
    if kw.get("use_fused_kernel") and not kw.get("per_tensor_fetch"):
        assert launches > 0


@pytest.mark.parametrize("name,via,rule,mode", [
    ("sasgd_auto_argument", "argument", "sasgd", "auto"),
    ("sasgd_auto_attached", "attached", "sasgd", "auto"),
    ("fasgd_cotangent_argument", "argument", "fasgd", "cotangent"),
    ("fasgd_cotangent_attached", "attached", "fasgd", "cotangent"),
])
def test_cotangent_round_matches_reference(setup, name, via, rule, mode,
                                           monkeypatch):
    """The cotangent path through both sources of the batched loss; every
    round goes through `fused_apply_cotangent`."""
    calls = []
    real = rt.engine.fused_apply_cotangent
    monkeypatch.setattr(rt.engine, "fused_apply_cotangent",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(rule=rule, lr=0.02, drop_policy="discard", fused_mode=mode,
              c_push=1.0, c_fetch=1.5)
    Pair(setup, kw, "fused", rounds=4, via=via).run()
    assert len(calls) == 4


def test_auto_without_a_batched_loss_stays_materialized(setup):
    kw = dict(rule="sasgd", lr=0.02, drop_policy="discard", c_fetch=1.5)
    auto = Pair(setup, kw, "fused", rounds=3).run()
    mat = Pair(setup, dict(kw, fused_mode="materialized"), "fused",
               rounds=3).run()
    for a, b in zip(leaves(auto.state.server.params),
                    leaves(mat.state.server.params)):
        assert torch.equal(a, b)


def test_mid_run_state_carried_across(setup):
    """A reference run stopped after 3 rounds (divergent copies, per-leaf
    timestamps, a loaded queue) continues in the port from its state
    (`round_state_from_numpy`) as it does in the reference."""
    kw = dict(rule="fasgd", lr=0.01, queue_capacity=3, drain_policy="drain_k",
              drain_k=2, admission_policy="reject", per_tensor_fetch=True,
              c_fetch=3.0)
    pair = Pair(setup, kw, "serial", rounds=6)
    for r in range(3):
        pair.j_state, _ = pair.j_step(pair.j_state, pair.j_batch,
                                      pair.keys[r])
    carried = round_state_from_numpy(jax.tree.map(np.asarray, pair.j_state),
                                     device="cpu")
    assert int(carried.queue.size) > 0
    assert int(carried.client_ts.min()) < int(carried.server.timestamp)
    pair.state = carried
    pair.run(rounds=3, first=3)


def test_counters_carry_across_only_without_shard_telemetry():
    """The reference's counters cross whole, its ``shard_*`` fields
    included (the port keeps them since it shards the server)."""
    j_c = jax.tree.map(np.asarray, j_init_counters()._replace(
        push_actual=jnp.int32(3), wall_clock=jnp.float32(2.5)))
    c = counters_from_numpy(j_c, device="cpu")
    assert int(c.push_actual) == 3 and float(c.wall_clock) == 2.5
    assert c.push_actual.dtype == torch.int32
    c = counters_from_numpy(j_c._replace(shard_applies=np.int32(1)), "cpu")
    assert int(c.shard_applies) == 1
    assert c.shard_applies.dtype == torch.int32


# ---------------------------------------------------------------------------
# the reference's properties, on the port
# ---------------------------------------------------------------------------

def _port(setup, kw, mode="serial", c=C, rounds=4, seed=0):
    params, x, y = setup
    tc = TrainerConfig(num_round_clients=c, **kw)
    p = params_from_numpy(params, "cpu")
    st = rt.init_round_state(tc, p, device="cpu")
    step = rt.build_round_step(tc, rt.make_grad_fn(nll_loss),
                               apply_mode=mode)
    draws = NativeRoundDraws(seed, c, N_LEAVES, tc.per_tensor_push,
                             tc.per_tensor_fetch, device="cpu")
    batch = (torch.as_tensor(x[:c]), torch.as_tensor(y[:c]).long())
    m = None
    for r in range(rounds):
        st, m = step(st, batch, draws.round(st.round_idx))
    return st, m, p, batch


def test_serial_matches_lock_protocol(setup):
    """All pushes, serial: the C gradients applied one at a time through
    `rules.apply_update` in client order."""
    tc = TrainerConfig(num_round_clients=C, rule="fasgd", lr=0.02)
    st, _, p, batch = _port(setup, dict(rule="fasgd", lr=0.02), rounds=1)
    scfg = rt.server_config(tc)
    server = server_rules.init(scfg, p)
    grad = torch.func.grad(nll_loss)
    for c in range(C):
        g = grad(p, batch[0][c], batch[1][c])
        server, _ = server_rules.apply_update(
            scfg, server, g, torch.tensor(0, dtype=torch.int32))
    for a, b in zip(leaves(st.server.params), leaves(server.params)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert int(st.server.timestamp) == C


def test_fetch_all_means_no_divergence(setup):
    st, _, _, _ = _port(setup, dict(rule="fasgd", lr=0.02), rounds=3)
    for cl, sp in zip(leaves(st.client_params), leaves(st.server.params)):
        for c in range(C):
            assert torch.equal(cl[c], sp)
    assert bool((st.client_ts == st.server.timestamp).all())


FUSED_RULES = tuple(r for r in server_rules.registered_rules()
                    if server_rules.get_rule(r).supports_fused)


@pytest.mark.parametrize("rule", FUSED_RULES)
def test_fused_equals_serial_for_one_client(setup, rule):
    kw = dict(rule=rule, lr=0.02, c_fetch=50.0)
    s1, _, _, _ = _port(setup, kw, "serial", c=1, rounds=5)
    s2, _, _, _ = _port(setup, kw, "fused", c=1, rounds=5)
    for a, b in zip(leaves(s1.server.params), leaves(s2.server.params)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    assert int(s1.server.timestamp) == int(s2.server.timestamp)


def test_kasync_at_k_c_is_ssgd_bitwise(setup):
    sa, _, _, _ = _port(setup, dict(rule="kasync", lr=0.05, c_fetch=2.0))
    sb, _, _, _ = _port(setup, dict(rule="ssgd", lr=0.05, c_fetch=2.0))
    for a, b in zip(leaves(sa.server.params), leaves(sb.server.params)):
        assert torch.equal(a, b)
    assert int(sa.server.timestamp) == int(sb.server.timestamp)


@pytest.mark.parametrize("mode", ["serial", "fused"])
def test_capacity_one_drain_all_is_the_unqueued_round_bitwise(setup, mode):
    kw = dict(rule="fasgd", lr=0.01, c_fetch=2.0)
    base, _, _, _ = _port(setup, kw, mode, c=1, rounds=6)
    queued, m, _, _ = _port(setup, dict(kw, queue_capacity=1), mode, c=1,
                            rounds=6)
    for a, b in zip(leaves(base.server), leaves(queued.server)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(base.client_params), leaves(queued.client_params)):
        assert torch.equal(a, b)
    assert int(queued.counters.queue_rejected) == 0
    assert int(m["queue_depth"]) == 0


def test_loaded_queue_accounts_every_event(setup):
    st, m, _, _ = _port(setup, dict(
        rule="fasgd", lr=0.01, queue_capacity=6, drain_policy="drain_k",
        drain_k=2, admission_policy="reject"), "fused", rounds=8)
    c = st.counters
    assert int(c.queue_rejected) > 0
    assert int(c.push_actual) == int(c.queue_enqueued)
    assert int(c.queue_enqueued) - int(c.queue_drained) == int(st.queue.size)
    assert int(c.queue_depth_peak) == 6
    assert float(m["mean_tau"]) > 1.0


@pytest.mark.parametrize("rule,kw", [("kasync", dict(kasync_k=2)),
                                     ("fasgd", {})])
def test_scenario_wall_is_the_round_order_statistic(setup, rule, kw):
    """The wall clock sums each round's k-th order statistic of the
    native service draws (k = K for kasync, C for an async rule)."""
    cfg = scen.preset("stragglers")
    st, m, _, _ = _port(setup, dict(rule=rule, scenario=cfg, **kw),
                        rounds=4)
    k = kw.get("kasync_k", C)
    want = sum(float(torch.sort(scen.round_service_times(
        cfg, C, r, device="cpu")).values[k - 1]) for r in range(4))
    assert float(st.counters.wall_clock) == pytest.approx(want, rel=1e-6)
    assert float(m["wall"]) == pytest.approx(want, rel=1e-6)
    assert int(st.counters.scenario_windows) == 4


def test_native_round_draws_are_counter_based():
    d = NativeRoundDraws(5, 8, 4, per_tensor_push=True, device="cpu")
    a = d.round(3)
    assert a.push_u.shape == (8, 4) and a.fetch_u.shape == (8,)
    b = d.round(torch.tensor(3, dtype=torch.int32))
    assert torch.equal(a.push_u, b.push_u)
    assert torch.equal(a.fetch_u, b.fetch_u)
    assert not torch.equal(d.round(4).fetch_u, a.fetch_u)
    # whole-copy lanes do not move when the other direction goes per tensor
    assert torch.equal(NativeRoundDraws(5, 8, device="cpu").round(3).fetch_u,
                       a.fetch_u)
    with pytest.raises(ValueError):
        NativeRoundDraws(5, 8, per_tensor_fetch=True, device="cpu")


def test_bandwidth_saved_bytes_matches_reference(setup):
    params = setup[0]
    kw = dict(num_rounds=10, push_rate=0.25, fetch_rate=0.5)
    assert (rt.bandwidth_saved_bytes(TrainerConfig(), params_from_numpy(
        params, "cpu"), **kw) == jrt.bandwidth_saved_bytes(
        JTrainerConfig(), params, **kw))


@pytest.mark.parametrize("make", [
    lambda setup, **kw: rt.init_round_state(
        TrainerConfig(queue_capacity=4, per_tensor_fetch=True),
        params_from_numpy(setup[0], "cpu"), **kw),
    lambda setup, **kw: NativeRoundDraws(0, 4, **kw).round(0),
], ids=["init_round_state", "NativeRoundDraws"])
def test_entry_points_run_on_the_card_unless_asked(setup, make):
    out = leaves(list(make(setup, device="cpu")))
    assert out and all(t.device.type == "cpu" for t in out)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(setup)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

REFUSED = {
    "sync_rule_with_queue": (dict(rule="ssgd", queue_capacity=4), {},
                             "synchronous rule"),
    "block_below_c": (dict(num_round_clients=8, queue_capacity=4), {},
                      "num_round_clients"),
    "cotangent_with_queue": (dict(queue_capacity=8, rule="asgd",
                                  drop_policy="discard",
                                  fused_mode="cotangent"),
                             dict(apply_mode="fused"), "cotangent"),
    "unknown_drain_policy": (dict(queue_capacity=4, drain_policy="nope"), {},
                             "unknown drain_policy"),
    "unknown_admission": (dict(queue_capacity=4, admission_policy="nope"),
                          {}, "unknown admission_policy"),
    "negative_capacity": (dict(queue_capacity=-1), {}, "queue_capacity"),
    "drain_k_zero": (dict(queue_capacity=4, drain_k=0,
                          admission_policy="reject",
                          drain_policy="drain_k"), {}, "drain_k"),
    "adaptive_gain": (dict(queue_capacity=4, drain_policy="adaptive",
                           drain_adaptive_gain=1.5,
                           admission_policy="reject"), {},
                      "drain_adaptive_gain"),
    "block_without_drain_all": (dict(queue_capacity=4,
                                     drain_policy="drain_k"), {},
                                "lossless backpressure"),
    "dropout_scenario": (dict(scenario="dropout"), {}, "FRED-only"),
    "elastic_scenario": (dict(scenario="elastic"), {}, "FRED-only"),
    "cotangent_local_apply": (dict(rule="sasgd", drop_policy="local_apply",
                                   fused_mode="cotangent"),
                              dict(apply_mode="fused", batched=True),
                              "cotangent"),
    "cotangent_serial": (dict(rule="sasgd", drop_policy="discard",
                              fused_mode="cotangent"),
                         dict(batched=True), "cotangent"),
    "server_shards_zero": (dict(server_shards=0), {}, "server_shards"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_match_reference(name):
    kw, build, match = REFUSED[name]
    kw, build = dict(kw), dict(build)
    j_kw, p_kw = dict(kw), dict(kw)
    if "scenario" in kw:
        j_kw["scenario"], p_kw["scenario"] = scenario_configs(kw["scenario"])
    j_b, p_b = dict(build), dict(build)
    if build.pop("batched", False):
        j_b.pop("batched"), p_b.pop("batched")
        j_b["batched_loss_fn"], p_b["batched_loss_fn"] = _j_batched, _batched
    with pytest.raises(ValueError, match=match):
        jrt.build_round_step(JTrainerConfig(**j_kw), j_grad_fn, **j_b)
    with pytest.raises(ValueError, match=match):
        rt.build_round_step(TrainerConfig(**p_kw), rt.make_grad_fn(nll_loss),
                            **p_b)


def test_fused_barrier_rule_raises_on_its_round(setup):
    tc = TrainerConfig(num_round_clients=C, rule="ssgd")
    params, x, y = setup
    st = rt.init_round_state(tc, params_from_numpy(params, "cpu"), "cpu")
    step = rt.build_round_step(tc, rt.make_grad_fn(nll_loss), "fused")
    with pytest.raises(ValueError, match="fused"):
        step(st, (torch.as_tensor(x), torch.as_tensor(y).long()),
             NativeRoundDraws(0, C, device="cpu").round(0))


def test_sharded_server_is_not_ported(setup):
    """A sharded server is ported now: ``server_shards=2`` builds, and
    `shard_round_state` places nothing for no mesh or a server axis of one
    device, and places the server over a larger one
    (`tests/test_torch_server_shard.py` holds the runs)."""
    from repro_torch.core import server_shard
    from repro_torch.launch.mesh import make_server_mesh
    rt.build_round_step(TrainerConfig(server_shards=2),
                        rt.make_grad_fn(nll_loss))
    st = rt.init_round_state(TrainerConfig(),
                             params_from_numpy(setup[0], "cpu"), "cpu")
    cpu = torch.device("cpu")
    assert rt.shard_round_state(st, None).server is st.server
    assert rt.shard_round_state(
        st, make_server_mesh(server=1, devices=[cpu])).server is st.server
    placed = rt.shard_round_state(
        st, make_server_mesh(server=2, devices=[cpu] * 2))
    assert server_shard.is_sharded(placed.server)
    assert placed.client_params is st.client_params


def test_trainer_config_has_the_reference_fields():
    got = {f.name: f.default for f in dataclasses.fields(TrainerConfig)}
    want = {f.name: f.default for f in dataclasses.fields(JTrainerConfig)}
    assert got == want
