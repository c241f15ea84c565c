"""The bounded server ingress queue in the port, against a live run of the
JAX reference: the ring (`core.queue`) and FRED's queued protocol.

The ring cases are those of tests/test_queue.py, each run through both
packages, which must agree exactly (head, size, every slot, the admitted
mask and the rejected/dropped counts) as well as on the values stated.
FRED runs replay the reference's draws (`test_torch_fred.replay_of`: every
gate of a queued window from its event's key).  Tolerances as in
tests/test_torch_fred.py: τ, T, every counter (the `queue_*` ones too),
client timestamps and the ring's indices, timestamps and clients exactly;
losses, parameters, statistics and the queued payloads within rtol 1e-4 /
atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queue as jqlib
from repro.core.bandwidth import BandwidthConfig as JBandwidthConfig
from repro.core.rules import ServerConfig as JServerConfig
from repro.sim.fred import SimConfig as JSimConfig

from repro_torch.core import queue as qlib
from repro_torch.core.bandwidth import BandwidthConfig
from repro_torch.core.rules import ServerConfig
from repro_torch.models.mlp import nll_loss
from repro_torch.sim.fred import SimConfig, run_simulation
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import leaves

from test_torch_fred import (check_against_reference, one_thread,  # noqa: F401
                             setup)

LEAF_LIKE = {"a": 0.0, "b": 0.0}        # a two-leaf tree for per-leaf masks


class Rings:
    """The same ring in both packages, driven op by op and compared after
    each (every field exactly; the payload is exact too: it is only
    copied)."""

    def __init__(self, cap, per_leaf=False):
        self.per_leaf = per_leaf
        kw = dict(n_leaves=2, mask_like=LEAF_LIKE) if per_leaf else {}
        self.j = jqlib.init_queue(cap, {"x": jnp.zeros((), jnp.float32)},
                                  **kw)
        self.t = qlib.init_queue(cap, {"x": torch.zeros(())}, **kw)

    def enqueue(self, vals, policy, T=0, valid=None, seed=0):
        k = len(vals)
        rng = np.random.default_rng(seed)
        valid = np.ones(k, bool) if valid is None else np.asarray(valid)
        ts = rng.integers(0, 9, k).astype(np.int32)
        clients = np.arange(k, dtype=np.int32)
        extra = {}
        if self.per_leaf:
            extra = dict(leaf_ts=rng.integers(0, 9, (k, 2)).astype(np.int32),
                         leaf_mask={n: rng.random(k) < 0.5 for n in "ab"})
        j_arr = jqlib.Arrivals(
            payload={"x": jnp.asarray(vals, jnp.float32)},
            ts=jnp.asarray(ts), client=jnp.asarray(clients),
            valid=jnp.asarray(valid),
            **{n: jax.tree.map(jnp.asarray, v) for n, v in extra.items()})
        t_arr = qlib.Arrivals(
            payload={"x": torch.tensor(vals, dtype=torch.float32)},
            ts=torch.from_numpy(ts), client=torch.from_numpy(clients).long(),
            valid=torch.from_numpy(valid),
            **{n: (torch.from_numpy(v) if n == "leaf_ts" else
                   {m: torch.from_numpy(b) for m, b in v.items()})
               for n, v in extra.items()})
        self.j, jadm, jrej, jdrop = jqlib.enqueue(self.j, j_arr, policy, T)
        self.t, adm, rej, drop = qlib.enqueue(
            self.t, t_arr, policy, torch.tensor(T, dtype=torch.int32))
        np.testing.assert_array_equal(adm.numpy(), np.asarray(jadm))
        assert (int(rej), int(drop)) == (int(jrej), int(jdrop))
        self.check()
        return adm.numpy(), int(rej), int(drop)

    def dequeue(self, k):
        self.j, jb = jqlib.dequeue(self.j, jnp.int32(k))
        self.t, b = qlib.dequeue(self.t, torch.tensor(k, dtype=torch.int32))
        for field in ("ts", "client", "enq_T", "valid", "leaf_ts"):
            got, want = getattr(b, field), getattr(jb, field)
            if want is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=field)
        np.testing.assert_array_equal(b.payload["x"].numpy(),
                                      np.asarray(jb.payload["x"]))
        self.check()
        return b

    def drain_all(self):
        b = self.dequeue(int(self.t.size))
        return b.payload["x"].numpy()[b.valid.numpy()]

    def check(self):
        for field in ("head", "size", "ts", "client", "enq_T", "leaf_ts"):
            want = getattr(self.j, field)
            if want is not None:
                np.testing.assert_array_equal(
                    getattr(self.t, field).numpy(), np.asarray(want),
                    err_msg=field)
        np.testing.assert_array_equal(self.t.payload["x"].numpy(),
                                      np.asarray(self.j.payload["x"]))
        if self.per_leaf:
            for n in "ab":
                np.testing.assert_array_equal(
                    self.t.leaf_mask[n].numpy(),
                    np.asarray(self.j.leaf_mask[n]))


def test_ring_fifo_order_and_wraparound():
    q = Rings(4)
    adm, rej, drop = q.enqueue([1, 2, 3], "reject")
    assert adm.all() and rej == 0 and drop == 0
    b = q.dequeue(2)                       # pops 1, 2; head wraps later
    np.testing.assert_array_equal(b.payload["x"].numpy()[b.valid.numpy()],
                                  [1, 2])
    adm, _, _ = q.enqueue([4, 5, 6], "reject")
    assert adm.all() and int(q.t.size) == 4
    np.testing.assert_array_equal(q.drain_all(), [3, 4, 5, 6])


def test_invalid_arrivals_never_enqueue():
    q = Rings(4)
    adm, rej, _ = q.enqueue([1, 2, 3, 4], "reject",
                            valid=[True, False, True, False])
    np.testing.assert_array_equal(adm, [True, False, True, False])
    assert rej == 0 and int(q.t.size) == 2
    np.testing.assert_array_equal(q.drain_all(), [1, 3])


@pytest.mark.parametrize("policy", ["reject", "block"])
def test_reject_admits_in_arrival_order(policy):
    q = Rings(2)
    adm, rej, drop = q.enqueue([1, 2, 3, 4], policy)
    np.testing.assert_array_equal(adm, [True, True, False, False])
    assert rej == 2 and drop == 0 and int(q.t.size) == 2
    np.testing.assert_array_equal(q.drain_all(), [1, 2])


def test_drop_oldest_evicts_head():
    q = Rings(3)
    q.enqueue([1, 2, 3], "drop_oldest")
    adm, rej, drop = q.enqueue([4, 5], "drop_oldest")
    assert adm.all() and rej == 0 and drop == 2
    np.testing.assert_array_equal(q.drain_all(), [3, 4, 5])


def test_drop_oldest_window_beyond_capacity_keeps_newest():
    q = Rings(2)
    adm, rej, drop = q.enqueue([1, 2, 3, 4, 5], "drop_oldest")
    assert adm.all()                 # all transmitted (then partly evicted)
    assert drop == 3 and int(q.t.size) == 2
    np.testing.assert_array_equal(q.drain_all(), [4, 5])


def test_enqueue_stamps_admission_timestamp():
    q = Rings(3)
    q.enqueue([1], "reject", T=7)
    q.enqueue([2], "reject", T=9)
    b = q.dequeue(int(q.t.size))
    np.testing.assert_array_equal(b.enq_T.numpy()[b.valid.numpy()], [7, 9])


@pytest.mark.parametrize("policy", ["reject", "drop_oldest"])
def test_random_ring_sequences_match_reference(policy):
    """Thirty windows of random arrivals (invalid rows, per-leaf timestamps
    and masks) and drains, both packages in step."""
    rng = np.random.default_rng(5)
    q = Rings(5, per_leaf=True)
    for w in range(30):
        k = int(rng.integers(1, 8))
        q.enqueue(rng.standard_normal(k).astype(np.float32).tolist(), policy,
                  T=w, valid=rng.random(k) < 0.7, seed=w)
        q.dequeue(int(rng.integers(0, int(q.t.size) + 1)))
    b = q.dequeue(int(q.t.size))
    for n in "ab":
        want = jqlib.drained_push_arg(
            jqlib.Drained(payload=None, ts=None, client=None, enq_T=None,
                          valid=jnp.asarray(b.valid.numpy()),
                          leaf_mask=jax.tree.map(
                              lambda m: jnp.asarray(m.numpy()),
                              b.leaf_mask)), True)[n]
        got = qlib.drained_push_arg(b, True)[n]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert qlib.drained_push_arg(b, False) is b.valid


def test_drain_count_policies():
    """The reference's cases and a grid against it; 'adaptive' rounds in
    float32 (gain 0.6 at depth 25 drains 16, not Python's ceil(15.0))."""
    dc = lambda size, *a, **kw: int(qlib.drain_count(
        torch.tensor(size, dtype=torch.int32), *a, **kw))
    assert dc(10, "drain_all") == 10
    assert dc(10, "drain_k", drain_k=3) == 3
    assert dc(2, "drain_k", drain_k=3) == 2
    assert dc(10, "adaptive", drain_k=1, gain=0.5) == 5
    assert dc(3, "adaptive", drain_k=1, gain=0.5) == 2
    assert dc(1, "adaptive", drain_k=4, gain=0.1) == 1       # capped at size
    assert dc(9, "adaptive", drain_k=4, gain=0.1) == 4       # floor wins
    assert dc(0, "adaptive", drain_k=2, gain=0.5) == 0
    assert dc(25, "adaptive", drain_k=1, gain=0.6) == 16
    assert dc(50, "adaptive", drain_k=1, gain=0.3) == 16
    for size in range(0, 64):
        for policy, kw in (("drain_all", {}), ("drain_k", dict(drain_k=3)),
                           ("adaptive", dict(drain_k=1, gain=0.6)),
                           ("adaptive", dict(drain_k=2, gain=0.3)),
                           ("adaptive", dict(drain_k=1, gain=0.7))):
            want = int(jqlib.drain_count(jnp.int32(size), policy, **kw))
            assert dc(size, policy, **kw) == want, (size, policy, kw)


# ---------------------------------------------------------------------------
# FRED's queued protocol
# ---------------------------------------------------------------------------

QUEUED = dict(num_clients=8, batch_size=8, seed=3, events_per_step=4)
SERIAL = dict(QUEUED, num_clients=4, queue_capacity=6, drain_policy="drain_k",
              drain_k=2, admission_policy="reject")
FUSED = dict(QUEUED, apply_mode="fused", queue_capacity=6,
             drain_policy="adaptive", drain_adaptive_gain=0.6)
PER_TENSOR = dict(c_push=0.05, c_fetch=0.2, drop_policy="skip",
                  per_tensor_push=True, per_tensor_fetch=True)
CASES = {
    # serial drains: capacity candidates a window, invalid rows masked
    "serial_kernel_drain_k_reject": dict(
        sim=SERIAL, server=dict(rule="fasgd", lr=0.01,
                                use_fused_kernel=True)),
    "serial_gap_block_drain_all": dict(
        sim=dict(QUEUED, queue_capacity=8),
        server=dict(rule="gap", lr=0.01)),
    "serial_gated_skip_drop_oldest": dict(
        sim=dict(SERIAL, admission_policy="drop_oldest", seed=7),
        server=dict(rule="fasgd", lr=0.01),
        bandwidth=dict(c_push=2.0, c_fetch=2.0, drop_policy="skip")),
    "serial_per_tensor": dict(
        sim=SERIAL, server=dict(rule="fasgd", lr=0.01,
                                use_fused_kernel=True),
        bandwidth=PER_TENSOR),
    # fused drains on fused_event_apply at K = capacity, masked rows
    "fused_kernel_adaptive_drop_oldest": dict(
        sim=dict(FUSED, admission_policy="drop_oldest"),
        server=dict(rule="asgd", lr=0.02, use_fused_kernel=True)),
    "fused_kernel_fasgd_drain_k_reject": dict(
        sim=dict(FUSED, drain_policy="drain_k", drain_k=3,
                 admission_policy="reject"),
        server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True)),
    "fused_kernel_per_tensor": dict(
        sim=dict(FUSED, admission_policy="reject"),
        server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True),
        bandwidth=PER_TENSOR),
    # cotangent drains: the copy and the rows are queued
    "cotangent_auto_adaptive_reject": dict(
        sim=dict(FUSED, admission_policy="reject"),
        server=dict(rule="sasgd", lr=0.05)),
    "cotangent_fasgd_block_drain_all": dict(
        sim=dict(FUSED, fused_mode="cotangent", drain_policy="drain_all",
                 queue_capacity=8),
        server=dict(rule="fasgd", lr=0.01)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_queued_run_simulation_matches_reference(setup, name):  # noqa: F811
    """Queued FRED against the reference, the ring's final state included;
    the counters' key set is the reference's, `queue_*` with them."""
    out = check_against_reference(setup, name, CASES[name])
    c = out["counters"]
    assert c["queue_windows"] == 12                        # 48 events / 4
    assert c["queue_enqueued"] == c["push_actual"]
    assert (c["queue_enqueued"] - c["queue_dropped"]
            == c["queue_drained"] + int(out["state"].queue.size))


def _run(cfg, setup, steps=48):
    params, ds = setup
    return run_simulation(cfg, nll_loss, params_from_numpy(params, device="cpu"),
                          ds["x_train"], ds["y_train"], steps,
                          eval_every=steps, collect_step_metrics=True,
                          device="cpu")


@pytest.mark.parametrize("rule,kernel", [
    ("asgd", False), ("sasgd", False), ("exp", False), ("poly", False),
    ("fasgd", False), ("fasgd", True), ("gap", False)])
def test_capacity_one_drain_all_is_the_serial_path(setup, rule,  # noqa: F811
                                                   kernel):
    """queue_capacity=1, 'drain_all', 'block': the queued serial run is the
    port's unqueued serial run bitwise (the same ops in the same order),
    counters aside from the queue's own."""
    base = SimConfig(num_clients=4, batch_size=8, seed=3,
                     server=ServerConfig(rule=rule, lr=0.01,
                                         use_fused_kernel=kernel))
    plain = _run(base, setup)
    queued = _run(dataclasses.replace(base, queue_capacity=1), setup)
    st, qst = plain["state"], queued["state"]
    for field in ("params", "n", "b", "v", "extra"):
        for a, b in zip(leaves(getattr(st.server, field)),
                        leaves(getattr(qst.server, field))):
            assert torch.equal(a, b), field
    for a, b in zip(leaves(st.client_params), leaves(qst.client_params)):
        assert torch.equal(a, b)
    assert torch.equal(st.client_ts, qst.client_ts)
    assert torch.equal(plain["train_loss"], queued["train_loss"])
    assert plain["final_timestamp"] == queued["final_timestamp"] == 48
    assert {k: v for k, v in queued["counters"].items()
            if not k.startswith("queue_")} == plain["counters"]
    assert queued["counters"]["queue_drained"] == 48


def _both_refuse(kw, match):
    """Both packages' SimConfig raise ValueError matching `match`."""
    J = {"bandwidth": JBandwidthConfig, "server": JServerConfig}
    T = {"bandwidth": BandwidthConfig, "server": ServerConfig}
    base = dict(num_clients=4, batch_size=8)
    j_kw = {k: (J[k](**v) if k in J else v) for k, v in kw.items()}
    t_kw = {k: (T[k](**v) if k in T else v) for k, v in kw.items()}
    j_kw.setdefault("server", JServerConfig(rule="asgd"))
    t_kw.setdefault("server", ServerConfig(rule="asgd"))
    with pytest.raises(ValueError, match=match):
        JSimConfig(**base, **j_kw)
    with pytest.raises(ValueError, match=match):
        SimConfig(**base, **t_kw)


OK = dict(queue_capacity=4, drain_policy="drain_all", admission_policy="block")


@pytest.mark.parametrize("kw,match", [
    (dict(queue_capacity=-1), "queue_capacity must be >= 0"),
    (dict(OK, drain_policy="bogus"), "unknown drain_policy"),
    (dict(OK, admission_policy="bogus"), "unknown admission_policy"),
    (dict(OK, dispatcher="roundrobin", server=dict(rule="ssgd")),
     "synchronous rule"),
    (dict(queue_capacity=4, drain_policy="drain_k", drain_k=0,
          admission_policy="reject"), "drain_k must be >= 1"),
    (dict(queue_capacity=4, drain_policy="adaptive", drain_adaptive_gain=0.0,
          admission_policy="reject"), "drain_adaptive_gain"),
    (dict(OK, bandwidth=dict(c_push=1.0, drop_policy="cache")),
     "gradient cache"),
    (dict(queue_capacity=4, drain_policy="drain_k",
          admission_policy="block"), "lossless backpressure"),
    (dict(OK, events_per_step=8), "queue_capacity >= events_per_step"),
])
def test_sim_config_queue_validation_matches_reference(kw, match):
    _both_refuse(kw, match)
    SimConfig(num_clients=4, batch_size=8, server=ServerConfig(rule="asgd"),
              **OK)


def test_counters_carry_the_queue_only_with_a_queue(setup):  # noqa: F811
    """The reference's key set: `queue_*` present exactly when a queue is
    configured (the unqueued key set is compared against the reference
    in test_torch_fred.py)."""
    base = SimConfig(num_clients=4, batch_size=8, seed=3,
                     server=ServerConfig(rule="sasgd", lr=0.01))
    plain = _run(base, setup, steps=8)["counters"]
    queued = _run(dataclasses.replace(base, **OK), setup, steps=8)["counters"]
    assert not any(k.startswith("queue_") for k in plain)
    assert set(queued) - set(plain) == {
        "queue_enqueued", "queue_rejected", "queue_dropped", "queue_drained",
        "queue_depth_sum", "queue_depth_peak", "queue_latency_sum",
        "queue_windows", "queue_latency_wall_sum"}
