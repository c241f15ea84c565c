"""The port's sharded parameter server (`core/server_shard.py`,
`launch/mesh.py`, FRED's and the round trainer's ``server_shards > 1``,
FRED's client axis) against the JAX reference.

The reference places the server with `jax.device_put` and lets XLA split
the step; the port holds S block trees and runs the engine's apply on
each.  Several shards share one device here (``[cpu] * S`` meshes), the
port's counterpart of the reference's forced host devices.  The plans
(paths, routed dimensions, owners, bytes) must equal the reference's.
``server_shards=1`` with a size-1 server axis is the unsharded port,
bitwise.  At S = 2 and 4 the port replays the reference's draws and is
held against its own S = 1 run within the reference's S > 1 invariant
(rtol 1e-5 / atol 1e-6), and against a live reference run at S = 1 (the
invariant makes S = 1 the reference's stand-in) within FRED's parity
tolerance (rtol 1e-4 / atol 1e-5: the two frameworks' float32 sums part
by more than the invariant's 1e-6 over 24 events); the counters exactly,
the ``shard_*`` ones against the reference's `peak_shard_bytes` and the
window counts.
One subprocess runs the reference itself at S = 2 on two forced host
devices, so that the port's ``shard_*`` counters meet the reference's own.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core import rules as jrules
from repro.core import server_shard as jss
from repro.core.bandwidth import BandwidthConfig as JBandwidthConfig
from repro.core.rules import ServerConfig as JServerConfig
from repro.launch.mesh import make_mesh_compat
from repro.models.mlp import nll_loss as j_nll_loss
from repro.models.transformer import init_model as j_init_model
from repro.sim.fred import SimConfig as JSimConfig
from repro.sim.fred import run_simulation as j_run_simulation

from repro_torch.configs import get_smoke_config
from repro_torch.core import engine
from repro_torch.core import round_trainer as rt
from repro_torch.core import rules as server_rules
from repro_torch.core import server_shard as ss
from repro_torch.core.bandwidth import BandwidthConfig
from repro_torch.core.rules import ServerConfig
from repro_torch.launch.mesh import Mesh, init_distributed_mesh, make_server_mesh
from repro_torch.models.mlp import nll_loss
from repro_torch.models.transformer import init_model
from repro_torch.sim.fred import FleetRows, SimConfig, run_simulation
from repro_torch.utils.convert import (counters_from_numpy,
                                       params_from_numpy, to_numpy)
from repro_torch.utils.trees import leaves

from test_server_shard import _tree
from test_torch_fred import (RTOL, ATOL, one_thread,  # noqa: F401
                             replay_of, setup)
from test_torch_round_trainer import Pair, compare_states

RULES = server_rules.registered_rules()
SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-6       # tests/test_server_shard.py:257
EVENTS = 24
CPU = torch.device("cpu")


def cpu_mesh(S):
    return make_server_mesh(server=S, devices=[CPU] * S)


# ---------------------------------------------------------------------------
# plans: the port's routing table is the reference's
# ---------------------------------------------------------------------------

def _j_dims(plan):
    """The reference's PartitionSpecs as routed dimensions."""
    out = []
    for spec in plan.specs:
        dims = [i for i, a in enumerate(spec) if a is not None]
        out.append(dims[0] if dims else ss.REPLICATE)
    return tuple(out)


def _mlp_states(setup, rule):
    params = setup[0]
    j = jrules.init(JServerConfig(rule=rule, num_clients=4),
                    jax.tree.map(jnp.asarray, params))
    p = server_rules.init(ServerConfig(rule=rule, num_clients=4),
                          params_from_numpy(params, "cpu"))
    return p, j


def _lm_states():
    kw = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=128, head_dim=16, param_dtype="bfloat16")
    j = jax.eval_shape(lambda: jrules.init(
        JServerConfig(), j_init_model(jax.random.PRNGKey(0),
                                      j_get_smoke_config("tinyllama-1.1b",
                                                         **kw))))
    params = init_model(torch.Generator().manual_seed(0),
                        get_smoke_config("tinyllama-1.1b", **kw), "cpu")
    return server_rules.init(ServerConfig(), params), j


def _plan_trees(setup, name):
    if name == "tree":
        j = _tree()
        return params_from_numpy(jax.tree.map(np.asarray, j), "cpu"), j
    if name == "lm_bf16":
        return _lm_states()
    return _mlp_states(setup, name.split("_")[1])


# the reference's peak per-shard bytes at S = 1, 2, 4 (S = 3 routes nothing
# of the MLP, so its peak is the whole state)
MLP_PEAKS = {"fasgd": (2544164, 1272084, 636164),
             "gap": (3180204, 1590104, 795204),
             "ssgd": (3180208, 1590108, 795208)}


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["tree", "mlp_fasgd", "mlp_gap", "mlp_ssgd",
                                  "lm_bf16"])
def test_plan_equals_reference(setup, name, S):
    tree, j_tree = _plan_trees(setup, name)
    got, want = ss.make_shard_plan(tree, S), jss.make_shard_plan(j_tree, S)
    assert got.paths == want.paths
    assert got.specs == _j_dims(want)
    assert got.owners == want.owners
    for f in ("num_shards", "axis", "leaf_bytes", "owned_bytes",
              "shard_bytes", "replicated_bytes", "total_bytes",
              "peak_resident_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    assert ss.peak_shard_bytes(tree, S) == jss.peak_shard_bytes(j_tree, S)
    if name.startswith("mlp_"):
        peaks = MLP_PEAKS[name.split("_")[1]]
        want_peak = {1: peaks[0], 2: peaks[1], 3: peaks[0], 4: peaks[2]}[S]
        assert got.peak_resident_bytes == want_peak
    if name == "mlp_fasgd":
        assert got.paths[:5] == ("params/0/b", "params/0/w", "params/1/b",
                                 "params/1/w", "timestamp")
    if name == "mlp_ssgd":
        assert "extra/count" in got.paths
        assert got.paths[-1] == "extra/pending/1/w"
    if name == "lm_bf16":
        # a bf16 leaf counts 2 bytes an element
        assert got.total_bytes == sum(l.numel() * l.element_size()
                                      for l in leaves(tree))


@pytest.mark.parametrize("shape,S", [
    ((784, 200), 1), ((784, 200), 4), ((200, 10), 4), ((200, 10), 2),
    ((200, 10), 3), ((7,), 4), ((), 4), ((6, 4), 2), ((3, 8, 6), 4)])
def test_leaf_spec_routing(shape, S):
    """The reference's routing cases: the last dimension S divides, else
    replicate; S = 1 replicates."""
    want = jss.server_leaf_spec(shape, S)
    dims = [i for i, a in enumerate(want) if a is not None]
    assert ss.server_leaf_spec(shape, S) == (dims[0] if dims
                                             else ss.REPLICATE)


def test_leaf_spec_routing_cases():
    P = ss.server_leaf_spec
    assert P((784, 200), 1) == ss.REPLICATE
    assert P((784, 200), 4) == 1
    assert P((200, 10), 4) == 0       # 10 is not 4-divisible
    assert P((200, 10), 2) == 1
    assert P((7,), 4) == ss.REPLICATE
    assert P((), 4) == ss.REPLICATE


@pytest.mark.parametrize("S", [2, 4])
def test_placement_blocks_contiguous_and_gather_exact(setup, S):
    """Every block and replica a fresh contiguous tensor on its shard's
    device; `gather` gives back the leaf exactly; the queue payload routes
    its leaf dimensions under a slot axis."""
    tree = params_from_numpy(jax.tree.map(np.asarray, _tree()), "cpu")
    mesh = cpu_mesh(S)
    placed = ss.shard_tree(tree, mesh)
    assert placed.num_shards == S
    for s, blk in enumerate(placed.blocks):
        for leaf, dim, whole in zip(leaves(blk), placed.dims, leaves(tree)):
            assert leaf.is_contiguous()
            assert leaf.device == mesh.axis_devices("server")[s]
            assert leaf.data_ptr() != whole.data_ptr()
            if dim is None:
                assert torch.equal(leaf, whole)
            else:
                n = whole.shape[dim] // S
                assert torch.equal(leaf, whole.narrow(dim, s * n, n))
    for a, b in zip(leaves(placed.gather()), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the server state: w1 [784, 200] routes along its strided dim 1
    srv, _ = _mlp_states(setup, "fasgd")
    placed = ss.shard_server_state(srv, mesh)
    assert placed.sub(lambda s_: s_.params).dims == (0, 1, 0 if S == 2
                                                     else None, 1 if S == 2
                                                     else 0)
    whole = ss.gather(placed)
    for a, b in zip(leaves(whole), leaves(srv)):
        assert torch.equal(a, b)
    assert ss.shard_server_state(srv, cpu_mesh(1)) is srv
    assert ss.shard_server_state(srv, None) is srv
    # a [capacity, *leaf] payload: the slot axis stays whole
    from repro_torch.core import queue as qlib
    q = qlib.init_queue(3, {"grad": srv.params,
                            "loss": torch.zeros(())})
    pq = ss.shard_queue_state(q, mesh)
    assert pq.ts is q.ts
    assert pq.payload["grad"].dims == tuple(
        None if d is None else d + 1
        for d in placed.sub(lambda s_: s_.params).dims)
    assert all(l.shape[0] == 3 for b in pq.payload.blocks
               for l in leaves(b["grad"]))
    assert ss.shard_queue_state(None, mesh) is None


def test_validate_server_mesh_rejects():
    """The reference's refusals and messages (the recipe after the dash is
    the port's own: shards on one device through `devices=`)."""
    cases = [(None, None, 2),
             (cpu_mesh(1), make_mesh_compat((1, 1), ("server", "data")), 2),
             (Mesh([CPU], ("clients",)), make_mesh_compat((1,),
                                                          ("clients",)), 2)]
    for mesh, j_mesh, S in cases:
        with pytest.raises(ValueError) as j_err:
            jss.validate_server_mesh(j_mesh, S)
        with pytest.raises(ValueError) as err:
            ss.validate_server_mesh(mesh, S)
        head = lambda e: str(e.value).split(" — ")[0]
        assert head(err) == head(j_err)
    with pytest.raises(ValueError, match="axis size 1"):
        ss.validate_server_mesh(cpu_mesh(1), 2)
    ss.validate_server_mesh(cpu_mesh(1), 1)
    ss.validate_server_mesh(cpu_mesh(2), 2)
    with pytest.raises(ValueError, match="server_shards"):
        SimConfig(server_shards=0)


def test_meshes():
    """`make_server_mesh` clamps to the distinct devices (here: the CPU) as
    the reference does, takes a list that repeats one, and
    `init_distributed_mesh` without a coordinator is `make_server_mesh`."""
    m = make_server_mesh(server=4, data=2)
    assert m.shape == {"server": 1, "data": 1}
    m = make_server_mesh(server=2, data=2, devices=[CPU] * 4)
    assert m.axis_names == ("server", "data")
    assert m.shape == {"server": 2, "data": 2}
    assert m.axis_devices("server") == (CPU, CPU)
    assert ss.mesh_axis_size(m) == 2 and ss.mesh_axis_size(m, "x") == 0
    assert ss.mesh_axis_size(None) == 0
    assert init_distributed_mesh(2).shape == make_server_mesh(2).shape
    # a coordinator joins a gloo group (here of this process alone) and
    # records the rank of every entry; two devices give S = 2 in one
    # process, so the placement is not spread and runs no collective
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    try:
        m = init_distributed_mesh(2, coordinator_address=f"127.0.0.1:{port}",
                                  num_processes=1, process_id=0,
                                  devices=[CPU, CPU])
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert m.shape == {"server": 2, "data": 1}
        assert m.axis_ranks("server") == (0, 0)
        placed = ss.shard_tree({"w": torch.arange(8.0)}, m)
        assert placed.local == (0, 1) and not placed.spread
        assert torch.equal(placed.gather()["w"], torch.arange(8.0))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the couplings: v̄, each leaf's v̄, the mean scale
# ---------------------------------------------------------------------------

def test_vbar_counts_a_replica_once(setup):
    """At S = 4 the MLP's [10] bias replicates; its v differs from every
    other leaf's, so counting it S times would move v̄ (and its own leaf's
    v̄ would be S times too large)."""
    srv, _ = _mlp_states(setup, "fasgd")
    gen = torch.Generator().manual_seed(3)
    v = [torch.rand(l.shape, generator=gen) + 0.5 for l in leaves(srv.v)]
    v[2] = torch.full_like(v[2], 40.0)                  # params/1/b: [10]
    from repro_torch.utils.trees import unflatten
    srv = srv._replace(v=unflatten(srv.v, v))
    placed = ss.shard_server_state(srv, cpu_mesh(4))
    assert placed.sub(lambda s: s.v).dims[2] is None     # replicated
    want = server_rules.vbar(srv)
    got = server_rules.vbar(placed)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    n = sum(l.numel() for l in v)
    doubled = (want * n + 3 * v[2].sum()) / n
    assert abs(float(doubled - want)) > 1e3 * abs(float(got - want))
    u = torch.rand(6, 4, generator=gen)
    m1, sent1, tot1 = engine.per_tensor_gate(u, srv, 5.0, 1e-8)
    m2, sent2, tot2 = engine.per_tensor_gate(u, placed, 5.0, 1e-8)
    assert all(torch.equal(a, b) for a, b in zip(leaves(m1), leaves(m2)))
    assert torch.equal(sent1, sent2) and tot1 == tot2
    for a, b in zip(ss.leaf_means(placed.sub(lambda s: s.v)), v):
        torch.testing.assert_close(a, b.mean(), rtol=1e-6, atol=0)
    # the telemetry's mean effective lr, from every shard's scale sums
    scfg = ServerConfig(rule="fasgd", lr=0.01)
    g = [torch.randn(l.shape, generator=gen) for l in leaves(srv.params)]
    g = unflatten(srv.params, g)
    ts = torch.tensor(0, dtype=torch.int32)
    _, aux1 = engine.apply_gated(scfg, srv, g, torch.tensor(True), ts)
    new, aux2 = engine.apply_gated(scfg, placed, g, torch.tensor(True), ts)
    torch.testing.assert_close(aux2["mean_scale"], aux1["mean_scale"],
                               rtol=1e-6, atol=0)
    assert "scale_sums" not in aux2
    assert ss.is_sharded(new)


# ---------------------------------------------------------------------------
# S = 1 is the unsharded port, bitwise
# ---------------------------------------------------------------------------

def _sim_kw(rule, apply_mode, per_tensor):
    sync = server_rules.get_rule(rule).synchronous
    return dict(
        sim=dict(num_clients=4, batch_size=8, seed=5, apply_mode=apply_mode,
                 events_per_step=4 if apply_mode == "fused" else 1,
                 dispatcher="roundrobin" if sync else "uniform"),
        server=dict(rule=rule, lr=0.01, num_clients=4,
                    kasync_k=2 if rule == "kasync" else 0),
        bandwidth=dict(c_push=0.5 if not sync else 0.0, c_fetch=0.5,
                       per_tensor_push=per_tensor and not sync,
                       per_tensor_fetch=per_tensor))


def _port_cfg(case, shards=1):
    return SimConfig(server=ServerConfig(**case["server"]),
                     bandwidth=BandwidthConfig(**case["bandwidth"]),
                     server_shards=shards, **case["sim"])


def _port_run(setup, case, shards=1, mesh=None, rng=None):
    params, ds = setup
    xv = torch.as_tensor(ds["x_valid"])
    yv = torch.as_tensor(ds["y_valid"]).long()
    return run_simulation(
        _port_cfg(case, shards), nll_loss, params_from_numpy(params, "cpu"),
        ds["x_train"], ds["y_train"], EVENTS, eval_every=EVENTS // 2,
        eval_fn=lambda p: nll_loss(p, xv, yv), mesh=mesh, rng=rng,
        device="cpu")


def _skip(rule, apply_mode, per_tensor):
    sync = server_rules.get_rule(rule).synchronous
    if sync and apply_mode == "fused":
        pytest.skip("synchronous rules do not support the fused apply")
    if sync and per_tensor:
        pytest.skip("per-tensor gating is undefined at a sync barrier")


@pytest.mark.parametrize("per_tensor", [False, True],
                         ids=["whole-copy", "per-tensor"])
@pytest.mark.parametrize("apply_mode", ["serial", "fused"])
@pytest.mark.parametrize("rule", RULES)
def test_one_shard_bitwise_identical(setup, rule, apply_mode, per_tensor):
    """``server_shards=1`` with a size-1 server axis places nothing: the
    trajectory and the (shard-free) counters are the unsharded port's."""
    _skip(rule, apply_mode, per_tensor)
    case = _sim_kw(rule, apply_mode, per_tensor)
    base = _port_run(setup, case)
    one = _port_run(setup, case, mesh=cpu_mesh(1))
    assert not ss.is_sharded(one["state"].server)
    for a, b in zip(leaves(base["state"].server), leaves(one["state"].server)):
        assert torch.equal(a, b)
    assert base["val_cost"] == one["val_cost"]
    assert base["counters"] == one["counters"]
    assert not any(k.startswith("shard_") for k in base["counters"])
    assert hasattr(one["state"].counters, "shard_applies")


# ---------------------------------------------------------------------------
# S = 2 and 4: every rule against a live reference run at S = 1
# ---------------------------------------------------------------------------

def _cases():
    out = {}
    for rule in RULES:
        sync = server_rules.get_rule(rule).synchronous
        for mode in ("serial",) if sync else ("serial", "fused"):
            for pt in (False,) if sync else (False, True):
                out[f"{rule}-{mode}-{'pt' if pt else 'wc'}"] = _sim_kw(
                    rule, mode, pt)
    queued = _sim_kw("fasgd", "fused", False)
    queued["sim"].update(queue_capacity=6, drain_policy="drain_k", drain_k=3,
                         admission_policy="reject")
    queued["server"]["use_fused_kernel"] = True
    queued["bandwidth"]["drop_policy"] = "skip"
    out["fasgd-fused-queued"] = queued
    return out


CASES = _cases()
_J_RUNS = {}
_ONE_SHARD = {}


def _j_run(setup, name):
    """The reference's S = 1 run of case `name` (cached: S = 2 and 4 meet
    the same run)."""
    if name not in _J_RUNS:
        params, ds = setup
        case = CASES[name]
        cfg = JSimConfig(
            server=JServerConfig(**case["server"], kernel_interpret=True),
            bandwidth=JBandwidthConfig(**case["bandwidth"]), **case["sim"])
        _J_RUNS[name] = j_run_simulation(
            cfg, j_nll_loss, jax.tree.map(jnp.asarray, params),
            jnp.asarray(ds["x_train"]), jnp.asarray(ds["y_train"]), EVENTS,
            eval_every=EVENTS // 2,
            eval_fn=lambda p: j_nll_loss(p, ds["x_valid"], ds["y_valid"]))
    return _J_RUNS[name]


def _hold_shard_counters(c, j_out, S, case):
    """The ``shard_*`` counters: the reference's plan's peak bytes, one
    apply a window (an event serially), the events it consumed."""
    sim = case["sim"]
    assert c["shard_bytes_peak"] == jss.peak_shard_bytes(
        j_out["state"].server, S)
    if sim.get("queue_capacity"):
        assert c["shard_applies"] == c["queue_windows"]
        assert c["shard_events"] == c["queue_drained"]
        assert 1 <= c["shard_depth_peak"] <= sim["drain_k"]
        return
    k = sim["events_per_step"]
    assert c["shard_applies"] == EVENTS // k
    assert c["shard_events"] == EVENTS
    assert c["shard_depth_peak"] == k


def _replay(setup, case):
    return replay_of(case["sim"], setup[1]["x_train"].shape[0], EVENTS,
                     EVENTS // 2, bandwidth=case["bandwidth"])


def _states_close(got, want, rtol, atol, what):
    """The server states (numpy trees) field by field."""
    for field in ("params", "n", "b", "v", "extra"):
        a_l = leaves(getattr(got, field))
        b_l = jax.tree.leaves(getattr(want, field))
        assert len(a_l) == len(b_l), field
        for i, (a, b) in enumerate(zip(a_l, b_l)):
            np.testing.assert_allclose(
                a, np.asarray(b), rtol=rtol, atol=atol,
                err_msg=f"{what}: {field} leaf {i}")


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_matches_reference(setup, name, S):
    case = CASES[name]
    j_out = _j_run(setup, name)
    if name not in _ONE_SHARD:
        _ONE_SHARD[name] = _port_run(setup, case, rng=_replay(setup, case))
    one = _ONE_SHARD[name]
    out = _port_run(setup, case, S, cpu_mesh(S), _replay(setup, case))
    assert ss.is_sharded(out["state"].server)
    assert out["state"].server.num_shards == S
    srv = to_numpy(out["state"].server)
    _states_close(srv, to_numpy(one["state"].server), SHARD_RTOL, SHARD_ATOL,
                  "against the port's S = 1")
    _states_close(srv, j_out["state"].server, RTOL, ATOL,
                  "against the reference's S = 1")
    assert out["final_timestamp"] == j_out["final_timestamp"]
    np.testing.assert_allclose(out["val_cost"], one["val_cost"],
                               rtol=SHARD_RTOL, atol=SHARD_ATOL)
    np.testing.assert_allclose(out["val_cost"], j_out["val_cost"],
                               rtol=RTOL, atol=ATOL)
    c, j_c = out["counters"], j_out["counters"]
    assert {k: v for k, v in c.items() if not k.startswith("shard_")} == j_c
    _hold_shard_counters(c, j_out, S, case)
    if case["sim"].get("queue_capacity"):
        # the ring's payload is placed, and comes back whole
        q = out["state"].queue
        assert ss.is_sharded(q.payload)
        for a, b in zip(leaves(to_numpy(q.payload)),
                        jax.tree.leaves(j_out["state"].queue.payload)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL,
                                       atol=ATOL)


_MULTIDEV_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.core.rules import ServerConfig
    from repro.core.bandwidth import BandwidthConfig
    from repro.sim.fred import SimConfig, run_simulation
    from repro.launch.mesh import make_mesh_compat
    from repro.models.mlp import nll_loss

    assert len(jax.devices()) == 2, jax.devices()
    params, ds, cases = np.load(sys.argv[1], allow_pickle=True).tolist()
    mesh = make_mesh_compat((2,), ("server",))
    out = {}
    for name, case in cases.items():
        cfg = SimConfig(server=ServerConfig(**case["server"],
                                            kernel_interpret=True),
                        bandwidth=BandwidthConfig(**case["bandwidth"]),
                        server_shards=2, **case["sim"])
        r = run_simulation(cfg, nll_loss, jax.tree.map(jnp.asarray, params),
                           jnp.asarray(ds["x_train"]),
                           jnp.asarray(ds["y_train"]), 24, eval_every=12,
                           mesh=mesh)
        out[name] = r["counters"]
    print("COUNTERS " + json.dumps(out))
""")


def test_shard_counters_match_reference_at_two_devices(setup, tmp_path):
    """The reference itself at S = 2 on two forced host devices (fasgd,
    serial and fused, gated, kernel on): its counters, the ``shard_*``
    ones included, are the port's."""
    cases = {}
    for mode in ("serial", "fused"):
        case = _sim_kw("fasgd", mode, False)
        case["server"]["use_fused_kernel"] = True
        cases[mode] = case
    arg = tmp_path / "inputs.npy"
    np.save(arg, np.array([setup[0], setup[1], cases], dtype=object),
            allow_pickle=True)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, "-c", _MULTIDEV_SCRIPT, str(arg)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [l for l in r.stdout.splitlines() if l.startswith("COUNTERS ")]
    want = json.loads(line[-1][len("COUNTERS "):])
    for mode, case in cases.items():
        out = _port_run(setup, case, 2, cpu_mesh(2), _replay(setup, case))
        assert out["counters"] == want[mode], mode
        assert out["counters"]["shard_applies"] > 0


# ---------------------------------------------------------------------------
# the round trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rt_setup():
    """`test_torch_round_trainer`'s 16-8-4 MLP and batch (C=4, μ=8)."""
    from repro.models.mlp import init_mlp as j_init_mlp
    params = jax.tree.map(np.array, j_init_mlp(jax.random.PRNGKey(0),
                                               (16, 8, 4)))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (4, 8, 16)))
    y = np.array(jax.random.randint(jax.random.PRNGKey(2), (4, 8), 0, 4))
    return params, x, y


def test_round_trainer_shard_fold_bitwise(rt_setup):
    """``server_shards > 1`` without placement changes only the
    ``shard_*`` telemetry: the port's states at S = 1 and 2 are bitwise
    equal, and each is held against the reference's at its own S, the
    ``shard_*`` counters included."""
    kw = dict(rule="fasgd", c_push=1.0, c_fetch=1.0)
    p1 = Pair(rt_setup, dict(kw, server_shards=1), rounds=4).run()
    p2 = Pair(rt_setup, dict(kw, server_shards=2), rounds=4).run()
    for a, b in zip(leaves(p1.state.server), leaves(p2.state.server)):
        assert torch.equal(a, b)
    assert int(p1.state.counters.shard_applies) == 0
    assert int(p2.state.counters.shard_applies) == 4
    assert float(p2.state.counters.shard_bytes_peak) == \
        jss.peak_shard_bytes(p2.j_state.server, 2)


@pytest.mark.parametrize("apply_mode", ["serial", "fused"])
def test_round_trainer_placed(rt_setup, apply_mode):
    """`shard_round_state` places the server at S = 2 (the [C] copies stay
    whole); the apply runs on each shard, with the kernel's plain version
    here, and the run is the reference's S = 2 run (whose math is its
    S = 1 run's)."""
    kw = dict(rule="fasgd", c_push=1.0, c_fetch=1.0, server_shards=2,
              use_fused_kernel=True)
    pair = Pair(rt_setup, kw, apply_mode=apply_mode, rounds=4)
    pair.state = rt.shard_round_state(pair.state, cpu_mesh(2))
    assert ss.is_sharded(pair.state.server)
    assert not ss.is_sharded(pair.state.client_params)
    assert rt.shard_round_state(pair.state, None).server is \
        pair.state.server
    for r in range(pair.rounds):
        pair.j_state, _ = pair.j_step(pair.j_state, pair.j_batch,
                                      pair.keys[r])
        pair.state, m = pair.step(pair.state, pair.batch, pair.draws.round(r))
    assert ss.is_sharded(pair.state.server)
    compare_states(pair.state._replace(server=ss.gather(pair.state.server)),
                   pair.j_state)


def test_counters_cross_with_shard_fields():
    """`counters_from_numpy` carries the reference's ``shard_*`` fields."""
    from repro.core.engine import init_counters as j_init_counters
    j_c = jax.tree.map(np.asarray, j_init_counters()._replace(
        shard_applies=jnp.int32(3), shard_bytes_peak=jnp.float32(636164.0)))
    c = counters_from_numpy(j_c, "cpu")
    assert int(c.shard_applies) == 3 and float(c.shard_bytes_peak) == 636164
    assert c.shard_depth_peak.dtype == torch.int32
    assert c._fields == tuple(j_c._fields)


# ---------------------------------------------------------------------------
# FRED's client axis
# ---------------------------------------------------------------------------

def _client_run(setup, mesh, per_tensor=False, shards=1):
    case = _sim_kw("fasgd", "fused", per_tensor)
    return _port_run(setup, case, shards, mesh=mesh,
                     rng=_replay(setup, case))


@pytest.mark.parametrize("per_tensor", [False, True],
                         ids=["whole-copy", "per-tensor"])
def test_client_axis_fused_matches_no_mesh(setup, per_tensor):
    """The fleet split by rows over a two-device client axis and the
    gradient batch in two chunks of K/2 events: the run of no mesh, and
    with a server axis beside it, the sharded run."""
    base = _client_run(setup, None, per_tensor)
    split = _client_run(setup, Mesh([CPU, CPU], ("clients",)), per_tensor)
    assert isinstance(split["state"].client_ts, FleetRows)
    both = _client_run(setup, Mesh([[CPU, CPU], [CPU, CPU]],
                                   ("clients", "server")), per_tensor,
                       shards=2)
    assert ss.is_sharded(both["state"].server)
    pick = lambda st: to_numpy([st.server, st.client_params, st.client_ts,
                                st.client_leaf_ts])
    want = pick(base["state"])
    for out in (split, both):
        for a, b in zip(leaves(pick(out["state"])), leaves(want)):
            np.testing.assert_allclose(a, b, rtol=SHARD_RTOL,
                                       atol=SHARD_ATOL)
        assert out["val_cost"] == pytest.approx(base["val_cost"],
                                                rel=SHARD_RTOL)
    assert split["counters"] == base["counters"]


def test_client_axis_refusals_match_reference(setup, monkeypatch):
    """A queue refuses a client axis, and so does fused_mode='cotangent',
    in both packages (a size-1 axis states the intent); 'auto' gives the
    cotangent path up where the axis has more than one device."""
    params, ds = setup
    j_mesh = make_mesh_compat((1,), ("clients",))
    mesh = Mesh([CPU], ("clients",))
    queued = dict(num_clients=4, batch_size=8, events_per_step=4,
                  queue_capacity=8)
    cot = dict(num_clients=4, batch_size=8, events_per_step=4,
               apply_mode="fused", fused_mode="cotangent")
    for sim, match in ((queued, "queue_capacity > 0 does not support a "
                                "client-axis mesh"),
                       (cot, "fused_mode='cotangent' does not support a "
                             "client-axis mesh")):
        with pytest.raises(ValueError, match=match):
            j_run_simulation(JSimConfig(**sim), j_nll_loss,
                             jax.tree.map(jnp.asarray, params),
                             jnp.asarray(ds["x_train"]),
                             jnp.asarray(ds["y_train"]), 4, mesh=j_mesh)
        with pytest.raises(ValueError, match=match):
            run_simulation(SimConfig(**sim), nll_loss,
                           params_from_numpy(params, "cpu"), ds["x_train"],
                           ds["y_train"], 4, mesh=mesh, device="cpu")
    auto = SimConfig(num_clients=4, batch_size=8, events_per_step=4,
                     apply_mode="fused", server=ServerConfig(rule="sasgd"))
    assert auto.cotangent_eligible()
    calls = []
    real = engine.fused_apply_cotangent
    monkeypatch.setattr(engine, "fused_apply_cotangent", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    for m in (None, Mesh([CPU, CPU], ("clients",))):
        run_simulation(auto, nll_loss, params_from_numpy(params, "cpu"),
                       ds["x_train"], ds["y_train"], 8, mesh=m,
                       device="cpu")
        calls.append(m is None)
    # two windows on the cotangent path without a mesh, none with the axis
    assert calls == [1, 1, True, False]
