"""The port's sharded server spread over processes
(`launch.mesh.init_distributed_mesh` with a coordinator, the collectives
of `core/server_shard.py`) against the same server in one process, and
against a live reference run.

Two worker processes (`torch_distributed_worker.py`, started once for the
module) join a gloo group through a coordinator on localhost and run
every arm of `torch_distributed_worker.ARMS` on the 784-200-10 MLP for 24
events: FRED serial, serial with whole-copy gates and with per-tensor
'cache' gates, fused K = 8 materialized and cotangent, a queued
``drain_k`` arm, the round trainer fused, and FRED fused with its
'clients' axis spread over the two processes beside the server's (the
fleet's rows in a block a process, per-tensor gates), each at S = 2
(one shard a process) and S = 4 (two a process).  The workers import neither `jax`
nor the reference package.  Every process's server state (params, n, b,
v, T), counters (the ``shard_*`` ones included) and validation curve must
be bitwise those of the other process and of the one-process port at the
same S on ``[cpu] * S``: the couplings add gathered partial sums in shard
order, as one process does.  The serial and queued arms replay the
reference's draws and are also held within FRED's parity tolerance (rtol
1e-4 / atol 1e-5) of a live reference run at S = 1, the reference's
S > 1 invariant making S = 1 its stand-in.  Each process holds only its
own shards' blocks: their bytes are the plan's `resident_bytes` of those
shards.  A group that does not finish within `GROUP_TIMEOUT` seconds is
killed, and the module's tests fail.
"""
import os
import pickle
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bandwidth import BandwidthConfig as JBandwidthConfig
from repro.core.rules import ServerConfig as JServerConfig
from repro.models.mlp import nll_loss as j_nll_loss
from repro.sim.fred import SimConfig as JSimConfig
from repro.sim.fred import run_simulation as j_run_simulation

from repro_torch.core import server_shard as ss
from repro_torch.launch.mesh import make_server_mesh
from repro_torch.utils.trees import leaves

import torch_distributed_worker as worker
from test_torch_fred import (RTOL, ATOL, one_thread,  # noqa: F401
                             replay_of, setup)

WORLD = 2
GROUP_TIMEOUT = 120.0
CPU = torch.device("cpu")
# the arms also held against a live reference run (their draws replayed:
# the cheapest two to replay)
REFERENCE_ARMS = ("serial", "queued")
RUNS = [(name, S) for name in worker.ARMS for S in worker.SHARDS]
RUN_IDS = [f"{name}-S{S}" for name, S in RUNS]
# the MLP's fasgd state at S = 2: one shard's blocks and T (the
# reference's per-shard peak, tests/test_torch_server_shard.py MLP_PEAKS)
FASGD_S2_BYTES = 1272084


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _draws(setup, name):
    """The reference's draws of arm `name`, as `ReplayDraws` arrays."""
    arm = worker.ARMS[name]
    rep = replay_of(arm["sim"], setup[1]["x_train"].shape[0], worker.EVENTS,
                    worker.EVAL_EVERY, bandwidth=arm["bandwidth"])
    return {k: v.numpy() for k, v in rep.all._asdict().items()}


@pytest.fixture(scope="module")
def inputs(setup):
    params, ds = setup
    return params, ds, {name: _draws(setup, name) for name in REFERENCE_ARMS}


@pytest.fixture(scope="module")
def group(inputs, tmp_path_factory):
    """`WORLD` worker processes of one process group, started (the
    one-process runs go on meanwhile); killed at the module's end if
    still running."""
    out = tmp_path_factory.mktemp("distributed")
    path = out / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH",
                                                               "")]))
    port = _free_port()
    script = os.path.join(os.path.dirname(__file__),
                          "torch_distributed_worker.py")
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(WORLD), str(port), str(path),
         str(out)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    yield procs, out, time.monotonic() + GROUP_TIMEOUT
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in logs:
        f.close()


@pytest.fixture(scope="module")
def one_process(group, inputs):
    """Every arm in this process at S = 2 and 4 on ``[cpu] * S``."""
    params, ds, draws = inputs
    mesh = lambda name, S: (worker.clients_mesh(S, spread=False)
                            if worker.ARMS[name]["clients"]
                            else make_server_mesh(S, devices=[CPU] * S))
    return {(name, S): worker.run_arm(name, params, ds, S, mesh(name, S),
                                      draws.get(name)) for name, S in RUNS}


@pytest.fixture(scope="module")
def reference(group, inputs):
    """The reference's run of each of `REFERENCE_ARMS` at S = 1 on the
    same draws (while the group runs)."""
    params, ds, _ = inputs
    out = {}
    for name in REFERENCE_ARMS:
        arm = worker.ARMS[name]
        cfg = JSimConfig(
            server=JServerConfig(**arm["server"], kernel_interpret=True),
            bandwidth=JBandwidthConfig(**arm["bandwidth"]), **arm["sim"])
        out[name] = j_run_simulation(
            cfg, j_nll_loss, jax.tree.map(jnp.asarray, params),
            jnp.asarray(ds["x_train"]), jnp.asarray(ds["y_train"]),
            worker.EVENTS, eval_every=worker.EVAL_EVERY,
            eval_fn=lambda p: j_nll_loss(p, ds["x_valid"], ds["y_valid"]))
    return out


@pytest.fixture(scope="module")
def spread(group, one_process, reference):
    """Both ranks' results, once the group has finished: a group still
    running `GROUP_TIMEOUT` seconds after its start is killed."""
    procs, out, deadline = group
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
    if any(p.returncode != 0 for p in procs):
        tail = "".join((out / f"rank{r}.log").read_text()[-3000:]
                       for r in range(WORLD))
        pytest.fail(f"worker exit codes {[p.returncode for p in procs]} "
                    f"(killed after {GROUP_TIMEOUT} s if negative):\n{tail}")
    res = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def _assert_same(got, want, what):
    """Bitwise: the same dtype and the same bits."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                  want.reshape(-1).view(np.uint8),
                                  err_msg=what)


def _assert_runs_bitwise(got, want, what):
    g_srv, w_srv = leaves(got["server"]), leaves(want["server"])
    assert len(g_srv) == len(w_srv)
    for i, (a, b) in enumerate(zip(g_srv, w_srv)):
        _assert_same(a, b, f"{what}: server leaf {i}")
    assert sorted(got["counters"]) == sorted(want["counters"])
    for k in want["counters"]:
        _assert_same(got["counters"][k], want["counters"][k],
                     f"{what}: counter {k}")
    assert got["val_cost"] == want["val_cost"], what
    assert got["final_timestamp"] == want["final_timestamp"], what
    g_fleet = {k: v for k, v in got["fleet"].items() if k != "blocks"}
    w_fleet = {k: v for k, v in want["fleet"].items() if k != "blocks"}
    assert sorted(g_fleet) == sorted(w_fleet)
    for k in w_fleet:
        for i, (a, b) in enumerate(zip(leaves(g_fleet[k]),
                                       leaves(w_fleet[k]))):
            _assert_same(a, b, f"{what}: fleet {k} leaf {i}")


def test_workers_import_no_reference(spread):
    for res in spread:
        assert res["imported"] == [], res["imported"]


def test_group_and_meshes(spread):
    """Each rank joined one group (a second `init_distributed_mesh` call
    kept it) and sees the same global meshes: one entry a rank at S = 2,
    two at S = 4."""
    for r, res in enumerate(spread):
        assert res["rank"] == r
        assert res["kept_group"]
        assert res["ranks2"] == (0, 1)
        assert res["ranks4"] == (0, 0, 1, 1)


@pytest.mark.parametrize("name,S", RUNS, ids=RUN_IDS)
def test_ranks_bitwise_equal(spread, name, S):
    _assert_runs_bitwise(spread[1]["runs"][name, S],
                         spread[0]["runs"][name, S], f"rank 1 vs 0, {name}")


@pytest.mark.parametrize("name,S", RUNS, ids=RUN_IDS)
def test_bitwise_one_process(spread, one_process, name, S):
    """Each rank's run is the one-process run at the same S, bitwise, the
    ``shard_*`` counters included."""
    want = one_process[name, S]
    for res in spread:
        _assert_runs_bitwise(res["runs"][name, S], want,
                             f"rank {res['rank']}, {name}")
    c = want["counters"]
    assert c["shard_applies"] > 0 and c["shard_events"] > 0


@pytest.mark.parametrize("name,S", RUNS, ids=RUN_IDS)
def test_each_process_holds_its_shards(spread, name, S):
    """Rank r holds shards r (S = 2) or 2r, 2r + 1 (S = 4), and nothing
    else: the bytes of its blocks are the plan's `resident_bytes` of those
    shards (the MLP's fasgd state at S = 2: 1,272,084 bytes a rank)."""
    per = S // WORLD
    for r, res in enumerate(spread):
        run = res["runs"][name, S]
        assert run["local"] == tuple(range(r * per, (r + 1) * per))
        assert run["held_bytes"] == run["planned_bytes"]
        if S == 2:
            assert run["held_bytes"] == FASGD_S2_BYTES


@pytest.mark.parametrize("name", REFERENCE_ARMS)
def test_against_reference(spread, reference, name):
    """The reference at S = 1 on the same draws, within FRED's parity
    tolerance; its counters exactly (the ``shard_*`` ones aside, which the
    reference reports only above S = 1)."""
    j_out = reference[name]
    j_srv = j_out["state"].server
    for S in worker.SHARDS:
        for res in spread:
            run = res["runs"][name, S]
            srv = run["server"]
            for field in ("params", "n", "b", "v"):
                for i, (a, b) in enumerate(zip(
                        leaves(getattr(srv, field)),
                        jax.tree.leaves(getattr(j_srv, field)))):
                    np.testing.assert_allclose(
                        a, np.asarray(b), rtol=RTOL, atol=ATOL,
                        err_msg=f"S={S} rank {res['rank']}: {field} {i}")
            assert run["final_timestamp"] == j_out["final_timestamp"]
            np.testing.assert_allclose(run["val_cost"], j_out["val_cost"],
                                       rtol=RTOL, atol=ATOL)
            got = {k: float(v) for k, v in run["counters"].items()
                   if not k.startswith("shard_")}
            assert {k: got[k] for k in j_out["counters"]} == \
                j_out["counters"]


@pytest.mark.parametrize("name", [n for n, a in worker.ARMS.items()
                                  if a["clients"]])
def test_client_axis_blocks(spread, name):
    """On FRED's 'clients' axis over the processes each rank holds its own
    block of the fleet's rows (block c in rank c), and the rows gathered
    from both are the one-process fleet (`test_bitwise_one_process`)."""
    for S in worker.SHARDS:
        for r, res in enumerate(spread):
            blocks = res["runs"][name, S]["fleet"]["blocks"]
            assert blocks == [c == r for c in range(worker.CLIENTS)]


def test_refusals(spread):
    """A server axis of another size than ``server_shards`` is refused
    over processes as in one, and so is a checkpoint of a spread
    server."""
    for res in spread:
        msgs = res["refusals"]
        for key, S, size in (("axis_2_on_4", 2, 4), ("axis_4_on_2", 4, 2)):
            assert msgs[key] is not None and msgs[key].startswith(
                f"server_shards={S} requires a mesh with a 'server' axis "
                f"of exactly that size; got axis size {size}"), msgs[key]
        assert "spread over processes" in msgs["checkpoint"]


def test_kernel_dispatches_per_rank(spread):
    """Both ranks dispatched the two server-update kernels' slots (their
    plain versions here) equally often."""
    counts = [res["launches"] for res in spread]
    assert counts[0] == counts[1]
    assert counts[0]["fasgd_update"] > 0
    assert counts[0]["fused_event_apply"] > 0


def test_spread_tree_api():
    """A placement's bookkeeping without a group: a mesh whose ranks put
    every shard in this process (rank 0) is not spread, and a shard of
    another rank holds no block."""
    tree = {"w": torch.arange(24.0).reshape(4, 6), "b": torch.ones(3)}
    mesh = make_server_mesh(2, devices=[CPU, CPU], ranks=[0, 0])
    placed = ss.shard_tree(tree, mesh)
    assert placed.local == (0, 1) and not placed.spread
    assert torch.equal(placed.gather()["w"], tree["w"])
    mesh = make_server_mesh(2, devices=[CPU, CPU], ranks=[0, 1])
    placed = ss.shard_tree(tree, mesh)
    assert placed.spread and placed.local == (0,)
    assert placed.blocks[1] is None
    assert torch.equal(placed.blocks[0]["w"], tree["w"][:, :3])
    assert placed.sub(lambda t: t["w"]).blocks[1] is None
    with pytest.raises(ValueError, match="holds no shard"):
        ss.shard_tree(tree, make_server_mesh(2, devices=[CPU, CPU],
                                             ranks=[1, 1]))
