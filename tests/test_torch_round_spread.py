"""The round trainer over a group of processes (`launch.train --clients C >
0` under torchrun): each process computes the gradients of its rows of
every client's micro-batch (`sharding.rules.row_slice`), one mean over the
group a round makes every process's losses and gradients the same
(`sharding.reduce.GroupMean`), and every process steps the same whole
state (`sharding.reduce.check_replicas`).

Four worker processes (`torch_round_spread_worker.py`, started once for
the module) join a gloo group through a coordinator on localhost, on a
(data=4, model=1) mesh, and run `worker.CASES` on the SMOKE configs in
float32 (C = 2 clients, S = 32): tinyllama-1.1b's serial round trainer
with the `fasgd_update` kernel's slot off and on, fused with the
`fused_event_apply` slot, fused cotangent (sasgd, 'discard'), per-tensor
push and fetch gating, the ingress queue (drain_k with 'reject', and
drain_all with 'block'), the 'stragglers' scenario under kasync,
'local_apply' with gated pushes, all at Bc = 4 (one row a process), and
at Bc = 2 (4 ∤ 2: every process computes the whole micro-batch); one
fused arm each of mamba2-1.3b, zamba2-7b, phi-3-vision-4.2b and
hubert-xlarge; then the command line under the group, uninterrupted,
with ``--server-shards 2``, and stopped after step 1 with a checkpoint
and resumed.  The workers import
neither `jax` nor the reference package.

Each result is held three ways: against the one-process port on the same
inputs (rtol 1e-5, atol 1e-6 of the largest entry of the compared array,
at least 1e-6, as `tests/test_torch_model_spread.py` states it: the
group's GEMMs take one row where one process takes four, and the mean
adds the four rows' gradients in another order; integer gates, T and
counters exactly), or bitwise where the batch does not split; dense
serial, serial kernel, fused kernel, cotangent and the mamba2 arm against
a live one-device reference run (`tests/test_torch_launch.py`'s TOL,
rtol 1e-4 / atol 1e-5); and every rank's state, metrics and per-round
digests bitwise every other rank's.  A group that does not finish within
`GROUP_TIMEOUT` seconds is killed and the module's tests fail.
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

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.configs.base import TrainerConfig as JTrainerConfig
from repro.core import round_trainer as jrt
from repro.models.lm import make_lm_loss as j_make_lm_loss
from repro.models.transformer import loss_fn as j_loss_fn

from repro_torch.utils.convert import lm_params_to_numpy

import torch_round_spread_worker as worker
from test_torch_fred import one_thread  # noqa: F401
from test_torch_round_trainer import round_replay

WORLD = 4
GROUP_TIMEOUT = 240.0
REF = dict(rtol=1e-4, atol=1e-5)     # tests/test_torch_launch.py's TOL
ONE_RTOL, ONE_ATOL = 1e-5, 1e-6
CASES = sorted(worker.CASES)
SPLIT = [n for n in CASES if worker.CASES[n][3] == worker.BC]
REFERENCE_CASES = ("serial", "serial_kernel", "fused_kernel", "cotangent",
                   "mamba2")
N_LEAVES = 12                        # tinyllama's SMOKE tree


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [] if t is None else [np.asarray(t)]


def _exact(a) -> bool:
    return a.dtype == bool or np.issubdtype(a.dtype, np.integer)


def close_to_one(got, want, what):
    """Integer and boolean arrays equal; every other array of `got` within
    rtol 1e-5 and atol 1e-6 × the largest |entry| (at least 1e-6) of its
    counterpart in `want`."""
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        if _exact(b):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} [{i}]")
            continue
        b = np.asarray(b, np.float64)
        atol = ONE_ATOL * max(1.0, float(np.abs(b).max(initial=0.0)))
        np.testing.assert_allclose(np.asarray(a, np.float64), b,
                                   rtol=ONE_RTOL, atol=atol,
                                   err_msg=f"{what} [{i}]")


def bitwise(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), \
            f"{what} [{i}]"


def draws_of(name):
    """Each round's gate uniforms: the reference's from keys 100 + r
    (`test_torch_round_trainer.round_replay`), or, per tensor, numpy's
    from seed 30."""
    tc = worker.trainer_config(name)
    rounds = worker.CASES[name][4]
    if tc.per_tensor_push or tc.per_tensor_fetch:
        rng = np.random.default_rng(30)
        shape = (rounds, worker.C, N_LEAVES)
        return {"push": rng.random(shape, np.float32),
                "fetch": rng.random(shape, np.float32)}
    replay = round_replay([jax.random.PRNGKey(100 + r)
                           for r in range(rounds)], worker.C, False, False)
    return {"push": replay.push_u.numpy(), "fetch": replay.fetch_u.numpy()}


@pytest.fixture(scope="module")
def draws():
    return {name: draws_of(name) for name in worker.CASES}


@pytest.fixture(scope="module")
def group(draws, tmp_path_factory):
    """`WORLD` worker processes of one gloo group, started (the one-process
    and reference runs go on meanwhile); killed at the module's end if
    still running."""
    out = tmp_path_factory.mktemp("round_spread")
    path = out / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(draws, f)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH",
                                                               "")]))
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    port = _free_port()
    script = os.path.join(os.path.dirname(__file__),
                          "torch_round_spread_worker.py")
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
def one_process(group, draws):
    """Every case and the command line in one process (no group)."""
    out = {name: worker.run_case(name, draws[name]) for name in worker.CASES}
    out["cli"] = worker.run_cli(worker.train_cli())
    return out


def reference_run(name):
    """Case `name` through the reference's round trainer on one device:
    its launcher's gradient (`loss_fn`'s value and gradient over the dict
    batch) and event-batched loss, the port's weights, the same batches
    and the keys `draws_of` replays."""
    arch, mode, kw, _, rounds = worker.CASES[name]
    jcfg = j_get_smoke_config(arch)
    j_tc = JTrainerConfig(num_round_clients=worker.C, kernel_interpret=True,
                          **kw)
    lm = j_make_lm_loss(jcfg)

    def grad_fn(p, batch):
        (loss, _), g = jax.value_and_grad(j_loss_fn, has_aux=True)(
            p, jcfg, batch)
        return loss, g

    step = jax.jit(jrt.build_round_step(
        j_tc, grad_fn, apply_mode=mode,
        batched_loss_fn=lambda W, d, b: lm.event_batched(
            W, d, b["tokens"], b["targets"])))
    params = jax.tree.map(jnp.asarray, lm_params_to_numpy(
        worker.params_of(arch)))
    state = jrt.init_round_state(j_tc, params)
    metrics = []
    for r, batch in enumerate(worker.batches_of(name)):
        batch = {k: jnp.asarray(v.numpy().astype(np.int32)
                                if not v.is_floating_point() else v.numpy())
                 for k, v in batch.items()}
        state, m = step(state, batch, jax.random.PRNGKey(100 + r))
        metrics.append(jax.tree.map(np.asarray, m))
    return {"metrics": metrics, "state": jax.tree.map(np.asarray, state)}


@pytest.fixture(scope="module")
def reference(group):
    return {name: reference_run(name) for name in REFERENCE_CASES}


@pytest.fixture(scope="module")
def results(group, one_process, reference):
    """Every rank's results, once the group has finished."""
    procs, out, deadline = group
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            break
    failed = [r for r, p in enumerate(procs) if p.poll() != 0]
    if failed:
        for p in procs:
            if p.poll() is None:
                p.kill()
        tails = "\n".join(f"--- rank {r}:\n"
                          + (out / f"rank{r}.log").read_text()[-3000:]
                          for r in failed)
        pytest.fail(f"ranks {failed} failed or outlived {GROUP_TIMEOUT} s:"
                    f"\n{tails}")
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def test_group_ran_without_the_reference(results):
    for r, res in enumerate(results):
        assert res["imports"] == [], (r, res["imports"])
        assert res["mesh"] == {"data": WORLD, "model": 1}
    print(f"\nround spread: seconds of rank 0 {results[0]['seconds']}")


@pytest.mark.parametrize("name", SPLIT)
def test_rows_follow_the_bsd_rule(results, name):
    """Rank r takes row r of each client's four."""
    for r, res in enumerate(results):
        assert res["rows"][name] == (r, r + 1)


@pytest.mark.parametrize("name", SPLIT)
def test_group_matches_one_process(results, one_process, name):
    want = one_process[name]
    for r, res in enumerate(results):
        got = res["cases"][name]
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            assert sorted(g) == sorted(w)
            close_to_one(g, w, f"rank {r} round {i} metrics")
        close_to_one(got["state"], want["state"], f"rank {r} state")
        assert got["launches"] == want["launches"], r


def test_fallback_is_the_one_process_run_bitwise(results, one_process):
    """Bc = 2 does not split over four processes: each computes the whole
    micro-batch, reduces nothing, and steps bitwise the one-process
    run."""
    want = one_process["fallback"]
    for r, res in enumerate(results):
        got = res["cases"]["fallback"]
        assert res["rows"]["fallback"] is None
        bitwise(got["metrics"], want["metrics"], f"rank {r} metrics")
        bitwise(got["state"], want["state"], f"rank {r} state")
        assert got["launches"] == want["launches"]


@pytest.mark.parametrize("name", CASES)
def test_ranks_hold_the_same_state(results, name):
    """Every rank's metrics, final state and per-round digests are rank
    0's, bit for bit (each rank also checked every round's digest against
    the group's, `check_replicas`)."""
    base = results[0]["cases"][name]
    assert len(base["checks"]) == worker.CASES[name][4]
    for r, res in enumerate(results[1:], 1):
        got = res["cases"][name]
        for key in ("metrics", "state", "checks"):
            bitwise(got[key], base[key], f"rank {r} {key}")


def _reference_metrics(got, want, what):
    for key in ("loss", "loss_per_client", "mean_tau"):
        np.testing.assert_allclose(got[key], want[key], **REF,
                                   err_msg=f"{what} {key}")
    for key in ("pushes", "fetches", "timestamp"):
        assert int(got[key]) == int(want[key]), (what, key)


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_group_matches_the_reference(results, reference, name):
    want = reference[name]
    got = results[0]["cases"][name]
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        _reference_metrics(g, w, f"round {i}")
    st, j_st = got["state"], want["state"]
    for field in ("params", "n", "b", "v"):
        g, w = _leaves(getattr(st.server, field)), \
            _leaves(getattr(j_st.server, field))
        assert len(g) == len(w), field
        for i, (a, b) in enumerate(zip(g, w)):
            np.testing.assert_allclose(a, b, **REF, err_msg=f"{field} {i}")
    assert int(st.server.timestamp) == int(j_st.server.timestamp)
    for i, (a, b) in enumerate(zip(_leaves(st.client_params),
                                   _leaves(j_st.client_params))):
        np.testing.assert_allclose(a, b, **REF, err_msg=f"client copy {i}")
    np.testing.assert_array_equal(st.client_ts, j_st.client_ts)
    j_c = j_st.counters._asdict()
    for k, v in st.counters._asdict().items():
        assert float(v) == float(j_c[k]), (k, v, j_c[k])


def test_cli_under_the_group(results, one_process):
    """`launch.train.main` under torchrun's variables: the mesh is (data=4,
    model=1), rank 0 alone prints the round and split lines, and every
    rank's final state is within float32 rounding of one process's."""
    want_state, want_text = one_process["cli"]
    assert "mesh=OrderedDict({'data': 1, 'model': 1})" in want_text
    for r, res in enumerate(results):
        state, text = res["cli"]["whole"]
        assert "mesh=OrderedDict({'data': 4, 'model': 1})" in text, text
        assert text.count(" loss=") == (2 if r == 0 else 0), text
        assert ("[train] split: rows [0, 1) of each client's 4" in text) \
            == (r == 0), text
        close_to_one(state, want_state, f"rank {r} CLI state")
    want_losses = [line.split()[2] for line in want_text.splitlines()
                   if " loss=" in line]
    got_losses = [line.split()[2] for line in
                  results[0]["cli"]["whole"][1].splitlines()
                  if " loss=" in line]
    assert got_losses == want_losses


def test_cli_resume_under_the_group_is_bitwise(results):
    """Stopped after step 1 with a checkpoint (rank 0 writes it) and
    resumed (every rank reads it), the group ends bitwise where the
    uninterrupted group run ends."""
    for r, res in enumerate(results):
        whole, _ = res["cli"]["whole"]
        resumed, text = res["cli"]["resumed"]
        assert ("resumed from step 1" in text) == (r == 0), text
        bitwise(resumed, whole, f"rank {r} resumed state")
        bitwise(whole, results[0]["cli"]["whole"][0], f"rank {r} vs rank 0")


def test_cli_server_shards_under_the_group(results):
    """``--server-shards 2`` under the group: each process holds both
    shards on its own device, and the run is bitwise the unsharded one
    (but for the shard_* counters, which only a sharded server moves)."""
    for r, res in enumerate(results):
        sharded, text = res["cli"]["sharded"]
        whole = res["cli"]["whole"][0]
        assert ("[train] server sharded: 2 shards" in text) == (r == 0)
        drop = lambda st: st._replace(counters={
            k: v for k, v in st.counters._asdict().items()
            if not k.startswith("shard_")})
        bitwise(drop(sharded), drop(whole), f"rank {r} sharded state")
        assert int(sharded.counters.shard_applies) == 2


def test_group_mean_over_buckets(results):
    """A float32, a bfloat16 and an integer leaf through buckets of 16
    float32 entries: the float leaves become the mean over the ranks
    ((1 + 2 + 3 + 4) / 4 = 2.5 times arange, the bf16 one rounded once),
    the integer leaf stays; 50 entries make 4 buckets, 200 bytes."""
    for res in results:
        got = res["probes"]
        np.testing.assert_array_equal(got["mean"]["f32"],
                                      2.5 * np.arange(40.0, dtype=np.float32))
        bf16 = (2.5 * np.arange(10.0)).astype(np.float32)
        np.testing.assert_array_equal(
            got["mean"]["bf16"],
            jnp.asarray(bf16).astype(jnp.bfloat16).astype(jnp.float32))
        assert got["mean"]["int"].tolist() == [res["rank"]] * 3
        assert (got["buckets"], got["bytes"]) == (4, 200)


def test_a_differing_replica_raises(results):
    """`check_replicas` on a tree whose leaf "b" differs on the last rank
    raises on every rank, naming the leaf and the rank."""
    for res in results:
        msg = res["probes"]["differ"]
        assert msg is not None and "leaf b of rank 3" in msg, msg
