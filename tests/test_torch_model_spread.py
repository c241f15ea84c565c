"""The dense family's pod-sync step and serving placed over a (data, model)
mesh of processes (`launch.mesh.init_distributed_host_mesh`,
`sharding.rules.place` / `constrain`, `launch.steps.place_args`), against
the same steps in one process and against a live reference run.

Four worker processes (`torch_model_spread_worker.py`, started once for
the module) join a gloo group through a coordinator on localhost and run,
on meshes (2, 2), (4, 1) and (1, 4) over the four of them, tinyllama-1.1b's
SMOKE config in float32 (2 layers, d 256, 8 / 2 heads, vocab 512) at
B = 4, S = 32: two pod-sync FASGD steps with the `fasgd_update` kernel's
route off and on and with ``remat``, then a prefill of 16 tokens and four
decode steps; then both command lines under the group (torchrun's
variables) and their refusals.  On (1, 4) the two kv heads are replicated
over the four model ranks (`kernels.ops.head_split` 'q').  The workers
import neither `jax` nor the reference package.

Each result is held against the one-process port on the same inputs
(`ONE`: rtol 1e-5, atol 1e-6 of the largest entry of the compared array,
at least 1e-6; a contraction split over processes adds in another order,
and a process's [1 × d] decode GEMM takes another BLAS kernel than
[4 × d]) and against a live one-device reference run
(`tests/test_torch_launch.py`'s TOL, rtol 1e-4 / atol 1e-5).  Each
process's resident bytes of every placed leaf (state, weights, cache)
equal its shard's by the spec.  The collectives a step takes are counted
with `CommDebugMode` and printed (``pytest -s``), not pinned.  A group that
does not finish within `GROUP_TIMEOUT` seconds is killed and the module's
tests fail.
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
from repro.core import rules as j_rules
from repro.launch import steps as j_steps
from repro.models.serving import decode_step as j_decode_step
from repro.models.serving import prefill as j_prefill
from repro.models.transformer import init_model as j_init_model

from repro_torch.launch.mesh import make_host_mesh

import torch_model_spread_worker as worker
from test_torch_fred import one_thread  # noqa: F401

WORLD = 4
GROUP_TIMEOUT = 240.0
REF = dict(rtol=1e-4, atol=1e-5)     # tests/test_torch_launch.py's TOL
ONE_RTOL, ONE_ATOL = 1e-5, 1e-6
RUNS = [(mesh, name) for mesh in worker.MESHES for name in worker.CASES]
RUN_IDS = [f"{d}x{m}-{name}" for (d, m), name in RUNS]
TRAIN_RUNS = [(mesh, name) for mesh, name in RUNS if name != "serve"]
TRAIN_IDS = [f"{d}x{m}-{name}" for (d, m), name in TRAIN_RUNS]
MESH_IDS = [f"{d}x{m}" for d, m in worker.MESHES]


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [] if t is None else [t]


def close_to_one(got, want, what):
    """Every array of `got` within rtol 1e-5 and atol 1e-6 × the largest
    |entry| (at least 1e-6) of its counterpart in `want`."""
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        b = np.asarray(b, np.float64)
        atol = ONE_ATOL * max(1.0, float(np.abs(b).max(initial=0.0)))
        np.testing.assert_allclose(np.asarray(a, np.float64), b,
                                   rtol=ONE_RTOL, atol=atol,
                                   err_msg=f"{what} [{i}]")


def close_to_reference(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), **REF,
                                   err_msg=f"{what} [{i}]")


@pytest.fixture(scope="module")
def inputs():
    """The reference's SMOKE parameters (float32, `jax.random.PRNGKey(0)`)
    and token batches, a prompt and decode tokens from numpy seed 29."""
    jcfg = j_get_smoke_config(worker.ARCH)
    params = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    rng = np.random.default_rng(29)
    draw = lambda *shape: rng.integers(0, jcfg.vocab_size, shape) \
        .astype(np.int64)
    return {"params": params,
            "batches": [(draw(worker.B, worker.S), draw(worker.B, worker.S))
                        for _ in range(2)],
            "prompt": draw(worker.B, 16),
            "decode_tokens": draw(worker.B, worker.DECODE_STEPS)}


@pytest.fixture(scope="module")
def group(inputs, tmp_path_factory):
    """`WORLD` worker processes of one gloo group, started (the one-process
    and reference runs go on meanwhile); killed at the module's end if
    still running."""
    out = tmp_path_factory.mktemp("model_spread")
    path = out / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH",
                                                               "")]))
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    port = _free_port()
    script = os.path.join(os.path.dirname(__file__),
                          "torch_model_spread_worker.py")
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
    """Every case, both command lines and the refusals' one-process runs
    (on a (1, 1) mesh, no group)."""
    mesh = make_host_mesh(devices=["cpu"])
    out = {name: worker.run_case(name, inputs, mesh)
           for name in worker.CASES}
    state, text = worker.run_cli("train", worker.TRAIN_CLI)
    out["train_cli"] = (worker.to_numpy(state._replace(extra=None)), text)
    res, text = worker.run_cli("serve", worker.SERVE_CLI)
    out["serve_cli"] = ({k: worker.to_numpy(v) for k, v in res.items()
                         if k in ("tokens", "last_logits")}, text)
    return out


@pytest.fixture(scope="module")
def reference(group, inputs):
    """The reference's two pod-sync steps (its step updates with the plain
    rule; the kernel route and remat are held against it too) and its
    prefill and decode steps on the same inputs, one device."""
    jcfg = j_get_smoke_config(worker.ARCH)
    jparams = jax.tree.map(jnp.asarray, inputs["params"])
    j_tc = JTrainerConfig(rule="fasgd", lr=worker.LR)
    jst = j_rules.init(j_steps.server_config(j_tc), jparams)
    j_step = jax.jit(j_steps.make_train_step(jcfg, j_tc))
    metrics, states = [], []
    for tok, tgt in inputs["batches"]:
        jst, jm = j_step(jst, {"tokens": jnp.asarray(tok, jnp.int32),
                               "targets": jnp.asarray(tgt, jnp.int32)})
        metrics.append({k: float(v) for k, v in jm.items()})
        states.append(jax.tree.map(np.asarray, jst._replace(extra=None)))
    prompt = jnp.asarray(inputs["prompt"], jnp.int32)
    logits, cache = j_prefill(jparams, jcfg, {"tokens": prompt})
    S0 = prompt.shape[1]
    serve = {"prefill_logits": np.asarray(logits),
             "prefill_cache": jax.tree.map(np.asarray, cache)}
    pad = lambda c: jnp.concatenate([c, jnp.zeros(
        c.shape[:2] + (worker.DECODE_STEPS,) + c.shape[3:], c.dtype)], 2)
    cache = {k: pad(v) for k, v in cache.items()}
    dec = []
    tokens = jnp.asarray(inputs["decode_tokens"], jnp.int32)
    for i in range(worker.DECODE_STEPS):
        lg, cache = j_decode_step(jparams, jcfg, tokens[:, i:i + 1], cache,
                                  jnp.int32(S0 + i))
        dec.append(np.asarray(lg))
    serve["decode_logits"] = dec
    serve["cache"] = jax.tree.map(np.asarray, cache)
    return {"metrics": metrics, "states": states, "serve": serve}


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
    print(f"\nmodel spread: seconds of rank 0 {results[0]['seconds']}")


@pytest.mark.parametrize("mesh,name", TRAIN_RUNS, ids=TRAIN_IDS)
def test_train_matches_one_process(results, one_process, mesh, name):
    want = one_process[name]
    for r, res in enumerate(results):
        got = res["cases"][mesh + (name,)]
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            close_to_one([g["loss"], g["mean_scale"], g["tau"]],
                         [w["loss"], w["mean_scale"], w["tau"]],
                         f"rank {r} step {i} loss, mean_scale, tau")
        for i, (g, w) in enumerate(zip(got["states"], want["states"])):
            close_to_one(g, w, f"rank {r} state after step {i}")
            assert int(g.timestamp) == int(w.timestamp) == i + 1


@pytest.mark.parametrize("mesh,name", TRAIN_RUNS, ids=TRAIN_IDS)
def test_train_matches_the_reference(results, reference, mesh, name):
    got = results[0]["cases"][mesh + (name,)]
    for i, (g, w) in enumerate(zip(got["metrics"], reference["metrics"])):
        close_to_reference([g["loss"], g["mean_scale"]],
                           [w["loss"], w["mean_scale"]], f"step {i}")
    for i, (g, w) in enumerate(zip(got["states"], reference["states"])):
        for field in ("params", "n", "b", "v"):
            close_to_reference(getattr(g, field), getattr(w, field),
                               f"{field} after step {i}")


@pytest.mark.parametrize("mesh", worker.MESHES, ids=MESH_IDS)
def test_serving_matches_one_process(results, one_process, mesh):
    want = one_process["serve"]
    for r, res in enumerate(results):
        got = res["cases"][mesh + ("serve",)]
        for key in ("prefill_logits", "prefill_cache", "decode_logits",
                    "cache"):
            close_to_one(got[key], want[key], f"rank {r} {key}")


@pytest.mark.parametrize("mesh", worker.MESHES, ids=MESH_IDS)
def test_serving_matches_the_reference(results, reference, mesh):
    got = results[0]["cases"][mesh + ("serve",)]
    want = reference["serve"]
    for key in ("prefill_logits", "decode_logits"):
        close_to_reference(got[key], want[key], key)
    for key in ("prefill_cache", "cache"):
        for name in ("k", "v"):
            close_to_reference(got[key][name], want[key][name],
                               f"{key} {name}")


@pytest.mark.parametrize("mesh,name", RUNS, ids=RUN_IDS)
def test_kernels_run_once_a_step_on_local_shards(results, mesh, name):
    """`fasgd_update` once a step on each process's local shards (the CPU
    counts a leaf dispatch each: 12 leaves) on the kernel route, never
    off it; `flash_attention` once a layer per prefill and decode call.
    The collectives a step took are printed."""
    for r, res in enumerate(results):
        got = res["cases"][mesh + (name,)]
        if name == "serve":
            assert got["launches"] == [2] * (1 + worker.DECODE_STEPS), r
        else:
            fused = name == "train_fused"
            assert got["launches"]["fasgd_update"] == (12 if fused else 0)
            assert got["launches"]["flash_attention"] == 0
        assert got["comm"], (r, got["comm"])
    print(f"\ncollectives {mesh} {name}, a "
          f"{'decode step' if name == 'serve' else 'train step'}: "
          f"{results[0]['cases'][mesh + (name,)]['comm']}")


@pytest.mark.parametrize("mesh,name", RUNS, ids=RUN_IDS)
def test_each_process_holds_its_shards(results, mesh, name):
    """Each process's resident bytes of every placed leaf are its local
    shard's bytes by the spec; the all-divisible leaves hold 1 / (data ×
    model) of the whole."""
    for r, res in enumerate(results):
        held = res["cases"][mesh + (name,)]["resident"]
        assert held and all(local == want for _, local, want in held), \
            (r, [h for h in held if h[1] != h[2]])


@pytest.mark.parametrize("mesh,name", RUNS, ids=RUN_IDS)
def test_ranks_agree(results, mesh, name):
    """Every rank gathers the same arrays (each gather is a collective)."""
    base = results[0]["cases"][mesh + (name,)]
    keys = ("prefill_logits", "decode_logits", "cache") if name == "serve" \
        else ("states",)
    for r, res in enumerate(results[1:], 1):
        got = res["cases"][mesh + (name,)]
        for key in keys:
            for a, b in zip(_leaves(got[key]), _leaves(base[key])):
                assert np.array_equal(a, b), (r, key)


def test_train_cli_under_the_group(results, one_process):
    want_state, want_text = one_process["train_cli"]
    for r, res in enumerate(results):
        state, text = res["cli"]["train"]
        assert "mesh=OrderedDict({'data': 4, 'model': 1})" in text, text
        assert "mesh=OrderedDict({'data': 1, 'model': 1})" in want_text
        close_to_one(state, want_state, f"rank {r} CLI state")
        assert text.count(" loss=") == want_text.count(" loss=") == 2


def test_serve_cli_under_the_group(results, one_process):
    want, _ = one_process["serve_cli"]
    for r, res in enumerate(results):
        got, text = res["cli"]["serve"]
        assert "mesh=OrderedDict({'data': 4, 'model': 1})" in text, text
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        close_to_one(got["last_logits"], want["last_logits"],
                     f"rank {r} last logits")


@pytest.mark.parametrize("name", sorted(worker.REFUSED))
def test_refusals_over_processes(results, name):
    """The MoE family (pod-sync, ``--clients > 0`` and serving) and the
    SSM's pod-sync step and serving are refused over more than one
    process, naming ROADMAP queue 1, item 10b."""
    for res in results:
        value, text = res["cli"][name]
        assert value == ("exit", 2)
        assert "ROADMAP queue 1, item 10b" in text, text


def test_constrain_and_the_kernels_refusal(results):
    """Under the (2, 2) mesh's context `constrain` redistributes a DTensor
    to the reference's spec, and a DTensor that reaches a kernel's launch
    raises."""
    for res in results:
        probe = res["probe"]
        assert probe["bsd"] == ["Shard(0)", "Shard(2)"]
        assert probe["attn"] == ["Shard(0)", "Shard(1)"]
        assert probe["axes"] == ["Replicate", "Shard(1)"]
        assert probe["plain_is_itself"]
        for name in ("fasgd_update", "attention"):
            assert "DTensor reached the" in probe[name], probe[name]
