"""The cases of `test_torch_model_spread.py`, and the worker process that
runs them over a gloo group of four.

Run as a script, it is one rank of a process group: ``python
torch_model_spread_worker.py RANK WORLD PORT INPUTS OUT``.  It joins the
group through `init_distributed_host_mesh` (coordinator
``127.0.0.1:PORT``), runs every case of `CASES` on each mesh of
`MESHES` over the group's four processes, then the two command lines
under the group (``launch.train`` pod-sync and ``launch.serve``, through
torchrun's environment variables) and their refusals, and writes its
results (numpy, gathered through `to_numpy`) to ``OUT/rank{RANK}.pkl``.
It imports `repro_torch` and never `jax` or the reference package, and
says so in its results.

Imported, `run_case` runs one case on any mesh, so the test holds a run
over processes against the same case in one process on a (1, 1) mesh.
"""
import contextlib
import dataclasses
import io
import os
import pickle
import sys
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainerConfig
from repro_torch.core import rules as server_rules
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.serving import decode_step, grow_cache, prefill
from repro_torch.sharding.rules import (cache_shardings, mesh_context,
                                        param_shardings, place,
                                        placements, state_shardings)
from repro_torch.utils.convert import lm_params_from_numpy, to_numpy
from repro_torch.utils.trees import leaves

ARCH = "tinyllama-1.1b"
B, S = 4, 32                 # the batch and sequence of every case
LR = 0.05
DECODE_STEPS = 4
MESHES = ((2, 2), (4, 1), (1, 4))
# (label, use_fused_kernel, remat)
TRAIN = (("train", False, False), ("train_fused", True, False),
         ("train_remat", False, True))
CASES = tuple(label for label, _, _ in TRAIN) + ("serve",)
CPU = torch.device("cpu")


def config(remat=False):
    """tinyllama-1.1b's SMOKE config in float32 (2 layers, d 256, 8 / 2
    heads, vocab 512)."""
    return dataclasses.replace(get_smoke_config(ARCH), remat=remat)


def _bytes_by_spec(t, pls, mesh):
    """The bytes of one process's shard of `t` placed by `pls`."""
    n = t.numel()
    for axis, p in enumerate(pls):
        if p.is_shard():
            n //= mesh.devices.shape[axis]
    return n * t.element_size()


def resident(tree, shardings, mesh):
    """[(leaf index, resident bytes of this process's shard, the shard's
    bytes by the spec)] for every placed leaf of `tree`."""
    out = []
    for i, (t, s) in enumerate(zip(leaves(tree), leaves(shardings))):
        if t.ndim == 0:
            continue
        local = t.to_local() if hasattr(t, "to_local") else t
        out.append((i, local.untyped_storage().nbytes(),
                    _bytes_by_spec(t, placements(s.spec, mesh), mesh)))
    return out


def _comm_counts(fn):
    """Run `fn` under `CommDebugMode` → (its result, {collective: count})."""
    from torch.distributed.tensor.debug import CommDebugMode
    mode = CommDebugMode()
    with mode:
        out = fn()
    return out, {str(k).split(".")[-1]: v
                 for k, v in mode.get_comm_counts().items()}


def run_train(inputs, mesh, fused, remat):
    """Two pod-sync FASGD steps from the inputs' parameters on `mesh`
    (placed by `steps.place_args`): each step's loss and mean_scale, and
    the state (θ, n, b, v, T) after each step, gathered."""
    cfg = config(remat)
    tc = TrainerConfig(rule="fasgd", lr=LR, use_fused_kernel=fused)
    shardings = (state_shardings(steps.abstract_server_state(cfg, tc), mesh),
                 steps.batch_shardings(steps.batch_struct(
                     cfg, B, S, with_targets=True), mesh))
    params = place(lm_params_from_numpy(inputs["params"], device=CPU),
                   shardings[0].params)
    state = server_rules.init(steps.server_config(tc), params)
    step = steps.place_args(steps.make_train_step(cfg, tc), shardings)
    out = {"metrics": [], "states": [], "comm": None, "resident": None}
    for i, (tok, tgt) in enumerate(inputs["batches"]):
        batch = {"tokens": torch.from_numpy(tok), "targets":
                 torch.from_numpy(tgt)}
        ops.reset_launches()
        if i == 1:
            (state, m), out["comm"] = _comm_counts(lambda: step(state, batch))
        else:
            state, m = step(state, batch)
        out["launches"] = dict(ops.LAUNCHES)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(to_numpy(state._replace(extra=None)))
    out["resident"] = resident(state, shardings[0], mesh)
    return out


def run_serve(inputs, mesh):
    """Prefill of the inputs' prompt, the cache grown, and `DECODE_STEPS`
    decode steps on the inputs' tokens, on `mesh` (the weights by
    `param_shardings`, the prompt and tokens by `batch_shardings`, the
    cache by `cache_shardings`): the prefill logits and cache, each
    step's logits, all gathered; the flash launches of each call."""
    cfg = config()
    params = lm_params_from_numpy(inputs["params"], device=CPU)
    pshard = param_shardings(params, mesh)
    params = place(params, pshard)
    prompt = torch.from_numpy(inputs["prompt"])
    tokens = torch.from_numpy(inputs["decode_tokens"])
    S0 = prompt.shape[1]
    out = {"launches": []}
    with mesh_context(mesh):
        batch = {"tokens": prompt}
        batch = place(batch, steps.batch_shardings(batch, mesh))
        ops.reset_launches()
        logits, cache = prefill(params, cfg, batch)
        out["launches"].append(ops.LAUNCHES["flash_attention"])
        out["prefill_logits"] = to_numpy(logits)
        out["prefill_cache"] = to_numpy(cache)
        cache = grow_cache(cfg, cache, S0 + DECODE_STEPS)
        out["resident"] = (resident(params, pshard, mesh)
                           + resident(cache, cache_shardings(cache, mesh),
                                      mesh))
        out["decode_logits"] = []
        for i in range(DECODE_STEPS):
            tok = {"t": tokens[:, i:i + 1]}
            tok = place(tok, steps.batch_shardings(tok, mesh, seq_dim=None))
            ops.reset_launches()
            run = lambda: decode_step(params, cfg, tok["t"], cache, S0 + i)
            if i == 1:
                (logits, cache), out["comm"] = _comm_counts(run)
            else:
                logits, cache = run()
            out["launches"].append(ops.LAUNCHES["flash_attention"])
            out["decode_logits"].append(to_numpy(logits))
        out["cache"] = to_numpy(cache)
    return out


def run_case(name, inputs, mesh):
    if name == "serve":
        return run_serve(inputs, mesh)
    _, fused, remat = next(c for c in TRAIN if c[0] == name)
    return run_train(inputs, mesh, fused, remat)


# the command lines run under the group (and by the test in one process)
TRAIN_CLI = ["--smoke", "--device", "cpu", "--clients", "0", "--steps", "2",
             "--batch", "4", "--seq", "32", "--log-every", "1", "--lr",
             str(LR), "--use-fused-kernel"]
SERVE_CLI = ["--smoke", "--device", "cpu", "--batch", "4", "--prompt-len",
             "16", "--gen", "3", "--temperature", "0"]
REFUSED = {"train_ssm": ("train", ["--arch", "mamba2-1.3b", "--smoke",
                                   "--device", "cpu", "--clients", "0"]),
           "train_moe": ("train", ["--arch", "grok-1-314b", "--smoke",
                                   "--device", "cpu", "--clients", "0"]),
           "train_clients": ("train", ["--arch", "grok-1-314b", "--smoke",
                                       "--device", "cpu", "--clients", "2"]),
           "serve_ssm": ("serve", ["--arch", "mamba2-1.3b", "--smoke",
                                   "--device", "cpu"]),
           "serve_moe": ("serve", ["--arch", "grok-1-314b", "--smoke",
                                   "--device", "cpu"])}


def run_cli(kind, argv):
    """A command line's return value and printed lines (stdout + stderr);
    a refusal's `SystemExit` code in place of the value."""
    from repro_torch.launch import serve, train
    main = train.main if kind == "train" else serve.main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        try:
            value = main(argv)
        except SystemExit as e:
            value = ("exit", e.code)
    return value, buf.getvalue()


def cli_results():
    """Both command lines and the refusals, as numpy and text."""
    out = {}
    state, text = run_cli("train", TRAIN_CLI)
    out["train"] = (to_numpy(state._replace(extra=None)), text)
    res, text = run_cli("serve", SERVE_CLI)
    out["serve"] = ({k: to_numpy(v) for k, v in res.items()
                     if k in ("tokens", "last_logits")}, text)
    for name, (kind, argv) in REFUSED.items():
        out[name] = run_cli(kind, argv)
    return out


def probe(mesh):
    """`constrain` and `constrain_axes` on a replicated DTensor [4, 8, 16]
    under `mesh`'s context (their placements), on a plain tensor (itself),
    and the refusals of a DTensor at the kernels' launches."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.sharding.rules import (constrain, constrain_axes,
                                            device_mesh)
    x = DTensor.from_local(torch.ones(4, 8, 16), device_mesh(mesh),
                           [Replicate(), Replicate()], run_check=False)
    plain = torch.ones(4, 8, 16)
    out = {}
    names = lambda y: [f"Shard({p.dim})" if p.is_shard() else "Replicate"
                       for p in y.placements]
    with mesh_context(mesh):
        for kind in ("bsd", "attn"):
            out[kind] = names(constrain(x, kind))
        out["axes"] = names(constrain_axes(x, {1: "model"}))
        out["plain_is_itself"] = (constrain(plain, "bsd") is plain
                                  and constrain_axes(plain, {0: "batch"})
                                  is plain)
    q = x.reshape(4, 8, 4, 4)
    calls = {"fasgd_update": lambda: ops._fasgd_update_cuda(
        [x], [x], [x], [x], [x], 0.1, 1.0, 0.9, 0.9, 1e-8, "intent"),
        "attention": lambda: ops._attention_cuda(q, q, q, True, 0, 0.5)}
    for name, call in calls.items():
        try:
            call()
            out[name] = "no error"
        except TypeError as e:
            out[name] = str(e)
    return out


def main(rank, world, port, inputs_path, out_dir):
    from repro_torch.launch.mesh import init_distributed_host_mesh
    torch.set_num_threads(1)
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    address = f"127.0.0.1:{port}"
    results = {"cases": {}, "seconds": {}}
    t0 = time.perf_counter()
    group = init_distributed_host_mesh(world, 1, coordinator_address=address,
                                       num_processes=world, process_id=rank,
                                       devices=[CPU])
    for data, model in MESHES:
        mesh = make_host_mesh(data, model, devices=list(group.devices.flat),
                              ranks=list(group.ranks.flat))
        for name in CASES:
            t = time.perf_counter()
            results["cases"][(data, model, name)] = run_case(name, inputs,
                                                             mesh)
            results["seconds"][(data, model, name)] = time.perf_counter() - t
    results["probe"] = probe(make_host_mesh(
        2, 2, devices=list(group.devices.flat), ranks=list(group.ranks.flat)))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    t = time.perf_counter()
    results["cli"] = cli_results()
    results["seconds"]["cli"] = time.perf_counter() - t
    results["seconds"]["all"] = time.perf_counter() - t0
    results["imports"] = sorted(m for m in sys.modules
                                if m == "jax" or m.startswith("jax.")
                                or m == "repro" or m.startswith("repro."))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
