"""The cases of `test_torch_round_spread.py`, and the worker process that
runs them over a gloo group of four.

Run as a script, it is one rank of a process group: ``python
torch_round_spread_worker.py RANK WORLD PORT INPUTS OUT``.  It joins the
group through `init_distributed_host_mesh` (coordinator
``127.0.0.1:PORT``) on a ``(data=4, model=1)`` mesh, runs every case of
`CASES` as `launch.train` runs the round trainer over a group (this
process's rows of every client's micro-batch, `sharding.rules.row_slice`;
the losses and gradients averaged over the group, `sharding.reduce.
GroupMean`; the replicas checked every round, `sharding.reduce.
check_replicas`), then the command line under the group (torchrun's
variables) uninterrupted and stopped and resumed from a checkpoint, and
writes its results (numpy) to ``OUT/rank{RANK}.pkl``.  It imports
`repro_torch` and never `jax` or the reference package, and says so in
its results.

Imported, `run_case` runs one case in one process (no `rows`, no
`reduce`), so the test holds the group's runs against the same case in
one process.
"""
import contextlib
import io
import os
import pickle
import sys
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainerConfig
from repro_torch.core import scenarios
from repro_torch.core.round_trainer import build_round_step, init_round_state
from repro_torch.kernels import ops
from repro_torch.launch.train import batch_for_step
from repro_torch.models.api import make_dict_grad_fn
from repro_torch.models.lm import make_lm_loss
from repro_torch.models.transformer import init_model
from repro_torch.utils.convert import to_numpy
from repro_torch.utils.rng import ReplayRoundDraws

C, S = 2, 32                 # clients, positions of every case
BC, BC_FALLBACK = 4, 2       # a client's rows: one a rank; 4 ∤ 2
ROUNDS = 3
FASGD = dict(rule="fasgd", lr=0.01, c_fetch=2.0)
# name → (arch, apply_mode, TrainerConfig fields, Bc, rounds)
CASES = {
    "serial": ("tinyllama-1.1b", "serial", FASGD, BC, ROUNDS),
    "serial_kernel": ("tinyllama-1.1b", "serial",
                      dict(FASGD, use_fused_kernel=True), BC, ROUNDS),
    "fused_kernel": ("tinyllama-1.1b", "fused",
                     dict(FASGD, use_fused_kernel=True), BC, ROUNDS),
    "cotangent": ("tinyllama-1.1b", "fused",
                  dict(rule="sasgd", lr=0.01, c_fetch=2.0,
                       drop_policy="discard", fused_mode="cotangent"),
                  BC, ROUNDS),
    "per_tensor": ("tinyllama-1.1b", "fused",
                   dict(FASGD, c_push=1.0, per_tensor_push=True,
                        per_tensor_fetch=True), BC, ROUNDS),
    "queue_drain_k": ("tinyllama-1.1b", "serial",
                      dict(FASGD, queue_capacity=3, drain_policy="drain_k",
                           drain_k=1, admission_policy="reject"), BC, ROUNDS),
    "queue_block": ("tinyllama-1.1b", "fused",
                    dict(FASGD, queue_capacity=2, drain_policy="drain_all",
                         admission_policy="block", use_fused_kernel=True),
                    BC, ROUNDS),
    "stragglers": ("tinyllama-1.1b", "serial",
                   dict(rule="kasync", lr=0.01, c_fetch=2.0, kasync_k=1,
                        scenario="stragglers"), BC, ROUNDS),
    "local_apply": ("tinyllama-1.1b", "fused",
                    dict(FASGD, c_push=1.0, drop_policy="local_apply"),
                    BC, ROUNDS),
    "fallback": ("tinyllama-1.1b", "serial",
                 dict(FASGD, use_fused_kernel=True), BC_FALLBACK, ROUNDS),
    "mamba2": ("mamba2-1.3b", "fused", dict(FASGD, use_fused_kernel=True),
               BC, 2),
    "zamba2": ("zamba2-7b", "fused", dict(FASGD, use_fused_kernel=True),
               BC, 2),
    "vlm": ("phi-3-vision-4.2b", "fused", dict(FASGD, use_fused_kernel=True),
            BC, 2),
    "audio": ("hubert-xlarge", "fused", dict(FASGD, use_fused_kernel=True),
              BC, 2),
}
CPU = torch.device("cpu")


def trainer_config(name):
    _, _, kw, _, _ = CASES[name]
    kw = dict(kw)
    if "scenario" in kw:
        kw["scenario"] = scenarios.preset(kw["scenario"])
    return TrainerConfig(num_round_clients=C, **kw)


def params_of(arch):
    """The SMOKE config's random weights from seed 0 (float32), drawn on
    the CPU: the same in every process."""
    cfg = get_smoke_config(arch)
    return init_model(torch.Generator().manual_seed(0), cfg, device=CPU)


def batches_of(name):
    """Each round's batch, a function of the round alone
    (`launch.train.batch_for_step`), as [C, Bc, ...] leaves."""
    arch, _, _, Bc, rounds = CASES[name]
    cfg = get_smoke_config(arch)
    out = []
    for r in range(rounds):
        flat = batch_for_step(cfg, C * Bc, S, r, device=CPU)
        out.append({k: v.reshape((C, Bc) + tuple(v.shape[1:]))
                    for k, v in flat.items()})
    return out


def step_of(name, reduce=None):
    arch, mode, _, _, _ = CASES[name]
    cfg = get_smoke_config(arch)
    batched = None
    if cfg.arch_type not in ("audio", "vlm"):
        lm_loss = make_lm_loss(cfg)

        def batched(W, deltas, batch):
            return lm_loss.event_batched(W, deltas, batch["tokens"],
                                         batch["targets"])
    return build_round_step(trainer_config(name), make_dict_grad_fn(cfg),
                            apply_mode=mode, batched_loss_fn=batched,
                            reduce=reduce)


def run_case(name, draws, rows=None, reduce=None, check=None):
    """Case `name`'s rounds from `params_of` on `batches_of`'s batches
    (this process's `rows` of each, where given) and `draws` ({"push",
    "fetch"}: [R, C] or [R, C, n_leaves] uniforms): each round's metrics,
    the launches of the kernels' slots a round, the state's `check`
    (``check(state)`` after each round, e.g. a digest), and the final
    state, all as numpy."""
    arch = CASES[name][0]
    tc = trainer_config(name)
    state = init_round_state(tc, params_of(arch), CPU)
    step = step_of(name, reduce)
    replay = ReplayRoundDraws(draws["push"], draws["fetch"], device=CPU)
    out = {"metrics": [], "launches": [], "checks": []}
    for r, batch in enumerate(batches_of(name)):
        if rows is not None:
            batch = {k: v[:, rows].contiguous() for k, v in batch.items()}
        ops.reset_launches()
        state, m = step(state, batch, replay.round(r))
        out["launches"].append(dict(ops.LAUNCHES))
        out["metrics"].append(to_numpy(m))
        if check is not None:
            out["checks"].append(check(state))
    out["state"] = to_numpy(state)
    return out


def train_cli(steps=2):
    """The command line run under the group (and by the test in one
    process): the fused round trainer with the kernel's slot, Bc = 4."""
    return ["--smoke", "--device", "cpu", "--clients", str(C), "--steps",
            str(steps), "--batch", str(C * BC), "--seq", str(S),
            "--log-every", "1", "--c-fetch", "2.0", "--lr", "0.01",
            "--apply-mode", "fused", "--use-fused-kernel"]


def run_cli(argv):
    """`launch.train.main(argv)`'s final state (numpy) and printed lines."""
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        state = train.main(argv)
    return to_numpy(state), buf.getvalue()


def cli_results(ckpt_dir):
    """The command line uninterrupted, with the server in two shards
    (both in each process), and stopped after step 1 with a checkpoint
    and resumed from it."""
    ckpt = ["--ckpt-dir", ckpt_dir, "--ckpt-every", "1"]
    return {"whole": run_cli(train_cli()),
            "sharded": run_cli(train_cli() + ["--server-shards", "2"]),
            "first": run_cli(train_cli(1) + ckpt),
            "resumed": run_cli(train_cli() + ckpt)}


def probes(rank):
    """`GroupMean` over buckets of 16 float32 entries on a float32, a
    bfloat16 and an integer leaf (rank r holds (r + 1) · arange), and
    `check_replicas` on a tree whose leaf "b" differs on the last rank."""
    from repro_torch.sharding.reduce import GroupMean, check_replicas
    world = torch.distributed.get_world_size()
    tree = {"f32": torch.arange(40.0) * (rank + 1),
            "bf16": (torch.arange(10.0) * (rank + 1)).bfloat16(),
            "int": torch.full((3,), rank)}
    mean = GroupMean(bucket_bytes=64)
    out = {"mean": to_numpy(mean(tree)), "buckets": mean.buckets,
           "bytes": mean.bytes}
    try:
        check_replicas({"a": torch.zeros(3),
                        "b": torch.full((2,), float(rank == world - 1))})
        out["differ"] = None
    except RuntimeError as e:
        out["differ"] = str(e)
    return out


def main(rank, world, port, inputs_path, out_dir):
    from repro_torch.launch.mesh import init_distributed_host_mesh
    from repro_torch.sharding.reduce import GroupMean, check_replicas, digest
    from repro_torch.sharding.rules import row_slice
    torch.set_num_threads(1)
    with open(inputs_path, "rb") as f:
        draws = pickle.load(f)
    results = {"cases": {}, "seconds": {}, "rows": {}, "rank": rank}
    t0 = time.perf_counter()
    mesh = init_distributed_host_mesh(
        world, 1, coordinator_address=f"127.0.0.1:{port}",
        num_processes=world, process_id=rank, devices=[CPU])
    results["mesh"] = dict(mesh.shape)

    def check(state):
        check_replicas(state)
        return digest(state)[1].numpy()

    for name in CASES:
        arch, _, _, Bc, _ = CASES[name]
        rows = row_slice((Bc, S, get_smoke_config(arch).d_model), mesh)
        reduce = None if rows is None else GroupMean()
        t = time.perf_counter()
        results["cases"][name] = run_case(name, draws[name], rows, reduce,
                                          check)
        results["rows"][name] = (None if rows is None
                                 else (rows.start, rows.stop))
        results["seconds"][name] = time.perf_counter() - t
    results["probes"] = probes(rank)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    t = time.perf_counter()
    results["cli"] = cli_results(os.path.join(out_dir, "ckpt"))
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
