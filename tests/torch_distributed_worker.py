"""The arms of `test_torch_distributed.py`, and the worker process that runs
them over a gloo group.

Run as a script, it is one rank of a process group: ``python
torch_distributed_worker.py RANK WORLD PORT INPUTS OUT``.  It joins the
group through `init_distributed_mesh` (coordinator ``127.0.0.1:PORT``),
runs every arm of INPUTS (a pickle of the MLP's params, the data and the
arms) at S = 2 (one shard per process) and S = 4 (two per process),
checks the refusals, and writes its results (numpy, through `to_numpy`)
to ``OUT/rank{RANK}.pkl``.  It imports `repro_torch` and never `jax` or
the reference package, and says so in its results.

Imported, `run_arm` runs one arm on any mesh, so the test holds a run over
processes against the same arm in one process on ``[cpu] * S`` (the
'clients' arms on `clients_mesh`).
"""
import pickle
import sys

import numpy as np
import torch

from repro_torch.configs.base import TrainerConfig
from repro_torch.core import round_trainer as rt
from repro_torch.core import server_shard as ss
from repro_torch.core.bandwidth import BandwidthConfig
from repro_torch.core.rules import ServerConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh
from repro_torch.models.mlp import nll_loss
from repro_torch.sim.fred import SimConfig, run_simulation
from repro_torch.utils.convert import params_from_numpy, to_numpy
from repro_torch.utils.rng import ReplayDraws
from repro_torch.utils.trees import leaves

EVENTS = 24
EVAL_EVERY = 12
CPU = torch.device("cpu")

_BASE = dict(sim=dict(num_clients=4, batch_size=8, seed=5),
             server=dict(rule="fasgd", lr=0.01, num_clients=4,
                         use_fused_kernel=True),
             bandwidth=dict())
_FUSED = dict(apply_mode="fused", events_per_step=8)


def _arm(sim=None, server=None, bandwidth=None, round_trainer=False,
         clients=False):
    return dict(sim=dict(_BASE["sim"], **(sim or {})),
                server=dict(_BASE["server"], **(server or {})),
                bandwidth=dict(_BASE["bandwidth"], **(bandwidth or {})),
                round_trainer=round_trainer, clients=clients)


# every arm runs 24 events (the round trainer: 6 rounds of C = 4 pushes)
ARMS = {
    "serial": _arm(),
    "serial_gated": _arm(bandwidth=dict(c_push=0.5, c_fetch=0.5,
                                        drop_policy="skip")),
    "serial_pt_cache": _arm(bandwidth=dict(
        c_push=0.5, c_fetch=0.5, per_tensor_push=True,
        per_tensor_fetch=True, drop_policy="cache")),
    "fused": _arm(sim=dict(_FUSED, fused_mode="materialized"),
                  bandwidth=dict(c_push=0.5, c_fetch=0.5)),
    "cotangent": _arm(sim=dict(_FUSED, fused_mode="cotangent"),
                      server=dict(use_fused_kernel=False),
                      bandwidth=dict(c_push=0.5, c_fetch=0.5,
                                     drop_policy="skip")),
    "queued": _arm(sim=dict(_FUSED, fused_mode="materialized",
                            queue_capacity=12, drain_policy="drain_k",
                            drain_k=6, admission_policy="reject"),
                   bandwidth=dict(c_push=0.5, c_fetch=0.5,
                                  drop_policy="skip")),
    "round_fused": _arm(round_trainer=True),
    # FRED's 'clients' axis over the processes beside the server's: every
    # fleet array (copies, timestamps per copy and per tensor, the cache)
    "clients": _arm(sim=dict(_FUSED, fused_mode="materialized"),
                    bandwidth=dict(c_push=0.5, c_fetch=0.5,
                                   per_tensor_push=True,
                                   per_tensor_fetch=True), clients=True),
}
SHARDS = (2, 4)
CLIENTS = 2


def clients_mesh(S, spread):
    """A ("clients", "server") mesh of `CLIENTS` × S CPU entries; spread
    over two processes so that each axis spans both (client block c and
    shard s in process ``(c + s // (S / 2)) % 2``), else this process's
    alone."""
    ranks = None
    if spread:
        ranks = np.array([[(c + s * 2 // S) % 2 for s in range(S)]
                          for c in range(CLIENTS)])
    return Mesh(np.full((CLIENTS, S), CPU, dtype=object),
                ("clients", "server"), ranks=ranks)


def sim_config(arm, shards):
    """The arm's `SimConfig` at `shards` server shards."""
    return SimConfig(server=ServerConfig(**arm["server"]),
                     bandwidth=BandwidthConfig(**arm["bandwidth"]),
                     server_shards=shards, **arm["sim"])


def _local_bytes(placed):
    """(bytes of this process's blocks, the plan's resident bytes of its
    shards)."""
    plan = ss.make_shard_plan(placed, placed.num_shards)
    held = sum(l.numel() * l.element_size() for s in placed.local
               for l in leaves(placed.blocks[s]))
    return held, sum(plan.resident_bytes(s) for s in placed.local)


def _round_run(arm, params, ds, shards, mesh, device):
    sim = arm["sim"]
    tc = TrainerConfig(num_round_clients=sim["num_clients"],
                       rule=arm["server"]["rule"], lr=arm["server"]["lr"],
                       use_fused_kernel=arm["server"]["use_fused_kernel"],
                       server_shards=shards, seed=sim["seed"])
    C, mu = sim["num_clients"], sim["batch_size"]
    x = torch.as_tensor(ds["x_train"][:C * mu]).reshape(C, mu, -1).to(device)
    y = torch.as_tensor(ds["y_train"][:C * mu]).reshape(C, mu).long().to(
        device)
    p = params_from_numpy(params, device)
    step = rt.build_round_step(tc, rt.make_grad_fn(nll_loss),
                               apply_mode="fused")
    draws = rt.native_round_draws(tc, p, device)
    state = rt.shard_round_state(rt.init_round_state(tc, p, device), mesh)
    for r in range(EVENTS // C):
        state, _ = step(state, (x, y), draws.round(r))
    return state, None, None


def run_arm(name, params, ds, shards, mesh, draws=None, device=CPU):
    """Arm `name` at `shards` server shards on `mesh` (a global mesh over
    processes, or one process's), replaying `draws` (the arrays of a
    `ReplayDraws`) where given.  Returns its results as numpy: the server
    state's fields, the counters, the validation curve, T, and this
    process's bytes beside its shards' plan."""
    arm = ARMS[name]
    if arm["round_trainer"]:
        state, val_cost, final_T = _round_run(arm, params, ds, shards, mesh,
                                              device)
    else:
        xv = torch.as_tensor(ds["x_valid"]).to(device)
        yv = torch.as_tensor(ds["y_valid"]).long().to(device)
        out = run_simulation(
            sim_config(arm, shards), nll_loss,
            params_from_numpy(params, device), ds["x_train"], ds["y_train"],
            EVENTS, eval_every=EVAL_EVERY,
            eval_fn=lambda p: nll_loss(p, xv, yv), mesh=mesh,
            rng=None if draws is None else ReplayDraws(**draws),
            device=device)
        state, val_cost, final_T = (out["state"], out["val_cost"],
                                    out["final_timestamp"])
    server = state.server
    held, planned = _local_bytes(server)
    fleet = {}
    if arm["clients"]:
        fleet = to_numpy({"params": state.client_params,
                          "ts": state.client_ts,
                          "leaf_ts": state.client_leaf_ts,
                          "cache": state.grad_cache})
        fleet["blocks"] = [b is not None for b in state.client_ts.blocks]
    return {"server": to_numpy(server), "fleet": fleet,
            "counters": to_numpy(state.counters._asdict()),
            "val_cost": val_cost, "final_timestamp": final_T,
            "local": server.local, "held_bytes": held,
            "planned_bytes": planned}


def _refusals(params, ds, mesh2, mesh4, tmp):
    """The messages of the refusals over processes: a server axis that
    does not match ``server_shards``, each way, and a checkpoint of a
    spread server."""
    from repro_torch.checkpoint.checkpoint import save_checkpoint
    msgs = {}
    for key, shards, mesh in (("axis_2_on_4", 2, mesh4),
                              ("axis_4_on_2", 4, mesh2)):
        try:
            run_simulation(sim_config(ARMS["serial"], shards), nll_loss,
                           params_from_numpy(params, CPU), ds["x_train"],
                           ds["y_train"], 1, mesh=mesh, device=CPU)
            msgs[key] = None
        except ValueError as e:
            msgs[key] = str(e)
    placed = ss.shard_tree({"w": torch.zeros(8, 4)}, mesh2)
    try:
        save_checkpoint(tmp, 0, {"server": placed})
        msgs["checkpoint"] = None
    except ValueError as e:
        msgs["checkpoint"] = str(e)
    return msgs


def main(rank, world, port, inputs, out_dir):
    import os
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed_mesh

    torch.set_num_threads(1)
    with open(inputs, "rb") as f:
        params, ds, draws = pickle.load(f)
    address = f"127.0.0.1:{port}"
    mesh2 = init_distributed_mesh(2, coordinator_address=address,
                                  num_processes=world, process_id=rank)
    group = dist.group.WORLD
    # a second call keeps the group; two CPU entries a process give S = 4
    mesh4 = init_distributed_mesh(4, coordinator_address=address,
                                  num_processes=world, process_id=rank,
                                  devices=[CPU, CPU])
    res = {"rank": rank, "kept_group": dist.group.WORLD is group,
           "ranks2": mesh2.axis_ranks("server"),
           "ranks4": mesh4.axis_ranks("server"), "runs": {}}
    for name, arm in ARMS.items():
        for S, mesh in ((2, mesh2), (4, mesh4)):
            if arm["clients"]:
                mesh = clients_mesh(S, spread=True)
            res["runs"][name, S] = run_arm(name, params, ds, S, mesh,
                                           draws.get(name))
    res["launches"] = dict(ops.LAUNCHES)
    res["refusals"] = _refusals(params, ds, mesh2, mesh4,
                                os.path.join(out_dir, f"ckpt{rank}"))
    res["imported"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "repro"))
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
