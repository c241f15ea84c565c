"""Training entry point: FASGD (round-based or pod-sync) on any assigned
arch.

Ported from `repro.launch.train`, with its flags, defaults, refusals and
printed lines, so a reference command line runs with ``repro.`` replaced
by ``repro_torch.``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --device cpu --steps 100 --clients 4 --rule fasgd \\
      --c-fetch 2.0

Modes:
  --clients C > 0 → the divergent-copy round trainer (core.round_trainer):
      C client groups, B-FASGD push/fetch gating, real staleness; with
      --use-fused-kernel the server applies through the CUDA kernels
      (`fasgd_update` once a candidate push with --apply-mode serial,
      `fused_event_apply` once a round with fused).
  --clients 0     → the pod-sync FASGD step (launch.steps.make_train_step):
      one gradient + FASGD server update per step.

It runs on the card unless given ``--device cpu`` (use ``--smoke`` there,
the reduced configuration; the kernels then take their plain versions).
``--remat`` recomputes each layer's activations in the backward
(`ModelConfig.remat`, which the reference's CLI takes from the config
alone).

Started by ``torchrun`` (or with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
and ``MASTER_PORT`` set otherwise) it joins that group
(`launch.mesh.init_distributed_host_mesh`), as the reference's launcher
takes every device of its process group: the mesh is then ``(data=world,
model=1)``.  With ``--clients C > 0`` (the dense, VLM, audio, SSM and
hybrid families) every process holds the whole round state and computes
the gradients of its rows of every client's micro-batch, by the
reference's 'bsd' rule (`sharding.rules.row_slice`: rows [r·Bc/w,
(r+1)·Bc/w) where w divides Bc; otherwise every process computes the
whole micro-batch and nothing is reduced); the losses and gradients are
averaged over the group once a round (`sharding.reduce.GroupMean`,
float32 buckets), so every process steps the same state, which
`sharding.reduce.check_replicas` checks every ``--log-every`` rounds.
Only rank 0 prints the round lines and writes the checkpoint; every rank
resumes from it.  With ``--clients 0`` the state and each batch are
placed by the reference's shardings (`launch.steps.place_args`) and every
process holds its shard of each leaf: the dense family only.  The MoE
family's round trainer (its capacity and aux loss route the whole
micro-batch) and the other families' pod-sync step are refused over more
than one process (ROADMAP queue 1, item 10b).
Weights are random, from ``--seed``.  Round r's gates are
``native_round_draws(...).round(r)``, keyed by the step, and its batch a
function of the step alone, so a run resumed from ``--ckpt-dir`` replays
the uninterrupted run's rounds.  Pod-sync mode saves the parameters at
``--ckpt-every`` and does not resume, as in the reference.  `main(argv)`
returns the final state (a `RoundState`, or the pod-sync `ServerState`).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import statistics
import time

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainerConfig
from repro_torch.core import rules as server_rules
from repro_torch.core import scenarios
from repro_torch.core import server_shard
from repro_torch.core.round_trainer import (
    build_round_step, init_round_state, native_round_draws,
    shard_round_state)
from repro_torch.data.tokens import TokenDataConfig
from repro_torch.data.tokens import make_batch as make_token_batch
from repro_torch.launch.mesh import (init_distributed_host_mesh,
                                     make_host_mesh, make_server_mesh)
from repro_torch.launch.steps import (abstract_server_state, batch_struct,
                                      make_train_step, place_args,
                                      server_config)
from repro_torch.models.api import make_batch, make_dict_grad_fn, param_count
from repro_torch.models.lm import make_lm_loss
from repro_torch.models.transformer import init_model
from repro_torch.sharding.reduce import GroupMean, check_replicas
from repro_torch.sharding.rules import (batch_shardings, place, row_slice,
                                        state_shardings)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import leaves


def batch_for_step(cfg, B, S, step, device=None):
    """The batch of `step`, a function of the step alone: Markov-chain
    tokens (`data.tokens`) for the token archs, `models.api.make_batch`'s
    random embeddings from a generator seeded by (7, step) for audio and
    VLM; on `device` (the card unless the caller passes another)."""
    device = resolve_device(device)
    if cfg.arch_type in ("audio", "vlm"):
        g = torch.Generator(device=device).manual_seed((7 << 32) + step)
        return make_batch(cfg, B, S, g)
    tcfg = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B)
    tokens, targets = make_token_batch(tcfg, step, device=device)
    return {"tokens": tokens, "targets": targets}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


SPREAD_REFUSAL = ("over more than one process the port runs the round "
                  "trainer (--clients > 0) of every family but the MoE, "
                  "and the dense family's pod-sync step and serving only "
                  "(ROADMAP queue 1, item 10b)")


def group_mesh(device):
    """The host mesh of the group the environment names (torchrun's
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): ``(data=
    world, model=1)`` over its processes, each on `device` (its card
    there, ``rank % device_count``); without them, or for one process,
    None."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or "RANK" not in os.environ:
        return None
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["RANK"])
                              % torch.cuda.device_count())
    return init_distributed_host_mesh(
        world, 1, coordinator_address=f"{os.environ['MASTER_ADDR']}:"
        f"{os.environ['MASTER_PORT']}", num_processes=world,
        process_id=int(os.environ["RANK"]), devices=[device])


def main(argv=None):
    """CLI entry point: round-based (--clients C > 0) or pod-sync FASGD
    training on the assigned arch (see the module docstring).  Returns the
    final state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--rule", default="fasgd",
                    choices=list(server_rules.registered_rules()))
    ap.add_argument("--lr", type=float, default=0.005)
    ap.add_argument("--clients", type=int, default=4,
                    help="round-trainer client groups; 0 = pod-sync step")
    ap.add_argument("--apply-mode", default="serial", choices=["serial", "fused"])
    ap.add_argument("--fused-mode", default="auto",
                    choices=["auto", "materialized", "cotangent"],
                    help="fused-apply gradient reduction: 'auto' rides the "
                         "engine's cotangent path for v-independent rules "
                         "when eligible, 'materialized' forces the [C, P] "
                         "per-event reduction, 'cotangent' demands the "
                         "contraction (error if ineligible)")
    ap.add_argument("--drop-policy", default="local_apply",
                    choices=["local_apply", "discard"],
                    help="what a gated-out push does with its gradient "
                         "(cotangent reduction needs 'discard')")
    ap.add_argument("--c-push", type=float, default=0.0)
    ap.add_argument("--c-fetch", type=float, default=0.0)
    ap.add_argument("--per-tensor", action="store_true",
                    help="gate each parameter tensor independently on both "
                         "directions (per-leaf eq. 9 + per-tensor staleness)")
    ap.add_argument("--variant", default="intent", choices=["intent", "literal"])
    ap.add_argument("--queue-capacity", type=int, default=0,
                    help="bounded server ingress queue (core/queue.py); "
                         "0 = apply pushes immediately")
    ap.add_argument("--drain-policy", default="drain_all",
                    choices=["drain_all", "drain_k", "adaptive"],
                    help="how many queued pushes each round applies")
    ap.add_argument("--drain-k", type=int, default=1,
                    help="per-round drain budget (drain_k; adaptive floor)")
    ap.add_argument("--admission-policy", default="block",
                    choices=["block", "reject", "drop_oldest"],
                    help="what happens to a push arriving at a full queue")
    ap.add_argument("--scenario", default="off",
                    choices=["off"] + sorted(scenarios.SCENARIO_PRESETS),
                    help="modeled arrival process (core/scenarios.py): "
                         "rounds get wall-clock durations from per-client "
                         "service draws; pushes apply fastest-first")
    ap.add_argument("--kasync-k", type=int, default=0,
                    help="partial-barrier K for --rule kasync "
                         "(0 = clients // 2 when the rule is kasync)")
    ap.add_argument("--use-fused-kernel", action="store_true",
                    help="route the server apply through the CUDA kernels "
                         "(fasgd_update serial, fused_event_apply fused); "
                         "on the CPU their plain versions run")
    ap.add_argument("--kernel-interpret", default="auto",
                    choices=["auto", "on", "off"],
                    help="the reference's Pallas interpret-mode toggle: "
                         "accepted, no effect in the port (the tensors' "
                         "device picks the kernel path)")
    ap.add_argument("--kernel-block-rows", type=int, default=0,
                    help="the reference's TPU tile height: accepted, no "
                         "effect in the port")
    ap.add_argument("--server-shards", type=int, default=1,
                    help="partition the server state (W + eq. 4-6 stats) "
                         "into S shards along a 'server' mesh axis "
                         "(core/server_shard.py); 1 = one whole server; "
                         "this process holds every shard, on --device (under "
                         "torchrun every process holds all S on its own "
                         "device; spreading them over the processes is "
                         "ROADMAP queue 1, item 10d)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer's activations in the "
                         "backward (ModelConfig.remat; the reference's CLI "
                         "takes it from the config alone)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run there; default: the card")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    scn = (None if args.scenario == "off"
           else scenarios.preset(args.scenario))
    if scn is not None and args.clients <= 0:
        ap.error("--scenario needs the round trainer (--clients C > 0)")
    if args.server_shards > 1 and args.clients <= 0:
        ap.error("--server-shards needs the round trainer (--clients C > 0)")
    device = resolve_device(args.device)
    kasync_k = args.kasync_k
    if args.rule == "kasync" and kasync_k == 0:
        # a full-barrier default would make kasync ≡ ssgd; half the fleet
        # is the interesting operating point out of the box
        kasync_k = max(1, args.clients // 2)
    tc = TrainerConfig(
        num_round_clients=max(args.clients, 1), rule=args.rule, lr=args.lr,
        c_push=args.c_push, c_fetch=args.c_fetch, variant=args.variant,
        per_tensor_push=args.per_tensor, per_tensor_fetch=args.per_tensor,
        fused_mode=args.fused_mode, drop_policy=args.drop_policy,
        queue_capacity=args.queue_capacity, drain_policy=args.drain_policy,
        drain_k=args.drain_k, admission_policy=args.admission_policy,
        scenario=scn, kasync_k=kasync_k,
        server_shards=args.server_shards,
        use_fused_kernel=args.use_fused_kernel,
        kernel_interpret=(None if args.kernel_interpret == "auto"
                          else args.kernel_interpret == "on"),
        kernel_block_rows=args.kernel_block_rows,
        seed=args.seed,
    )
    spread = group_mesh(device)
    if spread is not None and (
            (args.clients > 0 and cfg.arch_type == "moe")
            or (args.clients <= 0 and cfg.arch_type != "dense")):
        ap.error(SPREAD_REFUSAL)
    # over a group only rank 0 prints the round trainer's lines
    rank0 = spread is None or torch.distributed.get_rank() == 0
    say = print if rank0 else (lambda *_: None)
    # one process on one device: the mesh is (1, 1); a group: (world, 1)
    mesh = spread or make_host_mesh(data=1, devices=[device])
    if spread is not None:
        device = spread.devices.flat[spread.ranks.flatten().tolist().index(
            torch.distributed.get_rank())]

    params = init_model(torch.Generator(device=device).manual_seed(args.seed),
                        cfg, device=device)
    print(f"[train] {cfg.name}: {param_count(params):,} params, "
          f"rule={args.rule}, clients={args.clients}, "
          f"mesh={collections.OrderedDict(mesh.shape)}")

    grad_fn = make_dict_grad_fn(cfg)
    # token archs get the shared/delta event-batched loss so the fused
    # cotangent reduction applies to the transformer stack (models/lm.py);
    # audio/vlm batches carry extra modal keys the adapter doesn't thread.
    batched_loss_fn = None
    if cfg.arch_type not in ("audio", "vlm"):
        lm_loss = make_lm_loss(cfg)

        def batched_loss_fn(W, deltas, batch):
            return lm_loss.event_batched(
                W, deltas, batch["tokens"], batch["targets"])

    if args.clients > 0:
        state = init_round_state(tc, params, device)
        draws = native_round_draws(tc, params, device)
        del params
        start = 0
        if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
            # restored whole, then placed on the shards
            state, start, _ = restore_checkpoint(args.ckpt_dir, state)
            say(f"[train] resumed from step {start}")
        if tc.server_shards > 1:
            smesh = make_server_mesh(server=tc.server_shards,
                                     devices=[device] * tc.server_shards)
            server_shard.validate_server_mesh(
                smesh, tc.server_shards, tc.server_axis)
            state = shard_round_state(state, smesh, tc.server_axis)
            say(f"[train] server sharded: {tc.server_shards} shards on "
                f"axis '{tc.server_axis}' (mesh {dict(smesh.shape)})")
        C = args.clients
        assert args.batch % C == 0, "global batch must divide clients"
        Bc = args.batch // C
        rows = reduce = None
        if spread is not None:
            rows = row_slice((Bc, args.seq, cfg.d_model), mesh)
            if rows is None:
                say(f"[train] split: data={mesh.shape['data']} does not "
                    f"divide a client's {Bc} rows: every process computes "
                    f"the whole micro-batch and nothing is reduced (the "
                    f"reference splits the sequence; ROADMAP queue 1, item "
                    f"10d)")
            else:
                reduce = GroupMean()
        step_fn = build_round_step(
            tc, grad_fn, apply_mode=args.apply_mode,
            batched_loss_fn=batched_loss_fn, reduce=reduce)

        _sync(device)
        t0 = time.time()
        for step in range(start, args.steps):
            flat = batch_for_step(cfg, args.batch, args.seq, step, device)
            batch = {k: l.reshape((C, Bc) + tuple(l.shape[1:]))
                     for k, l in flat.items()}
            if rows is not None:
                batch = {k: l[:, rows].contiguous() for k, l in batch.items()}
            state, m = step_fn(state, batch, draws.round(step))
            if step % args.log_every == 0 or step == args.steps - 1:
                if spread is not None:
                    check_replicas(state)
                wall = (f" wall={float(m['wall']):.2f}"
                        if "wall" in m else "")
                say(f"  step {step:5d} loss={float(m['loss']):.4f} "
                    f"tau={float(m['mean_tau']):.2f} "
                    f"push={int(m['pushes'])}/{C} fetch={int(m['fetches'])}/{C} "
                    f"T={int(m['timestamp'])}{wall}")
            if args.ckpt_every and args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                # the state is whole and the same on every process
                if rank0:
                    save_checkpoint(args.ckpt_dir, step + 1, state)
                if spread is not None:
                    torch.distributed.barrier()
        _sync(device)
        dt = time.time() - t0
        say(f"[train] done: {args.steps - start} rounds in {dt:.1f}s "
            f"({(args.steps - start) / max(dt, 1e-9):.2f} rounds/s)")
        if reduce is not None:
            w = mesh.shape["data"]
            # the first round's reduction also sets up the collective
            secs = reduce.seconds[1:] or reduce.seconds
            say(f"[train] split: rows [{rows.start}, {rows.stop}) of each "
                f"client's {Bc} on rank 0, {Bc // w} on each of {w} "
                f"processes; one mean over 'data' a round: "
                f"{reduce.buckets} float32 bucket(s), "
                f"{reduce.bytes / 2**20:.2f} MiB, "
                f"{statistics.median(secs):.4f} s a round (median over "
                f"{len(secs)} rounds)")
        cnt = state.counters
        sent = float(cnt.push_bytes_sent + cnt.fetch_bytes_sent)
        total = float(cnt.push_bytes_total + cnt.fetch_bytes_total)
        if total > 0:
            say(f"[train] bandwidth: {sent / 2**20:.1f} MiB sent of "
                f"{total / 2**20:.1f} MiB potential "
                f"({sent / total:.1%} transmitted, "
                f"{total / max(sent, 1e-9):.1f}x reduction)")
        if args.queue_capacity:
            w = max(int(cnt.queue_windows), 1)
            say(f"[train] queue: {int(cnt.queue_drained)} drained / "
                f"{int(cnt.queue_enqueued)} admitted "
                f"({int(cnt.queue_rejected)} rejected, "
                f"{int(cnt.queue_dropped)} dropped), "
                f"mean depth {float(cnt.queue_depth_sum) / w:.2f}, "
                f"peak {int(cnt.queue_depth_peak)}, "
                f"mean latency "
                f"{float(cnt.queue_latency_sum) / max(int(cnt.queue_drained), 1):.2f} T-ticks")
        if args.use_fused_kernel:
            n_leaves = len(leaves(server_shard.like(state.server).params))
            launches = int(cnt.kernel_launches)
            windows = launches // max(n_leaves, 1)
            events = int(cnt.kernel_events)
            say(f"[train] kernel: {launches} launches "
                f"({windows} apply windows x {n_leaves} leaves), "
                f"{events} events consumed "
                f"({events / max(windows, 1):.1f} events/window)")
        if tc.server_shards > 1:
            say(f"[train] shards: {tc.server_shards} server shards, "
                f"{int(cnt.shard_events)} events over "
                f"{int(cnt.shard_applies)} apply windows "
                f"(peak window batch {int(cnt.shard_depth_peak)}), "
                f"peak resident "
                f"{float(cnt.shard_bytes_peak) / 2**20:.2f} MiB/shard")
        if scn is not None:
            rounds = max(int(cnt.scenario_windows), 1)
            k_used = (tc.kasync_k or C) if server_rules.get_rule(
                args.rule).synchronous else C
            say(f"[train] scenario '{args.scenario}': "
                f"wall={float(cnt.wall_clock):.2f} "
                f"({float(cnt.wall_clock) / rounds:.3f}/round, "
                f"barrier {k_used}/{C}), "
                f"mean active {float(cnt.scenario_active_sum) / rounds:.1f}"
                f"/{C} over {rounds} rounds")
    else:
        scfg = server_config(tc)
        train_step = make_train_step(cfg, tc)
        if spread is not None:
            # each process keeps its shard of θ, then makes n, b, v and T
            # of its shard alone; each batch is placed by the same rule
            shardings = (state_shardings(abstract_server_state(cfg, tc),
                                         mesh),
                         batch_shardings(batch_struct(
                             cfg, args.batch, args.seq, with_targets=True),
                             mesh))
            params = place(params, shardings[0].params)
            train_step = place_args(train_step, shardings)
        state = server_rules.init(scfg, params)
        del params
        _sync(device)
        t0 = time.time()
        for step in range(args.steps):
            batch = batch_for_step(cfg, args.batch, args.seq, step, device)
            state, m = train_step(state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"  step {step:5d} loss={float(m['loss']):.4f} "
                      f"scale={float(m['mean_scale']):.5f}")
            if args.ckpt_every and args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, step + 1, state.params)
        _sync(device)
        dt = time.time() - t0
        print(f"[train] done: {args.steps} steps in {dt:.1f}s")
        print(f"[train] rate: {args.steps / max(dt, 1e-9):.3f} steps/s, "
              f"{args.steps * args.batch * args.seq / max(dt, 1e-9):.0f} "
              f"tokens/s")
    return state


if __name__ == "__main__":
    main()
