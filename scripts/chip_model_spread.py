"""The model over four processes, one card each: llama3-8b's pod-sync FASGD
step (the default), or tinyllama-1.1b's round trainer (``--round-trainer``).

    python3 scripts/chip_model_spread.py   # four H100s of one host, within 700 s
    python3 scripts/chip_model_spread.py --round-trainer [--procs 1,2,4]
        [--batch 32] [--rounds 4]          # within 600 s

**Pod-sync** (the default): llama3-8b's step, which no single card holds
(≈ 157 GiB at bf16 statistics, twice an H100's 80 GB), placed by the
reference's shardings over a (data, model) mesh of processes.

The script starts four children of itself (card = rank), which join an
NCCL group through `launch.mesh.init_distributed_host_mesh` and run, on
meshes (2, 2) and (4, 1) in turn: llama3-8b at full width and depth in
bfloat16 with ``remat`` (`launch.steps.make_train_step`,
``use_fused_kernel``: `fasgd_update` on each process's shards, float32
statistics), its weights drawn on each card from seed 0 (whole for the
draw, then each process keeps its shard: `sharding.rules.place`), then
`STEPS` pod-sync steps at B = `B`, S = `S` on token batches from numpy
seed 29 (`launch.steps.place_args` places each).  Rank 0 prints each
rank's peak allocated bytes, state bytes and step times, the losses of
both meshes (which must agree within one bf16 rounding, 2^-8 relative),
and the step's MFU: `launch.analysis.model_flops_estimate` at that shape
over (seconds × the card's bf16 peak × 4), with the card's name and power
limit as ``nvidia-smi`` gives them.  Everything printed also goes to
``chiprun_out/model_spread.json``.  Exits 1 if a child fails, outlives
`TIMEOUT`, or the meshes disagree.

**Round trainer** (``--round-trainer``): `launch.train.main` in each of
1, 2 and 4 processes (``--procs``), one card each, over NCCL (torchrun's
variables set for 2 and 4): tinyllama-1.1b at full width and depth in
bf16 with ``--remat``, the fused round trainer with the
`fused_event_apply` kernel (fasgd, lr 0.01, c_fetch 0.5), C = 4 clients,
S = 1024, the global batch ``--batch`` (Bc = B / 4 rows a client, split
over the processes by the reference's 'bsd' rule), ``--rounds`` rounds.
Each process's final peak allocated bytes, rank 0's printed lines (each
round's loss and gates, the split line with a round's reduction: its
float32 bytes and median seconds) and the rate over rounds 2 onwards (the
step lines' times: each is printed once its round's loss is read off the
card and every rank's state digest compared) are printed and go to
``build/round_spread/round_spread.json``; the losses of 2 and 4 processes must
agree with one process's within one bf16 rounding (2^-8 relative, at the
printed 4 decimals), the gates and T exactly.  Exits 1 otherwise, or if a
child fails or outlives `TIMEOUT`.
"""
import dataclasses
import gc
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARCH = "llama3-8b"
WORLD = 4
MESHES = ((2, 2), (4, 1))
B, S, STEPS = 8, 1024, 3
LR = 0.001
TIMEOUT = 600                  # seconds for the whole group
BF16_ROUNDING = 2.0 ** -8
ROUND_ARCH = "tinyllama-1.1b"
ROUND_C, ROUND_S = 4, 1024


def child(rank, port, out):
    """One rank: join the group, run both meshes, rank 0 writes `out`."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, TrainerConfig
    from repro_torch.core import rules as server_rules
    from repro_torch.kernels import build, ops
    from repro_torch.launch import analysis, steps
    from repro_torch.launch.mesh import (card_rates,
                                         init_distributed_host_mesh,
                                         make_host_mesh)
    from repro_torch.models.transformer import init_model
    from repro_torch.sharding.rules import place, state_shardings
    from repro_torch.utils.trees import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    if rank == 0:
        build.build_all()
    group = init_distributed_host_mesh(
        WORLD, 1, coordinator_address=f"127.0.0.1:{port}",
        num_processes=WORLD, process_id=rank, devices=[dev])
    if rank != 0:
        build.build_all()        # after rank 0's build: reads its library
    dist.barrier()
    cfg = dataclasses.replace(get_config(ARCH), remat=True)
    tc = TrainerConfig(rule="fasgd", lr=LR, stats_dtype="float32",
                       use_fused_kernel=True)
    rng = np.random.default_rng(29)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)),
        "targets": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int64))}
        for _ in range(STEPS)]
    shape = InputShape("pod_sync", S, B, "train")
    model_flops = analysis.model_flops_estimate(cfg, shape)
    peak_flops = card_rates(torch.cuda.get_device_name(dev))[2]
    record = {"backend": dist.get_backend(), "meshes": {}}
    for data, model in MESHES:
        mesh = make_host_mesh(data, model, devices=list(group.devices.flat),
                              ranks=list(group.ranks.flat))
        shardings = (
            state_shardings(steps.abstract_server_state(cfg, tc), mesh),
            steps.batch_shardings(steps.batch_struct(cfg, B, S,
                                                     with_targets=True),
                                  mesh))
        t0 = time.perf_counter()
        whole = init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
        params = place(whole, shardings[0].params)
        del whole
        state = server_rules.init(steps.server_config(tc), params)
        del params
        step = steps.place_args(steps.make_train_step(cfg, tc), shardings)
        gc.collect()
        torch.cuda.empty_cache()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        state_bytes = sum(
            (t.to_local() if hasattr(t, "to_local") else t).numel()
            * t.element_size() for t in leaves(state._replace(extra=None)))
        losses, secs, launches = [], [], []
        for batch in batches:
            ops.reset_launches()
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
            torch.cuda.synchronize(dev)
            secs.append(time.perf_counter() - t)
            losses.append(float(m["loss"]))
            launches.append(ops.DEVICE_LAUNCHES["fasgd_update"])
        peak = torch.cuda.max_memory_allocated(dev)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        mine = {"losses": losses, "secs": secs, "peak": peak,
                "state_bytes": state_bytes, "init_s": init_s,
                "fasgd_update": launches}
        everyone = [None] * WORLD
        dist.all_gather_object(everyone, mine)
        steady = min(max(r["secs"][i] for r in everyone)
                     for i in range(1, STEPS))
        record["meshes"][f"{data}x{model}"] = {
            "ranks": everyone, "steady_step_s": steady,
            "tokens_per_s": B * S / steady,
            "mfu": model_flops / (steady * peak_flops * WORLD),
            "model_flops": model_flops}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
    dist.destroy_process_group()


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print("\n".join(smi))
    import torch
    if torch.cuda.device_count() < WORLD:
        print(f"chip_model_spread: {torch.cuda.device_count()} card(s), "
              f"needs {WORLD}", file=sys.stderr)
        return 2
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    out = out_dir / "model_spread_ranks.json"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    logs = [open(out_dir / f"model_spread_rank{r}.log", "w")
            for r in range(WORLD)]
    t0 = time.perf_counter()
    # the update allocates the new statistics in one 22 GiB buffer:
    # expandable segments keep the freed activations' blocks usable for it
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               str(port), str(out)], stdout=logs[r],
                              stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(p.returncode != 0 for p in procs):
        for r in range(WORLD):
            tail = (out_dir / f"model_spread_rank{r}.log").read_text()[-3000:]
            print(f"--- rank {r} (exit {procs[r].returncode}):\n{tail}")
        return 1
    record = json.loads(out.read_text())
    record["card"] = smi
    record["seconds"] = time.perf_counter() - t0
    record["shape"] = {"arch": ARCH, "B": B, "S": S, "steps": STEPS,
                       "remat": True, "stats": "float32"}
    print(f"{ARCH} pod-sync over {WORLD} processes, one card each "
          f"({record['backend']}), B = {B}, S = {S}, remat, bf16 weights, "
          f"float32 statistics, fasgd_update kernel; {record['seconds']:.1f}"
          f" s in all")
    for name, m in record["meshes"].items():
        for r, got in enumerate(m["ranks"]):
            print(f"  {name} rank {r}: losses {got['losses']}, steps "
                  f"{[round(s, 3) for s in got['secs']]} s, peak "
                  f"{got['peak'] / 2**30:.2f} GiB allocated, state "
                  f"{got['state_bytes'] / 2**30:.2f} GiB, fasgd_update "
                  f"{got['fasgd_update']}, drawn and placed in "
                  f"{got['init_s']:.1f} s")
        print(f"  {name}: steady step {m['steady_step_s']:.3f} s, "
              f"{m['tokens_per_s']:.0f} tokens/s, MFU {m['mfu']:.4f} "
              f"(model FLOPs {m['model_flops']:.4e} a step)")
    a, b = (record["meshes"][f"{d}x{m}"]["ranks"][0]["losses"]
            for d, m in MESHES)
    worst = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    record["loss_agreement"] = worst
    print(f"  losses (2, 2) vs (4, 1): worst relative difference {worst:.2e}"
          f" (one bf16 rounding: {BF16_ROUNDING:.2e})")
    (out_dir / "model_spread.json").write_text(json.dumps(record, indent=1))
    return 0 if worst <= BF16_ROUNDING else 1


def round_argv(batch, rounds):
    return ["--arch", ROUND_ARCH, "--clients", str(ROUND_C), "--batch",
            str(batch), "--seq", str(ROUND_S), "--steps", str(rounds),
            "--apply-mode", "fused", "--use-fused-kernel", "--remat",
            "--lr", "0.01", "--c-fetch", "0.5", "--log-every", "1"]


def round_child(rank, world, port, out, batch, rounds):
    """One process of a round-trainer run: `launch.train.main` with
    torchrun's variables (for a group), its lines kept with the time of
    each write; writes {rank, peak, text, step_times} to `out`."""
    import contextlib
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.launch import train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    build.build_all()           # built by the parent already: a no-op
    if world > 1:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    lines = []

    class Stamped:
        def write(self, s):
            lines.append((time.perf_counter(), s))
            return len(s)

        def flush(self):
            pass

    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(Stamped()):
        train.main(round_argv(batch, rounds))
    record = {"rank": rank, "peak": torch.cuda.max_memory_allocated(),
              "text": "".join(s for _, s in lines),
              "step_times": [t for t, s in lines
                             if s.startswith("  step ")],
              "backend": (torch.distributed.get_backend() if world > 1
                          else None)}
    with open(out, "w") as f:
        json.dump(record, f)
    if world > 1:
        torch.distributed.destroy_process_group()


def _round_lines(text):
    """Each printed round's (loss, pushes, fetches, T)."""
    import re
    return [(float(m[0]), m[1], m[2], int(m[3])) for m in re.findall(
        r"loss=(\S+) tau=\S+ push=(\S+) fetch=(\S+) T=(\d+)", text)]


def round_main(procs, batch, rounds) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print("\n".join(smi))
    import torch
    if torch.cuda.device_count() < max(procs):
        print(f"chip_model_spread: {torch.cuda.device_count()} card(s), "
              f"needs {max(procs)}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.build_all()
    out_dir = ROOT / "build" / "round_spread"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    record = {"card": smi, "shape": {"arch": ROUND_ARCH, "C": ROUND_C,
                                     "B": batch, "S": ROUND_S,
                                     "rounds": rounds, "remat": True},
              "runs": {}}
    ok = True
    for world in procs:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        outs = [out_dir / f"round_spread_{world}_rank{r}.json"
                for r in range(world)]
        logs = [open(out_dir / f"round_spread_{world}_rank{r}.log", "w")
                for r in range(world)]
        t0 = time.perf_counter()
        ps = [subprocess.Popen(
            [sys.executable, __file__, "--round-rank", str(r), str(world),
             str(port), str(outs[r]), str(batch), str(rounds)],
            stdout=logs[r], stderr=subprocess.STDOUT, env=env)
            for r in range(world)]
        deadline = time.monotonic() + TIMEOUT
        try:
            for p in ps:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        if any(p.returncode != 0 for p in ps):
            for r in range(world):
                tail = (out_dir / f"round_spread_{world}_rank{r}.log"
                        ).read_text()[-3000:]
                print(f"--- {world} processes, rank {r} (exit "
                      f"{ps[r].returncode}):\n{tail}")
            ok = False
            continue
        ranks = [json.loads(o.read_text()) for o in outs]
        text = ranks[0]["text"]
        stamps = ranks[0]["step_times"]
        rate = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        split = [line for line in text.splitlines()
                 if line.startswith("[train] split:")]
        record["runs"][world] = {
            "seconds": time.perf_counter() - t0, "backend":
            ranks[0]["backend"], "peaks": [r["peak"] for r in ranks],
            "rounds_per_s": rate, "tokens_per_s": rate * batch * ROUND_S,
            "rounds": _round_lines(text), "split": split, "text": text}
        print(f"{world} process(es) ({ranks[0]['backend'] or 'one card'}): "
              f"{rate:.3f} rounds/s over rounds 2-{rounds} "
              f"({rate * batch * ROUND_S:.0f} tokens/s), peaks "
              f"{[round(r['peak'] / 2**30, 2) for r in ranks]} GiB, "
              f"{record['runs'][world]['seconds']:.1f} s in all")
        for line in text.splitlines():
            print(f"    | {line}")
    base = record["runs"].get(min(procs))
    for world, run in record["runs"].items():
        if base is None or world == min(procs):
            continue
        worst = max(abs(a[0] - b[0]) / abs(b[0])
                    for a, b in zip(run["rounds"], base["rounds"]))
        same = [a[1:] for a in run["rounds"]] == \
            [b[1:] for b in base["rounds"]]
        run["loss_agreement"] = worst
        print(f"{world} processes vs {min(procs)}: losses within {worst:.2e} "
              f"(one bf16 rounding: {BF16_ROUNDING:.2e}), gates and T "
              f"{'equal' if same else 'DIFFER'}, rounds/s "
              f"{run['rounds_per_s'] / base['rounds_per_s']:.3f}x")
        ok = ok and worst <= BF16_ROUNDING and same
    (out_dir / "round_spread.json").write_text(json.dumps(record, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if len(sys.argv) == 8 and sys.argv[1] == "--round-rank":
        round_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                    sys.argv[5], int(sys.argv[6]), int(sys.argv[7]))
        sys.exit(0)
    if len(sys.argv) > 1 and sys.argv[1] == "--round-trainer":
        import argparse
        ap = argparse.ArgumentParser()
        ap.add_argument("--round-trainer", action="store_true")
        ap.add_argument("--procs", default="1,2,4")
        ap.add_argument("--batch", type=int, default=32)
        ap.add_argument("--rounds", type=int, default=4)
        a = ap.parse_args()
        sys.exit(round_main([int(p) for p in a.procs.split(",")], a.batch,
                            a.rounds))
    sys.exit(main())
