"""Dry-run: the roofline and memory of every (architecture × input shape)
at the production mesh, counted on the meta device.

Ported from `repro.launch.dryrun`, which compiles each step for a 512-chip
TPU mesh.  Here each pair's step (train / prefill / decode) runs once at
full depth on meta tensors under `launch.analysis`'s counting modes, with
the production mesh's shardings (`sharding.rules` over
`make_production_mesh()`, 16×16 or 2×16×16) reckoned, not applied.  For
each pair it records:

 - memory per device: the arguments' and outputs' bytes under their specs,
   and an estimate of the temporaries (`analysis.temp_bytes`);
 - the counted FLOPs and bytes, split evenly over the chips, and the
   roofline terms on the card's published rates (`launch.mesh.card_rates`,
   the H100 SXM where no card is present).

The whole program is counted, so no 1- or 2-unit variants are compiled and
nothing is extrapolated.  A decode step runs at ``pos = S − 1``, a full
cache: the reference's program over the whole cache.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all              # every pair
  python -m repro_torch.launch.dryrun --all --multi-pod

Results append to build/dryrun/dryrun.jsonl at the root of the checkout
(one JSON object per line), unless ``--out`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun" / \
    "dryrun.jsonl"


def pair_list():
    """Every (arch, shape) to dry-run, with per-pair config overrides."""
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.configs.base import INPUT_SHAPES
    pairs = []
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape_name, shape in INPUT_SHAPES.items():
            if shape.kind == "decode" and not cfg.supports_decode():
                pairs.append((arch, shape_name, None, "encoder-only: no decode"))
                continue
            overrides = {}
            if shape_name == "long_500k" and not cfg.supports_long_context():
                # dense archs serve 500k with the sliding-window variant
                overrides["attn_window"] = 8192
            if shape.kind == "train":
                overrides["remat"] = True
            pairs.append((arch, shape_name, overrides, None))
    return pairs


def _out_shardings(kind: str, out, mesh):
    """Shardings of a step's outputs by the argument rules: the train
    step's new state as its state (its metrics replicated), logits as a
    batch, a cache by the cache rule."""
    from repro_torch.sharding import (batch_shardings, cache_shardings,
                                      state_shardings)
    from repro_torch.sharding.rules import NamedSharding, PartitionSpec
    from repro_torch.utils.trees import tree_map
    if kind == "train":
        state, metrics = out
        return (state_shardings(state, mesh),
                tree_map(lambda _: NamedSharding(mesh, PartitionSpec()),
                         metrics))
    seq_dim = 1 if kind == "prefill" else None
    if isinstance(out, tuple):               # (logits, cache)
        return (batch_shardings(out[0], mesh, seq_dim=seq_dim),
                cache_shardings(out[1], mesh))
    return batch_shardings(out, mesh, seq_dim=seq_dim)    # an encoder


def run_one(arch: str, shape_name: str, multi_pod: bool, out_path,
            overrides=None, tag: str = "baseline"):
    """Dry-run one (arch × shape × mesh): count the full-depth step once on
    the meta device, append a JSON record to `out_path`, and print the
    memory / cost / roofline summary."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import analysis
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import shardings_for
    from repro_torch.sharding import mesh_context

    t0 = time.time()
    cfg = get_config(arch, **(overrides or {}))
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = mesh.devices.size

    with mesh_context(mesh):
        fn, args, shard = shardings_for(cfg, shape, mesh)
        step = fn
        if shape.kind == "decode":
            def step(params, token, cache, pos):
                return fn(params, token, cache, shape.seq_len - 1)
        out, flops, hbm, peak = analysis.count_pass(step, args)
    mf = analysis.model_flops_estimate(cfg, shape)
    roof = analysis.analyze(arch, shape_name, mesh_name, chips, step, args,
                            shard, model_flops=mf,
                            costs=(flops, hbm, {}, peak))
    mem = dict(
        arg_bytes=analysis.bytes_per_device(args, shard),
        out_bytes=analysis.bytes_per_device(
            out, _out_shardings(shape.kind, out, mesh)),
        temp_bytes=analysis.temp_bytes(peak, shard),
        alias_bytes=0,
    )
    rec = roof.to_dict()
    rec["extrapolated"] = False
    rec.update(
        tag=tag,
        status="ok",
        compile_s=round(time.time() - t0, 1),
        mem=mem,
        overrides={k: v for k, v in (overrides or {}).items()},
    )
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    gib = lambda n: f"{n / 2**30:.2f}GiB"
    print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: OK "
          f"({rec['compile_s']}s counting pass)")
    print(f"  memory (reckoned): arg={gib(mem['arg_bytes'])} "
          f"temp={gib(mem['temp_bytes'])} (estimate) "
          f"out={gib(mem['out_bytes'])} (per device)")
    print(f"  cost (counted):  flops={roof.flops:.3e} bytes={roof.hbm_bytes:.3e} "
          f"coll_bytes={roof.coll_bytes:.3e}")
    print(f"  roofline:        compute={roof.compute_s*1e3:.2f}ms "
          f"memory={roof.memory_s*1e3:.2f}ms "
          f"collective={roof.collective_s*1e3:.2f}ms → {roof.bottleneck}-bound"
          f" ({roof.card})")
    return rec


def run_all(multi_pod: bool, out_path):
    """Dry-run every `pair_list` entry in this process (nothing here locks
    a device count), skipping pairs already recorded ok in `out_path`;
    exits nonzero on any failure."""
    done = set()
    if os.path.exists(out_path):
        mesh_name = "2x16x16" if multi_pod else "16x16"
        with open(out_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("mesh") == mesh_name and r.get("status") == "ok" \
                        and r.get("tag") == "baseline":
                    done.add((r["arch"], r["shape"]))

    failures = []
    t0 = time.time()
    for arch, shape_name, overrides, skip in pair_list():
        if skip:
            print(f"[dryrun] {arch} × {shape_name}: SKIP ({skip})")
            continue
        if (arch, shape_name) in done:
            print(f"[dryrun] {arch} × {shape_name}: cached")
            continue
        try:
            run_one(arch, shape_name, multi_pod, out_path,
                    overrides=overrides)
        except Exception as e:          # record it, go on to the next pair
            traceback.print_exc()
            print(f"[dryrun] {arch} × {shape_name}: FAILED: "
                  f"{type(e).__name__}: {e}")
            failures.append((arch, shape_name, f"{type(e).__name__}: {e}"))
        sys.stdout.flush()
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        sys.exit(1)
    print(f"all dry-runs passed ({time.time() - t0:.1f} s)")


def main(argv=None):
    """CLI entry point (see module docstring for usage)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of ModelConfig overrides")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)

    if args.all:
        run_all(args.multi_pod, args.out)
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    overrides = json.loads(args.overrides) if args.overrides else None
    if overrides is None:
        # default per-pair overrides from pair_list
        for arch, shape_name, ov, skip in pair_list():
            if arch == args.arch and shape_name == args.shape:
                if skip:
                    print(f"SKIP: {skip}")
                    return
                overrides = ov
                break
    run_one(args.arch, args.shape, args.multi_pod, args.out,
            overrides=overrides, tag=args.tag)


if __name__ == "__main__":
    main()
