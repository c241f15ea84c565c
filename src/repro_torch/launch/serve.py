"""LM serving: batched prefill, then token-by-token decode.

Ported from `repro.launch.serve` (every decoder family: the dense
decoders, the VLM, the MoE decoders, the SSM and the hybrid):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --batch 4 --prompt-len 2048 --gen 32 --temperature 0
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch phi-3-vision-4.2b --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --batch 4 --prompt-len 2048 --gen 32 --temperature 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --batch 4 --prompt-len 2048 --gen 32 --temperature 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b \\
      --smoke --device cpu

mamba2-1.3b and zamba2-7b decode from an O(1) state (`models.serving`):
the prefill's state carries over as it is, and only zamba2's shared
attention block keeps a cache that grows with the sequence.

grok-1-314b and deepseek-v2-236b do not fit one card at their published
depth, and the CLI, like the reference's, has no depth flag: a caller
serves them through `serve` with a config cut in depth only,
``dataclasses.replace(get_config(name), num_layers=4)`` (`chip_smoke.py`
phase 17).

It runs on the card unless given ``--device cpu`` (use ``--smoke`` there:
the reduced configuration).  Weights are random, from ``--seed``, at the
reference's scales; prompts are uniform random tokens from ``--seed + 1``
(`models.api.make_batch`: for the VLM ``--prompt-len`` counts its image
tokens, whose embeddings are random too).  Prints prefill and decode
tokens/s.  An encoder (hubert-xlarge) has no decode step and is refused,
as the reference refuses it; `models.serving.encode` is its inference
entry point.  `serve` is the loop itself, for callers that bring their
own weights and prompts.

Started by ``torchrun`` (or under ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) it joins that group as `launch.train`
does: a ``(data=world, model=1)`` mesh, the weights placed by
`param_shardings`, the prompts by `batch_shardings` and the cache by
`cache_shardings`, each process holding its shards.  Serving over more
than one process runs the dense family only: the VLM, MoE, SSM and
hybrid families are refused there (ROADMAP queue 1, item 10b), as they
are in `launch.train`'s pod-sync step; `launch.train`'s round trainer
runs every family but the MoE over a group.  `serve` takes weights
placed so under a `sharding.rules.mesh_context` of their mesh.
"""
from __future__ import annotations

import argparse
import collections
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import is_spread, make_host_mesh
from repro_torch.launch.train import SPREAD_REFUSAL, group_mesh
from repro_torch.models.api import make_batch, param_count
from repro_torch.models.serving import decode_step, grow_cache, prefill
from repro_torch.models.transformer import init_model
from repro_torch.sharding.rules import (batch_shardings, gather,
                                        get_mesh_context, mesh_context,
                                        param_shardings, place)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import leaves


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _next_token(logits, temperature: float, generator):
    """[B, 1] next tokens from the last position's logits [B, 1, V]:
    arg-max at temperature 0, else a draw from softmax(logits / T)."""
    last = logits[:, -1, :]
    if temperature > 0:
        probs = torch.softmax(last.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(last, dim=-1, keepdim=True)


def serve(cfg: ModelConfig, params, tokens, gen: int, *,
          temperature: float = 0.0, seed: int = 0, device=None,
          image_embeds=None):
    """Prefill `tokens` [B, S_text] (after `image_embeds` [B, P, F] for the
    VLM, S = P + S_text positions in all), then generate `gen` tokens per
    row.

    The prefill's cache grows to S + gen slots (`grow_cache`), then gen − 1
    decode steps follow (the first token comes from the prefill's logits).
    Sampling draws from a generator seeded with `seed` on `device`.  Runs on
    `device` (the card unless the caller passes another), where `params`
    must already be.  Under a mesh context spread over processes the
    weights are placed DTensors (`sharding.rules.place`): the prompt and
    each next token are placed by `batch_shardings`, the cache by
    `cache_shardings`, and every process draws the same tokens from the
    gathered logits.  Returns a dict: ``tokens`` [B, gen] (the generated
    tokens), ``prefill_logits`` [B, S, V], ``last_logits`` [B, 1, V] (those
    the last token was chosen from), ``prefill_s`` and ``decode_s`` (host
    clock, ending in a device synchronise).
    """
    device = resolve_device(device)
    if gen < 1:
        raise ValueError(f"gen must be at least 1, got {gen}")
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode "
                         f"step (models.serving.encode runs it)")
    if (image_embeds is not None) != (cfg.arch_type == "vlm"):
        raise ValueError(f"{cfg.name}: image_embeds go with a VLM, and a "
                         f"VLM needs them")
    for t in leaves(params):
        if t.device.type != device.type:
            raise ValueError(f"params are on {t.device}, serving on {device}")
    batch = {"tokens": tokens.to(device)}
    if image_embeds is not None:
        batch["image_embeds"] = image_embeds.to(device)
    mesh = get_mesh_context()
    if mesh is None or not is_spread(mesh):
        placed = lambda b: b
    else:
        placed = lambda b: place(b, batch_shardings(b, mesh))
    generator = torch.Generator(device=device).manual_seed(seed)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, placed(batch))
    S = logits.shape[1]
    tok = _next_token(gather(logits[:, -1:]), temperature, generator)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    cache = grow_cache(cfg, cache, S + gen)
    out, last = [tok], logits[:, -1:]
    _sync(device)
    t0 = time.perf_counter()
    for i in range(gen - 1):
        last, cache = decode_step(params, cfg, placed({"t": tok})["t"],
                                  cache, S + i)
        tok = _next_token(gather(last), temperature, generator)
        out.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1), "prefill_logits": logits,
            "last_logits": last, "prefill_s": prefill_s,
            "decode_s": decode_s}


def main(argv=None):
    """CLI entry point (see the module docstring)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run there; default: the card")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.supports_decode():
        ap.error(f"{cfg.name} is encoder-only: it has no decode step")
    device = resolve_device(args.device)
    spread = group_mesh(device)
    if spread is not None and cfg.arch_type != "dense":
        ap.error(SPREAD_REFUSAL)
    if spread is not None:
        device = spread.devices.flat[spread.ranks.flatten().tolist().index(
            torch.distributed.get_rank())]
    mesh = spread or make_host_mesh(data=1, devices=[device])
    params = init_model(torch.Generator(device=device).manual_seed(args.seed),
                        cfg, device=device)
    B, S = args.batch, args.prompt_len
    print(f"[serve] {cfg.name}: {param_count(params):,} params, "
          f"batch={B} prompt={S} gen={args.gen} on {device}"
          + (f", mesh={collections.OrderedDict(mesh.shape)}"
             if spread is not None else ""))
    if spread is not None:
        params = place(params, param_shardings(params, mesh))
    batch = make_batch(cfg, B, S, torch.Generator(device=device).manual_seed(
        args.seed + 1))
    with mesh_context(mesh):
        res = serve(cfg, params, batch["tokens"], args.gen,
                    temperature=args.temperature, seed=args.seed + 2,
                    device=device, image_embeds=batch.get("image_embeds"))
    print(f"  prefill: {B * S} tokens in {res['prefill_s']:.3f}s "
          f"({B * S / res['prefill_s']:.0f} tok/s)")
    n_dec = B * (args.gen - 1)
    print(f"  decode: {B}×{args.gen - 1} steps in {res['decode_s']:.3f}s "
          f"({n_dec / max(res['decode_s'], 1e-9):.0f} tok/s)")
    print(f"  sample[0]: {res['tokens'][0].tolist()}")
    return res


if __name__ == "__main__":
    main()
