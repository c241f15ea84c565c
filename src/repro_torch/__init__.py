"""FASGD on PyTorch and CUDA: a port of the `repro` JAX package for NVIDIA Hopper.

The layout mirrors the JAX package: `repro_torch/<sub>/<mod>.py` ports
`repro/<sub>/<mod>.py`.  This package imports `torch` and never `jax`.

- `core.rules`     — the update-rule registry (asgd / sasgd / exp / poly /
                     fasgd), `ServerState`, eqs. 4–8
- `core.bandwidth` — the eq. 9 B-FASGD transmit probability
- `core.engine`    — gates, gated / serial / fused application, counters
- `core.queue`, `core.scenarios` — the bounded ingress queue and the
                     modelled arrival processes (stragglers, churn, ...)
- `core.round_trainer` — C divergent copies stepped a round at a time
                     (`build_round_step`, with `configs.base.TrainerConfig`)
- `sim.fred`       — the FRED simulator (`run_simulation`)
- `kernels.ops`    — the two server-update kernels and flash attention,
                     hand-written in CUDA for `sm_90a`; a CPU tensor takes
                     their plain PyTorch version (`kernels.ref`), a CUDA
                     tensor launches the kernel or raises
- `models.mlp`, `data.mnist` — the paper's 784-200-10 MLP and the
                     synthetic MNIST stand-in
- `configs`, `models.{layers,attention,transformer,serving,api}` — the
                     dense GQA decoders (tinyllama-1.1b, llama3-8b, yi-9b,
                     yi-34b): forward, prefill and decode
- `launch.serve`   — batched LM serving (`serve`, and its CLI)
- `launch.train`, `launch.steps` — the training CLI (round trainer or the
                     pod-sync step), the step functions and abstract
                     (meta-device) input specs
- `checkpoint`, `optim`, `sharding` — tree checkpoints in the reference's
                     layout, the baseline optimizers, the FSDP spec rules
- `utils.trees`, `utils.convert`, `utils.rng` — parameter trees in JAX's
                     leaf order, numpy round trips, and the RNG seam

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
