"""FRED, the deterministic simulator of the paper's protocol, ported from
`repro.sim`."""
from repro_torch.sim.fred import (
    SimConfig,
    SimState,
    build_step_fn,
    init_sim,
    run_simulation,
)
