"""FASGD core, ported from `repro.core`: the update-rule registry
(`rules`), step-staleness (`staleness`), B-FASGD gating (`bandwidth`), the
shared protocol core (`engine`), the bounded ingress queue (`queue`), the
modelled arrival processes (`scenarios`) and the round trainer
(`round_trainer`)."""
from repro_torch.core.bandwidth import BandwidthConfig, transmit_prob
from repro_torch.core.rules import (
    ServerConfig,
    ServerState,
    UpdateRule,
    apply_update,
    effective_scale,
    get_rule,
    init,
    register_rule,
    registered_rules,
    vbar,
)
from repro_torch.core.round_trainer import (
    RoundState,
    bandwidth_saved_bytes,
    build_round_step,
    init_round_state,
)
