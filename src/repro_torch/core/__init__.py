"""FASGD core, ported from `repro.core`: the update-rule registry
(`rules`), step-staleness (`staleness`), B-FASGD gating (`bandwidth`) and
the shared protocol core (`engine`)."""
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
