"""B-FASGD bandwidth gating (paper §2.3), ported from `repro.core.bandwidth`.

A client transmits (push or fetch) at an opportunity iff

    r < 1 / (1 + c / (v̄ + ε)),   r ~ U[0,1]                     (eq. 9)

with v̄ the mean over all parameters of the gradient-std moving average.
`c = 0` gives probability exactly 1.  The uniform r comes from the run's
RNG provider (`repro_torch.utils.rng`), so the gate itself draws nothing.

Whole-copy gating only: the §5 per-tensor switches are kept on the config
so that a caller who sets them gets a clear error, not a silent whole-copy
run.
"""
from __future__ import annotations

import dataclasses

from repro_torch.utils.trees import leaves


@dataclasses.dataclass(frozen=True)
class BandwidthConfig:
    """Eq.-9 gating strengths + drop policy."""

    c_push: float = 0.0
    c_fetch: float = 0.0
    eps: float = 1e-8
    # 'cache' — re-apply the client's most recent transmitted gradient (the
    #           paper's choice; needs a [λ, P] gradient cache);
    # 'skip'  — no server update happens for this opportunity.
    drop_policy: str = "cache"
    per_tensor_fetch: bool = False
    per_tensor_push: bool = False

    def __post_init__(self):
        if self.drop_policy not in ("cache", "skip"):
            raise ValueError(f"unknown drop_policy {self.drop_policy!r}")
        if self.per_tensor_fetch or self.per_tensor_push:
            raise NotImplementedError(
                "per-tensor gating (§5) is not ported to repro_torch yet")


def transmit_prob(vbar, c, eps: float = 1e-8):
    """Eq. 9 right-hand side, in (0, 1]: increasing in v̄, decreasing in c."""
    return 1.0 / (1.0 + c / (vbar + eps))


def tree_bytes(tree) -> float:
    """Wire size of one full copy of `tree` (a python float)."""
    return float(sum(l.numel() * l.element_size() for l in leaves(tree)))
