"""Server update rules as a pluggable registry, ported from `repro.core.rules`.

Ported: ASGD, SASGD, exponential penalty, polynomial decay and FASGD — the
five rules with a batched kernel mode.  Gap-Aware, synchronous SGD and
K-async wait for a later slice; `get_rule` raises `NotImplementedError` for
them.

A rule is an `UpdateRule` subclass registered by name; the server state is
a tree of tensors (`ServerState`), as in the reference.  Rules are plain
functions over tensors and never leave the device: the staleness τ stays a
device scalar.

Eq. (6) as printed averages the *inverse* std; ``variant="intent"``
(default) averages the std itself, ``variant="literal"`` the printed form —
see the reference module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.staleness import step_staleness
from repro_torch.utils.trees import leaves, tree_map

_REGISTRY: Dict[str, "UpdateRule"] = {}
# rules of the reference that this package does not have yet
_NOT_PORTED = ("gap", "ssgd", "kasync")


def register_rule(name: str):
    """Class decorator: instantiate `cls` and register it under `name`."""

    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"duplicate update-rule name {name!r}")
        cls.name = name
        _REGISTRY[name] = cls()
        return cls

    return deco


def get_rule(name: str) -> "UpdateRule":
    """Look up a registered `UpdateRule` by name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"update rule {name!r} is not ported to repro_torch yet; "
                f"ported: {registered_rules()}") from None
        raise KeyError(
            f"unknown update rule {name!r}; registered: {registered_rules()}"
        ) from None


def registered_rules() -> Tuple[str, ...]:
    """All registered rule names, sorted."""
    return tuple(sorted(_REGISTRY))


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Hyper-parameters of the server update (rule + eq. 4-8 constants).

    The reference's ``kernel_interpret`` (Pallas interpret mode) and
    ``kernel_block_rows`` (TPU VMEM tiling) have no counterpart here: the
    kernel path is chosen by the tensors' device.
    """

    rule: str = "fasgd"
    lr: float = 0.005
    gamma: float = 0.9          # MA decay for n (2nd moment) and b (1st moment)
    beta: float = 0.9           # MA decay for v (std average)
    eps: float = 1e-8
    variant: str = "intent"     # 'intent' | 'literal'
    kappa: float = 0.15         # exp-penalty strength: lr * exp(-kappa * tau)
    poly_power: float = 0.5     # 'poly' exponent p in lr / tau**p
    track_stats: bool = True    # maintain n/b/v even for non-FASGD rules
    use_fused_kernel: bool = False  # route updates through the CUDA kernels

    def __post_init__(self):
        get_rule(self.rule)
        if self.variant not in ("intent", "literal"):
            raise ValueError(f"unknown variant {self.variant!r}")


class ServerState(NamedTuple):
    """Canonical parameters + timestamp + FASGD statistics.

    `n`, `b`, `v` mirror the params tree.  The reference's rule-private
    `extra` state belongs to rules not ported yet (gap, ssgd, kasync).
    """
    params: Any
    timestamp: torch.Tensor         # int32 scalar on the params' device, "T"
    n: Any                          # MA of g^2        (eq. 4)
    b: Any                          # MA of g          (eq. 5)
    v: Any                          # MA of std        (eq. 6; see variant)


def init(config: ServerConfig, params) -> ServerState:
    """Fresh `ServerState`: T = 0, n = b = 0, v = 1 (so the first FASGD
    updates are ~plain ASGD instead of dividing by ~0)."""
    device = leaves(params)[0].device
    return ServerState(
        params=params,
        timestamp=torch.zeros((), dtype=torch.int32, device=device),
        n=tree_map(torch.zeros_like, params),
        b=tree_map(torch.zeros_like, params),
        v=tree_map(torch.ones_like, params),
    )


def _std(config: ServerConfig, n_leaf, b_leaf):
    return torch.sqrt(torch.clamp(n_leaf - b_leaf ** 2, min=0.0) + config.eps)


def _shared_stats(config: ServerConfig, state: ServerState, grad) -> ServerState:
    """Eqs. 4–6: one moving-average step with gradient `grad` (the
    statistics step of every ported rule)."""
    g, be = config.gamma, config.beta
    n = tree_map(lambda m, x: g * m + (1 - g) * x * x, state.n, grad)
    b = tree_map(lambda m, x: g * m + (1 - g) * x, state.b, grad)
    if config.variant == "intent":
        v = tree_map(
            lambda m, nn, bb: be * m + (1 - be) * _std(config, nn, bb),
            state.v, n, b)
    else:
        v = tree_map(
            lambda m, nn, bb: be * m + (1 - be) / _std(config, nn, bb),
            state.v, n, b)
    return state._replace(n=n, b=b, v=v)


def effective_scale(config: ServerConfig, state: ServerState, tau):
    """Per-parameter learning-rate tree for one gradient with staleness τ
    (a scalar; per-tensor staleness waits for a later slice)."""
    rule = get_rule(config.rule)
    return tree_map(lambda v: rule.scale_leaf(config, v, tau), state.v)


def _mean_scale(scale) -> torch.Tensor:
    ls = leaves(scale)
    return sum(torch.sum(s) for s in ls) / float(sum(s.numel() for s in ls))


class UpdateRule:
    """Base class for server update rules; subclass + `@register_rule`."""

    name: str = "?"
    requires_stats: bool = False
    # Name of the single-push kernel in `kernels.ops` (the reference's
    # `pallas_op`).
    kernel_op: Optional[str] = None
    # Mode of the one-kernel K-event apply (the reference's
    # `batched_pallas_mode`): 'coeff' — a per-event scalar weight
    # (`fused_coeffs`); 'fasgd' — lr/(v·τ_k + ε) elementwise, in-kernel.
    batched_kernel_mode: Optional[str] = None
    # The fused update needs only Σ_k w_k·g_k with v-independent scalar w_k
    # (the reference's cotangent-path eligibility).
    coeffs_are_v_independent: bool = False

    def fused_coeffs(self, config: ServerConfig, taus):
        """Per-event scalar effective lr [K] for the 'coeff' mode."""
        raise NotImplementedError(self.name)

    def scale_leaf(self, config: ServerConfig, v, tau):
        """Per-leaf effective lr; broadcasts `v` against `tau` (a scalar, or
        [K, 1, ...] for the fused per-event batch)."""
        raise NotImplementedError(self.name)

    def apply(self, config: ServerConfig, state: ServerState, grad, tau,
              tau_scalar):
        """One server update: stats step, scale, SGD step, T ← T + 1."""
        if config.use_fused_kernel and self.kernel_op is not None:
            return self._apply_kernel(config, state, grad, tau, tau_scalar)
        if config.track_stats or self.requires_stats:
            state = _shared_stats(config, state, grad)
        scale = effective_scale(config, state, tau)
        new_params = tree_map(
            lambda p, s, g: (p.float() - s * g.float()).to(p.dtype),
            state.params, scale, grad)
        new_state = state._replace(
            params=new_params, timestamp=state.timestamp + 1)
        return new_state, {"tau": tau_scalar, "mean_scale": _mean_scale(scale)}


def _bshape(v, tau):
    return torch.broadcast_shapes(v.shape, torch.as_tensor(tau).shape)


def _f32(t, like):
    return torch.as_tensor(t, dtype=torch.float32, device=like.device)


@register_rule("asgd")
class AsgdRule(UpdateRule):
    """Plain async SGD: θ ← θ − α·g, staleness ignored (eq. 1)."""

    batched_kernel_mode = "coeff"
    coeffs_are_v_independent = True

    def scale_leaf(self, config, v, tau):
        """Constant α broadcast over the leaf (eq. 1)."""
        return torch.full(_bshape(v, tau), config.lr, dtype=torch.float32,
                          device=v.device)

    def fused_coeffs(self, config, taus):
        """Constant α per event (eq. 1)."""
        return torch.full_like(taus, config.lr, dtype=torch.float32)


@register_rule("sasgd")
class SasgdRule(UpdateRule):
    """Staleness-aware SGD (Zhang et al.): α/τ (eq. 2)."""

    batched_kernel_mode = "coeff"
    coeffs_are_v_independent = True

    def scale_leaf(self, config, v, tau):
        """α/τ broadcast over the leaf (eq. 2)."""
        return torch.broadcast_to(config.lr / _f32(tau, v), _bshape(v, tau))

    def fused_coeffs(self, config, taus):
        """α/τ_k per event (eq. 2)."""
        return config.lr / taus.float()


@register_rule("exp")
class ExpPenaltyRule(UpdateRule):
    """Exponential staleness penalty (Chan & Lane): α·e^{−κ(τ−1)}."""

    batched_kernel_mode = "coeff"
    coeffs_are_v_independent = True

    def scale_leaf(self, config, v, tau):
        """α·e^{−κ(τ−1)} broadcast over the leaf."""
        t = _f32(tau, v)
        return torch.broadcast_to(
            config.lr * torch.exp(-config.kappa * (t - 1.0)), _bshape(v, tau))

    def fused_coeffs(self, config, taus):
        """α·e^{−κ(τ_k−1)} per event."""
        return config.lr * torch.exp(-config.kappa * (taus.float() - 1.0))


@register_rule("poly")
class PolyRule(UpdateRule):
    """Polynomial staleness decay: α/τ^p (Zhang et al., arXiv:1511.05950)."""

    batched_kernel_mode = "coeff"
    coeffs_are_v_independent = True

    def scale_leaf(self, config, v, tau):
        """α/τ^p broadcast over the leaf."""
        t = _f32(tau, v)
        return torch.broadcast_to(config.lr / t ** config.poly_power,
                                  _bshape(v, tau))

    def fused_coeffs(self, config, taus):
        """α/τ_k^p per event."""
        return config.lr / taus.float() ** config.poly_power


@register_rule("fasgd")
class FasgdRule(UpdateRule):
    """FASGD (the paper): α / (v·τ), elementwise in the std MA v (eq. 7)."""

    requires_stats = True
    kernel_op = "fasgd_update"
    batched_kernel_mode = "fasgd"

    def scale_leaf(self, config, v, tau):
        """α/(v·τ + ε) elementwise in the std moving average v (eq. 7)."""
        return config.lr / (v * _f32(tau, v) + config.eps)

    def fused_coeffs(self, config, taus):
        """α/τ_k per event (the scalar part of eq. 7's scale)."""
        return config.lr / taus.float()

    def _apply_kernel(self, config, state, grad, tau, tau_scalar):
        # Ports `FasgdRule._apply_pallas`: eqs. 4-8 in one pass per leaf
        # through `kernels.ops.fasgd_update` (the CUDA kernel on the card,
        # its plain version on the CPU).
        from repro_torch.kernels.ops import fasgd_update
        f32 = lambda tr: tree_map(lambda l: l.float(), tr)
        new_params, n_new, b_new, v_new = fasgd_update(
            state.params, grad, f32(state.n), f32(state.b), f32(state.v),
            config.lr, tau, gamma=config.gamma, beta=config.beta,
            eps=config.eps, variant=config.variant)
        cast = lambda new, old: tree_map(lambda a, o: a.to(o.dtype), new, old)
        new_state = state._replace(
            params=new_params, n=cast(n_new, state.n), b=cast(b_new, state.b),
            v=cast(v_new, state.v), timestamp=state.timestamp + 1)
        scale = effective_scale(config, new_state._replace(v=v_new), tau)
        return new_state, {"tau": tau_scalar, "mean_scale": _mean_scale(scale)}


def apply_update(config: ServerConfig, state: ServerState, grad,
                 grad_timestamp):
    """One server update (the Async SGD protocol's step 2 + FASGD eqs. 4-8).

    Returns (new_state, aux) with the staleness and the mean effective lr.
    `grad_timestamp` is a scalar; per-tensor timestamps (§5) wait for a
    later slice.
    """
    if isinstance(grad_timestamp, (list, tuple, dict)):
        raise NotImplementedError(
            "per-tensor timestamps (§5) are not ported to repro_torch yet")
    rule = get_rule(config.rule)
    tau = step_staleness(state.timestamp, grad_timestamp)
    return rule.apply(config, state, grad, tau, tau)


def vbar(state: ServerState) -> torch.Tensor:
    """Mean over all parameters of the std moving average (B-FASGD's v̄)."""
    ls = leaves(state.v)
    total = sum(torch.sum(l.float()) for l in ls)
    return total / float(sum(l.numel() for l in ls))

