"""Server update rules as a pluggable registry, ported from `repro.core.rules`.

All eight rules of the reference: ASGD, SASGD, exponential penalty,
polynomial decay and FASGD (the five with a batched kernel mode),
Gap-Aware, synchronous SGD and K-async (the round-barrier rules).

A rule is an `UpdateRule` subclass registered by name; the server state is
a tree of tensors (`ServerState`), as in the reference.  A rule declares

* ``init_extra_state(config, params)`` — rule-private state kept in
  ``ServerState.extra`` (gap's ĝ EMA, the barrier rules' pending sum);
* ``update_stats(config, state, grad)`` — one statistics step (the shared
  eqs. 4–6 unless overridden);
* ``scale_leaf(config, v, tau, extra, gap)`` — the per-leaf effective
  learning rate, broadcastable so that one body serves one gradient
  (``v: [*s]``, scalar τ) and the fused K-event batch (``v: [1, *s]``,
  ``tau: [K, 1, ...]``, ``gap: [K, *s]``);
* flags: ``synchronous``, ``needs_client_params``, ``requires_stats``,
  ``supports_fused``, ``coeffs_are_v_independent``, ``v_separable``.

Rules are plain functions over tensors and never leave the device: the
staleness τ stays a device scalar, and the barrier rules decide whether a
round is complete with `torch.where`, never with a host branch.

Eq. (6) as printed averages the *inverse* std; ``variant="intent"``
(default) averages the std itself, ``variant="literal"`` the printed form —
see the reference module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import server_shard
from repro_torch.core.staleness import mean_leaf_tau, step_staleness
from repro_torch.utils.trees import leaves, same_structure, tree_map, unflatten

_REGISTRY: Dict[str, "UpdateRule"] = {}


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
    num_clients: int = 1        # the barrier rules' round size λ
    use_fused_kernel: bool = False  # route updates through the CUDA kernels
    kasync_k: int = 0           # kasync's partial barrier K (0 → num_clients)

    def __post_init__(self):
        get_rule(self.rule)
        if self.variant not in ("intent", "literal"):
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.kasync_k < 0:
            raise ValueError(f"kasync_k={self.kasync_k} must be >= 0")
        if self.kasync_k > max(self.num_clients, 1):
            raise ValueError(
                f"kasync_k={self.kasync_k} exceeds num_clients="
                f"{self.num_clients} (set num_clients to the fleet size)")


class ServerState(NamedTuple):
    """Canonical parameters + timestamp + FASGD statistics.

    `n`, `b`, `v` mirror the params tree; `extra` holds the rule's private
    state from `UpdateRule.init_extra_state` (None for rules without).
    """
    params: Any
    timestamp: torch.Tensor         # int32 scalar on the params' device, "T"
    n: Any                          # MA of g^2        (eq. 4)
    b: Any                          # MA of g          (eq. 5)
    v: Any                          # MA of std        (eq. 6; see variant)
    extra: Any = None               # rule-specific (gap: ĝ EMA; ssgd: pending)


def init(config: ServerConfig, params) -> ServerState:
    """Fresh `ServerState`: T = 0, n = b = 0, v = 1 (so the first FASGD
    updates are ~plain ASGD instead of dividing by ~0), plus the rule's
    `init_extra_state`."""
    device = leaves(params)[0].device
    return ServerState(
        params=params,
        timestamp=torch.zeros((), dtype=torch.int32, device=device),
        n=tree_map(torch.zeros_like, params),
        b=tree_map(torch.zeros_like, params),
        v=tree_map(torch.ones_like, params),
        extra=get_rule(config.rule).init_extra_state(config, params),
    )


def _std(config: ServerConfig, n_leaf, b_leaf):
    return torch.sqrt(torch.clamp(n_leaf - b_leaf ** 2, min=0.0) + config.eps)


def _shared_stats(config: ServerConfig, state: ServerState, grad) -> ServerState:
    """Eqs. 4–6: one moving-average step with gradient `grad`."""
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


def _tau_tree(state: ServerState, tau):
    """A scalar staleness broadcast to a per-leaf tree; a per-leaf tree
    (per-tensor staleness, §5) is returned as it is."""
    if same_structure(tau, state.v):
        return tau
    return tree_map(lambda _: tau, state.v)


def extra_leaf_dicts(extra, like):
    """`ServerState.extra` sliced into one dict per leaf for `scale_leaf`:
    only the entries whose tree mirrors `like` (the params/v tree), leaf by
    leaf; scalars and other buffers are the rule's own apply state."""
    n_leaves = len(leaves(like))
    if not isinstance(extra, dict):
        return [None] * n_leaves
    mirrored = {k: leaves(sub) for k, sub in extra.items()
                if same_structure(sub, like)}
    if not mirrored:
        return [None] * n_leaves
    return [{k: ls[i] for k, ls in mirrored.items()} for i in range(n_leaves)]


def effective_scale(config: ServerConfig, state: ServerState, tau, gap=None):
    """Per-parameter learning-rate tree for one gradient with staleness τ
    (a scalar or a per-leaf tree); `gap` optionally carries θ_T − θ_ts per
    leaf for the gap-aware rule."""
    rule = get_rule(config.rule)
    v_leaves = leaves(state.v)
    t_leaves = leaves(_tau_tree(state, tau))
    gap_leaves = leaves(gap) if gap is not None else [None] * len(v_leaves)
    e_leaves = extra_leaf_dicts(state.extra, state.v)
    return unflatten(state.v, [
        rule.scale_leaf(config, v, t, extra=e, gap=g)
        for v, t, e, g in zip(v_leaves, t_leaves, e_leaves, gap_leaves)])


def _scale_aux(scale) -> dict:
    """aux's ``mean_scale``, the mean effective lr over every parameter,
    and the per-leaf sums it is made of (``scale_sums``, from which a
    sharded server's shards make the whole tree's mean)."""
    ls = leaves(scale)
    sums = [torch.sum(s) for s in ls]
    return {"mean_scale": sum(sums) / float(sum(s.numel() for s in ls)),
            "scale_sums": sums}


def _gap_tree(state: ServerState, client_params):
    """Parameter-space divergence θ_T − θ_ts of the pushing client."""
    return tree_map(lambda sp, cp: sp.float() - cp.float(), state.params,
                    client_params)


class UpdateRule:
    """Base class for server update rules; subclass + `@register_rule`."""

    name: str = "?"
    synchronous: bool = False        # apply() buffers until a round completes
    needs_client_params: bool = False  # scale uses the gap θ_T − θ_ts
    requires_stats: bool = False     # rule consumes n/b/v (or extra stats)
    supports_fused: bool = True      # usable in the engine's fused apply
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
    # The fused scale factorizes as a per-event scalar times one elementwise
    # v-factor (fasgd); the reference's cotangent path serves such rules on
    # request only.
    v_separable: bool = False

    def barrier_k(self, config: ServerConfig) -> int:
        """Arrivals per round a synchronous rule waits for: λ for a full
        barrier, ``kasync_k`` for the K-async partial barrier."""
        return max(config.num_clients, 1)

    def fused_coeffs(self, config: ServerConfig, taus):
        """Per-event scalar effective lr [K] for the 'coeff' mode."""
        raise NotImplementedError(self.name)

    def fused_vfactor(self, config: ServerConfig, v):
        """Elementwise v-factor tree of a `v_separable` rule: it multiplies
        the coefficient-weighted fused delta once per leaf, against the
        post-stats v (`engine.fused_apply_cotangent`)."""
        raise NotImplementedError(self.name)

    def init_extra_state(self, config: ServerConfig, params):
        """Rule-private state kept in `ServerState.extra` (or None).  Entries
        whose tree mirrors `params` are merged per leaf under per-tensor
        gating; anything else follows the whole-update decision."""
        return None

    def update_stats(self, config: ServerConfig, state: ServerState, grad):
        """One statistics step (default: the shared eqs. 4-6)."""
        return _shared_stats(config, state, grad)

    def scale_leaf(self, config: ServerConfig, v, tau, extra=None, gap=None):
        """Per-leaf effective lr; broadcasts `v` against `tau` and `gap`."""
        raise NotImplementedError(self.name)

    def apply(self, config: ServerConfig, state: ServerState, grad, tau,
              tau_scalar, client_params=None):
        """One server update: stats step, scale, SGD step, T ← T + 1.  The
        single-push kernel takes a scalar τ only (as in the reference)."""
        per_tensor_tau = same_structure(tau, state.params)
        if (config.use_fused_kernel and self.kernel_op is not None
                and not per_tensor_tau):
            return self._apply_kernel(config, state, grad, tau, tau_scalar)
        if config.track_stats or self.requires_stats:
            state = self.update_stats(config, state, grad)
        gap = (_gap_tree(state, client_params)
               if self.needs_client_params and client_params is not None
               else None)
        scale = effective_scale(config, state, tau, gap=gap)
        new_params = tree_map(
            lambda p, s, g: (p.float() - s * g.float()).to(p.dtype),
            state.params, scale, grad)
        new_state = state._replace(
            params=new_params, timestamp=state.timestamp + 1)
        return new_state, {"tau": tau_scalar, **_scale_aux(scale)}


def _bshape(v, tau):
    return torch.broadcast_shapes(v.shape, torch.as_tensor(tau).shape)


def _f32(t, like):
    return torch.as_tensor(t, dtype=torch.float32, device=like.device)


@register_rule("asgd")
class AsgdRule(UpdateRule):
    """Plain async SGD: θ ← θ − α·g, staleness ignored (eq. 1)."""

    batched_kernel_mode = "coeff"
    coeffs_are_v_independent = True

    def scale_leaf(self, config, v, tau, extra=None, gap=None):
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

    def scale_leaf(self, config, v, tau, extra=None, gap=None):
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

    def scale_leaf(self, config, v, tau, extra=None, gap=None):
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

    def scale_leaf(self, config, v, tau, extra=None, gap=None):
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
    v_separable = True

    def scale_leaf(self, config, v, tau, extra=None, gap=None):
        """α/(v·τ + ε) elementwise in the std moving average v (eq. 7)."""
        return config.lr / (v * _f32(tau, v) + config.eps)

    def fused_coeffs(self, config, taus):
        """ε-reparameterised per-event factor α/τ_k (the `v_separable`
        split).

        Together with `fused_vfactor` this gives α/(τ_k·(v+ε)) =
        α/(v·τ_k + ε·τ_k), eq. 7 with its ε guard scaled by τ_k: relative
        error ≤ ε/(v+ε), far inside the fused path's tolerances.
        """
        return config.lr / taus.float()

    def fused_vfactor(self, config, v):
        """Elementwise 1/(v+ε), in float32, against the post-stats std
        moving average (eq. 7)."""
        return tree_map(lambda l: 1.0 / (l.float() + config.eps), v)

    def _apply_kernel(self, config, state, grad, tau, tau_scalar):
        # Ports `FasgdRule._apply_pallas`: eqs. 4-8 in one pass per leaf
        # through `kernels.ops.fasgd_update` (the CUDA kernel on the card,
        # its plain version on the CPU), with a scalar τ.
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
        return new_state, {"tau": tau_scalar, **_scale_aux(scale)}


@register_rule("gap")
class GapAwareRule(UpdateRule):
    """Gap-Aware staleness mitigation (Barkai et al., arXiv:1909.10802).

    Penalizes a stale gradient by the parameter-space gap it was computed
    across: C = max(1, |θ_T − θ_ts| / ĝ) elementwise, with ĝ an EMA of the
    typical per-step movement α·|g|; the effective lr is α / C.  With no
    client copy to measure against (``gap=None``) the penalty is 1 (ASGD).
    """

    needs_client_params = True
    requires_stats = True

    def init_extra_state(self, config, params):
        """ĝ EMA of the per-step parameter movement (float32 zeros)."""
        return {"gbar": tree_map(
            lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                  device=l.device), params)}

    def update_stats(self, config, state, grad):
        """Shared eq. 4-6 step plus the ĝ EMA of α·|g| (Barkai et al. §4)."""
        state = _shared_stats(config, state, grad)
        gbar = tree_map(
            lambda m, g: (config.gamma * m + (1 - config.gamma) * config.lr
                          * torch.abs(g.float())),
            state.extra["gbar"], grad)
        return state._replace(extra={"gbar": gbar})

    def scale_leaf(self, config, v, tau, extra=None, gap=None):
        """α / max(1, |gap|/ĝ) elementwise; α (ASGD) when no gap is given."""
        shape = _bshape(v, tau)
        if gap is None or extra is None:
            return torch.full(shape, config.lr, dtype=torch.float32,
                              device=v.device)
        penalty = torch.clamp(torch.abs(gap) / (extra["gbar"] + config.eps),
                              min=1.0)
        return torch.broadcast_to(
            config.lr / penalty,
            torch.broadcast_shapes(shape, penalty.shape))


def _barrier_step(config, state, pending, count, k):
    """The barrier rules' round: θ ← θ − α·pending/k, pending ← 0, count ← 0
    and T ← T + 1 where ``count >= k``, else all kept — selected on the
    device with `torch.where`.  Returns (params, pending, count, T, full)."""
    full = count >= k
    params = tree_map(
        lambda p, s: torch.where(full, p - config.lr * s / k, p),
        state.params, pending)
    pending = tree_map(
        lambda s: torch.where(full, torch.zeros_like(s), s), pending)
    count = torch.where(full, torch.zeros_like(count), count)
    ts = torch.where(full, state.timestamp + 1, state.timestamp)
    return params, pending, count, ts, full


@register_rule("ssgd")
class SsgdRule(UpdateRule):
    """Synchronous SGD barrier: buffer gradients, step once per full round."""

    synchronous = True
    supports_fused = False

    def init_extra_state(self, config, params):
        """Pending-gradient buffer (mirrors params) + arrival count."""
        device = leaves(params)[0].device
        return {"pending": tree_map(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def scale_leaf(self, config, v, tau, extra=None, gap=None):
        """α/λ broadcast over the leaf (the per-round mean step)."""
        return torch.full(_bshape(v, tau),
                          config.lr / max(config.num_clients, 1),
                          dtype=torch.float32, device=v.device)

    def apply(self, config, state, grad, tau, tau_scalar, client_params=None):
        """Buffer `grad`; step θ once `num_clients` gradients arrived."""
        pending = tree_map(torch.add, state.extra["pending"], grad)
        params, pending, count, ts, full = _barrier_step(
            config, state, pending, state.extra["count"] + 1,
            config.num_clients)
        new_state = state._replace(params=params, timestamp=ts,
                                   extra={"pending": pending, "count": count})
        if config.track_stats:
            new_state = self.update_stats(config, new_state, grad)
        return new_state, {"tau": tau_scalar, "applied": full}


@register_rule("kasync")
class KAsyncRule(UpdateRule):
    """K-async partial barrier (Dutta et al., arXiv:1803.01113 §3).

    Each round of λ = ``num_clients`` consecutive arrivals (the ``seen``
    cursor) steps θ ← θ − α·(Σ g)/K over its first K = ``kasync_k``
    arrivals and discards the rest, statistics included.  ``kasync_k = 0``
    means K = λ, which is `ssgd`.
    """

    synchronous = True
    supports_fused = False

    def _k(self, config: ServerConfig) -> int:
        return config.kasync_k or max(config.num_clients, 1)

    def barrier_k(self, config: ServerConfig) -> int:
        """Partial-barrier round size K (``kasync_k``, 0 → λ)."""
        return self._k(config)

    def init_extra_state(self, config, params):
        """Pending buffer + taken-count + round-arrival cursor ``seen``."""
        device = leaves(params)[0].device
        zero = lambda: torch.zeros((), dtype=torch.int32, device=device)
        return {"pending": tree_map(torch.zeros_like, params),
                "count": zero(), "seen": zero()}

    def scale_leaf(self, config, v, tau, extra=None, gap=None):
        """α/K broadcast over the leaf (the per-round mean over the K kept)."""
        return torch.full(_bshape(v, tau), config.lr / self._k(config),
                          dtype=torch.float32, device=v.device)

    def apply(self, config, state, grad, tau, tau_scalar, client_params=None):
        """Accumulate the first K arrivals of the round; discard the rest."""
        k = self._k(config)
        lam = max(config.num_clients, 1)
        seen = state.extra["seen"]
        take = seen < k
        pending = tree_map(lambda acc, g: torch.where(take, acc + g, acc),
                           state.extra["pending"], grad)
        params, pending, count, ts, full = _barrier_step(
            config, state, pending,
            state.extra["count"] + take.to(torch.int32), k)
        seen = torch.where(seen + 1 >= lam, torch.zeros_like(seen), seen + 1)
        new_state = state._replace(
            params=params, timestamp=ts,
            extra={"pending": pending, "count": count, "seen": seen})
        if config.track_stats:
            # a discarded arrival never reached the server: its statistics
            # are dropped with it
            tracked = self.update_stats(config, new_state, grad)
            new_state = tree_map(lambda a, b: torch.where(take, a, b),
                                 tracked, new_state)
        return new_state, {"tau": tau_scalar, "applied": full}


def apply_update(config: ServerConfig, state: ServerState, grad,
                 grad_timestamp, *, client_params=None):
    """One server update (the Async SGD protocol's step 2 + FASGD eqs. 4-8).

    Returns (new_state, aux) with the staleness and, for the asynchronous
    rules, the mean effective lr.  `grad_timestamp` is a scalar or a
    per-tensor tree (§5; τ is then per leaf and aux's τ their mean).
    `client_params` is the copy the gradient was computed on, which the
    gap-aware rule measures the divergence against.  A synchronous rule
    accumulates and moves θ once a round is complete.
    """
    rule = get_rule(config.rule)
    if same_structure(grad_timestamp, state.params):
        tau = tree_map(lambda ts: step_staleness(state.timestamp, ts),
                       grad_timestamp)
        tau_scalar = mean_leaf_tau(tau)
    else:
        tau = tau_scalar = step_staleness(state.timestamp, grad_timestamp)
    return rule.apply(config, state, grad, tau, tau_scalar,
                      client_params=client_params)


def vbar(state: ServerState) -> torch.Tensor:
    """Mean over all parameters of the std moving average (B-FASGD's v̄);
    over a placed state (`core.server_shard`), from the shards' partial
    sums (`server_shard.tree_mean`)."""
    if server_shard.is_sharded(state):
        return server_shard.tree_mean(state.sub(lambda s: s.v))
    ls = leaves(state.v)
    total = sum(torch.sum(l.float()) for l in ls)
    return total / float(sum(l.numel() for l in ls))
