"""Modelled arrival processes for fault-tolerance and elasticity scenarios.

Ported from `repro.core.scenarios`.  A fleet of λ clients runs a
discrete-event race whose state (`ScenarioState`) is a handful of [λ]
device tensors, advanced by device ops only:

* **service times** — client c draws i.i.d. service times from a fixed,
  lognormal or Pareto law with per-client mean ``scale[c]``
  (`client_scales`): stragglers get ``scale × straggler_slowdown``,
  hotspots ``scale / hotspot_speedup``;
* **dropout / rejoin churn** — each window every live client drops with
  hazard ``dropout_rate`` and every dropped client rejoins with hazard
  ``rejoin_rate``, restarting from the current wall time;
* **elastic resize** — ``initial_active_frac·λ`` clients run until wall
  time ``resize_at``, then ``resize_to_frac·λ``;
* **wall clock** — `ScenarioState.now` advances to each event's modelled
  finish time.

Every variate comes from a provider (`repro_torch.utils.rng`): client c's
n-th service draw is ``draws.service(c, n)`` and window w's churn uniforms
``draws.churn(w, λ)``, functions of those counters alone, so dropping
client i never moves client j's times.  `NativeScenarioDraws` (the
default, from ``config.seed``) hashes the counters on the device;
`ReplayScenarioDraws` replays the variates `jax.random` drew for the
reference.

Two arrival modes feed the engine: `async_window` (the earliest active
client fires, its finish time becomes the wall clock, and it redraws at
once — a K-step Python loop of device ops where the reference scans) and
`sync_round` (all λ clients draw once; arrivals fastest-first, ties by
index, and the clock advances by the ``k_used``-th order statistic).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.rng import NativeScenarioDraws

_SERVICE_KINDS = ("fixed", "lognormal", "pareto")


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Arrival-process model for one simulated fleet.

    Fractions are of the fleet size λ; times are in modelled wall units,
    where a nominal client's mean service time is ``mean_service``.
    """

    service: str = "lognormal"      # 'fixed' | 'lognormal' | 'pareto'
    mean_service: float = 1.0       # mean service time of a nominal client
    sigma: float = 0.5              # lognormal shape (ignored otherwise)
    pareto_alpha: float = 1.5       # Pareto tail index (> 1 for finite mean)
    straggler_frac: float = 0.0     # last ⌈frac·λ⌉ clients are stragglers
    straggler_slowdown: float = 1.0  # straggler mean = mean_service × slowdown
    hotspot_frac: float = 0.0       # first ⌈frac·λ⌉ clients are hotspots
    hotspot_speedup: float = 1.0    # hotspot mean = mean_service / speedup
    dropout_rate: float = 0.0       # per-window per-client dropout hazard
    rejoin_rate: float = 0.0        # per-window per-client rejoin hazard
    initial_active_frac: float = 1.0  # fleet fraction active at t = 0
    resize_at: float = 0.0          # wall time of the elastic resize (0: never)
    resize_to_frac: float = 1.0     # fleet fraction active after the resize
    seed: int = 0                   # base of all scenario RNG streams

    def __post_init__(self):
        if self.service not in _SERVICE_KINDS:
            raise ValueError(
                f"service {self.service!r} not in {_SERVICE_KINDS}")
        if not self.mean_service > 0:
            raise ValueError("mean_service must be > 0")
        if not self.pareto_alpha > 1:
            raise ValueError(
                "pareto_alpha must be > 1 (finite-mean normalization)")
        for name in ("straggler_frac", "hotspot_frac", "dropout_rate",
                     "rejoin_rate", "initial_active_frac", "resize_to_frac"):
            val = getattr(self, name)
            if not 0.0 <= val <= 1.0:
                raise ValueError(f"{name}={val} outside [0, 1]")
        if self.straggler_slowdown < 1.0 or self.hotspot_speedup < 1.0:
            raise ValueError("slowdown/speedup factors must be >= 1")
        if self.resize_at < 0:
            raise ValueError("resize_at must be >= 0")

    def has_churn(self) -> bool:
        """True when the fleet composition can change mid-run (dropout,
        rejoin, or an elastic resize) — incompatible with barrier rules."""
        return (self.dropout_rate > 0 or self.rejoin_rate > 0
                or self.initial_active_frac < 1.0 or self.resize_at > 0)


#: Named operating points, as in the reference.
SCENARIO_PRESETS: Dict[str, ScenarioConfig] = {
    # Heavy-tailed stragglers: 1/8 of the fleet runs 16x slower, with a
    # Pareto(α=1.3) tail on every service time.
    "stragglers": ScenarioConfig(
        service="pareto", pareto_alpha=1.3,
        straggler_frac=0.125, straggler_slowdown=16.0),
    # Churny fleet: every window each live client drops w.p. 2% and each
    # dropped client rejoins w.p. 5% (steady state ~28% dark).
    "dropout": ScenarioConfig(
        service="lognormal", dropout_rate=0.02, rejoin_rate=0.05),
    # Hotspots: 1/16 of the fleet runs 8x faster and dominates traffic.
    "hotspot": ScenarioConfig(
        service="lognormal", hotspot_frac=0.0625, hotspot_speedup=8.0),
    # Elastic resize: half the fleet until t=8, then scale out to full.
    "elastic": ScenarioConfig(
        service="lognormal", initial_active_frac=0.5,
        resize_at=8.0, resize_to_frac=1.0),
}


def preset(name: str) -> ScenarioConfig:
    """Look up a named `ScenarioConfig` preset (KeyError with the listing)."""
    try:
        return SCENARIO_PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; presets: "
            f"{tuple(sorted(SCENARIO_PRESETS))}") from None


class ScenarioState(NamedTuple):
    """Arrival-process state (fixed shapes, on the device).

    ``next_t[c]`` is client c's modelled finish time (+inf, in float32, for
    a client never activated); ``n_draws[c]`` counts its service draws and
    indexes its stream.
    """

    now: torch.Tensor        # f32 scalar — modelled wall clock
    next_t: torch.Tensor     # f32 [λ]   — per-client next finish time
    n_draws: torch.Tensor    # i32 [λ]   — per-client service-draw counter
    dropped: torch.Tensor    # bool [λ]  — churn state (True = dark)
    window: torch.Tensor     # i32 scalar — churn-stream window index


def native_draws(config: ScenarioConfig) -> NativeScenarioDraws:
    """The default provider of `config`'s variates (from its seed)."""
    return NativeScenarioDraws(config.seed, config.service,
                               config.pareto_alpha)


def _draws(config: ScenarioConfig, draws):
    return native_draws(config) if draws is None else draws


def _service_time(config: ScenarioConfig, unit, scale):
    """Service times of mean `scale` from unit variates `unit` (float32,
    the reference's arithmetic in its order)."""
    if config.service == "fixed":
        return scale
    if config.service == "lognormal":
        # E[scale·exp(σz − σ²/2)] = scale
        s = config.sigma
        return scale * torch.exp(s * unit - 0.5 * s * s)
    # pareto: x_m·X with X ~ Pareto(α) on [1, ∞), x_m = scale·(α−1)/α
    a = config.pareto_alpha
    return scale * (a - 1.0) / a * unit


def _draw_all(config: ScenarioConfig, scales, n_draws, draws):
    """Client c's service draw at its stream index ``n_draws[c]``, all c."""
    if config.service == "fixed":
        return scales.clone()
    c = torch.arange(scales.shape[0], device=scales.device)
    return _service_time(config, draws.service(c, n_draws), scales)


def check_fleet(config: ScenarioConfig, num_clients: int) -> Tuple[int, int]:
    """The hotspot and straggler counts of a λ-client fleet; raises
    `ValueError` when they overlap (the reference's check)."""
    lam = int(num_clients)
    n_hot = int(round(config.hotspot_frac * lam))
    n_strag = int(round(config.straggler_frac * lam))
    if n_hot + n_strag > lam:
        raise ValueError(
            f"hotspot_frac + straggler_frac cover {n_hot + n_strag} > "
            f"{lam} clients")
    return n_hot, n_strag


def client_scales(config: ScenarioConfig, num_clients: int,
                  device=None) -> torch.Tensor:
    """Static per-client mean service times [λ] float32 on `device` (the
    card unless the caller passes another): hotspots first, stragglers
    last.  Computed in float32 on the host as the reference computes it."""
    lam = int(num_clients)
    n_hot, n_strag = check_fleet(config, lam)
    scales = np.full((lam,), config.mean_service, np.float32)
    if n_hot:
        scales[:n_hot] /= np.float32(config.hotspot_speedup)
    if n_strag:
        scales[lam - n_strag:] *= np.float32(config.straggler_slowdown)
    return torch.from_numpy(scales).to(resolve_device(device))


def _base_size(config: ScenarioConfig, lam: int, now) -> torch.Tensor:
    """Elastic fleet size at wall time `now` (a device scalar), >= 1."""
    n0 = max(1, int(round(config.initial_active_frac * lam)))
    if config.resize_at <= 0:
        return torch.full((), n0, dtype=torch.int32, device=now.device)
    n1 = max(1, int(round(config.resize_to_frac * lam)))
    return n0 + (n1 - n0) * (now >= config.resize_at).to(torch.int32)


def _base_mask(config: ScenarioConfig, lam: int, now) -> torch.Tensor:
    """Bool [λ] elastic membership (the first `_base_size` clients)."""
    return (torch.arange(lam, dtype=torch.int32, device=now.device)
            < _base_size(config, lam, now))


def init_scenario(config: ScenarioConfig, num_clients: int, device=None,
                  draws=None) -> ScenarioState:
    """Initial `ScenarioState` on `device` (the card unless the caller
    passes another): the initial fleet starts one draw each; parked
    clients carry ``next_t = +inf`` until elastically activated."""
    lam = int(num_clients)
    dev = resolve_device(device)
    scales = client_scales(config, lam, dev)
    now = torch.zeros((), dtype=torch.float32, device=dev)
    base = _base_mask(config, lam, now)
    first = _draw_all(config, scales, torch.zeros(lam, dtype=torch.int32,
                                                  device=dev),
                      _draws(config, draws))
    return ScenarioState(
        now=now,
        next_t=torch.where(base, first, torch.inf).to(torch.float32),
        n_draws=base.to(torch.int32),
        dropped=torch.zeros(lam, dtype=torch.bool, device=dev),
        window=torch.zeros((), dtype=torch.int32, device=dev),
    )


def window_prologue(config: ScenarioConfig, num_clients: int,
                    state: ScenarioState, scales, draws=None):
    """Per-window fleet bookkeeping before any event fires: elastic
    activation (parked clients entering the base set start a fresh draw at
    the current wall time), dropout/rejoin churn (skipped when both rates
    are 0, so a churn-free scenario consumes no churn draws), and the
    active mask base ∧ ¬dropped, falling back to the base set if churn
    darkens the whole fleet.

    Returns ``(state', active [λ] bool, n_dropouts, n_rejoins)``.
    """
    lam = int(num_clients)
    draws = _draws(config, draws)
    now = state.now
    base = _base_mask(config, lam, now)
    next_t, n_draws = state.next_t, state.n_draws

    newly = base & torch.isinf(next_t)
    fresh = _draw_all(config, scales, n_draws, draws)
    next_t = torch.where(newly, now + fresh, next_t)
    n_draws = n_draws + newly.to(torch.int32)

    dropped = state.dropped
    n_drop = n_rejoin = torch.zeros((), dtype=torch.int32, device=now.device)
    if config.dropout_rate > 0 or config.rejoin_rate > 0:
        u = draws.churn(state.window, lam)                       # [λ, 2]
        drops = base & ~dropped & (u[:, 0] < config.dropout_rate)
        rejoins = dropped & (u[:, 1] < config.rejoin_rate)
        # a rejoining client abandons its stale in-flight work and restarts
        # from the current wall time on a fresh draw of its own stream
        restart = _draw_all(config, scales, n_draws, draws)
        next_t = torch.where(rejoins, now + restart, next_t)
        n_draws = n_draws + rejoins.to(torch.int32)
        dropped = (dropped | drops) & ~rejoins
        n_drop = drops.sum(dtype=torch.int32)
        n_rejoin = rejoins.sum(dtype=torch.int32)

    active = base & ~dropped
    active = torch.where(active.any(), active, base)
    new_state = state._replace(next_t=next_t, n_draws=n_draws,
                               dropped=dropped, window=state.window + 1)
    return new_state, active, n_drop, n_rejoin


def async_window(config: ScenarioConfig, num_clients: int,
                 state: ScenarioState, scales, active, num_events: int,
                 draws=None):
    """The next `num_events` arrivals of the asynchronous race: each step
    the active client with the earliest finish time fires (``argmin``,
    ties to the lowest index), the wall clock advances to that time, and
    the client redraws from its own stream.

    The service times a window can consume — client c's draws
    ``n_draws[c] + j`` for j < K — are formed in one batch before the
    loop; each step then gathers its client's next one.  Returns
    ``(state', clients [K] int64, finish_times [K] f32)``, finish times
    nondecreasing.
    """
    lam, K = int(num_clients), int(num_events)
    dev = state.next_t.device
    n0 = state.n_draws
    if config.service == "fixed":
        dt_tab = scales[:, None].expand(lam, K)
    else:
        j = torch.arange(K, device=dev, dtype=torch.int32)
        c = torch.arange(lam, device=dev)[:, None]
        unit = _draws(config, draws).service(c, n0[:, None] + j[None, :])
        dt_tab = _service_time(config, unit, scales[:, None])   # [λ, K]
    dt_flat = dt_tab.reshape(-1)
    next_t = state.next_t.clone()
    used = torch.zeros(lam, dtype=torch.int64, device=dev)
    one = torch.ones(1, dtype=torch.int64, device=dev)
    now = state.now
    cs, ts = [], []
    for _ in range(K):
        masked = torch.where(active, next_t, torch.inf)
        c1 = torch.argmin(masked).reshape(1)
        # max() keeps the clock monotone if a reactivated client carried
        # an old finish time from before it was parked
        t = torch.maximum(masked[c1], now)
        dt = dt_flat[c1 * K + used[c1]]
        next_t.index_copy_(0, c1, t + dt)
        used.index_add_(0, c1, one)
        now = t[0]
        cs.append(c1)
        ts.append(t)
    new_state = state._replace(now=now, next_t=next_t,
                               n_draws=n0 + used.to(torch.int32))
    return new_state, torch.cat(cs), torch.cat(ts)


def sync_round(config: ScenarioConfig, num_clients: int,
               state: ScenarioState, scales, k_used: int, draws=None):
    """One synchronous round of λ arrivals ordered fastest-first (a stable
    sort: ties by index).  All λ clients start at ``now`` and draw once;
    the round ends at the ``k_used``-th order statistic t₍ₖ₎ (``k_used =
    λ`` is the full barrier).  Arrivals after the k-th are still delivered
    as events; a partial-barrier rule discards them.

    Returns ``(state', clients [λ] int64 fastest-first, finish_times [λ])``.
    """
    lam, k_used = int(num_clients), int(k_used)
    if not 1 <= k_used <= lam:
        raise ValueError(f"k_used={k_used} outside [1, {lam}]")
    dts = _draw_all(config, scales, state.n_draws, _draws(config, draws))
    order = torch.argsort(dts, stable=True)
    sorted_dt = dts[order]
    t_fin = state.now + sorted_dt
    new_state = state._replace(now=state.now + sorted_dt[k_used - 1],
                               n_draws=state.n_draws + 1)
    return new_state, order, t_fin


def _cast(x, like):
    """`x` in `like`'s dtype: a tensor is cast on its device; a Python
    number rides the op as a scalar (no host-to-device copy)."""
    return x.to(like.dtype) if isinstance(x, torch.Tensor) else x


def count_scenario(counters, *, now, active_count, dropouts, rejoins):
    """Fold one window's scenario telemetry into an `engine.Counters`:
    ``wall_clock`` is a max-fold of the absolute modelled clock; the
    scenario_* fields accumulate churn counts and the mean-active
    numerator."""
    wc = counters.wall_clock
    wall = (torch.maximum(wc, now.to(wc.dtype))
            if isinstance(now, torch.Tensor) else torch.clamp(wc, min=now))
    return counters._replace(
        wall_clock=wall,
        scenario_dropouts=(counters.scenario_dropouts
                           + _cast(dropouts, counters.scenario_dropouts)),
        scenario_rejoins=(counters.scenario_rejoins
                          + _cast(rejoins, counters.scenario_rejoins)),
        scenario_active_sum=(counters.scenario_active_sum
                             + _cast(active_count, wc)),
        scenario_windows=counters.scenario_windows + 1,
    )


def advance_wall(counters, dt, *, active_count):
    """Advance the round trainer's relative wall clock by `dt` (one round
    is one window; no churn in its fixed fleet)."""
    wc = counters.wall_clock
    return counters._replace(
        wall_clock=wc + _cast(dt, wc),
        scenario_active_sum=(counters.scenario_active_sum
                             + _cast(active_count, wc)),
        scenario_windows=counters.scenario_windows + 1,
    )


def round_draws(config: ScenarioConfig, scales, round_idx, draws=None):
    """`round_service_times` from precomputed `scales` [C] and a device
    scalar `round_idx`: device ops only."""
    idx = round_idx.to(torch.int32).expand(scales.shape[0])
    return _draw_all(config, scales, idx, _draws(config, draws))


def round_service_times(config: ScenarioConfig, num_clients: int, round_idx,
                        draws=None, device=None) -> torch.Tensor:
    """The round trainer's per-round service draws [C]: client c's draw
    number `round_idx` (a Python int or a device scalar), so client
    streams stay independent with no `ScenarioState`.  On round_idx's
    device when it is a tensor, else on `device` (the card unless the
    caller passes another)."""
    lam = int(num_clients)
    if isinstance(round_idx, torch.Tensor):
        dev = round_idx.device
    else:
        dev = resolve_device(device)
        round_idx = torch.tensor(int(round_idx), device=dev)
    return round_draws(config, client_scales(config, lam, dev), round_idx,
                       draws)
