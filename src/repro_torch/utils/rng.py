"""The RNG seam: every random draw of the FRED simulator, by global event,
of the round trainer, by round, and of the scenarios, by client and draw.

The JAX simulator derives one key per global event index,
``fold_in(PRNGKey(seed), i)``, and splits it into dispatch, batch, push and
fetch keys.  `jax.random` cannot be reproduced in torch, so the port asks a
*provider* for the draws of events ``[start, start + count)``:

* the client each event dispatches (uniform and heterogeneous dispatchers;
  round-robin needs no draw),
* the event's minibatch row indices,
* the uniforms its push gate and its fetch gate compare against eq. 9:
  one per event for whole-copy gating, one per parameter tensor (in leaf
  order) for per-tensor gating (§5) in that direction.

Two providers share that interface.  `NativeDraws` is counter-based: each
event's draws come from a `torch.Generator` seeded from ``(seed, event
index)`` alone, so serial trajectories do not depend on the window size K.
`ReplayDraws` hands back draws made elsewhere; the parity tests fill it with
the exact draws `jax.random` made for the reference run.

The round trainer's gates (`NativeRoundDraws` / `ReplayRoundDraws`, one
`RoundDraws` a round) and a scenario's service and churn variates
(`NativeScenarioDraws` / `ReplayScenarioDraws`) sit behind the same kind
of seam; their native providers hash the counters on the device (below).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

_GOLDEN = 0x9E3779B9          # odd, so i -> i·_GOLDEN is a bijection mod 2^32
_MASK32 = 0xFFFFFFFF


class Draws(NamedTuple):
    """The draws of a run of consecutive events, on the run's device."""

    clients: torch.Tensor     # [E] int64 — dispatched client (unused by rr)
    idx: torch.Tensor         # [E, μ] int64 — minibatch rows
    # uniforms of the push and fetch gates: [E] float32, or [E, n_leaves]
    # in a direction gated per tensor
    push_u: torch.Tensor
    fetch_u: torch.Tensor

    def window(self, lo: int, hi: int) -> "Draws":
        """The draws of events ``[lo, hi)`` of this run (views, no copy)."""
        return Draws(*(t[lo:hi] for t in self))


def _mix32(x: int) -> int:
    """splitmix64's finaliser, cut to 32 bits (the width `torch.Generator`'s
    Mersenne twister takes its seed in)."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) & _MASK32


def _to_device(host: Draws, device) -> Draws:
    device = torch.device(device)
    if device.type == "cuda":
        return Draws(*(t.pin_memory().to(device, non_blocking=True)
                       for t in host))
    return Draws(*(t.to(device) for t in host))


class NativeDraws:
    """Counter-based provider: event i's draws come from a generator seeded
    with a 32-bit hash of ``seed`` plus ``i·0x9E3779B9`` — distinct for every
    event of a run below 2^32 events.

    The heterogeneous dispatcher's per-client speed logits are drawn once
    from ``seed ^ 0x5EED``, as in the reference.

    Under per-tensor gating the `n_leaves` uniforms of a direction so gated
    (push first) come from the event's generator after its whole-copy
    draws, in the same call as the two whole-copy gate uniforms (the CPU
    generator fills a tensor in sequence, so those two keep their values):
    the client, the minibatch and a whole-copy run's stream do not change
    when per-tensor gating is turned on or off.
    """

    def __init__(self, seed: int, num_clients: int, batch_size: int,
                 n_data: int, dispatcher: str = "uniform",
                 het_skew: float = 1.5, n_leaves: int = 0,
                 per_tensor_push: bool = False,
                 per_tensor_fetch: bool = False):
        if (per_tensor_push or per_tensor_fetch) and n_leaves < 1:
            raise ValueError("per-tensor gating needs n_leaves >= 1")
        self.base = _mix32(seed)
        self.num_clients = num_clients
        self.batch_size = batch_size
        self.n_data = n_data
        self.dispatcher = dispatcher
        self.per_tensor = (per_tensor_push, per_tensor_fetch)
        self.n_leaves = n_leaves
        self.probs = None
        if dispatcher == "heterogeneous":
            g = torch.Generator().manual_seed(_mix32(seed ^ 0x5EED))
            logits = het_skew * torch.randn(num_clients, generator=g)
            self.probs = torch.softmax(logits, dim=0)

    def events(self, start: int, count: int, device) -> Draws:
        """The draws of events ``[start, start + count)`` on `device`."""
        clients = torch.zeros(count, dtype=torch.int64)
        idx = torch.empty((count, self.batch_size), dtype=torch.int64)
        n_u = 2 + self.n_leaves * sum(self.per_tensor)
        u = torch.empty((count, n_u), dtype=torch.float32)
        g = torch.Generator()
        for j in range(count):
            g.manual_seed((self.base + (start + j) * _GOLDEN) & _MASK32)
            if self.dispatcher == "uniform":
                clients[j] = torch.randint(self.num_clients, (), generator=g)
            elif self.dispatcher == "heterogeneous":
                clients[j] = torch.multinomial(self.probs, 1, generator=g)[0]
            idx[j] = torch.randint(self.n_data, (self.batch_size,),
                                   generator=g)
            u[j] = torch.rand(n_u, generator=g)
        gates, first = [], 2
        for d, on in enumerate(self.per_tensor):
            if on:
                gates.append(u[:, first:first + self.n_leaves].contiguous())
                first += self.n_leaves
            else:
                gates.append(u[:, d].clone())
        return _to_device(Draws(clients, idx, *gates), device)


class ReplayDraws:
    """Replays draws given as arrays over all events of a run (numpy or
    torch, indexed by global event); `push_u` and `fetch_u` are [E] or, in
    a direction gated per tensor, [E, n_leaves]."""

    def __init__(self, clients, idx, push_u, fetch_u):
        as_t = lambda a, dt: torch.as_tensor(np.asarray(a)).to(dt)
        self.all = Draws(as_t(clients, torch.int64), as_t(idx, torch.int64),
                         as_t(push_u, torch.float32),
                         as_t(fetch_u, torch.float32))

    def events(self, start: int, count: int, device) -> Draws:
        """The recorded draws of events ``[start, start + count)``."""
        if start + count > self.all.idx.shape[0]:
            raise IndexError(
                f"replay holds {self.all.idx.shape[0]} events, asked for "
                f"[{start}, {start + count})")
        return _to_device(self.all.window(start, start + count), device)


# ---------------------------------------------------------------------------
# counter-based draws on the device: the round trainer and the scenarios
# ---------------------------------------------------------------------------
#
# A draw of the paths below is a pure function of integer counters (seed,
# round, client, draw index, window), computed by an integer hash in torch
# ops on the device that holds the counters, so a loop whose counters live
# on the card never waits for the host.  The hash keeps 32-bit lanes in
# int64 tensors: a product of a lane and a 32-bit constant is formed from
# the constant's two 16-bit halves, so no intermediate exceeds 2^49 and the
# arithmetic is exact, the same bits on the CPU and on the card.

_SVC_SALT = 0x5E11CE      # service-time stream (the reference's salts)
_CHURN_SALT = 0xC4192     # dropout / rejoin stream
_ROUND_SALT = 0x40D5      # round trainer's push / fetch gates


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x·c mod 2^32`` for int64 `x` holding 32-bit values, exactly."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32_t(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit finaliser (lowbias32) on int64 lanes."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash32(base: int, *words) -> torch.Tensor:
    """32-bit hash (int64 tensor) of a host constant `base` and integer
    tensors or Python ints `words` (broadcast together; at least one a
    tensor): each word is added times an odd constant and mixed in, a
    bijection of the word for a fixed prefix."""
    h = base
    for w in words:
        if isinstance(w, int):                  # a host constant
            w = (w * _GOLDEN) & _MASK32
        else:
            w = _mul32(w.to(torch.int64) & _MASK32, _GOLDEN)
        h = _mix32_t((h + w) & _MASK32)
    return h


def unit_f32(h: torch.Tensor) -> torch.Tensor:
    """A uniform in [0, 1) from a 32-bit hash: its top 24 bits times 2^-24,
    exact in float32."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def open_unit_f64(h: torch.Tensor) -> torch.Tensor:
    """A uniform in (0, 1) from a 32-bit hash, ``(h + 1/2)·2^-32`` in
    float64 (exact), for transforms that need both ends open."""
    return (h.to(torch.float64) + 0.5) * (1.0 / (1 << 32))


class RoundDraws(NamedTuple):
    """The gate uniforms of one round of the round trainer: [C] float32, or
    [C, n_leaves] in a direction gated per tensor."""

    push_u: torch.Tensor
    fetch_u: torch.Tensor


class NativeRoundDraws:
    """Counter-based provider of the round trainer's gates: client c's push
    (lane 0) and fetch (lane 1) uniforms of round r, leaf i's under
    per-tensor gating (lanes 2 + i and 2 + n_leaves + i), are
    ``hash32(seed, r, c, lane)`` on `device` (the card unless the caller
    passes another).  `round` takes r as a Python int or a device scalar
    (``state.round_idx``), so a loop of rounds needs no host sync."""

    def __init__(self, seed: int, num_clients: int, n_leaves: int = 0,
                 per_tensor_push: bool = False,
                 per_tensor_fetch: bool = False, device=None):
        if (per_tensor_push or per_tensor_fetch) and n_leaves < 1:
            raise ValueError("per-tensor gating needs n_leaves >= 1")
        self.base = _mix32(seed ^ _ROUND_SALT)
        self.num_clients = num_clients
        self.n_leaves = n_leaves
        self.per_tensor = (per_tensor_push, per_tensor_fetch)
        self.device = resolve_device(device)

    def round(self, r) -> RoundDraws:
        """The draws of round `r`."""
        dev = self.device
        c = torch.arange(self.num_clients, device=dev)[:, None]
        r = torch.as_tensor(r).to(device=dev, dtype=torch.int64)
        out = []
        for d, on in enumerate(self.per_tensor):
            if on:
                first = 2 + d * self.n_leaves
                lane = torch.arange(first, first + self.n_leaves, device=dev)
                out.append(unit_f32(hash32(self.base, r, c, lane[None, :])))
            else:
                out.append(unit_f32(hash32(self.base, r, c[:, 0], d)))
        return RoundDraws(*out)


class ReplayRoundDraws:
    """Replays the gates of rounds given as arrays [R, C] (or [R, C,
    n_leaves] per tensor), indexed by round, on `device` (the card unless
    the caller passes another); `round` takes a Python int."""

    def __init__(self, push_u, fetch_u, device=None):
        dev = resolve_device(device)
        as_t = lambda a: torch.as_tensor(np.array(a, np.float32)).to(dev)
        self.push_u, self.fetch_u = as_t(push_u), as_t(fetch_u)

    def round(self, r: int) -> RoundDraws:
        """The recorded draws of round `r`."""
        r = int(r)
        if r >= self.push_u.shape[0]:
            raise IndexError(f"replay holds {self.push_u.shape[0]} rounds, "
                             f"asked for round {r}")
        return RoundDraws(self.push_u[r], self.fetch_u[r])


class NativeScenarioDraws:
    """Counter-based provider of a scenario's variates, computed on the
    device of the counters it is given, with no host round trip:

    * `service(c, n)`: the unit variate of client c's n-th service draw —
      a standard normal (``'lognormal'``: ``√2·erfinv(2u − 1)``) or a
      Pareto(α) on [1, ∞) (``'pareto'``: ``u^(−1/α)``), u in (0, 1) from
      ``hash32(seed ⊕ salt, c, n)``; the transform runs in float64 and is
      rounded once to float32;
    * `churn(window, lam)`: the [λ, 2] dropout and rejoin uniforms of a
      window, from ``hash32(seed ⊕ salt, c, window, lane)``.

    Client c's stream depends on nothing but (seed, c, n) and (seed, c,
    window), as the reference's ``fold_in`` streams do: removing client i
    never moves client j's draws.
    """

    def __init__(self, seed: int, service: str, pareto_alpha: float = 1.5):
        self.svc_base = _mix32(seed ^ _SVC_SALT)
        self.churn_base = _mix32(seed ^ _CHURN_SALT)
        self.kind = service
        self.alpha = float(pareto_alpha)

    def service(self, c, n) -> torch.Tensor:
        """Unit variates (float32) of the draws ``(c, n)``, broadcast."""
        u = open_unit_f64(hash32(self.svc_base, c, n))
        if self.kind == "pareto":
            x = torch.pow(u, -1.0 / self.alpha)
        else:
            x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        return x.to(torch.float32)

    def churn(self, window, lam: int) -> torch.Tensor:
        """[λ, 2] float32 uniforms of window `window` (a device scalar)."""
        window = torch.as_tensor(window)
        c = torch.arange(lam, device=window.device)[:, None]
        lane = torch.arange(2, device=window.device)[None, :]
        return unit_f32(hash32(self.churn_base, c, window, lane))


class ReplayScenarioDraws:
    """Replays a scenario's variates from tables: `service_table` [λ, N]
    (client c's n-th unit variate at ``[c, n]``) and `churn_table` [W, λ,
    2] (window w's uniforms).  The tables move to the device of the first
    counters they are asked for; an index past a table raises."""

    def __init__(self, service_table=None, churn_table=None):
        as_t = lambda a: (None if a is None else
                          torch.as_tensor(np.array(a, np.float32)))
        self.tables = {"service": as_t(service_table),
                       "churn": as_t(churn_table)}

    def _table(self, name, device):
        tab = self.tables[name]
        if tab is None:
            raise ValueError(f"this replay holds no {name} table")
        if tab.device != torch.device(device):
            tab = self.tables[name] = tab.to(device)
        return tab

    def service(self, c, n) -> torch.Tensor:
        """The recorded unit variates at ``[c, n]``, broadcast."""
        c, n = torch.as_tensor(c), torch.as_tensor(n)
        tab = self._table("service", c.device)
        if c.device.type == "cpu" and int(n.max()) >= tab.shape[1]:
            raise IndexError(f"replay holds {tab.shape[1]} draws per "
                             f"client, asked for draw {int(n.max())}")
        return tab[c.long(), n.long()]

    def churn(self, window, lam: int) -> torch.Tensor:
        """The recorded [λ, 2] uniforms of `window`."""
        window = torch.as_tensor(window)
        return self._table("churn", window.device)[window.long()][:lam]
