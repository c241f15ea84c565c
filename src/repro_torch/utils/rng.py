"""The RNG seam: every random draw of the FRED simulator, by global event.

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
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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
