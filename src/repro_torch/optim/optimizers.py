"""Baseline optimizers as pure (init, update) pairs over parameter trees.

Ported from `repro.optim.optimizers`.  They serve the synchronous baseline
and the paper's RMSProp lineage (FASGD's eqs. 4-6 are the Graves (2013)
RMSProp statistics applied at the *server*; `rmsprop_graves` here is the
same statistics applied at a single worker, so with one client and τ ≡ 1
the FASGD server equals `rmsprop_graves` up to the β-smoothing of v).

Each optimizer is ``(init_fn, update_fn)``:
    state = init_fn(params)
    new_params, new_state = update_fn(params, grads, state)

Trees are the port's (`utils.trees`); no update writes in place.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.trees import leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any = None       # 1st-moment / momentum buffer
    n: Any = None       # 2nd-moment buffer
    v: Any = None       # std moving average (graves)


def _zeros(params):
    return tree_map(torch.zeros_like, params)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


def sgd(lr: float):
    """θ ← θ − lr·g."""
    def init_fn(params):
        return OptState(step=_step0(params))

    def update_fn(params, grads, state):
        new = tree_map(lambda p, g: p - lr * g, params, grads)
        return new, OptState(step=state.step + 1)

    return init_fn, update_fn


def momentum(lr: float, mu: float = 0.9, nesterov: bool = False):
    """Heavy-ball momentum m ← μ·m + g (Nesterov: step along μ·m + g)."""
    def init_fn(params):
        return OptState(step=_step0(params), m=_zeros(params))

    def update_fn(params, grads, state):
        m = tree_map(lambda b, g: mu * b + g, state.m, grads)
        upd = tree_map(lambda b, g: mu * b + g, m, grads) if nesterov else m
        new = tree_map(lambda p, u: p - lr * u, params, upd)
        return new, OptState(step=state.step + 1, m=m)

    return init_fn, update_fn


def rmsprop_graves(lr: float, gamma: float = 0.95, eps: float = 1e-4):
    """RMSProp as in Graves (2013), the version the paper cites for FASGD:
    divide by sqrt(MA(g²) − MA(g)² + eps), a running *std*, not a running
    rms."""

    def init_fn(params):
        return OptState(step=_step0(params), m=_zeros(params),
                        n=_zeros(params))

    def update_fn(params, grads, state):
        n = tree_map(lambda a, g: gamma * a + (1 - gamma) * g * g,
                     state.n, grads)
        m = tree_map(lambda a, g: gamma * a + (1 - gamma) * g, state.m, grads)
        new = tree_map(
            lambda p, g, nn, mm: p - lr * g / torch.sqrt(
                torch.clamp(nn - mm * mm, min=0.0) + eps),
            params, grads, n, m)
        return new, OptState(step=state.step + 1, m=m, n=n)

    return init_fn, update_fn


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam with bias corrections; the corrections are float32 tensors, as
    the reference computes them (``b1 ** float32(t)``), not Python
    doubles."""
    def init_fn(params):
        return OptState(step=_step0(params), m=_zeros(params),
                        n=_zeros(params))

    def update_fn(params, grads, state):
        t = state.step + 1
        m = tree_map(lambda a, g: b1 * a + (1 - b1) * g, state.m, grads)
        n = tree_map(lambda a, g: b2 * a + (1 - b2) * g * g, state.n, grads)
        tf = t.float()
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=tf.device), tf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=tf.device), tf)
        new = tree_map(
            lambda p, mm, nn: p - lr * (mm / c1) / (torch.sqrt(nn / c2) + eps),
            params, m, n)
        return new, OptState(step=t, m=m, n=n)

    return init_fn, update_fn


_REGISTRY: dict[str, Callable] = {
    "sgd": sgd,
    "momentum": momentum,
    "rmsprop_graves": rmsprop_graves,
    "adam": adam,
}


def get_optimizer(name: str, lr: float, **kwargs):
    """``(init_fn, update_fn)`` of the optimizer registered as `name`."""
    return _REGISTRY[name](lr, **kwargs)
