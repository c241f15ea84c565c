"""The cotangent fused path in the port, against a live run of the JAX
reference: `reweight_by_v`, FASGD's ε-reparameterised split, the
shared/delta MLP loss, `engine.fused_apply_cotangent` and FRED's
``fused_mode='cotangent'`` / ``'auto'``.

The same numpy state, stale copies and minibatches go into both packages.
Tolerances as in tests/test_torch_engine.py and tests/test_torch_fred.py:
one forward fp32 rtol 1e-5 / atol 1e-6, K-event sums rtol 1e-4 / atol
1e-6; FRED runs rtol 1e-4 / atol 1e-5 on floats; τ, T and counters
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import engine as jengine
from repro.core import rules as jrules
from repro.core.bandwidth import BandwidthConfig as JBandwidthConfig
from repro.core.rules import ServerConfig as JServerConfig
from repro.models.mlp import nll_loss as j_nll_loss
from repro.sim.fred import SimConfig as JSimConfig

from repro_torch.core import engine, rules
from repro_torch.core.bandwidth import BandwidthConfig
from repro_torch.core.rules import ServerConfig
from repro_torch.models.mlp import nll_loss, nll_loss_event_batched
from repro_torch.sim import fred
from repro_torch.sim.fred import SimConfig, run_simulation
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.trees import leaves, tree_map

from test_torch_engine import KSUM, TOL, _close_state, _pair, _tree
from test_torch_fred import (check_against_reference, one_thread,  # noqa: F401
                             setup)

COEFF_RULES = ("asgd", "sasgd", "exp", "poly")
K, MU = 8, 6          # μ differs from every leaf dimension (SIZES 30, 12, 5)


def _window(seed=21, n_out=5, d_in=30):
    """Stale copies (server params + noise, [K, ...]), a minibatch per
    event, push mask and timestamps, as numpy."""
    rng = np.random.default_rng(seed)
    stale = _tree(0, lead=())
    stale = [{k: (l[None] + 0.05 * rng.standard_normal((K,) + l.shape))
              .astype(np.float32) for k, l in layer.items()}
             for layer in stale]
    x = rng.standard_normal((K, MU, d_in)).astype(np.float32)
    y = rng.integers(0, n_out, (K, MU)).astype(np.int32)
    push = np.array([1, 0, 1, 1, 1, 0, 1, 1], bool)
    ts = np.array([9, 3, 5, 9, 1, 0, 5, 9], np.int32)
    return stale, x, y, push, ts


def test_reweight_by_v_is_the_identity_with_a_scaled_pullback():
    """Forward: the identity.  Backward: the cotangent times `vfac`, cast
    to the cotangent's dtype — bitwise the reference's pullback, in
    float32 and bfloat16."""
    rng = np.random.default_rng(0)
    vfac = rng.uniform(0.5, 4.0, (3, 7)).astype(np.float32)
    w = rng.standard_normal((3, 7)).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        ct = rng.standard_normal((3, 7)).astype(np.float32)
        W = torch.from_numpy(w).to(dtype).requires_grad_()
        out = engine.reweight_by_v([W], [torch.from_numpy(vfac)])[0]
        assert torch.equal(out, W)
        (got,) = torch.autograd.grad(out, W,
                                     torch.from_numpy(ct).to(dtype))
        assert got.dtype == dtype
        _, pull = jax.vjp(
            lambda p: jengine.reweight_by_v(p, {"w": jnp.asarray(vfac)}),
            {"w": jnp.asarray(w, jdtype)})
        want = pull({"w": jnp.asarray(ct, jdtype)})[0]["w"]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
        np.testing.assert_array_equal(
            got.float().numpy(),
            (torch.from_numpy(vfac) * torch.from_numpy(ct).to(dtype))
            .to(dtype).float().numpy())


def test_fasgd_split_matches_reference():
    """fused_coeffs · fused_vfactor, leaf by leaf: α/(τ_k·(v+ε)), and the
    base class refuses a v-factor for rules without the split."""
    jcfg, cfg, js, ts = _pair()
    taus = np.array([1, 2, 3, 7], np.float32)
    rule, jrule = rules.get_rule("fasgd"), jrules.get_rule("fasgd")
    coeffs = rule.fused_coeffs(cfg, torch.from_numpy(taus))
    jcoeffs = jrule.fused_coeffs(jcfg, jnp.asarray(taus))
    vf = rule.fused_vfactor(cfg, ts.v)
    jvf = jrule.fused_vfactor(jcfg, js.v)
    for a, b in zip(leaves(vf), jax.tree.leaves(jvf)):
        assert a.dtype == torch.float32
        got = coeffs.reshape((-1,) + (1,) * a.dim()) * a[None]
        want = jcoeffs.reshape((-1,) + (1,) * b.ndim) * b[None]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in COEFF_RULES:
        with pytest.raises(NotImplementedError):
            rules.get_rule(name).fused_vfactor(cfg, ts.v)


def test_event_batched_mlp_loss_matches_reference_and_vmap():
    """The shared/delta loss against the reference's, against the port's
    own `vmap` of `nll_loss` over the per-event parameters, and the generic
    fallback; `nll_loss.event_batched` is attached as in the reference."""
    stale, x, y, _, _ = _window()
    W = _tree(0)
    deltas = [{k: l - W[i][k][None] for k, l in layer.items()}
              for i, layer in enumerate(stale)]
    J = lambda t: jax.tree.map(jnp.asarray, t)
    want = j_nll_loss.event_batched(J(W), J(deltas), jnp.asarray(x),
                                    jnp.asarray(y))
    tW, td = (params_from_numpy(W, device="cpu"),
              params_from_numpy(deltas, device="cpu"))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()
    fast = nll_loss.event_batched(tW, td, tx, ty)
    assert nll_loss.event_batched is nll_loss_event_batched
    np.testing.assert_allclose(fast.numpy(), np.asarray(want), **TOL)
    direct = torch.func.vmap(nll_loss)(
        tree_map(lambda w, d: w[None] + d, tW, td), tx, ty)
    np.testing.assert_allclose(fast.numpy(), direct.numpy(), **TOL)
    generic = engine.event_batched_losses(nll_loss)(tW, td, tx, ty)
    np.testing.assert_allclose(generic.numpy(), direct.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert (engine.resolve_event_batched_loss(nll_loss)
            is nll_loss_event_batched)
    marker = lambda *a: None
    assert engine.resolve_event_batched_loss(nll_loss, marker) is marker
    plain = lambda p, xb, yb: nll_loss(p, xb, yb)
    np.testing.assert_allclose(
        engine.resolve_event_batched_loss(plain)(tW, td, tx, ty).numpy(),
        direct.numpy(), rtol=1e-6, atol=1e-7)


def _both(rule, track_stats, all_dropped, batched=None):
    """One window through both packages' `fused_apply_cotangent` from the
    same server state; returns ((port server, τ, losses), reference's)."""
    kw = {} if track_stats is None else dict(track_stats=track_stats)
    jcfg, cfg, js, ts = _pair(rule=rule, **kw)
    stale, x, y, push, grad_ts = _window()
    if all_dropped:
        push = np.zeros_like(push)
    J = lambda t: jax.tree.map(jnp.asarray, t)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want = jengine.fused_apply_cotangent(
        jcfg, js, lambda W, d: j_nll_loss.event_batched(W, d, jx, jy),
        J(stale), jnp.asarray(push), jnp.asarray(grad_ts))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()
    batched = batched or nll_loss_event_batched
    got = engine.fused_apply_cotangent(
        cfg, ts, lambda W, d: batched(W, d, tx, ty),
        params_from_numpy(stale, device="cpu"), torch.from_numpy(push),
        torch.from_numpy(grad_ts))
    return got, want


@pytest.mark.parametrize("rule", COEFF_RULES + ("fasgd",))
@pytest.mark.parametrize("track_stats", [True, False])
@pytest.mark.parametrize("all_dropped", [False, True])
def test_fused_apply_cotangent_matches_reference(rule, track_stats,
                                                 all_dropped):
    """θ, n, b, v and T after one window (fasgd requires its statistics,
    so track_stats off still advances them), τ exactly, the drain-time
    losses; a window where no event pushed leaves θ, the statistics and T
    where they were."""
    (srv, taus, losses), (jsrv, jtaus, jlosses) = _both(rule, track_stats,
                                                        all_dropped)
    _close_state(srv, jsrv, KSUM)
    np.testing.assert_array_equal(taus.numpy(), np.asarray(jtaus))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **TOL)
    if all_dropped:
        _, _, js, _ = _pair(rule=rule)
        _close_state(srv, js, dict(rtol=0, atol=0))
    assert not losses.requires_grad
    assert all(not l.requires_grad for l in leaves(srv.params))


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in leaves(list(out) if isinstance(out, (list, tuple))
                        else [out]):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def _backward_shapes(monkeypatch, batched):
    """The output shapes of every op inside `fused_apply_cotangent`'s
    backward passes (the dispatch mode is active only around
    `torch.autograd.grad`)."""
    mode = _Shapes()
    grad = torch.autograd.grad

    def recorded(*args, **kwargs):
        with mode:
            return grad(*args, **kwargs)
    monkeypatch.setattr(torch.autograd, "grad", recorded)
    _both("sasgd", True, False, batched=batched)
    monkeypatch.undo()
    return mode.shapes


def test_cotangent_backward_forms_no_per_event_gradient(monkeypatch):
    """The point of the path: no [K, ...leaf shape] tensor inside the
    backward.  The generic vmap fallback does form one, which shows the
    check can see it."""
    leaf_shapes = [tuple(l.shape) for l in leaves(_pair()[3].params)]
    per_event = {(K,) + s for s in leaf_shapes}
    shapes = _backward_shapes(monkeypatch, nll_loss_event_batched)
    assert shapes, "the backward ran no op under the dispatch mode"
    assert not per_event & set(shapes), sorted(per_event & set(shapes))
    generic = _backward_shapes(monkeypatch,
                               engine.event_batched_losses(nll_loss))
    assert per_event & set(generic)


def test_fused_apply_cotangent_refusals():
    """As the reference: a rule whose scale does not ride the cotangent
    path, and per-leaf masks or timestamps, raise ValueError."""
    stale, _, _, push, ts = _window()
    args = (lambda W, d: torch.zeros(K),
            params_from_numpy(stale, device="cpu"))
    push, ts = torch.from_numpy(push), torch.from_numpy(ts)
    _, cfg, _, server = _pair(rule="gap")
    with pytest.raises(ValueError, match="cotangent"):
        engine.fused_apply_cotangent(cfg, server, *args, push, ts)
    _, cfg, _, server = _pair(rule="sasgd")
    per_leaf = lambda t: tree_map(lambda _: t, server.params)
    with pytest.raises(ValueError, match="per-leaf"):
        engine.fused_apply_cotangent(cfg, server, *args, per_leaf(push), ts)
    with pytest.raises(ValueError, match="per-leaf"):
        engine.fused_apply_cotangent(cfg, server, *args, push, per_leaf(ts))


# ---------------------------------------------------------------------------
# FRED
# ---------------------------------------------------------------------------

FUSED = dict(num_clients=16, batch_size=8, seed=3, events_per_step=8,
             apply_mode="fused")
CASES = {
    # 'auto' resolves to the cotangent path: v-independent, kernel off
    "sasgd_auto_k8": dict(sim=FUSED, server=dict(rule="sasgd", lr=0.05)),
    "sasgd_auto_k1": dict(sim=dict(FUSED, events_per_step=1),
                          server=dict(rule="sasgd", lr=0.05)),
    "fasgd_cotangent": dict(sim=dict(FUSED, fused_mode="cotangent"),
                            server=dict(rule="fasgd", lr=0.01)),
    "exp_auto_gated_skip": dict(
        sim=dict(FUSED, seed=7), server=dict(rule="exp", lr=0.05),
        bandwidth=dict(c_push=2.0, c_fetch=2.0, drop_policy="skip")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cotangent_run_simulation_matches_reference(setup, name,  # noqa: F811
                                                    monkeypatch):
    """FRED on the cotangent path against the reference (which resolves
    'auto' the same way): every window goes through
    `fused_apply_cotangent` and none through `fused_apply`."""
    case = CASES[name]
    cfg = SimConfig(server=ServerConfig(**case["server"]),
                    bandwidth=BandwidthConfig(**case.get("bandwidth", {})),
                    **case["sim"])
    j_cfg = JSimConfig(server=JServerConfig(**case["server"]),
                       bandwidth=JBandwidthConfig(**case.get("bandwidth",
                                                             {})),
                       **case["sim"])
    assert cfg.cotangent_serviceable() == j_cfg.cotangent_serviceable()
    assert cfg.cotangent_eligible() == j_cfg.cotangent_eligible()
    calls = {"cotangent": 0, "materialized": 0}
    for name_, fn in (("cotangent", engine.fused_apply_cotangent),
                      ("materialized", engine.fused_apply)):
        def counted(*a, _fn=fn, _n=name_, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(engine, fn.__name__, counted)
    check_against_reference(setup, name, case)
    assert calls == {"cotangent": -(-48 // case["sim"]["events_per_step"]),
                     "materialized": 0}


@pytest.mark.parametrize("rule", ["sasgd", "fasgd"])
def test_cotangent_matches_the_ports_materialized_path(setup,  # noqa: F811
                                                       rule):
    """The port against itself, from the same native draws: cotangent and
    materialized reductions agree within the K-sum tolerance (fasgd: plus
    its ε-reparameterisation, ≤ ε/(v+ε) of each update), τ, counters and
    T exactly; 'auto' is bitwise the path it resolves to."""
    params, ds = setup
    base = SimConfig(server=ServerConfig(rule=rule, lr=0.02), **FUSED)
    run = lambda cfg: run_simulation(
        cfg, nll_loss, params_from_numpy(params, device="cpu"),
        ds["x_train"], ds["y_train"], 48, eval_every=48,
        collect_step_metrics=True, device="cpu")
    mat = run(dataclasses.replace(base, fused_mode="materialized"))
    cot = run(dataclasses.replace(base, fused_mode="cotangent"))
    auto = run(base)
    assert torch.equal(mat["tau"], cot["tau"])
    assert mat["counters"] == cot["counters"]
    assert mat["final_timestamp"] == cot["final_timestamp"]
    for field in ("params", "n", "b", "v"):
        for a, b in zip(leaves(getattr(cot["state"].server, field)),
                        leaves(getattr(mat["state"].server, field))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=field,
                                       rtol=1e-4, atol=1e-5)
    same = cot if rule == "sasgd" else mat
    for a, b in zip(leaves(auto["state"].server.params),
                    leaves(same["state"].server.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw,jkw", [
    # a rule whose scale needs the stale copies (gap)
    (dict(server=ServerConfig(rule="gap")),
     dict(server=JServerConfig(rule="gap"))),
    # per-tensor gating needs per-leaf weight vectors
    (dict(bandwidth=BandwidthConfig(per_tensor_fetch=True)),
     dict(bandwidth=JBandwidthConfig(per_tensor_fetch=True))),
    (dict(bandwidth=BandwidthConfig(per_tensor_push=True)),
     dict(bandwidth=JBandwidthConfig(per_tensor_push=True))),
    # the gradient cache stores per-event gradients the path never forms
    (dict(bandwidth=BandwidthConfig(c_push=1.0, drop_policy="cache")),
     dict(bandwidth=JBandwidthConfig(c_push=1.0, drop_policy="cache"))),
    # the kernel selects the one-kernel materialized path
    (dict(server=ServerConfig(rule="sasgd", use_fused_kernel=True)),
     dict(server=JServerConfig(rule="sasgd", use_fused_kernel=True))),
    # the serial apply mode
    (dict(apply_mode="serial"), dict(apply_mode="serial")),
])
def test_cotangent_refusals_match_reference(kw, jkw):
    """Where the reference's SimConfig asserts, the port raises
    ValueError; 'auto' on such a configuration takes the materialized
    path in both."""
    base = dict(apply_mode="fused", events_per_step=4,
                server=ServerConfig(rule="sasgd"))
    jbase = dict(apply_mode="fused", events_per_step=4,
                 server=JServerConfig(rule="sasgd"))
    with pytest.raises(AssertionError, match="cotangent"):
        JSimConfig(**{**jbase, **jkw, "fused_mode": "cotangent"})
    with pytest.raises(ValueError, match="cotangent"):
        SimConfig(**{**base, **kw, "fused_mode": "cotangent"})
    cfg = SimConfig(**{**base, **kw})
    assert not fred._use_cotangent(cfg)
    assert (cfg.cotangent_eligible()
            == JSimConfig(**{**jbase, **jkw}).cotangent_eligible())
