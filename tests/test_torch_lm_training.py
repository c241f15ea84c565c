"""The port's LM training against a live run of the JAX reference.

The reference tests' tiny LM (tinyllama's dense family at 2 layers,
d_model 64, 4 heads over 2 kv heads, d_ff 128, vocab 128, head_dim 16) and
its Markov-chain tokens (S = 16) go through both packages from the same
weights and tokens, carried across through numpy: the stale-offset layer
forms, the exact q-chunked `_sdpa`, `transformer.loss_fn` (value and every
leaf's gradient, dense and chunked cross-entropy, with and without
`deltas`), the event-batched loss of `models.lm`, FRED on the LM (the
`tests/test_lm_equivalence.py` matrix: serial, fused materialized,
cotangent, per-tensor and queued drains, with the reference's draws
replayed) and the round trainer on the LM (serial, fused, cotangent; and
in bf16 at `examples/train_lm_fasgd.py`'s operating point, with the
held-out CE after every round).  Then the port alone: the law of
`data/tokens.py`, the properties of `tests/test_lm_properties.py`, and the
flash kernel's refusal to train.

Tolerances: float32 rtol 1e-4 / atol 1e-5, bfloat16 rtol 5e-2 / atol 5e-2
(the reference's own, `tests/test_lm_properties.py`) except where a bound
scaled to the leaf is tighter: bf16 gradients and round-trainer state
within 8 bf16 ulps of the leaf's largest reference entry, bf16 losses
within one bf16 rounding or, over rounds, 2e-3; τ, T, the counters and
the integer state exactly.  The event-batched form computes
`einsum(x, W) + einsum(x, δ)`, not `einsum(x, W + δ)`, so it is held to
the per-event loss within tolerance, not bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.configs.base import TrainerConfig as JTrainerConfig
from repro.core import round_trainer as jrt
from repro.core.bandwidth import BandwidthConfig as JBandwidthConfig
from repro.core.rules import ServerConfig as JServerConfig
from repro.data.tokens import TokenDataConfig as JTokenDataConfig
from repro.data.tokens import make_batch as j_make_batch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.lm import make_eval_fn as j_make_eval_fn
from repro.models.lm import make_lm_loss as j_make_lm_loss
from repro.models.transformer import init_model as j_init_model
from repro.models.transformer import loss_fn as j_loss_fn
from repro.sim.fred import SimConfig as JSimConfig
from repro.sim.fred import run_simulation as j_run_simulation

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainerConfig
from repro_torch.core import engine
from repro_torch.core import round_trainer as rt
from repro_torch.core.bandwidth import BandwidthConfig
from repro_torch.core.rules import ServerConfig
from repro_torch.data import tokens as tok_mod
from repro_torch.kernels import ops
from repro_torch.models import attention, layers, transformer
from repro_torch.models.lm import make_eval_fn, make_lm_loss
from repro_torch.sim.fred import SimConfig, run_simulation
from repro_torch.utils.convert import lm_params_from_numpy, to_numpy
from repro_torch.utils.trees import leaves, tree_map

from test_torch_fred import (RTOL, ATOL, assert_counters_match,  # noqa: F401
                             one_thread, replay_of)
from test_torch_round_trainer import (compare_metrics, compare_states,
                                      round_replay)

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=128, head_dim=16)
SEQ = 16
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
N_LEAVES = 12
BF16_ULP = 2.0 ** -7
BF16_GRAD_ULPS = 8


class Tiny:
    """The tiny LM in both packages: configs, weights and a token pool."""

    def __init__(self, dtype, jparams, tok, tgt):
        self.dtype = dtype
        self.jcfg = j_get_smoke_config("tinyllama-1.1b", param_dtype=dtype,
                                       **TINY)
        self.cfg = get_smoke_config("tinyllama-1.1b", param_dtype=dtype,
                                    **TINY)
        # the reference draws every weight in float32 and casts it once
        self.jparams = jax.tree.map(lambda a: a.astype(dtype), jparams)
        self.np_params = jax.tree.map(np.asarray, self.jparams)
        self.tok, self.tgt = tok, tgt

    def params(self):
        return lm_params_from_numpy(self.np_params, device="cpu")

    def batch(self, lo, hi):
        return (torch.as_tensor(self.tok[lo:hi]),
                torch.as_tensor(self.tgt[lo:hi]))


@pytest.fixture(scope="module")
def tiny():
    jparams = jax.jit(j_init_model, static_argnums=1)(
        jax.random.PRNGKey(0), j_get_smoke_config("tinyllama-1.1b", **TINY))
    data = JTokenDataConfig(vocab_size=128, seq_len=SEQ, batch_size=128,
                            temperature=0.5)
    tok, tgt = jax.jit(lambda: j_make_batch(data, 0))()
    tok, tgt = np.array(tok), np.array(tgt)
    return {dt: Tiny(dt, jparams, tok, tgt) for dt in ("float32", "bfloat16")}


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=what,
                               **tol)


def _within_ulps_of_max(got, want, ulps, what=""):
    """max|got − want| ≤ `ulps` bf16 ulps of max|want|: a bound scaled to
    the leaf, which a zero or halved leaf exceeds many times over."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= ulps * BF16_ULP * scale, (
        f"{what}: max|Δ| {err:.3e} above {ulps} bf16 ulps of max|ref| "
        f"{scale:.3e}")


def _deltas(np_params, k, scale, seed):
    """[k, ...] stale offsets of `scale` · N(0, 1), in the leaves' dtypes,
    as numpy (ml_dtypes' bfloat16 where the leaf is)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda w: (scale * rng.standard_normal((k,) + w.shape)).astype(
            w.dtype), np_params)


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------

def test_delta_forms_match_the_reference():
    rng = np.random.default_rng(0)
    x, w, dw = (rng.standard_normal(s).astype(np.float32)
                for s in ((3, 5, 8), (8, 6), (8, 6)))
    for d in (None, dw):
        want = jlayers.delta_einsum("bsd,df->bsf", x, w, d)
        got = layers.delta_einsum("bsd,df->bsf", torch.as_tensor(x),
                                  torch.as_tensor(w),
                                  None if d is None else torch.as_tensor(d))
        _close(got, want, TOL["float32"])
        _close(layers.eff(torch.as_tensor(w),
                          None if d is None else torch.as_tensor(d)),
               jlayers.eff(w, d), TOL["float32"])
    tree = {"a": torch.ones(2)}
    assert layers.dget(None, "a") is None
    assert layers.dget(tree, "a") is tree["a"]
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         (("w_gate", (8, 16)), ("w_up", (8, 16)), ("w_down", (16, 8)))}
    dp = {k: 0.1 * v for k, v in p.items()}
    t = lambda tr: {k: torch.as_tensor(v) for k, v in tr.items()}
    for d in (None, dp):
        _close(layers.mlp_forward(t(p), torch.as_tensor(x),
                                  None if d is None else t(d)),
               jlayers.mlp_forward(p, x, d), TOL["float32"])


SDPA_CASES = {
    "causal": dict(S=16, Sk=16, causal=True, window=0, q_offset=0,
                   chunk=512),
    "window": dict(S=16, Sk=16, causal=True, window=5, q_offset=0,
                   chunk=512),
    "chunked": dict(S=32, Sk=32, causal=True, window=7, q_offset=0,
                    chunk=8),
    "noncausal": dict(S=8, Sk=12, causal=False, window=0, q_offset=4,
                      chunk=512),
    # the first two query rows see no key: _sdpa averages V uniformly there
    "masked_rows": dict(S=8, Sk=8, causal=True, window=0, q_offset=-2,
                        chunk=4),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SDPA_CASES))
def test_sdpa_matches_the_reference(name, dtype):
    c = SDPA_CASES[name]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, c["S"], 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, c["Sk"], 2, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=c["causal"], window=c["window"], q_offset=c["q_offset"],
              chunk=c["chunk"])
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jattn._sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)), **kw)
    got = attention._sdpa(*(torch.as_tensor(a).to(tdt) for a in (q, k, v)),
                          **kw)
    assert got.dtype == tdt and got.shape == q.shape
    _close(got, np.asarray(want, np.float32), TOL[dtype])
    if name == "masked_rows":
        mean_v = v.mean(axis=1)                       # [B, Kv, hd]
        row = got[:, 0].float().numpy().reshape(2, 2, 2, 16)
        _close(row, np.broadcast_to(mean_v[:, :, None], row.shape),
               TOL[dtype])


# ---------------------------------------------------------------------------
# transformer.loss_fn and the event-batched loss
# ---------------------------------------------------------------------------

LOSS_CASES = [("float32", False, 0), ("float32", True, 0),
              ("float32", False, 4), ("float32", True, 4),
              ("bfloat16", False, 0), ("bfloat16", True, 0)]


@pytest.mark.parametrize("dtype,with_deltas,chunk", LOSS_CASES)
def test_loss_and_every_gradient_match_the_reference(tiny, dtype,
                                                     with_deltas, chunk):
    """`loss_fn` value, CE and every leaf's gradient, through `_ce_dense`
    (chunk 0) or `_ce_chunked` (chunks of 4 of the 16 positions).

    In bfloat16 each leaf's gradient is held to BF16_GRAD_ULPS bf16 ulps
    (2^-7) of that leaf's largest reference entry, not to an absolute
    tolerance: the tiny LM's leaves have max|g| from 2.5e-3 (a norm scale
    under `deltas`) to 0.22 (the embedding), so atol 5e-2 would pass a zero
    gradient.  The worst leaf is 4.4 ulps off (the same norm scale).  The
    loss and CE are held to one bf16 rounding (rtol 2^-7)."""
    lm = tiny[dtype]
    jcfg = dataclasses.replace(lm.jcfg, loss_chunk=chunk)
    cfg = dataclasses.replace(lm.cfg, loss_chunk=chunk)
    np_d = (jax.tree.map(lambda a: a[0], _deltas(lm.np_params, 1, 0.02, 3))
            if with_deltas else None)
    jb = {"tokens": jnp.asarray(lm.tok[:4]), "targets": jnp.asarray(lm.tgt[:4])}
    tok, tgt = lm.batch(0, 4)

    def j_f(p):
        return j_loss_fn(p, jcfg, jb, deltas=np_d)
    (jl, jm), jg = jax.jit(jax.value_and_grad(j_f, has_aux=True))(lm.jparams)

    d = None if np_d is None else lm_params_from_numpy(np_d, "cpu")
    g, (loss, m) = torch.func.grad_and_value(
        lambda p: transformer.loss_fn(p, cfg, {"tokens": tok, "targets": tgt},
                                      deltas=d), has_aux=True)(lm.params())
    tol = TOL[dtype] if dtype == "float32" else dict(rtol=BF16_ULP, atol=0)
    _close(loss, jl, tol, "loss")
    _close(m["ce"], jm["ce"], tol, "ce")
    assert float(m["moe_aux"]) == 0.0
    got, want = leaves(g), jax.tree.leaves(jg)
    assert len(got) == len(want) == N_LEAVES
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == getattr(torch, dtype) and a.shape == b.shape
        assert bool(torch.isfinite(a).all()) and bool((a != 0).any()), i
        b = np.asarray(b, np.float32)
        if dtype == "float32":
            _close(a, b, tol, f"grad leaf {i}")
        else:
            _within_ulps_of_max(a, b, BF16_GRAD_ULPS, f"grad leaf {i}")


def test_chunked_and_dense_ce_agree(tiny):
    lm = tiny["float32"]
    tok, tgt = lm.batch(0, 4)
    p = lm.params()
    x, pos = transformer._embed_inputs(p, lm.cfg, {"tokens": tok})
    x, _ = transformer._run_stack(p, lm.cfg, x, pos)
    x = transformer._final_norm(p, lm.cfg, x)
    dense = transformer._ce_dense(p, lm.cfg, x, tgt)
    for c in (2, 8):
        chunked = transformer._ce_chunked(
            p, dataclasses.replace(lm.cfg, loss_chunk=c), x, tgt)
        _close(chunked, float(dense), dict(rtol=1e-6, atol=0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_event_batched_matches_per_event_loss_and_the_reference(tiny, dtype):
    """`make_lm_loss(cfg).event_batched(W, δ, x, y)[k]` against the port's
    loss at W + δ_k and against the reference's event-batched loss."""
    lm = tiny[dtype]
    K, B = 3, 2
    np_d = _deltas(lm.np_params, K, 0.02, 5)
    x = lm.tok[:K * B].reshape(K, B, SEQ)
    y = lm.tgt[:K * B].reshape(K, B, SEQ)
    loss = make_lm_loss(lm.cfg)
    W, d = lm.params(), lm_params_from_numpy(np_d, "cpu")
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    got = loss.event_batched(W, d, tx, ty)
    assert got.shape == (K,)
    per_event = torch.stack([
        loss(tree_map(lambda w, dd: (w + dd[k]).to(w.dtype), W, d), tx[k],
             ty[k]) for k in range(K)])
    _close(got, per_event.detach().float().numpy(), TOL[dtype])
    want = j_make_lm_loss(lm.jcfg).event_batched(lm.jparams, np_d, x, y)
    _close(got, np.asarray(want, np.float32), TOL[dtype])


def test_event_batched_gradient_reaches_every_leaf(tiny):
    """The cotangent contraction's dL/dW on the shared W: every leaf gets a
    finite gradient of its own shape, equal to the reference's."""
    lm = tiny["float32"]
    np_d = jax.tree.map(lambda w: np.zeros((2,) + w.shape, w.dtype),
                        lm.np_params)
    x = lm.tok[:4].reshape(2, 2, SEQ)
    y = lm.tgt[:4].reshape(2, 2, SEQ)
    jl = j_make_lm_loss(lm.jcfg)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jl.event_batched(
        p, np_d, x, y))))(lm.jparams)
    loss = make_lm_loss(lm.cfg)
    d = lm_params_from_numpy(np_d, "cpu")
    g = torch.func.grad(lambda p: loss.event_batched(
        p, d, torch.as_tensor(x), torch.as_tensor(y)).sum())(lm.params())
    for i, (a, b) in enumerate(zip(leaves(g), jax.tree.leaves(jg))):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        _close(a, b, TOL["float32"], f"leaf {i}")
    assert engine.resolve_event_batched_loss(loss) is loss.event_batched


def test_training_never_reaches_the_flash_kernel(tiny, monkeypatch):
    lm = tiny["float32"]

    def refuse(*a, **kw):
        raise AssertionError("ops.attention on the training path")
    monkeypatch.setattr(ops, "attention", refuse)
    tok, tgt = lm.batch(0, 2)
    g = torch.func.grad(make_lm_loss(lm.cfg))(lm.params(), tok, tgt)
    assert len(leaves(g)) == N_LEAVES


def test_remat_raises(tiny):
    """`remat=True` no longer raises: the loss and every gradient equal
    those without it, bitwise (tests/test_torch_remat.py holds the
    families)."""
    lm = tiny["float32"]
    tok, tgt = lm.batch(0, 2)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(lm.cfg, remat=remat)
        out[remat] = torch.func.grad_and_value(
            lambda p: transformer.loss_fn(
                p, cfg, {"tokens": tok, "targets": tgt})[0])(lm.params())
    (g0, l0), (g1, l1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))


def test_eval_fn_is_the_held_out_ce(tiny):
    lm = tiny["float32"]
    tok, tgt = lm.batch(0, 16)
    got = make_eval_fn(lm.cfg, tok, tgt)(lm.params())
    _, m = j_loss_fn(lm.jparams, lm.jcfg, {"tokens": lm.tok[:16],
                                           "targets": lm.tgt[:16]})
    _close(got, m["ce"], TOL["float32"])


# ---------------------------------------------------------------------------
# FRED on the LM
# ---------------------------------------------------------------------------

STEPS, EVAL_EVERY = 16, 8
SIM = dict(num_clients=4, batch_size=4, seed=3)
FRED_CASES = {
    "serial_fasgd_kernel": dict(server=dict(rule="fasgd",
                                            use_fused_kernel=True)),
    "fused_materialized_fasgd_kernel": dict(
        server=dict(rule="fasgd", use_fused_kernel=True),
        sim=dict(events_per_step=4, apply_mode="fused",
                 fused_mode="materialized")),
    "fused_cotangent_asgd": dict(
        server=dict(rule="asgd"),
        sim=dict(events_per_step=4, apply_mode="fused",
                 fused_mode="cotangent")),
    "per_tensor_skip_fused": dict(
        server=dict(rule="fasgd"),
        sim=dict(apply_mode="fused"),
        bandwidth=dict(c_push=0.5, c_fetch=0.5, per_tensor_push=True,
                       per_tensor_fetch=True, drop_policy="skip")),
    "queued_cotangent_asgd": dict(
        server=dict(rule="asgd"),
        sim=dict(events_per_step=2, apply_mode="fused",
                 fused_mode="cotangent", queue_capacity=8,
                 drain_policy="drain_all")),
}


@pytest.mark.parametrize("name", sorted(FRED_CASES))
def test_fred_on_the_lm_matches_the_reference(tiny, name):
    lm = tiny["float32"]
    case = FRED_CASES[name]
    sim = dict(SIM, **case.get("sim", {}))
    bw = case.get("bandwidth", {})
    srv = dict(lr=0.01, num_clients=4, **case["server"])
    j_loss = j_make_lm_loss(lm.jcfg)
    j_out = j_run_simulation(
        JSimConfig(server=JServerConfig(**srv, kernel_interpret=True),
                   bandwidth=JBandwidthConfig(**bw), **sim),
        j_loss, lm.jparams, jnp.asarray(lm.tok), jnp.asarray(lm.tgt),
        STEPS, eval_every=EVAL_EVERY,
        eval_fn=lambda p: j_loss(p, lm.tok[:16], lm.tgt[:16]),
        collect_step_metrics=True)

    loss = make_lm_loss(lm.cfg)
    ops.reset_launches()
    out = run_simulation(
        SimConfig(server=ServerConfig(**srv), bandwidth=BandwidthConfig(**bw),
                  **sim),
        loss, lm.params(), lm.tok, lm.tgt, STEPS, eval_every=EVAL_EVERY,
        eval_fn=make_eval_fn(lm.cfg, *lm.batch(0, 16)),
        collect_step_metrics=True, device="cpu",
        rng=replay_of(sim, lm.tok.shape[0], STEPS, EVAL_EVERY, bandwidth=bw,
                      n_leaves=N_LEAVES))

    if bw.get("per_tensor_fetch"):
        # the mean of 12 leaves' integer τ: XLA divides by 12 through its
        # reciprocal, PyTorch divides (the per-leaf timestamps are held
        # exactly below)
        np.testing.assert_allclose(out["tau"].numpy(),
                                   np.asarray(j_out["tau"]), rtol=1e-6)
    else:
        np.testing.assert_array_equal(out["tau"].numpy(),
                                      np.asarray(j_out["tau"]))
    assert_counters_match(out["counters"], j_out["counters"])
    assert out["final_timestamp"] == j_out["final_timestamp"]
    tol = TOL["float32"]
    _close(out["train_loss"], j_out["train_loss"], tol, "train_loss")
    _close(out["val_cost"], j_out["val_cost"], tol, "val_cost")
    st, j_st = out["state"], j_out["state"]
    for field in ("params", "n", "b", "v"):
        got = leaves(to_numpy(getattr(st.server, field)))
        want = jax.tree.leaves(getattr(j_st.server, field))
        assert len(got) == len(want) == N_LEAVES, field
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, tol, f"{field} leaf {i}")
    for i, (a, b) in enumerate(zip(leaves(to_numpy(st.client_params)),
                                   jax.tree.leaves(j_st.client_params))):
        _close(a, b, tol, f"client_params leaf {i}")
    np.testing.assert_array_equal(st.client_ts.numpy(),
                                  np.asarray(j_st.client_ts))
    if j_st.client_leaf_ts is not None:
        np.testing.assert_array_equal(st.client_leaf_ts.numpy(),
                                      np.asarray(j_st.client_leaf_ts))
        leaf_ts = st.client_leaf_ts.numpy()
        assert (leaf_ts.max(axis=1) != leaf_ts.min(axis=1)).any()
    if j_st.queue is not None:
        for field in ("head", "size", "ts", "client", "enq_T"):
            np.testing.assert_array_equal(
                getattr(st.queue, field).numpy(),
                np.asarray(getattr(j_st.queue, field)), err_msg=field)
        assert out["counters"]["queue_drained"] > 0
    launches = ops.LAUNCHES["fasgd_update"] + ops.LAUNCHES["fused_event_apply"]
    assert launches == out["counters"].get("kernel_launches", 0.0)
    if srv.get("use_fused_kernel"):
        assert launches == N_LEAVES * (STEPS // sim.get("events_per_step", 1)
                                       if sim.get("apply_mode") == "fused"
                                       else STEPS)


# ---------------------------------------------------------------------------
# the round trainer on the LM
# ---------------------------------------------------------------------------

C, MU, ROUNDS = 4, 2, 3
# `examples/train_lm_fasgd.py`'s operating point, which `chip_smoke.py`
# phase 15 (b) runs at tinyllama-1.1b's width in bf16
EXAMPLE_POINT = dict(rule="fasgd", lr=0.01, c_fetch=0.5,
                     use_fused_kernel=True)
ROUND_CASES = {
    "serial_fasgd_kernel": ("serial", EXAMPLE_POINT, "float32"),
    "fused_fasgd_kernel": ("fused", EXAMPLE_POINT, "float32"),
    "fused_cotangent_asgd": ("fused", dict(rule="asgd", lr=0.01,
                                           drop_policy="discard",
                                           fused_mode="cotangent"),
                             "float32"),
    "serial_fasgd_kernel_bf16": ("serial", EXAMPLE_POINT, "bfloat16"),
    "fused_fasgd_kernel_bf16": ("fused", EXAMPLE_POINT, "bfloat16"),
}
# bf16: rounds run, the held-out batch (pool rows the rounds do not read),
# the tolerance on losses and CE (a sixteenth of a bf16 ulp at CE ≈ 4.9;
# each curve moves by ~1e-2 over the rounds) and on the float state
BF16_ROUNDS, HELD_OUT = 12, slice(96, 128)
CE_ATOL = 2e-3
BF16_STATE_ULPS = 8


def _round_pair(lm, mode, kw, rounds=ROUNDS):
    """(port state and step, reference state and step, batches, draws) of
    one configuration on the tiny LM."""
    j_loss = j_make_lm_loss(lm.jcfg)
    j_step = jax.jit(jrt.build_round_step(
        JTrainerConfig(num_round_clients=C, kernel_interpret=True, **kw),
        lambda p, b: jax.value_and_grad(j_loss)(p, b[0], b[1]),
        apply_mode=mode,
        batched_loss_fn=lambda W, d, b: j_loss.event_batched(W, d, *b)))
    loss = make_lm_loss(lm.cfg)
    tc = TrainerConfig(num_round_clients=C, **kw)
    step = rt.build_round_step(
        tc, rt.make_grad_fn(loss), apply_mode=mode,
        batched_loss_fn=lambda W, d, b: loss.event_batched(W, d, *b))
    keys = [jax.random.PRNGKey(100 + r) for r in range(rounds)]
    n = C * MU
    batches = [(lm.tok[r * n:(r + 1) * n].reshape(C, MU, SEQ),
                lm.tgt[r * n:(r + 1) * n].reshape(C, MU, SEQ))
               for r in range(rounds)]
    return (rt.init_round_state(tc, lm.params(), device="cpu"), step,
            jrt.init_round_state(JTrainerConfig(num_round_clients=C, **kw),
                                 lm.jparams),
            j_step, batches, keys, round_replay(keys, C, False, False))


@pytest.mark.parametrize("name", sorted(ROUND_CASES))
def test_round_trainer_on_the_lm_matches_the_reference(tiny, name):
    mode, kw, dtype = ROUND_CASES[name]
    if dtype == "bfloat16":
        return _bf16_rounds_match(tiny[dtype], mode, kw)
    state, step, j_state, j_step, batches, keys, draws = _round_pair(
        tiny["float32"], mode, kw)
    with CountCotangent() as calls:
        for r in range(ROUNDS):
            j_state, j_m = j_step(j_state, tuple(map(jnp.asarray,
                                                     batches[r])), keys[r])
            state, m = step(state, tuple(map(torch.as_tensor, batches[r])),
                            draws.round(r))
            compare_metrics(m, j_m)
    compare_states(state, j_state)
    assert calls["n"] == (ROUNDS if kw.get("fused_mode") == "cotangent"
                          else 0)


def _bf16_rounds_match(lm, mode, kw):
    """BF16_ROUNDS rounds in bf16 through both packages: the held-out CE
    after every round and each round's losses within CE_ATOL, the integer
    state and counters exactly, θ, n, b, v and the client copies within
    BF16_STATE_ULPS bf16 ulps of each leaf's largest entry (the packages
    round the bf16 statistics at different points, so most n and b entries
    differ in their last bit)."""
    state, step, j_state, j_step, batches, keys, draws = _round_pair(
        lm, mode, kw, BF16_ROUNDS)
    vt, vg = lm.tok[HELD_OUT], lm.tgt[HELD_OUT]
    j_eval = j_make_eval_fn(lm.jcfg, jnp.asarray(vt), jnp.asarray(vg))
    t_eval = make_eval_fn(lm.cfg, torch.as_tensor(vt), torch.as_tensor(vg))
    curve, j_curve = [], []
    for r in range(BF16_ROUNDS):
        j_state, j_m = j_step(j_state, tuple(map(jnp.asarray, batches[r])),
                              keys[r])
        state, m = step(state, tuple(map(torch.as_tensor, batches[r])),
                        draws.round(r))
        assert sorted(m) == sorted(j_m)
        for k, w in j_m.items():
            w = np.asarray(w)
            if k.startswith("loss"):
                _close(m[k], w, dict(rtol=0, atol=CE_ATOL), k)
            else:
                np.testing.assert_array_equal(m[k].numpy(), w, err_msg=k)
        curve.append(float(t_eval(state.server.params)))
        j_curve.append(float(j_eval(j_state.server.params)))
    _close(np.array(curve), np.array(j_curve), dict(rtol=0, atol=CE_ATOL),
           "held-out CE")
    for what, got, want in (
            ("θ", state.server.params, j_state.server.params),
            ("n", state.server.n, j_state.server.n),
            ("b", state.server.b, j_state.server.b),
            ("v", state.server.v, j_state.server.v),
            ("client copies", state.client_params, j_state.client_params)):
        for i, (a, b) in enumerate(zip(leaves(got), jax.tree.leaves(want))):
            assert a.dtype == torch.bfloat16
            _within_ulps_of_max(a, np.asarray(b, np.float32),
                                BF16_STATE_ULPS, f"{what} leaf {i}")
    assert int(state.server.timestamp) == int(j_state.server.timestamp)
    for field in ("client_ts", "round_idx"):
        np.testing.assert_array_equal(getattr(state, field).numpy(),
                                      np.asarray(getattr(j_state, field)))
    j_c = j_state.counters._asdict()
    for k, v in state.counters._asdict().items():
        if k != "wall_clock":
            assert float(v) == float(j_c[k]), k


def test_round_trainer_cotangent_matches_materialized_on_the_lm(tiny):
    """The port's two fused reductions of each round on the LM."""
    finals = {}
    for fm in ("materialized", "cotangent"):
        state, step, *_, batches, _, draws = _round_pair(
            tiny["float32"], "fused", dict(rule="asgd", lr=0.01,
                                           drop_policy="discard",
                                           fused_mode=fm))
        for r in range(ROUNDS):
            state, m = step(state, tuple(map(torch.as_tensor, batches[r])),
                            draws.round(r))
            assert bool(torch.isfinite(m["loss"]))
        finals[fm] = state
    for a, b in zip(leaves(finals["cotangent"].server.params),
                    leaves(finals["materialized"].server.params)):
        _close(a, b.detach().numpy(), TOL["float32"])
    assert int(finals["cotangent"].server.timestamp) == int(
        finals["materialized"].server.timestamp) == C * ROUNDS


class CountCotangent:
    """Counts `engine.fused_apply_cotangent` calls while active."""

    def __enter__(self):
        self.fn, self.calls = engine.fused_apply_cotangent, {"n": 0}

        def counted(*a, **kw):
            self.calls["n"] += 1
            return self.fn(*a, **kw)
        engine.fused_apply_cotangent = counted
        return self.calls

    def __exit__(self, *exc):
        engine.fused_apply_cotangent = self.fn


# ---------------------------------------------------------------------------
# data/tokens.py
# ---------------------------------------------------------------------------

def test_token_batches_follow_the_chain():
    cfg = tok_mod.TokenDataConfig(vocab_size=64, seq_len=12, batch_size=32,
                                  seed=1)
    tok, tgt = tok_mod.make_batch(cfg, 0, device="cpu")
    assert tok.shape == tgt.shape == (32, 12)
    assert tok.dtype == tgt.dtype == torch.int64
    assert bool(((tok >= 0) & (tok < 64)).all())
    assert torch.equal(tok[:, 1:], tgt[:, :-1])
    again = tok_mod.make_batch(cfg, 0, device="cpu")
    assert torch.equal(tok, again[0]) and torch.equal(tgt, again[1])
    assert not torch.equal(tok, tok_mod.make_batch(cfg, 1, device="cpu")[0])
    other = dataclasses.replace(cfg, seed=2)
    assert not torch.equal(tok, tok_mod.make_batch(other, 0, device="cpu")[0])
    stream = tok_mod.synthetic_token_batches(cfg, device="cpu")
    for step in range(2):
        assert torch.equal(next(stream)[0],
                           tok_mod.make_batch(cfg, step, device="cpu")[0])
    # near zero temperature the chain follows its most likely transition
    cold = dataclasses.replace(cfg, temperature=1e-5)
    tok, tgt = tok_mod.make_batch(cold, 0, device="cpu")
    emb, dec = tok_mod._chain_params(cold, "cpu")
    assert float((tgt == (emb[tok] @ dec).argmax(-1)).float().mean()) > 0.99
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tok_mod.make_batch(cfg, 0)


# ---------------------------------------------------------------------------
# tests/test_lm_properties.py, on the port
# ---------------------------------------------------------------------------

PROP_SEQ, PROP_B = 8, 2
_prop = {}


def _prop_setup(dtype):
    if dtype not in _prop:
        cfg = get_smoke_config(
            "tinyllama-1.1b", num_layers=1, d_model=32, num_heads=2,
            num_kv_heads=1, d_ff=64, vocab_size=128, head_dim=16,
            param_dtype=dtype)
        W = transformer.init_model(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
        tok, tgt = tok_mod.make_batch(tok_mod.TokenDataConfig(
            vocab_size=128, seq_len=PROP_SEQ, batch_size=64,
            temperature=0.5), 0, device="cpu")
        _prop[dtype] = (make_lm_loss(cfg), W, tok, tgt)
    return _prop[dtype]


def _prop_deltas(W, groups, scale, seed):
    """[K, ...] offsets where events of one group carry identical ones."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.tensor(groups)
    return tree_map(lambda w: (scale * torch.randn(
        (max(groups) + 1,) + tuple(w.shape), generator=g)).to(w.dtype)[idx],
        W)


@settings(max_examples=15, deadline=None)
@given(dtype=st.sampled_from(["float32", "bfloat16"]),
       groups=st.lists(st.integers(0, 3), min_size=1, max_size=5).map(
           lambda g: [x % (max(g) + 1) for x in g]),
       scale=st.sampled_from([0.0, 1e-3, 5e-2]),
       shared_batch=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_event_batched_equals_vmapped_per_event(dtype, groups, scale,
                                                shared_batch, seed):
    loss, W, tok, tgt = _prop_setup(dtype)
    K = len(groups)
    deltas = _prop_deltas(W, groups, scale, seed)
    if shared_batch:
        x = tok[:PROP_B].expand(K, PROP_B, PROP_SEQ)
        y = tgt[:PROP_B].expand(K, PROP_B, PROP_SEQ)
    else:
        x = tok[:K * PROP_B].reshape(K, PROP_B, PROP_SEQ)
        y = tgt[:K * PROP_B].reshape(K, PROP_B, PROP_SEQ)
    got = loss.event_batched(W, deltas, x, y)
    eff = tree_map(lambda w, d: (w + d).to(w.dtype), W, deltas)
    want = torch.func.vmap(loss)(eff, x, y)
    assert got.shape == (K,)
    _close(got, want.double().numpy(), TOL[dtype])
    if shared_batch:
        # identical (δ, batch) cells land on identical losses, bitwise
        g = np.asarray(groups)
        for gid in np.unique(g):
            members = got.detach()[torch.as_tensor(g == gid)]
            assert bool((members == members[0]).all())


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_zero_delta_matches_plain_loss(seed):
    loss, W, tok, tgt = _prop_setup("float32")
    deltas = tree_map(lambda w: torch.zeros((2,) + tuple(w.shape),
                                            dtype=w.dtype), W)
    i = int(np.random.default_rng(seed).integers(0, 32))
    x = torch.stack([tok[i:i + PROP_B]] * 2)
    y = torch.stack([tgt[i:i + PROP_B]] * 2)
    got = loss.event_batched(W, deltas, x, y)
    want = loss(W, x[0], y[0])
    _close(got, np.full(2, float(want)), dict(rtol=1e-6, atol=0))


# ---------------------------------------------------------------------------
# ops.attention refuses to train on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card_branch(monkeypatch):
    """`ops.attention` as on the card: the CUDA branch taken for CPU
    tensors, its launch replaced by a recorder."""
    launched = []
    monkeypatch.setattr(ops, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(ops, "_attention_cuda",
                        lambda q, *a: launched.append(1) or q.clone())
    return launched


def _qkv(requires_grad=False):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(s, generator=g).requires_grad_(requires_grad)
            for s in ((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16))]


@pytest.mark.parametrize("how", ["requires_grad", "vmap", "grad"])
def test_flash_kernel_refuses_training_inputs(card_branch, how):
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="_sdpa"):
        if how == "requires_grad":
            ops.attention(*_qkv(requires_grad=True))
        elif how == "vmap":
            q, k, v = _qkv()
            torch.func.vmap(lambda a: ops.attention(a, k, v))(
                q.expand(3, *q.shape))
        else:
            q, k, v = _qkv()
            torch.func.grad(lambda a: ops.attention(a, k, v).sum())(q)
    assert card_branch == []
    assert ops.LAUNCHES["flash_attention"] == 0
    assert ops.DEVICE_LAUNCHES["flash_attention"] == 0


def test_flash_kernel_still_serves(card_branch):
    """Serving has no input that requires grad: the kernel launches, and so
    it does for such an input with autograd off."""
    ops.reset_launches()
    ops.attention(*_qkv())
    with torch.no_grad():
        ops.attention(*_qkv(requires_grad=True))
    assert card_branch == [1, 1]
    assert ops.LAUNCHES["flash_attention"] == 2
