"""The port's MoE family against a live run of the JAX reference.

The SMOKE configs of grok-1-314b (GQA, 8 q heads of 32 over 2 kv heads,
4 experts of width 512, top-2: 2 layers, d_model 256, vocab 512) and
deepseek-v2-236b (MLA with a 64-wide latent and the 64-wide rope key, 8
heads of 32, 4 routed experts of width 128, top-2, one shared expert: 2
layers, d_model 256, vocab 512) run through both packages from the same
weights (the JAX package's init, through numpy and
`lm_params_from_numpy`) on the same token batches (numpy, seeded):
`moe_forward` alone (the routing first, then the values), the overflow
path, `forward`, `loss_fn` (value, CE, `moe_aux` and every leaf's
gradient, the router's included, with and without `deltas`), `prefill`
and four `decode_step`s (from a full cache and from a 16-slot ring),
`make_lm_loss(cfg).event_batched`, and the round
trainer (serial and fused, the server-update kernels' slots on: their
plain versions on the CPU) on the reference's `launch/train.py`
gradient, with the round draws replayed.  Then the reference's own specs,
run on the port.

The routing (each token's experts and each (token, slot) pair's place in
its expert's buffer, the overflow slot included) is asserted equal before
any value is compared: a token routed otherwise moves its output by far
more than a rounding, and `torch.topk` orders exact ties otherwise than
`jax.lax.top_k`.

In bfloat16 the two frameworks round at different places (XLA's jit keeps
some fused intermediates in float32, such as the folded W + δ of the MoE
and MLA weights, where PyTorch and the reference run op by op round each
op's output), and a token whose router probabilities nearly tie can then
take another expert: the reference itself routes such a token otherwise
when it is compiled with XLA's ``xla_allow_excess_precision`` off (every
bf16 op rounding its output, as run op by op) than with it on (the
default).  So the bfloat16 model checks record every layer's routing in
both packages and hold the port against the reference, compiled either
way, that routes every token as the port does; the test fails if neither
does.  Float32 is held against the default compilation alone.

Tolerances, as `tests/test_torch_audio_vlm.py` states them:
- float32: logits and caches rtol/atol 1e-5; an MoE layer's output y
  within 1e-5 of its largest reference entry (plus rtol 1e-5): at the
  reference's expert scale (1/√E) y runs to ~10³, a sum of products of
  that size, where entries near 0 carry the terms' rounding; losses and
  gradients rtol 1e-4 / atol 1e-5; the round trainer's state as
  `test_torch_round_trainer.compare_states` holds it (rtol 1e-4 / atol
  1e-5, integers and counters exactly).
- bfloat16: logits (the padded columns aside, which are −1e30 in both),
  outputs, caches and each leaf's gradient within 8 bf16 ulps of the
  largest reference entry of that tensor; losses within one bf16 rounding
  (rtol 2⁻⁷).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.configs.base import TrainerConfig as JTrainerConfig
from repro.core import round_trainer as jrt
import repro.models.moe as j_moe
from repro.models.lm import make_lm_loss as j_make_lm_loss
from repro.models.moe import moe_forward as j_moe_forward
from repro.models.serving import decode_step as j_decode_step
from repro.models.serving import prefill as j_prefill
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_model as j_init_model
from repro.models.transformer import loss_fn as j_loss_fn

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainerConfig
from repro_torch.core import round_trainer as rt
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import moe
from repro_torch.models.api import make_batch, make_dict_grad_fn, param_count
from repro_torch.models.lm import make_lm_loss
from repro_torch.models.serving import (decode_step, grow_cache, init_cache,
                                        prefill)
from repro_torch.models.transformer import forward, init_model, loss_fn
from repro_torch.utils.convert import (lm_params_from_numpy,
                                       lm_params_to_numpy)
from repro_torch.utils.trees import leaves, tree_map

from test_torch_audio_vlm import (BF16_ULP, BF16_ULPS, F32, F32_GRAD,
                                  _close, _deltas, _j_grad_fn,
                                  _within_ulps_of_max)
from test_torch_fred import one_thread  # noqa: F401
from test_torch_lm_serving import _np32, _ring
from test_torch_round_trainer import (compare_metrics, compare_states,
                                      round_replay)

GROK, DSV2 = "grok-1-314b", "deepseek-v2-236b"
NAMES = [GROK, DSV2]
B, S, N_DEC = 2, 32, 4


def numpy_tokens(cfg, batch, seq, seed, lead=()):
    """{tokens, targets} [*lead, batch, seq] uniform over the vocabulary,
    int64, from `seed`."""
    rng = np.random.default_rng(seed)
    shape = lead + (batch, seq)
    return {"tokens": rng.integers(0, cfg.vocab_size, shape),
            "targets": rng.integers(0, cfg.vocab_size, shape)}


class Family:
    """One MoE config in both packages: the reference's weights and a
    numpy token batch."""

    def __init__(self, name, dtype, seed=1):
        self.jcfg = j_get_smoke_config(name, param_dtype=dtype)
        self.cfg = get_smoke_config(name, param_dtype=dtype)
        self.jparams = j_init_model(jax.random.PRNGKey(0), self.jcfg)
        self.np_params = jax.tree.map(np.asarray, self.jparams)
        self.np_batch = numpy_tokens(self.cfg, B, S, seed)

    def params(self):
        return lm_params_from_numpy(self.np_params, device="cpu")

    def jbatch(self, np_batch=None):
        np_batch = self.np_batch if np_batch is None else np_batch
        return {k: jnp.asarray(v, jnp.int32) for k, v in np_batch.items()}

    def batch(self, np_batch=None):
        np_batch = self.np_batch if np_batch is None else np_batch
        return {k: torch.from_numpy(v) for k, v in np_batch.items()}


@functools.lru_cache(maxsize=None)
def family(name, dtype):
    """One `Family` per config and dtype for the module (the tests read
    it and never write it)."""
    return Family(name, dtype)


def j_routing(p, jcfg, x, capacity_factor=1.25):
    """The reference's routing of x [B, S, d], as `repro.models.moe.
    moe_forward` computes it (its own lines): (ids [T, k], slots [T, k],
    gates [T, k], cap)."""
    B_, S_, d = x.shape
    E, k = jcfg.num_experts, jcfg.num_experts_per_tok
    T = B_ * S_
    xf = x.reshape(T, d)
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32),
                        p["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gates, ids = jax.lax.top_k(probs, k)
    gates = gates / jnp.sum(gates, axis=-1, keepdims=True)
    cap = int((T * k + E - 1) // E * capacity_factor)
    cap = max(128, -(-cap // 128) * 128)
    eid_flat = ids.reshape(T * k)
    order = jnp.argsort(eid_flat)
    sorted_eid = eid_flat[order]
    counts = jnp.bincount(eid_flat, length=E)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(T * k) - starts[sorted_eid]
    slot = jnp.where(rank < cap, rank, cap)
    slot_of_flat = jnp.zeros((T * k,), jnp.int32).at[order].set(
        slot.astype(jnp.int32))
    return (np.asarray(ids), np.asarray(slot_of_flat.reshape(T, k)),
            np.asarray(gates), cap)


@contextlib.contextmanager
def j_routes():
    """Record the expert ids [T, k] of every MoE layer the reference runs
    inside the block (jitted or not: `jax.debug.callback`), into the
    yielded list.  Wraps `repro.models.moe.moe_forward` in this process
    (a function traced inside the block keeps the wrapper)."""
    got, real = [], j_moe.moe_forward

    def recording(p, cfg, x, capacity_factor=1.25, dp=None):
        pp = p if dp is None else jax.tree.map(lambda w, dl: w + dl, p, dp)
        logits = jnp.einsum("td,de->te",
                            x.reshape(-1, x.shape[-1]).astype(jnp.float32),
                            pp["router"].astype(jnp.float32))
        ids = jax.lax.top_k(logits, cfg.num_experts_per_tok)[1]
        jax.debug.callback(lambda i: got.append(np.sort(np.asarray(i), 1)),
                           ids)
        return real(p, cfg, x, capacity_factor, dp)
    j_moe.moe_forward = recording
    try:
        yield got
    finally:
        j_moe.moe_forward = real


@contextlib.contextmanager
def t_routes():
    """Record the expert ids of every MoE layer the port runs inside the
    block (outside `torch.func` transforms), into the yielded list."""
    got, real = [], moe.route

    def recording(*a, **kw):
        r = real(*a, **kw)
        got.append(np.sort(r["ids"].numpy(), 1))
        return r
    moe.route = recording
    try:
        yield got
    finally:
        moe.route = real


def flipped(j_ids, t_ids):
    """Tokens routed to another set of experts, summed over the layers."""
    assert len(j_ids) == len(t_ids) > 0
    return sum(int((a != b).any(1).sum()) for a, b in zip(j_ids, t_ids))


def _layer0_moe(np_params):
    return jax.tree.map(lambda a: a[0], np_params["layers"]["moe"])


def _moe_case(name, dtype, seq, capacity_factor, seed):
    """The reference's and the port's routing and outputs of one MoE layer
    (layer 0 of the reference's init) on a seeded normal x [B, seq, d]."""
    fam = family(name, dtype)
    np_p = _layer0_moe(fam.np_params)
    x = np.random.default_rng(seed).standard_normal(
        (B, seq, fam.cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, fam.jcfg.dtype)
    jp = jax.tree.map(jnp.asarray, np_p)
    want_y, want_aux = jax.jit(lambda p, xx: j_moe_forward(
        p, fam.jcfg, xx, capacity_factor=capacity_factor))(jp, jx)
    ids, slots, gates, cap = j_routing(jp, fam.jcfg, jx, capacity_factor)
    p = lm_params_from_numpy({**fam.np_params, "layers": {
        **fam.np_params["layers"], "moe": np_p}}, "cpu")["layers"]["moe"]
    tx = torch.from_numpy(x).to(fam.cfg.dtype)
    r = moe.route(p, fam.cfg, tx.reshape(-1, fam.cfg.d_model),
                  capacity_factor)
    y, aux = moe.moe_forward(p, fam.cfg, tx, capacity_factor=capacity_factor)
    return fam, (ids, slots, gates, cap, want_y, want_aux), (r, y, aux)


def _close_y(got, want, dtype):
    """An MoE output: float32 within 1e-5 · max|want| + 1e-5 · |want|;
    bfloat16 within 8 bf16 ulps of max|want|."""
    if dtype == "bfloat16":
        _within_ulps_of_max(got, _np32(want), BF16_ULPS, "y")
        return
    got, want = _np32(got), _np32(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg="y")


def _routing_equal(want, r):
    ids, slots, gates, cap = want[:4]
    assert r["cap"] == cap
    np.testing.assert_array_equal(r["ids"].numpy(), ids)
    np.testing.assert_array_equal(r["slots"].numpy(), slots)
    np.testing.assert_allclose(r["gates"].numpy(), gates, **F32)


# ---------------------------------------------------------------------------
# the MoE layer alone
# ---------------------------------------------------------------------------

MOE_CASES = [(n, dt) for n in NAMES for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("name,dtype", MOE_CASES,
                         ids=[f"{n}-{dt}" for n, dt in MOE_CASES])
def test_moe_forward_routes_then_computes_as_the_reference(name, dtype):
    """Layer 0's MoE on x [2, 32, 256]: the router's experts, gates and
    slots equal the reference's, then y and the aux loss."""
    fam, want, (r, y, aux) = _moe_case(name, dtype, S, 1.25, 7)
    _routing_equal(want, r)
    assert not (r["slots"] == r["cap"]).any()        # nothing drops here
    assert y.shape == (B, S, fam.cfg.d_model) and y.dtype == fam.cfg.dtype
    _close_y(y, want[4], dtype)
    np.testing.assert_allclose(float(aux), float(want[5]), **F32_GRAD)


@pytest.mark.parametrize("name", NAMES)
def test_overflow_drops_the_reference_tokens(name):
    """T = 2 × 256 tokens over 4 experts, top-2, capacity factor 0.25:
    capacity 128 (its floor) against ~256 pairs an expert, so about half
    the pairs overflow; the same pairs overflow as in the reference (their
    slot is the capacity), and the outputs agree, the dropped pairs adding
    nothing in either."""
    fam, want, (r, y, aux) = _moe_case(name, "float32", 256, 0.25, 8)
    _routing_equal(want, r)
    dropped = r["slots"] == r["cap"]
    assert r["cap"] == 128 and 0.25 < float(dropped.float().mean()) < 0.75
    _close_y(y, want[4], "float32")
    np.testing.assert_allclose(float(aux), float(want[5]), **F32_GRAD)


# ---------------------------------------------------------------------------
# forward, loss_fn and every gradient
# ---------------------------------------------------------------------------

LOSS_CASES = [(n, dt, d) for n in NAMES for dt in ("float32", "bfloat16")
              for d in (False, True)]
N_LEAVES = {GROK: 13, DSV2: 20}


def _j_forward_and_grad(fam, jb, jd, exact):
    """The reference's (logits, aux) and ((loss, metrics), grads), jitted
    (with `exact`, compiled with XLA's `xla_allow_excess_precision` off, so
    that every bf16 op rounds its output as it does run op by op), with the
    routing of each of its MoE layers in both runs."""
    opts = {"xla_allow_excess_precision": False} if exact else None

    def run(f, *args):
        return jax.jit(f).lower(*args).compile(compiler_options=opts)(*args)
    with j_routes() as ids:
        out = run(lambda p, b, dd: j_forward(p, fam.jcfg, b, deltas=dd),
                  fam.jparams, jb, jd)
        grad = run(jax.value_and_grad(
            lambda p, b, dd: j_loss_fn(p, fam.jcfg, b, deltas=dd),
            has_aux=True), fam.jparams, jb, jd)
        jax.effects_barrier()
    return out, grad, ids


@pytest.mark.parametrize("name,dtype,with_deltas", LOSS_CASES,
                         ids=[f"{n}-{dt}-{'deltas' if d else 'plain'}"
                              for n, dt, d in LOSS_CASES])
def test_forward_loss_and_every_gradient_match_the_reference(
        name, dtype, with_deltas):
    fam = family(name, dtype)
    np_d = _deltas(fam.np_params, 0.02, 3) if with_deltas else None
    d = None if np_d is None else lm_params_from_numpy(np_d, "cpu")
    jd = None if np_d is None else jax.tree.map(jnp.asarray, np_d)
    jb, tb = fam.jbatch(), fam.batch()
    with t_routes() as t_ids:
        got, aux = forward(fam.params(), fam.cfg, tb, deltas=d)
    L = fam.cfg.num_layers
    (want, want_aux), ((jl, jm), jg), j_ids = _j_forward_and_grad(
        fam, jb, jd, False)
    flips = flipped(j_ids, t_ids * 2)
    if dtype == "float32":
        assert flips == 0
    elif flips:
        # bf16: a near-tie routed otherwise by the jitted reference; the
        # reference rounding every op must route every token as the port
        # does
        (want, want_aux), ((jl, jm), jg), j_ids = _j_forward_and_grad(
            fam, jb, jd, True)
        assert flipped(j_ids, t_ids * 2) == 0, (
            f"{flips} tokens routed otherwise than the jitted reference, "
            f"and some otherwise than the reference rounding every op")
    assert len(t_ids) == L and got.shape == (B, S, fam.cfg.padded_vocab)
    _close(got, want, dtype, fam.cfg.vocab_size, "logits")
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(want_aux), **F32_GRAD)

    g, (loss, m) = torch.func.grad_and_value(
        lambda p: loss_fn(p, fam.cfg, tb, deltas=d), has_aux=True)(
        fam.params())
    tol = F32_GRAD if dtype == "float32" else dict(rtol=BF16_ULP, atol=0)
    np.testing.assert_allclose(float(loss), float(jl), **tol)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), **tol)
    np.testing.assert_allclose(float(m["moe_aux"]), float(jm["moe_aux"]),
                               **F32_GRAD)
    # the aux term is live: the loss is CE + 0.01 · aux
    np.testing.assert_allclose(float(loss),
                               float(m["ce"]) + 0.01 * float(m["moe_aux"]),
                               rtol=1e-6)
    got_g, want_g = leaves(g), jax.tree.leaves(jg)
    assert len(got_g) == len(want_g) == N_LEAVES[name]
    assert float(g["layers"]["moe"]["router"].float().abs().max()) > 0.0
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        assert a.dtype == getattr(torch, dtype) and a.shape == b.shape
        assert bool(torch.isfinite(a).all()) and bool((a != 0).any()), i
        if dtype == "float32":
            np.testing.assert_allclose(_np32(a), _np32(b), err_msg=f"leaf {i}",
                                       **F32_GRAD)
        else:
            _within_ulps_of_max(a, _np32(b), BF16_ULPS, f"leaf {i}")


def test_router_gradient_comes_through_the_gates_and_the_aux_term():
    """The router's gradient has two parts, through the gates (CE) and
    through the aux loss: at aux_weight 0 it is the CE's alone, and the
    difference is the aux term's, as the reference gives both."""
    fam = family(GROK, "float32")
    tb, jb = fam.batch(), fam.jbatch()
    for w in (0.0, 1.0):
        g = torch.func.grad(lambda p: loss_fn(p, fam.cfg, tb,
                                              aux_weight=w)[0])(fam.params())
        jg = jax.jit(jax.grad(lambda p: j_loss_fn(
            p, fam.jcfg, jb, aux_weight=w)[0]))(fam.jparams)
        got = g["layers"]["moe"]["router"]
        want = jg["layers"]["moe"]["router"]
        assert float(got.abs().max()) > 0.0
        np.testing.assert_allclose(_np32(got), _np32(want), **F32_GRAD)
        if w == 0.0:
            ce_only = got
    assert not torch.allclose(got, ce_only)


# ---------------------------------------------------------------------------
# serving: prefill and decode
# ---------------------------------------------------------------------------

SERVE_CASES = [(n, dt) for n in NAMES for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("name,dtype", SERVE_CASES,
                         ids=[f"{n}-{dt}" for n, dt in SERVE_CASES])
def test_prefill_and_decode_match_the_reference(name, dtype):
    """Prefill S − 4 tokens (the cache: GQA's k, v or MLA's c, kr), then
    decode four from the same cache; the MLA prefill attends at head dim
    32 + 64 through `ops.attention`."""
    fam = family(name, dtype)
    S0 = S - N_DEC
    jb, tb = fam.jbatch(), fam.batch()
    jl, jc = jax.jit(lambda p, t: j_prefill(p, fam.jcfg, {"tokens": t}))(
        fam.jparams, jb["tokens"][:, :S0])
    params = fam.params()
    ops.reset_launches()
    tl, tc = prefill(params, fam.cfg, {"tokens": tb["tokens"][:, :S0]})
    assert ops.LAUNCHES["flash_attention"] == fam.cfg.num_layers
    V = fam.cfg.vocab_size
    _close(tl, jl, dtype, V, "prefill logits")
    names = ("c", "kr") if fam.cfg.use_mla else ("k", "v")
    assert sorted(tc) == sorted(jc) == sorted(names)
    for nm in names:
        assert tc[nm].shape == jc[nm].shape
        _close(tc[nm], jc[nm], dtype, what=f"cache {nm}")
    start = {nm: np.concatenate(
        [_np32(c), np.zeros(c.shape[:2] + (N_DEC,) + c.shape[3:],
                            np.float32)], axis=2) for nm, c in jc.items()}
    jcache = {k: jnp.asarray(v, fam.jcfg.dtype) for k, v in start.items()}
    tcache = {k: torch.from_numpy(v).to(fam.cfg.dtype)
              for k, v in start.items()}
    j_step = jax.jit(lambda p, t, c, pos: j_decode_step(p, fam.jcfg, t, c,
                                                        pos))
    for t in range(S0, S):
        jl_t, jcache = j_step(fam.jparams, jb["tokens"][:, t:t + 1], jcache,
                              jnp.int32(t))
        tl_t, tcache = decode_step(params, fam.cfg, tb["tokens"][:, t:t + 1],
                                   tcache, t)
        _close(tl_t, jl_t, dtype, V, f"decode logits at {t}")
    for nm in names:
        _close(tcache[nm], jcache[nm], dtype, what=f"cache {nm} after decode")


@pytest.mark.parametrize("name", NAMES)
def test_windowed_decode_matches_the_reference(name):
    """attn_window 16: prefill S − 4 tokens (the windowed mask through
    `ops.attention`), then decode four from a 16-slot ring holding the
    last 16 positions at slot p % 16 (GQA's k, v or MLA's c, kr), each
    step writing slot pos % 16, as the reference's decode does."""
    W, S0 = 16, S - N_DEC
    jcfg = j_get_smoke_config(name, attn_window=W)
    cfg = get_smoke_config(name, attn_window=W)
    fam = family(name, "float32")
    params = fam.params()
    jb, tb = fam.jbatch(), fam.batch()
    jl, jc = jax.jit(lambda p, t: j_prefill(p, jcfg, {"tokens": t}))(
        fam.jparams, jb["tokens"][:, :S0])
    tl, tc = prefill(params, cfg, {"tokens": tb["tokens"][:, :S0]})
    _close(tl, jl, "float32", cfg.vocab_size, "prefill logits")
    ring = {nm: _ring(_np32(c), S0, W) for nm, c in jc.items()}
    grown = grow_cache(cfg, tc, S)
    for nm in ring:
        np.testing.assert_allclose(_np32(grown[nm]), ring[nm], **F32)
    jcache = {k: jnp.asarray(v) for k, v in ring.items()}
    j_step = jax.jit(lambda p, t, c, pos: j_decode_step(p, jcfg, t, c, pos))
    for t in range(S0, S):
        jl_t, jcache = j_step(fam.jparams, jb["tokens"][:, t:t + 1], jcache,
                              jnp.int32(t))
        tl_t, grown = decode_step(params, cfg, tb["tokens"][:, t:t + 1],
                                  grown, t)
        _close(tl_t, jl_t, "float32", cfg.vocab_size,
               f"decode logits at {t}")


def test_mla_cache_layout_and_growth():
    """`init_cache` and `grow_cache` on MLA's {c, kr}: the reference's
    shapes, a prefill placed at slots 0 .. S − 1, and a windowed cache's
    ring slots p % W."""
    cfg = get_smoke_config(DSV2)
    j = j_get_smoke_config(DSV2)
    from repro.models.serving import init_cache as j_init_cache
    want = j_init_cache(j, 3, 40)
    got = init_cache(cfg, 3, 40, device="cpu")
    assert sorted(got) == ["c", "kr"]
    for nm in got:
        assert got[nm].shape == want[nm].shape and not got[nm].any()
    pre = {nm: torch.randn(2, 3, 10, t.shape[-1])
           for nm, t in got.items()}
    grown = grow_cache(cfg, pre, 40)
    for nm in pre:
        assert torch.equal(grown[nm][:, :, :10], pre[nm])
        assert not grown[nm][:, :, 10:].any()
    wcfg = dataclasses.replace(cfg, attn_window=4)
    ring = grow_cache(wcfg, pre, 40)
    for nm in pre:
        assert ring[nm].shape[2] == 4
        for p_ in range(6, 10):
            assert torch.equal(ring[nm][:, :, p_ % 4], pre[nm][:, :, p_])


# ---------------------------------------------------------------------------
# the event-batched loss and the round trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_event_batched_loss_matches_the_reference(name):
    """`make_lm_loss(cfg).event_batched(W, δ, x, y)`: its [K] losses (the
    aux term at 0.01 in each) against the reference's and against the
    port's loss at each W + δ_k, and its gradient on W against the
    reference's; the MoE dispatch runs under `torch.func.vmap`."""
    fam = family(name, "float32")
    K = 3
    np_d = jax.tree.map(lambda w: (0.02 * np.random.default_rng(5)
                                   .standard_normal((K,) + w.shape))
                        .astype(w.dtype), fam.np_params)
    nb = numpy_tokens(fam.cfg, B, S, 11, lead=(K,))
    x, y = nb["tokens"], nb["targets"]
    loss = make_lm_loss(fam.cfg)
    W, d = fam.params(), lm_params_from_numpy(np_d, "cpu")
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    got = loss.event_batched(W, d, tx, ty)
    assert got.shape == (K,)
    per_event = torch.stack([
        loss(tree_map(lambda w, dd: w + dd[k], W, d), tx[k], ty[k])
        for k in range(K)])
    np.testing.assert_allclose(got.numpy(), per_event.numpy(), **F32_GRAD)
    jl = j_make_lm_loss(fam.jcfg)
    want = jl.event_batched(fam.jparams, np_d, x, y)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_GRAD)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jl.event_batched(
        p, np_d, x, y))))(fam.jparams)
    g = torch.func.grad(lambda p: loss.event_batched(p, d, tx, ty).sum())(W)
    for i, (a, b) in enumerate(zip(leaves(g), jax.tree.leaves(jg))):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        np.testing.assert_allclose(_np32(a), _np32(b), err_msg=f"leaf {i}",
                                   **F32_GRAD)


C, MU, ROUNDS = 4, 2, 3
POINT = dict(rule="fasgd", lr=0.01, c_fetch=0.5, use_fused_kernel=True)
ROUND_CASES = [(n, m) for n in NAMES for m in ("serial", "fused")]


@pytest.mark.parametrize("name,mode", ROUND_CASES,
                         ids=[f"{n}-{m}" for n, m in ROUND_CASES])
def test_round_trainer_matches_the_reference(name, mode):
    """Three rounds of C = 4 clients on `make_dict_grad_fn` (vmapped over
    the clients, so the MoE dispatch runs under `torch.func.vmap`) against
    the reference's round step on its `launch/train.py` gradient, the
    round draws replayed."""
    fam = family(name, "float32")
    j_step = jax.jit(jrt.build_round_step(
        JTrainerConfig(num_round_clients=C, kernel_interpret=True, **POINT),
        _j_grad_fn(fam.jcfg), apply_mode=mode))
    tc = TrainerConfig(num_round_clients=C, **POINT)
    step = rt.build_round_step(tc, make_dict_grad_fn(fam.cfg), apply_mode=mode)
    keys = [jax.random.PRNGKey(100 + r) for r in range(ROUNDS)]
    draws = round_replay(keys, C, False, False)
    j_state = jrt.init_round_state(
        JTrainerConfig(num_round_clients=C, **POINT), fam.jparams)
    state = rt.init_round_state(tc, fam.params(), device="cpu")
    ops.reset_launches()
    for r in range(ROUNDS):
        nb = numpy_tokens(fam.cfg, MU, S, 10 + r, lead=(C,))
        j_state, j_m = j_step(j_state, fam.jbatch(nb), keys[r])
        state, m = step(state, fam.batch(nb), draws.round(r))
        compare_metrics(m, j_m)
    compare_states(state, j_state)
    kernel = "fasgd_update" if mode == "serial" else "fused_event_apply"
    assert ops.LAUNCHES[kernel] == int(state.counters.kernel_launches) > 0


def test_params_round_trip():
    """The MoE and MLA leaves cross in both directions, dtypes kept; the
    port's init has the reference's tree, shapes and dtypes."""
    for name in NAMES:
        fam = family(name, "bfloat16")
        back = lm_params_to_numpy(fam.params())
        for a, b in zip(jax.tree.leaves(back),
                        jax.tree.leaves(fam.np_params)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.int16), b.view(np.int16))
        params = init_model(torch.Generator().manual_seed(0), fam.cfg,
                            device="cpu")
        got = jax.tree_util.tree_leaves_with_path(lm_params_to_numpy(params))
        want = jax.tree_util.tree_leaves_with_path(fam.np_params)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, path
        assert param_count(params) == sum(w.size for _, w in want)
        # the expert weights at the reference's scale, 1/√E (its fan-in
        # is the first axis)
        wg = params["layers"]["moe"]["w_gate"].float()
        assert abs(float(wg.std()) - fam.cfg.num_experts ** -0.5) < 0.01
    bad = {**fam.np_params, "layers": {**fam.np_params["layers"],
                                       "mlp": np.zeros(2)}}
    with pytest.raises(ValueError, match="not a dense LM"):
        lm_params_from_numpy(bad, device="cpu")


# ---------------------------------------------------------------------------
# the reference's specs, on the port
# ---------------------------------------------------------------------------

def _port(name, batch=B, seq=64):
    cfg = get_smoke_config(name)
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, params, make_batch(cfg, batch, seq,
                                   torch.Generator().manual_seed(1))


def test_moe_aux_loss_nonzero():
    cfg, params, batch = _port(GROK)
    _, metrics = loss_fn(params, cfg, batch)
    assert float(metrics["moe_aux"]) > 0.0


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_forward(name):
    """Prefill S − 4 tokens, then decode the last four one by one; every
    step's logits match the full forward's at its position (the
    reference's `test_decode_matches_forward`, its tolerances rtol/atol
    2e-3 and 5e-3).  It holds because no token overflows at this size:
    each call routes its own tokens, and which tokens drop depends on how
    many there are."""
    cfg, params, batch = _port(name, seq=S)
    full, _ = forward(params, cfg, batch)
    S0 = S - N_DEC
    logits, cache = prefill(params, cfg, {"tokens": batch["tokens"][:, :S0]})
    np.testing.assert_allclose(_np32(logits), _np32(full[:, :S0]), rtol=2e-3,
                               atol=2e-3)
    cache = grow_cache(cfg, cache, S)
    for t in range(S0, S):
        lt, cache = decode_step(params, cfg, batch["tokens"][:, t:t + 1],
                                cache, t)
        np.testing.assert_allclose(_np32(lt[:, 0]), _np32(full[:, t]),
                                   rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_no_nans(name):
    """One gradient: a finite loss and a gradient tree that mirrors the
    parameters leaf for leaf (shape and dtype), every leaf finite."""
    cfg, params, batch = _port(name)
    g, (loss, _) = torch.func.grad_and_value(
        lambda p: loss_fn(p, cfg, batch), has_aux=True)(params)
    assert bool(torch.isfinite(loss))
    assert sorted(g) == sorted(params)
    for a, p in zip(leaves(g), leaves(params)):
        assert a.shape == p.shape and a.dtype == p.dtype
        assert bool(torch.isfinite(a).all())
    assert float(sum((a.float() ** 2).sum() for a in leaves(g))) > 0.0


@pytest.mark.parametrize("name", NAMES)
def test_one_sgd_step_reduces_loss_on_same_batch(name):
    cfg, params, batch = _port(name)
    lfn = lambda p: loss_fn(p, cfg, batch)[0]
    g, l0 = torch.func.grad_and_value(lfn)(params)
    p1 = tree_map(lambda p, gg: p - 0.5 * gg, params, g)
    assert float(lfn(p1)) < float(l0)


def test_param_counts_scale_with_family():
    """MoE smoke > dense smoke of similar dims (experts multiply params)."""
    dense = init_model(torch.Generator().manual_seed(0),
                       get_smoke_config("tinyllama-1.1b"), device="cpu")
    grok = init_model(torch.Generator().manual_seed(0),
                      get_smoke_config(GROK), device="cpu")
    assert param_count(grok) > param_count(dense)


@pytest.mark.parametrize("name", NAMES)
def test_full_config_matches_assignment(name):
    """FULL and SMOKE field for field as the reference's, the assigned
    hyperparameters (layers, d_model, heads, kv heads, d_ff, vocab, head
    dim, experts, top-k, shared experts, MLA), a citation."""
    spec = {GROK: (64, 6144, 48, 8, 32768, 131072, 128, 8, 2, 0, False),
            DSV2: (60, 5120, 128, 128, 1536, 102400, 128, 160, 6, 2,
                   True)}[name]
    cfg = get_config(name)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.hd, cfg.num_experts,
            cfg.num_experts_per_tok, cfg.num_shared_experts,
            cfg.use_mla) == spec
    assert cfg.citation and cfg.dtype == torch.bfloat16 and cfg.is_moe
    for mine, ref in ((cfg, j_get_config(name)),
                      (get_smoke_config(name), j_get_smoke_config(name))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.hd == ref.hd and mine.padded_vocab == ref.padded_vocab
        assert mine.is_moe == ref.is_moe
        assert mine.supports_decode() == ref.supports_decode()


@pytest.mark.parametrize("name", NAMES)
def test_serve_greedy_follows_forward(name, capsys):
    """`serve` on the MoE family: each greedy token is the arg-max of the
    full forward over the prompt and the tokens before it (nothing
    overflows at this size), the flash kernel once a layer at prefill and
    once a layer a decode step for GQA, at prefill only for MLA (its
    decode is absorbed); the CLI serves the SMOKE config."""
    cfg, params, batch = _port(name, seq=24)
    ops.reset_launches()
    res = serve_mod.serve(cfg, params, batch["tokens"], 4, device="cpu")
    per_step = 0 if cfg.use_mla else cfg.num_layers
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers + 3 * per_step
    seq = torch.cat([batch["tokens"], res["tokens"][:, :-1]], dim=1)
    full, _ = forward(params, cfg, {"tokens": seq})
    assert torch.equal(res["tokens"], full[:, 23:].argmax(-1))
    out = serve_mod.main(["--arch", name, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "16", "--gen", "3",
                          "--temperature", "0"])
    assert out["tokens"].shape == (2, 3)
    assert "tok/s" in capsys.readouterr().out
