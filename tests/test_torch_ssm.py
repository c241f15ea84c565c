"""The port's SSM and hybrid families against a live run of the JAX reference.

The SMOKE configs of mamba2-1.3b (2 Mamba2 layers, d_model 256, d_inner
512, 16 heads of 32, state 32, chunks of 32, vocab 512) and zamba2-7b (the
same stack with its shared attention block, 8 heads of 32, MLP 512, after
every 2 layers) run through both packages from the same weights (the JAX
package's init, through numpy and `lm_params_from_numpy`) on the same
token batches (numpy, seeded): the SSD primitives (`segsum_exp`,
`ssd_chunked` against the reference's and the port's `ssd_naive`, the
tail padding), `_causal_conv`, one Mamba2 block (`ssm_forward` with its
carried state, with `return_state`, with a stale offset `dp`) and its
`ssm_decode`; the model's init tree and the FULL parameter counts;
`forward` and `loss_fn` (value, CE and every leaf's gradient, the shared
block's included, with and without `deltas`, float32 and bfloat16);
`prefill` and four `decode_step`s; `serve`; and the round trainer (serial
and fused, the server-update kernels' slots on: their plain versions on
the CPU) on `models.lm.make_lm_loss`, with the round draws replayed.  Then
the reference's own specs, run on the port.

Tolerances, as `tests/test_torch_audio_vlm.py` states them:
- float32: logits, caches and SSM outputs rtol/atol 1e-5; losses and
  gradients rtol 1e-4 / atol 1e-5; the SSD primitives against the
  reference rtol/atol 1e-5 and against `ssd_naive` the reference's own
  rtol/atol 1e-4 (the chunked form sums in another order); the round
  trainer's state as `test_torch_round_trainer.compare_states` holds it.
  The port's softplus returns x above 20 where the reference's is
  log(1 + eˣ), which differs there by under 2·10⁻⁹, inside these.
- bfloat16: logits (the padded columns aside, which are −1e30 in both),
  outputs, caches and each leaf's gradient within 8 bf16 ulps of the
  largest reference entry of that tensor (the conv's bf16 tap sums and
  the residual adds round at other points than under XLA's fusion);
  losses within one bf16 rounding (rtol 2⁻⁷).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as j_ssm
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.configs.base import TrainerConfig as JTrainerConfig
from repro.core import round_trainer as jrt
from repro.models.lm import make_lm_loss as j_make_lm_loss
from repro.models.serving import decode_step as j_decode_step
from repro.models.serving import init_cache as j_init_cache
from repro.models.serving import prefill as j_prefill
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_model as j_init_model
from repro.models.transformer import loss_fn as j_loss_fn

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainerConfig
from repro_torch.core import round_trainer as rt
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import ssm
from repro_torch.models.api import make_batch, param_count
from repro_torch.models.lm import make_lm_loss
from repro_torch.models.serving import (decode_step, grow_cache, init_cache,
                                        prefill)
from repro_torch.models.transformer import forward, init_model, loss_fn
from repro_torch.utils.convert import (lm_params_from_numpy,
                                       lm_params_to_numpy)
from repro_torch.utils.trees import leaves, tree_map

from test_torch_audio_vlm import (BF16_ULP, BF16_ULPS, F32, F32_GRAD,
                                  _close, _deltas, _within_ulps_of_max)
from test_torch_fred import one_thread  # noqa: F401
from test_torch_lm_serving import _np32
from test_torch_moe import Family as _Family
from test_torch_moe import numpy_tokens
from test_torch_round_trainer import (compare_metrics, compare_states,
                                      round_replay)

MAMBA, ZAMBA = "mamba2-1.3b", "zamba2-7b"
NAMES = [MAMBA, ZAMBA]
B, S, N_DEC = 2, 40, 4          # S: one full chunk of 32 and a ragged tail
NAIVE = dict(rtol=1e-4, atol=1e-4)      # tests/test_models_smoke.py's


class Family(_Family):
    """One config in both packages: the reference's weights and a numpy
    token batch of B × S."""

    def __init__(self, name, dtype, seed=1):
        super().__init__(name, dtype, seed)
        self.np_batch = numpy_tokens(self.cfg, B, S, seed)


@functools.lru_cache(maxsize=None)
def family(name, dtype):
    """One `Family` per config and dtype for the module (read, never
    written)."""
    return Family(name, dtype)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _ssd_inputs(b, L, H, P, N, seed, with_h0=False):
    """x, dt (> 0), A (< 0), B, C (and h0) in float32, from `seed`."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    out = [n(b, L, H, P), np.log1p(np.exp(n(b, L, H))).astype(np.float32),
           -np.exp(n(H)), n(b, L, N), n(b, L, N)]
    return out + ([n(b, H, P, N)] if with_h0 else [])


@functools.lru_cache(maxsize=None)
def _j_ssd(chunk):
    return jax.jit(lambda *a, h0=None: j_ssm.ssd_chunked(*a, chunk, h0=h0))


# ---------------------------------------------------------------------------
# the SSD primitives
# ---------------------------------------------------------------------------

SSD_CASES = {
    # the reference's test_ssm_matches_naive_recurrence
    "spec_naive": (2, 64, 4, 8, 16, 16, False),
    # its test_ssm_chunked_with_initial_state
    "spec_initial_state": (1, 32, 2, 4, 8, 8, True),
    # L = 50 over chunks of 16: the zero-padded tail (dt = 0)
    "ragged_tail": (2, 50, 4, 8, 16, 16, True),
}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_chunked_matches_the_reference_and_the_recurrence(case):
    b, L, H, P, N, chunk, with_h0 = SSD_CASES[case]
    ins = _ssd_inputs(b, L, H, P, N, seed=L + H, with_h0=with_h0)
    x, dt, A, Bm, Cm = ins[:5]
    h0 = ins[5] if with_h0 else None
    y, h = ssm.ssd_chunked(*map(_t, ins[:5]), chunk,
                           h0=None if h0 is None else _t(h0))
    assert y.shape == (b, L, H, P) and h.shape == (b, H, P, N)
    jy, jh = _j_ssd(chunk)(*ins[:5], h0=h0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32)
    ny, nh = ssm.ssd_naive(*map(_t, ins[:5]),
                           h0=None if h0 is None else _t(h0))
    np.testing.assert_allclose(y.numpy(), ny.numpy(), **NAIVE)
    np.testing.assert_allclose(h.numpy(), nh.numpy(), **NAIVE)
    jny, _ = j_ssm.ssd_naive(*ins[:5], h0=h0)
    np.testing.assert_allclose(ny.numpy(), np.asarray(jny), **F32)


def test_segsum_exp_masks_before_exp():
    """The reference's lower-triangular decay matrix, exactly 0 above the
    diagonal; its gradient is finite.  With decays as large as these (a
    down to ~−100) the upper triangle's sums reach ~10³, whose exp
    overflows: a mask after exp would give inf·0 = nan there."""
    a = -np.exp(np.random.default_rng(0).standard_normal((3, 5, 16))
                ).astype(np.float32) * 8.0
    got = ssm.segsum_exp(_t(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_ssm.segsum_exp(a)),
                               **F32)
    assert not got.triu(1).any()
    g = torch.func.grad(lambda t: ssm.segsum_exp(t).sum())(_t(a))
    assert bool(torch.isfinite(g).all())
    jg = jax.jit(jax.grad(lambda t: j_ssm.segsum_exp(t).sum()))(a)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **F32_GRAD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_the_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, 96)).astype(np.float32)
    w = (0.5 * rng.standard_normal((4, 96))).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax.jit(j_ssm._causal_conv)(*(jnp.asarray(a, jdt)
                                         for a in (x, w, b)))
    got = ssm._causal_conv(*(_t(a).to(tdt) for a in (x, w, b)))
    assert got.dtype == tdt and got.shape == x.shape
    _close(got, want, dtype, what="conv")


# ---------------------------------------------------------------------------
# one Mamba2 block
# ---------------------------------------------------------------------------

def _layer0(fam):
    np_p = jax.tree.map(lambda a: a[0], fam.np_params["layers"]["mamba"])
    return np_p, {k: torch.from_numpy(np.array(v, np.float32))
                  for k, v in np_p.items()}


def _x(fam, L, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, L, fam.cfg.d_model)).astype(np.float32)


# the two SMOKE configs' Mamba2 blocks have the same widths: one suffices
@pytest.mark.parametrize("name", [MAMBA])
def test_ssm_forward_and_its_state_match_the_reference(name):
    """Layer 0's block over 40 positions (a ragged chunk) with
    `return_state`; then the next 24 from that state (`h0`, `conv0`), which
    must equal the same 64 positions run at once; then with a stale offset
    `dp` on every leaf."""
    fam = family(name, "float32")
    np_p, p = _layer0(fam)
    jcfg, cfg = fam.jcfg, fam.cfg
    x = _x(fam, 64, 3)
    j_run = jax.jit(lambda pp, xx, h0, c0: j_ssm.ssm_forward(
        pp, jcfg, xx, h0=h0, conv0=c0, return_state=True))
    jy0, jst = jax.jit(lambda pp, xx: j_ssm.ssm_forward(
        pp, jcfg, xx, return_state=True))(np_p, x[:, :40])
    y0, st = ssm.ssm_forward(p, cfg, _t(x[:, :40]), return_state=True)
    np.testing.assert_allclose(y0.numpy(), np.asarray(jy0), **F32)
    for k in ("h", "conv"):
        assert st[k].shape == jst[k].shape
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), **F32)
    assert st["h"].dtype == torch.float32
    jy1, jst1 = j_run(np_p, x[:, 40:], jst["h"], jst["conv"])
    y1, st1 = ssm.ssm_forward(p, cfg, _t(x[:, 40:]), h0=st["h"],
                              conv0=st["conv"], return_state=True)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), **F32)
    np.testing.assert_allclose(st1["h"].numpy(), np.asarray(jst1["h"]),
                               **F32)
    whole, st_all = ssm.ssm_forward(p, cfg, _t(x), return_state=True)
    np.testing.assert_allclose(torch.cat([y0, y1], 1).numpy(),
                               whole.numpy(), **NAIVE)
    np.testing.assert_allclose(st1["h"].numpy(), st_all["h"].numpy(),
                               **NAIVE)
    np_d = _deltas(np_p, 0.02, 4)
    jyd = jax.jit(lambda pp, xx, dd: j_ssm.ssm_forward(pp, jcfg, xx, dp=dd))(
        np_p, x, np_d)
    yd = ssm.ssm_forward(p, cfg, _t(x), dp={k: _t(v)
                                            for k, v in np_d.items()})
    np.testing.assert_allclose(yd.numpy(), np.asarray(jyd), **F32)
    assert not np.allclose(yd.numpy(), whole.numpy(), atol=1e-3)


@pytest.mark.parametrize("name", [MAMBA])
def test_ssm_decode_matches_the_reference(name):
    """Four one-token steps of layer 0 from the state after 36 positions:
    each output and state against the reference's, and the outputs against
    the block run over all 40 positions."""
    fam = family(name, "float32")
    np_p, p = _layer0(fam)
    x = _x(fam, 40, 5)
    y_all = ssm.ssm_forward(p, fam.cfg, _t(x))
    _, st = ssm.ssm_forward(p, fam.cfg, _t(x[:, :36]), return_state=True)
    jst = {k: v.numpy() for k, v in st.items()}
    j_step = jax.jit(lambda pp, xx, s: j_ssm.ssm_decode(pp, fam.jcfg, xx, s,
                                                        0))
    for t in range(36, 40):
        jy, jst = j_step(np_p, x[:, t:t + 1], jst)
        y, st = ssm.ssm_decode(p, fam.cfg, _t(x[:, t:t + 1]), st)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
        for k in ("h", "conv"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       **F32)
        np.testing.assert_allclose(y[:, 0].numpy(), y_all[:, t].numpy(),
                                   **NAIVE)


# ---------------------------------------------------------------------------
# the weights
# ---------------------------------------------------------------------------

def test_init_tree_params_round_trip_and_refusals():
    """`init_model`'s tree has the reference's structure, shapes and dtypes
    (the hybrid's `shared` block too); both trees cross in both directions
    with their dtypes; a tree missing a Mamba2 leaf, or the hybrid's
    shared block missing its MLP, is refused."""
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
        assert [q for q, _ in got] == [q for q, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, path
        assert param_count(params) == sum(w.size for _, w in want)
        # the reference's fixed leaves: A_log, D, dt_bias, the norms
        for leaf in ("A_log", "D", "dt_bias", "out_norm", "conv_b"):
            np.testing.assert_allclose(
                _np32(params["layers"]["mamba"][leaf]),
                _np32(fam.np_params["layers"]["mamba"][leaf]), rtol=1e-2,
                atol=0, err_msg=leaf)
    np_p = family(MAMBA, "float32").np_params
    bad = {**np_p, "layers": {**np_p["layers"], "mamba": {
        k: v for k, v in np_p["layers"]["mamba"].items() if k != "A_log"}}}
    with pytest.raises(ValueError, match="not a dense LM"):
        lm_params_from_numpy(bad, device="cpu")
    np_z = family(ZAMBA, "float32").np_params
    bad = {**np_z, "shared": {k: v for k, v in np_z["shared"].items()
                              if k != "mlp"}}
    with pytest.raises(ValueError, match="not a dense LM"):
        lm_params_from_numpy(bad, device="cpu")
    with pytest.raises(ValueError, match="not a dense LM"):
        lm_params_from_numpy({**np_p, "shared": np_z["shared"],
                              "img_proj": np.zeros(2)}, device="cpu")


@pytest.mark.parametrize("name,count", [(MAMBA, 1_446_812_672),
                                        (ZAMBA, 6_776_820_944)])
def test_full_parameter_counts_equal_the_reference(monkeypatch, name, count):
    """The FULL configs' trees, built on the meta device (no weights are
    drawn), hold the reference's shapes and dtypes (`jax.eval_shape` of its
    init) and its parameter count."""
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None,
                        device=None: torch.empty(shape, device="meta"))
    cfg = get_config(name)
    params = init_model(torch.Generator(), cfg, device="meta")
    want = jax.eval_shape(lambda k: j_init_model(k, j_get_config(name)),
                          jax.random.PRNGKey(0))
    got = jax.tree_util.tree_leaves_with_path(params)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [q for q, _ in got] == [q for q, _ in wl]
    for (path, g), (_, w) in zip(got, wl):
        assert g.shape == w.shape and g.dtype == torch.bfloat16, path
    assert param_count(params) == sum(int(np.prod(w.shape))
                                      for _, w in wl) == count


# ---------------------------------------------------------------------------
# forward, loss_fn and every gradient
# ---------------------------------------------------------------------------

LOSS_CASES = [(n, dt, d) for n in NAMES for dt in ("float32", "bfloat16")
              for d in (False, True)]
N_LEAVES = {MAMBA: 12, ZAMBA: 22}


@functools.lru_cache(maxsize=None)
def _j_forward_and_grad(name, dtype):
    """The reference's jitted (logits, ((loss, metrics), grads)) without
    deltas, and ((loss, metrics), grads) with them."""
    jcfg = family(name, dtype).jcfg
    grad = jax.value_and_grad(
        lambda p, b, dd: j_loss_fn(p, jcfg, b, deltas=dd), has_aux=True)
    plain = jax.jit(lambda p, b: (j_forward(p, jcfg, b)[0],
                                  grad(p, b, None)))
    return plain, jax.jit(grad)


@pytest.mark.parametrize("name,dtype,with_deltas", LOSS_CASES,
                         ids=[f"{n}-{dt}-{'deltas' if d else 'plain'}"
                              for n, dt, d in LOSS_CASES])
def test_forward_loss_and_every_gradient_match_the_reference(
        name, dtype, with_deltas):
    """Logits (without `deltas`), loss, CE, `moe_aux` (0) and every leaf's
    gradient; the hybrid's shared block is applied once at this depth, and
    its gradient is nonzero.  With `deltas` the port's logits are held to
    its own at W + δ folded, within the gradients' tolerance."""
    fam = family(name, dtype)
    np_d = _deltas(fam.np_params, 0.02, 3) if with_deltas else None
    d = None if np_d is None else lm_params_from_numpy(np_d, "cpu")
    jd = None if np_d is None else jax.tree.map(jnp.asarray, np_d)
    jb, tb = fam.jbatch(), fam.batch()
    plain, grad = _j_forward_and_grad(name, dtype)
    got, aux = forward(fam.params(), fam.cfg, tb, deltas=d)
    assert got.shape == (B, S, fam.cfg.padded_vocab) and float(aux) == 0.0
    if d is None:
        want, ((jl, jm), jg) = plain(fam.jparams, jb)
        _close(got, want, dtype, fam.cfg.vocab_size, "logits")
    else:
        (jl, jm), jg = grad(fam.jparams, jb, jd)
        if dtype == "float32":
            folded = tree_map(lambda w, dw: w + dw, fam.params(), d)
            V = fam.cfg.vocab_size
            np.testing.assert_allclose(
                _np32(got)[..., :V], _np32(forward(folded, fam.cfg, tb)[0])[
                    ..., :V], err_msg="logits at W + δ", **F32_GRAD)
    g, (loss, m) = torch.func.grad_and_value(
        lambda p: loss_fn(p, fam.cfg, tb, deltas=d), has_aux=True)(
        fam.params())
    tol = F32_GRAD if dtype == "float32" else dict(rtol=BF16_ULP, atol=0)
    np.testing.assert_allclose(float(loss), float(jl), **tol)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), **tol)
    assert float(m["moe_aux"]) == float(jm["moe_aux"]) == 0.0
    got_g, want_g = leaves(g), jax.tree.leaves(jg)
    assert len(got_g) == len(want_g) == N_LEAVES[name]
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        assert a.dtype == getattr(torch, dtype) and a.shape == b.shape
        assert bool(torch.isfinite(a).all()), i
        if dtype == "float32":
            np.testing.assert_allclose(_np32(a), _np32(b), err_msg=f"leaf {i}",
                                       **F32_GRAD)
        else:
            _within_ulps_of_max(a, _np32(b), BF16_ULPS, f"leaf {i}")
    if name == ZAMBA:
        assert all(bool((t != 0).any()) for t in leaves(g["shared"]))


def test_shared_block_gradients_sum_over_its_applications(monkeypatch):
    """At 4 layers zamba2's shared block runs twice.  Giving each
    application its own copy of the block's weights, the gradient of the
    one shared set is the sum of the two copies' gradients, leaf for leaf,
    and both copies' are nonzero.  (Its parity with the reference is
    `test_forward_loss_and_every_gradient_match_the_reference`'s, at one
    application.)"""
    from repro_torch.models import transformer
    cfg = get_smoke_config(ZAMBA, num_layers=4)
    params = init_model(torch.Generator().manual_seed(2), cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in numpy_tokens(cfg, B, 24,
                                                          6).items()}
    g = torch.func.grad(lambda p: loss_fn(p, cfg, tb)[0])(params)
    real = transformer._shared_block

    def split(p, c0, c1):
        copies = iter([c0, c1])
        monkeypatch.setattr(transformer, "_shared_block",
                            lambda sp, *a, **kw: real(next(copies), *a,
                                                      **kw))
        try:
            return loss_fn(p, cfg, tb)[0]
        finally:
            monkeypatch.setattr(transformer, "_shared_block", real)
    sp = params["shared"]
    g_p, g0, g1 = torch.func.grad(split, argnums=(0, 1, 2))(params, sp, sp)
    assert not any(bool(t.any()) for t in leaves(g_p["shared"]))
    for i, (a, b, c) in enumerate(zip(leaves(g["shared"]), leaves(g0),
                                      leaves(g1))):
        assert bool(b.any()) and bool(c.any()), i
        np.testing.assert_allclose(a.numpy(), (b + c).numpy(),
                                   err_msg=f"leaf {i}", **F32_GRAD)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_serve(name, dtype):
    jcfg = family(name, dtype).jcfg
    return (jax.jit(lambda p, t: j_prefill(p, jcfg, {"tokens": t})),
            jax.jit(lambda p, t, c, pos: j_decode_step(p, jcfg, t, c, pos)))


SERVE_CASES = [(n, dt) for n in NAMES for dt in ("float32", "bfloat16")]


def _ssm_part(cache, name):
    return cache if name == MAMBA else cache["mamba"]


@pytest.mark.parametrize("name,dtype", SERVE_CASES,
                         ids=[f"{n}-{dt}" for n, dt in SERVE_CASES])
def test_prefill_and_decode_match_the_reference(name, dtype):
    """Prefill S − 4 tokens (the SSM state, and for the hybrid the shared
    block's k, v through `ops.attention`), then decode four from the same
    cache: logits and every cache leaf against the reference's."""
    fam = family(name, dtype)
    S0 = S - N_DEC
    jb, tb = fam.jbatch(), fam.batch()
    j_pre, j_step = _j_serve(name, dtype)
    jl, jc = j_pre(fam.jparams, jb["tokens"][:, :S0])
    params = fam.params()
    ops.reset_launches()
    tl, tc = prefill(params, fam.cfg, {"tokens": tb["tokens"][:, :S0]})
    groups = 1 if name == ZAMBA else 0
    assert ops.LAUNCHES["flash_attention"] == groups
    V = fam.cfg.vocab_size
    _close(tl, jl, dtype, V, "prefill logits")
    assert jax.tree.structure(jc) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tc, is_leaf=torch.is_tensor))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tc),
                            jax.tree.leaves(jc)):
        assert tuple(a.shape) == b.shape and a.dtype == getattr(
            torch, str(b.dtype)), path
        _close(a, b, dtype, what=f"cache {path}")
    assert _ssm_part(tc, name)["h"].dtype == torch.float32
    # the reference's decode cache: the attention part grown to S slots
    if name == ZAMBA:
        jc = {"mamba": jc["mamba"], "attn": jax.tree.map(
            lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, N_DEC), (0, 0),
                                  (0, 0))), jc["attn"])}
    tc = grow_cache(fam.cfg, tc, S)
    for t in range(S0, S):
        jl_t, jc = j_step(fam.jparams, jb["tokens"][:, t:t + 1], jc,
                          jnp.int32(t))
        tl_t, tc2 = decode_step(params, fam.cfg, tb["tokens"][:, t:t + 1],
                                tc, t)
        assert tc2 is tc                  # written in place
        _close(tl_t, jl_t, dtype, V, f"decode logits at {t}")
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tc),
                            jax.tree.leaves(jc)):
        _close(a, b, dtype, what=f"cache {path} after decode")


def test_cache_layout_and_growth():
    """`init_cache`: the reference's shapes and dtypes (h float32 under
    bf16 weights); `grow_cache` passes the SSM state through untouched and
    grows only the hybrid's attention part, n_groups entries deep."""
    for name in NAMES:
        cfg = get_smoke_config(name, param_dtype="bfloat16")
        want = j_init_cache(j_get_smoke_config(name,
                                               param_dtype="bfloat16"), 3, 40)
        got = init_cache(cfg, 3, 40, device="cpu")
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree.leaves(want)):
            assert tuple(a.shape) == b.shape and not a.any(), path
            assert a.dtype == getattr(torch, str(b.dtype)), path
        pre = tree_map(lambda t: torch.randn(t.shape).to(t.dtype), got)
        if name == ZAMBA:
            pre["attn"] = {k: v[:, :, :10] for k, v in pre["attn"].items()}
        grown = grow_cache(cfg, pre, 40)
        ssm_pre, ssm_grown = _ssm_part(pre, name), _ssm_part(grown, name)
        for k in ("h", "conv"):
            assert ssm_grown[k] is ssm_pre[k]
        if name == ZAMBA:
            for k in ("k", "v"):
                assert grown["attn"][k].shape[:3] == (1, 3, 40)
                assert torch.equal(grown["attn"][k][:, :, :10],
                                   pre["attn"][k])
                assert not grown["attn"][k][:, :, 10:].any()


# ---------------------------------------------------------------------------
# the round trainer
# ---------------------------------------------------------------------------

C, MU, ROUNDS, SEQ = 4, 2, 3, 24
POINT = dict(rule="fasgd", lr=0.01, c_fetch=0.5, use_fused_kernel=True)
ROUND_CASES = [(n, m) for n in NAMES for m in ("serial", "fused")]


@functools.lru_cache(maxsize=None)
def _j_round_step(name, mode):
    j_loss = j_make_lm_loss(family(name, "float32").jcfg)
    return jax.jit(jrt.build_round_step(
        JTrainerConfig(num_round_clients=C, kernel_interpret=True, **POINT),
        lambda p, b: jax.value_and_grad(j_loss)(p, b[0], b[1]),
        apply_mode=mode))


@pytest.mark.parametrize("name,mode", ROUND_CASES,
                         ids=[f"{n}-{m}" for n, m in ROUND_CASES])
def test_round_trainer_matches_the_reference(name, mode):
    """Three rounds of C = 4 clients on `make_lm_loss` (vmapped over the
    clients, so the SSD runs under `torch.func.vmap`) against the
    reference's round step, the round draws replayed: metrics every round,
    then the whole state."""
    fam = family(name, "float32")
    j_step = _j_round_step(name, mode)
    tc = TrainerConfig(num_round_clients=C, **POINT)
    step = rt.build_round_step(tc, rt.make_grad_fn(make_lm_loss(fam.cfg)),
                               apply_mode=mode)
    keys = [jax.random.PRNGKey(100 + r) for r in range(ROUNDS)]
    draws = round_replay(keys, C, False, False)
    j_state = jrt.init_round_state(
        JTrainerConfig(num_round_clients=C, **POINT), fam.jparams)
    state = rt.init_round_state(tc, fam.params(), device="cpu")
    ops.reset_launches()
    for r in range(ROUNDS):
        nb = numpy_tokens(fam.cfg, MU, SEQ, 10 + r, lead=(C,))
        j_state, j_m = j_step(j_state, (jnp.asarray(nb["tokens"]),
                                        jnp.asarray(nb["targets"])), keys[r])
        state, m = step(state, (torch.from_numpy(nb["tokens"]),
                                torch.from_numpy(nb["targets"])),
                        draws.round(r))
        compare_metrics(m, j_m)
    compare_states(state, j_state)
    kernel = "fasgd_update" if mode == "serial" else "fused_event_apply"
    assert ops.LAUNCHES[kernel] == int(state.counters.kernel_launches) > 0


# ---------------------------------------------------------------------------
# the reference's specs, on the port
# ---------------------------------------------------------------------------

def _port(name, batch=B, seq=S):
    cfg = get_smoke_config(name)
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, params, make_batch(cfg, batch, seq,
                                   torch.Generator().manual_seed(1))


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_forward(name):
    """Prefill S − 4 tokens, then decode the last four one by one; every
    step's logits match the full forward's at its position (the
    reference's `test_decode_matches_forward`, rtol/atol 2e-3 and
    5e-3)."""
    cfg, params, batch = _port(name)
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
def test_one_sgd_step_reduces_loss_and_no_nans(name):
    """One gradient: finite, a tree that mirrors the parameters; one SGD
    step of 0.5 lowers the loss on the same batch."""
    cfg, params, batch = _port(name)
    lfn = lambda p: loss_fn(p, cfg, batch)[0]
    g, l0 = torch.func.grad_and_value(lfn)(params)
    assert bool(torch.isfinite(l0)) and sorted(g) == sorted(params)
    for a, p in zip(leaves(g), leaves(params)):
        assert a.shape == p.shape and a.dtype == p.dtype
        assert bool(torch.isfinite(a).all())
    p1 = tree_map(lambda p, gg: p - 0.5 * gg, params, g)
    assert float(lfn(p1)) < float(l0)


@pytest.mark.parametrize("name", NAMES)
def test_full_config_matches_assignment(name):
    """FULL and SMOKE field for field as the reference's, the assigned
    hyperparameters, a citation; SSM and hybrid serve long contexts."""
    spec = {MAMBA: (48, 2048, 0, 0, 50280, 128, 64, 128, 4, 0),
            ZAMBA: (81, 3584, 32, 32, 32000, 64, 64, 128, 4, 6)}[name]
    cfg = get_config(name)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.vocab_size, cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_chunk,
            cfg.conv_width, cfg.hybrid_attn_every) == spec
    assert cfg.citation and cfg.dtype == torch.bfloat16
    assert cfg.supports_long_context() and cfg.supports_decode()
    if name == ZAMBA:
        assert cfg.hd == 112 and 112 in ops._HEAD_DIMS
    for mine, ref in ((cfg, j_get_config(name)),
                      (get_smoke_config(name), j_get_smoke_config(name))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert (mine.d_inner, mine.ssm_heads, mine.hd, mine.padded_vocab) == (
            ref.d_inner, ref.ssm_heads, ref.hd, ref.padded_vocab)


@pytest.mark.parametrize("name", NAMES)
def test_serve_greedy_follows_forward(name, capsys):
    """`serve`: each greedy token is the arg-max of the full forward over
    the prompt and the tokens before it; the flash kernel runs once per
    shared-block application at prefill and each decode step (none for
    mamba2); the CLI serves the SMOKE config."""
    cfg, params, batch = _port(name, seq=24)
    ops.reset_launches()
    res = serve_mod.serve(cfg, params, batch["tokens"], 4, device="cpu")
    groups = cfg.num_layers // cfg.hybrid_attn_every if name == ZAMBA else 0
    assert ops.LAUNCHES["flash_attention"] == groups * 4
    seq = torch.cat([batch["tokens"], res["tokens"][:, :-1]], dim=1)
    full, _ = forward(params, cfg, {"tokens": seq})
    assert torch.equal(res["tokens"], full[:, 23:].argmax(-1))
    out = serve_mod.main(["--arch", name, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "16", "--gen", "3",
                          "--temperature", "0"])
    assert out["tokens"].shape == (2, 3)
    assert "tok/s" in capsys.readouterr().out
