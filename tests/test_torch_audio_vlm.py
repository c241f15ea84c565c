"""The port's audio and VLM families against a live run of the JAX reference.

The SMOKE configs of hubert-xlarge (a bidirectional encoder over 64-wide
frame embeddings: 2 layers, d_model 256, 8 heads of 32, vocab 504) and
phi-3-vision-4.2b (16 image tokens of width 64 before the text: 2 layers,
d_model 256, 8 heads of 32, vocab 512) run through both packages from the
same weights (the JAX package's init, through numpy and
`lm_params_from_numpy`) on the same batches (numpy, seeded): `forward`,
`loss_fn` (value, CE and every leaf's gradient, `img_proj` / `frame_proj`
included, with and without `deltas`), the VLM's `prefill` and four
`decode_step`s, the encoder's `encode` against the reference's `forward`
(its `make_prefill_step` for an encoder), and the round trainer (serial
and fused, the server-update kernels' slots on: their plain versions on
the CPU) on the reference's `launch/train.py` gradient, with the round
draws replayed.  Then the reference's own specs, run on the port.

Tolerances, as `tests/test_torch_lm_serving.py` and
`tests/test_torch_lm_training.py` state them:
- float32: logits and caches rtol/atol 1e-5; losses and gradients rtol
  1e-4 / atol 1e-5; the round trainer's state as
  `test_torch_round_trainer.compare_states` holds it (rtol 1e-4 / atol
  1e-5, integers and counters exactly).
- bfloat16: logits (the padded columns aside, which are −1e30 in both),
  caches and each leaf's gradient within 8 bf16 ulps of the largest
  reference entry of that tensor; losses within one bf16 rounding (rtol
  2⁻⁷).  Tinyllama's logits held `test_torch_lm_serving.py`'s rtol 2⁻⁷ /
  atol 2⁻⁶; here a few of 32768 entries are 3 ulps off (2.3e-2 at
  |logit| ≈ 0.5), where the two frameworks round the bf16 frame or image
  projection and the residual adds at different points.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.configs.base import TrainerConfig as JTrainerConfig
from repro.core import round_trainer as jrt
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
from repro_torch.models.api import make_batch, make_dict_grad_fn, param_count
from repro_torch.models.serving import (decode_step, encode, grow_cache,
                                        prefill)
from repro_torch.models.transformer import forward, init_model, loss_fn
from repro_torch.utils.convert import (lm_params_from_numpy,
                                       lm_params_to_numpy)
from repro_torch.utils.trees import leaves

from test_torch_fred import one_thread  # noqa: F401
from test_torch_lm_serving import _decode_cache, _np32
from test_torch_round_trainer import (compare_metrics, compare_states,
                                      round_replay)

VLM, AUDIO = "phi-3-vision-4.2b", "hubert-xlarge"
NAMES = [VLM, AUDIO]
B, S, N_DEC = 2, 32, 4          # S: the total length, image tokens included
F32 = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = dict(rtol=1e-4, atol=1e-5)
BF16_ULP = 2.0 ** -7
BF16_ULPS = 8


class Family:
    """One family in both packages: configs, the reference's weights and
    a numpy batch of B sequences of S positions."""

    def __init__(self, name, dtype, seed=1, batch=B):
        self.jcfg = j_get_smoke_config(name, param_dtype=dtype)
        self.cfg = get_smoke_config(name, param_dtype=dtype)
        self.jparams = j_init_model(jax.random.PRNGKey(0), self.jcfg)
        self.np_params = jax.tree.map(np.asarray, self.jparams)
        self.np_batch = numpy_batch(self.cfg, batch, S, seed)

    def params(self):
        return lm_params_from_numpy(self.np_params, device="cpu")

    def jbatch(self, np_batch=None):
        np_batch = self.np_batch if np_batch is None else np_batch
        return {k: jnp.asarray(v, self.jcfg.dtype) if v.dtype.kind == "f"
                else jnp.asarray(v, jnp.int32) for k, v in np_batch.items()}

    def batch(self, np_batch=None):
        np_batch = self.np_batch if np_batch is None else np_batch
        return {k: torch.from_numpy(v).to(self.cfg.dtype)
                if v.dtype.kind == "f" else torch.from_numpy(v)
                for k, v in np_batch.items()}


def numpy_batch(cfg, batch, seq, seed, lead=()):
    """`make_batch`'s keys as numpy from `seed`, with leading axes
    `lead`; embeddings float32 (cast to the config's dtype by the
    packages), tokens int64."""
    rng = np.random.default_rng(seed)
    shape = lead + (batch,)
    ints = lambda n: rng.integers(0, cfg.vocab_size, shape + (n,))
    normal = lambda *s: rng.standard_normal(shape + s).astype(np.float32)
    if cfg.arch_type == "audio":
        return {"frames": normal(seq, cfg.frame_embed_dim),
                "targets": ints(seq)}
    P = cfg.num_image_tokens
    return {"tokens": ints(seq - P),
            "image_embeds": normal(P, cfg.image_embed_dim),
            "targets": ints(seq - P)}


def _within_ulps_of_max(got, want, ulps, what):
    got, want = _np32(got).astype(np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= ulps * BF16_ULP * scale, (
        f"{what}: max|Δ| {err:.3e} above {ulps} bf16 ulps of max|ref| "
        f"{scale:.3e}")


def _close(got, want, dtype, vocab=None, what=""):
    """float32: rtol/atol 1e-5; bfloat16: 8 bf16 ulps of max|want|, over
    the first `vocab` columns of logits (the rest equal)."""
    got, want = _np32(got), _np32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=what, **F32)
        return
    if vocab is not None:
        np.testing.assert_array_equal(got[..., vocab:], want[..., vocab:])
        got, want = got[..., :vocab], want[..., :vocab]
    _within_ulps_of_max(got, want, BF16_ULPS, what)


def _deltas(np_params, scale, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda w: (scale * rng.standard_normal(w.shape))
                        .astype(w.dtype), np_params)


# ---------------------------------------------------------------------------
# forward, loss_fn and every gradient
# ---------------------------------------------------------------------------

LOSS_CASES = [(n, dt, d) for n in NAMES for dt in ("float32", "bfloat16")
              for d in (False, True)]


@pytest.mark.parametrize("name,dtype,with_deltas", LOSS_CASES,
                         ids=[f"{n}-{dt}-{'deltas' if d else 'plain'}"
                              for n, dt, d in LOSS_CASES])
def test_forward_loss_and_every_gradient_match_the_reference(
        name, dtype, with_deltas):
    fam = Family(name, dtype)
    np_d = _deltas(fam.np_params, 0.02, 3) if with_deltas else None
    d = None if np_d is None else lm_params_from_numpy(np_d, "cpu")
    jd = None if np_d is None else jax.tree.map(jnp.asarray, np_d)
    jb, tb = fam.jbatch(), fam.batch()

    want, _ = jax.jit(lambda p, b, dd: j_forward(p, fam.jcfg, b, deltas=dd))(
        fam.jparams, jb, jd)
    got, aux = forward(fam.params(), fam.cfg, tb, deltas=d)
    assert got.shape == (B, S, fam.cfg.padded_vocab) and float(aux) == 0.0
    _close(got, want, dtype, fam.cfg.vocab_size, "logits")

    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b, dd: j_loss_fn(p, fam.jcfg, b, deltas=dd), has_aux=True))(
        fam.jparams, jb, jd)
    g, (loss, m) = torch.func.grad_and_value(
        lambda p: loss_fn(p, fam.cfg, tb, deltas=d), has_aux=True)(
        fam.params())
    tol = F32_GRAD if dtype == "float32" else dict(rtol=BF16_ULP, atol=0)
    np.testing.assert_allclose(float(loss), float(jl), **tol)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), **tol)
    got_g, want_g = leaves(g), jax.tree.leaves(jg)
    names = [k for k in sorted(g) for _ in leaves(g[k])]   # top-level keys
    proj = "img_proj" if name == VLM else "frame_proj"
    assert proj in names and len(got_g) == len(want_g) == 13
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        assert a.dtype == getattr(torch, dtype) and a.shape == b.shape
        assert bool(torch.isfinite(a).all()), i
        if name == AUDIO and names[i] == "embed":
            # the encoder reads frames, never the token embedding
            assert not a.any() and not np.any(_np32(b))
            continue
        assert bool((a != 0).any()), i
        if dtype == "float32":
            np.testing.assert_allclose(_np32(a), _np32(b), err_msg=f"leaf {i}",
                                       **F32_GRAD)
        else:
            _within_ulps_of_max(a, _np32(b), BF16_ULPS, f"leaf {i}")


# ---------------------------------------------------------------------------
# serving: the VLM's prefill and decode, the encoder's encode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_and_decode_match_the_reference(dtype):
    """Prefill the image and the first text tokens, then decode four text
    tokens at positions P + S_text + i from the same cache."""
    fam = Family(VLM, dtype)
    P = fam.cfg.num_image_tokens
    S0 = S - N_DEC
    jb, tb = fam.jbatch(), fam.batch()
    jpre = {"tokens": jb["tokens"][:, :S0 - P],
            "image_embeds": jb["image_embeds"]}
    tpre = {"tokens": tb["tokens"][:, :S0 - P],
            "image_embeds": tb["image_embeds"]}
    jl, jc = jax.jit(lambda p, b: j_prefill(p, fam.jcfg, b))(fam.jparams,
                                                              jpre)
    params = fam.params()
    tl, tc = prefill(params, fam.cfg, tpre)
    assert tl.shape == (B, S0, fam.cfg.padded_vocab)
    V = fam.cfg.vocab_size
    _close(tl, jl, dtype, V, "prefill logits")
    for nm in ("k", "v"):
        assert tc[nm].shape == jc[nm].shape
        _close(tc[nm], jc[nm], dtype, what=f"cache {nm}")
    start = _decode_cache(jc, S0, S, 0)
    jcache = {k: jnp.asarray(v, fam.jcfg.dtype) for k, v in start.items()}
    tcache = {k: torch.from_numpy(v).to(fam.cfg.dtype)
              for k, v in start.items()}
    j_step = jax.jit(lambda p, t, c, pos: j_decode_step(p, fam.jcfg, t, c,
                                                        pos))
    for t in range(S0, S):
        i = t - P
        jl_t, jcache = j_step(fam.jparams, jb["tokens"][:, i:i + 1], jcache,
                              jnp.int32(t))
        tl_t, tcache = decode_step(params, fam.cfg, tb["tokens"][:, i:i + 1],
                                   tcache, t)
        _close(tl_t, jl_t, dtype, V, f"decode logits at {t}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_the_reference_forward(dtype):
    """`encode` (attention through `ops.attention`, non-causal) against the
    reference's encoder step, which is its `forward`."""
    fam = Family(AUDIO, dtype)
    want, _ = jax.jit(lambda p, b: j_forward(p, fam.jcfg, b))(fam.jparams,
                                                               fam.jbatch())
    ops.reset_launches()
    got = encode(fam.params(), fam.cfg, fam.batch())
    assert ops.LAUNCHES["flash_attention"] == fam.cfg.num_layers
    assert got.shape == (B, S, fam.cfg.padded_vocab)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype, fam.cfg.vocab_size, "logits")


def test_make_batch_shapes_and_dtypes():
    gen = torch.Generator().manual_seed(0)
    for dt in ("float32", "bfloat16"):
        cfg = get_smoke_config(AUDIO, param_dtype=dt)
        b = make_batch(cfg, 3, 40, gen)
        assert sorted(b) == ["frames", "targets"]
        assert b["frames"].shape == (3, 40, cfg.frame_embed_dim)
        assert b["frames"].dtype == cfg.dtype
        assert b["targets"].shape == (3, 40)
        assert b["targets"].dtype == torch.int64
        assert int(b["targets"].max()) < cfg.vocab_size
        cfg = get_smoke_config(VLM, param_dtype=dt)
        P = cfg.num_image_tokens
        b = make_batch(cfg, 3, 40, gen)
        assert sorted(b) == ["image_embeds", "targets", "tokens"]
        assert b["tokens"].shape == b["targets"].shape == (3, 40 - P)
        assert b["image_embeds"].shape == (3, P, cfg.image_embed_dim)
        assert b["image_embeds"].dtype == cfg.dtype
        assert b["tokens"].dtype == torch.int64
        with pytest.raises(ValueError, match="no text"):
            make_batch(cfg, 1, P, gen)


# ---------------------------------------------------------------------------
# the round trainer on launch/train.py's gradient
# ---------------------------------------------------------------------------

C, MU, ROUNDS = 4, 2, 3
# examples/train_lm_fasgd.py's operating point, with the kernels' slots on
POINT = dict(rule="fasgd", lr=0.01, c_fetch=0.5, use_fused_kernel=True)
ROUND_CASES = [(n, m) for n in NAMES for m in ("serial", "fused")]


def _j_grad_fn(jcfg):
    """The reference's `launch/train.py` gradient."""
    def grad_fn(p, batch):
        (loss, _), g = jax.value_and_grad(j_loss_fn, has_aux=True)(
            p, jcfg, batch)
        return loss, g
    return grad_fn


@pytest.mark.parametrize("name,mode", ROUND_CASES,
                         ids=[f"{n}-{m}" for n, m in ROUND_CASES])
def test_round_trainer_matches_the_reference(name, mode):
    fam = Family(name, "float32")
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
        nb = numpy_batch(fam.cfg, MU, S, 10 + r, lead=(C,))
        j_state, j_m = j_step(j_state, fam.jbatch(nb), keys[r])
        state, m = step(state, fam.batch(nb), draws.round(r))
        compare_metrics(m, j_m)
    compare_states(state, j_state)
    kernel = "fasgd_update" if mode == "serial" else "fused_event_apply"
    assert ops.LAUNCHES[kernel] == int(state.counters.kernel_launches) > 0


@pytest.mark.parametrize("name", NAMES)
def test_round_trainer_cotangent_refuses_modal_batches(name):
    """No event-batched loss threads the modal keys, so both packages
    refuse the cotangent path for these families."""
    kw = dict(num_round_clients=C, rule="asgd", drop_policy="discard",
              fused_mode="cotangent")
    fam = Family(name, "float32")
    with pytest.raises(ValueError, match="event-batched loss"):
        rt.build_round_step(TrainerConfig(**kw), make_dict_grad_fn(fam.cfg),
                            apply_mode="fused")
    with pytest.raises(ValueError, match="cotangent"):
        jrt.build_round_step(JTrainerConfig(**kw), _j_grad_fn(fam.jcfg),
                             apply_mode="fused")


# ---------------------------------------------------------------------------
# the reference's specs, on the port
# ---------------------------------------------------------------------------

def _port(name, batch=B, seq=S):
    cfg = get_smoke_config(name)
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, params, make_batch(cfg, batch, seq,
                                   torch.Generator().manual_seed(1))


@pytest.mark.parametrize("name", NAMES)
def test_full_config_matches_assignment(name):
    """FULL and SMOKE field for field as the reference's, the assigned
    hyperparameters, a citation."""
    spec = {VLM: (32, 3072, 32, 32, 8192, 32064, 96),
            AUDIO: (48, 1280, 16, 16, 5120, 504, 80)}[name]
    cfg = get_config(name)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.hd) == spec
    assert cfg.citation and cfg.dtype == torch.bfloat16
    for mine, ref in ((cfg, j_get_config(name)),
                      (get_smoke_config(name), j_get_smoke_config(name))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.hd == ref.hd and mine.padded_vocab == ref.padded_vocab
        assert mine.supports_decode() == ref.supports_decode()


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


def test_vlm_loss_only_on_text_positions():
    """The loss reads the text targets (S − P of them) and nothing of the
    image positions: new text targets change it, and the logits of the
    image positions do not enter it."""
    cfg, params, batch = _port(VLM, seq=64)
    assert batch["targets"].shape == (B, 64 - cfg.num_image_tokens)
    l0 = float(loss_fn(params, cfg, batch)[0])
    b2 = {**batch, "targets": (batch["targets"] + 1) % cfg.vocab_size}
    assert float(loss_fn(params, cfg, b2)[0]) != l0
    # the same CE from the forward's text positions alone
    logits, _ = forward(params, cfg, batch)
    text = logits[:, cfg.num_image_tokens:].float().log_softmax(-1)
    ce = -text.gather(-1, batch["targets"][..., None])[..., 0].mean()
    np.testing.assert_allclose(float(ce), l0, rtol=1e-5)


def test_encoder_is_bidirectional():
    """HuBERT: changing a late frame changes the first position's logits,
    through `forward` and through `encode`."""
    cfg, params, batch = _port(AUDIO, batch=1)
    moved = {**batch, "frames": batch["frames"].clone()}
    moved["frames"][:, -1] += 10.0
    for run in (lambda b: forward(params, cfg, b)[0],
                lambda b: encode(params, cfg, b)):
        a, b = run(batch), run(moved)
        assert not torch.allclose(a[:, 0], b[:, 0])


def test_encoder_has_no_decode():
    cfg, params, batch = _port(AUDIO, batch=1, seq=8)
    assert not cfg.supports_decode()
    with pytest.raises(ValueError, match="encoder-only"):
        prefill(params, cfg, batch)
    with pytest.raises(ValueError, match="encoder-only"):
        decode_step(params, cfg, torch.zeros(1, 1, dtype=torch.long),
                    {"k": None, "v": None}, 0)
    with pytest.raises(ValueError, match="encoder-only"):
        serve_mod.serve(cfg, params, torch.zeros(1, 4, dtype=torch.long), 2,
                        device="cpu")
    with pytest.raises(SystemExit):
        serve_mod.main(["--arch", AUDIO, "--smoke", "--device", "cpu"])
    vcfg, vparams, vbatch = _port(VLM)
    with pytest.raises(ValueError, match="decoder"):
        encode(vparams, vcfg, vbatch)


def test_decode_matches_forward():
    """phi-3-vision: prefill the image and the first text tokens, then
    decode the last four one by one; every step's logits match the full
    forward's at its position (the reference's
    `test_decode_matches_forward[phi-3-vision-4.2b]`)."""
    cfg, params, batch = _port(VLM)
    full, _ = forward(params, cfg, batch)
    P, S0 = cfg.num_image_tokens, S - N_DEC
    pre = {"tokens": batch["tokens"][:, :S0 - P],
           "image_embeds": batch["image_embeds"]}
    logits, cache = prefill(params, cfg, pre)
    np.testing.assert_allclose(_np32(logits), _np32(full[:, :S0]), **F32)
    cache = grow_cache(cfg, cache, S)
    for t in range(S0, S):
        tok = batch["tokens"][:, t - P:t - P + 1]
        lt, cache = decode_step(params, cfg, tok, cache, t)
        np.testing.assert_allclose(_np32(lt[:, 0]), _np32(full[:, t]), **F32)


def test_serve_vlm_greedy_follows_forward(capsys):
    """`serve` with image embeddings: positions count the image tokens,
    and each greedy token is the arg-max of the full forward over the
    image, the prompt and the tokens before it; the CLI serves the VLM
    with ``--prompt-len`` the total length."""
    cfg, params, batch = _port(VLM)
    ops.reset_launches()
    res = serve_mod.serve(cfg, params, batch["tokens"], 4, device="cpu",
                          image_embeds=batch["image_embeds"])
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers * 4
    assert res["prefill_logits"].shape[1] == S
    seq = torch.cat([batch["tokens"], res["tokens"][:, :-1]], dim=1)
    full, _ = forward(params, cfg, {"tokens": seq,
                                    "image_embeds": batch["image_embeds"]})
    assert torch.equal(res["tokens"], full[:, S - 1:].argmax(-1))
    with pytest.raises(ValueError, match="image_embeds"):
        serve_mod.serve(cfg, params, batch["tokens"], 2, device="cpu")
    out = serve_mod.main(["--arch", VLM, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "24", "--gen", "3",
                          "--temperature", "0"])
    assert out["tokens"].shape == (2, 3)
    assert out["prefill_logits"].shape[1] == 24
    assert "tok/s" in capsys.readouterr().out


def test_params_round_trip_with_the_projections():
    """The modality projections cross in both directions, dtypes kept;
    the init has the reference's tree, shapes and dtypes."""
    for name in NAMES:
        fam = Family(name, "bfloat16")
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
        proj = params["img_proj" if name == VLM else "frame_proj"]
        assert abs(float(proj.float().std()) - proj.shape[0] ** -0.5) < 0.01
    with pytest.raises(ValueError, match="not a dense LM"):
        lm_params_from_numpy({**fam.np_params, "img_proj": np.zeros(2)},
                             device="cpu")
