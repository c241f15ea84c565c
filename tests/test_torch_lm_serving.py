"""The port's LM serving slice against a live run of the JAX reference.

Smoke `tinyllama-1.1b` (2 layers, d_model 256, 8 q heads over 2 kv heads,
head_dim 32, vocab 512): both packages run the same weights (the JAX
package's init, through numpy and `lm_params_from_numpy`) on the same
tokens.  The reference runs its own serving code (q-chunked `_sdpa` in
prefill, einsums over the cache in decode); the port runs
`kernels.ops.attention`, which on the CPU takes the kernel's plain version.

Tolerances:
- float32: logits and caches within atol 1e-5 / rtol 1e-5.  Both sides
  compute in float32; the frameworks order their BLAS sums and evaluate
  pow / sin / cos / rsqrt differently, which moves the last bits only
  (logits are O(1)).
- bfloat16: logits within rtol 2⁻⁷ (one bf16 ulp) / atol 2⁻⁶ (two ulps
  at the logits' size, |logit| < 2), caches within one ulp plus atol 1e-2.
  Every einsum, the residual adds and the SwiGLU product round to bf16 in
  both frameworks, but XLA's CPU code keeps some of them in float32 across
  fusions and PyTorch's does not, so a 1-ulp difference can enter at any of
  the ~20 roundings of the two layers; measured: 2⁻⁷ in the logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models.serving import decode_step as j_decode_step
from repro.models.serving import prefill as j_prefill
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_model as j_init_model

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models.api import make_batch, param_count
from repro_torch.models.serving import (decode_step, grow_cache, init_cache,
                                        prefill)
from repro_torch.models.transformer import forward, init_model
from repro_torch.utils.convert import (lm_params_from_numpy,
                                       lm_params_to_numpy)
from repro_torch.utils.trees import leaves

B, S, N_DEC = 2, 24, 4
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_LOGITS = dict(rtol=2 ** -7, atol=2 ** -6)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _setup(dtype="float32", window=0):
    jcfg = j_get_smoke_config("tinyllama-1.1b", param_dtype=dtype,
                              attn_window=window)
    cfg = get_smoke_config("tinyllama-1.1b", param_dtype=dtype,
                           attn_window=window)
    jparams = j_init_model(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    return jcfg, cfg, jparams, params, tokens


def _ring(cache, S0, W):
    """A [L, B, S0, ...] numpy prefill cache as a W-slot ring buffer:
    position p in slot p % W (positions before S0 - W dropped)."""
    out = np.zeros(cache.shape[:2] + (W,) + cache.shape[3:], cache.dtype)
    for p in range(max(0, S0 - W), S0):
        out[:, :, p % W] = cache[:, :, p]
    return out


def _decode_cache(pre_cache, S0, total, window):
    """The reference's prefill cache as the decode cache both packages
    start from (numpy float32, `total` slots or a `window`-slot ring)."""
    out = {}
    for name in ("k", "v"):
        c = _np32(pre_cache[name])
        if window:
            out[name] = _ring(c, S0, min(window, total))
        else:
            pad = np.zeros(c.shape[:2] + (total - S0,) + c.shape[3:],
                           np.float32)
            out[name] = np.concatenate([c, pad], axis=2)
    return out


@pytest.mark.parametrize("window", [0, 16], ids=["full", "window16"])
def test_serving_matches_reference_f32(window):
    jcfg, cfg, jparams, params, tokens = _setup(window=window)
    jt = jnp.asarray(tokens, jnp.int32)
    tt = torch.from_numpy(tokens)

    # forward (the full-sequence oracle)
    want, _ = j_forward(jparams, jcfg, {"tokens": jt})
    got, aux = forward(params, cfg, {"tokens": tt})
    np.testing.assert_allclose(_np32(got), _np32(want), **F32)
    assert float(aux) == 0.0

    # prefill: logits and cache
    S0 = S - N_DEC
    jl, jc = j_prefill(jparams, jcfg, {"tokens": jt[:, :S0]})
    tl, tc = prefill(params, cfg, {"tokens": tt[:, :S0]})
    np.testing.assert_allclose(_np32(tl), _np32(jl), **F32)
    for name in ("k", "v"):
        assert tc[name].shape == jc[name].shape
        np.testing.assert_allclose(_np32(tc[name]), _np32(jc[name]), **F32)

    # four decode steps from the same cache: logits and cache each step
    start = _decode_cache(jc, S0, S, window)
    jcache = {k: jnp.asarray(v) for k, v in start.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    worst = 0.0
    for t in range(S0, S):
        jl_t, jcache = j_decode_step(jparams, jcfg, jt[:, t:t + 1], jcache,
                                     jnp.int32(t))
        tl_t, tcache = decode_step(params, cfg, tt[:, t:t + 1], tcache, t)
        np.testing.assert_allclose(_np32(tl_t), _np32(jl_t), **F32)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np32(tcache[name]),
                                       _np32(jcache[name]), **F32)
        worst = max(worst, float(np.abs(_np32(tl_t) - _np32(jl_t)).max()))
    # `pytest -s` shows the parity reached (recorded in PERF.md)
    print(f"\nPARITY serving f32 window={window}: forward max|Δ| "
          f"{np.abs(_np32(got) - _np32(want)).max():.3e}, prefill "
          f"{np.abs(_np32(tl) - _np32(jl)).max():.3e}, decode {worst:.3e}")


def test_serving_matches_reference_bf16():
    jcfg, cfg, jparams, params, tokens = _setup(dtype="bfloat16")
    jt = jnp.asarray(tokens, jnp.int32)
    tt = torch.from_numpy(tokens)
    assert params["embed"].dtype == torch.bfloat16
    S0 = S - N_DEC
    jl, jc = j_prefill(jparams, jcfg, {"tokens": jt[:, :S0]})
    tl, tc = prefill(params, cfg, {"tokens": tt[:, :S0]})
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_np32(tl), _np32(jl), **BF16_LOGITS)
    for name in ("k", "v"):
        want = _np32(jc[name])
        np.testing.assert_allclose(_np32(tc[name]), want, rtol=2 ** -7,
                                   atol=1e-2)
    start = _decode_cache(jc, S0, S, 0)
    jcache = {k: jnp.asarray(v, jnp.bfloat16) for k, v in start.items()}
    tcache = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in start.items()}
    worst = 0.0
    for t in range(S0, S):
        jl_t, jcache = j_decode_step(jparams, jcfg, jt[:, t:t + 1], jcache,
                                     jnp.int32(t))
        tl_t, tcache = decode_step(params, cfg, tt[:, t:t + 1], tcache, t)
        np.testing.assert_allclose(_np32(tl_t), _np32(jl_t), **BF16_LOGITS)
        worst = max(worst, float(np.abs(_np32(tl_t) - _np32(jl_t)).max()))
    print(f"\nPARITY serving bf16: prefill max|Δ| "
          f"{np.abs(_np32(tl) - _np32(jl)).max():.3e}, decode {worst:.3e}")


@pytest.mark.parametrize("window", [0, 16], ids=["full", "window16"])
def test_prefill_then_decode_matches_forward(window):
    """The port alone: prefill S-4 tokens, grow the cache, decode 4; every
    step's logits match the full forward's (teacher forcing)."""
    _, cfg, _, params, tokens = _setup(window=window)
    tt = torch.from_numpy(tokens)
    full, _ = forward(params, cfg, {"tokens": tt})
    S0 = S - N_DEC
    logits, cache = prefill(params, cfg, {"tokens": tt[:, :S0]})
    np.testing.assert_allclose(_np32(logits), _np32(full[:, :S0]), **F32)
    cache = grow_cache(cfg, cache, S)
    for t in range(S0, S):
        lt, cache = decode_step(params, cfg, tt[:, t:t + 1], cache, t)
        np.testing.assert_allclose(_np32(lt[:, 0]), _np32(full[:, t]), **F32)


def test_grow_cache_places_ring_slots():
    cfg = get_smoke_config("tinyllama-1.1b", attn_window=8)
    L, Kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
    pos = torch.arange(13, dtype=torch.float32)
    pre = {n: pos[None, None, :, None, None].expand(L, 1, 13, Kv, hd).clone()
           for n in ("k", "v")}
    ring = grow_cache(cfg, pre, 40)
    assert ring["k"].shape == (L, 1, 8, Kv, hd)
    # slot s holds the latest prompt position p < 13 with p % 8 == s
    want = torch.tensor([8, 9, 10, 11, 12, 5, 6, 7], dtype=torch.float32)
    assert torch.equal(ring["k"][0, 0, :, 0, 0], want)
    full = grow_cache(get_smoke_config("tinyllama-1.1b"), pre, 20)
    assert full["v"].shape[2] == 20
    assert torch.equal(full["v"][0, 0, :13, 0, 0], pos)
    assert not full["v"][:, :, 13:].any()


def test_launches_two_per_prefill_and_per_decode_step():
    _, cfg, _, params, tokens = _setup()
    tt = torch.from_numpy(tokens)
    ops.reset_launches()
    _, cache = prefill(params, cfg, {"tokens": tt[:, :8]})
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers == 2
    cache = grow_cache(cfg, cache, 12)
    for t in range(8, 11):
        _, cache = decode_step(params, cfg, tt[:, t:t + 1], cache, t)
    assert ops.LAUNCHES["flash_attention"] == 2 + 2 * 3
    assert ops.LAUNCHES["fasgd_update"] == ops.LAUNCHES["fused_event_apply"] == 0


def test_serve_greedy_follows_forward():
    """`serve` at temperature 0: each generated token is the arg-max of the
    full forward over the prompt and the tokens before it."""
    _, cfg, _, params, tokens = _setup()
    prompt = torch.from_numpy(tokens[:, :12])
    ops.reset_launches()
    res = serve_mod.serve(cfg, params, prompt, 5, device="cpu")
    assert res["tokens"].shape == (B, 5)
    assert ops.LAUNCHES["flash_attention"] == 2 + 2 * 4
    seq = torch.cat([prompt, res["tokens"][:, :-1]], dim=1)
    full, _ = forward(params, cfg, {"tokens": seq})
    want = full[:, 11:].argmax(-1)
    assert torch.equal(res["tokens"], want)
    assert res["prefill_s"] > 0 and res["decode_s"] > 0
    # sampling at T > 0 is reproducible from its seed
    a = serve_mod.serve(cfg, params, prompt, 3, temperature=1.0, seed=3,
                        device="cpu")["tokens"]
    b = serve_mod.serve(cfg, params, prompt, 3, temperature=1.0, seed=3,
                        device="cpu")["tokens"]
    assert torch.equal(a, b)


def test_serve_cli_runs_on_the_cpu(capsys):
    res = serve_mod.main(["--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "8", "--gen", "3",
                          "--temperature", "0"])
    assert res["tokens"].shape == (2, 3)
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode:" in out and "tok/s" in out


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = get_smoke_config("tinyllama-1.1b")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(gen, cfg)
    params = init_model(gen, cfg, device="cpu")
    tokens = make_batch(cfg, 1, 4, gen)["tokens"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.serve(cfg, params, tokens, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_params_from_numpy(lm_params_to_numpy(params))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--smoke"])


def test_init_model_has_the_reference_geometry():
    """Port-native init: the reference's tree, shapes, dtypes and scales."""
    cfg = get_smoke_config("tinyllama-1.1b", param_dtype="bfloat16")
    jcfg = j_get_smoke_config("tinyllama-1.1b", param_dtype="bfloat16")
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    jparams = jax.eval_shape(lambda: j_init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    got = lm_params_to_numpy(params)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(jparams)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
    assert param_count(params) == sum(w.size for _, w in flat_want)
    d = cfg.d_model
    std = lambda t: float(t.float().std())
    assert abs(std(params["embed"]) - 0.02) < 0.002
    assert abs(std(params["unembed"]) - 0.02) < 0.002
    assert abs(std(params["layers"]["attn"]["wq"]) - d ** -0.5) < 0.005
    assert abs(std(params["layers"]["mlp"]["w_down"]) - cfg.d_ff ** -0.5) < 0.005
    assert torch.equal(params["layers"]["ln1"], torch.ones(2, d,
                                                           dtype=torch.bfloat16))


def test_lm_params_round_trip_keeps_dtypes():
    _, _, jparams, params, _ = _setup(dtype="bfloat16")
    back = lm_params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(jax.tree.map(np.asarray, jparams))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.int16), b.view(np.int16))
    assert all(t.dtype == torch.bfloat16 for t in leaves(params))
    with pytest.raises(ValueError, match="not a dense LM"):
        lm_params_from_numpy({"w": np.zeros(2)}, device="cpu")


def test_configs_mirror_the_reference():
    from repro.configs import get_config as j_get_config
    for name in ("tinyllama-1.1b", "llama3-8b", "yi-9b", "yi-34b"):
        cfg, jcfg = get_config(name), j_get_config(name)
        for f in dataclasses.fields(cfg):
            if f.name != "param_dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.hd == jcfg.hd and cfg.padded_vocab == jcfg.padded_vocab
        assert cfg.dtype == torch.bfloat16 and cfg.supports_decode()
    full = get_config("tinyllama-1.1b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.hd, full.d_ff, full.vocab_size) == (22, 2048, 32, 4, 64,
                                                     5632, 32000)
    # the MoE family is ported: field for field the reference's
    for name in ("grok-1-314b", "deepseek-v2-236b"):
        cfg, jcfg = get_config(name), j_get_config(name)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.is_moe and cfg.hd == jcfg.hd
    # the SSM and hybrid families are ported: field for field the
    # reference's
    for name in ("mamba2-1.3b", "zamba2-7b"):
        cfg, jcfg = get_config(name), j_get_config(name)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert (cfg.d_inner, cfg.ssm_heads, cfg.supports_long_context()) == (
            jcfg.d_inner, jcfg.ssm_heads, jcfg.supports_long_context())
    with pytest.raises(ValueError, match="unknown arch_type"):
        dataclasses.replace(full, arch_type="rnn")


def test_mask_vocab_pad_and_padded_vocab():
    from repro_torch.models.transformer import mask_vocab_pad
    cfg = get_smoke_config("tinyllama-1.1b", vocab_size=500)
    assert cfg.padded_vocab == 512
    out = mask_vocab_pad(cfg, torch.zeros(1, 1, 512))
    assert (out[..., 500:] == -1e30).all() and (out[..., :500] == 0).all()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    logits, cache = prefill(params, cfg, {"tokens": torch.zeros(1, 3,
                                                                dtype=torch.long)})
    assert logits.shape == (1, 3, 512) and (logits[..., 500:] == -1e30).all()
    assert init_cache(cfg, 1, 3, device="cpu")["k"].shape == cache["k"].shape
