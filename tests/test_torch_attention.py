"""The flash-attention kernel's plain version and dispatch, on the CPU,
against the JAX reference.

`repro_torch.kernels.ref.attention_ref` is what `ops.attention` runs on a
CPU tensor, and what `chip_smoke.py` holds the CUDA kernel against on the
card.  Here it is held against the JAX package's Pallas kernel, run in
interpret mode as `tests/test_kernels_flash.py` runs it, and against the JAX
`attention_ref`, over that file's sweep: causal square L ∈ {128, 200
(ragged), 256}, GQA (8,2) / (8,1) / (4,4), windows {64, 200}, non-causal,
Lq < Lk, D ∈ {64, 128}, fp32 and bf16.  Inputs come from numpy, seeded.

Tolerances:
- fp32: atol 1e-5 / rtol 1e-5 against both.  All three take exact softmax
  attention in float32; the kernel's online softmax and the einsums sum in
  other orders, which moves the last bits (|o| ≤ ~3).
- bf16: within one bf16 ulp of the reference output, plus the fp32 atol
  1e-5.  All three compute in float32 from the same bf16 inputs and round
  once at the end; an fp32 difference of a few 1e-7 can flip that rounding
  by one ulp where the float32 value sits near a midpoint, and near 0 the
  float32 sums' absolute noise is larger than the ulp itself.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ref import attention_ref as j_attention_ref

from repro_torch.kernels import ops, ref

F32 = dict(rtol=1e-5, atol=1e-5)


def _qkv(B, Hq, Hkv, Lq, Lk, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (8 significant bits)."""
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        d = np.abs(got - want)
        assert np.all(d <= _bf16_ulp(want) + F32["atol"]), (
            f"bf16 max|Δ| {d.max():.3e}, {np.max(d / _bf16_ulp(want)):.2f} ulp")
    return float(np.max(np.abs(got - want)))


def _run(qkv, dtype="float32", causal=True, window=0):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in qkv)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in qkv)
    got = ref.attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == tq.shape
    got = got.float().numpy()
    flash = j_flash(jq, jk, jv, causal=causal, window=window, interpret=True)
    oracle = j_attention_ref(jq, jk, jv, causal=causal, window=window)
    e1 = _close(got, flash, dtype)
    e2 = _close(got, oracle, dtype)
    # `pytest -s` shows the parity reached (recorded in PERF.md)
    print(f"\nPARITY attention_ref {dtype} max|Δ| vs flash(interpret) "
          f"{e1:.3e}, vs jnp oracle {e2:.3e}")


@pytest.mark.parametrize("L", [128, 200, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_square(L, dtype):
    _run(_qkv(2, 4, 4, L, L, 64, seed=L), dtype)


@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (8, 1), (4, 4)])
def test_gqa_grouping(Hq, Hkv):
    _run(_qkv(2, Hq, Hkv, 256, 256, 64, seed=1))


@pytest.mark.parametrize("window", [64, 200])
def test_sliding_window(window):
    _run(_qkv(1, 2, 2, 256, 256, 64, seed=2), window=window)


def test_non_causal():
    _run(_qkv(2, 4, 4, 256, 256, 64, seed=3), causal=False)


def test_queries_at_the_end_of_the_kv_axis():
    """Lq < Lk: the queries are the LAST Lq positions of the kv axis."""
    _run(_qkv(2, 4, 2, 128, 384, 64, seed=5))


@pytest.mark.parametrize("D", [64, 128])
def test_head_dims(D):
    _run(_qkv(1, 2, 2, 128, 128, D, seed=6))


def test_decode_shape_window_bf16():
    """Lq = 1 over a ragged kv axis (the decode call), windowed, bf16."""
    _run(_qkv(2, 8, 2, 1, 200, 64, seed=7), "bfloat16", window=64)


def test_rows_with_no_visible_key_are_zero():
    """Lq > Lk, causal: the first Lq − Lk queries see no key and output 0,
    as both JAX paths give.  (The reference's model `_sdpa` would average
    every v instead; no model path produces such a row.)"""
    q, k, v = _qkv(1, 2, 1, 40, 24, 32, seed=8)
    T = torch.from_numpy
    got = ref.attention_ref(T(q), T(k), T(v), causal=True).numpy()
    assert not got[:, :, :16].any() and np.abs(got[:, :, 16:]).min() > 0
    _close(got, j_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True), "float32")


def test_ops_attention_on_the_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version: same values, counted once per
    call; permuted views (the model's layout) give the same result."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 8, 2, 48, 48, 32, seed=9))
    ops.reset_launches()
    got = ops.attention(q, k, v, causal=True, window=16)
    assert ops.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, window=16),
                               rtol=0, atol=0)
    views = [t.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
             for t in (q, k, v)]
    assert not views[0].is_contiguous()
    got2 = ops.attention(*views, causal=True, window=16)
    assert ops.LAUNCHES["flash_attention"] == 2
    torch.testing.assert_close(got2, got, **F32)
    # an explicit scale goes through unchanged
    got3 = ops.attention(q, k, v, causal=False, sm_scale=0.3)
    torch.testing.assert_close(
        got3, ref.attention_ref(q, k, v, causal=False, sm_scale=0.3),
        rtol=0, atol=0)
