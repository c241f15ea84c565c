"""The flash-attention kernel's plain version and dispatch, on the CPU,
against the JAX reference.

`repro_torch.kernels.ref.attention_ref` is what `ops.attention` runs on a
CPU tensor, and what `chip_smoke.py` holds the CUDA kernel against on the
card.  Here it is held against the JAX package's Pallas kernel, run in
interpret mode as `tests/test_kernels_flash.py` runs it, and against the JAX
`attention_ref`, over that file's sweep: causal square L ∈ {128, 200
(ragged), 256}, GQA (8,2) / (8,1) / (4,4), windows {64, 200}, non-causal,
Lq < Lk, D ∈ {64, 128}, fp32 and bf16; at the head dims the kernel pads
in shared memory, D ∈ {80, 96, 112} (hubert-xlarge, phi-3-vision-4.2b,
zamba2-7b's shared attention), causal
and not, prefill and decode shapes; and at D = 192, deepseek-v2's MLA
prefill (128 + 64 rope columns, V padded with 64 zero columns).  Inputs
come from numpy, seeded.

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


PADDED_DIMS = [(D, dt, causal) for D in (80, 96, 112)
               for dt in ("float32", "bfloat16") for causal in (True, False)]


@pytest.mark.parametrize("D,dtype,causal", PADDED_DIMS,
                         ids=[f"D{D}-{dt}-{'causal' if c else 'bidir'}"
                              for D, dt, c in PADDED_DIMS])
def test_padded_head_dims(D, dtype, causal):
    """D = 80 (hubert-xlarge), 96 (phi-3-vision-4.2b) and 112 (zamba2-7b's
    shared attention block): MHA over a
    ragged L = 136 and a GQA decode query, the scale 1/√D of the true D."""
    _run(_qkv(1, 4, 4, 136, 136, D, seed=D), dtype, causal=causal)
    _run(_qkv(2, 8, 2, 1, 150, D, seed=D + 1), dtype, causal=causal)


MLA_CASES = [(dt, causal) for dt in ("float32", "bfloat16")
             for causal in (True, False)]


@pytest.mark.parametrize("dtype,causal", MLA_CASES,
                         ids=[f"{dt}-{'causal' if c else 'bidir'}"
                              for dt, c in MLA_CASES])
def test_mla_head_dim_192(dtype, causal):
    """D = 192 (deepseek-v2-236b's MLA prefill folds 64 rope columns into
    its 128-wide heads): MHA over a ragged L = 136, GQA and MHA decode
    queries, the scale 1/√192; then V with its last 64 columns zero, as
    `attention.mla_prefill` pads it, whose output columns come out 0 and
    whose first 128 columns are the attention over the unpadded V."""
    _run(_qkv(1, 4, 4, 136, 136, 192, seed=192), dtype, causal=causal)
    _run(_qkv(2, 8, 2, 1, 150, 192, seed=193), dtype, causal=causal)
    _run(_qkv(1, 4, 4, 16, 150, 192, seed=194), dtype, causal=causal)
    q, k, v = _qkv(1, 4, 4, 72, 72, 192, seed=195)
    v[..., 128:] = 0.0
    _run((q, k, v), dtype, causal=causal)
    T = torch.from_numpy
    got = ref.attention_ref(T(q), T(k), T(v), causal=causal)
    assert not got[..., 128:].any()
    # the first 128 columns are P·V over the 128 real columns alone: the
    # kernel's padding and the reference's pad agree
    scale = 1.0 / 192 ** 0.5
    s = torch.einsum("bhqd,bhkd->bhqk", T(q), T(k)) * scale
    if causal:
        s = s.masked_fill(torch.ones(72, 72, dtype=torch.bool).triu(1),
                          float("-inf"))
    want = torch.einsum("bhqk,bhkd->bhqd", s.softmax(-1), T(v)[..., :128])
    torch.testing.assert_close(got[..., :128], want, **F32)


@pytest.mark.parametrize("D", [48, 144, 160])
def test_the_card_refuses_other_head_dims(monkeypatch, D):
    """On the card `ops.attention` takes D in {32, 64, 80, 96, 112, 128,
    192}
    and raises for any other, before a launch and with no fallback to the
    plain version (the card's branch is taken with `_device_kind`
    monkeypatched, as `tests/test_torch_lm_training.py` does)."""
    monkeypatch.setattr(ops, "_device_kind", lambda t: "cuda")
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 8, 8, D, seed=D))
    with pytest.raises(ValueError, match=f"head dim {D} not in"):
        ops.attention(q, k, v)
    assert ops._HEAD_DIMS == (32, 64, 80, 96, 112, 128, 192)


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


# --- the bf16 tensor-core prefill kernel's numerics, emulated on the CPU ---

def _bf16_round(x):
    return x.to(torch.bfloat16).float()


def _bf16_trunc(x):
    """x with its low 16 bits cleared: bf16 by truncation, as the kernel's
    P_hi (integer ops on the fp32 bits)."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _tensor_core_emulation(q, k, v, *, causal, window, split, tile=64,
                           scale_dim=None):
    """What `flash_wgmma_kernel` computes, in torch on the CPU: bf16 inputs
    (given as their fp32 values), fp32 scores, an online softmax over
    64-key tiles in log2 units, P either split into P_hi = trunc_bf16(P)
    and P_lo = bf16(P - P_hi) (`split`) or rounded once to bf16, both
    products accumulated in fp32, one division by l, one rounding to bf16.

    A head dim D that is no multiple of 64 lies in shared memory padded
    with zero columns to DP = 128: S = Q·Kᵀ runs D/16 k16 steps over the
    real columns, P·V runs over all DP columns of V, and only the first D
    output columns are stored (the rest come out 0, which is checked).
    The scale is 1/√D of the true D (`scale_dim` overrides it, to show the
    check bites)."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    DP = -(-D // 64) * 64
    pad = lambda t: torch.nn.functional.pad(t, (0, DP - D))
    kk = torch.repeat_interleave(k, Hq // Hkv, dim=1)
    vv = pad(torch.repeat_interleave(v, Hq // Hkv, dim=1))
    sl2 = (1.0 / (scale_dim or D) ** 0.5) * 1.4426950408889634
    qpos = torch.arange(Lq)[:, None] + (Lk - Lq)
    m = torch.full((B, Hq, Lq, 1), -1e30)
    l = torch.zeros((B, Hq, Lq, 1))
    acc = torch.zeros((B, Hq, Lq, DP))
    for kb in range(0, Lk, tile):
        kpos = torch.arange(kb, min(kb + tile, Lk))[None, :]
        vis = torch.ones((Lq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            vis &= kpos <= qpos
        if window:
            vis &= kpos > qpos - window
        s = torch.einsum("bhqd,bhkd->bhqk", q, kk[:, :, kb:kb + tile])
        s = torch.where(vis, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * sl2)
        msc = torch.where(m_new == -1e30, torch.tensor(0.0), m_new * sl2)
        p = torch.exp2(s * sl2 - msc)
        l = corr * l + p.sum(-1, keepdim=True)
        parts = ((_bf16_trunc(p), _bf16_round(p - _bf16_trunc(p))) if split
                 else (_bf16_round(p),))
        acc = acc * corr
        for part in parts:
            acc = acc + part @ vv[:, :, kb:kb + tile]
        m = m_new
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0),
                      torch.tensor(0.0))
    assert not out[..., D:].any()          # V's zero columns give zeros
    return _bf16_round(out[..., :D])


def _allowance_share(got, want32):
    """Worst share of `chip_smoke.py`'s bf16 allowance (`attention_check`):
    one bf16 ulp of the fp32 plain version rounded once, plus 1e-5."""
    want = _bf16_round(want32)
    mag = want.abs().clamp(min=torch.finfo(torch.float32).tiny)
    allowed = torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5
    return float(((got - want).abs() / allowed).max())


@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("split", [True, False], ids=["P_split", "P_once"])
def test_tensor_core_numerics_need_p_split(window, split):
    """Why the bf16 prefill kernel feeds P·V two bf16 parts of P.

    Seeded normal q, k, v rounded to bf16, B=1, Hq=8 over Hkv=2, L=1024,
    D=64, causal, with and without a window over several 64-key tiles.  The
    kernel's roundings, emulated, are held to the criterion `chip_smoke.py`
    holds the card to: within one bf16 ulp of the fp32 plain version rounded
    once, plus 1e-5.  That allowance is the one-ulp rounding flip that any
    fp32 reordering may cause where the fp32 value sits near a bf16
    midpoint.  With P split (P_hi = P truncated to bf16, P_lo = bf16(P −
    P_hi): ~16 bits of P) the emulation stays within it; with P rounded once
    to bf16 (8 bits) near-zero outputs carry P's rounding error, which their
    own ulp cannot absorb, and the criterion fails.
    """
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 1024, 1024, 64,
                                                  seed=11))
    q, k, v = _bf16_round(q), _bf16_round(k), _bf16_round(v)
    want32 = ref.attention_ref(q, k, v, causal=True, window=window)
    got = _tensor_core_emulation(q, k, v, causal=True, window=window,
                                 split=split)
    share = _allowance_share(got, want32)
    print(f"\nEMULATION P {'split' if split else 'once'} window={window}: "
          f"worst share of the bf16 allowance {share:.3f}")
    if split:
        assert share <= 1.0
    else:
        assert share > 1.0


@pytest.mark.parametrize("window", [0, 300])
def test_tensor_core_numerics_at_padded_head_dim(window):
    """D = 96 (phi-3-vision-4.2b), padded to two 64-column halves with
    zero columns: the emulated kernel, P split, stays within the bf16
    allowance `test_tensor_core_numerics_need_p_split` states, causal over
    1024 keys with and without a window; the same emulation with the scale
    of the padded width (1/√128) is caught by the criterion."""
    q, k, v = (_bf16_round(torch.from_numpy(a))
               for a in _qkv(1, 8, 2, 1024, 1024, 96, seed=13))
    want32 = ref.attention_ref(q, k, v, causal=True, window=window)
    got = _tensor_core_emulation(q, k, v, causal=True, window=window,
                                 split=True)
    share = _allowance_share(got, want32)
    print(f"\nEMULATION D=96 padded to 128, window={window}: worst share "
          f"of the bf16 allowance {share:.3f}")
    assert share <= 1.0
    bad = _tensor_core_emulation(q, k, v, causal=True, window=window,
                                 split=True, scale_dim=128)
    assert _allowance_share(bad, want32) > 1.0


@pytest.mark.parametrize("window", [0, 300])
def test_tensor_core_numerics_at_head_dim_112(window):
    """D = 112 (zamba2-7b's shared attention, MHA), padded to two 64-column
    halves with 16 zero columns, S as 7 k16 steps: the emulated kernel, P
    split, stays within the bf16 allowance
    `test_tensor_core_numerics_need_p_split` states, causal over 1024 keys
    with and without a window; with the scale of the padded width
    (1/√128) the criterion catches it."""
    q, k, v = (_bf16_round(torch.from_numpy(a))
               for a in _qkv(1, 8, 8, 1024, 1024, 112, seed=16))
    want32 = ref.attention_ref(q, k, v, causal=True, window=window)
    got = _tensor_core_emulation(q, k, v, causal=True, window=window,
                                 split=True)
    share = _allowance_share(got, want32)
    print(f"\nEMULATION D=112 padded to 128, window={window}: worst share "
          f"of the bf16 allowance {share:.3f}")
    assert share <= 1.0
    bad = _tensor_core_emulation(q, k, v, causal=True, window=window,
                                 split=True, scale_dim=128)
    assert _allowance_share(bad, want32) > 1.0


def test_tensor_core_numerics_at_head_dim_192():
    """D = 192 (deepseek-v2-236b's MLA prefill), three 64-column parts with
    no padding and P·V as m64n192k16: the emulated kernel, P split, stays
    within the bf16 allowance `test_tensor_core_numerics_need_p_split`
    states, causal over 512 keys with V's last 64 columns zero, as the
    model pads it."""
    q, k, v = (_bf16_round(torch.from_numpy(a))
               for a in _qkv(1, 4, 4, 512, 512, 192, seed=14))
    v[..., 128:] = 0.0
    want32 = ref.attention_ref(q, k, v, causal=True)
    got = _tensor_core_emulation(q, k, v, causal=True, window=0, split=True)
    share = _allowance_share(got, want32)
    print(f"\nEMULATION D=192: worst share of the bf16 allowance {share:.3f}")
    assert share <= 1.0 and not got[..., 128:].any()


# --- the decode kernel's key splits and merge, emulated on the CPU ---

def _split_decode_emulation(q, k, v, *, causal, window, chunk=128,
                            splits=17):
    """What `flash_decode_kernel` + `flash_decode_merge` compute, in fp32:
    the visible key range cut into `splits` runs of whole `chunk`-key
    chunks, each run's (m, l, unnormalised acc) from its own softmax, then
    o = Σ_s acc_s·e^(m_s − M) / Σ_s l_s·e^(m_s − M), 0 where no run saw a
    key (every m_s is −1e30 and every l_s is 0)."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    kk = torch.repeat_interleave(k, Hq // Hkv, dim=1)
    vv = torch.repeat_interleave(v, Hq // Hkv, dim=1)
    qpos = torch.arange(Lq)[:, None] + (Lk - Lq)
    begin = max(0, Lk - Lq - window + 1) if window else 0
    nchunks = max(1, -(-(Lk - begin) // chunk))
    cps = -(-nchunks // min(splits, nchunks))
    parts = []
    for lo in range(begin, Lk, cps * chunk):
        hi = min(lo + cps * chunk, Lk)
        kpos = torch.arange(lo, hi)[None, :]
        vis = torch.ones((Lq, hi - lo), dtype=torch.bool)
        if causal:
            vis &= kpos <= qpos
        if window:
            vis &= kpos > qpos - window
        s = torch.einsum("bhqd,bhkd->bhqk", q, kk[:, :, lo:hi]) / D ** 0.5
        s = torch.where(vis, s, torch.tensor(-1e30))
        m = s.amax(-1, keepdim=True)
        p = torch.where(vis, torch.exp(s - m), torch.tensor(0.0))
        parts.append((m, p.sum(-1, keepdim=True), p @ vv[:, :, lo:hi]))
    mm = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - mm) for m, _, _ in parts]
    ll = sum(l * x for (_, l, _), x in zip(parts, w))
    out = sum(a * x for (_, _, a), x in zip(parts, w))
    return torch.where(ll > 0, out / torch.where(ll > 0, ll, 1.0),
                       torch.tensor(0.0))


@pytest.mark.parametrize("Lq,Lk,window,Hkv", [
    (1, 2079, 0, 4),      # the main path's decode step
    (4, 1001, 300, 2),    # a window: the first runs see no key
    (16, 1001, 300, 2),
    (8, 5, 0, 1),         # Lq > Lk: rows with no visible key give 0
])
def test_decode_key_splits_merge_to_the_plain_version(Lq, Lk, window, Hkv):
    """The flash-decoding split and merge (`flash_decode_kernel` with
    `flash_decode_merge`), emulated in fp32, against the plain version:
    within the fp32 tolerance atol 1e-5 / rtol 1e-5 (`chip_smoke.py`'s), the
    two differing only in the order of their sums."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, Hkv, Lq, Lk, 64,
                                                  seed=12))
    got = _split_decode_emulation(q, k, v, causal=True, window=window)
    want = ref.attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("Lq,Hkv", [(1, 8), (16, 2)])
def test_decode_key_splits_merge_at_head_dim_192(Lq, Hkv):
    """The same split and merge at D = 192 (the decode kernel's
    instantiation for a deepseek-v2 prompt of at most 16 tokens), MHA and
    GQA 4/1 over 2079 keys, within atol 1e-5 / rtol 1e-5."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, Hkv, Lq, 2079, 192,
                                                  seed=15))
    got = _split_decode_emulation(q, k, v, causal=True, window=0)
    torch.testing.assert_close(got, ref.attention_ref(q, k, v), **F32)


@pytest.mark.parametrize("Lq,Hkv", [(1, 32), (16, 8)])
def test_decode_key_splits_merge_at_head_dim_112(Lq, Hkv):
    """The same split and merge at D = 112 (zamba2-7b's decode: MHA with
    32 heads over 2079 keys; and Lq = 16 with GQA 4/1), within atol 1e-5 /
    rtol 1e-5."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 32, Hkv, Lq, 2079, 112,
                                                  seed=17))
    got = _split_decode_emulation(q, k, v, causal=True, window=0)
    torch.testing.assert_close(got, ref.attention_ref(q, k, v), **F32)
