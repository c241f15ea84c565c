"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block.

Ported from `repro.models.ssm`.  The chunked SSD splits the sequence into
chunks of `cfg.ssm_chunk` positions: within a chunk the recurrence is
computed in its dual quadratic-attention form, and a loop over the chunk
*states* (a Python loop where the reference scans with `lax.scan`) carries
the recurrence across chunks: O(L·cs) work, L/cs sequential steps, the
naive recurrence (`ssd_naive`) to float32 rounding.  Decode is the
one-token recurrence on the cached state.  One group: B and C are shared
across heads.

Layout: d_inner = expand · d_model, heads H = d_inner / headdim P, state
width N; the input projection's columns are [z (d_inner), x (d_inner), B
(N), C (N), dt (H)], and the causal conv runs over [x, B, C].

The reference computes the SSD in plain JAX, outside any Pallas kernel, so
there is no TPU kernel to port here: it stays plain PyTorch (`einsum`,
`cumsum`, `exp`), all in float32, as the reference computes it.  Where
this differs in form, not in what it computes:
- the reference's three-operand einsums are contracted in a stated order
  (the elementwise product first, then one batched matmul), which sets
  both their memory and their float32 rounding against XLA's;
- `torch.nn.functional.softplus` returns x itself above 20, where
  `jax.nn.softplus` is log(1 + eˣ): the two differ there by less than
  log1p(e⁻²⁰) ≈ 2·10⁻⁹, below a float32 ulp of 20.
Everything on the training path is free of in-place writes, host syncs
and data-dependent control flow, so `torch.func.vmap` and `grad` go
through it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (delta_einsum, dense_init, dget, eff,
                                       rms_norm)


def init_ssm(generator, cfg, *, layers: int = 0, device=None):
    """{in_proj: [d, 2·d_inner + 2N + H], conv_w: [W, conv_dim], conv_b:
    zeros [conv_dim], A_log: log(linspace(1, 16, H)), D: ones [H],
    dt_bias: log(expm1(linspace(1e-3, 0.1, H))), out_norm: ones
    [d_inner], out_proj: [d_inner, d]} with conv_dim = d_inner + 2N,
    stacked over `layers` when > 0, as the reference initialises them."""
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = cfg.dtype
    dev = device or generator.device
    lead = (layers,) if layers else ()
    conv_dim = di + 2 * N
    kw = dict(layers=layers, device=device)

    def per_layer(vec):             # a float32 [n] vector, in every layer
        return vec.to(device=dev, dtype=dt).expand(lead + vec.shape).clone()
    return {
        "in_proj": dense_init(generator, (d, 2 * di + 2 * N + H), dt, **kw),
        "conv_w": dense_init(generator, (cfg.conv_width, conv_dim), dt, **kw),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dt, device=dev),
        "A_log": per_layer(torch.log(torch.linspace(1.0, 16.0, H))),
        "D": torch.ones(lead + (H,), dtype=dt, device=dev),
        "dt_bias": per_layer(torch.log(torch.expm1(
            torch.linspace(1e-3, 1e-1, H)))),
        "out_norm": torch.ones(lead + (di,), dtype=dt, device=dev),
        "out_proj": dense_init(generator, (di, d), dt, **kw),
    }


def _split(cfg, zxbcdt):
    """The input projection's columns → (z, xBC, dt)."""
    di, N = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
            zxbcdt[..., 2 * di + 2 * N:])


def _causal_conv(xbc, w, b):
    """Depthwise causal conv along the sequence, then SiLU.  xbc: [B, L,
    C]; w: [W, C]; b: [C].  The W taps sum in the input's dtype in the
    reference's order, 0 + t₀ + t₁ + …"""
    W, L = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + L, :] * w[i] for i in range(W))
    return F.silu(out + b)


def segsum_exp(a):
    """exp of segment sums: out[..., i, j] = exp(Σ_{j<m≤i} a_m) for i ≥ j,
    else 0.  a: [..., cs] → [..., cs, cs], lower triangular.

    The mask is applied *before* exp: the upper triangle's (large
    positive) sums would overflow, and their gradient would be inf·0 =
    nan."""
    cs = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    tril = torch.ones(cs, cs, dtype=torch.bool, device=a.device).tril()
    return torch.exp(torch.where(tril, diff, float("-inf")))


def ssd_chunked(x, dt, A, B, C, chunk_size: int, h0=None):
    """The SSD scan.  x: [b, L, H, P], dt: [b, L, H] (> 0), A: [H] (< 0),
    B, C: [b, L, N], float32.  Returns (y [b, L, H, P], h_final [b, H, P,
    N]).

    h_t = exp(dt·A)·h_{t−1} + dt·B_t ⊗ x_t;  y_t = C_t·h_t (the caller adds
    D·x).  A tail that does not fill a chunk is zero-padded with dt = 0
    (decay exp(0) = 1, input 0), which changes neither the states nor the
    real outputs.
    """
    b, L, H, P = x.shape
    N = B.shape[-1]
    cs = min(chunk_size, L)
    L0 = L
    pad = (-L) % cs
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        L += pad
    nc = L // cs

    xb = (x * dt[..., None]).reshape(b, nc, cs, H, P)     # dt-scaled input
    dA = (dt * A).reshape(b, nc, cs, H)                    # (< 0)
    Bc = B.reshape(b, nc, cs, N)
    Cc = C.reshape(b, nc, cs, N)

    # intra-chunk, the quadratic dual form: the reference's
    # "bcij,bchij,bcjhp->bcihp" as (scores · decay) first, an elementwise
    # [b, c, h, i, j] product, then one batched matmul over j
    Lmat = segsum_exp(dA.movedim(3, 2))                    # [b, c, H, i, j]
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores[:, :, None] * Lmat,
                          xb)

    # chunk states S_c = Σ_j exp(cum_last − cum_j) · B_j ⊗ xb_j: the
    # reference's "bcjn,bcjh,bcjhp->bchpn" as (decay · xb) first, then the
    # contraction over j
    cum = torch.cumsum(dA, dim=2)                          # [b, c, cs, H]
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    S = torch.einsum("bcjn,bcjhp->bchpn", Bc, decay_to_end[..., None] * xb)

    # the recurrence over chunk states; each chunk sees the state before it
    chunk_decay = torch.exp(cum[:, :, -1, :])              # [b, c, H]
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # [b, c, H, P, N]

    # the carried state's contribution to each position: the reference's
    # "bcin,bcih,bchpn->bcihp" as C·h first, then the decay
    state_decay = torch.exp(cum)                           # [b, c, cs, H]
    y_off = (torch.einsum("bcin,bchpn->bcihp", Cc, h_prevs)
             * state_decay[..., None])

    y = (y_diag + y_off).reshape(b, L, H, P)[:, :L0]
    return y, h


def ssd_naive(x, dt, A, B, C, h0=None):
    """The step-by-step recurrence, the oracle of the tests."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t] * A)                    # [b, H]
        h = h * decay[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t, :, None], B[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, C[:, t]))
    return torch.stack(ys, dim=1), h


def ssm_forward(p, cfg, x, h0=None, conv0=None, return_state: bool = False,
                dp=None):
    """The Mamba2 block over a full sequence.  x: [B, L, d] → [B, L, d].

    `h0` [B, H, P, N] (float32) and `conv0` [B, W − 1, conv_dim] start it
    from a carried state; with `return_state` it also returns {"h": [B, H,
    P, N] float32, "conv": [B, W − 1, conv_dim]}, the state after the last
    position.  `dp` optionally carries a stale parameter offset: the two
    large projections take the shared/delta split (`delta_einsum`), the
    small leaves (conv taps, A_log, D, dt_bias, out_norm) fold into
    effective parameters, as in the reference.
    """
    B_, L, _ = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    di = cfg.d_inner
    zxbcdt = delta_einsum("bld,dk->blk", x, p["in_proj"],
                          dget(dp, "in_proj"))
    z, xbc, dtr = _split(cfg, zxbcdt)
    conv_w = eff(p["conv_w"], dget(dp, "conv_w"))
    conv_b = eff(p["conv_b"], dget(dp, "conv_b"))
    if conv0 is not None:
        xbc_in = torch.cat([conv0, xbc], dim=1)
        conv_out = _causal_conv(xbc_in, conv_w, conv_b)[:, conv0.shape[1]:]
    else:
        conv_out = _causal_conv(xbc, conv_w, conv_b)
    xs = conv_out[..., :di].reshape(B_, L, H, P).float()
    Bmat = conv_out[..., di:di + N].float()
    Cmat = conv_out[..., di + N:].float()
    dt = F.softplus(dtr.float()
                    + eff(p["dt_bias"], dget(dp, "dt_bias")).float())
    A = -torch.exp(eff(p["A_log"], dget(dp, "A_log")).float())

    y, h_fin = ssd_chunked(xs, dt, A, Bmat, Cmat, cfg.ssm_chunk, h0=h0)
    y = y + eff(p["D"], dget(dp, "D")).float()[None, None, :, None] * xs
    y = y.reshape(B_, L, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), eff(p["out_norm"], dget(dp, "out_norm")),
                 cfg.norm_eps)
    out = delta_einsum("blk,kd->bld", y, p["out_proj"],
                       dget(dp, "out_proj"))
    if return_state:
        W = cfg.conv_width
        full = (torch.cat([conv0, xbc], dim=1) if conv0 is not None
                else F.pad(xbc, (0, 0, W - 1, 0)))
        return out, {"h": h_fin, "conv": full[:, -(W - 1):]}
    return out


def ssm_decode(p, cfg, x, state, pos=None):
    """The one-token recurrence.  x: [B, 1, d]; state {"h": [B, H, P, N]
    float32, "conv": [B, W − 1, conv_dim]} → (out [B, 1, d], the next
    state).  The next conv window is a new tensor (`conv_in[:, 1:]` of a
    fresh concatenation), so a caller may write it over the old one.
    `pos` is unused, as in the reference."""
    B_ = x.shape[0]
    H, P, N, di = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.d_inner
    zxbcdt = torch.einsum("bld,dk->blk", x, p["in_proj"])
    z, xbc, dtr = _split(cfg, zxbcdt)
    conv_in = torch.cat([state["conv"], xbc], dim=1)           # [B, W, C]
    conv_out = F.silu(torch.einsum("bwc,wc->bc", conv_in, p["conv_w"])
                      + p["conv_b"])                            # [B, C]
    xs = conv_out[:, :di].reshape(B_, H, P).float()
    Bmat = conv_out[:, di:di + N].float()
    Cmat = conv_out[:, di + N:].float()
    dt = F.softplus(dtr[:, 0].float() + p["dt_bias"].float())  # [B, H]
    A = -torch.exp(p["A_log"].float())

    decay = torch.exp(dt * A)
    h = state["h"] * decay[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xs * dt[..., None], Bmat)
    y = torch.einsum("bhpn,bn->bhp", h, Cmat)
    y = y + p["D"].float()[None, :, None] * xs
    y = y.reshape(B_, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    out = torch.einsum("blk,kd->bld", y, p["out_proj"])
    return out, {"h": h, "conv": conv_in[:, 1:]}
