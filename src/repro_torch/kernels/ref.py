"""Plain PyTorch versions of the kernels: the three server updates and
attention.

Ported from `repro.kernels.ref`.  `kernels.ops` takes these for tensors
that lie on the CPU; the tests hold them against the interpreted Pallas
kernels, and `chip_smoke.py` holds the CUDA kernels against them on the
card.  Nothing on a main path runs them when a card is present.
"""
from __future__ import annotations

import torch


def fasgd_update_ref(params, grads, n, b, v, lr, tau,
                     *, gamma=0.9, beta=0.9, eps=1e-8, variant="intent"):
    """Unfused FASGD server update (paper eqs. 4–8) on one leaf.

    Returns (new_params, new_n, new_b, new_v); `tau` is a float or a device
    scalar (no host sync).
    """
    g = grads.float()
    n_new = gamma * n + (1.0 - gamma) * g * g
    b_new = gamma * b + (1.0 - gamma) * g
    std = torch.sqrt(torch.clamp(n_new - b_new ** 2, min=0.0) + eps)
    if variant == "intent":
        v_new = beta * v + (1.0 - beta) * std
    else:
        v_new = beta * v + (1.0 - beta) / std
    tau = torch.as_tensor(tau, dtype=torch.float32, device=g.device)
    scale = lr / (v_new * tau + eps)
    p_new = (params.float() - scale * g).to(params.dtype)
    return p_new, n_new, b_new, v_new


def fused_event_apply_ref(params, grads, n, b, v, weights, wmean, taus, lr,
                          has_push, *, gamma=0.9, beta=0.9, eps=1e-8,
                          variant="intent", mode="fasgd", track_stats=True):
    """One K-event server apply on one leaf: the mean-gradient statistics
    step (eqs. 4-6, held still when nothing pushed), then the weighted delta
    against the POST-stats v.

    `grads` is [K, *shape]; `weights`/`wmean`/`taus` are [K] and `has_push`
    a scalar, all possibly on the device.  Like the reference, the event
    axis is contracted with einsum for ḡ and for the 'coeff' delta, and
    walked in order for fasgd's elementwise eq. 7 scale.  Returns
    (params', n', b', v') with the statistics in float32.
    """
    g32 = grads.float()
    w = torch.as_tensor(weights, dtype=torch.float32, device=g32.device)
    t = torch.as_tensor(taus, dtype=torch.float32, device=g32.device)
    if track_stats:
        wm = torch.as_tensor(wmean, dtype=torch.float32, device=g32.device)
        gbar = torch.einsum("k,k...->...", wm, g32)
        n1 = gamma * n + (1.0 - gamma) * gbar * gbar
        b1 = gamma * b + (1.0 - gamma) * gbar
        std = torch.sqrt(torch.clamp(n1 - b1 * b1, min=0.0) + eps)
        if variant == "intent":
            v1 = beta * v + (1.0 - beta) * std
        else:
            v1 = beta * v + (1.0 - beta) / std
        keep = torch.as_tensor(has_push, device=g32.device).to(torch.bool)
        n1 = torch.where(keep, n1, n)
        b1 = torch.where(keep, b1, b)
        v1 = torch.where(keep, v1, v)
    else:
        n1, b1, v1 = n, b, v
    if mode == "coeff":
        delta = torch.einsum("k,k...->...", w, g32)
    else:
        delta = torch.zeros(g32.shape[1:], dtype=torch.float32,
                            device=g32.device)
        for k in range(g32.shape[0]):
            scale = lr / (v1 * t[k] + eps)
            delta = delta + w[k] * scale * g32[k]
    p1 = (params.float() - delta).to(params.dtype)
    return p1, n1, b1, v1


def batched_scale_apply_ref(params, grads, v, coeffs, taus, lr, *,
                            masks=None, eps=1e-8, mode="fasgd"):
    """θ' = θ - Σ_k m_k·c_k·scale_k·g_k on one leaf, with no statistics.

    `grads` is [K, *shape]; `coeffs`, `taus` and `masks` are [K], possibly
    on the device; `masks=None` weighs event k by c_k alone, which equals
    an all-ones mask.  scale_k is lr / (v·τ_k + ε) in 'fasgd' mode (`v` is
    read only there) and 1 in 'coeff' mode.  Like the Pallas body, the
    events are walked in order from an fp32 zero accumulator, each term
    grouped as (w_k·scale_k)·g_k with g cast to fp32, and θ' is rounded to
    θ's dtype once.  `lr` is divided as a tensor: PyTorch computes
    ``float / tensor`` as ``tensor.reciprocal() * float``, which rounds
    otherwise than the kernels' division.
    """
    if mode not in ("coeff", "fasgd"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = params.device
    w = torch.as_tensor(coeffs, dtype=torch.float32, device=dev)
    if masks is not None:
        w = torch.as_tensor(masks, dtype=torch.float32, device=dev) * w
    if mode == "fasgd":
        t = torch.as_tensor(taus, dtype=torch.float32, device=dev)
        lr = (torch.as_tensor(lr, dtype=torch.float32, device=dev)
              if isinstance(lr, torch.Tensor)
              else torch.full((), float(lr), dtype=torch.float32, device=dev))
    acc = torch.zeros(params.shape, dtype=torch.float32, device=dev)
    for k in range(grads.shape[0]):
        g = grads[k].float()
        if mode == "fasgd":
            acc = acc + w[k] * (lr / (v * t[k] + eps)) * g
        else:
            acc = acc + w[k] * g
    return (params.float() - acc).to(params.dtype)


def attention_ref(q, k, v, *, causal=True, window=0, sm_scale=None):
    """Exact GQA attention with causal / sliding-window masks.

    q: [B, Hq, Lq, D]; k, v: [B, Hkv, Lk, D]; q head h reads kv head
    h // (Hq/Hkv).  When Lk > Lq the queries are the *last* Lq positions
    of the kv axis (decode / prefill-with-cache semantics).  Scores, softmax
    and the weighted sum in float32; a row with no visible key outputs 0;
    the output is in q's dtype.
    """
    B, Hq, Lq, D = q.shape
    _, Hkv, Lk, _ = k.shape
    group = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    kk = torch.repeat_interleave(k, group, dim=1).float()
    vv = torch.repeat_interleave(v, group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * sm_scale
    q_pos = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
    k_pos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv)
    any_visible = mask.any(dim=-1)[:, None]               # [Lq, 1]
    out = torch.where(any_visible, out, torch.zeros((), device=q.device))
    return out.to(q.dtype)
