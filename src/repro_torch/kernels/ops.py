"""Public wrappers of the kernels: the three server updates (over trees of
leaves) and attention.

Ported from `repro.kernels.ops`.  Dispatch is by the tensors' device:

* a CPU tensor takes the kernel's plain PyTorch version (`kernels.ref`);
* a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/<name>.cu``, built by `kernels.build`) or raises.

There is no switch and no fallback.  The server-update kernels take each
leaf flat and contiguous and mask its tail, so unlike the TPU wrappers there
is no padding to (R, 128) tiles; the attention kernel takes each tensor's
strides and masks its ragged tails, so it needs neither padding nor
contiguous copies.  A launch runs on PyTorch's current stream, does not
synchronise, and writes out-of-place outputs allocated here.

`LAUNCHES` counts dispatches per kernel on either device: on a CUDA tensor
every dispatch is one kernel launch, so on the card it counts launches, and
on the CPU the tests hold it against the simulator's
``Counters.kernel_launches`` and the model's layer count.
"""
from __future__ import annotations

import ctypes
from typing import Any

import torch

from repro_torch.kernels import ref
from repro_torch.utils.trees import leaves, same_structure, unflatten

LAUNCHES = {"fasgd_update": 0, "fused_event_apply": 0,
            "batched_scale_apply": 0, "flash_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _device_kind(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return kind


def _check(name, t, *, device, numel, dtype=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")


def _scalar_f32(x, device) -> torch.Tensor:
    """A float32 device scalar; a tensor already there is not copied."""
    return torch.as_tensor(x, device=device).to(torch.float32).reshape(())


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _fasgd_update_cuda(p, g, n, b, v, lr, tau, gamma, beta, eps, variant):
    from repro_torch.kernels.build import kernel
    dev, size = p.device, p.numel()
    if p.dtype not in _DTYPE_CODE:
        raise ValueError(f"params dtype {p.dtype} not supported by the kernel")
    _check("grads", g, device=dev, numel=size, dtype=p.dtype)
    _check("params", p, device=dev, numel=size)
    for nm, t in (("n", n), ("b", b), ("v", v)):
        _check(nm, t, device=dev, numel=size, dtype=torch.float32)
    tau = _scalar_f32(tau, dev)
    po, no = torch.empty_like(p), torch.empty_like(n)
    bo, vo = torch.empty_like(b), torch.empty_like(v)
    with torch.cuda.device(dev):
        rc = kernel("fasgd_update")(
            _DTYPE_CODE[p.dtype], int(variant == "literal"),
            p.data_ptr(), g.data_ptr(), n.data_ptr(), b.data_ptr(),
            v.data_ptr(), tau.data_ptr(), lr, gamma, 1.0 - gamma, beta,
            1.0 - beta, eps, size, po.data_ptr(), no.data_ptr(),
            bo.data_ptr(), vo.data_ptr(), _stream(dev))
    _raise_on(rc, "fasgd_update")
    return po, no, bo, vo


def fasgd_update_leaf(p, g, n, b, v, lr, tau, *, gamma=0.9, beta=0.9,
                      eps=1e-8, variant="intent"):
    """One FASGD push on one leaf: (θ', n', b', v'), statistics float32.

    `tau` is a float or a float32 device scalar; `lr` and the constants are
    floats.
    """
    if variant not in ("intent", "literal"):
        raise ValueError(f"unknown variant {variant!r}")
    LAUNCHES["fasgd_update"] += 1
    if _device_kind(p) == "cpu":
        return ref.fasgd_update_ref(p, g, n, b, v, lr, tau, gamma=gamma,
                                    beta=beta, eps=eps, variant=variant)
    return _fasgd_update_cuda(p, g, n, b, v, lr, tau, gamma, beta, eps,
                              variant)


def _unzip(params, outs):
    return tuple(unflatten(params, [o[i] for o in outs]) for i in range(4))


def fasgd_update(params: Any, grads: Any, n: Any, b: Any, v: Any, lr, tau,
                 *, gamma=0.9, beta=0.9, eps=1e-8, variant="intent"):
    """Fused FASGD update over trees (one dispatch per leaf).

    Returns (params', n', b', v') trees; the statistics are float32.
    """
    outs = [fasgd_update_leaf(p, g, nn, bb, vv, lr, tau, gamma=gamma,
                              beta=beta, eps=eps, variant=variant)
            for p, g, nn, bb, vv in zip(leaves(params), leaves(grads),
                                        leaves(n), leaves(b), leaves(v))]
    return _unzip(params, outs)


def _fused_event_apply_cuda(p, g, n, b, v, w, wm, t, lr, hp, gamma, beta, eps,
                            variant, mode, track_stats):
    from repro_torch.kernels.build import kernel
    dev, size, K = p.device, p.numel(), g.shape[0]
    if p.dtype not in _DTYPE_CODE:
        raise ValueError(f"params dtype {p.dtype} not supported by the kernel")
    _check("params", p, device=dev, numel=size)
    _check("grads", g, device=dev, numel=K * size, dtype=p.dtype)
    for nm, x in (("n", n), ("b", b), ("v", v)):
        _check(nm, x, device=dev, numel=size, dtype=torch.float32)
    vecs = [torch.as_tensor(x, device=dev).to(torch.float32).contiguous()
            for x in (w, wm, t)]
    for nm, x in zip(("weights", "wmean", "taus"), vecs):
        _check(nm, x, device=dev, numel=K)
    hp = _scalar_f32(hp, dev)
    po, no = torch.empty_like(p), torch.empty_like(n)
    bo, vo = torch.empty_like(b), torch.empty_like(v)
    with torch.cuda.device(dev):
        rc = kernel("fused_event_apply")(
            _DTYPE_CODE[p.dtype], int(mode == "fasgd"), int(track_stats),
            int(variant == "literal"), p.data_ptr(), g.data_ptr(),
            n.data_ptr(), b.data_ptr(), v.data_ptr(), vecs[0].data_ptr(),
            vecs[1].data_ptr(), vecs[2].data_ptr(), hp.data_ptr(), lr, gamma,
            1.0 - gamma, beta, 1.0 - beta, eps, K, size, po.data_ptr(),
            no.data_ptr(), bo.data_ptr(), vo.data_ptr(), _stream(dev))
    _raise_on(rc, "fused_event_apply")
    return po, no, bo, vo


def fused_event_apply_leaf(p, g, n, b, v, weights, wmean, taus, has_push, *,
                           lr, gamma=0.9, beta=0.9, eps=1e-8,
                           variant="intent", mode="fasgd", track_stats=True):
    """One K-event server apply on one leaf: (θ', n', b', v').

    `g` is [K, *p.shape]; `weights`/`wmean`/`taus` are [K] and `has_push` a
    scalar, all allowed to live on the device.
    """
    if mode not in ("coeff", "fasgd"):
        raise ValueError(f"unknown mode {mode!r}")
    if variant not in ("intent", "literal"):
        raise ValueError(f"unknown variant {variant!r}")
    LAUNCHES["fused_event_apply"] += 1
    if _device_kind(p) == "cpu":
        return ref.fused_event_apply_ref(
            p, g, n, b, v, weights, wmean, taus, lr, has_push, gamma=gamma,
            beta=beta, eps=eps, variant=variant, mode=mode,
            track_stats=track_stats)
    return _fused_event_apply_cuda(p, g, n, b, v, weights, wmean, taus, lr,
                                   has_push, gamma, beta, eps, variant, mode,
                                   track_stats)


def fused_event_apply(params: Any, grads: Any, n: Any, b: Any, v: Any,
                      weights, wmean, taus, has_push, *, lr, gamma=0.9,
                      beta=0.9, eps=1e-8, variant="intent", mode="fasgd",
                      track_stats=True):
    """One-kernel K-event server apply over trees (one dispatch per leaf).

    `grads` leaves carry a leading [K] event axis; `weights`/`wmean`/`taus`
    ([K]) and `has_push` (scalar) are shared by every leaf (per-leaf
    vectors belong to per-tensor gating, which is not ported yet).
    `n`/`b`/`v` must be float32.  Returns (params', n', b', v') with the
    statistics in float32.
    """
    outs = [fused_event_apply_leaf(
        p, g, nn, bb, vv, weights, wmean, taus, has_push, lr=lr, gamma=gamma,
        beta=beta, eps=eps, variant=variant, mode=mode,
        track_stats=track_stats)
        for p, g, nn, bb, vv in zip(leaves(params), leaves(grads), leaves(n),
                                    leaves(b), leaves(v))]
    return _unzip(params, outs)


# The most events `csrc/batched_update.cu` stages in shared memory
# (its kMaxEvents).
MAX_BATCHED_EVENTS = 4096


def _batched_scale_apply_cuda(p, g, v, coeffs, taus, masks, lr, eps, mode):
    from repro_torch.kernels.build import kernel
    dev, size = p.device, p.numel()
    K = g.shape[0] if g.dim() else 0
    if p.dtype not in _DTYPE_CODE:
        raise ValueError(f"params dtype {p.dtype} not supported by the kernel")
    if not 1 <= K <= MAX_BATCHED_EVENTS:
        raise ValueError(f"{K} events: the kernel takes 1 to "
                         f"{MAX_BATCHED_EVENTS} (their weights and τ are "
                         f"staged in shared memory)")
    _check("params", p, device=dev, numel=size)
    _check("grads", g, device=dev, numel=K * size, dtype=p.dtype)
    _check("v", v, device=dev, numel=size, dtype=torch.float32)
    named = [("coeffs", coeffs), ("taus", taus)]
    if masks is not None:
        named.append(("masks", masks))
    vecs = [torch.as_tensor(x, device=dev).to(torch.float32).contiguous()
            for _, x in named]
    for (nm, _), x in zip(named, vecs):
        _check(nm, x, device=dev, numel=K)
    mask_ptr = vecs[2].data_ptr() if masks is not None else None
    po = torch.empty_like(p)
    with torch.cuda.device(dev):
        rc = kernel("batched_update")(
            _DTYPE_CODE[p.dtype], int(mode == "fasgd"), int(masks is not None),
            p.data_ptr(), g.data_ptr(), v.data_ptr(), vecs[0].data_ptr(),
            vecs[1].data_ptr(), mask_ptr, lr, eps, K, size, po.data_ptr(),
            _stream(dev))
    _raise_on(rc, "batched_scale_apply")
    return po


def batched_scale_apply_leaf(p, g, v, coeffs, taus, *, masks=None, lr,
                             eps=1e-8, mode="fasgd"):
    """θ' = θ - Σ_k m_k·c_k·scale_k·g_k on one leaf, in θ's dtype.

    `g` is [K, *p.shape]; `coeffs`, `taus` and `masks` are [K], allowed to
    live on the device; `masks=None` weighs event k by c_k alone.  scale_k
    is lr / (v·τ_k + ε) in 'fasgd' mode and 1 in 'coeff' mode, where `v`
    is not read.
    """
    if mode not in ("coeff", "fasgd"):
        raise ValueError(f"unknown mode {mode!r}")
    LAUNCHES["batched_scale_apply"] += 1
    if _device_kind(p) == "cpu":
        return ref.batched_scale_apply_ref(p, g, v, coeffs, taus, lr,
                                           masks=masks, eps=eps, mode=mode)
    return _batched_scale_apply_cuda(p, g, v, coeffs, taus, masks, lr, eps,
                                     mode)


def batched_scale_apply(params: Any, grads: Any, v: Any, coeffs, taus, *,
                        masks=None, lr, eps=1e-8, mode="fasgd"):
    """Σ_k m_k·c_k·scale(v,τ_k)·g_k applied over trees (one dispatch per
    leaf); returns params' in the params' dtypes.

    `grads` leaves carry a leading [K] event axis.  `coeffs`, `taus` and
    `masks` are each one [K] vector shared by every leaf, or a tree that
    mirrors `params` with one [K] vector per leaf (per-tensor gating and
    per-tensor staleness).  `masks=None` means the push decision is already
    folded into `coeffs`, the same as an all-ones mask.
    """
    ps = leaves(params)

    def per_leaf(x):
        if x is None:
            return [None] * len(ps)
        if same_structure(x, params):
            return leaves(x)
        return [x] * len(ps)

    outs = [batched_scale_apply_leaf(p, g, vv, c, t, masks=m, lr=lr, eps=eps,
                                     mode=mode)
            for p, g, vv, c, t, m in zip(ps, leaves(grads), leaves(v),
                                         per_leaf(coeffs), per_leaf(taus),
                                         per_leaf(masks))]
    return unflatten(params, outs)


_HEAD_DIMS = (32, 64, 128)
# Lq up to this takes the decode kernel, which splits the keys across at
# most _DECODE_MAX_SPLITS blocks and merges their (m, l, acc) from a float32
# scratch buffer (kRowsMaxLq and kMaxSplits in csrc/flash_attention.cu).
_DECODE_MAX_LQ = 16
_DECODE_MAX_SPLITS = 32


def _attention_cuda(q, k, v, causal, window, sm_scale):
    from repro_torch.kernels.build import kernel
    B, Hq, Lq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    Hkv, Lk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{Hq} q heads do not group over {Hkv} kv heads")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if min(B, Hq, Lq, Lk) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype} not supported by the kernel")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{nm} is {t.dtype} on {t.device}, expected "
                             f"{q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{nm}'s last dimension must be contiguous")
    o = torch.empty_like(q)          # q's layout where q is dense, else packed
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *o.stride()[:3])
    scratch = None
    if Lq <= _DECODE_MAX_LQ:
        scratch = torch.empty(B * Hq * Lq * _DECODE_MAX_SPLITS * (D + 2),
                              dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = kernel("flash_attention")(
            _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, Hq, Hkv, Lq, Lk, strides, int(causal),
            int(window), sm_scale,
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel(), _stream(q.device))
    _raise_on(rc, "flash_attention")
    return o


def attention(q, k, v, *, causal=True, window=0, sm_scale=None):
    """Exact GQA attention: q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D] → o like q.

    Causal and sliding-window (`window` > 0) masks; the queries are the last
    Lq positions of the kv axis; a row with no visible key outputs 0;
    `sm_scale` defaults to 1/√D.  On the card the tensors may be strided
    views (permuted heads, cache slices) as long as their last dimension is
    contiguous; the output keeps q's layout.
    """
    LAUNCHES["flash_attention"] += 1
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if _device_kind(q) == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 sm_scale=sm_scale)
    return _attention_cuda(q, k, v, causal, window, sm_scale)
