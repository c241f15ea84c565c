"""Mixture-of-Experts FFN: a top-k router and capacity-based dispatch.

Ported from `repro.models.moe`.  Tokens are sorted by their routed expert
(a stable sort of the (token, slot) pairs), laid into a dense
[E, capacity, d] buffer, run through the experts as three batched products
over that buffer, and combined with the renormalised gate weights.  A
token beyond its expert's capacity is dropped (GShard/Switch semantics);
capacity is ``int((T·k + E − 1) // E · capacity_factor)`` rounded up to a
multiple of 128 and at least 128, the reference's float arithmetic.
Shared experts (DeepSeek-V2) see every token; the switch load-balance aux
loss comes back beside the output.

The reference has no Pallas kernel here: it computes the dispatch and the
expert products in plain JAX, and they stay plain PyTorch (`torch.einsum`)
here.  What differs in form, not in value:
- the buffer is filled by a gather (expert e's slot c takes the token at
  sorted position starts[e] + c when c < counts[e], else zeros) where the
  reference scatters every (token, slot) pair into [E, cap + 1, d] and
  drops the overflow row; the [E, cap] part is the same tensor;
- the per-expert counts are a comparison sum against ``arange(E)``, and
  the one-hot of the aux loss a comparison, since `torch.bincount` and
  `F.one_hot` have no `torch.func.vmap` rule (the round trainer maps the
  gradient over clients, the cotangent path over events).
Nothing on the path syncs with the host.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, init_mlp, is_meta,
                                       mlp_forward)
from repro_torch.utils.trees import tree_map


def _expert_init(generator, shape, dtype, *, layers, device):
    """`layers.dense_init` of an [E, a, b] expert weight (scale 1/√E, the
    reference's fan-in of its first axis), stacked over `layers`, drawn one
    expert of one layer at a time into the `dtype` result: the float32 draw
    of a whole stacked leaf would be twice the size of grok-1's bf16
    result.  On the meta device nothing is drawn."""
    full = ((layers,) if layers else ()) + tuple(shape)
    if is_meta(device, generator):
        return torch.empty(full, dtype=dtype, device="meta")
    scale = 1.0 / math.sqrt(shape[0])
    device = device or generator.device
    out = torch.empty(full, dtype=dtype, device=device)
    flat = out.view((-1,) + tuple(shape[1:]))
    for i in range(flat.shape[0]):
        w = torch.randn(shape[1:], generator=generator,
                        device=generator.device)
        flat[i] = (scale * w).to(device=device, dtype=dtype)
    return out


def init_moe(generator, cfg, *, layers: int = 0, device=None):
    """{router: [d, E], w_gate, w_up: [E, d, f], w_down: [E, f, d]} and,
    with shared experts, {shared: SwiGLU at num_shared_experts · f}, f =
    moe_d_ff (or d_ff), stacked over `layers` when > 0."""
    d, E, fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    dt = cfg.dtype
    kw = dict(layers=layers, device=device)
    p = {
        "router": dense_init(generator, (d, E), dt, **kw),
        "w_gate": _expert_init(generator, (E, d, fe), dt, **kw),
        "w_up": _expert_init(generator, (E, d, fe), dt, **kw),
        "w_down": _expert_init(generator, (E, fe, d), dt, **kw),
    }
    if cfg.num_shared_experts > 0:
        p["shared"] = init_mlp(generator, d, cfg.num_shared_experts * fe, dt,
                               **kw)
    return p


def capacity(T: int, k: int, E: int, capacity_factor: float = 1.25) -> int:
    """Slots per expert for T tokens routed to k of E experts: the
    reference's expression, ≥ 128 and a multiple of 128."""
    cap = int((T * k + E - 1) // E * capacity_factor)
    return max(128, -(-cap // 128) * 128)


def route(p, cfg, xf, capacity_factor: float = 1.25):
    """The router and the dispatch plan of tokens xf [T, d] → a dict:
    ``gates`` [T, k] (renormalised, float32), ``ids`` [T, k], ``slots``
    [T, k] (each (token, slot) pair's place in its expert's buffer; `cap`
    where it overflowed and is dropped), ``cap``, ``aux`` (the switch
    loss), and the gather plan ``src`` [E, cap] / ``valid`` [E, cap] (the
    token each buffer row takes, and whether it takes one)."""
    T = xf.shape[0]
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = torch.einsum("td,de->te", xf.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)                       # [T, E]
    gates, ids = torch.topk(probs, k, dim=-1)                   # [T, k]
    gates = gates / gates.sum(dim=-1, keepdim=True)

    experts = torch.arange(E, device=xf.device)
    hot = (ids[..., None] == experts).float()                   # [T, k, E]
    me = probs.mean(dim=0)
    ce = hot.sum(dim=1).mean(dim=0) / k
    aux = E * torch.sum(me * ce)

    cap = capacity(T, k, E, capacity_factor)
    eid = ids.reshape(T * k)
    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    counts = (eid[:, None] == experts).sum(dim=0)               # [E]
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(T * k, device=xf.device) - starts[sorted_eid]
    slot = torch.where(rank < cap, rank, torch.full_like(rank, cap))
    token_of = order // k
    slots = torch.zeros_like(order).scatter(0, order, slot).reshape(T, k)

    c = torch.arange(cap, device=xf.device)
    valid = c[None, :] < counts[:, None]                        # [E, cap]
    pos = (starts[:, None] + c[None, :]).clamp(max=T * k - 1)
    return dict(gates=gates, ids=ids, slots=slots, cap=cap, aux=aux,
                src=token_of[pos], valid=valid)


def moe_forward(p, cfg, x, capacity_factor: float = 1.25, dp=None):
    """x [B, S, d] → (y [B, S, d], aux_loss).

    `dp` (the event's stale offset) is folded into effective weights, as
    in the reference: the top-k and the capacity dispatch depend on the
    stale logits, so a shared/delta split of the products would route
    otherwise than the serial path.
    """
    if dp is not None:
        p = tree_map(lambda w, dl: w + dl, p, dp)
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    r = route(p, cfg, xf, capacity_factor)
    h = torch.where(r["valid"][..., None], xf[r["src"]],
                    torch.zeros((), dtype=x.dtype, device=x.device))
    gate_h = F.silu(torch.einsum("ecd,edf->ecf", h, p["w_gate"]))
    up_h = torch.einsum("ecd,edf->ecf", h, p["w_up"])
    out_e = torch.einsum("ecf,efd->ecd", gate_h * up_h, p["w_down"])
    out_e = F.pad(out_e, (0, 0, 0, 1))                          # overflow row
    expert_out = out_e[r["ids"], r["slots"]]                    # [T, k, d]
    y = torch.einsum("tk,tkd->td", r["gates"].to(expert_out.dtype),
                     expert_out)
    if "shared" in p:
        y = y + mlp_forward(p["shared"], xf)
    return y.reshape(B, S, d), r["aux"]
