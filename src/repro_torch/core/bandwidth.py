"""B-FASGD bandwidth gating (paper §2.3), ported from `repro.core.bandwidth`.

A client transmits (push or fetch) at an opportunity iff

    r < 1 / (1 + c / (v̄ + ε)),   r ~ U[0,1]                     (eq. 9)

with v̄ the mean over all parameters of the gradient-std moving average.
`c = 0` gives probability exactly 1.  The uniforms r come from the run's
RNG provider (`repro_torch.utils.rng`), so the gates themselves draw
nothing.

Per-tensor gating (the paper's §5 proposal): each parameter tensor
transmits on its own draw, against its own v̄ (`leaf_vbar`), in either
direction (`per_tensor_push`, `per_tensor_fetch`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import server_shard
from repro_torch.utils.trees import leaves, unflatten


@dataclasses.dataclass(frozen=True)
class BandwidthConfig:
    """Eq.-9 gating strengths + drop policy + §5 per-tensor switches."""

    c_push: float = 0.0
    c_fetch: float = 0.0
    eps: float = 1e-8
    # 'cache' — re-apply the client's most recent transmitted gradient (the
    #           paper's choice; needs a [λ, P] gradient cache);
    # 'skip'  — no server update happens for this opportunity.
    # Under per-tensor push the policy holds leaf by leaf.
    drop_policy: str = "cache"
    per_tensor_fetch: bool = False
    per_tensor_push: bool = False

    def __post_init__(self):
        if self.drop_policy not in ("cache", "skip"):
            raise ValueError(f"unknown drop_policy {self.drop_policy!r}")

    @property
    def enabled(self) -> bool:
        """True iff any gating (either direction, any granularity) is on."""
        return (self.c_push > 0 or self.c_fetch > 0
                or self.per_tensor_fetch or self.per_tensor_push)

    @property
    def per_tensor(self) -> bool:
        """True iff any per-tensor (§5) gating direction is on."""
        return self.per_tensor_fetch or self.per_tensor_push


def transmit_prob(vbar, c, eps: float = 1e-8):
    """Eq. 9 right-hand side, in (0, 1]: increasing in v̄, decreasing in c."""
    return 1.0 / (1.0 + c / (vbar + eps))


def tree_bytes(tree) -> float:
    """Wire size of one full copy of `tree` (a python float)."""
    return float(sum(l.numel() * l.element_size() for l in leaves(tree)))


def leaf_vbar(leaf) -> torch.Tensor:
    """One tensor's v̄: the mean of its gradient-std moving average."""
    return torch.mean(leaf.to(torch.float32))


def masked_bytes(mask_tree, like_tree) -> torch.Tensor:
    """Transmitted bytes of per-leaf decisions: Σ_leaf count(mask)·nbytes,
    summed in float32 leaf by leaf in leaf order, as the reference does.
    Mask leaves are scalars or [K] event vectors; `like_tree` gives each
    tensor's wire size (its shapes and dtypes are all that is read)."""
    ms = leaves(mask_tree)
    sent = torch.zeros((), dtype=torch.float32, device=ms[0].device)
    for m, l in zip(ms, leaves(like_tree)):
        sent = sent + m.to(torch.float32).sum() * float(
            l.numel() * l.element_size())
    return sent


def per_tensor_transmit_mask(u, v_tree, c, eps: float = 1e-8):
    """§5: one eq.-9 decision per parameter tensor, against that tensor's
    own v̄.  `u` holds the uniforms, one per leaf in leaf order along its
    last axis: [n_leaves] for one event, [K, n_leaves] for a window (each
    event's leaves then get [K] masks).

    Returns (mask tree mirroring `v_tree`, transmitted bytes (float32, per
    event), total bytes of one copy (a python float)).  A placed v tree
    (`core.server_shard`) gives each leaf's v̄ from its shards' sums."""
    if server_shard.is_sharded(v_tree):
        vbars = server_shard.leaf_means(v_tree)
        v_tree = v_tree.like
    else:
        vbars = [leaf_vbar(l) for l in leaves(v_tree)]
    ls = leaves(v_tree)
    if u.shape[-1] != len(ls):
        raise ValueError(f"{u.shape[-1]} uniforms per event for "
                         f"{len(ls)} tensors")
    masks = [u[..., i] < transmit_prob(vb.to(u.device), c, eps)
             for i, vb in enumerate(vbars)]
    sent = torch.zeros(u.shape[:-1], dtype=torch.float32, device=u.device)
    for m, l in zip(masks, ls):
        sent = sent + m.to(torch.float32) * float(l.numel() * l.element_size())
    return unflatten(v_tree, masks), sent, tree_bytes(v_tree)


def per_tensor_fetch_mask(u, v_tree, c, eps: float = 1e-8):
    """The fetch direction's name for `per_tensor_transmit_mask`."""
    return per_tensor_transmit_mask(u, v_tree, c, eps)
