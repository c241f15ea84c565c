"""Roofline terms of a step, counted on the meta device.

Ported from `repro.launch.analysis`, which reads a compiled XLA program's
`cost_analysis()` and `memory_analysis()`.  The port has no compiler to ask:
`raw_costs` runs the step once on meta tensors (shapes and dtypes, no
storage, no arithmetic) under dispatch modes that count what each aten op
would do on the card:

  flops      `torch.utils.flop_counter.FlopCounterMode`'s count (matrix
             products, convolutions and attention; elementwise ops count
             0), the flash kernel's shape-only route counted as its useful
             work, 4·B·H·(visible query-key pairs)·D (`ops.flash_flops`);
  hbm_bytes  the sum, over every aten op that is not a view (nor
             `_unsafe_view`), of the bytes of its tensor inputs and
             outputs: what the eager, unfused port moves if no operand
             stays in cache;
  peak       the high-water mark of the bytes of the storages made during
             the pass and alive at once (the arguments' own excluded).

The whole program is counted, every layer included, so the reference's
extrapolation from 1- and 2-unit variants is not needed (`extrapolate_costs`
is kept for its callers).  The terms are reckoned on a card's published
rates (`launch.mesh.card_rates`, the H100 SXM where no card is present):

  compute term    = flops per device / peak bf16 FLOP/s
  memory term     = hbm_bytes per device / memory bytes/s
  collective term = 0: the counting pass runs the step in one process,
                    which has no collectives to count (the reference
                    parses them out of XLA's HLO text, which the port
                    never produces).  Over a mesh of processes the step's
                    collectives are DTensor's, counted on a live group by
                    `CommDebugMode` (`chip_smoke.py` phase 22); counting
                    them at the production mesh's sizes here is ROADMAP
                    queue 1, item 10c.

Per-device memory is reckoned from the `sharding.rules` specs: each
argument leaf's bytes over the sizes of the mesh axes in its spec, plus an
estimate of the temporaries, the pass's high-water mark over the size of
the axes that shard the batch.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch.mesh import DEFAULT_CARD, card_name, card_rates
from repro_torch.sharding.rules import axis_size
from repro_torch.utils.trees import leaves

_DEFAULT_BYTES_S, _, _DEFAULT_BF16_S = card_rates(DEFAULT_CARD)

# What each counted quantity is: `Roofline.to_dict` writes these into the
# record beside the numbers.
DEFINITIONS = {
    "flops": "FlopCounterMode's FLOPs of the step on meta tensors, the flash "
             "kernel's route as 4*B*H*visible_pairs*D, divided evenly over "
             "the chips",
    "hbm_bytes": "sum of the input and output tensor bytes of every aten op "
                 "that is not a view (nor _unsafe_view), divided evenly over "
                 "the chips",
    "per_device_mem": "argument bytes per device from the sharding specs "
                      "plus temp_bytes, an estimate",
    "temp_bytes": "estimate: high-water mark of the bytes made and alive at "
                  "once during the pass, over the batch axes' size",
    "collectives": "not reckoned at the production mesh (ROADMAP queue "
                   "1, item 10c): coll_bytes 0, collective_s 0",
}


def _flash_formula(q_shape, k_shape, v_shape, causal, window, *,
                   out_shape=None, **kw) -> int:
    from repro_torch.kernels.ops import flash_flops
    return flash_flops(q_shape, k_shape, causal, window)


@dataclasses.dataclass
class Roofline:
    """All byte/FLOP quantities are PER DEVICE.  `flops` and `hbm_bytes` are
    the step's counted totals divided evenly over the chips: not the
    reference's SPMD-partitioned count, which adds the work a partition
    repeats and differs from an even split at 256 chips.  The card's rates
    are held by the record (`card`, `card_bytes_s`, `card_bf16_flops_s`)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                  # counted FLOPs per device per step
    hbm_bytes: float              # counted bytes per device per step
    coll_bytes: float             # 0.0: collectives are not reckoned
    coll_breakdown: Dict[str, int]
    per_device_mem: Optional[int] = None   # arguments + temp estimate
    model_flops: Optional[float] = None    # 6·N·D analytic (GLOBAL)
    card: str = DEFAULT_CARD
    card_bytes_s: float = _DEFAULT_BYTES_S
    card_bf16_flops_s: float = _DEFAULT_BF16_S

    @property
    def compute_s(self) -> float:
        """Compute roofline term: per-device FLOPs / peak FLOP/s (seconds)."""
        return self.flops / self.card_bf16_flops_s

    @property
    def memory_s(self) -> float:
        """Memory roofline term: per-device bytes / memory bandwidth."""
        return self.hbm_bytes / self.card_bytes_s

    @property
    def collective_s(self) -> float:
        """Collective roofline term: 0, nothing is reckoned to cross a
        link."""
        return 0.0

    @property
    def bottleneck(self) -> str:
        """The largest roofline term: 'compute' | 'memory' | 'collective'."""
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> Optional[float]:
        """Model-FLOPs utilization proxy: analytic 6·N·D / counted FLOPs
        (per device); None when either quantity is unknown."""
        if self.model_flops and self.flops:
            return (self.model_flops / self.chips) / self.flops
        return None

    def to_dict(self) -> dict:
        """Flat JSON-ready dict: dataclass fields, the derived terms and the
        definitions of the counted quantities."""
        d = dataclasses.asdict(self)
        d.update(
            compute_s=self.compute_s, memory_s=self.memory_s,
            collective_s=self.collective_s, bottleneck=self.bottleneck,
            useful_flops_frac=self.useful_flops_frac,
            definitions=dict(DEFINITIONS),
        )
        return d


# Ops that alias an input without saying so in their schema: views too.
_UNMARKED_VIEWS = (torch.ops.aten._unsafe_view,)


class _Tally(TorchDispatchMode):
    """Counts the bytes every non-view aten op reads and writes, and the
    live bytes of the storages made while it is on (their high-water mark).
    A storage's bytes leave the live count when its last tensor, autograd's
    saved ones included, is freed."""

    def __init__(self, args):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._known = {t.untyped_storage()._cdata for t in leaves(args)
                       if isinstance(t, torch.Tensor)}
        self._held = {}

    def _release(self, key):
        self.live -= self._held.pop(key)

    def _hold(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known or key in self._held:
            return
        self._held[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
        if not (func.is_view or func.overloadpacket in _UNMARKED_VIEWS):
            ins = [t for t in leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        for t in outs:
            self._hold(t)
        return out


def count_pass(fn, args) -> Tuple[object, float, float, int]:
    """Run ``fn(*args)`` once on meta tensors under the counting modes.
    → (its outputs, FLOPs, bytes, live-bytes high-water mark), each for
    the whole step (module docstring)."""
    flops = FlopCounterMode(display=False, custom_mapping={
        torch.ops.repro_torch.flash_attention: _flash_formula})
    with flops, _Tally(args) as tally:
        out = fn(*args)
    return (out, float(flops.get_total_flops()), float(tally.bytes),
            int(tally.peak))


def raw_costs(fn, args) -> Tuple[float, float, Dict[str, int], int]:
    """(flops, hbm_bytes, collective breakdown, peak live bytes) of
    ``fn(*args)``, counted for the whole step on meta tensors (the module
    docstring defines each); the breakdown is empty, since one process has
    no collectives."""
    _, flops, hbm, peak = count_pass(fn, args)
    return flops, hbm, {}, peak


def extrapolate_costs(c1, c2, n_units: int):
    """Linear-in-depth extrapolation: cost(L) = c1 + (n_units − 1)·(c2 − c1)
    where c1 was measured at 1 unit (+ fixed overhead) and c2 at 2 units.

    Works for scalars and for the collective-breakdown dicts."""
    if isinstance(c1, dict):
        return {k: extrapolate_costs(c1[k], c2.get(k, 0), n_units) for k in c1}
    return c1 + (n_units - 1) * (c2 - c1)


def _shard_bytes(leaf, sharding) -> int:
    """A leaf's bytes on one device: each dimension over the sizes of the
    mesh axes its spec names, rounded up, as XLA shards it."""
    spec = tuple(sharding.spec) + (None,) * (leaf.dim() - len(sharding.spec))
    n = 1
    for size, axes in zip(leaf.shape, spec):
        n *= -(-size // axis_size(sharding.mesh, axes)) if axes else size
    return n * leaf.element_size()


def bytes_per_device(tree, shardings) -> int:
    """The bytes one device holds of `tree` under `shardings` (a tree of
    `NamedSharding` of the same structure)."""
    ts, ss = leaves(tree), leaves(shardings)
    if len(ts) != len(ss):
        raise ValueError(f"{len(ts)} leaves against {len(ss)} shardings")
    return sum(_shard_bytes(t, s) for t, s in zip(ts, ss))


def batch_split(shardings) -> int:
    """The number of shards of the batch: the product of the mesh axes'
    sizes in the spec of the step's second argument (its batch, or the
    decode step's token), as `sharding.rules.batch_spec` gave it."""
    sh = leaves(shardings[1])[0]
    return math.prod(axis_size(sh.mesh, a) for a in sh.spec if a)


def temp_bytes(peak: int, shardings) -> int:
    """The temporaries' estimate per device: the pass's high-water mark over
    the batch's shards."""
    return int(peak // batch_split(shardings))


def analyze(arch: str, shape: str, mesh_name: str, chips: int, fn, args,
            shardings, model_flops: Optional[float] = None,
            costs: Optional[Tuple[float, float, Dict[str, int], int]] = None,
            card: Optional[str] = None) -> Roofline:
    """Build a `Roofline` of ``fn(*args)`` (or of pre-counted `costs`) on
    `chips` devices: the counted FLOPs and bytes split evenly, and
    per-device memory = the arguments' bytes per device under `shardings`
    + `temp_bytes`.  The rates are `card`'s (default: the card present,
    else the H100 SXM)."""
    if costs is None:
        costs = raw_costs(fn, args)
    flops, hbm, coll, peak = costs
    card = card_name() if card is None else card
    bw, _, bf16 = card_rates(card)
    per_dev = bytes_per_device(args, shardings) + temp_bytes(peak, shardings)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops=flops / chips, hbm_bytes=hbm / chips,
        coll_bytes=float(sum(coll.values())), coll_breakdown=dict(coll),
        per_device_mem=per_dev, model_flops=model_flops,
        card=card, card_bytes_s=bw, card_bf16_flops_s=bf16,
    )


def model_flops_estimate(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) for train; 2·N·D for inference."""
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    N = active_param_count(cfg)
    if shape.kind == "train":
        D = shape.global_batch * shape.seq_len
        return 6.0 * N * D
    if shape.kind == "prefill":
        D = shape.global_batch * shape.seq_len
        return 2.0 * N * D
    D = shape.global_batch * 1      # one token per request
    return 2.0 * N * D


def active_param_count(cfg) -> int:
    """Parameters touched per token (MoE: shared + top-k routed only)."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    emb = 2 * V * d
    if cfg.arch_type in ("ssm", "hybrid"):
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = di + 2 * N
        per = d * (2 * di + 2 * N + H) + cfg.conv_width * conv_dim + di * d + 2 * di
        total = L * per + emb
        if cfg.arch_type == "hybrid":
            k = cfg.hybrid_attn_every
            n_apps = L // k
            hd = cfg.hd
            attn = (2 * d) * d * 2 + d * cfg.num_heads * hd * 2 \
                + d * cfg.num_kv_heads * hd * 2 + 3 * d * cfg.d_ff
            total += n_apps * attn          # shared weights reused n_apps times
        return int(total)
    hd = cfg.hd
    if cfg.use_mla:
        r, dr = cfg.kv_lora_rank, 64
        attn = d * cfg.num_heads * (hd + dr) + d * r + r * cfg.num_heads * hd * 2 \
            + d * dr + cfg.num_heads * hd * d
    else:
        attn = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd \
            + cfg.num_heads * hd * d
    if cfg.is_moe:
        fe = cfg.moe_d_ff or cfg.d_ff
        k = cfg.num_experts_per_tok + cfg.num_shared_experts
        ffn = 3 * d * fe * k + d * cfg.num_experts
    else:
        ffn = 3 * d * cfg.d_ff
    return int(L * (attn + ffn) + emb)


def total_param_count(cfg) -> int:
    """All parameters (MoE: every expert)."""
    if not cfg.is_moe:
        return active_param_count(cfg)
    d, L = cfg.d_model, cfg.num_layers
    fe = cfg.moe_d_ff or cfg.d_ff
    dense_like = active_param_count(cfg)
    k = cfg.num_experts_per_tok + cfg.num_shared_experts
    return int(dense_like + L * 3 * d * fe * (cfg.num_experts - k))
