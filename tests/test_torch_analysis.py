"""The port's roofline analysis (`launch.analysis`) against the reference's.

- the pure arithmetic (`active_param_count`, `total_param_count`,
  `model_flops_estimate`, `extrapolate_costs`) equal to the live reference
  for every config and input shape;
- the `Roofline` arithmetic on the H100's published rates, against the
  reference's on its TPU constants; one table of card rates, no TPU
  constant in the port;
- the counting pass (`raw_costs`) on hand-counted steps, then against the
  reference's `cost_analysis()` for a train step at 2 layers, full width,
  B = 2, S = 512 on a 1×1 mesh (`unroll_stack=True`, so XLA counts every
  layer): FLOPs within the band measured for each config, bytes above the
  reference's (the port runs eagerly and unfused);
- the flash kernel's shape-only route on the meta device: counted as
  4·B·H·(visible pairs)·D under causal, sliding and full masks, pairs
  counted here from the plain version's mask; a CPU tensor still takes the
  plain version.
"""
import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs.base import InputShape as JInputShape
from repro.launch import analysis as j_analysis
from repro.launch import mesh as j_mesh
from repro.launch import steps as j_steps
from repro.sharding import set_mesh_context as j_set_mesh_context

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.kernels import ops, ref
from repro_torch.launch import analysis, mesh, steps
from repro_torch.sharding.rules import NamedSharding, P

from test_torch_fred import one_thread  # noqa: F401
from test_torch_sharding import port_mesh

ROOT = Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"
# The train step both packages count: 2 layers at full width, B = 2, S = 512.
PARITY = InputShape("parity", 512, 2, "train")
PARITY_ARCHS = ("tinyllama-1.1b", "mamba2-1.3b", "grok-1-314b")
# The port's FLOPs over the reference's `cost_analysis()["flops"]`, as
# measured (0.975, 0.964, 0.963): XLA also counts elementwise FLOPs, which
# FlopCounterMode does not.  The band is what was measured, a little wider.
FLOP_BAND = (0.95, 0.98)
# The port's bytes over the reference's "bytes accessed", as measured
# (1.31, 1.39, 1.51): every op of the eager port reads its inputs and writes
# its output, where XLA fuses.
BYTE_BAND = (1.25, 1.60)


# ---------------------------------------------------------------------------
# pure arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert analysis.active_param_count(cfg) == \
        j_analysis.active_param_count(jcfg)
    assert analysis.total_param_count(cfg) == \
        j_analysis.total_param_count(jcfg)
    for name in INPUT_SHAPES:
        assert analysis.model_flops_estimate(cfg, name) == \
            j_analysis.model_flops_estimate(jcfg, name)
        assert analysis.model_flops_estimate(cfg, INPUT_SHAPES[name]) == \
            j_analysis.model_flops_estimate(jcfg, J_INPUT_SHAPES[name])


def test_extrapolate_costs_equals_the_reference():
    cases = [(10.0, 14.0, 5), (3, 3, 1), (2.5, 1.0, 7),
             ({"a": 1, "total": 3}, {"a": 2, "total": 5}, 3),
             ({"a": 1, "b": 4}, {"a": 3}, 4)]
    for c1, c2, n in cases:
        assert analysis.extrapolate_costs(c1, c2, n) == \
            j_analysis.extrapolate_costs(c1, c2, n)
    # the reference's own spec (tests/test_sharding.py)
    assert analysis.extrapolate_costs(10.0, 14.0, 5) == 10.0 + 4 * 4.0
    assert analysis.extrapolate_costs({"a": 1, "total": 3},
                                      {"a": 2, "total": 5}, 3) == \
        {"a": 3, "total": 7}


def test_active_param_counts_sane():
    """The reference's spec: analytic N near the assigned sizes; grok-1's
    total near 314B and its active count far less."""
    expect = {"tinyllama-1.1b": 1.1e9, "llama3-8b": 8e9, "yi-34b": 34e9,
              "yi-9b": 9e9, "mamba2-1.3b": 1.3e9}
    for arch, n in expect.items():
        got = analysis.active_param_count(get_config(arch))
        assert abs(got - n) / n < 0.35, (arch, got, n)
    g = get_config("grok-1-314b")
    assert abs(analysis.total_param_count(g) - 314e9) / 314e9 < 0.15
    assert analysis.active_param_count(g) < \
        0.4 * analysis.total_param_count(g)


# ---------------------------------------------------------------------------
# the card's rates and the Roofline
# ---------------------------------------------------------------------------

def test_card_rates_one_table():
    assert mesh.card_rates(H100) == (3.35e12, 67e12, 989e12)
    assert mesh.card_rates("NVIDIA H100 PCIe") == (2.0e12, 51e12, 756e12)
    assert mesh.card_rates("NVIDIA H100 NVL") == (3.9e12, 60e12, 835e12)
    assert mesh.card_rates("NVIDIA H200") == (4.8e12, 67e12, 989e12)
    assert mesh.DEFAULT_CARD == H100
    assert mesh.card_rates() == mesh.card_rates(H100)    # no card here
    with pytest.raises(ValueError, match="no published rates"):
        mesh.card_rates("NVIDIA A100-SXM4-80GB")
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^CARD_RATES\s*=", smoke, re.M)
    assert "from repro_torch.launch.mesh import card_rates" in smoke


def test_no_tpu_constant_in_the_port():
    names = ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW")
    values = (j_mesh.PEAK_FLOPS_BF16, j_mesh.HBM_BW, j_mesh.ICI_BW)
    assert values == (197e12, 819e9, 50e9)
    for f in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = f.read_text()
        for n in names + ("197e12", "819e9", "50e9"):
            assert n not in text, (f, n)
    for m in (analysis, mesh):
        assert not any(hasattr(m, n) for n in names)


def _fields(**kw):
    base = dict(arch="a", shape="s", mesh="16x16", chips=256,
                flops=3.0e12, hbm_bytes=4.0e10, coll_bytes=0.0,
                coll_breakdown={}, per_device_mem=123, model_flops=5.0e14)
    base.update(kw)
    return base


@pytest.mark.parametrize("flops,hbm", [(3.0e12, 4.0e10), (1.0e9, 8.0e10),
                                       (0.0, 0.0)])
def test_roofline_arithmetic_on_the_h100_rates(flops, hbm):
    r = analysis.Roofline(**_fields(flops=flops, hbm_bytes=hbm))
    j = j_analysis.Roofline(**_fields(flops=flops, hbm_bytes=hbm))
    assert (r.card, r.card_bytes_s, r.card_bf16_flops_s) == \
        (H100, 3.35e12, 989e12)
    assert r.compute_s == flops / 989e12
    assert r.memory_s == hbm / 3.35e12
    # the reference's terms with its TPU rates swapped for the card's
    assert r.compute_s == pytest.approx(
        j.compute_s * j_mesh.PEAK_FLOPS_BF16 / 989e12, rel=1e-12)
    assert r.memory_s == pytest.approx(j.memory_s * j_mesh.HBM_BW / 3.35e12,
                                       rel=1e-12)
    assert r.collective_s == 0.0
    want = "compute" if r.compute_s >= r.memory_s else "memory"
    assert r.bottleneck == want
    if flops:
        assert r.useful_flops_frac == j.useful_flops_frac == \
            (5.0e14 / 256) / flops
    else:
        assert r.useful_flops_frac is None is j.useful_flops_frac
    d, jd = r.to_dict(), j.to_dict()
    assert set(jd) <= set(d)
    assert set(d) - set(jd) == {"card", "card_bytes_s", "card_bf16_flops_s",
                                "definitions"}
    assert set(d["definitions"]) == {"flops", "hbm_bytes", "per_device_mem",
                                     "temp_bytes", "collectives"}
    assert "item 9" in d["definitions"]["collectives"]
    for k in ("compute_s", "memory_s", "collective_s", "bottleneck",
              "useful_flops_frac"):
        assert d[k] == getattr(r, k)


def test_roofline_on_another_card():
    r = analysis.Roofline(**_fields(), card="NVIDIA H100 PCIe",
                          card_bytes_s=2.0e12, card_bf16_flops_s=756e12)
    assert r.compute_s == 3.0e12 / 756e12
    assert r.memory_s == 4.0e10 / 2.0e12


# ---------------------------------------------------------------------------
# the counting pass on hand-counted steps
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_raw_costs_counts_by_hand():
    x, w = _meta(64, 32), _meta(32, 16)

    def step(x, w):
        y = x @ w                     # 2·64·32·16 FLOPs; 8192 + 2048 in, 4096 out
        z = y.t()                     # a view: no bytes, no storage
        return (z * 2.0).sum()        # 4096 in, 4096 out; 4096 in, 4 out

    flops, hbm, coll, peak = analysis.raw_costs(step, (x, w))
    assert flops == 2 * 64 * 32 * 16
    assert hbm == (8192 + 2048 + 4096) + (4096 + 4096) + (4096 + 4)
    assert coll == {}
    # y (alive through the step) and z * 2 at once, then the sum's scalar
    assert peak == 4096 + 4096 + 4


def test_raw_costs_frees_what_the_step_drops():
    """Storages freed during the pass leave the live count: a chain of
    temporaries peaks at two of them, not at their sum."""
    x = _meta(1024)

    def chain(x):
        for _ in range(10):
            x = x + 1.0
        return x

    _, hbm, _, peak = analysis.raw_costs(chain, (x,))
    assert peak == 2 * 4096
    assert hbm == 10 * 2 * 4096


def test_raw_costs_keeps_what_autograd_saves():
    """A tensor autograd saves for the backward stays live until the
    backward has run."""
    x = _meta(1024).requires_grad_()

    def step(x):
        y = x.sin()                   # saves x (an argument)
        z = y.cos()                   # saves y: 4096 stays live
        g, = torch.autograd.grad(z.sum(), x)
        return g

    flops, _, _, peak = analysis.raw_costs(step, (x,))
    assert flops == 0
    assert peak >= 3 * 4096           # y, z and a gradient at once


def test_bytes_per_device_and_the_temp_estimate():
    m = port_mesh({"data": 2, "model": 4})
    t = _meta(8, 6, 10, dtype=torch.bfloat16)
    spec = lambda *s: NamedSharding(m, P(*s))
    assert analysis.bytes_per_device([t], [spec()]) == 8 * 6 * 10 * 2
    assert analysis.bytes_per_device([t], [spec("data", None, "model")]) \
        == 4 * 6 * 3 * 2              # 10 / 4 rounds up, as XLA pads
    assert analysis.bytes_per_device([t], [spec(("data", "model"))]) == \
        1 * 6 * 10 * 2
    with pytest.raises(ValueError):
        analysis.bytes_per_device([t, t], [spec()])
    # the batch is the step's second argument
    shard = ({"w": spec("model")}, {"tokens": spec("data", None)})
    assert analysis.batch_split(shard) == 2
    assert analysis.temp_bytes(1001, shard) == 500
    shard = ({"w": spec()}, {"tokens": spec(None, ("data", "model"))})
    assert analysis.batch_split(shard) == 8
    assert analysis.batch_split(({}, spec())) == 1


# ---------------------------------------------------------------------------
# the flash kernel's shape-only route
# ---------------------------------------------------------------------------

def _pairs_from_the_mask(Lq, Lk, causal, window):
    """Visible pairs counted from `ref.attention_ref`'s own mask."""
    q_pos = np.arange(Lq)[:, None] + (Lk - Lq)
    k_pos = np.arange(Lk)[None, :]
    mask = np.ones((Lq, Lk), bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return int(mask.sum())


FLASH_CASES = [  # B, Hq, Hkv, Lq, Lk, D, causal, window
    (2, 8, 2, 300, 300, 64, True, 0),        # causal prefill
    (1, 4, 4, 257, 257, 128, True, 64),      # sliding window
    (3, 6, 3, 200, 200, 80, False, 0),       # an encoder
    (4, 8, 2, 1, 1000, 64, True, 0),         # a decode step
    (2, 4, 1, 16, 700, 96, False, 100),      # window, no causal mask
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_meta_route_counts_the_useful_work(case):
    B, Hq, Hkv, Lq, Lk, D, causal, window = case
    q = _meta(B, Hq, Lq, D, dtype=torch.bfloat16)
    k = _meta(B, Hkv, Lk, D, dtype=torch.bfloat16)
    v = _meta(B, Hkv, Lk, D, dtype=torch.bfloat16)
    before = dict(ops.LAUNCHES)
    out, flops, hbm, peak = analysis.count_pass(
        lambda q, k, v: ops.attention(q, k, v, causal=causal, window=window),
        (q, k, v))
    pairs = _pairs_from_the_mask(Lq, Lk, causal, window)
    assert ops.visible_pairs(Lq, Lk, causal, window) == pairs
    assert flops == 4 * B * Hq * pairs * D
    # one op: q, k, v read, o written, as the kernel does
    assert hbm == 2 * (2 * q.numel() + 2 * k.numel())
    assert peak == q.numel() * 2
    assert out.device.type == "meta" and out.shape == q.shape \
        and out.dtype == q.dtype
    assert dict(ops.LAUNCHES) == before      # no kernel, no plain version


def test_flash_bound_of_the_kernel_table():
    """The count behind the kernel table's prefill bound: 68.75 GFLOP for
    q [4, 32, 2048, 64], causal."""
    q = (4, 32, 2048, 64)
    assert ops.flash_flops(q, q, True, 0) == 4 * 4 * 32 * 2048 * 2049 // 2 \
        * 64
    assert round(ops.flash_flops(q, q, True, 0) / 1e9, 2) == 68.75


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def test_cpu_tensors_still_take_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 9, 32, generator=g)
    k = torch.randn(2, 2, 9, 32, generator=g)
    v = torch.randn(2, 2, 9, 32, generator=g)
    n = ops.LAUNCHES["flash_attention"]
    with _Ops() as seen:
        got = ops.attention(q, k, v, causal=True, window=4)
    assert ops.LAUNCHES["flash_attention"] == n + 1
    assert "repro_torch.flash_attention" not in seen.names
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=True,
                                                      window=4),
                               rtol=0, atol=0)
    q, k, v = (t.to("meta") for t in (q, k, v))
    with _Ops() as seen:
        out = ops.attention(q, k, v)
    assert seen.names == ["repro_torch.flash_attention"]
    assert out.device.type == "meta"


def test_meta_prefill_reaches_the_flash_route():
    """A prefill counted on meta goes through the shape-only route once a
    layer (`_device_kind` would refuse the meta device)."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("tinyllama-1.1b", param_dtype="bfloat16")
    fn = steps.make_prefill_step(cfg)
    args = (steps.abstract_params(cfg),
            steps.input_specs(cfg, InputShape("p", 64, 2, "prefill"))
            ["batch"])
    with _Ops() as seen:
        (logits, cache), flops, _, _ = analysis.count_pass(fn, args)
    assert seen.names.count("repro_torch.flash_attention") == cfg.num_layers
    assert logits.device.type == "meta"
    assert flops > cfg.num_layers * 4 * 2 * cfg.num_heads * \
        _pairs_from_the_mask(64, 64, True, 0) * cfg.hd


# ---------------------------------------------------------------------------
# FLOPs and bytes against the reference's cost_analysis
# ---------------------------------------------------------------------------

_COUNTS = {}


def _counts(arch):
    """(port flops, port bytes, reference flops, reference bytes) of the
    PARITY train step, counted once for the module."""
    if arch not in _COUNTS:
        cfg = get_config(arch, num_layers=2)
        m = port_mesh({"data": 1, "model": 1})
        fn, args, _ = steps.shardings_for(cfg, PARITY, m)
        flops, hbm, _, _ = analysis.raw_costs(fn, args)
        jcfg = j_get_config(arch, num_layers=2, unroll_stack=True)
        jm = j_mesh.make_host_mesh(1, 1)
        j_set_mesh_context(jm)
        try:
            jfn, jargs, jshard = j_steps.shardings_for(
                jcfg, JInputShape("parity", 512, 2, "train"), jm)
            compiled = jax.jit(jfn, in_shardings=jshard).lower(
                *jargs).compile()
        finally:
            j_set_mesh_context(None)
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        _COUNTS[arch] = (flops, hbm, float(ca["flops"]),
                         float(ca["bytes accessed"]))
    return _COUNTS[arch]


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_flops_against_the_reference_cost_analysis(arch):
    flops, _, j_flops, _ = _counts(arch)
    assert FLOP_BAND[0] <= flops / j_flops <= FLOP_BAND[1], \
        (arch, flops, j_flops, flops / j_flops)


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_bytes_against_the_reference_cost_analysis(arch):
    _, hbm, _, j_hbm = _counts(arch)
    assert BYTE_BAND[0] <= hbm / j_hbm <= BYTE_BAND[1], \
        (arch, hbm, j_hbm, hbm / j_hbm)


def test_analyze_splits_evenly_over_the_chips():
    cfg = get_config("tinyllama-1.1b", num_layers=2)
    flops, hbm, _, _ = _counts("tinyllama-1.1b")
    m = port_mesh({"data": 2, "model": 4})
    fn, args, shard = steps.shardings_for(cfg, PARITY, m)
    r = analysis.analyze("tinyllama-1.1b", "parity", "2x4", 8, fn, args,
                         shard, model_flops=analysis.model_flops_estimate(
                             cfg, PARITY))
    assert r.flops == flops / 8 and r.hbm_bytes == hbm / 8
    assert (r.coll_bytes, r.coll_breakdown, r.collective_s) == (0.0, {}, 0.0)
    peak = analysis.raw_costs(fn, args)[3]
    assert r.per_device_mem == analysis.bytes_per_device(args, shard) + \
        peak // 2                     # B = 2 over the data axis
    assert r.card == H100
    assert r.bottleneck == "memory"
    assert dataclasses.asdict(r)["model_flops"] == \
        6.0 * analysis.active_param_count(cfg) * 2 * 512
