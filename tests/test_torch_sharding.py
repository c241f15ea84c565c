"""The port's sharding rules against the reference's, spec by spec.

Every `PartitionSpec` that `param_specs`, `state_shardings`,
`cache_specs` (both `mla_cache_mode`s) and `batch_spec` give, for all ten
full configs' abstract parameters, server states, decode caches and
batches, on (1, 1), (2, 4), (16, 16) and (2, 16, 16) meshes: the
reference on a shape-only mesh (`tests/test_sharding.py`'s `FakeMesh`),
its `NamedSharding` replaced by the bare spec for the comparison; the port
on meshes of the meta device.  Then the reference's rule tests in the
port, and `constrain` returning its input.
"""
import numpy as np
import pytest
import torch

import repro.sharding.rules as j_rules
from repro.configs import get_config as j_get_config
from repro.configs.base import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs.base import TrainerConfig as JTrainerConfig
from repro.launch import steps as j_steps

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import INPUT_SHAPES, TrainerConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P
from repro_torch.utils.trees import leaves

MESHES = {"1x1": {"data": 1, "model": 1}, "2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """The reference test's shape-only stand-in for a mesh."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)
        self.shape = sizes


def port_mesh(sizes) -> Mesh:
    grid = np.empty(tuple(sizes.values()), dtype=object)
    grid.fill(torch.device("meta"))
    return Mesh(grid, tuple(sizes))


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's shardings as their specs (a `NamedSharding` needs a
    real mesh of devices)."""
    monkeypatch.setattr(j_rules, "NamedSharding", lambda mesh, spec: spec)


def _j_specs(tree):
    import jax
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, j_rules.P))]


def _t_specs(tree):
    out = []

    def walk(t):
        if isinstance(t, rules.NamedSharding):
            out.append(tuple(t.spec))
        elif isinstance(t, P):
            out.append(tuple(t))
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
    walk(tree)
    return out


CASES = [(a, m) for a in ARCH_NAMES for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_specs_equal_the_reference(arch, mesh, bare_specs, monkeypatch):
    jm, tm = FakeMesh(MESHES[mesh]), port_mesh(MESHES[mesh])
    jcfg, cfg = j_get_config(arch), get_config(arch)
    # parameters
    jp, tp = j_steps.abstract_params(jcfg), steps.abstract_params(cfg)
    want, got = _j_specs(j_rules.param_specs(jp, jm)), _t_specs(
        rules.param_specs(tp, tm))
    assert len(want) == len(got) == len(leaves(tp))
    assert got == want
    assert _t_specs(rules.param_shardings(tp, tm)) == want
    # the pod-sync server state, bf16 statistics as `shardings_for` makes
    # them
    jst = j_steps.abstract_server_state(
        jcfg, JTrainerConfig(stats_dtype="bfloat16"))
    tst = steps.abstract_server_state(cfg, TrainerConfig(
        stats_dtype="bfloat16"))
    assert _t_specs(rules.state_shardings(tst, tm)) == _j_specs(
        j_rules.state_shardings(jst, jm))
    # batches and decode caches of the named input shapes
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        js, ts = J_INPUT_SHAPES[name], INPUT_SHAPES[name]
        if ts.kind == "decode" and not cfg.supports_decode():
            continue
        jin, tin = j_steps.input_specs(jcfg, js), steps.input_specs(cfg, ts)
        if ts.kind == "decode":
            for mode in ("rank", "seq"):
                monkeypatch.setenv("REPRO_MLA_CACHE", mode)
                assert _t_specs(rules.cache_specs(tin["cache"], tm)) == \
                    _j_specs(j_rules.cache_specs(jin["cache"], jm)), mode
                assert _t_specs(rules.cache_shardings(tin["cache"], tm)) \
                    == _j_specs(j_rules.cache_shardings(jin["cache"], jm))
            monkeypatch.delenv("REPRO_MLA_CACHE")
            assert _t_specs(rules.batch_shardings(
                tin["token"], tm, seq_dim=None)) == _j_specs(
                j_rules.batch_shardings(jin["token"], jm, seq_dim=None))
        else:
            assert _t_specs(rules.batch_shardings(tin["batch"], tm)) == \
                _j_specs(j_rules.batch_shardings(jin["batch"], jm))
        for leaf in leaves(tin.get("batch", tin.get("token"))):
            for sd in (None, 1):
                assert tuple(rules.batch_spec(tuple(leaf.shape), tm,
                                              seq_dim=sd)) == tuple(
                    j_rules.batch_spec(tuple(leaf.shape), jm, seq_dim=sd))


def test_mode_switches_read_their_environment(monkeypatch):
    monkeypatch.delenv("REPRO_MLA_CACHE", raising=False)
    assert rules.mla_cache_mode() == "rank"
    monkeypatch.setenv("REPRO_MLA_CACHE", "x")
    assert rules.mla_cache_mode() == "x"
    rules.set_mla_cache_mode("seq")
    try:
        assert rules.mla_cache_mode() == "seq"
    finally:
        rules.set_mla_cache_mode(None)


def test_meshes():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16}
    assert all(d.type == "meta" for d in m.devices.flat)
    mp = make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}
    assert rules.axis_size(mp, ("pod", "data")) == 32
    assert rules.axis_size(m, "pod") == 1
    assert rules.batch_axes(mp) == ("pod", "data")
    assert rules.batch_axes(m) == ("data",)
    # clamped to the devices there are, as the reference's
    assert make_host_mesh(4, 2, devices=["cpu"]).shape == {"data": 1,
                                                          "model": 1}
    h = make_host_mesh(2, 2, devices=["cpu"] * 4)
    assert h.shape == {"data": 2, "model": 2}
    assert make_host_mesh(8, devices=["cpu"] * 4).shape == {"data": 4,
                                                           "model": 1}


def test_mesh_context():
    m = make_host_mesh(devices=["cpu"])
    assert rules.get_mesh_context() is None
    with rules.mesh_context(m):
        assert rules.get_mesh_context() is m
    assert rules.get_mesh_context() is None
    rules.set_mesh_context(m)
    assert rules.get_mesh_context() is m
    rules.set_mesh_context(None)


# ---------------------------------------------------------------------------
# the reference's rule tests (tests/test_sharding.py), in the port
# ---------------------------------------------------------------------------

M = port_mesh({"data": 16, "model": 16})
MP = port_mesh({"pod": 2, "data": 16, "model": 16})


def test_fsdp_rule_last_divisible_dim_to_model():
    assert rules.leaf_param_spec("unembed", (4096, 128256), M) == P(
        "data", "model")
    assert rules.leaf_param_spec("embed", (128256, 4096), M) == P(
        "data", "model")


def test_nondivisible_dims_replicate():
    assert rules.leaf_param_spec("layers/mamba/conv_b", (8456,), M) == P(None)


def test_stacked_layer_dim_never_sharded():
    spec = rules.leaf_param_spec("layers/attn/wq", (22, 2048, 32, 64), M)
    assert spec[0] is None
    assert "model" in tuple(spec)


def test_multipod_folds_pod_into_data():
    assert rules.leaf_param_spec("unembed", (4096, 128256), MP) == P(
        ("data", "pod"), "model")


def test_small_tensors_replicate():
    assert rules.leaf_param_spec("final_norm", (7,), M) == P(None)


def test_batch_spec_shards_batch_dim():
    assert rules.batch_spec((256, 4096), M) == P("data", None)
    assert rules.batch_spec((256, 4096), MP) == P(("pod", "data"), None)


def test_batch_one_falls_back_to_sequence():
    assert rules.batch_spec((1, 524288), M, seq_dim=1) == P(None, "data")


def test_cache_rule_decode():
    cache = {"k": torch.empty((32, 128, 32768, 8, 128), dtype=torch.bfloat16,
                              device="meta")}
    spec = rules.cache_specs(cache, M)["k"]
    assert spec[1] == "data"
    assert spec[4] == "model"


def test_cache_rule_batch1_shards_window():
    cache = {"k": torch.empty((32, 1, 8192, 8, 128), dtype=torch.bfloat16,
                              device="meta")}
    spec = rules.cache_specs(cache, M)["k"]
    assert spec[1] is None
    assert spec[2] == "data"


def test_constrain_returns_its_input():
    x = torch.ones(4, 4, 4)
    assert rules.constrain(x, "bsd") is x
    assert rules.constrain_axes(x, {0: "batch"}) is x
    with rules.mesh_context(make_host_mesh(devices=["cpu"])):
        assert rules.constrain(x, "attn") is x
        assert rules.constrain_axes(x, {2: "model"}) is x


def test_param_specs_cover_full_model():
    """Every leaf of a full-size model gets a valid spec: each dim
    replicated or exactly divisible."""
    for arch in ("llama3-8b", "grok-1-314b", "mamba2-1.3b", "zamba2-7b"):
        params = steps.abstract_params(get_config(arch))
        specs = _t_specs(rules.param_specs(params, M))
        assert len(specs) == len(leaves(params))
        for leaf, spec in zip(leaves(params), specs):
            for dim, ax in enumerate(spec):
                if ax is not None:
                    size = 16 if ax in ("data", "model") else 32
                    assert leaf.shape[dim] % size == 0, (leaf.shape, spec)
