"""The port's checkpoints and baseline optimizers against the reference.

Checkpoints: the reference's own tests (`tests/test_substrate.py`) in the
port; files written by the reference restored by the port (float32, int32
and bfloat16 leaves, and a whole bfloat16 `RoundState` of the tiny LM);
the port's float32 and int32 files restored by the reference; and the
port's bfloat16 ``.npy`` members byte for byte the reference's.  (The
reference cannot restore bfloat16 from either package's files: its
numeric cast of the stored bits raises, so that direction is not tested.)

Optimizers: each against the reference for 5 steps on the paper's MLP,
and the FASGD server equal to Graves' RMSProp at β = 0 in the port.
"""
import json
import os
import tempfile
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.configs.base import TrainerConfig as JTrainerConfig
from repro.core import round_trainer as jrt
from repro.data.mnist import make_synth_mnist as j_make_synth_mnist
from repro.models.mlp import init_mlp as j_init_mlp
from repro.models.mlp import nll_loss as j_nll_loss
from repro.models.transformer import init_model as j_init_model
from repro.optim import get_optimizer as j_get_optimizer

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainerConfig
from repro_torch.core import round_trainer as rt
from repro_torch.core import rules
from repro_torch.core.rules import ServerConfig
from repro_torch.models.mlp import nll_loss
from repro_torch.optim import get_optimizer
from repro_torch.utils.convert import (lm_params_from_numpy,
                                       params_from_numpy, to_numpy)
from repro_torch.utils.trees import leaves, tree_map

from test_torch_fred import one_thread  # noqa: F401

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=128, head_dim=16)


@pytest.fixture(scope="module")
def mlp():
    """The reference's MLP weights and 64 rows of its synthetic MNIST, as
    numpy."""
    params = jax.tree.map(np.asarray, j_init_mlp(jax.random.PRNGKey(0)))
    ds = j_make_synth_mnist(n_train=512, n_valid=256)
    return params, np.asarray(ds.x_train[:64]), np.asarray(ds.y_train[:64])


def _equal_trees(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the reference's checkpoint tests, in the port
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(mlp):
    params = params_from_numpy(mlp[0], "cpu")
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 7, params, extra={"lr": 0.1})
        save_checkpoint(d, 11, params)
        assert latest_step(d) == 11
        tree, step, extra = restore_checkpoint(d, params, step=7)
        assert step == 7 and extra == {"lr": 0.1}
        assert _equal_trees(tree, params)
        assert sorted(os.listdir(d)) == ["step_11", "step_7"]


def test_checkpoint_structure_mismatch_raises(mlp):
    params = params_from_numpy(mlp[0], "cpu")
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, params)
        with pytest.raises(ValueError, match="structure mismatch"):
            restore_checkpoint(d, {"different": torch.zeros(3)})
        bad = tree_map(lambda l: l, params)
        bad[0]["b"] = torch.zeros(7)
        with pytest.raises(ValueError, match="shape"):
            restore_checkpoint(d, bad)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(d, params)
        assert latest_step(os.path.join(d, "absent")) is None


def test_checkpoint_restores_server_state():
    cfg = ServerConfig(rule="fasgd")
    st = rules.init(cfg, {"w": torch.arange(4.0)})
    st, _ = rules.apply_update(cfg, st, {"w": torch.ones(4)},
                               torch.tensor(0, dtype=torch.int32))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, st)
        got, _, _ = restore_checkpoint(d, st)
        assert _equal_trees(got.params, st.params)
        assert _equal_trees(got, st)
        assert int(got.timestamp) == 1


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _mixed_numpy():
    """float32, int32 and bfloat16 leaves (the bf16 as its reference
    array) with a list and a None."""
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "i": [np.arange(6, dtype=np.int32).reshape(2, 3), None],
            "h": rng.standard_normal((4, 2)).astype(jnp.bfloat16)}


def test_port_restores_reference_checkpoints_bf16_included():
    tree = _mixed_numpy()
    template = params_from_numpy(tree, "cpu")
    with tempfile.TemporaryDirectory() as d:
        j_save(d, 3, jax.tree.map(jnp.asarray, tree), extra={"k": 1})
        got, step, extra = restore_checkpoint(
            d, tree_map(torch.zeros_like, template))
        assert step == 3 and extra == {"k": 1}
        assert _equal_trees(got, template)
        # a meta template: the shapes and dtypes alone
        meta = tree_map(lambda t: torch.empty_like(t, device="meta"),
                        template)
        got, _, _ = restore_checkpoint(d, meta, device="cpu")
        assert _equal_trees(got, template)


def test_reference_restores_port_checkpoints_f32_and_int():
    tree = _mixed_numpy()
    del tree["h"]
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 5, params_from_numpy(tree, "cpu"))
        got, step, _ = j_restore(d, jax.tree.map(jnp.zeros_like, tree))
        assert step == 5
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            assert np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)


def test_port_bf16_npz_members_are_the_reference_bytes():
    tree = _mixed_numpy()
    with tempfile.TemporaryDirectory() as jd, \
            tempfile.TemporaryDirectory() as td:
        j_save(jd, 1, jax.tree.map(jnp.asarray, tree))
        save_checkpoint(td, 1, params_from_numpy(tree, "cpu"))
        zj = zipfile.ZipFile(os.path.join(jd, "step_1", "arrays.npz"))
        zt = zipfile.ZipFile(os.path.join(td, "step_1", "arrays.npz"))
        assert zj.namelist() == zt.namelist()
        for name in zj.namelist():
            assert zj.read(name) == zt.read(name), name
        manifests = [json.load(open(os.path.join(x, "step_1",
                                                 "manifest.json")))
                     for x in (jd, td)]
        assert manifests[0] == manifests[1]
        assert [e["dtype"] for e in manifests[1]["leaves"]] == [
            "bfloat16", "int32", "float32"]


def test_port_restores_a_reference_round_state():
    """A bf16 tiny-LM `RoundState` after one serial round of the reference
    (server, C client copies, counters), written by the reference and
    restored into the port's fresh state: the paths are the reference's,
    every leaf its value, bitwise.  (Serial: the reference's materialized
    fused round returns float32 copies by type promotion, ROADMAP.md queue
    3, item 3, so a fresh bf16 state is not its template.)"""
    jcfg = j_get_smoke_config("tinyllama-1.1b", param_dtype="bfloat16",
                              **TINY)
    cfg = get_smoke_config("tinyllama-1.1b", param_dtype="bfloat16", **TINY)
    jparams = j_init_model(jax.random.PRNGKey(0), jcfg)
    j_tc = JTrainerConfig(num_round_clients=2, rule="fasgd", lr=0.01,
                          c_fetch=0.5)
    j_st = jrt.init_round_state(j_tc, jparams)
    rng = np.random.default_rng(0)
    batch = {k: jnp.asarray(rng.integers(0, 128, (2, 2, 16)), jnp.int32)
             for k in ("tokens", "targets")}

    def grad_fn(p, b):
        from repro.models.transformer import loss_fn as j_loss_fn
        (loss, _), g = jax.value_and_grad(
            lambda q: j_loss_fn(q, jcfg, b), has_aux=True)(p)
        return loss, g
    j_st, _ = jax.jit(jrt.build_round_step(j_tc, grad_fn, "serial"))(
        j_st, batch, jax.random.PRNGKey(1))
    tc = TrainerConfig(num_round_clients=2, rule="fasgd", lr=0.01,
                       c_fetch=0.5)
    template = rt.init_round_state(
        tc, lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        device="cpu")
    with tempfile.TemporaryDirectory() as d:
        j_save(d, 1, j_st)
        got, _, _ = restore_checkpoint(d, template)
    assert int(got.server.timestamp) == int(j_st.server.timestamp) > 0
    want = jax.tree.leaves(j_st)
    have = leaves(got)
    assert len(have) == len(want)
    for a, b in zip(have, want):
        b = np.asarray(b)
        if a.dtype == torch.bfloat16:
            assert b.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy(), b.view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), b)


def test_sharded_template_is_refused():
    from repro_torch.core import server_shard
    from repro_torch.launch.mesh import make_server_mesh
    cfg = ServerConfig(rule="fasgd")
    st = rules.init(cfg, {"w": torch.ones(8, 4), "b": torch.ones(4)})
    placed = server_shard.shard_server_state(
        st, make_server_mesh(2, devices=["cpu"] * 2))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, placed)       # gathered whole
        got, _, _ = restore_checkpoint(d, st)
        assert _equal_trees(got, st)
        with pytest.raises(ValueError, match="unsharded"):
            restore_checkpoint(d, placed)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTS = [("sgd", 0.1, {}), ("momentum", 0.02, {}),
        ("momentum", 0.02, {"nesterov": True}),
        ("rmsprop_graves", 0.01, {}), ("adam", 0.01, {})]


@pytest.mark.parametrize("name,lr,kw", OPTS,
                         ids=["sgd", "momentum", "nesterov", "rmsprop_graves",
                              "adam"])
def test_optimizer_matches_the_reference(mlp, name, lr, kw):
    """5 steps on the MLP from the same weights, each given the reference's
    gradient at the reference's point (the optimizers compared, not the
    two frameworks' GEMMs): parameters and buffers within rtol 2e-6, the
    step count exact.  atol 1e-8: XLA fuses Adam's update expression and
    may round its quotient otherwise, so a weight that crosses 0 differs
    by a few float32 roundings of one lr-sized step (ulp(0.01) ≈ 9e-10)
    where its relative error is large.  Then 30 steps of the port alone on its own
    gradients reduce the loss, as the reference's
    `test_optimizers_reduce_loss` asks."""
    np_params, x, y = mlp
    j_init, j_upd = j_get_optimizer(name, lr, **kw)
    init_fn, upd = get_optimizer(name, lr, **kw)
    jp, p = jax.tree.map(jnp.asarray, np_params), params_from_numpy(
        np_params, "cpu")
    jst, st = j_init(jp), init_fn(p)
    for _ in range(5):
        # the reference's gradient at its own point, given to both
        jg = jax.grad(j_nll_loss)(jp, x, y)
        jp, jst = j_upd(jp, jg, jst)
        p, st = upd(p, params_from_numpy(jax.tree.map(np.asarray, jg),
                                         "cpu"), st)
    assert int(st.step) == int(jst.step) == 5
    assert st.step.dtype == torch.int32
    for field in ("m", "n", "v"):
        assert (getattr(st, field) is None) == (getattr(jst, field) is None)
    for a, b in zip(leaves(to_numpy((p, st.m, st.n))),
                    jax.tree.leaves((jp, jst.m, jst.n))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-6, atol=1e-8)
    tx, ty = torch.from_numpy(x.copy()), torch.from_numpy(y.copy()).long()
    l0 = float(nll_loss(params_from_numpy(np_params, "cpu"), tx, ty))
    p = params_from_numpy(np_params, "cpu")
    st = init_fn(p)
    for _ in range(30):
        p, st = upd(p, torch.func.grad(nll_loss)(p, tx, ty), st)
    assert float(nll_loss(p, tx, ty)) < l0 * 0.7


def test_fasgd_server_equals_graves_rmsprop_when_beta_zero():
    """With one client, τ ≡ 1 and β = 0 the FASGD server is Graves'
    RMSProp (same γ, same eps): the paper's lineage, in the port."""
    eps = 1e-4
    cfg = ServerConfig(rule="fasgd", lr=0.01, gamma=0.95, beta=0.0, eps=eps)
    params = {"w": torch.tensor([1.0, -2.0, 0.5])}
    st = rules.init(cfg, params)
    init_fn, upd = get_optimizer("rmsprop_graves", 0.01, gamma=0.95, eps=eps)
    ost = init_fn(params)
    p = params
    for i in range(5):
        g = {"w": torch.tensor([0.1, -0.2, 0.3]) * (i + 1)}
        st, _ = rules.apply_update(cfg, st, g, st.timestamp)   # τ → 1
        p, ost = upd(p, g, ost)
    np.testing.assert_allclose(st.params["w"].numpy(), p["w"].numpy(),
                               rtol=1e-3)
