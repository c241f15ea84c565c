"""The port's launch layer (`launch.steps`, `launch.train`) against the
reference's.

- `make_train_step` (pod-sync FASGD) against the reference's: the tinyllama
  SMOKE config in float32 and bfloat16, and with bfloat16 statistics, 5
  steps from one state carried across with `utils.convert`, on the same
  token batches; the loss and θ, n, b, v at `tests/test_torch_lm_training.py`'s
  tolerances, T = 5;
- the reference's `tests/test_launch.py` specs in the port's terms: the
  input specs, `abstract_params` (a real init's shapes, and the reference's
  `jax.eval_shape` leaves for all ten full configs, without a draw),
  `abstract_server_state`, `shardings_for` for five archs (every step
  function run on CPU zeros of its abstract arguments, outputs shaped as
  the reference's `jax.eval_shape` says), the decode step and the
  encoder's prefill;
- `launch.train.main` on ``--device cpu --smoke``: both modes, serial and
  fused with ``--use-fused-kernel`` (the kernels' plain versions), the
  reference's printed lines, its refusals, a checkpointed and resumed run
  bitwise the uninterrupted one, and the default device (the card)
  raising where there is none.

Token tensors are int64 in the port, int32 in the reference.
"""
import dataclasses
import os
import re
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import TrainerConfig as JTrainerConfig
from repro.core import rules as j_rules
from repro.data.tokens import TokenDataConfig as JTokenDataConfig
from repro.data.tokens import make_batch as j_token_batch
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro.models.transformer import init_model as j_init_model

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.configs.base import InputShape, TrainerConfig
from repro_torch.core import rules
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import init_model
from repro_torch.utils.convert import server_state_from_numpy
from repro_torch.utils.trees import leaves, tree_map

from test_torch_fred import one_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)        # tests/test_torch_lm_training.py's
BF16_ULP, BF16_ULPS = 2.0 ** -7, 8
SMALL = InputShape("small", 64, 2, "train")
SMALL_DEC = InputShape("small_dec", 64, 2, "decode")
SMALL_PRE = InputShape("small_pre", 64, 2, "prefill")
J_SHAPES = {s.name: JInputShape(s.name, s.seq_len, s.global_batch, s.kind)
            for s in (SMALL, SMALL_DEC, SMALL_PRE)}


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _held(got, want, dtype, what):
    got, want = np.asarray(got, np.float64), np.asarray(_np(want), np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
        return
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= BF16_ULPS * BF16_ULP * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# make_train_step against the reference's
# ---------------------------------------------------------------------------

STEP_CASES = [("float32", "float32"), ("bfloat16", "bfloat16"),
              ("float32", "bfloat16")]


@pytest.mark.parametrize("dtype,stats", STEP_CASES,
                         ids=["f32", "bf16", "f32-bf16-stats"])
def test_train_step_matches_the_reference(dtype, stats):
    jcfg = j_get_smoke_config("tinyllama-1.1b", param_dtype=dtype)
    cfg = get_smoke_config("tinyllama-1.1b", param_dtype=dtype)
    j_tc = JTrainerConfig(rule="fasgd", lr=0.05, stats_dtype=stats)
    tc = TrainerConfig(rule="fasgd", lr=0.05, stats_dtype=stats)
    jst = j_rules.init(j_steps.server_config(j_tc),
                       j_init_model(jax.random.PRNGKey(0), jcfg))
    if stats != "float32":
        cast = lambda t: jax.tree.map(lambda l: l.astype(jnp.bfloat16), t)
        jst = jst._replace(n=cast(jst.n), b=cast(jst.b), v=cast(jst.v))
    np_st = jax.tree.map(np.asarray, jst)
    st = server_state_from_numpy(np_st.params, np_st.timestamp, np_st.n,
                                 np_st.b, np_st.v, device="cpu")
    j_step = jax.jit(j_steps.make_train_step(jcfg, j_tc))
    step = steps.make_train_step(cfg, tc)
    data = JTokenDataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                            batch_size=2)
    for i in range(5):
        tok, tgt = (np.asarray(a) for a in j_token_batch(data, i))
        jst, jm = j_step(jst, {"tokens": jnp.asarray(tok),
                               "targets": jnp.asarray(tgt)})
        st, m = step(st, {"tokens": torch.from_numpy(tok.copy()).long(),
                          "targets": torch.from_numpy(tgt.copy()).long()})
        tol = TOL if dtype == "float32" else dict(rtol=BF16_ULP, atol=0)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   err_msg=f"loss {i}", **tol)
        # the mean effective lr reads v: one bf16 rounding of it when the
        # statistics are bf16
        np.testing.assert_allclose(
            float(m["mean_scale"]), float(jm["mean_scale"]),
            rtol=1e-4 if stats == "float32" else BF16_ULP)
        assert float(m["tau"]) == float(jm["tau"]) == 1.0
    assert int(st.timestamp) == int(jst.timestamp) == 5
    for field in ("params", "n", "b", "v"):
        got, want = leaves(getattr(st, field)), jax.tree.leaves(
            getattr(jst, field))
        assert len(got) == len(want)
        for k, (a, b) in enumerate(zip(got, want)):
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
            # bf16 statistics put one bf16 rounding of v into every update
            # of a float32 θ: it is held to the bf16 bound then
            _held(a.float().numpy(), b,
                  "float32" if dtype == stats == "float32" else "bfloat16",
                  f"{field} leaf {k}")


def test_train_step_loss_falls_and_remat_agrees():
    """The reference's `test_train_step_runs_and_advances_timestamp` (the
    same batch five times: the loss falls, T = 5), and the same steps with
    ``remat=True``: bitwise, plain autograd recomputing each layer."""
    cfg = get_smoke_config("tinyllama-1.1b")
    tc = TrainerConfig(rule="fasgd", lr=0.05)
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
             for k in ("tokens", "targets")}
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        st = rules.init(steps.server_config(tc), params)
        step = steps.make_train_step(c, tc)
        losses = []
        for _ in range(5):
            st, m = step(st, batch)
            losses.append(float(m["loss"]))
        assert int(st.timestamp) == 5 and losses[-1] < losses[0]
        out[remat] = (losses, st)
    assert out[False][0] == out[True][0]
    for a, b in zip(leaves(out[False][1]), leaves(out[True][1])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the reference's launch specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b",
                                  "hubert-xlarge"])
def test_input_specs_cover_kinds(arch):
    cfg = get_smoke_config(arch)
    sp = steps.input_specs(cfg, SMALL)
    assert "batch" in sp and "targets" in sp["batch"]
    assert all(t.device.type == "meta" for t in leaves(sp))
    sp = steps.input_specs(cfg, SMALL_PRE)
    assert "targets" not in sp["batch"]
    if cfg.supports_decode():
        sp = steps.input_specs(cfg, SMALL_DEC)
        assert tuple(sp["token"].shape) == (2, 1)
        assert tuple(sp["pos"].shape) == ()
    else:
        with pytest.raises(ValueError, match="encoder-only"):
            steps.input_specs(cfg, SMALL_DEC)


def test_abstract_params_match_real_init():
    cfg = get_smoke_config("zamba2-7b")
    ab = steps.abstract_params(cfg)
    real = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    fa, fr = leaves(ab), leaves(real)
    assert len(fa) == len(fr)
    for a, r in zip(fa, fr):
        assert a.device.type == "meta"
        assert a.shape == r.shape and a.dtype == r.dtype


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_equal_the_reference_without_drawing(arch,
                                                             monkeypatch):
    """Every leaf's shape and dtype equal the reference's `jax.eval_shape`
    of its init; no random number is drawn (`torch.randn` refused), and
    even grok-1-314b's 316 B parameters take well under a second."""
    def refuse(*a, **k):
        raise AssertionError("abstract_params drew random numbers")
    monkeypatch.setattr(torch, "randn", refuse)
    t0 = time.perf_counter()
    got = leaves(steps.abstract_params(get_config(arch)))
    secs = time.perf_counter() - t0
    want = jax.tree.leaves(j_steps.abstract_params(j_get_config(arch)))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    assert secs < 1.0, secs


def test_abstract_server_state_bf16_stats():
    cfg = get_smoke_config("tinyllama-1.1b")
    st = steps.abstract_server_state(cfg, TrainerConfig(
        rule="fasgd", stats_dtype="bfloat16"))
    for field in ("n", "b", "v"):
        assert all(l.dtype == torch.bfloat16 and l.device.type == "meta"
                   for l in leaves(getattr(st, field)))
    assert all(l.dtype == torch.float32 for l in leaves(st.params))
    assert st.timestamp.dtype == torch.int32 and st.timestamp.dim() == 0


def _shapes(tree):
    return [tuple(l.shape) for l in leaves(tree)]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "grok-1-314b",
                                  "mamba2-1.3b", "zamba2-7b",
                                  "deepseek-v2-236b"])
def test_shardings_for_runs_on_cpu_zeros(arch):
    """`shardings_for` on a 1×1 host mesh for every step kind: a spec for
    every argument leaf, and the step function run on CPU zeros of the
    abstract arguments, its outputs shaped as the reference's."""
    cfg, jcfg = get_smoke_config(arch), j_get_smoke_config(arch)
    mesh = make_host_mesh(devices=["cpu"])
    for shape in (SMALL, SMALL_PRE, SMALL_DEC):
        if shape.kind == "decode" and not cfg.supports_decode():
            continue
        fn, args, shard = steps.shardings_for(cfg, shape, mesh)
        assert len(shard) == len(args)
        for a, s in zip(args, shard):
            n = len(leaves(a))
            assert n == len(leaves(s)) or (n == 1 and not isinstance(
                s, (list, tuple, dict)))
        out = fn(*tree_map(lambda l: torch.zeros(l.shape, dtype=l.dtype),
                           args))
        j_fn, j_args, _ = _j_shardings_for(jcfg, J_SHAPES[shape.name])
        want = jax.eval_shape(j_fn, *j_args)
        assert _shapes(out) == [tuple(l.shape) for l in
                                jax.tree.leaves(want)], (arch, shape.name)
        assert all(bool(torch.isfinite(l.float()).all())
                   for l in leaves(out) if l.is_floating_point())


def _j_shardings_for(jcfg, shape):
    from repro.launch.mesh import make_host_mesh as j_make_host_mesh
    return j_steps.shardings_for(jcfg, shape, j_make_host_mesh())


def test_decode_step_runs():
    from repro_torch.models.serving import init_cache
    cfg = get_smoke_config("llama3-8b")
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache = init_cache(cfg, 2, 16, device="cpu")
    step = steps.make_decode_step(cfg)
    tok = torch.zeros((2, 1), dtype=torch.int64)
    logits, _ = step(params, tok, cache, torch.tensor(0))
    assert tuple(logits.shape) == (2, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())


def test_encoder_prefill_step():
    from repro_torch.models.api import make_batch
    cfg = get_smoke_config("hubert-xlarge")
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = make_batch(cfg, 2, 32, torch.Generator().manual_seed(1))
    batch.pop("targets")
    logits = steps.make_prefill_step(cfg)(params, batch)
    assert tuple(logits.shape) == (2, 32, cfg.padded_vocab)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
       "--log-every", "1"]


def _masked(text):
    """The printed lines with every number replaced by '#'."""
    return [re.sub(r"\d+(\.\d+)?", "#", line)
            for line in text.strip().splitlines()]


@pytest.mark.parametrize("mode", ["serial", "fused", "podsync"])
def test_cli_prints_the_reference_lines(mode, capsys, monkeypatch):
    """The port's CLI and the reference's, on the same command line: the
    same lines, numbers aside (the pod-sync mode adds one, its rate); the
    kernel line counts one launch per leaf per candidate push (serial) or
    per round (fused)."""
    args = (["--clients", "0"] if mode == "podsync" else
            ["--clients", "2", "--apply-mode", mode, "--use-fused-kernel",
             "--c-fetch", "0.5"])
    args += ["--steps", "2"]
    state = train.main(CLI + args)
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["train"] + [
        a for a in CLI + args if a not in ("--device", "cpu")])
    j_train.main()
    theirs = capsys.readouterr().out
    got = [line for line in _masked(ours) if "[train] rate:" not in line]
    assert got == _masked(theirs)
    if mode == "podsync":
        assert "[train] rate:" in ours
        assert int(state.timestamp) == 2
    else:
        assert int(state.round_idx) == 2
        want = (2 if mode == "serial" else 1) * 2 * 12
        assert f"[train] kernel: {want} launches" in ours
        assert int(state.counters.kernel_launches) == want


def test_cli_refusals(capsys):
    for extra in (["--scenario", "stragglers"], ["--server-shards", "2"]):
        with pytest.raises(SystemExit):
            train.main(CLI + ["--clients", "0", "--steps", "1"] + extra)
        assert "needs the round trainer" in capsys.readouterr().err


def test_cli_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1", "--clients", "0"])


def test_cli_resume_replays_the_uninterrupted_run(capsys):
    """4 rounds straight against 2, a checkpoint, and 2 more from it:
    every leaf of the final state bitwise (the gates are keyed by the step,
    the batches a function of it)."""
    args = CLI + ["--clients", "2", "--c-fetch", "0.5", "--c-push", "0.2",
                  "--use-fused-kernel"]
    straight = train.main(args + ["--steps", "4"])
    with tempfile.TemporaryDirectory() as d:
        train.main(args + ["--steps", "2", "--ckpt-dir", d,
                           "--ckpt-every", "2"])
        assert os.listdir(d) == ["step_2"]
        resumed = train.main(args + ["--steps", "4", "--ckpt-dir", d])
    assert "[train] resumed from step 2" in capsys.readouterr().out
    a, b = leaves(straight), leaves(resumed)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(resumed.round_idx) == 4


def test_cli_podsync_checkpoint_holds_the_final_parameters():
    with tempfile.TemporaryDirectory() as d:
        st = train.main(CLI + ["--clients", "0", "--steps", "2",
                               "--ckpt-dir", d, "--ckpt-every", "2"])
        from repro_torch.checkpoint import restore_checkpoint
        got, step, _ = restore_checkpoint(d, st.params)
    assert step == 2
    assert all(torch.equal(x, y) for x, y in zip(leaves(got),
                                                 leaves(st.params)))


def test_batch_for_step_is_a_function_of_the_step():
    for arch in ("tinyllama-1.1b", "hubert-xlarge", "phi-3-vision-4.2b"):
        cfg = get_smoke_config(arch)
        S = 16 + cfg.num_image_tokens
        a = train.batch_for_step(cfg, 2, S, 3, "cpu")
        b = train.batch_for_step(cfg, 2, S, 3, "cpu")
        c = train.batch_for_step(cfg, 2, S, 4, "cpu")
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not all(torch.equal(a[k], c[k]) for k in a)
