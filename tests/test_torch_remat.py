"""`ModelConfig.remat` in the port: each layer's activations recomputed in
the backward (`models.transformer.remat`), under plain autograd and under
`torch.func`.

- the port with ``remat=True`` against ``remat=False``: the loss and every
  gradient, through `torch.func.grad` and through plain autograd, for
  every family's SMOKE config; bitwise in float32, except the hybrid (see
  `test_remat_equals_no_remat_in_the_port`);
- the same against the reference's ``remat=True`` (`jax.checkpoint`), at
  `tests/test_torch_lm_training.py`'s float32 tolerances;
- one round of the round trainer (serial and fused, `torch.func.vmap` of
  `torch.func.grad`) on the tiny LM with remat against without;
- what remat saves: under plain autograd, counted with
  `torch.autograd.graph.saved_tensors_hooks`; under `torch.func.vmap` of
  `torch.func.grad`, the peak of the allocator's bytes in a
  `torch.profiler` trace (saved-tensor hooks are refused there).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models.transformer import init_model as j_init_model
from repro.models.transformer import loss_fn as j_loss_fn

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainerConfig
from repro_torch.core import round_trainer as rt
from repro_torch.models.api import make_dict_grad_fn
from repro_torch.models.transformer import init_model, loss_fn
from repro_torch.utils.convert import lm_params_from_numpy
from repro_torch.utils.rng import ReplayRoundDraws
from repro_torch.utils.trees import leaves, unflatten

from test_torch_audio_vlm import numpy_batch
from test_torch_fred import one_thread  # noqa: F401
from test_torch_moe import numpy_tokens

F32_GRAD = dict(rtol=1e-4, atol=1e-5)   # tests/test_torch_lm_training.py's
NAMES = ["tinyllama-1.1b", "grok-1-314b", "deepseek-v2-236b", "mamba2-1.3b",
         "zamba2-7b", "hubert-xlarge", "phi-3-vision-4.2b"]
FAMILY = {"tinyllama-1.1b": "dense", "grok-1-314b": "moe",
          "deepseek-v2-236b": "mla", "mamba2-1.3b": "ssm",
          "zamba2-7b": "hybrid", "hubert-xlarge": "audio",
          "phi-3-vision-4.2b": "vlm"}
B, S = 2, 32


def _np_batch(cfg, seed=1):
    if cfg.arch_type in ("audio", "vlm"):
        return numpy_batch(cfg, B, S, seed)
    return numpy_tokens(cfg, B, S, seed)


def _t_batch(cfg, np_batch):
    return {k: torch.from_numpy(v).to(cfg.dtype) if v.dtype.kind == "f"
            else torch.from_numpy(v) for k, v in np_batch.items()}


def _j_batch(np_batch):
    return {k: jnp.asarray(v) if v.dtype.kind == "f"
            else jnp.asarray(v, jnp.int32) for k, v in np_batch.items()}


def _port_grads(params, cfg, batch, how):
    """(loss, every leaf's gradient) by `torch.func.grad` or by plain
    autograd (`Tensor.backward`; a leaf the loss does not reach gets
    zeros, as under torch.func)."""
    if how == "func":
        g, loss = torch.func.grad_and_value(
            lambda p: loss_fn(p, cfg, batch)[0])(params)
        return loss, leaves(g)
    flat = [x.detach().clone().requires_grad_() for x in leaves(params)]
    loss = loss_fn(unflatten(params, flat), cfg, batch)[0]
    loss.backward()
    return loss.detach(), [torch.zeros_like(x) if x.grad is None else x.grad
                           for x in flat]


def _config(name, layers=None):
    cfg = get_smoke_config(name)
    return cfg if layers is None else dataclasses.replace(
        cfg, num_layers=layers)


# the hybrid at 5 layers: two groups of 2 with the shared block after each,
# and a last layer with none (the remat's group and tail paths both)
DEPTH = {"zamba2-7b": 5}
CASES = [(n, how) for n in NAMES for how in ("func", "autograd")]


@pytest.mark.parametrize("name,how", CASES,
                         ids=[f"{FAMILY[n]}-{h}" for n, h in CASES])
def test_remat_equals_no_remat_in_the_port(name, how):
    """Bitwise in float32: the backward recomputes each layer's forward
    with the same ops on the same inputs, and differentiates it by the
    same rules, in the order the transform would.  Not the hybrid: its
    shared block's weights and the embedded input it reads get one
    gradient per application, and with remat each group's part is formed
    in the group's own backward and added to the others afterwards, in
    another order than one backward over the whole stack adds them; it is
    held within 2^-22 of each leaf's largest entry (two to four float32
    ulps of it: the sums of three or more terms round twice)."""
    cfg = _config(name, DEPTH.get(name))
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _t_batch(cfg, _np_batch(cfg))
    loss0, g0 = _port_grads(params, cfg, batch, how)
    loss1, g1 = _port_grads(params, dataclasses.replace(cfg, remat=True),
                            batch, how)
    assert torch.equal(loss0, loss1)
    assert len(g0) == len(g1) and any(bool(g.abs().max() > 0) for g in g1)
    for i, (a, b) in enumerate(zip(g0, g1)):
        if cfg.arch_type == "hybrid":
            scale = float(a.abs().max())
            assert float((a - b).abs().max()) <= 2.0 ** -22 * scale, i
        else:
            assert torch.equal(a, b), (name, how, i)


@pytest.mark.parametrize("name", NAMES, ids=[FAMILY[n] for n in NAMES])
def test_remat_matches_the_reference_remat(name):
    """The port's remat loss and every gradient against the reference's
    `jax.checkpoint` stack, from the same weights and batch."""
    jcfg = dataclasses.replace(j_get_smoke_config(name), remat=True)
    cfg = dataclasses.replace(get_smoke_config(name), remat=True)
    jparams = j_init_model(jax.random.PRNGKey(0), jcfg)
    np_batch = _np_batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, jcfg, b), has_aux=True))(
        jparams, _j_batch(np_batch))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    g, (loss, m) = torch.func.grad_and_value(
        lambda p: loss_fn(p, cfg, _t_batch(cfg, np_batch)), has_aux=True)(
        params)
    np.testing.assert_allclose(float(loss), float(jl), **F32_GRAD)
    np.testing.assert_allclose(float(m["moe_aux"]), float(jm["moe_aux"]),
                               **F32_GRAD)
    got, want = leaves(g), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=str(i),
                                   **F32_GRAD)


EVENT_NAMES = ["tinyllama-1.1b", "grok-1-314b", "mamba2-1.3b", "zamba2-7b"]


@pytest.mark.parametrize("name", EVENT_NAMES,
                         ids=[FAMILY[n] for n in EVENT_NAMES])
def test_event_batched_loss_with_remat(name):
    """`make_lm_loss(cfg).event_batched` (the cotangent path's form: the
    stale offsets δ_k batched under `torch.func.vmap`, W shared) and its
    gradient in W, with remat against without: the δ views are detached
    inputs of each checkpointed layer, so their cotangents are never
    formed.  Bitwise but for the hybrid (within 2^-22 of each leaf's
    largest entry, as above)."""
    from repro_torch.models.lm import make_lm_loss
    K = 2
    cfg = _config(name, DEPTH.get(name))
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(3)
    deltas = unflatten(params, [0.02 * torch.randn((K,) + tuple(l.shape),
                                                   generator=g)
                                for l in leaves(params)])
    rng = np.random.default_rng(2)
    tok, tgt = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (K, B, S)))
                for _ in range(2))
    out = {}
    for remat in (False, True):
        ev = make_lm_loss(dataclasses.replace(cfg, remat=remat)).event_batched
        grad, losses = torch.func.grad_and_value(
            lambda W: (lambda v: (v.sum(), v))(ev(W, deltas, tok, tgt)),
            has_aux=True)(params)
        out[remat] = (losses[1], leaves(grad))
    (l0, g0), (l1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for i, (a, b) in enumerate(zip(g0, g1)):
        if cfg.arch_type == "hybrid":
            assert float((a - b).abs().max()) <= 2.0 ** -22 * float(
                a.abs().max()), i
        else:
            assert torch.equal(a, b), (name, i)


TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=128, head_dim=16)


@pytest.mark.parametrize("mode", ["serial", "fused"])
def test_round_trainer_under_vmap_grad_with_and_without_remat(mode):
    """One round of `build_round_step` (C = 4 clients, `torch.func.vmap`
    of `torch.func.grad`) from one state with the same batch and draws:
    θ, n, b, v, the client copies and the loss bitwise."""
    C = 4
    states = {}
    for remat in (False, True):
        cfg = get_smoke_config("tinyllama-1.1b", remat=remat, **TINY)
        params = init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
        tc = TrainerConfig(num_round_clients=C, rule="fasgd", lr=0.01,
                           c_fetch=0.5, use_fused_kernel=True)
        step = rt.build_round_step(tc, make_dict_grad_fn(cfg),
                                   apply_mode=mode)
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(0, 128, (C, 2, 16)))
                 for k in ("tokens", "targets")}
        draws = ReplayRoundDraws(np.full((1, C), 0.25, np.float32),
                                 np.full((1, C), 0.75, np.float32),
                                 device="cpu")
        state = rt.init_round_state(tc, params, device="cpu")
        # a first round makes the copies differ from the server's
        state, _ = step(state, batch, draws.round(0))
        states[remat] = step(state, batch, draws.round(0))
    (s0, m0), (s1, m1) = states[False], states[True]
    assert torch.equal(m0["loss_per_client"], m1["loss_per_client"])
    for field in ("params", "n", "b", "v"):
        for a, b in zip(leaves(getattr(s0.server, field)),
                        leaves(getattr(s1.server, field))):
            assert torch.equal(a, b), field
    for a, b in zip(leaves(s0.client_params), leaves(s1.client_params)):
        assert torch.equal(a, b)


def _saved_bytes(cfg, params, batch) -> int:
    """Bytes of the tensors autograd saves for `loss_fn`'s backward, each
    storage counted once, the parameters' own storage left out."""
    param_storage = {l.untyped_storage().data_ptr() for l in leaves(params)}
    seen = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in param_storage:
            seen[ptr] = t.untyped_storage().nbytes()
        return t

    flat = [x.detach().requires_grad_() for x in leaves(params)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = loss_fn(unflatten(params, flat), cfg, batch)[0]
    del loss
    return sum(seen.values())


def test_remat_saves_a_layer_input_per_layer():
    """Under plain autograd, going from 2 to 4 layers adds at most two
    layer inputs (2 · B·S·d·itemsize) to what remat saves, where without
    remat it adds more than 4× that (every layer's activations)."""
    Bm, Sm = 2, 64
    grow = {}
    for remat in (False, True):
        saved = []
        for L in (2, 4):
            cfg = get_smoke_config("tinyllama-1.1b", remat=remat,
                                   num_layers=L)
            params = init_model(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
            rng = np.random.default_rng(0)
            batch = {k: torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (Bm, Sm))) for k in ("tokens", "targets")}
            saved.append(_saved_bytes(cfg, params, batch))
        grow[remat] = saved[1] - saved[0]
    x_bytes = Bm * Sm * cfg.d_model * 4
    assert 0 < grow[True] <= 2 * x_bytes, (grow, x_bytes)
    assert grow[False] > 4 * 2 * x_bytes, (grow, x_bytes)


def _peak_bytes(fn) -> int:
    """The most bytes the CPU allocator held at once while `fn` ran, from
    the memory events of a `torch.profiler` trace (counted from its
    start)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]"), key=lambda e: e.start_ns())
    held = peak = 0
    for e in events:
        held += e.nbytes()
        peak = max(peak, held)
    return peak


def test_remat_saves_a_layer_input_per_layer_under_vmap_grad():
    """The round trainer's gradient (`torch.func.vmap` of `torch.func.grad`
    over C = 2 copies of the tiny LM, B = 4, S = 256): going from 2 to 4
    layers adds at most two layers' inputs (2 · C·B·S·d·itemsize) to the
    peak with remat, where without it the peak grows by more than 20×
    that.  (`torch.func.grad` differentiates with ``create_graph``: a
    backward that recorded its recomputation would keep every recomputed
    activation, and remat would save nothing.)"""
    C, Bm, Sm = 2, 4, 256
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 128, (C, Bm, Sm)))
             for k in ("tokens", "targets")}
    grow = {}
    for remat in (False, True):
        peaks = []
        for L in (2, 4):
            cfg = get_smoke_config("tinyllama-1.1b",
                                   **dict(TINY, num_layers=L), remat=remat)
            params = init_model(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
            copies = unflatten(params, [l[None].expand(
                (C,) + tuple(l.shape)).clone() for l in leaves(params)])
            grad = torch.func.vmap(make_dict_grad_fn(cfg))
            peaks.append(_peak_bytes(lambda: grad(copies, batch)))
        grow[remat] = peaks[1] - peaks[0]
    x_bytes = C * Bm * Sm * TINY["d_model"] * 4
    assert 0 < grow[True] <= 2 * x_bytes, (grow, x_bytes)
    assert grow[False] > 20 * 2 * x_bytes, (grow, x_bytes)
