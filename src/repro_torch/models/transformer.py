"""The model stack and its training loss, for the reference's six
families:
 - dense (tinyllama / llama3 / yi): a causal GQA decoder over tokens;
 - audio (hubert): a bidirectional encoder over precomputed frame
   embeddings (`frame_proj`; the conv frontend is a stub, as in the
   reference);
 - vlm (phi-3-vision): a causal decoder over projected patch embeddings
   (`img_proj`; the vision tower is a stub) followed by text tokens, its
   loss over the text positions only;
 - moe (grok-1 / deepseek-v2): a causal decoder whose FFN is a top-k MoE
   (`models.moe`) and whose attention is GQA or, with `use_mla`, MLA; the
   layers' switch aux losses sum into `moe_aux`, which `loss_fn` weighs
   by `aux_weight`;
 - ssm (mamba2): [ln→Mamba2→res] × L (`models.ssm`), no attention;
 - hybrid (zamba2): the Mamba2 stack with ONE shared attention + MLP
   block (`shared`) applied after every `hybrid_attn_every` layers, on
   the concatenation of the hidden state and the embedded input; its
   weights are reused at every application, as in the paper, so their
   gradients sum over the applications.
The first four are attention stacks, [ln→attn→res, ln→FFN→res] × L.

Ported from `repro.models.transformer`.  Parameters are a plain dict of
tensors with the reference's structure and its stacked [L, ...] layer
leaves, so weights carry across one to one
(`utils.convert.lm_params_from_numpy`).  The reference's `lax.scan` over
layers (two levels for the hybrid: groups, then the layers of a group) is
a Python loop over per-layer views of the stacked leaves (`layer_views`),
and so is its scan over the loss's sequence chunks.

`deltas`, where a function takes it, is an event's stale offset
δ = p_k − W (detached, the structure of the parameters): the forward is
evaluated at W + δ with W the differentiable operand of every large GEMM
and of the embedding gather (`layers.delta_einsum`), which is what
`models.lm` maps over events for the cotangent fused path.  (MLA and the
MoE FFN fold δ into effective weights instead, as the reference does.)
Everything on the training path is free of in-place writes, host syncs
and data-dependent control flow, so `torch.func.vmap` and `grad` go
through it.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (delta_einsum, dense_init, dget, eff,
                                       embed_lookup, init_embedding, init_mlp,
                                       mlp_forward, rms_norm)
from repro_torch.sharding.rules import constrain, unstacked
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import leaves, tree_map, unflatten


def init_model(generator: torch.Generator, cfg: ModelConfig, device=None):
    """Random weights at the reference's scales (N(0, 1/fan_in), embedding
    and unembedding 0.02, norm gains 1) in `cfg.dtype`, on `device` (the
    card unless the caller passes another).  Draws come from `generator`, on
    its own device: a CUDA generator keeps a full-width init on the card.
    An MoE config draws the `moe` leaves where the others draw `mlp`, and
    MLA's attention leaves where the others draw GQA's; the SSM and hybrid
    families draw {ln, mamba} layers, and the hybrid its shared block after
    them; the other families' draws are unchanged.  On the meta device
    nothing is drawn (`generator` may be None): the leaves are shapes and
    dtypes alone (`launch.steps.abstract_params`)."""
    device = resolve_device(device)
    L, d, dt = cfg.num_layers, cfg.d_model, cfg.dtype
    kw = dict(device=device)
    params: Dict[str, Any] = {
        "embed": init_embedding(generator, cfg.padded_vocab, d, dt, **kw),
        "final_norm": torch.ones(d, dtype=dt, device=device),
        "unembed": dense_init(generator, (d, cfg.padded_vocab), dt,
                              scale=0.02, **kw),
    }
    if cfg.arch_type in ("ssm", "hybrid"):
        params["layers"] = {
            "ln": torch.ones(L, d, dtype=dt, device=device),
            "mamba": ssm_mod.init_ssm(generator, cfg, layers=L, **kw),
        }
        if cfg.arch_type == "hybrid":
            params["shared"] = _init_shared_block(generator, cfg, device)
        return params
    params["layers"] = {
        "ln1": torch.ones(L, d, dtype=dt, device=device),
        "attn": attn.init_attention(generator, cfg, layers=L, **kw),
        "ln2": torch.ones(L, d, dtype=dt, device=device),
    }
    if cfg.is_moe:
        params["layers"]["moe"] = moe_mod.init_moe(generator, cfg, layers=L,
                                                   **kw)
    else:
        params["layers"]["mlp"] = init_mlp(generator, d, cfg.d_ff, dt,
                                           layers=L, **kw)
    # the modality stubs' input projections, drawn after the layers so that
    # the dense family's draws are those it always had
    if cfg.arch_type == "vlm":
        params["img_proj"] = dense_init(generator, (cfg.image_embed_dim, d),
                                        dt, **kw)
    if cfg.arch_type == "audio":
        params["frame_proj"] = dense_init(generator, (cfg.frame_embed_dim, d),
                                          dt, **kw)
    return params


def _init_shared_block(generator, cfg, device):
    """Zamba2's shared attention block, one set of weights: {in_proj: [2d,
    d], ln1, attn (GQA), ln2, mlp (SwiGLU)}."""
    d, dt = cfg.d_model, cfg.dtype
    return {
        "in_proj": dense_init(generator, (2 * d, d), dt, device=device),
        "ln1": torch.ones(d, dtype=dt, device=device),
        "attn": attn.init_attention(generator, cfg, device=device),
        "ln2": torch.ones(d, dtype=dt, device=device),
        "mlp": init_mlp(generator, d, cfg.d_ff, dt, device=device),
    }


def _attn_block(lp, cfg, x, positions, dl=None):
    """One layer → (x, its MoE aux loss, or None without experts)."""
    h = rms_norm(x, eff(lp["ln1"], dget(dl, "ln1")), cfg.norm_eps)
    forward_attn = attn.mla_forward if cfg.use_mla else attn.gqa_forward
    x = x + forward_attn(lp["attn"], cfg, h, positions, dp=dget(dl, "attn"))
    h = rms_norm(x, eff(lp["ln2"], dget(dl, "ln2")), cfg.norm_eps)
    if cfg.is_moe:
        h, aux = moe_mod.moe_forward(lp["moe"], cfg, h, dp=dget(dl, "moe"))
        return x + h, aux
    return x + mlp_forward(lp["mlp"], h, dp=dget(dl, "mlp")), None


def _mamba_block(lp, cfg, x, dl=None):
    h = rms_norm(x, eff(lp["ln"], dget(dl, "ln")), cfg.norm_eps)
    return x + ssm_mod.ssm_forward(lp["mamba"], cfg, h, dp=dget(dl, "mamba"))


def _shared_block(sp, cfg, x, emb0, positions, ds=None):
    """The hybrid's shared block on x and the embedded input emb0 (both
    [B, S, d]): y = [x, emb0]·in_proj, y += attn(ln1(y)), y += mlp(ln2(y)),
    out = x + y.  Attention is `gqa_forward` (`_sdpa`)."""
    y = delta_einsum("bsd,dk->bsk", torch.cat([x, emb0], dim=-1),
                     sp["in_proj"], dget(ds, "in_proj"))
    y = y + attn.gqa_forward(
        sp["attn"], cfg,
        rms_norm(y, eff(sp["ln1"], dget(ds, "ln1")), cfg.norm_eps),
        positions, dp=dget(ds, "attn"))
    y = y + mlp_forward(
        sp["mlp"], rms_norm(y, eff(sp["ln2"], dget(ds, "ln2")), cfg.norm_eps),
        dp=dget(ds, "mlp"))
    return x + y


def hybrid_split(cfg):
    """(k, n_groups, rest): the shared block follows each of the n_groups
    groups of k Mamba2 layers; the last `rest` layers have none after
    them."""
    k = cfg.hybrid_attn_every
    n_groups = cfg.num_layers // k
    return k, n_groups, cfg.num_layers - n_groups * k


def shared_after(cfg, i: int) -> bool:
    """Whether the hybrid's shared block follows layer i (False for every
    other family); its application is then number i // k."""
    if cfg.arch_type != "hybrid":
        return False
    k, n_groups, _ = hybrid_split(cfg)
    return i % k == k - 1 and i < n_groups * k


def layer_views(tree):
    """Each layer's tree of the stacked [L, ...] leaves (views), from one
    `unbind` per leaf.  On the training path its backward stacks the L
    layer gradients once, where indexing one layer at a time would give
    each leaf L full-size zero-filled gradients to add: O(L²) traffic.
    Over processes a leaf sharded along its layer dim is first gathered
    along it (`sharding.rules.unstacked`)."""
    cols = [unstacked(leaf).unbind(0) for leaf in leaves(tree)]
    return [unflatten(tree, [c[i] for c in cols])
            for i in range(len(cols[0]))]


class _Remat(torch.autograd.Function):
    """Activation checkpointing that runs under `torch.func`.

    `forward` runs ``body(*tensors)`` (a tuple of tensors) under no grad
    and saves only its tensor inputs; `backward` runs the body again and
    differentiates it, returning the cotangents of the floating inputs
    that need one (integer positions and detached offsets get None).
    `torch.utils.checkpoint` is refused under `torch.func.grad` and
    `vmap(grad)` (its saved-tensor hooks are not supported there); a
    Function with `setup_context` and ``generate_vmap_rule`` is not, so
    this serves plain autograd (the pod-sync step) and the round trainer's
    and FRED's vmapped gradients alike.

    The backward is the `torch.func.grad` of Σ ⟨body(x), ḡ⟩ rather than a
    `torch.func.vjp`: `vjp` returns its pullback after leaving its
    transform level, and a checkpoint nested in the body (the hybrid's
    layers inside its checkpointed group) would then run its own backward
    on tensors of that finished level, which `torch.func` refuses; `grad`
    runs the whole backward inside its level.  The cotangent reaches each
    output as ḡ · 1, exactly ḡ.  That `grad` runs under `torch.no_grad`,
    which it ignores for its own derivative: the transform around it
    differentiates with ``create_graph``, and would otherwise record the
    recomputation and keep every recomputed activation for a second
    derivative, which is all remat saves (a checkpointed model is
    therefore not twice differentiable).  Outside any `torch.func`
    transform (the pod-sync step) the same product goes through
    `torch.autograd.grad`, whose order of accumulation is plain
    autograd's, so the gradients are those of ``remat=False`` to the
    bit."""

    generate_vmap_rule = True

    @staticmethod
    def forward(body, *tensors):
        with torch.no_grad():
            return body(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.body = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        diff = [i for i, t in enumerate(tensors)
                if need[i] and t.is_floating_point()]
        out = [None] * len(tensors)
        if not diff:
            return (None, *out)

        def dot(*xs):
            full = list(tensors)
            for i, t in zip(diff, xs):
                full[i] = t
            return sum(torch.sum(y * g)
                       for y, g in zip(ctx.body(*full), grads))

        xs = [tensors[i] for i in diff]
        if torch._C._are_functorch_transforms_active():
            with torch.no_grad():
                got = torch.func.grad(dot, argnums=tuple(range(len(diff))))(
                    *xs)
        else:
            with torch.enable_grad():
                xs = [x.detach().requires_grad_() for x in xs]
                got = torch.autograd.grad(dot(*xs), xs)
        for i, g in zip(diff, got):
            out[i] = g
        return (None, *out)


def remat(fn, *trees):
    """``fn(*trees)`` (a tuple of tensors) with its activations recomputed
    in the backward (`_Remat`): the trees (a layer's parameter views, its
    δ views or None, x, the positions, ...) are flattened into the
    Function's tensor arguments and rebuilt inside."""
    shapes = [tree_map(lambda _: 0, t) for t in trees]
    counts = [len(leaves(t)) for t in trees]

    def body(*tensors):
        it = iter(tensors)
        return fn(*(unflatten(s, [next(it) for _ in range(n)])
                    for s, n in zip(shapes, counts)))

    return _Remat.apply(body, *(l for t in trees for l in leaves(t)))


def _attn_layer(cfg, lp, dl, x, positions):
    """`_attn_block` as a tuple of tensors: (x,), or (x, aux) with
    experts."""
    x, aux = _attn_block(lp, cfg, x, positions, dl)
    return (x,) if aux is None else (x, aux)


def _mamba_layer(cfg, lp, dl, x):
    return (_mamba_block(lp, cfg, x, dl),)


def _group(cfg, lps, dls, x, emb0, positions, sp, ds):
    """One hybrid group: its k Mamba2 layers (each checkpointed), then the
    shared block."""
    for lp, dl in zip(lps, dls):
        (x,) = remat(partial(_mamba_layer, cfg), lp, dl, x)
    return (_shared_block(sp, cfg, x, emb0, positions, ds),)


def _run_stack(params, cfg, x, positions, deltas=None):
    """The layers over x [B, S, d] → (x, moe_aux): the sum of the layers'
    switch aux losses (float32), 0.0 for a family without experts, as in
    the reference.  The hybrid applies the shared block after layers k −
    1, 2k − 1, …, n_groups·k − 1 (`shared_after`), on x and the embedded
    input, W[tok] + δ[tok] under `deltas`, with `deltas["shared"]` as the
    block's stale offset.

    With ``cfg.remat`` each layer is recomputed in the backward (`remat`)
    at the reference's granularity: every attention or MoE layer, every
    Mamba2 layer, and for the hybrid each group of k layers with its
    shared block besides (the reference checkpoints both its inner and its
    outer scan body)."""
    x = constrain(x, "bsd")
    lps = layer_views(params["layers"])
    dls = ([None] * len(lps) if deltas is None
           else layer_views(deltas["layers"]))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.arch_type in ("ssm", "hybrid"):
        emb0 = x
        sp = params.get("shared")
        ds = None if sp is None else dget(deltas, "shared")
        if cfg.remat:
            k, n_groups, _ = hybrid_split(cfg) if cfg.arch_type == "hybrid" \
                else (1, 0, 0)
            for g in range(n_groups):
                part = slice(g * k, (g + 1) * k)
                (x,) = remat(partial(_group, cfg), lps[part], dls[part], x,
                             emb0, positions, sp, ds)
            for lp, dl in zip(lps[n_groups * k:], dls[n_groups * k:]):
                (x,) = remat(partial(_mamba_layer, cfg), lp, dl, x)
            return x, aux
        for i, (lp, dl) in enumerate(zip(lps, dls)):
            x = _mamba_block(lp, cfg, x, dl)
            if shared_after(cfg, i):
                x = _shared_block(sp, cfg, x, emb0, positions, ds)
        return x, aux
    for lp, dl in zip(lps, dls):
        if cfg.remat:
            x, *a = remat(partial(_attn_layer, cfg), lp, dl, x, positions)
        else:
            x, *a = _attn_layer(cfg, lp, dl, x, positions)
        x = constrain(x, "bsd")
        if a:
            aux = aux + a[0]
    return x, aux


def _embed_inputs(params, cfg, batch, deltas=None):
    """→ (x [B, S, d], positions [B, S]) for the family's batch:
    `tokens` [B, S] (dense, moe, ssm, hybrid); `frames` [B, S, F] through `frame_proj`
    (audio); `image_embeds` [B, P, F] through `img_proj`, then `tokens`
    [B, S_text], at positions 0 .. P + S_text − 1 (vlm).

    Under `deltas` the gather stays split, `W[tokens] + δ[tokens]`: the
    backward of a gather from the shared W is one scatter-add over the
    combined event × token batch, never a per-event [K, V, d] gradient;
    the projections are `delta_einsum`s.
    """
    if cfg.arch_type == "audio":
        x = delta_einsum("bsf,fd->bsd", batch["frames"], params["frame_proj"],
                         dget(deltas, "frame_proj"))
    else:
        tokens = batch["tokens"]
        x = embed_lookup(params["embed"], tokens)
        if deltas is not None:
            x = x + deltas["embed"][tokens]
        if cfg.arch_type == "vlm":
            img = delta_einsum("bpf,fd->bpd", batch["image_embeds"],
                               params["img_proj"], dget(deltas, "img_proj"))
            x = torch.cat([img, x], dim=1)
    B, S = x.shape[:2]
    pos = torch.arange(S, device=x.device).expand(B, S)
    return x, pos


def mask_vocab_pad(cfg: ModelConfig, logits):
    """−∞ (−1e30) in the padded logit columns (no-op when the vocab is
    already a multiple of 128)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
    return logits.masked_fill(pad, -1e30)


def _final_norm(params, cfg, x, deltas=None):
    return rms_norm(x, eff(params["final_norm"],
                           dget(deltas, "final_norm")), cfg.norm_eps)


def _logits(params, cfg, x, deltas=None):
    """x [B, S, d] (normed) → masked logits [B, S, V] in x's dtype."""
    return mask_vocab_pad(cfg, constrain(delta_einsum(
        "bsd,dv->bsv", x, params["unembed"], dget(deltas, "unembed")),
        "bsv"))


def unembed(params, cfg, x):
    """Final norm and unembedding: x [B, S, d] → masked logits [B, S, V]."""
    return _logits(params, cfg, _final_norm(params, cfg, x))


def forward(params, cfg: ModelConfig, batch, deltas=None):
    """Full-sequence forward → (logits [B, S, V], moe_aux)."""
    x, positions = _embed_inputs(params, cfg, batch, deltas)
    x, aux = _run_stack(params, cfg, x, positions, deltas)
    x = _final_norm(params, cfg, x, deltas)
    return _logits(params, cfg, x, deltas), aux


def _nll_sum(params, cfg, x, targets, deltas=None):
    """Σ of the token NLLs of x [B, c, d] (normed) against `targets` [B, c],
    the logits in float32."""
    logits = mask_vocab_pad(cfg, constrain(delta_einsum(
        "bsd,dv->bsv", x, params["unembed"],
        dget(deltas, "unembed")), "bsv").float())
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0].sum()


def _ce_dense(params, cfg, x, targets, deltas=None):
    """Mean token cross-entropy over [B, S] from one [B, S, V] float32
    logits tensor."""
    return _nll_sum(params, cfg, x, targets, deltas) / targets.numel()


def _ce_chunked(params, cfg, x, targets, deltas=None):
    """Mean token cross-entropy in chunks of `cfg.loss_chunk` positions, so
    that the float32 logits are [B, chunk, V] at a time (a Python loop
    where the reference scans; its per-chunk checkpoint is not taken, as
    `torch.utils.checkpoint` does not run under `torch.func`)."""
    c = cfg.loss_chunk
    total = sum(_nll_sum(params, cfg, x[:, i:i + c], targets[:, i:i + c],
                         deltas) for i in range(0, x.shape[1], c))
    return total / targets.numel()


def loss_fn(params, cfg: ModelConfig, batch, aux_weight: float = 0.01,
            deltas=None):
    """Cross-entropy + `aux_weight` · the MoE aux term (0 without experts) →
    (loss, {"ce", "moe_aux"}), for the family's batch (`_embed_inputs`)
    and its `targets`: [B, S], or [B, S_text] for the VLM, whose image
    positions carry no targets, so its loss is over the text positions
    only.

    With `deltas` the forward is evaluated at the stale point W + δ in the
    shared/delta split form (see the module docstring).  With `cfg.remat`
    each layer's activations are recomputed in the backward (`_run_stack`,
    `remat`), under plain autograd and under `torch.func` alike.
    """
    x, positions = _embed_inputs(params, cfg, batch, deltas)
    x, aux = _run_stack(params, cfg, x, positions, deltas)
    x = _final_norm(params, cfg, x, deltas)
    targets = batch["targets"]
    if cfg.arch_type == "vlm":
        x = x[:, batch["image_embeds"].shape[1]:]
    if cfg.loss_chunk and x.shape[1] % cfg.loss_chunk == 0:
        ce = _ce_chunked(params, cfg, x, targets, deltas)
    else:
        ce = _ce_dense(params, cfg, x, targets, deltas)
    return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}
