"""Model and trainer configuration.

Ported from `repro.configs.base`.  `ModelConfig` covers the six
families of the reference: the dense decoders, the two modality families
built on them (the audio encoder and the VLM), the MoE family (GQA or MLA
attention, a top-k MoE FFN), the SSM family (a Mamba2 stack) and the
hybrid (the Mamba2 stack with one shared attention block); it has the
reference's fields, names and defaults, and `dtype` is a `torch.dtype`.
An `arch_type` outside those six raises `ValueError`.  `TrainerConfig`
configures the round trainer (`core.round_trainer`), with every field of
the reference; `InputShape` and `INPUT_SHAPES` name the launch layer's
input shapes (`launch.steps`).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import torch

if TYPE_CHECKING:       # core imports this module: no import cycle at run time
    from repro_torch.core.scenarios import ScenarioConfig

PORTED_ARCH_TYPES = ("dense", "audio", "vlm", "moe", "ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One model: an attention stack, [ln→attn→res, ln→FFN→res] × L (a
    dense decoder, an audio encoder over frame embeddings, a VLM decoder
    over image and text tokens, or an MoE decoder with GQA or MLA), a
    Mamba2 stack, [ln→Mamba2→res] × L (ssm), or that stack with one shared
    attention block after every `hybrid_attn_every` layers (hybrid)."""
    name: str
    arch_type: str               # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 → d_model // num_heads
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0            # per-expert hidden dim (d_ff for dense archs)
    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    # SSM (mamba2 / zamba2): d_inner = ssm_expand · d_model, ssm_heads =
    # d_inner / ssm_headdim, state width ssm_state, SSD chunks of ssm_chunk
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 64
    conv_width: int = 4
    # hybrid (zamba2): the shared attention block after every k SSM layers
    hybrid_attn_every: int = 0
    attn_window: int = 0         # 0 = full attention; >0 = sliding window
    causal: bool = True
    is_encoder: bool = False     # hubert: bidirectional, no decode step
    # modality stubs
    num_image_tokens: int = 0    # vlm: patch embeddings prepended to text
    image_embed_dim: int = 0
    frame_embed_dim: int = 0     # audio: precomputed frame embeddings
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # recompute each layer's activations in the backward
    # (`transformer.remat`, under plain autograd and torch.func alike)
    remat: bool = False
    loss_chunk: int = 0          # >0: compute CE in seq chunks (bounds the
                                 # f32 [B, S, V] logits footprint)
    # the reference's unrolled layer scan (an XLA cost-analysis mode): kept
    # for the field set, no effect here (the layers are a Python loop)
    unroll_stack: bool = False
    param_dtype: str = "float32"     # the full-size configs use bfloat16
    citation: str = ""

    def __post_init__(self):
        if self.arch_type not in PORTED_ARCH_TYPES:
            raise ValueError(f"{self.name}: unknown arch_type "
                             f"{self.arch_type!r}, not one of "
                             f"{PORTED_ARCH_TYPES}")
        # an attention-free family (mamba2) has no heads to group
        if self.num_kv_heads and self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: {self.num_heads} q heads do not "
                             f"group over {self.num_kv_heads} kv heads")

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128, as the reference pads it;
        the padded logit columns are masked to −∞ (`mask_vocab_pad`)."""
        return -(-self.vocab_size // 128) * 128

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def supports_decode(self) -> bool:
        return not self.is_encoder

    def supports_long_context(self) -> bool:
        """True if the arch serves long decodes with bounded state: SSM and
        hybrid natively, attention archs through a sliding window."""
        return self.arch_type in ("ssm", "hybrid") or self.attn_window > 0


@dataclasses.dataclass(frozen=True)
class InputShape:
    """A named input shape of the launch layer (`launch.steps`)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The round trainer (`core.round_trainer`): the reference's fields,
    names and defaults."""
    num_round_clients: int = 4   # C divergent parameter copies
    rule: str = "fasgd"          # any name in core.rules.registered_rules()
    lr: float = 0.005
    gamma: float = 0.9
    beta: float = 0.9
    eps: float = 1e-8
    kappa: float = 0.15          # 'exp' penalty strength
    poly_power: float = 0.5      # 'poly' exponent p in lr / tau**p
    variant: str = "intent"
    c_push: float = 0.0
    c_fetch: float = 0.0
    # §5 per-tensor gating: each parameter tensor pushes/fetches on its own
    # per-leaf eq. 9; staleness is then tracked per tensor (client_leaf_ts)
    per_tensor_push: bool = False
    per_tensor_fetch: bool = False
    drop_policy: str = "local_apply"   # 'local_apply' | 'discard'
    stats_dtype: str = "float32"       # the reference's >100B dry-run knob
    use_fused_kernel: bool = False     # the CUDA server-update kernels
    # 'auto' | 'materialized' | 'cotangent': how the fused apply reduces the
    # per-client gradients ('cotangent': engine.fused_apply_cotangent, with
    # a coeffs_are_v_independent or v_separable rule, whole-copy gating,
    # drop_policy='discard' and an event-batched loss)
    fused_mode: str = "auto"
    # the reference's Pallas interpret mode and TPU tile height: kept for
    # the field set, unused here (the tensors' device picks the kernel path)
    kernel_interpret: Optional[bool] = None
    kernel_block_rows: int = 0
    # --- bounded server ingress queue (core/queue.py) ---
    # 0 = immediate apply; > 0 admits each round's C pushes into a ring of
    # this capacity under `admission_policy` and drains `drain_policy`'s
    # count into the canonical update
    queue_capacity: int = 0
    drain_policy: str = "drain_all"
    drain_k: int = 1
    drain_adaptive_gain: float = 0.5
    admission_policy: str = "block"
    # --- scenario-lite wall clock (core/scenarios.py) ---
    # each round the C clients draw service times; gradients apply in
    # arrival (fastest-first) order and the round costs the barrier_k-th
    # order statistic (t_(C) for an async rule).  Churn/elastic knobs are
    # FRED-only (build_round_step raises).
    scenario: Optional[ScenarioConfig] = None
    kasync_k: int = 0                  # kasync partial-barrier K (0 → C)
    # --- sharded parameter server (core/server_shard.py): 1 = one whole
    # server; S > 1 places it on the `server_axis` of a mesh
    # (round_trainer.shard_round_state) ---
    server_shards: int = 1
    server_axis: str = "server"
    seed: int = 0
