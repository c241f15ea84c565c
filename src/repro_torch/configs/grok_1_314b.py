"""grok-1-314b [moe] — 8 experts, top-2 [hf:xai-org/grok-1]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    moe_d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    num_experts=8,
    num_experts_per_tok=2,
    param_dtype="bfloat16",
    citation="hf:xai-org/grok-1",
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    moe_d_ff=512,
    vocab_size=512,
    head_dim=32,
    num_experts=4,
    num_experts_per_tok=2,
    param_dtype="float32",
)
