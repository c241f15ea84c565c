"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1536,
    moe_d_ff=1536,
    vocab_size=102400,
    head_dim=128,
    num_experts=160,
    num_experts_per_tok=6,
    num_shared_experts=2,
    use_mla=True,
    kv_lora_rank=512,
    param_dtype="bfloat16",
    citation="arXiv:2405.04434",
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=8,
    d_ff=128,
    moe_d_ff=128,
    vocab_size=512,
    head_dim=32,
    num_experts=4,
    num_experts_per_tok=2,
    num_shared_experts=1,
    kv_lora_rank=64,
    param_dtype="float32",
)
