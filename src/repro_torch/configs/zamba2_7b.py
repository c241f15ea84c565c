"""zamba2-7b [hybrid] — Mamba2 stack + shared attention block every 6 layers
[arXiv:2411.15242]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    conv_width=4,
    hybrid_attn_every=6,
    param_dtype="bfloat16",
    citation="arXiv:2411.15242",
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=2,          # 2 mamba layers + 1 shared-attn application
    d_model=256,
    num_heads=8,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=512,
    head_dim=32,
    ssm_state=32,
    ssm_headdim=32,
    ssm_chunk=32,
    hybrid_attn_every=2,
    param_dtype="float32",
)
