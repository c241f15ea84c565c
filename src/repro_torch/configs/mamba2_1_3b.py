"""mamba2-1.3b [ssm] — SSD (state-space duality), attn-free [arXiv:2405.21060]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    conv_width=4,
    param_dtype="bfloat16",
    citation="arXiv:2405.21060",
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=2,
    d_model=256,
    vocab_size=512,
    ssm_state=32,
    ssm_headdim=32,
    ssm_chunk=32,
    param_dtype="float32",
)
