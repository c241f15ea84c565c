"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="yi-34b",
    arch_type="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    param_dtype="bfloat16",
    citation="arXiv:2403.04652",
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    head_dim=32,
    param_dtype="float32",
)
