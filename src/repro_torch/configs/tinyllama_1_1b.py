"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    head_dim=64,
    param_dtype="bfloat16",
    citation="arXiv:2401.02385",
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
