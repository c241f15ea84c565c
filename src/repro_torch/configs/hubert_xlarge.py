"""hubert-xlarge [audio] — encoder-only transformer backbone over precomputed
frame embeddings (the conv feature extractor is a stub, as in the
reference) [arXiv:2106.07447]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,           # k-means acoustic units
    head_dim=80,
    causal=False,
    is_encoder=True,
    frame_embed_dim=512,      # post-conv feature dim (stub input)
    param_dtype="bfloat16",
    citation="arXiv:2106.07447",
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=504,
    head_dim=32,
    frame_embed_dim=64,
    param_dtype="float32",
)
