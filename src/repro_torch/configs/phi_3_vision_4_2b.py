"""phi-3-vision-4.2b [vlm] — phi3-mini language backbone + projected CLIP
patch embeddings (the vision tower is a stub, as in the reference)
[hf:microsoft/Phi-3-vision-128k-instruct]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    num_image_tokens=256,
    image_embed_dim=1024,     # CLIP ViT-L/14 patch feature dim (stub input)
    param_dtype="bfloat16",
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE = dataclasses.replace(
    FULL,
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=512,
    head_dim=32,
    num_image_tokens=16,
    image_embed_dim=64,
    param_dtype="float32",
)
