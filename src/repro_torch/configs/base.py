"""Model configuration: the dense decoder family.

Ported from `repro.configs.base`.  The fields are those the dense path
reads (plus `causal` and `is_encoder`, which `supports_decode` and the
attention masks read); `dtype` is a `torch.dtype`.  The other families'
fields (MoE, MLA, SSM, hybrid, the modality stubs) come with their modules:
a config of another `arch_type` raises `NotImplementedError`.
`TrainerConfig` waits for the LM training slice.
"""
from __future__ import annotations

import dataclasses

import torch

# the reference's other families, and the modules each still needs here
NOT_PORTED = {
    "moe": "the MoE FFN (models/moe.py)",
    "mla": "the MLA paths of models/attention.py",
    "ssm": "the Mamba2 mixer (models/ssm.py)",
    "hybrid": "the Mamba2 mixer and the shared attention block "
              "(models/ssm.py, the hybrid stack of models/transformer.py)",
    "audio": "the audio encoder (frame projection, bidirectional stack)",
    "vlm": "the vision stub (image projection, image-token inputs)",
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One dense GQA decoder: [ln→GQA→res, ln→SwiGLU→res] × L."""
    name: str
    arch_type: str               # only "dense" is ported
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 → d_model // num_heads
    attn_window: int = 0         # 0 = full attention; >0 = sliding window
    causal: bool = True
    is_encoder: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    param_dtype: str = "float32"     # the full-size configs use bfloat16
    citation: str = ""

    def __post_init__(self):
        if self.arch_type != "dense":
            missing = NOT_PORTED.get(self.arch_type, "an unknown family")
            raise NotImplementedError(
                f"{self.name}: arch_type {self.arch_type!r} is not ported "
                f"yet; it needs {missing}")
        if self.num_heads % self.num_kv_heads:
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

    def supports_decode(self) -> bool:
        return not self.is_encoder
