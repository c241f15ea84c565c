"""Models of the port: the paper's MLP and the transformers — the dense LM
decoders, the audio encoder, the VLM and the MoE decoders (`layers`,
`attention`, `moe`, `transformer`, `serving`, `api`).

Float32 matrix products on the card run in full float32, not TF32: the
statistics of eqs. 4–6 and the parity with the reference need all of
float32's digits, so importing this package sets
``torch.backends.cuda.matmul.allow_tf32 = False`` explicitly (PyTorch's
default today, stated here so that no other default can change it).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
