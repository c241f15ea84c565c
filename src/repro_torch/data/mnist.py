"""Synthetic MNIST stand-in, ported from `repro.data.mnist`.

The same geometry and parameters as the reference's `make_synth_mnist`:
784 features, 10 classes, 32768 / 4096 rows of class-conditional Gaussians
whose means are themselves drawn from a fixed-seed Gaussian, rescaled to
MNIST's pixel scale.  The draws come from a `torch.Generator`, so the rows
differ from the JAX generator's; the parity tests feed the JAX arrays
through numpy instead.  Labels are int64 (torch's index type).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.utils.device import resolve_device


class Dataset(NamedTuple):
    """Train and validation splits on one device."""

    x_train: torch.Tensor  # [N, 784] float32
    y_train: torch.Tensor  # [N] int64
    x_valid: torch.Tensor
    y_valid: torch.Tensor


def make_synth_mnist(
    seed: int = 0,
    n_train: int = 32768,
    n_valid: int = 4096,
    dim: int = 784,
    num_classes: int = 10,
    mean_scale: float = 1.0,
    noise_scale: float = 4.0,
    feature_std: float = 0.3,
    label_noise: float = 0.0,
    device=None,
) -> Dataset:
    """Class-conditional Gaussians, normalized to MNIST-like feature scale
    (see the reference for the choice of SNR).  Generated on the CPU from
    `seed`, then moved to `device` (the card unless the caller passes
    another)."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    means = mean_scale * torch.randn(num_classes, dim, generator=g)
    rescale = feature_std / math.sqrt(mean_scale ** 2 + noise_scale ** 2)

    def make_split(n):
        y = torch.randint(num_classes, (n,), generator=g)
        noise = noise_scale * torch.randn(n, dim, generator=g)
        x = (means[y] + noise) * rescale
        if label_noise > 0:
            flip = torch.rand(n, generator=g) < label_noise
            y = torch.where(
                flip, torch.randint(num_classes, (n,), generator=g), y)
        return x.to(device), y.to(device)

    x_tr, y_tr = make_split(n_train)
    x_va, y_va = make_split(n_valid)
    return Dataset(x_tr, y_tr, x_va, y_va)
