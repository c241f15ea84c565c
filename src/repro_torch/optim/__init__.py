"""Baseline optimizers (`optim.optimizers`), ported from `repro.optim`."""
from repro_torch.optim.optimizers import (
    OptState,
    sgd,
    momentum,
    rmsprop_graves,
    adam,
    get_optimizer,
)
