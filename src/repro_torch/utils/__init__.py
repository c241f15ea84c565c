"""Tree helpers in JAX's leaf order, numpy round trips, and the RNG seam."""
from repro_torch.utils.trees import (
    leaves,
    tree_map,
    unflatten,
)
