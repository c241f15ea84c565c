"""Named-axis sharding rules (`sharding.rules`), ported from
`repro.sharding`: the generic FSDP parameter rule, the batch and cache
rules, and the mesh context."""
from repro_torch.sharding.rules import (
    NamedSharding,
    PartitionSpec,
    axis_size,
    batch_axes,
    leaf_param_spec,
    param_specs,
    param_shardings,
    state_shardings,
    batch_spec,
    batch_shardings,
    cache_specs,
    cache_shardings,
    set_mesh_context,
    get_mesh_context,
    mesh_context,
    constrain,
    constrain_axes,
)
