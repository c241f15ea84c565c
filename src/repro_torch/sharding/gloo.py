"""DTensor's collectives over a gloo group on the card.

Two processes that share one card cannot form an NCCL group (NCCL refuses
two ranks on one device), so their group is gloo's.  gloo carries card
tensors through its plain collectives (`dist.all_reduce`,
`dist.all_gather_into_tensor`, `dist.all_gather`), but the functional ones
that DTensor's redistributions and sharding propagation call
(``_c10d_functional::*`` and their ``wait_tensor``) crash the process on
card tensors over gloo (a segmentation fault in ``wait_tensor``, PyTorch
2.11 on an H100).  `install` registers a CUDA kernel for each of those
ops that runs the collective synchronously through the plain ones, so
DTensor works on the card unchanged above it:

* ``all_gather_into_tensor`` → `dist.all_gather_into_tensor`;
* ``all_reduce`` → `dist.all_reduce` on a copy ('avg' as a sum over the
  group's size, which gloo lacks);
* ``reduce_scatter_tensor`` → that all-reduce, then this rank's chunk (no
  reduce-scatter is asked of gloo);
* ``_dtensor::shard_dim_alltoall`` → an all-gather and this rank's
  chunk, as DTensor itself does over gloo on the CPU;
* the coalesced forms → one of the above a tensor; ``wait_tensor`` → its
  input, every collective above having completed already.

It is installed only in a process whose group is gloo and whose mesh is
on the card (`launch.mesh.device_mesh`); an NCCL group and the CPU keep
PyTorch's own kernels.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_LIB = None

_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "product": dist.ReduceOp.PRODUCT}


def _group(name):
    if isinstance(name, dist.ProcessGroup):
        return name
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _all_gather(x, group_size, group_name):
    out = x.new_empty((group_size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=_group(group_name))
    return out


def _all_reduce(x, reduce_op, group_name):
    pg = _group(group_name)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[reduce_op.lower()], group=pg)
    if reduce_op.lower() == "avg":
        out.div_(pg.size())
    return out


def _reduce_scatter(x, reduce_op, group_size, group_name):
    total = _all_reduce(x, reduce_op, group_name)
    me = dist.get_rank(_group(group_name))
    return total.chunk(group_size)[me].contiguous()


def _shard_dim_alltoall(x, gather_dim, shard_dim, group_name):
    pg = _group(group_name)
    n = pg.size()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=pg)
    whole = torch.cat(parts, dim=gather_dim)
    return whole.chunk(n, dim=shard_dim)[dist.get_rank(pg)].contiguous()


def install() -> None:
    """Register the synchronous CUDA kernels above (once a process)."""
    global _LIB
    if _LIB is not None:
        return
    import torch.distributed._functional_collectives  # noqa: F401  the ops
    import torch.distributed.tensor._collective_utils  # noqa: F401
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _all_gather, "CUDA")
    lib.impl("all_reduce", _all_reduce, "CUDA")
    lib.impl("reduce_scatter_tensor", _reduce_scatter, "CUDA")
    lib.impl("wait_tensor", lambda x: x, "CUDA")
    lib.impl("all_gather_into_tensor_coalesced",
             lambda xs, n, g: [_all_gather(x, n, g) for x in xs], "CUDA")
    lib.impl("reduce_scatter_tensor_coalesced",
             lambda xs, op, n, g: [_reduce_scatter(x, op, n, g) for x in xs],
             "CUDA")
    lib.impl("all_reduce_coalesced",
             lambda xs, op, g: [_all_reduce(x, op, g) for x in xs], "CUDA")
    dlib = torch.library.Library("_dtensor", "IMPL")
    dlib.impl("shard_dim_alltoall", _shard_dim_alltoall, "CUDA")
    _LIB = (lib, dlib)
