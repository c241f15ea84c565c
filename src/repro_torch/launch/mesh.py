"""Device meshes, ported from `repro.launch.mesh`: the host mesh, the
production mesh (for spec reckoning), the server mesh and its
multi-process form (`init_distributed_mesh`); and the published rates of
the cards the port runs on (`card_rates`), which take the place of the
reference's TPU constants in the roofline (`launch.analysis`).

A `Mesh` lays devices out on named axes, as the reference's
`jax.sharding.Mesh` does.  A device may appear more than once: several
shards on one card (``[cuda:0] * 4``) or on the CPU (``[cpu] * 2``) are
the port's counterpart of the reference's simulated host devices
(``--xla_force_host_platform_device_count``).  A mesh over several
processes also records which process (its rank in the
`torch.distributed` group) holds each entry.

A model's ("data", "model") mesh spread over processes, one entry a
process (`init_distributed_host_mesh`), is also a
`torch.distributed.device_mesh.DeviceMesh` over those ranks in the same
order (`device_mesh`): the mesh that `sharding.rules` places DTensors on.
The group is NCCL's where every process holds a card of its own and
gloo's otherwise (on the CPU, and where processes share a card, which
NCCL refuses); over gloo on the card DTensor's collectives run through
`sharding.gloo`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


# Published rates of NVIDIA's cards by the words of the card's name (as
# `torch.cuda.get_device_name` gives it): memory bytes/s, fp32 (non-tensor)
# op/s and bf16 tensor-core op/s, dense, at the full power limit.  Source:
# NVIDIA's H100 and H200 Tensor Core GPU data sheets.  A name is matched
# against the rows in order, so "H100" comes after its PCIe and NVL forms.
CARD_RATES = (("H100 PCIe", 2.0e12, 51e12, 756e12),
              ("H100 NVL", 3.9e12, 60e12, 835e12),
              ("H200", 4.8e12, 67e12, 989e12), ("H100", 3.35e12, 67e12, 989e12))
# The card this repo runs on (the H100 SXM): the roofline's rates where no
# card is present, as in a dry-run on the CPU.
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def card_name() -> str:
    """The name of the card present, else `DEFAULT_CARD`."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return DEFAULT_CARD


def card_rates(name: str | None = None):
    """(bytes/s, fp32 op/s, bf16 tensor op/s) published for the card named
    `name` (default: `card_name()`).  `ValueError` for a card the table
    does not know."""
    name = card_name() if name is None else name
    for words, *rates in CARD_RATES:
        if all(w in name for w in words.split()):
            return tuple(rates)
    raise ValueError(f"no published rates for card {name!r}")


class Mesh:
    """Devices on named axes: ``devices`` is an object array of
    `torch.device` with one dimension per name in ``axis_names``.
    ``ranks`` (an int array of the same shape) gives the process that
    holds each entry in a mesh spread over a process group; None means
    this process holds them all."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
        given = np.asarray(devices, dtype=object)
        self.devices = np.empty(given.shape, dtype=object)
        for i, d in np.ndenumerate(given):
            self.devices[i] = torch.device(d)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim} device dimensions for "
                             f"axes {self.axis_names}")
        self.ranks = None
        if ranks is not None:
            self.ranks = np.asarray(ranks, dtype=np.int64)
            if self.ranks.shape != self.devices.shape:
                raise ValueError(f"ranks of shape {self.ranks.shape} for "
                                 f"devices of shape {self.devices.shape}")

    @property
    def shape(self) -> dict:
        """Axis name → size."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> tuple:
        """The devices along `axis`, at index 0 of every other axis."""
        return tuple(self.devices[self._axis_index(axis)])

    def axis_ranks(self, axis: str):
        """The ranks holding the entries along `axis` (at index 0 of every
        other axis), or None when this process holds the whole mesh."""
        if self.ranks is None:
            return None
        return tuple(int(r) for r in self.ranks[self._axis_index(axis)])

    def _axis_index(self, axis: str):
        index = [0] * self.devices.ndim
        index[self.axis_names.index(axis)] = slice(None)
        return tuple(index)


def _distinct_devices():
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _grid(devices, shape) -> np.ndarray:
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = list(devices[:grid.size])
    return grid.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: (16, 16) on ("data", "model"), or
    (2, 16, 16) on ("pod", "data", "model") multi-pod, over the meta
    device repeated.  It holds no card: it is for reckoning specs
    (`sharding.rules`) at the production axis sizes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    return Mesh(_grid([torch.device("meta")] * n, shape), axes)


def make_host_mesh(data: int = 1, model: int = 1, devices=None,
                   ranks=None) -> Mesh:
    """A ("data", "model") mesh over the devices there are (the cards,
    else the CPU), each axis clamped to them as in the reference; an
    explicit `devices` list may repeat a device, and `ranks` gives the
    process holding each entry of a global list (the mesh takes as many
    of them as of the devices, in the same order)."""
    devices = _distinct_devices() if devices is None else list(devices)
    n = len(devices)
    data = min(data, n)
    model = min(model, max(n // data, 1))
    shape = (data, model)
    return Mesh(_grid(devices, shape), ("data", "model"),
                None if ranks is None else _grid(list(ranks), shape))


def make_server_mesh(server: int = 1, data: int = 1, devices=None,
                     ranks=None) -> Mesh:
    """A mesh with a ``'server'`` axis of S devices (the sharded server,
    `core.server_shard`) and a trailing ``'data'`` axis.

    Without `devices`, S and the data axis are clamped to the distinct
    devices there are (the cards, else the CPU), as in the reference.  An
    explicit `devices` list may repeat a device, e.g. ``[cuda:0] * 4`` for
    four shards on one card; the mesh takes its first S × data entries,
    and as many of `ranks` (the process holding each entry) where given.
    """
    devices = _distinct_devices() if devices is None else list(devices)
    n = len(devices)
    server = max(1, min(server, n))
    data = max(1, min(data, n // server))
    shape = (server, data)
    return Mesh(_grid([torch.device(d) for d in devices], shape),
                ("server", "data"),
                None if ranks is None else _grid(list(ranks), shape))


def _local_devices(rank: int):
    """A process's default share of a multi-process mesh: card
    ``rank % device_count`` where there are cards (several processes may
    share one), else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", rank % torch.cuda.device_count())]
    return [torch.device("cpu")]


def init_distributed_mesh(server: int = 1, *, coordinator_address=None,
                          num_processes=None, process_id=None,
                          devices=None) -> Mesh:
    """The multi-process form of `make_server_mesh`.

    Every process of the group calls this with the same `server`, and each
    then runs the same program against the returned global mesh (the
    reference's recipe, docs/SHARDING.md).  With a `coordinator_address`
    (``host:port``) the process joins a gloo `torch.distributed` group of
    `num_processes` as rank `process_id` first, unless a group is already
    initialized, which it keeps (as the reference keeps an initialized
    `jax.distributed`).  Each process contributes its `devices` (default:
    `_local_devices`), gathered in rank order, and the ``'server'`` axis
    spans that global list with the rank of each entry: S may exceed the
    number of processes when a process gives several devices.  With no
    coordinator it is `make_server_mesh` of this process alone.
    """
    if coordinator_address is None:
        return make_server_mesh(server=server, devices=devices)
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    everyone, ranks = _gather_devices(devices)
    return make_server_mesh(server=server, devices=everyone, ranks=ranks)


def _gather_devices(devices):
    """Every process's devices (default: `_local_devices`), gathered in
    rank order, and the rank of each entry."""
    mine = (_local_devices(dist.get_rank()) if devices is None
            else list(devices))
    shares = [None] * dist.get_world_size()
    dist.all_gather_object(shares, [str(d) for d in mine])
    everyone = [torch.device(d) for share in shares for d in share]
    ranks = [r for r, share in enumerate(shares) for _ in share]
    return everyone, ranks


def group_backend(num_processes: int) -> str:
    """The backend of a group of `num_processes` processes on this host:
    'nccl' where each takes a card of its own (card ``rank``), else
    'gloo' (the CPU, or processes sharing cards)."""
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def init_distributed_host_mesh(data=None, model: int = 1, *,
                               coordinator_address=None, num_processes=None,
                               process_id=None, devices=None) -> Mesh:
    """The reference's ``make_host_mesh`` over every process of a group:
    a ("data", "model") mesh with one entry a process, ``data`` ×
    ``model`` = the group's size (``data`` defaults to size / model).

    Every process calls this with the same arguments.  With a
    `coordinator_address` (``host:port``) the process joins a group of
    `num_processes` as rank `process_id` first (`group_backend`), unless a
    group is already initialized, which it keeps.  Each process
    contributes one device (default: `_local_devices`, card ``rank %
    device_count``, else the CPU).  Without a coordinator or a group it is
    `make_host_mesh` of this process alone."""
    if coordinator_address is None and not dist.is_initialized():
        return make_host_mesh(data or 1, model, devices=devices)
    if not dist.is_initialized():
        backend = group_backend(num_processes)
        if backend == "nccl":
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    everyone, ranks = _gather_devices(devices)
    if len(everyone) != dist.get_world_size():
        raise ValueError(f"{len(everyone)} devices for "
                         f"{dist.get_world_size()} processes: a host mesh "
                         f"takes one device a process")
    world = len(everyone)
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh over {world} processes")
    return make_host_mesh(data, model, devices=everyone, ranks=ranks)


def is_spread(mesh) -> bool:
    """Whether `mesh` spans more than one process."""
    ranks = getattr(mesh, "ranks", None)
    return ranks is not None and len(set(ranks.flat)) > 1


def local_device(mesh) -> torch.device:
    """The device of this process's entry of a spread mesh."""
    return mesh.devices[tuple(np.argwhere(mesh.ranks == dist.get_rank())[0])]


def device_mesh(mesh):
    """The `DeviceMesh` of a spread mesh, over its ranks in its order and
    with its axis names, made once a mesh (every process makes it, in the
    same order: it forms the axes' subgroups).  Each entry must be a
    process of its own.  Over gloo on the card it installs
    `sharding.gloo`'s collectives."""
    dm = getattr(mesh, "_device_mesh", None)
    if dm is not None:
        return dm
    if not is_spread(mesh) or len(set(mesh.ranks.flat)) != mesh.ranks.size:
        raise ValueError("a DeviceMesh needs a mesh of one entry a process")
    from torch.distributed.device_mesh import DeviceMesh
    kind = local_device(mesh).type
    if kind == "cuda" and dist.get_backend() == "gloo":
        from repro_torch.sharding import gloo
        gloo.install()
    dm = DeviceMesh(kind, torch.as_tensor(mesh.ranks),
                    mesh_dim_names=mesh.axis_names)
    mesh._device_mesh = dm
    return dm
