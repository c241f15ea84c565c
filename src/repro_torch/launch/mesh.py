"""Device meshes of one process, ported from `repro.launch.mesh`: the
host mesh, the production mesh (for spec reckoning) and the server mesh;
and the published rates of the cards the port runs on (`card_rates`), which
take the place of the reference's TPU constants in the roofline
(`launch.analysis`).

A `Mesh` lays devices out on named axes, as the reference's
`jax.sharding.Mesh` does.  A device may appear more than once: several
shards on one card (``[cuda:0] * 4``) or on the CPU (``[cpu] * 2``) are
the port's counterpart of the reference's simulated host devices
(``--xla_force_host_platform_device_count``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# The ROADMAP item that ports a server spread over processes.
_MULTI_PROCESS = ("a server spread over several processes "
                  "(torch.distributed) is not ported yet: ROADMAP.md queue "
                  "1, item 9")


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
    `torch.device` with one dimension per name in ``axis_names``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        self.devices = np.empty(given.shape, dtype=object)
        for i, d in np.ndenumerate(given):
            self.devices[i] = torch.device(d)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim} device dimensions for "
                             f"axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name → size."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> tuple:
        """The devices along `axis`, at index 0 of every other axis."""
        d = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[d] = slice(None)
        return tuple(self.devices[tuple(index)])


def _distinct_devices():
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _grid(devices, shape) -> np.ndarray:
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [torch.device(d) for d in devices[:grid.size]]
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


def make_host_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """A ("data", "model") mesh over the devices there are (the cards,
    else the CPU), each axis clamped to them as in the reference; an
    explicit `devices` list may repeat a device."""
    devices = _distinct_devices() if devices is None else list(devices)
    n = len(devices)
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return Mesh(_grid(devices, (data, model)), ("data", "model"))


def make_server_mesh(server: int = 1, data: int = 1, devices=None) -> Mesh:
    """A mesh with a ``'server'`` axis of S devices (the sharded server,
    `core.server_shard`) and a trailing ``'data'`` axis.

    Without `devices`, S and the data axis are clamped to the distinct
    devices there are (the cards, else the CPU), as in the reference.  An
    explicit `devices` list may repeat a device, e.g. ``[cuda:0] * 4`` for
    four shards on one card; the mesh takes its first S × data entries.
    """
    devices = _distinct_devices() if devices is None else list(devices)
    n = len(devices)
    server = max(1, min(server, n))
    data = max(1, min(data, n // server))
    return Mesh(_grid(devices, (server, data)), ("server", "data"))


def init_distributed_mesh(server: int = 1, *, coordinator_address=None,
                          num_processes=None, process_id=None) -> Mesh:
    """The multi-process form of `make_server_mesh`.  With no coordinator
    it is `make_server_mesh`, as in the reference; a coordinator (a server
    spread over processes) raises `NotImplementedError`."""
    if coordinator_address is not None:
        raise NotImplementedError(_MULTI_PROCESS)
    return make_server_mesh(server=server)
