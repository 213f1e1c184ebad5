"""A ``('data', 'model')`` grid of devices (counterpart of ``obs_rvc_tpu/parallel/mesh.py``).

Axes:

- ``data``  concurrent streams: each row of the grid steps its own group of
  streams, with no traffic between rows.
- ``model`` tensor parallelism inside a row: ContentVec's attention heads and
  FFN hidden width, and the exact retrieval table's rows, split across the
  row's devices (``parallel/sharding.py``).

The JAX package's mesh is one controller over every chip, and GSPMD puts the
collectives in. The port's server is one process that drives its pool and
its CUDA graphs from one worker thread, so its mesh is a plain grid of
``torch.device`` values held in that process; :mod:`distributed` carries the
process layer. A grid may name one device more than once: ``["cpu"] * 8``
gives the CPU tests a 4x2 mesh (the JAX tests' 8 virtual CPU devices), and
``[cuda:0] * 4`` a 2x2 mesh on one card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

#: the CPU devices a mesh takes when its entry point runs on the CPU (the JAX
#: tests' ``--xla_force_host_platform_device_count=8``)
CPU_MESH_DEVICES = 8


class Mesh:
    """``devices`` (a grid of ``torch.device``, one axis per name) under
    ``axis_names``; ``processes``, the same grid of the ranks that own each
    device (every device this process's when ``None``)."""

    def __init__(self, devices, axis_names: Sequence[str] = ("data", "model"), processes=None):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(given[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid under {len(axis_names)} axis names")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.processes = None if processes is None else np.asarray(processes, dtype=np.int64).reshape(grid.shape)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def rows(self) -> list[list[torch.device]]:
        """Each ``data`` row's devices along ``model``, in order."""
        return [list(row) for row in self.devices.reshape(self.devices.shape[0], -1)]

    def row_is_local(self, r: int) -> bool:
        """Whether this process feeds row ``r``: it owns the row's first model
        shard (the JAX convention, ``distributed.local_stream_slots``)."""
        if self.processes is None:
            return True
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_initialized() else 0
        return int(self.processes.reshape(self.devices.shape[0], -1)[r, 0]) == rank

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def visible_devices(device=None) -> list[torch.device]:
    """The devices a mesh spans by default: every visible card, or
    :data:`CPU_MESH_DEVICES` times the CPU when ``device`` is the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * CPU_MESH_DEVICES
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ``('data', 'model')`` mesh over ``devices`` (default: every visible
    card). ``n_data`` defaults to ``len(devices) // n_model``; ``model`` is
    the minor axis, so a row's shards are neighbours in ``devices``."""
    devices = [torch.device(d) for d in (devices if devices is not None else visible_devices())]
    if n_data is None:
        if len(devices) % n_model:
            raise ValueError(f"{len(devices)} devices not divisible by n_model={n_model}")
        n_data = len(devices) // n_model
    n = n_data * n_model
    if n > len(devices) or n < 1:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(n_data, n_model), ("data", "model"))


def parse_mesh_spec(spec: str, default_data: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh from a command-line string like ``"data=4,model=2"``, with the
    JAX grammar: ``model`` defaults to 1; ``data`` to ``default_data``,
    where ``None`` (or ``data=-1``) fills the devices left. Single-stream
    entry points pass ``default_data=1``, so ``--mesh model=2`` means tensor
    parallelism alone there."""
    n_data: Optional[int] = default_data
    n_model = 1
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad mesh spec part {part!r} (want axis=N)")
        axis, _, val = part.partition("=")
        n = int(val)
        if axis.strip() == "data":
            n_data = None if n == -1 else n
        elif axis.strip() == "model":
            n_model = n
        else:
            raise ValueError(f"unknown mesh axis {axis!r} (have: data, model)")
    return make_mesh(n_data=n_data, n_model=n_model, devices=devices)
