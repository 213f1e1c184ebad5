"""Several processes, one mesh (counterpart of ``obs_rvc_tpu/parallel/distributed.py``).

The JAX package spans hosts with ``jax.distributed``: ``data`` crosses
them and ``model`` stays inside each, so streams, which share nothing, are
the only thing split across processes (no cross-stream traffic). Here
``torch.distributed`` carries that process layer. Each process drives its
own devices' rows of the mesh in-process (``parallel/sharding.py``); the
collectives between processes are the caller's (for example a
``dist.all_gather`` of the rows' outputs).

Typical launch, one process per host::

    from obs_rvc_tpu_torch.parallel import distributed
    distributed.initialize()                   # torchrun's MASTER_ADDR/PORT, RANK, WORLD_SIZE
    mesh = distributed.global_mesh(n_model=1)  # every card of every process along data
    slots = distributed.local_stream_slots(mesh)
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from obs_rvc_tpu_torch.parallel.mesh import Mesh, make_mesh, visible_devices


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` over TCP at
    ``coordinator_address`` (``host:port``). The defaults are torchrun's:
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. A no-op
    when the group is up already or there is one process. The backend is
    ``nccl`` with a card and ``gloo`` without one, unless named. Under
    ``nccl`` each process makes its own card current first: ``LOCAL_RANK``
    (torchrun's; default the rank) modulo the visible cards, so two ranks on
    a host of two cards take one each."""
    if dist.is_initialized():
        return
    env = os.environ
    num = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    if num <= 1:
        return
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if coordinator_address is None:
        coordinator_address = f"{env.get('MASTER_ADDR', 'localhost')}:{env.get('MASTER_PORT', '29500')}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num, rank=rank)


def global_mesh(n_model: int = 1, local_devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over every process's devices (``local_devices``, default every
    visible card), in rank order along ``data``; ``model`` stays inside a
    process, so each process must hold a whole number of rows."""
    local = [torch.device(d) for d in (local_devices if local_devices is not None else visible_devices())]
    if len(local) % n_model:
        raise ValueError(f"{len(local)} local devices do not hold whole rows of n_model={n_model}")
    if dist.is_initialized():
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, [str(d) for d in local])
    else:
        every = [[str(d) for d in local]]
    devices = [d for names in every for d in names]
    processes = [rank for rank, names in enumerate(every) for _ in names]
    mesh = make_mesh(n_model=n_model, devices=devices)
    return Mesh(mesh.devices, mesh.axis_names, processes=processes)


def local_stream_slots(mesh: Mesh) -> int:
    """The data rows this process feeds: those whose first model shard it
    holds (the JAX convention; one feeder per stream)."""
    return sum(mesh.row_is_local(r) for r in range(mesh.shape["data"]))
