"""Several processes, one global mesh.

The port of zpix_tpu/parallel/distributed.py on ``torch.distributed``.
Every process runs the same program, calls ``initialize``, and builds one
("batch", "stripe") mesh over every process's devices
(``global_mesh``).  Work is data parallel by process: each decodes its
contiguous ``local_shard`` of the global image list on its own devices and
places its results with ``host_local_batch``, whose ``Sharded`` holds this
process's shards of the global batch.  No pixels move between processes;
outputs stay where they were decoded, as in the JAX package.

So the process group carries only coordination data (each process's
device names, in ``global_mesh``), and it is always ``gloo``: it runs on
every machine, needs no card, and does not hold NCCL's rule of one rank a
GPU, so two processes may share one card.  The caller gives the
rendezvous address, the world size and the rank; nothing is read from the
environment.  One process (the usual case) needs none of this: the mesh
then spans its own devices.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, Sharded, _device, make_mesh


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, timeout: float = 300.0) -> bool:
    """Join the process group at ``coordinator_address`` ("host:port")
    when running several processes.  Returns False (and does nothing) for
    one process or when the group already exists; ``timeout`` in seconds
    bounds the rendezvous and every later collective."""
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return False
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def global_mesh(stripe: int = 1, devices=None) -> Mesh:
    """A ("batch", "stripe") mesh over every process's devices (``devices``
    here, default every visible CUDA device), processes in rank order; a
    position is addressable only in its own process."""
    local = make_mesh(devices).devices.reshape(-1)
    if process_count() == 1:
        return make_mesh(list(local), stripe=stripe)
    names: list = [None] * process_count()
    dist.all_gather_object(names, [str(d) for d in local])
    devs, procs = [], []
    for rank, ns in enumerate(names):
        devs += [_device(n) if rank == process_index() else torch.device(n) for n in ns]
        procs += [rank] * len(ns)
    n = len(devs)
    if n % stripe:
        raise ValueError(f"mesh {n // stripe}x{stripe} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n // stripe, stripe), np.asarray(procs).reshape(n // stripe, stripe))


def local_shard(items: list, process_id: int | None = None,
                num_processes: int | None = None) -> list:
    """The contiguous slice of a global work list owned by this process."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    per = (len(items) + n - 1) // n
    return items[pid * per : (pid + 1) * per]


def host_local_batch(mesh: Mesh, local_arrays) -> Sharded:
    """This process's [local_B, ...] batch (numpy or a tensor) -> the
    global batch of local_B x process count images, sharded on the mesh's
    "batch" axis, holding only this process's shards: its local batch split
    equally over its own batch positions, each part on that position's
    device."""
    t = local_arrays if isinstance(local_arrays, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(local_arrays))
    rank = process_index()
    mine = [k for k in range(mesh.shape["batch"]) if int(mesh.processes[k, 0]) == rank]
    if not mine or t.shape[0] % len(mine):
        raise ValueError(f"host_local_batch: {t.shape[0]} local rows over {len(mine)} "
                         "local batch positions")
    per = t.shape[0] // len(mine)
    base = mine[0] * per
    shards, idx = [], []
    for j, k in enumerate(mine):
        shards.append(t[j * per : (j + 1) * per].to(mesh.devices[k, 0]))
        idx.append((slice(base + j * per, base + (j + 1) * per),)
                   + (slice(None),) * (t.dim() - 1))
    shape = (t.shape[0] * process_count(),) + tuple(t.shape[1:])
    return Sharded(shards, idx, shape, complete=process_count() == 1)
