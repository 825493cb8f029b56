"""Process groups and batch placement for data parallelism. Port of
``kbe_tpu/parallel/mesh.py`` over ``torch.distributed``.

A JAX mesh is the set of devices one program spans, and XLA splits a
global batch over it. Here every rank is a process of its own on one device
(``torchrun --nproc_per_node=N`` starts them), and a mesh is a rank's view
of the process group: its rank, the world size, its device and the group
its collectives run over (``DataMesh``). With no process group,
``data_mesh()`` is a 1-rank mesh, as JAX's one-device mesh is, and no
collective runs.

A rank holds its contiguous part of each global batch, as a JAX
``P('data')`` shard does (``shard_batch``), and a replica of the state
(``replicate``). ``batch_sharding`` and ``replicated_sharding`` are JAX
sharding objects with no counterpart here, so they are left out.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from kbe_torch.device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank of a 1-D data-parallel mesh. ``group`` is the process group
    of the collectives, or None for a 1-rank mesh with none."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[Any] = None

    @property
    def is_chief(self) -> bool:
        """Rank 0, which alone writes logs and checkpoints."""
        return self.rank == 0

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def local_rank() -> int:
    """torchrun's ``LOCAL_RANK``: the rank's card on its host."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def data_mesh(n_devices: Optional[int] = None, device=None) -> DataMesh:
    """The mesh of the default process group (``initialize_multihost``), or
    a 1-rank mesh where there is none. ``device`` defaults to ``cuda``,
    which is the rank's card ``cuda:LOCAL_RANK`` and raises where there is
    no GPU; ``'cpu'`` runs the plain path. ``n_devices``, where given, must
    be the world size: one process drives one device."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        group = dist.group.WORLD
    else:
        rank, world, group = 0, 1, None
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"data_mesh({n_devices}): the process group has {world} ranks; "
            f"start one process a device (torchrun --nproc_per_node="
            f"{n_devices}) and call initialize_multihost first")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return DataMesh(rank, world, resolve_device(dev), group)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda", backend: Optional[str] = None
                         ) -> bool:
    """Join the default process group; returns False, and joins none, where
    neither an address nor a world size is given or set.

    The arguments default to torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. The backend is ``nccl``
    for a CUDA ``device`` (the rank's card, ``LOCAL_RANK``, becomes the
    current one) and ``gloo`` for the CPU; ``backend`` overrides it (two
    ranks on one card need ``gloo``: NCCL refuses them)."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env \
            and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize_multihost needs an address, a world size and a rank "
            "(torchrun sets MASTER_ADDR and MASTER_PORT, WORLD_SIZE and "
            f"RANK); got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r}")
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)
        torch.cuda.set_device(local_rank() if dev.index is None
                              else dev.index)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def process_shard_indices(n_items: int,
                          process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> np.ndarray:
    """The rank's static slice of a dataset's index space: every
    ``process_count``-th index from ``process_index``."""
    initialized = dist.is_available() and dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if initialized else 0
    if process_count is None:
        process_count = dist.get_world_size() if initialized else 1
    return np.arange(process_index, n_items, process_count)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def shard_batch(mesh: DataMesh, batch):
    """The rank's contiguous part of a global batch (a dict of arrays or
    tensors, nested dicts too), as tensors on its device. The leading axis
    must divide by the world size, as a JAX sharding requires."""
    def part(x):
        n = x.shape[0]
        if n % mesh.world_size:
            raise ValueError(f"a global batch of {n} does not divide over "
                             f"{mesh.world_size} ranks")
        b = n // mesh.world_size
        x = x[mesh.rank * b:(mesh.rank + 1) * b]
        return torch.as_tensor(x if isinstance(x, torch.Tensor)
                               else np.ascontiguousarray(x),
                               device=mesh.device)
    return _tree_map(part, batch)


def host_local_batch_to_global(mesh: DataMesh, batch):
    """The rank's local part of a global batch, as tensors on its device.
    Every rank must pass the same local sizes, which one collective checks
    (a JAX global array has equal shards)."""
    out = _tree_map(lambda x: torch.as_tensor(x, device=mesh.device), batch)
    if mesh.group is not None:
        sizes = torch.tensor([x.shape[0] for x in _leaves(out)],
                             dtype=torch.int64, device=mesh.device)
        both = torch.cat([sizes, -sizes])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group)
        if not torch.equal(both[:len(sizes)], -both[len(sizes):]):
            raise ValueError(f"rank {mesh.rank}'s local batch sizes "
                             f"{sizes.tolist()} differ from another rank's")
    return out


def _tensors(tree):
    """Every tensor of a state: a module's parameters and buffers, and the
    tensors of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, torch.Tensor):
        return [tree.detach()]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def replicate(mesh: DataMesh, tree):
    """Broadcast every tensor of a state (modules, optimizer state) from
    rank 0, in place, so every rank starts from rank 0's; returns it."""
    if mesh.group is not None:
        for t in _tensors(tree):
            dist.broadcast(t, src=0, group=mesh.group)
    return tree
