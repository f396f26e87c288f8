"""Rank meshes on ``torch.distributed`` (counterpart of
``gpflow_slim_tpu.parallel.mesh``).

The JAX package lays devices on a ``jax.sharding.Mesh`` of named axes and
lets XLA's SPMD partitioner insert the collectives. The port's unit is a
process (a rank, one card each): ``make_mesh`` lays the world's ranks on
named axes and builds, for each axis, the process group of this rank's
line along it; the distributed paths (``dp``, ``dist_linalg``,
``grid_gpr``, ...) write their collectives out on those groups.
``shard_rows`` and ``replicated`` are the row slice and the broadcast that
``P(axis)`` and ``P()`` mean for an array. A mesh of one
rank is the identity on every path: with no process group initialized, a
1 x ... x 1 mesh runs in the one process and calls no collective, so the
same code runs on one card or many.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "replicated", "shard_rows", "initialize_distributed"]


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None, backend="nccl"):
    """Join the process group: ``dist.init_process_group`` with ``backend``,
    ``nccl`` (one card a rank) unless the caller asks for another: a world
    of CPU tensors asks for ``gloo``. Without a card, ``nccl`` raises here:
    the port runs on the card unless the caller asks for the CPU.
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to the environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), as the JAX package's ``jax.distributed.initialize``
    discovers its own. On ``nccl`` the rank takes card ``LOCAL_RANK`` (else
    its rank modulo the cards). No elasticity: a job recovers by restarting
    from a checkpoint (``utils.checkpoint``)."""
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device for the nccl backend: pass backend="gloo" for a world of CPU tensors')
    init_method = f"tcp://{coordinator_address}" if coordinator_address is not None else "env://"
    world = int(num_processes if num_processes is not None else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


class Mesh:
    """Ranks on named axes. ``shape``: ``{axis: size}``; ``devices``: the
    ranks as an array of that shape; ``coordinate(axis)``: this rank's
    index along an axis; ``line(axis)``: the ranks of this rank's line
    along it, in the order of their coordinate; ``group(axis)``: the process
    group of that line (None where the mesh has one rank and no process
    group is initialized); ``world_group``: the group of all the mesh's
    ranks."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))
        self.size = int(devices.size)
        self.rank = dist.get_rank() if dist.is_initialized() else int(devices.flat[0])
        if self.rank not in devices:
            raise ValueError(f"rank {self.rank} is not in the mesh {devices.tolist()}")
        self._coords = dict(zip(axis_names, (int(c[0]) for c in np.nonzero(devices == self.rank))))
        self._lines = {}
        for i, name in enumerate(axis_names):
            index = [self._coords[a] for a in axis_names]
            index[i] = slice(None)
            self._lines[name] = [int(r) for r in devices[tuple(index)]]
        self._groups = {}
        self.world_group = None
        if dist.is_initialized():
            # every rank creates every group, in one order (new_group is collective)
            everyone = sorted(int(r) for r in devices.flat)
            whole = everyone == list(range(dist.get_world_size()))
            self.world_group = dist.group.WORLD if whole else dist.new_group(everyone)
            for i, name in enumerate(axis_names):
                lines = np.moveaxis(devices, i, -1).reshape(-1, devices.shape[i])
                for line in lines:
                    ranks = [int(r) for r in line]
                    g = self.world_group if len(ranks) == self.size else dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[name] = g

    def coordinate(self, axis: str) -> int:
        return self._coords[axis]

    def line(self, axis: str) -> list[int]:
        return self._lines[axis]

    def group(self, axis: str):
        return self._groups.get(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """A mesh from an ``{axis: size}`` spec over ``devices`` (ranks; all the
    world's ranks by default, one if no process group is initialized).
    Default: all of them on one ``"data"`` axis. Sizes must multiply to the
    rank count; a ``-1`` size is inferred."""
    if devices is None:
        devices = list(range(dist.get_world_size() if dist.is_initialized() else 1))
    n = len(devices)
    if axes is None:
        axes = {"data": n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    return Mesh(np.asarray(devices).reshape(sizes), tuple(names))


def shard_rows(mesh: Mesh, axis: str):
    """``P(axis)`` for a tensor: a function that takes the global tensor
    (every rank holds it; rows divisible by the axis size) and returns this
    rank's contiguous block of rows, the block ``NamedSharding(mesh,
    P(axis))`` puts on this device."""
    n, i = mesh.shape[axis], mesh.coordinate(axis)

    def shard(x):
        if x.shape[0] % n != 0:
            raise ValueError(f"{x.shape[0]} rows not divisible by mesh axis {axis!r} of {n}")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return shard


def replicated(mesh: Mesh):
    """``P()`` for a tensor: a function that makes it equal on every rank of
    the mesh, a broadcast in place from the mesh's first rank; the tensor
    is returned. The identity on a mesh of one rank."""

    def replicate(x):
        if mesh.world_group is not None and mesh.size > 1:
            with torch.no_grad():
                dist.broadcast(x, src=int(mesh.devices.flat[0]), group=mesh.world_group)
        return x

    return replicate
